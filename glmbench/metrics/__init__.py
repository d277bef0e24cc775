"""One reader per metric, found by the metric's name, and the arithmetic they share."""
