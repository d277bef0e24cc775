"""glmbench's loops modules, found by name."""
