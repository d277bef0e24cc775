"""glmbench's data modules, found by name."""
