"""Sort and segment-scan operators, and the Hopper kernel wrappers."""
