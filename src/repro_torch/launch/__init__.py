"""Command-line entry points of the port (serving; training comes later)."""
