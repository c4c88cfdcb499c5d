"""Command-line entry points of the port: serving, training and the
mesh dry-run."""
