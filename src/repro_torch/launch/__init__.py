"""Command-line entry points of the port: serving and training."""
