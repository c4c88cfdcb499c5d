"""Roofline terms of the dry-run cells and their report tables."""
