"""Synthetic mask data (numpy only)."""
