"""Catalog, task splits, candidate pools and synthetic data (numpy only)."""
