"""Synthetic data generators (numpy only)."""
