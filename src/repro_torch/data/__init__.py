"""Synthetic datasets (numpy)."""
