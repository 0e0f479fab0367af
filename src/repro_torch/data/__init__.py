"""Synthetic data pipelines (numpy, host side)."""
