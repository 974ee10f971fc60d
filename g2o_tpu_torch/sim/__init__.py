"""Synthetic dataset generators."""
