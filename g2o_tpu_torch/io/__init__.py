"""File formats."""
