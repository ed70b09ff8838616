"""Chip-side tools of the benchmark."""
