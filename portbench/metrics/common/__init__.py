"""Arithmetic the metric readers share."""
