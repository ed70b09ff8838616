"""Roofline terms of the dry-run records on the H100 (``analysis``), the
card's constants (``constants``) and the per-device tallies of a step's
collectives, FLOPs, bytes and memory (``collectives``)."""
