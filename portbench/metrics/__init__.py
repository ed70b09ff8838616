"""Per-layer metric readers, one file each: `read(ctx) -> float | None`."""
