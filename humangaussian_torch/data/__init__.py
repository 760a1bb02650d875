"""Camera data (evaluation orbits)."""
