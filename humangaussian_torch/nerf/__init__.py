"""Mesh rasterization (the rest of the NeRF stack waits, ROADMAP item 21)."""
