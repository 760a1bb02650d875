"""Rasterizer ops: projection, binning, compositing, oracle."""
