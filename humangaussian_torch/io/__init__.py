"""Scene file formats (PLY)."""
