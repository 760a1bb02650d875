"""Training: per-group Adam and the photo-3DGS trainer."""
