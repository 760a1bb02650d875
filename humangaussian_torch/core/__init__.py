"""Core types: SH, cameras, the padded Gaussian scene."""
