"""SMPL-X body model and linear blend skinning."""
