"""Artifact saving."""
