"""Geometry, encoding, sampling and compositing ops (torch)."""
