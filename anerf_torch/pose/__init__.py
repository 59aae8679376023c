"""Trainable per-frame pose refinement (torch)."""
