"""Inference engines of the port (v2 ragged engine in this slice)."""
