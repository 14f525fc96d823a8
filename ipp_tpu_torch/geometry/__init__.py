"""Tile geometry of the port: copies of ipp_tpu/geometry extent.py and
stacks.py (host only)."""
