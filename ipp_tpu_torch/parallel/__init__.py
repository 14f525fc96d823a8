"""Host-side parallel IO of the port: copies of ipp_tpu/parallel
executor.py (the tile pipeline) and sandbox.py (the killable reader)."""
