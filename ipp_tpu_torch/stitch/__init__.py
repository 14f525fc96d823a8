"""The stitch chain of the port: pairwise NCC displacements (align.py),
placement (place.py, a copy of the reference's host graph code), the
blend of one z plane (blend.py) and the merge to a TIFF series with its
downsampled npz (merge.py)."""
