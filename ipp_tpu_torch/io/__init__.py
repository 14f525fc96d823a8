"""Codecs of the port: copies of ipp_tpu/io tiff.py, dcimg.py and
nrrd.py (the port imports nothing of ipp_tpu)."""
