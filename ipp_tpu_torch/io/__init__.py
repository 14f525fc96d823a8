"""Codecs and dataset IO of the port: copies of ipp_tpu/io tiff.py,
dcimg.py, nrrd.py, raw.py, generic2d.py, terafly.py, vaa3draw.py and
ims.py (the port imports nothing of ipp_tpu; h5py and PIL load lazily,
where the reading or writing needs them)."""
