"""Codecs and dataset IO of the port: copies of ipp_tpu/io tiff.py,
dcimg.py, nrrd.py, raw.py, generic2d.py, terafly.py, vaa3draw.py, ims.py,
bdv.py and precomputed.py (the port imports nothing of ipp_tpu), and
hdf5.py, the classic-HDF5 reader and writer that ims.py and bdv.py use in
place of h5py (the card's host has none).  PIL loads lazily, where a plane
needs it."""
