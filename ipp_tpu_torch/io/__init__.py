"""Codecs and dataset IO of the port: copies of ipp_tpu/io tiff.py,
dcimg.py, nrrd.py, raw.py, generic2d.py, terafly.py, vaa3draw.py, ims.py,
bdv.py and precomputed.py (the port imports nothing of ipp_tpu), and
hdf5.py, the classic-HDF5 reader and writer that ims.py and bdv.py use in
place of h5py (the card's host has none).  The planes the reference reads
and writes through PIL (PNG, JPEG, BMP, PNM, LZW and JPEG TIFF, JPEG 2000)
and its .avi movies go through the port's own codecs (png.py, jpeg.py,
bmp.py, netpbm.py, tiffcodec.py, avi.py over imgcodec.py and
native/imgcodec.cpp; jpeg2000.py over native/j2k.cpp); nothing here
imports PIL."""
