"""Device ops of the port: DFT matrices, the CUDA FFT-walk kernels and
their wrappers, and Richardson-Lucy deconvolution.  Submodules are
imported explicitly; this package imports none of them itself."""
