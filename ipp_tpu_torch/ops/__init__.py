"""Device ops of the port: DFT matrices, the CUDA FFT-walk and DWT
kernels and their wrappers, Richardson-Lucy deconvolution, and the
destripe tile chain (wavelets, destripe, intensity, resample, process).
Submodules are imported explicitly; this package imports none of them
itself."""
