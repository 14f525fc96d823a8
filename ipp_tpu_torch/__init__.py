"""ipp_tpu_torch — the PyTorch/CUDA port of ipp_tpu for one NVIDIA H100.

The JAX package `ipp_tpu` stays the reference: every port function here is
held against its `ipp_tpu` twin in `tests/test_torch_*.py`.  This package
imports `torch` and never `jax`, and nothing of `ipp_tpu`: host code it
needs from the reference is copied, keeping the reference's layout and
names (`io/` tiff, dcimg, nrrd, raw, generic2d, terafly, vaa3draw, ims,
bdv, precomputed; `native/` with `fastio.cpp`; `parallel/executor.py`,
`parallel/sandbox.py`; `geometry/extent.py`, `geometry/stacks.py`;
`stitch/place.py`; `pipeline/scan_stitch.py`, `flip.py`,
`command_generator.py`; `utils/iostat.py`, `lagged.py`, `log.py`,
`memory.py`, `progress.py`, `tifstack.py`, `checkfiles.py`, `cli.py`,
`markers.py`, `reconops.py`; the tests pin each copy to its original).

Layout mirrors `ipp_tpu/`: `ops/` (DFT matrices, the hand-written CUDA
kernels of the FFT walk and of the DWT and their wrappers,
Richardson-Lucy, wavelets, destripe, lightsheet correction, the tile
chain, NCC maps, resampling), `stitch/` (alignment, placement, blend,
merge, the Dragonfly scanner), `geometry/` (tile extents and grids),
`pipeline/` (the deconvolution, FNT-cube, pystripe, process_images,
channel alignment and merge, converter, scanner and tsv CLIs), `io/`,
`native/` and `parallel/` (host IO), `utils/` (device and precision
policy, host <-> device transfers, logging and progress), `csrc/` (the
CUDA C++ sources, built with nvcc on first use).

Every FFT convolution takes one of three routes, chosen from its work
shape before anything launches, by one rule on every device
(`ops.deconv.conv_route`): "walk" (the v2 kernel walk, inside its domain)
and "fft" (torch.fft, for every other shape); "walk1" (the v1 kernel walk)
only when a caller forces it.  On CPU tensors the walks run their
kernels' plain PyTorch versions.
"""

from .utils.device import apply_precision_policy as _apply_precision_policy

__version__ = "0.1.0"

_apply_precision_policy()
