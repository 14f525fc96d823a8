"""ipp_tpu_torch — the PyTorch/CUDA port of ipp_tpu for one NVIDIA H100.

The JAX package `ipp_tpu` stays the reference: every port function here is
held against its `ipp_tpu` twin in `tests/test_torch_*.py`.  This package
imports `torch` and never `jax`.  Host code that imports no jax is shared
with the reference as it is (`ipp_tpu.io.tiff`, `ipp_tpu.io.dcimg`,
`ipp_tpu.io.raw`, `ipp_tpu.io.nrrd`, `ipp_tpu.native`, `ipp_tpu.parallel.executor`,
`ipp_tpu.parallel.sandbox`, `ipp_tpu.utils.iostat`, `ipp_tpu.utils.lagged`,
`ipp_tpu.utils.log`, `ipp_tpu.utils.memory`, `ipp_tpu.utils.progress`).

Layout mirrors `ipp_tpu/`: `ops/` (DFT matrices, the hand-written CUDA
kernels of the FFT walk and of the DWT and their wrappers,
Richardson-Lucy, wavelets, destripe, the tile chain), `pipeline/` (the
deconvolution, FNT-cube and pystripe CLIs), `utils/` (device and precision policy,
host <-> device transfers), `csrc/` (the CUDA C++ sources, built with
nvcc on first use).
"""

import os as _os

from .utils.device import apply_precision_policy as _apply_precision_policy

__version__ = "0.1.0"

_apply_precision_policy()


def _load_reference_package() -> None:
    """Import the `ipp_tpu` package without letting it load jax.

    `ipp_tpu/__init__.py` imports jax to apply IPP_TPU_PLATFORM when that
    variable is set; the port reads the same variable for its own device
    policy, so it is hidden while the reference package initialises.  The
    host modules the port shares import no jax themselves."""
    saved = _os.environ.pop("IPP_TPU_PLATFORM", None)
    try:
        import ipp_tpu  # noqa: F401
    finally:
        if saved is not None:
            _os.environ["IPP_TPU_PLATFORM"] = saved


_load_reference_package()
