"""FFT helpers shared by NCC and deconvolution.

next_fast_len mirrors the reference's FFT-friendly padding
(LsDeconvolveMultiGPU/LsDeconv.m:387-419 pads blocks to 2,3,5,7-smooth
sizes); awkward (large-prime) FFT lengths are also pathologically slow to
compile/run in XLA, so every FFT in this package goes through these sizes.

A copy of ipp_tpu/ops/fftutil.py, which cannot be imported without jax.
The port's torch.fft route pads to the same sizes as the reference's XLA
route, so the two compute on identical work shapes.
"""

from __future__ import annotations

import functools

__all__ = ["next_fast_len"]


@functools.lru_cache(maxsize=4096)
def next_fast_len(n: int) -> int:
    """Smallest 2,3,5,7-smooth integer >= n."""
    if n <= 1:
        return 1

    def is_smooth(m: int) -> bool:
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        return m == 1

    m = n
    while not is_smooth(m):
        m += 1
    return m
