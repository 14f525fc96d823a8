"""The Zstandard test corpus and libzstd's one-shot calls through ctypes,
shared by tests/test_torch_fastio_zstd.py and scripts/zstd_sizes.py (which
must not import the JAX package).  Inputs come from numpy seeds."""

from __future__ import annotations

import ctypes

import numpy as np

BLOCK = 128 * 1024


def _blobs(shape, rng, n=40):
    """Gaussian blobs of a few voxels' radius, peak 3000."""
    out = np.zeros(shape)
    for _ in range(n):
        c = [rng.uniform(0, s) for s in shape]
        r = rng.uniform(2, 8)
        box = tuple(slice(max(0, int(ci - 4 * r)), min(s, int(ci + 4 * r) + 1))
                    for ci, s in zip(c, shape))
        z, y, x = ((np.arange(b.start, b.stop) - ci) ** 2
                   for b, ci in zip(box, c))
        d2 = z[:, None, None] + y[None, :, None] + x[None, None, :]
        out[box] += 3000 * np.exp(-d2 / (2 * r * r))
    return out


def _smooth(a):
    """A 3-tap box blur along every axis, as a deconvolved volume is smooth."""
    a = a.astype(np.float32)
    for ax in range(a.ndim):
        a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3
    return a


def make_corpus(planes):
    """The bricks (planes x 256 x 256) and the edge cases, as bytes."""
    rng = np.random.default_rng(29)
    shape = (planes, 256, 256)
    pois = rng.poisson(100 + _blobs(shape, rng)).astype(np.uint16)
    quarter = pois.copy()
    quarter[:, :128, :128] = 0
    noise = rng.integers(0, 65536, shape, dtype=np.uint16)
    period = rng.poisson(100, 640 * 1024).astype(np.uint16).tobytes()
    tail = rng.poisson(100, 256 * 1024).astype(np.uint16).tobytes()
    raw = pois.tobytes()
    return {
        "poisson": raw,
        "zeroed_quarter": quarter.tobytes(),
        "f32_smooth": _smooth(pois).tobytes(),
        "uniform_u16": noise.tobytes(),
        "constant": bytes([7]) * 100000,
        "empty": b"",
        "one_byte": b"x",
        "block_minus_1": raw[:BLOCK - 1],
        "block": raw[:BLOCK],
        "block_plus_1": raw[:BLOCK + 1],
        # 3 MiB, past level 3's 2 MiB window: a 1.25 MiB run repeated
        "past_window": period + period + tail,
    }


def compress_bound(n):
    """libzstd's ZSTD_compressBound."""
    return n + (n >> 8) + ((BLOCK - n) >> 11 if n < BLOCK else 0)


def bind(lib):
    """`lib` with libzstd's four one-shot calls typed (the port's fastio
    library or libzstd itself)."""
    c = ctypes
    lib.ZSTD_compress.argtypes = [c.c_void_p, c.c_size_t, c.c_void_p,
                                  c.c_size_t, c.c_int]
    lib.ZSTD_compress.restype = c.c_size_t
    lib.ZSTD_decompress.argtypes = [c.c_void_p, c.c_size_t, c.c_void_p,
                                    c.c_size_t]
    lib.ZSTD_decompress.restype = c.c_size_t
    lib.ZSTD_compressBound.argtypes = [c.c_size_t]
    lib.ZSTD_compressBound.restype = c.c_size_t
    lib.ZSTD_isError.argtypes = [c.c_size_t]
    lib.ZSTD_isError.restype = c.c_uint
    return lib


def compress(lib, data, level):
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(max(cap, 1))
    got = lib.ZSTD_compress(out, cap, data, len(data), level)
    assert not lib.ZSTD_isError(got)
    return out.raw[:got]


def decompress(lib, frame, n):
    out = ctypes.create_string_buffer(max(n, 1))
    got = lib.ZSTD_decompress(out, n, frame, len(frame))
    assert not lib.ZSTD_isError(got)
    return out.raw[:got]
