"""PBM, PGM and PPM planes (P1-P6, maxval up to 65535) without PIL, read as
``np.asarray(PIL.Image.open(path))`` shows them, and written as PIL
writes them.

PIL's view, which the JAX package's readers return:

- P1 / P4: bool, True where the file holds 0 (white);
- P2 / P5 with maxval <= 255: u8, scaled to 255 unless maxval is 255;
  with maxval > 255: int32 ("I"), scaled to 65535 unless maxval is 65535;
- P3 / P6: RGB u8, scaled to 255 unless maxval is 255 (16-bit samples
  included);
- scaling is ``round(v / maxval * out_max)`` in float64, Python's round;
  raw samples are capped at out_max, plain ones past maxval refused.

The writer: bool -> P4, u8 -> P5 at 255, u16 -> P5 at 65535, RGB(A) u8
-> P6 at 255 (alpha dropped).
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

from .imgcodec import CodecError

__all__ = ["is_netpbm", "read_netpbm", "encode_netpbm"]

_WHITESPACE = b" \t\n\r\x0b\x0c"


def is_netpbm(head: bytes) -> bool:
    return len(head) >= 3 and head[0:1] == b"P" and head[1:2] in \
        b"123456" and head[2:3] in _WHITESPACE


def _tokens(data: bytes, pos: int, n: int) -> Tuple[List[int], int]:
    """n header integers from pos (comments to the end of a line skipped),
    and the position after the one whitespace byte that ends the last."""
    out = []
    while len(out) < n:
        while pos < len(data) and data[pos] in _WHITESPACE:
            pos += 1
        if pos < len(data) and data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos] not in _WHITESPACE and \
                data[pos:pos + 1] != b"#":
            pos += 1
        tok = data[start:pos]
        if not tok or len(tok) > 10 or not tok.isdigit():
            raise CodecError(f"netpbm: a bad header token {tok[:11]!r}")
        out.append(int(tok))
        if pos < len(data) and data[pos:pos + 1] == b"#":
            continue
    return out, pos + 1


def _scale(v: np.ndarray, maxval: int, out_max: int, cap: bool) -> np.ndarray:
    if maxval == out_max:
        return v
    s = np.round(v.astype(np.float64) / maxval * out_max)
    return np.minimum(s, out_max) if cap else s


def read_netpbm(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not is_netpbm(data[:3]):
        raise CodecError("netpbm: not a PBM / PGM / PPM file")
    kind = data[1] - ord("0")
    if kind in (1, 4):
        (w, h), pos = _tokens(data, 2, 2)
        if kind == 4:
            stride = (w + 7) // 8
            raw = np.frombuffer(data, np.uint8, stride * h, pos)
            bits = np.unpackbits(raw.reshape(h, stride), axis=1)[:, :w]
        else:
            digits = re.sub(rb"#[^\r\n]*", b"", data[pos - 1:])
            digits = bytes(c for c in digits if c not in _WHITESPACE)
            if len(digits) < w * h or not set(digits[:w * h]) <= {48, 49}:
                raise CodecError("netpbm: P1 data cut short or not 0 / 1")
            bits = np.frombuffer(digits, np.uint8, w * h).reshape(h, w) - 48
        return bits == 0
    (w, h, maxval), pos = _tokens(data, 2, 3)
    if not 0 < maxval < 65536:
        raise CodecError(f"netpbm: maxval {maxval}")
    bands = 3 if kind in (3, 6) else 1
    wide = maxval > 255 and bands == 1          # PIL's mode "I"
    out_max = 65535 if wide else 255
    n = w * h * bands
    if kind in (5, 6):
        dt = np.dtype(">u2" if maxval > 255 else "u1")
        if len(data) - pos < n * dt.itemsize:
            raise CodecError("netpbm: image data cut short")
        v = np.frombuffer(data, dt, n, pos)
        v = _scale(v, maxval, out_max, cap=True)
    else:
        body = re.sub(rb"#[^\r\n]*", b"", data[pos - 1:]).split()
        if len(body) < n:
            raise CodecError("netpbm: plain data cut short")
        v = np.array([int(t) for t in body[:n]], np.int64)
        if (v > maxval).any():
            raise CodecError("netpbm: a sample past maxval")
        v = _scale(v, maxval, out_max, cap=False)
    v = np.asarray(v).astype(np.int32 if wide else np.uint8)
    return v.reshape(h, w, 3) if bands == 3 else v.reshape(h, w)


def encode_netpbm(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    h, w = img.shape[:2]
    if img.dtype == bool and img.ndim == 2:
        body = np.packbits(~img, axis=1).tobytes()
        return b"P4\n%d %d\n" % (w, h) + body
    if img.ndim == 2 and img.dtype == np.uint8:
        return b"P5\n%d %d\n255\n" % (w, h) + img.tobytes()
    if img.ndim == 2 and img.dtype == np.uint16:
        return b"P5\n%d %d\n65535\n" % (w, h) + img.astype(">u2").tobytes()
    if img.ndim == 3 and img.shape[2] in (3, 4) and img.dtype == np.uint8:
        return b"P6\n%d %d\n255\n" % (w, h) + \
            np.ascontiguousarray(img[..., :3]).tobytes()
    raise CodecError(f"netpbm: cannot write {img.dtype} {img.shape}")
