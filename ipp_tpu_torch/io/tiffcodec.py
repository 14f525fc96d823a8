"""TIFF planes that the JAX package reads through PIL (libtiff): LZW (5),
JPEG (7), LZMA (34925) and zstd (50000), read as
``np.asarray(PIL.Image.open(path))`` shows them.

``io/tiff.read_tiff`` decodes their strips and tiles (with JPEGTables,
photometric and both predictors, as every reader of ``io/tiff`` does);
this module adds PIL's view of the samples:

- u32 samples come back as int32 (PIL's mode "I", values past 2^31
  wrapped), i16 gray as int32;
- 16-bit RGB and RGBA come back as their high bytes, u8;
- 8-bit gray with photometric 0 (white is zero) comes back inverted;
- every other u8 / u16 / i32 / f32 plane, gray or RGB(A), and palette
  indices, as stored (also big-endian f32, which PIL returns with its
  bytes swapped, and big-endian u32, which PIL refuses).

A TIFF of none, deflate or PackBits is read by ``io/tiff.read_tiff`` (the
numpy codec), as the JAX package reads it; any other compression that
libtiff registers raises ``UnsupportedTiffError`` naming it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .tiff import (TiffError, _page_from_tags, _parse_ifds,
                   _read_tiff_header, _refused, read_tiff)

__all__ = ["read_tiff_plane", "tiff_shape"]

_NUMPY_CODECS = (1, 8, 32946, 32773)   # the ones io/tiff reads itself
_PIL_CODECS = (5, 7, 34925, 50000)     # the ones the JAX package gives PIL


def _first_page(f):
    bo, big = _read_tiff_header(f)
    for tags in _parse_ifds(f, bo, big):
        return bo, tags
    raise TiffError("no pages")


def tiff_shape(path) -> tuple:
    """(height, width) of the first page, from its IFD alone."""
    with open(path, "rb") as f:
        _, tags = _first_page(f)
    page = _page_from_tags(tags)
    return page.length, page.width


def _pil_view(img: np.ndarray, tags) -> np.ndarray:
    photometric = tags.get(262, (1,))[0]
    if img.dtype == np.uint32:
        return img.view(np.int32)
    if img.dtype == np.int16 and img.ndim == 2:
        return img.astype(np.int32)
    if img.ndim == 3 and img.shape[2] in (3, 4) and img.dtype.itemsize == 2:
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2 and img.dtype == np.uint8 and photometric == 0:
        return np.uint8(255) - img
    return img


def read_tiff_plane(path) -> np.ndarray:
    """The first page of a TIFF as the JAX package's imread returns it."""
    path = Path(path)
    with open(path, "rb") as f:
        _, tags = _first_page(f)
    comp = tags.get(259, (1,))[0]
    if comp in _NUMPY_CODECS:
        return read_tiff(path)
    if comp not in _PIL_CODECS:
        raise _refused(comp)
    return _pil_view(read_tiff(path), tags)
