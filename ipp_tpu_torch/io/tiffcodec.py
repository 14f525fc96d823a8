"""TIFF planes that the JAX package reads through PIL (libtiff): LZW (5),
JPEG (7), LZMA (34925), zstd (50000) and CCITT fax (2, 3, 4), and every
plane of 1-, 2- or 4-bit samples, read as ``np.asarray(PIL.Image.open(
path))`` shows them.

``io/tiff.read_tiff`` decodes their strips and tiles (with JPEGTables,
photometric, both predictors, FillOrder 2 and separate colour planes, as
every reader of ``io/tiff`` does); this module adds PIL's view of the
samples:

- u32 samples come back as int32 (PIL's mode "I", values past 2^31
  wrapped), i16 gray as int32;
- 16-bit RGB and RGBA come back as their high bytes, u8;
- 8-bit gray with photometric 0 (white is zero; PIL's default when the
  tag is missing) comes back inverted;
- 1-bit samples come back as bool (True stored as the byte 255, as PIL
  stores it), 2- and 4-bit gray as uint8 times 85 and 17, each inverted
  first under photometric 0; 1- to 4-bit palette
  indices as stored; other photometrics of sub-byte samples raise
  ``UnsupportedTiffError``, as PIL refuses them;
- a palette plane without its ColorMap raises, as PIL does, and so does
  gray with an extra sample other than 8-bit unassociated alpha;
- every other u8 / u16 / i32 / f32 plane, gray or RGB(A), and palette
  indices, as stored (also big-endian f32, which PIL returns with its
  bytes swapped, and big-endian u32, which PIL refuses).

A TIFF of none, deflate or PackBits with whole-byte samples is read by
``io/tiff.read_tiff`` (the numpy codec), as the JAX package reads it; any
other compression that libtiff registers raises ``UnsupportedTiffError``
naming it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .tiff import (TiffError, UnsupportedTiffError, _page_from_tags,
                   _parse_ifds, _read_tiff_header, _refused, read_tiff)

__all__ = ["read_tiff_plane", "tiff_shape"]

_NUMPY_CODECS = (1, 8, 32946, 32773)   # the ones io/tiff reads itself
# the ones the JAX package gives PIL
_PIL_CODECS = (2, 3, 4, 5, 7, 34925, 50000)


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
    photometric = tags.get(262, (0,))[0]
    bits = tags.get(258, (1,))[0]
    if photometric == 3 and 320 not in tags:
        raise TiffError("a palette TIFF without its ColorMap")
    if bits < 8:
        if photometric == 3:
            if tags.get(259, (1,))[0] == 1 and tags.get(266, (1,))[0] == 2:
                raise UnsupportedTiffError(
                    f"uncompressed {bits}-bit palette TIFF in FillOrder 2 is "
                    f"not read (PIL has no unpacker for it)")
            return img
        if photometric not in (0, 1):
            raise UnsupportedTiffError(
                f"{bits}-bit samples under photometric {photometric} are "
                f"not read (0, 1 and 3 are)")
        top = np.uint8((1 << bits) - 1)
        if photometric == 0:
            img = top - img
        # 1 bit: bool stored as 0 / 255, byte for byte as PIL returns it
        vals = img * np.uint8(255 // top)
        return vals.view(bool) if bits == 1 else vals
    if img.ndim == 3 and img.shape[2] == 2:   # PIL's "LA" alone
        if img.dtype.itemsize != 1 or tags.get(338) != (2,):
            raise UnsupportedTiffError(
                f"{img.dtype.itemsize * 8}-bit gray with an extra sample "
                f"{tags.get(338, ())} is not read (8 bits with unassociated "
                f"alpha is: PIL has no other mode for it)")
        if tags.get(284, (1,))[0] == 2:   # PIL leaves LA's alpha plane out
            img = img.copy()
            img[..., 1] = 0
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
    if comp in _NUMPY_CODECS and tags.get(258, (1,))[0] >= 8:
        return read_tiff(path)
    if comp not in _PIL_CODECS + _NUMPY_CODECS:
        raise _refused(comp)
    return _pil_view(read_tiff(path), tags)
