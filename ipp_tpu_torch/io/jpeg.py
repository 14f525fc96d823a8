"""JPEG planes without PIL: baseline, extended-sequential and progressive
Huffman JPEGs (SOF0 / SOF1 / SOF2), 8-bit, gray, YCbCr (or RGB) at any
integral sampling factors, and CMYK or YCCK, with restart intervals, read
as ``np.asarray(PIL.Image.open(path))`` shows them: the same pixels as
libjpeg(-turbo)'s decoder at its defaults (islow IDCT, fancy upsampling;
for a progression cut short, libjpeg-turbo 2.1's block smoothing of the
coefficients its scans left unrefined), (h, w) u8, (h, w, 3) RGB or
(h, w, 4) CMYK, the latter inverted as PIL's "CMYK;I" hands out every
four-component JPEG (YCCK turned to CMYK first).  Written as PIL writes
them at its defaults: quality 75, one component for gray, YCbCr 4:2:0 for
RGB, JFIF APP0, the standard Huffman tables.

The codec itself is ``native/imgcodec.cpp`` (``io/imgcodec.py``).
Arithmetic-coded (SOF9-11, DAC), lossless (SOF3), hierarchical and 12-bit
JPEGs raise ``CodecError`` naming what they are, as does a malformed
progression.
"""

from __future__ import annotations

import numpy as np

from .imgcodec import CodecError, jpeg_decode, jpeg_encode

__all__ = ["SIGNATURE", "read_jpeg", "encode_jpeg"]

SIGNATURE = b"\xff\xd8\xff"


def read_jpeg(path) -> np.ndarray:
    with open(path, "rb") as f:
        return jpeg_decode(f.read())


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """PIL's JPEG of a plane: bool (as 0 / 255) and u8 gray, RGB u8."""
    img = np.asarray(img)
    if img.dtype == bool and img.ndim == 2:
        img = img.astype(np.uint8) * np.uint8(255)
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.shape[2] == 3):
        raise CodecError(f"JPEG: cannot write {img.dtype} {img.shape}")
    return jpeg_encode(img, quality)
