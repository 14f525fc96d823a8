"""JPEG planes without PIL: baseline and extended-sequential Huffman JPEGs
(SOF0 / SOF1), 8-bit, gray or YCbCr at any integral sampling factors, with
restart intervals, read as ``np.asarray(PIL.Image.open(path))`` shows
them: the same pixels as libjpeg(-turbo)'s decoder at its defaults (islow
IDCT, fancy upsampling), (h, w) u8 or (h, w, 3) RGB.  Written as PIL
writes them at its defaults: quality 75, one component for gray, YCbCr
4:2:0 for RGB, JFIF APP0, the standard Huffman tables.

The codec itself is ``native/imgcodec.cpp`` (``io/imgcodec.py``).
Progressive (SOF2), arithmetic-coded, lossless, hierarchical, 12-bit and
CMYK / YCCK JPEGs raise ``CodecError`` naming what they are.
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
