""".raw memmap codec (reference: pystripe/raw.py:9-68, tsv/raw.py).

Format: 2 uint32 header words (width, height) at offset 0, then row-major
uint16 pixels from byte 8; endianness of header AND pixels is guessed by
decoding the width both ways and keeping the smaller (valid for widths
< 64K, exactly the reference's heuristic).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

__all__ = ["raw_imread", "raw_imsave"]


def raw_imread(path: Union[str, Path], dtype=None, shape=None) -> np.ndarray:
    path = Path(path)
    if dtype is None or shape is None:
        header = np.fromfile(path, dtype="<u4", count=2)
        w_le, h_le = int(header[0]), int(header[1])
        w_be, h_be = int(header.byteswap()[0]), int(header.byteswap()[1])
        # reference heuristic: the smaller decoded width wins
        # (pystripe/raw.py:33-39)
        if w_le < w_be:
            shape, dtype = (h_le, w_le), "<u2"
        else:
            shape, dtype = (h_be, w_be), ">u2"
    return np.memmap(path, dtype=dtype, mode="r", offset=8, shape=tuple(shape))


def raw_imsave(path: Union[str, Path], img: np.ndarray) -> None:
    img = np.ascontiguousarray(img, dtype=np.uint16)
    h, w = img.shape
    with open(path, "wb") as f:
        np.array([w, h], dtype=np.uint32).tofile(f)
        img.tofile(f)
