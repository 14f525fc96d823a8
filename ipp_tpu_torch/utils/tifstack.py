"""Lazy z-indexed TIFF stack reader
(reference supplements/tifstack.py:11-49)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Union

from ..io import tiff as tio

__all__ = ["TifStack", "natural_sorted"]


def natural_sorted(items):
    def key(s):
        return [int(t) if t.isdigit() else t.lower()
                for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


class TifStack:
    """Loads one z slice at a time; all planes assumed equal shape."""

    def __init__(self, input_directory: Union[Path, str], z_offset: int = 0):
        self.input_directory = Path(input_directory)
        self.z_offset = z_offset
        files = [f for f in self.input_directory.iterdir()
                 if f.is_file() and f.suffix.lower() in (".tif", ".tiff")]
        self.files = [Path(f) for f in natural_sorted(files)]
        if not self.files:
            raise FileNotFoundError(f"no TIFFs in {input_directory}")
        img = tio.imread(self.files[0])
        self.dtype = img.dtype
        self.nyx = img.shape
        self.nz = len(self.files)
        self.shape = (self.nz, *self.nyx)

    def __getitem__(self, i: int):
        i += self.z_offset
        if i < 0 or i >= self.nz:
            return None
        return tio.imread(self.files[i])

    def __len__(self):
        return self.nz

    def close(self):
        pass
