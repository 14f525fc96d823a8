"""Generic 2D plane codec — the opencv2D / bioformats2D plugin role.

The reference's TeraStitcher build ships two OPTIONAL 2D input plugins
(both OFF by default, iomanager/CMakeLists.txt:11-17):

- opencv2D (plugins/opencv2D/opencv2D.cpp:110): BMP, DIB, JPEG/JPG/JPE,
  PNG, PBM, PGM, PPM, SR, RAS, TIFF
- bioformats2D (plugins/bioformats2D + bioformats3D/bioformats_basecode.inc):
  embeds a JVM + user-supplied bioformats_package.jar for proprietary
  formats

Here the same role is filled by a PIL-backed codec: every opencv2D format
plus JPEG-2000 (.jp2/.j2k, incl. 16-bit) and 16-bit PNG decode through
`ipp_tpu.io.tiff.imread`'s PIL fallback, and tile/series discovery accepts
these suffixes (geometry/stacks.py, pipeline/convert._open_source).
Formats that genuinely need Bio-Formats (czi, nd2, lif, vsi, oib, ...)
are out of scope — see docs/PARITY.md §"bioformats format table" for the
per-format disposition.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import tiff as _tio

__all__ = ["GENERIC_2D_SUFFIXES", "PLANE_SUFFIXES", "imread_generic",
           "imwrite_generic"]

# the opencv2D surface + JPEG-2000; all decodable by the shipped PIL
GENERIC_2D_SUFFIXES = (".png", ".jp2", ".j2k", ".jpg", ".jpeg", ".jpe",
                       ".bmp", ".dib", ".pbm", ".pgm", ".ppm")

# everything a plane-series directory may contain (tiff/raw native codecs
# + the generic 2D set)
PLANE_SUFFIXES = (".tif", ".tiff", ".raw") + GENERIC_2D_SUFFIXES


def imread_generic(path) -> np.ndarray:
    """Decode any generic 2D plane (PIL fallback path of io.tiff.imread;
    16-bit PNG/JP2 come back as uint16)."""
    return _tio.imread(path)


def imwrite_generic(path, img: np.ndarray) -> None:
    """Atomic PIL-encoded write for generic formats, format from the
    suffix (the opencv2D writeData role)."""
    import os

    from PIL import Image

    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    # the .tmp suffix hides the real format from PIL: pass it explicitly
    fmt = {".png": "PNG", ".jp2": "JPEG2000", ".j2k": "JPEG2000",
           ".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG",
           ".bmp": "BMP", ".dib": "BMP",
           ".pbm": "PPM", ".pgm": "PPM", ".ppm": "PPM"}[path.suffix.lower()]
    Image.fromarray(img).save(tmp, format=fmt)
    os.replace(tmp, path)
