"""Generic 2D plane codec — the opencv2D / bioformats2D plugin role.

The reference's TeraStitcher build ships two OPTIONAL 2D input plugins
(both OFF by default, iomanager/CMakeLists.txt:11-17):

- opencv2D (plugins/opencv2D/opencv2D.cpp:110): BMP, DIB, JPEG/JPG/JPE,
  PNG, PBM, PGM, PPM, SR, RAS, TIFF
- bioformats2D (plugins/bioformats2D + bioformats3D/bioformats_basecode.inc):
  embeds a JVM + user-supplied bioformats_package.jar for proprietary
  formats

The JAX package fills the role with PIL; the port with codecs of its own,
which return what ``np.asarray(PIL.Image.open(path))`` returns (io/png.py,
io/jpeg.py, io/bmp.py, io/netpbm.py, io/tiffcodec.py; their docstrings
list PIL's quirks, io/jpeg2000.py OpenJPEG's) and write what PIL writes.
`read_plane` picks the codec by the file's signature, as PIL does, not by
its suffix.  No format is left on PIL.
Tile/series discovery accepts these suffixes (geometry/stacks.py,
pipeline/convert._open_source).  Formats that genuinely need Bio-Formats
(czi, nd2, lif, vsi, oib, ...) are out of scope — see docs/PARITY.md
§"bioformats format table" for the per-format disposition.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from . import jpeg, jpeg2000, png
from . import tiff as _tio

__all__ = ["GENERIC_2D_SUFFIXES", "PLANE_SUFFIXES", "imread_generic",
           "imwrite_generic", "read_plane"]

# the opencv2D surface + JPEG-2000
GENERIC_2D_SUFFIXES = (".png", ".jp2", ".j2k", ".jpg", ".jpeg", ".jpe",
                       ".bmp", ".dib", ".pbm", ".pgm", ".ppm")

# everything a plane-series directory may contain (tiff/raw native codecs
# + the generic 2D set)
PLANE_SUFFIXES = (".tif", ".tiff", ".raw") + GENERIC_2D_SUFFIXES

_TIFF = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")


def read_plane(path) -> np.ndarray:
    """Decode one plane with the codec its first bytes name."""
    from .imgcodec import CodecError

    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] in _TIFF:
        from .tiffcodec import read_tiff_plane

        return read_tiff_plane(path)
    if head.startswith(png.SIGNATURE):
        return png.read_png(path)
    if head.startswith(jpeg.SIGNATURE):
        return jpeg.read_jpeg(path)
    if head[:2] == b"BM":
        from .bmp import read_bmp

        return read_bmp(path)
    from .netpbm import is_netpbm, read_netpbm

    if is_netpbm(head):
        return read_netpbm(path)
    if head.startswith(jpeg2000.SIGNATURES):
        return jpeg2000.read_jpeg2000(path)
    raise CodecError(f"{path}: not a TIFF, PNG, JPEG, BMP, PBM / PGM / PPM "
                     f"or JPEG 2000 file (first bytes {head[:8]!r})")


def imread_generic(path) -> np.ndarray:
    """Decode any generic 2D plane (io.tiff.imread's last leg; 16-bit
    PNG come back as uint16)."""
    return _tio.imread(path)


def imwrite_generic(path, img: np.ndarray) -> None:
    """Atomic write for generic formats, format from the suffix (the
    opencv2D writeData role).  JPEG 2000 is written with the JP2 boxes for
    .j2k too, as PIL writes it through the .tmp name."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    suffix = path.suffix.lower()
    if suffix == ".png":
        encode = png.encode_png
    elif suffix in (".jpg", ".jpeg", ".jpe"):
        encode = jpeg.encode_jpeg
    elif suffix in (".jp2", ".j2k"):
        encode = jpeg2000.encode_jpeg2000
    elif suffix in (".bmp", ".dib"):
        from .bmp import encode_bmp as encode
    elif suffix in (".pbm", ".pgm", ".ppm"):
        from .netpbm import encode_netpbm as encode
    else:
        raise KeyError(suffix)
    tmp.write_bytes(encode(img))
    os.replace(tmp, path)
