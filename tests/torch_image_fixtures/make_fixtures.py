"""Write the image fixtures that the port reads on hosts without PIL: run
``python tests/torch_image_fixtures/make_fixtures.py`` (PIL needed) and
commit the files it writes with ``fixtures.json``.

Each file holds a 96 x 128 plane made by ``seeds()`` from numpy seeds,
which needs only numpy, so a reader can regenerate what a lossless file
must hold; ``fixtures.json`` gives, for every file, its seed, whether it
is lossless, and the sha256 of the array PIL decodes from it here
(``np.asarray(PIL.Image.open(path))``: its shape, dtype string and bytes),
which a lossy file's decode must match bit for bit:

- ``lzw_u16_p2.tif``: u16 gray, LZW with the horizontal predictor;
- ``lzw_rgb.tif``: RGB u8, LZW;
- ``jpeg_gray.tif`` / ``jpeg_rgb.tif``: JPEG-in-TIFF (quality 90) with
  the tables in JPEGTables, as PIL's libtiff writes it;
- ``gray16.png``, ``rgb.png`` and ``pal4.png`` (4-bit palette: PIL reads
  the indices);
- ``rgb.bmp`` (24 bits) and ``gray.bmp`` (8 bits with a gray ramp);
- ``rgb420.jpg``: a JFIF JPEG, YCbCr 4:2:0, quality 85;
- ``prog_gray.jpg``, ``prog_rgb420.jpg``, ``prog_rgb444.jpg``: progressive
  JPEGs (``progressive=True``: libjpeg's scan script, optimised tables);
  ``prog_rgb420_rst.jpg`` with a restart marker every 5 blocks;
  ``prog_keep_rgb.jpg`` of RGB components (Adobe transform 0);
- ``cmyk.jpg`` and ``prog_cmyk.jpg``: four components with PIL's Adobe
  APP14 segment (transform 0); ``ycck.jpg``, the same bytes with that
  transform set to 2 (libjpeg turns YCCK to CMYK); ``cmyk_noapp14.jpg``
  without the segment (libjpeg assumes CMYK);
- ``prog_rgb420_cut3.jpg``: ``prog_rgb420.jpg`` cut after its third scan,
  EOI appended, which libjpeg-turbo decodes with its block smoothing of
  the coefficients not yet refined.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SHAPE = (96, 128)


def seeds() -> dict:
    """name -> the array a fixture is made from."""
    h, w = SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = {}
    rng = np.random.default_rng(240)
    field = 0.5 + 0.3 * np.sin(xx / 9.0 + yy / 13.0)
    out["u16"] = np.clip(30000 * field + rng.normal(0, 400, (h, w)), 0,
                         65535).astype(np.uint16)
    rgb = field[..., None] * np.array([0.9, 0.7, 0.5]) * 255
    out["rgb"] = np.clip(rgb + rng.normal(0, 6, (h, w, 3)), 0,
                         255).astype(np.uint8)
    out["gray"] = out["rgb"][..., 1].copy()
    out["idx4"] = rng.integers(0, 16, (h, w)).astype(np.uint8)
    out["cmyk"] = np.concatenate(
        [255 - out["rgb"], (80 * field).astype(np.uint8)[..., None]], -1)
    return out


FILES = {   # file -> (seed, lossless)
    "lzw_u16_p2.tif": ("u16", True), "lzw_rgb.tif": ("rgb", True),
    "jpeg_gray.tif": ("gray", False), "jpeg_rgb.tif": ("rgb", False),
    "gray16.png": ("u16", True), "rgb.png": ("rgb", True),
    "pal4.png": ("idx4", True), "rgb.bmp": ("rgb", True),
    "gray.bmp": ("gray", True), "rgb420.jpg": ("rgb", False),
    "prog_gray.jpg": ("gray", False), "prog_rgb420.jpg": ("rgb", False),
    "prog_rgb444.jpg": ("rgb", False), "prog_rgb420_rst.jpg": ("rgb", False),
    "prog_keep_rgb.jpg": ("rgb", False), "cmyk.jpg": ("cmyk", False),
    "prog_cmyk.jpg": ("cmyk", False), "ycck.jpg": ("cmyk", False),
    "cmyk_noapp14.jpg": ("cmyk", False),
    "prog_rgb420_cut3.jpg": ("rgb", False),
}


def jpeg_segments(data: bytes):
    """(marker, start, end) of each segment of a JPEG after SOI; a scan
    runs to the marker after its entropy-coded data."""
    i, out = 2, []
    while i + 1 < len(data):
        m = data[i + 1]
        if m == 0xD9:
            out.append((m, i, i + 2))
            break
        j = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if m == 0xDA:
            while not (data[j] == 0xFF and data[j + 1] != 0 and
                       not 0xD0 <= data[j + 1] <= 0xD7):
                j += 1
        out.append((m, i, j))
        i = j
    return out


def cut_after_scan(data: bytes, k: int) -> bytes:
    """A JPEG cut after its k-th scan, EOI appended."""
    scans = [end for m, _, end in jpeg_segments(data) if m == 0xDA]
    return data[:scans[k - 1]] + b"\xff\xd9"


def adobe_transform(data: bytes, transform) -> bytes:
    """The Adobe APP14 segment's transform byte set (None: the segment
    taken out)."""
    out = bytearray(data[:2])
    for m, a, b in jpeg_segments(data):
        seg = bytearray(data[a:b])
        if m == 0xEE and seg[4:9] == b"Adobe":
            if transform is None:
                continue
            seg[15] = transform
        out += seg
    return bytes(out)


def digest(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.shape} {a.dtype.str}".encode() +
                          a.tobytes()).hexdigest()


def write(out: Path = HERE) -> dict:
    from PIL import Image, TiffImagePlugin

    s = seeds()
    out.mkdir(parents=True, exist_ok=True)
    pred = TiffImagePlugin.ImageFileDirectory_v2()
    pred[317] = 2
    Image.fromarray(s["u16"]).save(out / "lzw_u16_p2.tif",
                                   compression="tiff_lzw", tiffinfo=pred)
    Image.fromarray(s["rgb"]).save(out / "lzw_rgb.tif",
                                   compression="tiff_lzw")
    for name in ("gray", "rgb"):
        Image.fromarray(s[name]).save(out / f"jpeg_{name}.tif",
                                      compression="jpeg", quality=90)
    Image.fromarray(s["u16"]).save(out / "gray16.png")
    Image.fromarray(s["rgb"]).save(out / "rgb.png")
    pal = Image.fromarray(s["idx4"], "P")
    pal.putpalette([(17 * i) % 256 for i in range(48)])
    pal.save(out / "pal4.png", bits=4)
    Image.fromarray(s["rgb"]).save(out / "rgb.bmp")
    Image.fromarray(s["gray"]).save(out / "gray.bmp")
    Image.fromarray(s["rgb"]).save(out / "rgb420.jpg", quality=85)
    Image.fromarray(s["gray"]).save(out / "prog_gray.jpg", quality=85,
                                    progressive=True)
    for sub, name in ((2, "rgb420"), (0, "rgb444")):
        Image.fromarray(s["rgb"]).save(out / f"prog_{name}.jpg", quality=85,
                                       subsampling=sub, progressive=True)
    Image.fromarray(s["rgb"]).save(out / "prog_rgb420_rst.jpg", quality=85,
                                   progressive=True, restart_marker_blocks=5)
    Image.fromarray(s["rgb"]).save(out / "prog_keep_rgb.jpg", quality=85,
                                   progressive=True, keep_rgb=True)
    cmyk = Image.frombytes("CMYK", SHAPE[::-1], s["cmyk"].tobytes())
    cmyk.save(out / "cmyk.jpg", quality=85)
    cmyk.save(out / "prog_cmyk.jpg", quality=85, progressive=True)
    data = (out / "cmyk.jpg").read_bytes()
    (out / "ycck.jpg").write_bytes(adobe_transform(data, 2))
    (out / "cmyk_noapp14.jpg").write_bytes(adobe_transform(data, None))
    (out / "prog_rgb420_cut3.jpg").write_bytes(
        cut_after_scan((out / "prog_rgb420.jpg").read_bytes(), 3))
    manifest = {}
    for name, (seed, lossless) in FILES.items():
        a = np.asarray(Image.open(out / name))
        if lossless and not np.array_equal(a, s[seed]):
            raise AssertionError(f"{name} does not hold its seed")
        manifest[name] = dict(seed=seed, lossless=lossless, sha256=digest(a))
    (out / "fixtures.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


if __name__ == "__main__":
    for k, v in write().items():
        print(k, v)
