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
- ``rgb420.jpg``: a JFIF JPEG, YCbCr 4:2:0, quality 85.
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
    return out


FILES = {   # file -> (seed, lossless)
    "lzw_u16_p2.tif": ("u16", True), "lzw_rgb.tif": ("rgb", True),
    "jpeg_gray.tif": ("gray", False), "jpeg_rgb.tif": ("rgb", False),
    "gray16.png": ("u16", True), "rgb.png": ("rgb", True),
    "pal4.png": ("idx4", True), "rgb.bmp": ("rgb", True),
    "gray.bmp": ("gray", True), "rgb420.jpg": ("rgb", False),
}


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
