"""Write the JPEG 2000 fixtures that the port reads on hosts without PIL:
run ``python tests/torch_jpeg2000_fixtures/make_fixtures.py`` (PIL with
OpenJPEG needed) and commit the files it writes with ``fixtures.json``.

Each file holds a 96 x 128 plane made by ``seeds()`` from numpy seeds
(numpy alone), saved by PIL's JPEG 2000 writer with the options `FILES`
names.  ``fixtures.json`` holds the PIL and OpenJPEG versions that wrote
them and, for every file, its seed, its options, whether it is lossless,
and the sha256 of the array PIL decodes from it here
(``np.asarray(PIL.Image.open(path))``: its shape, dtype string and
bytes), which the port's decode must match bit for bit.  They cover PIL's
defaults (L, I;16, LA, RGB, RGBA), a raw codestream (``no_jp2``), the
9/7 wavelet (with the ICT on RGB), the RCT, tiles with edge tiles (the
lowest resolution of some empty), every
progression order, user precincts, a non-square code-block, one and three
resolutions, three quality layers and PLT markers.
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
    rng = np.random.default_rng(250)
    field = 0.5 + 0.3 * np.sin(xx / 9.0 + yy / 13.0)
    out = {"u16": np.clip(30000 * field + rng.normal(0, 400, (h, w)), 0,
                          65535).astype(np.uint16)}
    rgba = field[..., None] * np.array([0.9, 0.7, 0.5, 0.8]) * 255
    rgba = np.clip(rgba + rng.normal(0, 6, (h, w, 4)), 0, 255)
    out["rgba"] = rgba.astype(np.uint8)
    out["rgb"] = out["rgba"][..., :3].copy()
    out["la"] = out["rgba"][..., 1:3].copy()
    out["u8"] = out["rgba"][..., 0].copy()
    return out


PRECINCTS = dict(precinct_size=(32, 32))
FILES = {   # file -> (seed, PIL's save options)
    "default_u8.jp2": ("u8", {}),
    "default_u16.jp2": ("u16", {}),
    "default_la.jp2": ("la", {}),
    "default_rgb.jp2": ("rgb", {}),
    "default_rgba.jp2": ("rgba", {}),
    "raw_u16.j2k": ("u16", dict(no_jp2=True)),
    "irreversible_u16.jp2": ("u16", dict(irreversible=True)),
    "irreversible_rgb_ict.jp2": ("rgb", dict(irreversible=True, mct=1)),
    "rct_rgb.jp2": ("rgb", dict(mct=1)),
    # edge tiles 32 wide and 16 tall; the bottom row's lowest resolution
    # is empty
    "tiles_u8.jp2": ("u8", dict(tile_size=(48, 40))),
    # the same tiles at 16 bits, which PIL 12.1's writer does not keep
    # lossless (its 16-bit tile packing): the port reads PIL's bits
    "tiles_u16.jp2": ("u16", dict(tile_size=(48, 40))),
    "prog_rlcp_rgb.jp2": ("rgb", dict(progression="RLCP", **PRECINCTS)),
    "prog_rpcl_rgb.jp2": ("rgb", dict(progression="RPCL", **PRECINCTS)),
    "prog_pcrl_rgb.jp2": ("rgb", dict(progression="PCRL", **PRECINCTS)),
    "prog_cprl_rgb.jp2": ("rgb", dict(progression="CPRL", **PRECINCTS)),
    "precincts_u16.jp2": ("u16", dict(precinct_size=(64, 32))),
    "codeblock_16x64_u8.jp2": ("u8", dict(codeblock_size=(16, 64))),
    "resolutions_1_u16.jp2": ("u16", dict(num_resolutions=1)),
    "resolutions_3_u16.jp2": ("u16", dict(num_resolutions=3)),
    "layers_3_u16.jp2": ("u16", dict(quality_layers=[60, 20, 5])),
    "layers_3_irreversible_rgb.jp2": (
        "rgb", dict(quality_layers=[40, 12, 3], irreversible=True, mct=1,
                    progression="RPCL", **PRECINCTS)),
    "plt_u8.jp2": ("u8", dict(plt=True)),
}


def lossless(name: str, options: dict) -> bool:
    return not options.get("irreversible") and not options.get(
        "quality_layers") and name != "tiles_u16.jp2"


def digest(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.shape} {a.dtype.str}".encode() +
                          a.tobytes()).hexdigest()


def write(out: Path = HERE) -> dict:
    """Write every fixture into `out` and return the manifest."""
    import PIL
    from PIL import Image, features

    s = seeds()
    out.mkdir(parents=True, exist_ok=True)
    files = {}
    for name, (seed, options) in FILES.items():
        Image.fromarray(s[seed]).save(out / name, format="JPEG2000",
                                      **options)
        with Image.open(out / name) as im:
            got = np.asarray(im)
        files[name] = dict(seed=seed, options=options,
                           lossless=lossless(name, options), sha256=digest(got))
    manifest = dict(pil=PIL.__version__,
                    openjpeg=features.version("jpg_2000"), files=files)
    (out / "fixtures.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


if __name__ == "__main__":
    m = write()
    print(f"{len(m['files'])} fixtures, PIL {m['pil']}, OpenJPEG "
          f"{m['openjpeg']}")
