"""The port's process_images CLI against the JAX package's, end to end.

One channel of the mini-brain phantom (tests/test_minibrain.py: 2 x 2
tiles of 120 x 120, 6 planes, jitter 2) through `main` of both packages
with the same flags: the placement XMLs give equal offsets, the stitched
u16 series lie within 1 count, the downsampled npz within 1e-4 of its
max.  Then a second run with bleach correction (the merge's coif15
destripe through K5's plain version here), background subtraction (the
lightsheet stage on the merged planes) and 8-bit output; the placement
XML of each package driving the other's merge; `--rgb-composite` raising
NotImplementedError; and both parsers agreeing on a full flag set."""

import xml.etree.ElementTree as ET

import numpy as np
import pytest
from scipy import ndimage

from ipp_tpu.io import tiff as tio
from ipp_tpu.pipeline import align_channels as AC
from ipp_tpu.pipeline import merge_channels as JM
from ipp_tpu.pipeline import process_images as J
from ipp_tpu_torch.pipeline import process_images as P
from tests.synth import cut_tiles, make_phantom, write_tile_grid

CH = "Ex_488_Em_525"
CH2 = "Ex_561_Em_600"
SHIFT2 = (1, -3, 4)
FLAGS = ["--objective", "15x", "--sigma1", "24", "--sigma2", "24",
         "--wavelet", "db3", "--search-radius", "6", "--subvol-dim", "6",
         "--downsampled-voxel", "4.0", "--nthreads", "2"]
POST = ["--bleach-correction", "--background-subtraction",
        "--convert-to-8bit"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("IPP_TPU_PROGRESS", "off")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    rng = np.random.default_rng(5)
    root = tmp_path_factory.mktemp("stitch")
    vol = make_phantom(rng, (6, 200, 200), smooth=6.0)
    stripes = 1.0 + 0.25 * np.sin(np.arange(200) / 3.0)[None, None, :]
    tiles, _ = cut_tiles(vol * stripes, 2, 2, (120, 120), 48, jitter=2,
                         rng=np.random.default_rng(7))
    (root / "raw" / CH).mkdir(parents=True)
    write_tile_grid(root / "raw" / CH, tiles, overlap_nominal_px=48,
                    voxel_um=(0.41, 0.41, 0.2))
    return root


def _run(main, root, tag, extra=()):
    """One CLI run into root/<tag>; returns its stitched directory."""
    st = root / f"{tag}_stitched"
    rc = main(["--input", str(root / "raw"), "--preprocessed",
               str(root / f"{tag}_pre"), "--stitched", str(st), *FLAGS,
               *extra])
    assert rc == 0
    return st


@pytest.fixture(scope="module")
def runs(raw, monkeypatch_module):
    return {name: _run(main, raw, name) for name, main in
            (("port", P.main), ("jax", J.main))}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setenv("IPP_TPU_PLATFORM", "cpu")
    mp.setenv("IPP_TPU_PROGRESS", "off")
    yield mp
    mp.undo()


def _offsets(xml_path):
    root = ET.parse(xml_path).getroot()
    return sorted((s.get("ROW"), s.get("COL"), s.get("ABS_V"), s.get("ABS_H"),
                   s.get("ABS_D")) for s in root.iter("Stack"))


def _series(d):
    return sorted(p.name for p in d.glob("*.tif"))


def _same_series(a_dir, b_dir, dtype=np.uint16):
    names = _series(b_dir)
    assert names and _series(a_dir) == names
    for n in names:
        a, b = tio.imread(a_dir / n), tio.imread(b_dir / n)
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1, n


def _same_npz(a_dir, b_dir, atol=None):
    """The npz volumes agree within `atol`, by default 1e-4 of their max."""
    a = np.load(sorted(a_dir.glob(f"{CH}_zyx*.npz"))[0], allow_pickle=True)
    b = np.load(sorted(b_dir.glob(f"{CH}_zyx*.npz"))[0], allow_pickle=True)
    assert a["I"].shape == b["I"].shape and a["I"].dtype == b["I"].dtype
    if atol is None:
        atol = 1e-4 * float(np.abs(b["I"]).max())
    np.testing.assert_allclose(a["I"], b["I"], atol=atol)
    for xa, xb in zip(a["xI"], b["xI"]):
        np.testing.assert_array_equal(xa, xb)


def test_placement_offsets_equal(runs):
    xa = runs["port"] / f"{CH}_placement.xml"
    xb = runs["jax"] / f"{CH}_placement.xml"
    assert _offsets(xa) == _offsets(xb)
    assert len(_offsets(xa)) == 4


def test_stitched_series_within_one_count(runs):
    _same_series(runs["port"] / CH, runs["jax"] / CH)
    assert len(_series(runs["port"] / CH)) == 6


def test_downsampled_npz_within_tolerance(runs):
    _same_npz(runs["port"], runs["jax"])


def test_bleach_background_8bit_run(raw, runs):
    """--bleach-correction --background-subtraction --convert-to-8bit: the
    merge's post-processing (coif15 destripe at sigma 2 x tile, the
    lightsheet stage, the 8-bit cast) on the blended planes.  The npz is
    downsampled from the written 8-bit planes, which may differ by 1
    count, so it is held within 1 count."""
    out = {name: _run(main, raw, f"{name}_post", POST)
           for name, main in (("port", P.main), ("jax", J.main))}
    assert _offsets(out["port"] / f"{CH}_placement.xml") == \
        _offsets(out["jax"] / f"{CH}_placement.xml")
    _same_series(out["port"] / CH, out["jax"] / CH, np.uint8)
    _same_npz(out["port"], out["jax"], atol=1.0)
    assert tio.imread(out["port"] / CH / "img_000002.tif").max() > 0


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_placement_xml_drives_the_other_package(raw, runs, writer, reader):
    """process_channel of one package merges the preprocessed tiles at the
    placement the other wrote (the --stitch-on-reference-alignment path):
    the series equals the writer's own within 1 count."""
    src = runs[writer]
    pc = P.process_channel if reader == "port" else J.process_channel
    out = raw / f"{reader}_from_{writer}"
    pc(raw / f"{writer}_pre" / CH, raw / f"{writer}_pre", out / CH,
       (0.41, 0.41, 0.2), (2000, 2000), None, cosine_blending=False,
       placement_from=src / f"{CH}_placement.xml", skip_inspection=True)
    assert _offsets(out / f"{CH}_placement.xml") == \
        _offsets(src / f"{CH}_placement.xml")
    _same_series(out / CH, src / CH)


@pytest.fixture(scope="module")
def two_channels(tmp_path_factory):
    """Two channels of one phantom (smooth structure for the tiles' NCC,
    blurred beads for the channels' ECC), the second rolled by a known
    (dz, dy, dx) before the tiles are cut."""
    rng = np.random.default_rng(12)
    root = tmp_path_factory.mktemp("composite")
    vol = make_phantom(rng, (12, 200, 200), smooth=6.0) * 0.5
    beads = np.zeros(vol.shape, np.float32)
    beads[tuple(rng.integers(2, s - 2, 400) for s in vol.shape)] = 2e6
    vol = vol + ndimage.gaussian_filter(beads, 1.5)
    for ch, v in ((CH, vol), (CH2, AC.roll_pad(vol.copy(), SHIFT2))):
        tiles, _ = cut_tiles(v, 2, 2, (120, 120), 48, jitter=2,
                             rng=np.random.default_rng(7))
        (root / "raw" / ch).mkdir(parents=True)
        write_tile_grid(root / "raw" / ch, tiles, overlap_nominal_px=48,
                        voxel_um=(0.41, 0.41, 0.2))
    return root


def test_rgb_composite_matches_the_jax_package(two_channels, tmp_path):
    """`--rgb-composite` writes <stitched>/composite, and `--composite DIR`
    (a second run, resuming the stitched series) writes
    DIR/<input>_composite, in both packages alike: the same names, one
    plane per plane of the first channel, the second channel moved by the
    injected shift, and planes within 1 count of the JAX package's (they compose the stitched
    series, which the port holds to 1 count).  The JAX package's own
    merge_channels, run on the port's stitched series, writes the port's
    composite byte for byte."""
    root = two_channels
    comp = {}
    for name, main in (("port", P.main), ("jax", J.main)):
        st = _run(main, root, f"c_{name}", ["--rgb-composite"])
        parent = tmp_path / f"parent_{name}"
        parent.mkdir()
        _run(main, root, f"c_{name}", ["--composite", str(parent),
                                       "--resume"])
        comp[name] = (st, st / "composite", parent / "raw_composite")
    for i in (1, 2):
        _same_series(comp["port"][i], comp["jax"][i], np.uint16)
        assert len(_series(comp["port"][i])) == 12
    st = comp["port"][0]
    planes = np.stack([tio.imread(p) for p in
                       sorted(comp["port"][1].glob("*.tif"))])
    stitched = {ch: np.stack([tio.imread(p) for p in
                              sorted((st / ch).glob("*.tif"))])
                for ch in (CH, CH2)}
    # merge_channels takes green (CH2) as its reference and moves blue
    # (CH) by the found offsets: the injected shift
    assert planes.shape[-1] == 3 and planes[..., 0].max() == 0
    np.testing.assert_array_equal(planes[..., 1], stitched[CH2])
    np.testing.assert_array_equal(planes[..., 2],
                                  AC.roll_pad(stitched[CH], SHIFT2))
    out = tmp_path / "jax_on_port"
    assert JM.main(["--output", str(out), "--blue", str(st / CH),
                    "--green", str(st / CH2)]) == 0
    names = _series(comp["port"][1])
    assert _series(out) == names
    for n in names:
        assert (out / n).read_bytes() == (comp["port"][1] / n).read_bytes()


def test_mesh_raises(raw, tmp_path):
    with pytest.raises(TypeError, match="Mesh"):
        P.process_channel(raw / "raw" / CH, tmp_path / "p", tmp_path / "s",
                          (0.41, 0.41, 0.2), (2000, 2000), None,
                          mesh=object())


FULL = ["--input", "in", "-t", "pre", "--no-need_raw_png_to_tiff_conversion",
        "-s", "st", "--objective", "10x", "--channel", "A", "--channel", "B",
        "--sigma1", "100", "--sigma2", "50", "--wavelet", "coif15",
        "--padding_mode", "wrap", "--no-bidirectional", "--dark", "12.5",
        "--flat", "f.tif", "--lightsheet", "--lightsheet-vs-background",
        "3", "--artifact-length", "120", "--no-gaussian",
        "--no-de_stripe", "--skipconf", "--enable_axis_correction",
        "--no-preprocess", "--mip-calibrate", "mip", "--cosine_blending",
        "--search-radius", "30", "--subvol-dim", "50", "--threshold",
        "0.7", "-dt", "10", "--isotropic", "--timeout", "60",
        "--read-sandbox", "process", "--convert_to_8bit", "--bit-shift",
        "4", "--compression", "zlib:3", "-zm", "ADOBE_DEFLATE", "-zl", "5",
        "--background_subtraction", "--background_subtraction_channels",
        "A", "--reference_channel", "A",
        "--stitch_based_on_reference_channel_alignment",
        "--noprogressbar", "--logprogress", "--sparse_data",
        "--skip_inspection", "--terafly_path", "tf", "-f", "A", "B",
        "-n", "3", "--rot90", "--bleach_correction",
        "--bleach_correction_channels", "B", "--auto-params", "-o",
        "out.ims", "--terafly", "--rgb-composite", "--composite", "c",
        "--exclude_gpus", "1", "2", "--vram_mem_fraction_gpu0", "0.5",
        "--resume", "--stitch_mip", "--test"]


@pytest.mark.parametrize("argv", [FULL, ["-i", "x"], ["-i", "x", "--imaris"]])
def test_parsers_agree(argv):
    assert vars(P.build_parser().parse_args(argv)) == \
        vars(J.build_parser().parse_args(argv))
