"""The port's merge_channels CLI against the JAX package's, and the
parsers of every CLI this slice ports against their JAX twins.

merge_channels: two u16 channel series of a bead phantom, the second
shifted by a known (dz, dy, dx), aligned and composited by both packages
(composite planes byte-equal, the shift undone); four channels to CMYK
with a key channel and 8-bit conversion, no alignment (byte-equal); and
resume / --no-resume over a half-written composite directory.

Parsers: each CLI's parser of both packages parses the same full flag
set to equal namespaces (the pattern of test_torch_process_images.py)."""

import numpy as np
import pytest
from scipy import ndimage

from ipp_tpu.io import tiff as tio
from ipp_tpu.pipeline import align_channels as JA
from ipp_tpu.pipeline import convert as JC
from ipp_tpu.pipeline import flip as JF
from ipp_tpu.pipeline import merge_channels as J
from ipp_tpu.pipeline import scan_stitch as JS
from ipp_tpu.pipeline import tsv_tools as JT
from ipp_tpu_torch.pipeline import align_channels as PA
from ipp_tpu_torch.pipeline import convert as PC
from ipp_tpu_torch.pipeline import flip as PF
from ipp_tpu_torch.pipeline import merge_channels as P
from ipp_tpu_torch.pipeline import scan_stitch as PS
from ipp_tpu_torch.pipeline import tsv_tools as PT

SHIFT = (1, -4, 6)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")


def _write_series(d, vol):
    d.mkdir(parents=True, exist_ok=True)
    for z in range(vol.shape[0]):
        tio.imwrite(d / f"img_{z:06d}.tif", vol[z])
    return d


@pytest.fixture(scope="module")
def beads(tmp_path_factory):
    root = tmp_path_factory.mktemp("merge")
    rng = np.random.default_rng(8)
    vol = np.zeros((20, 112, 128), np.float32)
    vol[tuple(rng.integers(3, s - 3, 300) for s in vol.shape)] = 3000.0
    vol = ndimage.gaussian_filter(vol, 1.5)
    moved = JA.roll_pad(vol.copy(), SHIFT)
    dirs = {"red": _write_series(root / "red", vol.astype(np.uint16)),
            "green": _write_series(root / "green", moved.astype(np.uint16))}
    return root, dirs, vol


def _same_files(a_dir, b_dir):
    names = sorted(p.name for p in b_dir.glob("*.tif"))
    assert names and sorted(p.name for p in a_dir.glob("*.tif")) == names
    for n in names:
        assert (a_dir / n).read_bytes() == (b_dir / n).read_bytes(), n


def test_aligned_composite_byte_equal(beads, tmp_path):
    root, dirs, vol = beads
    out = {}
    for name, mod in (("port", P), ("jax", J)):
        out[name] = tmp_path / name
        assert mod.main(["--red", str(dirs["red"]), "--green",
                         str(dirs["green"]), "-o", str(out[name])]) == 0
    _same_files(out["port"], out["jax"])
    comp = np.stack([tio.imread(p) for p in
                     sorted(out["port"].glob("composite_*.tif"))])
    assert comp.shape == vol.shape + (3,) and comp.dtype == np.uint16
    # the green channel lies on the red one once the shift is undone
    inner = (slice(2, -2), slice(6, -6), slice(8, -8))
    np.testing.assert_array_equal(comp[..., 1][inner], comp[..., 0][inner])


def test_cmyk_key_8bit_no_align_byte_equal(tmp_path):
    rng = np.random.default_rng(4)
    flags = []
    for name in ("cyan", "magenta", "yellow", "black"):
        vol = rng.integers(0, 5000, (3, 24, 30)).astype(np.uint16)
        flags += [f"--{name}", str(_write_series(tmp_path / name, vol))]
    out = {}
    for name, mod in (("port", P), ("jax", J)):
        out[name] = tmp_path / f"out_{name}"
        assert mod.main(flags + ["-o", str(out[name]), "--no-align",
                                 "--convert_to_8bit", "--bit-shift",
                                 "5"]) == 0
    _same_files(out["port"], out["jax"])
    plane = tio.imread(out["port"] / "composite_000001.tif")
    assert plane.shape == (24, 30, 4) and plane.dtype == np.uint8


def test_resume_and_no_resume(beads, tmp_path):
    """--resume (the default) keeps an existing plane; --no-resume
    rewrites it; both packages alike."""
    _root, dirs, _vol = beads
    sentinel = np.full((112, 128, 3), 7, np.uint16)
    out = {}
    for name, mod in (("port", P), ("jax", J)):
        out[name] = tmp_path / name
        out[name].mkdir()
        tio.imwrite(out[name] / "composite_000003.tif", sentinel)
        assert mod.main(["--red", str(dirs["red"]), "-o", str(out[name]),
                         "--no-align"]) == 0
    _same_files(out["port"], out["jax"])
    np.testing.assert_array_equal(
        tio.imread(out["port"] / "composite_000003.tif"), sentinel)
    for name, mod in (("port", P), ("jax", J)):
        assert mod.main(["--red", str(dirs["red"]), "-o", str(out[name]),
                         "--no-align", "--no-resume"]) == 0
    _same_files(out["port"], out["jax"])
    assert tio.imread(out["port"] / "composite_000003.tif")[..., 0].max() > 7


PARSERS = {
    "align_channels": (PA.build_parser, JA.build_parser, [
        ["--red", "o_r", "d_r", "--green", "o_g", "d_g", "--blue", "o_b",
         "d_b", "-o", "out", "--write_alignments", "--generate_ims",
         "--max_iterations", "5", "--reference", "green", "--num_threads",
         "3", "--save_singles", "--dtype", "float32", "--dx", "1", "2",
         "--dy", "1", "2", "--dz", "2", "4"],
        ["-o", "x", "--dx", "1", "1", "--dy", "1", "1", "--dz", "1", "1"]]),
    "merge_channels": (P.build_parser, J.build_parser, [
        ["--red", "r", "--green", "g", "--blue", "b", "-c", "c", "-m", "m",
         "-y", "y", "-k", "k", "--output_path", "o", "--no-align",
         "--convert_to_8bit", "--bit_shift", "3", "--no-resume", "-n", "4"],
        ["-o", "x"]]),
    "convert": (PC.build_parser, JC.build_parser, [
        ["-i", "in", "-t", "out", "-dx", "1.5", "-dy", "1.5", "-dz", "4",
         "-n", "3", "--convert-to-8bit", "--convert-to-16bit", "-b", "4",
         "-d", "10", "--sigma1", "30", "--sigma2", "40", "--wavelet",
         "db3", "--destripe", "-dsx", "2", "-dsy", "3", "-dsm", "max",
         "--background-subtraction", "--bleach-correction",
         "--bleach-correction-period", "500",
         "--bleach-correction-clip-min", "5",
         "--bleach-correction-clip-max", "100", "-zm", "LZW", "-zl", "3",
         "--new-size", "10", "20", "-nsx", "5", "-nsy", "6", "--voxel",
         "1", "2", "3", "--teraFly", "tf", "--imaris", "f.ims", "--bdv",
         "--precomputed", "--halve", "max", "--block-format", "vaa3draw",
         "-fnt", "fnt", "--fnt-cube", "64", "-m", "m.avi", "--movie-fps",
         "30", "--movie-start", "2", "--movie-end", "9",
         "--movie-frame-duration", "3", "-c", "1", "-r", "90",
         "--flip_upside_down", "-g", "-w", "wrap", "--timeout", "5",
         "--rename", "--resume", "-dt", "10", "-dsp", "ds", "-dsdt",
         "uint8", "--alternating-downsampling", "--no-save-images",
         "--needed-memory", "4", "--threads-per-gpu", "2"],
        ["-i", "x", "-o", "y", "-f", "--imaris"]]),
    "scan_stitch": (PS.parse_args, JS.parse_args, [
        ["--input", "in", "--output-pattern", "o/img_%04d.tif",
         "--voxel-size", "1,1,1", "--z-step", "12", "--piezo-distance",
         "16", "--threshold", "0.5", "--x-slop", "5", "--y-slop", "6",
         "--z-slop", "4", "--z-skip", "2", "--dark", "100",
         "--min-support", "3", "--n-cores", "2", "--loose-x", "--rounds",
         "1", "--estimate-creep", "--n-io-cores", "2", "--log-level",
         "INFO", "--compression", "0", "--stack-offset-output", "a.json",
         "--stack-offset-input", "b.json", "--stacks", "s.json"],
        ["--input", "in", "--output-pattern", "p"]]),
    "flip": (PF.build_parser, JF.build_parser, [
        ["-i", "in", "-o", "out", "-x", "-y", "-z"], ["-i", "in"]]),
    "tsv_tools": (PT.build_parser, JT.build_parser, [
        ["convert", "--xml-path", "x.xml", "--output-pattern", "o/{z}.tif",
         "--mipmap-level", "2", "--volume", "0,1,0,1,0,1", "--compression",
         "3", "--rotation", "90", "--ignore-z-offsets", "--input", "alt",
         "--cosine-blending", "--cpus", "3", "--silent"],
        ["downsample", "--src", "s", "--dest", "d", "--downsample-factor",
         "4", "--method", "mean", "--z-factor", "2", "--compression", "1",
         "--n-cores", "2", "--silent"],
        ["simple", "--path", "p", "--voxel-size-xy", "1.8",
         "--voxel-size-x", "1", "--voxel-size-y", "2", "--voxel-size-z",
         "3", "--output-pattern", "o", "--mipmap-level", "1", "--volume",
         "v", "--compression", "2", "--cosine-blending", "--silent",
         "--cpus", "2"],
        ["fill-blanks", "--dir", "d"],
        ["fill-blanks-tree", "--src", "s", "--dest", "d", "--silent"],
        ["renumber", "--dir", "d"],
        ["renumber-tree", "r", "--n-digits", "4"],
        ["renumber-directories", "--path", "p"],
        ["npz", "-i", "i", "-o", "o", "--voxel", "1", "2", "3", "-dx", "1",
         "-dy", "2", "-dz", "3", "--downsampled_voxel", "25"],
        ["crop-series", "--input", "i", "--output", "o", "--roi", "1", "2",
         "3", "4", "--z", "5", "6"],
        ["resize3d", "--input", "i", "--output", "o", "--shape", "1", "2",
         "3"],
        ["crop-ims", "--ims", "f.ims", "--output", "o", "--roi", "0", "1",
         "2", "3", "4", "5", "--channel", "1", "--resolution-level", "2",
         "--right-shift", "4", "--no-8bit"],
        ["pfc-to-ls", "--root", "r", "--target", "t", "--xy-step", "10",
         "--z-step", "20", "--frame-shape", "64", "64"],
        ["precomputed", "--input", "i", "--output", "o", "--voxel-nm", "1",
         "2", "3", "--levels", "2"]]),
}
CASES = [(name, i) for name, (_p, _j, argvs) in PARSERS.items()
         for i in range(len(argvs))]


@pytest.mark.parametrize("name,i", CASES, ids=[f"{n}-{i}" for n, i in CASES])
def test_parsers_agree(name, i):
    port, jax, argvs = PARSERS[name]
    parse = (lambda f, a: f(a)) if name == "scan_stitch" else (
        lambda f, a: f().parse_args(a))
    assert vars(parse(port, argvs[i])) == vars(parse(jax, argvs[i]))
