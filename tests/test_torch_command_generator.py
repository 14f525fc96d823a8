"""The port's command generator writes commands that run the port.

`generate_batch_commands` (merge, FNT and Imaris chains per case) and the
`--template` example of the per-node generator name only
`ipp_tpu_torch.pipeline.*` modules, never the JAX package's; and
`command_generator batch --run` on a tiny two-channel case runs the
port's merge_channels, whose composite equals a direct call's."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ipp_tpu_torch.io import tiff as tio
from ipp_tpu_torch.pipeline import command_generator as G
from ipp_tpu_torch.pipeline import merge_channels as M

ROOT = Path(__file__).resolve().parent.parent
CHANNELS = ("Ex_488_Em_525", "Ex_561_Em_600")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("IPP_TPU_PLATFORM", "cpu")


def _case(root: Path, seed: int = 3) -> Path:
    rng = np.random.default_rng(seed)
    case = root / "brain1_15x_stitched"
    for ch in CHANNELS:
        d = case / ch
        d.mkdir(parents=True)
        for z in range(3):
            tio.imwrite(d / f"img_{z:06d}.tif",
                        rng.integers(0, 4000, (24, 30)).astype(np.uint16))
    (case / "metadata.txt").write_text("header\na b c 1.8 e\n")
    return case


def _modules(cmds: str):
    return re.findall(r"python -m (\S+)", cmds)


def test_batch_commands_name_only_the_port(tmp_path):
    case = _case(tmp_path)
    cmds = G.generate_batch_commands([case], goal=0,
                                     composite_root=tmp_path / "merged",
                                     fnt_root=tmp_path / "fnt",
                                     ims_root=tmp_path / "ims")
    mods = [m for key in ("merge", "fnt", "ims") for m in _modules(cmds[key])]
    # one merge, an FNT conversion per channel, one Imaris conversion
    assert len(mods) == 1 + len(CHANNELS) + 1
    assert mods[0] == "ipp_tpu_torch.pipeline.merge_channels"
    assert set(mods[1:]) == {"ipp_tpu_torch.pipeline.convert"}
    assert "ipp_tpu." not in " ".join(cmds.values())


def test_template_example_names_the_port(capsys):
    with pytest.raises(SystemExit):
        G.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "python -m ipp_tpu_torch.pipeline.convert" in text
    assert "ipp_tpu.pipeline" not in text


def test_batch_run_writes_the_ports_composite(tmp_path):
    case = _case(tmp_path)
    merged = tmp_path / "merged"
    env = dict(os.environ, IPP_TPU_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    # the chains call `python`: put this interpreter first on the PATH
    env["PATH"] = os.pathsep.join([str(Path(sys.executable).parent),
                                   env.get("PATH", "")])
    r = subprocess.run(
        [sys.executable, "-m", "ipp_tpu_torch.pipeline.command_generator",
         "batch", "--goal", "1", "--composite-root", str(merged), "--run",
         str(case)], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "python -m ipp_tpu_torch.pipeline.merge_channels" in r.stdout
    got = merged / case.name
    want = tmp_path / "direct"
    assert M.main(["--cyan", str(case / CHANNELS[0]), "--magenta",
                   str(case / CHANNELS[1]), "-o", str(want)]) == 0
    names = sorted(p.name for p in want.glob("*.tif"))
    assert len(names) == 3
    assert sorted(p.name for p in got.glob("*.tif")) == names
    for n in names:
        assert (got / n).read_bytes() == (want / n).read_bytes(), n
