"""Write the marker / SWC / ESWC / APO / recut-seed fixtures that the port
runs on hosts without pandas: run
``python tests/torch_marker_fixtures/make_fixtures.py`` (pandas and the
JAX package needed) and commit ``inputs/``, ``expected/`` and
``fixtures.json``.

``write_inputs`` makes the input files from numpy seeds (numpy alone):
two Vaa3D markers, a TeraFly .apo with duplicated rows, an SWC and an
ESWC whose coordinates carry 17-19 digits.  ``run`` drives one package's
``utils/markers.py`` and ``utils/reconops.py`` over them, each function
once, and writes what they give into a directory; run with the JAX
package's modules here, that directory is ``expected/``.  The port's
modules (chip_smoke.py phase 18 (g), tests/test_torch_markers.py) must
write the same files byte for byte.  ``fixtures.json`` lists every
expected file with its sha256 and the pandas version that wrote it.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
INPUTS = HERE / "inputs"
EXPECTED = HERE / "expected"


def _digits(rng, n: int) -> str:
    return "".join(map(str, rng.integers(0, 10, n)))


def write_inputs(out: Path = INPUTS) -> None:
    """The input files, from seeds."""
    rng = np.random.default_rng(260)
    out.mkdir(parents=True, exist_ok=True)
    names = ["soma", "b,c", 'q"t', "", "x y", "NA"]
    for k, name in enumerate(("a.marker", "b.marker")):
        rows = ["#x, y, z, radius, shape, name, comment, color_r, color_g, "
                "color_b"]
        for i in range(12):
            x, y, z = (f"{rng.integers(0, 4000)}.{_digits(rng, 13)}",
                       f"{rng.random() * 4000:.6f}",
                       f"{rng.integers(0, 300)}.{_digits(rng, 15)}")
            if k == 1 and i < 4:          # near-duplicates of a.marker's
                x = f"{float(x) + 0.5}"
            nm = names[i % len(names)]
            nm = f'"{nm}"' if ("," in nm or '"' in nm) else nm
            nm = nm.replace('q"t', 'q""t')
            rows.append(f"{x},{y},{z},{rng.integers(0, 9)},1,{nm},,"
                        f"{rng.integers(0, 256)},0,{rng.integers(0, 256)}")
        (out / name).write_text("\n".join(rows) + "\n")
    head = ("##n,orderinfo,name,comment,z,x,y,pixmax,intensity,sdev,"
            "volsize,mass,,,,color_r,color_g,color_b")
    rows = []
    for i in range(24):
        z, x, y = (rng.random(3) * [300, 4000, 4000]).round(3)
        rows.append(f"{i},,,,{z:.3f},{x:.3f},{y:.3f},0.000,0.000,0.000,"
                    f"{rng.random() * 4000:.3f},0.000,,,,0,0,255")
    rows += rows[:5]
    (out / "cells.ano.apo").write_text(head + "\n" + "\n".join(rows) + "\n")
    lines = ["# a neuron", "#id type x y z radius parent_id"]
    order = rng.permutation(np.arange(1, 41))
    for i in order:
        parent = -1 if i == 1 else int(rng.integers(1, i))
        xyz = " ".join(f"{rng.integers(0, 999)}.{_digits(rng, 16)}"
                       for _ in range(3))
        lines.append(f"{i} {rng.integers(1, 5)} {xyz} "
                     f"{rng.random() * 3:.4f} {parent}")
    lines.append(lines[-1])                    # a duplicated node
    (out / "neuron.swc").write_text("\n".join(lines) + "\n")
    elines = lines[:2] + [ln + f" {k} 0 0 {k * 7} 1" for k, ln in
                          enumerate(lines[2:12])]
    (out / "neuron.eswc").write_text("\n".join(elines) + "\n")


def run(markers, reconops, src: Path, out: Path) -> None:
    """Every marker and SWC function of one package over the inputs in
    `src`, its outputs written into `out`."""
    out.mkdir(parents=True, exist_ok=True)
    m, r = markers, reconops
    m.merge_marker_files([src / "a.marker", src / "b.marker"],
                         out / "merged.marker")
    m.merge_marker_files([src / "a.marker", src / "b.marker"],
                         out / "merged_dedup.marker", dedup_radius=2.0)
    m.write_marker(m.convert_coordinates(
        m.read_marker(src / "a.marker"), voxel_source=(0.4, 0.4, 1.0),
        voxel_target=(1.8, 1.8, 2.0), flip_lengths=(4000, 0, 300),
        offset=(0.5, 0, -1)), out / "converted.marker")
    swc = r.read_swc(src / "neuron.swc")
    r.write_swc(r.sort_swc(swc), out / "sorted.swc", comment="sorted")
    r.write_swc(r.flip_and_scale(swc, flip_lengths=(1000, 0, 0),
                                 voxel_source=(0.4, 0.4, 1.0),
                                 voxel_target=(1.0, 2.0, 3.0)),
                out / "flipped.swc")
    r.write_eswc(r.read_eswc(src / "neuron.eswc"), out / "neuron.eswc")
    r.write_eswc(swc, out / "from_swc.eswc")
    r.write_swc(r.read_apo(src / "cells.ano.apo", radius=7.5),
                out / "cells.swc")
    seeds = r.swc_to_seeds(r.read_swc(out / "cells.swc"))
    (out / "soma.txt").write_text(
        f"{len(seeds)} {r.soma_of_swc(out / 'cells.swc').tolist()}\n")
    work = out / "terafly"
    work.mkdir()
    shutil.copy(src / "cells.ano.apo", work)
    recut = m.terafly_apo_to_recut_seeds(work / "cells.ano.apo",
                                         voxel=(0.4, 0.45, 1.2))
    m.recut_seeds_to_terafly_ano(recut, voxel=(0.4, 0.45, 1.2))
    m.swc_to_recut_seeds(recut / "seeds_for_Imaris_proofread.swc",
                         radii=7.0, voxel=(0.4, 0.45, 1.2))


def tree(root: Path) -> dict:
    """Relative path -> sha256 of every file under root."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def write() -> dict:
    """Inputs, the JAX package's outputs and the manifest."""
    import sys

    import pandas

    sys.path.insert(0, str(HERE.parent.parent))
    from ipp_tpu.utils import markers, reconops

    shutil.rmtree(INPUTS, ignore_errors=True)
    shutil.rmtree(EXPECTED, ignore_errors=True)
    write_inputs()
    run(markers, reconops, INPUTS, EXPECTED)
    manifest = dict(pandas=pandas.__version__, expected=tree(EXPECTED))
    (HERE / "fixtures.json").write_text(json.dumps(manifest, indent=1) +
                                        "\n")
    return manifest


if __name__ == "__main__":
    m = write()
    print(f"{len(m['expected'])} expected files, pandas {m['pandas']}")
