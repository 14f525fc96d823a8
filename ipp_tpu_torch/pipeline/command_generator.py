"""Cluster command generator (reference command_generator.py:8-48 and
command_generator_batch.py): emit per-node shell command lists for the
export/merge stages so a cluster can split channels/cases across hosts,
plus the reference's per-case batch synthesis (merge + FNT + Imaris
command chains derived from acquisition metadata)."""

from __future__ import annotations

import argparse
import shlex
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["generate_commands", "generate_batch_commands", "main"]

# channel-index -> merge_channels CMYK flag
# (reference command_generator_batch.py merge_channel_color:25-34)
_COLOR_FLAGS = {0: "cyan", 1: "magenta", 2: "yellow", 3: "black"}


def _case_channels(stitched_path: Path) -> List[Path]:
    """Ex_* channel dirs, excluding MIP/middle previews (the reference's
    filter, command_generator_batch.py:91,199)."""
    return [sub for sub in sorted(stitched_path.iterdir())
            if sub.is_dir() and sub.name.startswith("Ex_")
            and "mip" not in sub.name.lower()
            and "middle" not in sub.name.lower()]


def _case_voxels(stitched_path: Path) -> Optional[Tuple[float, float]]:
    """((x==y) voxel, z voxel) from the acquisition's metadata.txt:
    2nd line, 4th whitespace word, rounded to 0.1 — the reference reads
    the SAME word for xy and z ('updated for Isotropic use',
    command_generator_batch.py:128-143)."""
    for f in stitched_path.iterdir():
        if f.is_file() and "metadata" in f.name.lower() \
                and f.suffix.lower() == ".txt":
            try:
                content = f.read_text(errors="replace").splitlines()
            except OSError:
                continue
            if len(content) >= 2:
                words = content[1].split()
                if len(words) >= 4:
                    try:
                        v = round(float(words[3]), 1)
                    except ValueError:
                        continue
                    return v, v
    return None


def _ims_filename(stitched_name: str) -> str:
    """Acquisition dir name -> .ims filename: strip '_stitched', keep the
    first and 5th+ underscore parts (reference
    command_generator_batch.py:211-214)."""
    parts = stitched_name.replace("_stitched", "").split("_")
    return "_".join(parts[:1] + parts[4:]) + ".ims"


def generate_batch_commands(
    stitched_paths: List[Path],
    goal: int = 0,
    composite_root: Path = Path("merged"),
    fnt_root: Path = Path("fnt"),
    ims_root: Path = Path("ims"),
    fnt_channels: Optional[List[str]] = None,
    make_dirs: bool = False,
) -> Dict[str, str]:
    """The reference batch synthesizer's per-case logic, non-interactive
    (command_generator_batch.py:35-250): for every stitched acquisition
    path, derive

    - goal 0/1: a merge_channels command mapping channels to C/M/Y/K by
      index; single-channel cases are skipped (:96-113),
    - goal 0/3: per-channel convert --fnt commands with -dx/-dy/-dz from
      metadata.txt (:118-160); `fnt_channels` replaces the interactive
      per-channel confirmation (None = convert all, the reference's '1'
      answer for everything),
    - goal 0/2: a convert -> .ims command per case, reading the merged
      composite for multi-channel cases and the single channel dir
      otherwise (:165-231); goal 2 alone is unsupported in the reference
      ('Direct Batch Imaris not yet implemented') and raises here.

    Returns {'merge': cmds, 'fnt': cmds, 'ims': cmds} with commands
    '&&'-joined exactly like the reference's BATCH_*_CMDS accumulators.
    """
    if goal not in (0, 1, 2, 3):
        raise ValueError(f"invalid goal {goal}")
    if goal == 2:
        raise NotImplementedError(
            "direct batch Imaris (goal 2) is unimplemented in the "
            "reference too (command_generator_batch.py:167-170)")
    merge_cmds: List[str] = []
    fnt_cmds: List[str] = []
    ims_cmds: List[str] = []
    for path in stitched_paths:
        sp = Path(path)
        channels = _case_channels(sp)
        vox = _case_voxels(sp)
        if goal in (0, 1) and len(channels) > 1:
            out = composite_root / sp.name
            if make_dirs:
                out.mkdir(parents=True, exist_ok=True)
            flags = " ".join(
                f"--{_COLOR_FLAGS[i]} {shlex.quote(str(c))}" for i, c in
                enumerate(channels[:len(_COLOR_FLAGS)]))
            merge_cmds.append(
                f"python -m ipp_tpu_torch.pipeline.merge_channels {flags} "
                f"--output_path {shlex.quote(str(out))}")
        if goal in (0, 3) and vox is not None:
            xy, z = vox
            for c in channels:
                if fnt_channels is not None and c.name not in fnt_channels:
                    continue
                out = fnt_root / sp.name / f"{c.name}_FNT"
                if make_dirs:
                    out.mkdir(parents=True, exist_ok=True)
                fnt_cmds.append(
                    f"python -m ipp_tpu_torch.pipeline.convert "
                    f"-i {shlex.quote(str(c))} "
                    f"--fnt {shlex.quote(str(out))} "
                    f"-dx {xy} -dy {xy} -dz {z}")
        if goal == 0 and vox is not None and channels:
            xy, z = vox
            src = (channels[0] if len(channels) == 1
                   else composite_root / sp.name)
            out_dir = ims_root / sp.name
            if make_dirs:
                out_dir.mkdir(parents=True, exist_ok=True)
            out = out_dir / _ims_filename(sp.name)
            ims_cmds.append(
                f"python -m ipp_tpu_torch.pipeline.convert "
                f"-i {shlex.quote(str(src))} -o {shlex.quote(str(out))} "
                f"-dx {xy} -dy {xy} -dz {z}")
    return {"merge": " && ".join(merge_cmds),
            "fnt": " && ".join(fnt_cmds),
            "ims": " && ".join(ims_cmds)}


def generate_commands(cases: List[Path], command_template: str,
                      n_nodes: int) -> List[List[str]]:
    """Round-robin `cases` over `n_nodes`; template placeholders: {input},
    {name}."""
    buckets: List[List[str]] = [[] for _ in range(max(1, n_nodes))]
    for i, case in enumerate(sorted(cases)):
        cmd = command_template.format(input=str(case), name=Path(case).name)
        buckets[i % len(buckets)].append(cmd)
    return buckets


def _batch_main(argv) -> int:
    p = argparse.ArgumentParser(
        prog="command_generator batch",
        description="per-case batch command synthesis (reference "
                    "command_generator_batch.py)")
    p.add_argument("--goal", type=int, default=0, choices=[0, 1, 2, 3],
                   help="0 merge+ims+fnt, 1 merge only, 3 fnt only "
                        "(2 unsupported, as in the reference)")
    p.add_argument("paths", nargs="*", type=Path,
                   help="stitched acquisition dirs; '-' or empty reads "
                        "newline-separated paths from stdin (the "
                        "reference's Ctrl+Z-terminated stdin read)")
    p.add_argument("--composite-root", type=Path, default=Path("merged"))
    p.add_argument("--fnt-root", type=Path, default=Path("fnt"))
    p.add_argument("--ims-root", type=Path, default=Path("ims"))
    p.add_argument("--fnt-channels", nargs="*", default=None,
                   help="restrict FNT conversion to these channel names "
                        "(replaces the interactive per-channel confirm)")
    p.add_argument("--run", action="store_true",
                   help="execute the three chains (the reference's "
                        "'1 to continue' branch); default prints only")
    args = p.parse_args(argv)
    paths = [pp for pp in args.paths if str(pp) != "-"]
    if not paths:
        paths = [Path(ln.strip().strip('"')) for ln in sys.stdin.read()
                 .splitlines() if ln.strip()]
    cmds = generate_batch_commands(
        paths, goal=args.goal, composite_root=args.composite_root,
        fnt_root=args.fnt_root, ims_root=args.ims_root,
        fnt_channels=args.fnt_channels, make_dirs=args.run)
    for key in ("merge", "fnt", "ims"):
        if cmds[key]:
            print(f"# {key}\n{cmds[key]}")
    if args.run:
        import subprocess

        for key in ("merge", "fnt", "ims"):
            if cmds[key]:
                rc = subprocess.call(cmds[key], shell=True)
                if rc != 0:
                    return rc
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "batch":
        return _batch_main(argv[1:])
    p = argparse.ArgumentParser(description="generate per-node command lists")
    p.add_argument("--input", "-i", required=True, type=Path,
                   help="directory whose subdirectories are the cases")
    p.add_argument("--template", "-t", required=True,
                   help="command template, e.g. 'python -m "
                        "ipp_tpu_torch.pipeline.convert --input {input} "
                        "--output {input}_out --imaris'")
    p.add_argument("--nodes", "-n", type=int, default=1)
    p.add_argument("--output", "-o", type=Path, default=None,
                   help="write node_<i>.sh files here instead of stdout")
    args = p.parse_args(argv)
    cases = [d for d in args.input.iterdir() if d.is_dir()]
    buckets = generate_commands(cases, args.template, args.nodes)
    if args.output:
        args.output.mkdir(parents=True, exist_ok=True)
        for i, cmds in enumerate(buckets):
            (args.output / f"node_{i:02d}.sh").write_text(
                "#!/bin/sh\nset -e\n" + "\n".join(cmds) + "\n")
    else:
        for i, cmds in enumerate(buckets):
            print(f"# node {i}")
            for c in cmds:
                print(c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
