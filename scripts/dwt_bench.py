#!/usr/bin/env python3
"""Time K5 and K5s, one level of circular DWT analysis and its synthesis,
on one CUDA card.

    python3 scripts/dwt_bench.py [--quick] [--sweep] [--variants] [--clocks]
                                 [--root DIR] [--tag T]

At every level shape of the destripe CLI's padded batch (8, 2688, 2688),
levels 0-6 (rows of 2688 ... 42), as wavelets._dwt2_once and _idwt2_once
run them: axis -1 on (8 h, w) and axis -2 on (8, h, w / 2) (the analysis'
input, the synthesis' output); for the filter lengths 2, 6, 18, 68, 90, 102
(haar, db3, db9, db34, coif15, coif17): each kernel against its plain
version (max |kernel - plain| / max |plain| <= 1e-5), then the kernel, the
plain version, the library call (K5: one strided F.conv1d of both filters
over the circular extension built beforehand; K5s: one F.conv_transpose1d
/ 2d of both subbands, no fold) and the bound (chip_smoke.work_dwt: the
taps' FLOPs over the f32 peak or 8 bytes an input element of K5, an output
element of K5s, over the HBM rate), in ms by CUDA events.  Prints ptxas'
registers and spills first, the card's name and power limit last; writes
chiprun_out/dwt_bench[_TAG].json.

`--quick`: level 0 only, for db3, db9 and coif15.  `--root DIR`: also
build the package at DIR (an unpacked `git archive` of another commit)
through DIR's own ops/_build.py and run its K5s on the same inputs beside
this tree's at every case: its time, and whether this tree's output equals
its bit for bit (a difference fails the run).  `--sweep` then times K5's
knobs at level 0 and level 4 for db3, db9, db34, coif15 and coif17: R
outputs a thread (4, 8, 16), the most threads a block takes (128, 256,
384, 512; 256 at R = 16) and the compile-time tap loop against the generic
one (at R = 8 and H = 3, 9, 45 only).
`--variants` then builds csrc/dwt.cu alone with `IPP_DWT_DIAG` set
(`VARIANTS`: timing-only builds that skip the tap loop and the stores, or
the copies) and times each at level 0 for db3, db9 and coif15 against this
build: K5 at 256 and 512 threads a block, K5s at its own geometry, each
beside one clone of the same bytes: where the kernels' time goes.
`--clocks` runs K5 at level 0 for about two seconds a case (coif15 on both
axes, db9 along x) while nvidia-smi samples the SM clock and the power
draw every 100 ms.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def arg(name, default=None):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


PARENT = Path(arg("--root")).resolve() if "--root" in sys.argv else None
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ipp_tpu_torch.ops import cuda_dwt as cd  # noqa: E402
from ipp_tpu_torch.ops import wavelets as wv  # noqa: E402
from ipp_tpu_torch.ops._build import build_info, load_library  # noqa: E402

WAVELETS = ("haar", "db3", "db9", "db34", "coif15", "coif17")
QUICK = ("db3", "db9", "coif15")
BATCH, SIDE, LEVELS = 8, 2688, 7
SWEEP_WAVELETS = ("db3", "db9", "db34", "coif15", "coif17")
SWEEP_LEVELS = (0, 4)
# timing only, wrong results: no tap loop or stores, no copies
VARIANTS = {"diag_nocompute": ["-DIPP_DWT_DIAG=1"],
            "diag_nocopy": ["-DIPP_DWT_DIAG=2"]}


def build_variants():
    """{name: ctypes library} of csrc/dwt.cu built with each VARIANTS flag
    set (all nvcc processes at once), into build/dwt_variants/."""
    import ctypes

    from ipp_tpu_torch.ops import _build

    out = ROOT / "build" / "dwt_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = ROOT / "ipp_tpu_torch" / "csrc" / "dwt.cu"
    cmds = [[_build._nvcc(), *_build._ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", *flags, "-shared", "-o",
             str(out / f"{name}.so"), str(src)]
            for name, flags in VARIANTS.items()]
    log = _build._run(cmds)
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for entry in ("ipp_dwt_analysis_knobs", "ipp_dwt_synthesis"):
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs, log


def parent_library(parent: Path):
    """The kernel library of the package at `parent`, built into its own
    build directory by its own ops/_build.py (every C entry bound)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "ipp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_library()


def level_cases(level: int):
    """(shape, axis) of the three calls of one 2D level (the two axis -2
    calls share a shape)."""
    h = SIDE >> level
    return [((BATCH * h, h), -1), ((BATCH, h, h // 2), -2)]


def library_fn(x, taps, axis):
    """One strided F.conv1d of both filters over the circular extension
    along the axis, the extension built here (not timed)."""
    rows = x if axis == -1 else x.transpose(-1, -2)
    n, L = rows.shape[-1], taps.shape[1]
    ext = torch.cat([rows] * (1 + -(-L // n)), -1)[..., :n + L]
    ext = ext.reshape(-1, 1, n + L).contiguous()
    w = taps.unsqueeze(1)
    return lambda: torch.nn.functional.conv1d(ext, w, stride=2)


def syn_library_fn(ca, cdd, taps, axis):
    """One transposed convolution of both subbands stacked, without the
    fold (chip_smoke.dwt_library_fns)."""
    return cs.dwt_library_fns(torch, taps, axis, ca=ca, cd=cdd)


def syn_fn(lib, ca, cdd, taps, axis):
    """K5s through `lib`'s C entry (this build, a variant or the parent's)
    into one output allocated here."""
    from ipp_tpu_torch.ops.cuda_fft import _launch

    m = ca.shape[axis]
    inner = 1 if axis == -1 else ca.shape[-1]
    out_shape = list(ca.shape)
    out_shape[axis] = 2 * m
    y = torch.empty(out_shape, device=ca.device)
    counts = {"syn": 0}

    def run():
        _launch("syn", ca.device, lib.ipp_dwt_synthesis, ca.data_ptr(),
                cdd.data_ptr(), taps.data_ptr(), y.data_ptr(),
                ca.numel() // (m * inner), m, inner, taps.shape[1],
                counts=counts)
        return y
    return run


def half(shape, axis):
    sub = list(shape)
    sub[axis] //= 2
    return tuple(sub)


def knob_fn(lib, x, taps, axis, R, threads, generic):
    from ipp_tpu_torch.ops.cuda_fft import _launch

    n = x.shape[axis]
    inner = 1 if axis == -1 else x.shape[-1]
    out_shape = list(x.shape)
    out_shape[axis] = n // 2
    ca = torch.empty(out_shape, device=x.device)
    dd = torch.empty(out_shape, device=x.device)
    counts = {"knobs": 0}

    def run():
        _launch("knobs", x.device, lib.ipp_dwt_analysis_knobs, x.data_ptr(),
                taps.data_ptr(), ca.data_ptr(), dd.data_ptr(),
                x.numel() // (n * inner), n, inner, taps.shape[1], R,
                threads, generic, counts=counts)
        return ca, dd
    return run


def clocks_under_load(fn, seconds=2.0):
    """(median SM MHz, median W) that nvidia-smi reads while fn runs back
    to back for about `seconds`."""
    import statistics
    import subprocess
    import time

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate(timeout=30)
    mhz, watts = [], []
    for line in out.splitlines()[3:]:   # past the ramp
        try:
            a, b = line.split(",")
            mhz.append(float(a))
            watts.append(float(b))
        except ValueError:
            continue
    if not mhz:
        return None, None
    return statistics.median(mhz), statistics.median(watts)


def main() -> int:
    quick, sweep = "--quick" in sys.argv, "--sweep" in sys.argv
    tag = arg("--tag")
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; parent package: {PARENT}")
    lib = load_library()
    parent = parent_library(PARENT) if PARENT is not None else None
    info = build_info()
    print(f"built in {info['seconds']:.1f} s")
    for line in cs.ptxas_summary(info["ptxas"]):
        if "dwt" in line:
            print(" ", line)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rows, bad = [], []
    inputs = {}

    def data(shape, tag=0):
        if (shape, tag) not in inputs:
            inputs[shape, tag] = torch.randn(shape, generator=gen, device=dev)
        return inputs[shape, tag]

    for name in (QUICK if quick else WAVELETS):
        taps = wv.filter_taps(name, dev)
        L = int(taps.shape[1])
        for level in (0,) if quick else range(LEVELS):
            for shape, axis in level_cases(level):
                x = data(shape)
                got = cd.dwt_analysis(x, taps, axis)
                ref = cd.dwt_analysis_plain(x, taps, axis)
                torch.cuda.synchronize()
                abs_err, rel = cs.err_of_max(got, ref)
                del got, ref
                reps = 10 if x.numel() > 2 ** 22 else 50
                ms = cs.time_ms(torch, lambda: cd.dwt_analysis(x, taps, axis),
                                reps)
                plain = cs.time_ms(
                    torch, lambda: cd.dwt_analysis_plain(x, taps, axis), reps)
                lib_ms = cs.time_ms(torch, library_fn(x, taps, axis), reps)
                bound_ms, by = cs.bound(*cs.work_dwt(x.numel(), L))
                rows.append(dict(kernel="K5", wavelet=name, taps=L,
                                 level=level, shape=list(shape), axis=axis,
                                 rel_err=rel,
                                 max_abs_err=abs_err, ms=ms, plain_ms=plain,
                                 library_ms=lib_ms, bound_ms=bound_ms,
                                 bound_by=by))
                print(f"  K5  {name:<6s} L {L:3d} level {level} "
                      f"{str(shape):<18s} "
                      f"axis {axis:2d} rel {rel:.2e}  kernel {ms:7.4f} ms  "
                      f"plain {plain:7.3f}  conv1d {lib_ms:7.4f}  bound "
                      f"{bound_ms:7.4f} ({by})  kernel/bound "
                      f"{ms / bound_ms:5.2f}")
                if not rel <= 1e-5:
                    bad.append(f"{name} level {level} axis {axis}: {rel:.2e}")
                # K5s to the same shape, from two subbands of half of it
                sub = half(shape, axis)
                ca, cdd = data(sub), data(sub, 1)
                got = cd.dwt_synthesis(ca, cdd, taps, axis)
                ref = cd.dwt_synthesis_plain(ca, cdd, taps, axis)
                torch.cuda.synchronize()
                abs_err, rel = cs.err_of_max(got, ref)
                del ref
                ms = cs.time_ms(
                    torch, lambda: cd.dwt_synthesis(ca, cdd, taps, axis), reps)
                plain = cs.time_ms(torch, lambda: cd.dwt_synthesis_plain(
                    ca, cdd, taps, axis), reps)
                lib_ms = cs.time_ms(torch, syn_library_fn(ca, cdd, taps, axis),
                                    reps)
                row = dict(kernel="K5s", wavelet=name, taps=L, level=level,
                           shape=list(shape), axis=axis, rel_err=rel,
                           max_abs_err=abs_err, ms=ms, plain_ms=plain,
                           library_ms=lib_ms, bound_ms=bound_ms, bound_by=by)
                old = ""
                if parent is not None:
                    pfn = syn_fn(parent, ca, cdd, taps, axis)
                    row["parent_equal"] = torch.equal(pfn(), got)
                    row["parent_ms"] = cs.time_ms(torch, pfn, reps)
                    # this tree's once more, after the parent's: in turns
                    row["ms_again"] = cs.time_ms(
                        torch, lambda: cd.dwt_synthesis(ca, cdd, taps, axis),
                        reps)
                    old = (f"  parent {row['parent_ms']:7.4f} ms (again "
                           f"{row['ms_again']:7.4f}), bit-equal "
                           f"{row['parent_equal']}")
                    if not row["parent_equal"]:
                        bad.append(f"K5s {name} level {level} axis {axis}: "
                                   f"differs from the parent's")
                rows.append(row)
                print(f"  K5s {name:<6s} L {L:3d} level {level} "
                      f"{str(shape):<18s} axis {axis:2d} rel {rel:.2e}  "
                      f"kernel {ms:7.4f} ms  plain {plain:7.3f}  conv_t "
                      f"{lib_ms:7.4f}  bound {bound_ms:7.4f} ({by})  "
                      f"kernel/bound {ms / bound_ms:5.2f}{old}")
                if not rel <= 1e-5:
                    bad.append(f"K5s {name} level {level} axis {axis}: "
                               f"{rel:.2e}")
                del got
    sweep_rows = []
    if sweep:
        for name in SWEEP_WAVELETS:
            taps = wv.filter_taps(name, dev)
            L = int(taps.shape[1])
            for level in SWEEP_LEVELS:
                for shape, axis in level_cases(level):
                    x = data(shape)
                    ref = cd.dwt_analysis_plain(x, taps, axis)
                    bound_ms, _ = cs.bound(*cs.work_dwt(x.numel(), L))
                    for R in (4, 8, 16):
                        for threads in (128, 256, 384, 512):
                            if threads > (512 if R <= 8 else 256):
                                continue
                            for generic in (0, 1):
                                if generic and not (R == 8 and
                                                    L // 2 in (3, 9, 45)):
                                    continue
                                fn = knob_fn(lib, x, taps, axis, R, threads,
                                             generic)
                                _, rel = cs.err_of_max(fn(), ref)
                                ms = cs.time_ms(torch, fn, 20)
                                sweep_rows.append(dict(
                                    wavelet=name, level=level, axis=axis,
                                    R=R, threads=threads, generic=generic,
                                    ms=ms, rel_err=rel, bound_ms=bound_ms))
                                print(f"  sweep {name:<6s} level {level} "
                                      f"axis {axis:2d} R {R:2d} threads "
                                      f"{threads:3d} generic {generic}: "
                                      f"{ms:7.4f} ms ({ms / bound_ms:5.2f}x "
                                      f"bound) rel {rel:.1e}")
                                if not rel <= 1e-5:
                                    bad.append(f"sweep {name} {level} {axis} "
                                               f"{R} {threads} {generic}")
                    del ref
    variant_rows = []
    if "--variants" in sys.argv:
        libs, log = build_variants()
        for line in cs.ptxas_summary(log):
            print("  variants:", line)
        libs = {"this build": lib, **libs}
        for name in QUICK:
            taps = wv.filter_taps(name, dev)
            L = int(taps.shape[1])
            for shape, axis in level_cases(0):
                x = data(shape)
                ref = cd.dwt_analysis_plain(x, taps, axis)
                bound_ms, _ = cs.bound(*cs.work_dwt(x.numel(), L))
                for threads in (256, 512):
                    for vname, vlib in libs.items():
                        fn = knob_fn(vlib, x, taps, axis, 8, threads, 0)
                        _, rel = cs.err_of_max(fn(), ref)
                        ms = cs.time_ms(torch, fn, 20)
                        variant_rows.append(dict(
                            variant=vname, wavelet=name, axis=axis,
                            threads=threads, ms=ms, rel_err=rel,
                            bound_ms=bound_ms))
                        print(f"  variant {vname:<16s} {name:<6s} axis "
                              f"{axis:2d} threads {threads}: {ms:7.4f} ms "
                              f"({ms / bound_ms:5.2f}x bound) rel {rel:.1e}")
                        if not rel <= 1e-5 and not vname.startswith("diag"):
                            bad.append(f"variant {vname} {name} {axis}")
                # the same bytes through one device-to-device copy: 4 read
                # and 4 written an element, as the kernel moves
                ms = cs.time_ms(torch, lambda: x.clone(), 20)
                variant_rows.append(dict(variant="clone", wavelet=name,
                                         axis=axis, ms=ms))
                print(f"  variant {'x.clone()':<16s} {name:<6s} axis "
                      f"{axis:2d}: {ms:7.4f} ms ({ms / bound_ms:5.2f}x bound)")
                del ref
                # K5s to the same shape, at its one geometry
                sub = half(shape, axis)
                ca, cdd = data(sub), data(sub, 1)
                ref = cd.dwt_synthesis_plain(ca, cdd, taps, axis)
                for vname, vlib in libs.items():
                    fn = syn_fn(vlib, ca, cdd, taps, axis)
                    _, rel = cs.err_of_max(fn(), ref)
                    ms = cs.time_ms(torch, fn, 20)
                    variant_rows.append(dict(
                        kernel="K5s", variant=vname, wavelet=name, axis=axis,
                        ms=ms, rel_err=rel, bound_ms=bound_ms))
                    print(f"  variant K5s {vname:<12s} {name:<6s} axis "
                          f"{axis:2d}: {ms:7.4f} ms ({ms / bound_ms:5.2f}x "
                          f"bound) rel {rel:.1e}")
                    if not rel <= 1e-5 and not vname.startswith("diag"):
                        bad.append(f"variant K5s {vname} {name} {axis}")
                y = ref.clone()
                ms = cs.time_ms(torch, lambda: y.clone(), 20)
                variant_rows.append(dict(kernel="K5s", variant="clone",
                                         wavelet=name, axis=axis, ms=ms))
                print(f"  variant K5s {'y.clone()':<12s} {name:<6s} axis "
                      f"{axis:2d}: {ms:7.4f} ms ({ms / bound_ms:5.2f}x bound)")
                del ref, y
    clock_rows = []
    if "--clocks" in sys.argv:
        for name, axis in (("coif15", -1), ("coif15", -2), ("db9", -1)):
            taps = wv.filter_taps(name, dev)
            shape = [s_ for s_, a in level_cases(0) if a == axis][0]
            x = data(shape)
            mhz, watts = clocks_under_load(
                lambda: cd.dwt_analysis(x, taps, axis))
            clock_rows.append(dict(wavelet=name, axis=axis, sm_mhz=mhz,
                                   watts=watts))
            print(f"  clocks {name:<6s} axis {axis:2d} under load: SM "
                  f"{mhz} MHz, {watts} W (nvidia-smi, median)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"dwt_bench{'_' + tag if tag else ''}.json").write_text(json.dumps(
        dict(card=card, parent=str(PARENT), rows=rows, sweep=sweep_rows,
             variants=variant_rows, clocks=clock_rows,
             ptxas=[s for s in cs.ptxas_summary(info["ptxas"]) if "dwt" in s]),
        indent=1))
    print(f"card: {cs.card_line()}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
