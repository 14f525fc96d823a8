#!/usr/bin/env python3
"""Check and time the large-axis FFT kernel of ipp_tpu_torch
(csrc/stage_large.cuh) on one CUDA card.

    python3 scripts/stage_large_bench.py [--check] [--sweep] [--only TEXT]
                                         [--parent DIR]

First every stage form (forward and inverse over z, forward over x, K6, K4
with the OTF, K4 conj, K4b with an OTF period of 3 rows) at n = 12416,
12544, 24576 and 24832, and K7's DFT (natural order) at 16384 and 24832,
against torch.fft in complex128 in the walk's order (<= 1e-5 of max), each
one launch of `ipp_stage_large` and none of a dense kernel.  `--check`
stops there.  Then the forms at the shapes `chip_smoke.py` times (K6 at
(512, 12416), the (256, 16, 12544) RL block's x stages at (4096, 12544),
the middle axis at (4, 12544, 256), the last axis past Form A at (256,
24832), and one of each length): the kernel, the dense stage kernel it
replaced (`cuda_fft.stage_dense`), one torch.fft call and the bound, in ms
per call replayed from a CUDA graph (the dense kernel by CUDA events); and
K7's DFT at (256, 16384) and (256, 24832) beside the dense Karatsuba
kernel (K7d), the plain version, torch.fft and the bound.
`--sweep` adds the kernel's knobs: Form A's threads a row, Form B's
threads a column and columns a block of each pass; `--only TEXT` times
the shapes whose label holds TEXT.  Last, the device bytes
of the walk's plan for a (256, 16, 12544) work shape
(`torch.cuda.max_memory_allocated` over its construction), and with
`--parent DIR` the same for the package unpacked at DIR (another commit's
`git archive`), in a process of its own.  Prints ptxas' registers and
stack frames first, the card's name and power limit last; the whole log
also goes to chiprun_out/stage_large_bench.txt.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ipp_tpu_torch.ops import cuda_fft as cf  # noqa: E402
from ipp_tpu_torch.ops._build import build_info, load_library  # noqa: E402
from ipp_tpu_torch.ops.dft_mats import stage_large_plan  # noqa: E402

CHECK_LENGTHS = (12416, 12544, 24576, 24832)
K7_LENGTHS = (16384, 24832)
# (label, n, (P, n, X) of the z forms or None, rows of the x forms)
TIMED = [("K6 (512, 12416)", 12416, None, 512),
         ("RL (256,16,12544) x", 12544, None, 4096),
         ("middle (4,12544,256)", 12544, (4, 12544, 256), None),
         ("12416 z", 12416, (4, 12416, 256), None),
         ("24576", 24576, (2, 24576, 256), 1024),
         ("24832", 24832, (2, 24832, 256), 256)]
PLAN_SHAPE = (256, 16, 12544)


def rel_err(got, ref):
    return max(float((g - r).abs().max()) for g, r in zip(got, ref)) / \
        max(float(r.abs().max()) for r in ref)


def perm(n, dev):
    """Position of frequency f in the walk's order."""
    f = torch.arange(n, device=dev)
    return (f & 1) * (n // 2) + (f >> 1)


def stage_ref(re, im, forward, axis, otf=None, conj=False):
    """The stage's function by torch.fft in complex128: forward, the
    permuted spectrum; inverse, of the permuted input (times the OTF row
    r % orows first)."""
    n = re.shape[axis]
    x = torch.complex(re.double(), im.double())
    if otf is not None:
        o = torch.complex(otf[0].double(), otf[1].double())
        o = o.conj() if conj else o
        x = x * o[torch.arange(x.shape[0], device=x.device) % o.shape[0]]
    p = perm(n, re.device)
    if forward:
        y = torch.empty_like(x)
        y.index_copy_(axis % x.dim(), p, torch.fft.fft(x, dim=axis))
    else:
        y = torch.fft.ifft(x.index_select(axis % x.dim(), p), dim=axis)
    return y.real, y.imag


def check(dev, gen, bad):
    def d(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5

    for n in CHECK_LENGTHS:
        zr, zi = d(3, n, 40), d(3, n, 40)
        xr, xi, pr, pi = d(21, n), d(21, n), d(21, n), d(21, n)
        br, bi, o_r, o_i = d(192, n), d(192, n), d(3, n), d(3, n)
        forms = [
            ("fwd z", "radix2_stage",
             lambda: cf.radix2_stage(zr, zi, None, None, True, 1),
             lambda: stage_ref(zr, zi, True, 1)),
            ("inv z", "radix2_stage",
             lambda: cf.radix2_stage(zr, zi, None, None, False, 1),
             lambda: stage_ref(zr, zi, False, 1)),
            ("fwd x", "radix2_stage",
             lambda: cf.radix2_stage(xr, xi, None, None, True, -1),
             lambda: stage_ref(xr, xi, True, -1)),
            ("K6 inv x", "radix2_stage_inv_last",
             lambda: cf.radix2_stage(xr, xi, None, None, False, -1),
             lambda: stage_ref(xr, xi, False, -1)),
            ("K4 otf", "radix2_stage_inv_otf",
             lambda: cf.radix2_stage_inv_otf(xr, xi, pr, pi, None, None,
                                             False),
             lambda: stage_ref(xr, xi, False, -1, (pr, pi))),
            ("K4 conj", "radix2_stage_inv_otf",
             lambda: cf.radix2_stage_inv_otf(xr, xi, pr, pi, None, None,
                                             True),
             lambda: stage_ref(xr, xi, False, -1, (pr, pi), True)),
            ("K4b period", "radix2_stage_inv_otf_batched",
             lambda: cf.radix2_stage_inv_otf_batched(br, bi, o_r, o_i, None,
                                                     None, True),
             lambda: stage_ref(br, bi, False, -1, (o_r, o_i), True)),
        ]
        worst = 0.0
        for form, counter, kfn, rfn in forms:
            cf.reset_launch_counts()
            got = kfn()
            torch.cuda.synchronize()
            counts = {k: v for k, v in cf.LAUNCHES.items() if v}
            err = rel_err(got, rfn())
            worst = max(worst, err)
            if counts != {counter: 1} or \
                    cf.ENTRY_LAUNCHES != {"ipp_stage_large": 1}:
                bad.append(f"n={n} {form}: launches {counts} "
                           f"{cf.ENTRY_LAUNCHES}")
            if not err <= 1e-5:
                bad.append(f"n={n} {form}: rel {err:.3e}")
        plans = stage_large_plan(n, True), stage_large_plan(n, False)
        print(f"check n={n:<5d} 7 forms: worst rel {worst:.2e}  plans "
              f"last {plans[0]}, middle {plans[1]}", flush=True)
    for n in K7_LENGTHS:
        xr, xi = d(5, n), d(5, n)
        for forward in (True, False):
            cf.reset_launch_counts()
            got = cf.stage_large(xr, xi, forward, -1, name="cplx_matmul",
                                 natural=True)
            torch.cuda.synchronize()
            x = torch.complex(xr.double(), xi.double())
            y = torch.fft.fft(x) if forward else torch.fft.ifft(x)
            err = rel_err(got, (y.real, y.imag))
            print(f"check K7 n={n} {'fwd' if forward else 'inv'}: rel "
                  f"{err:.2e}", flush=True)
            if not err <= 1e-5 or \
                    cf.ENTRY_LAUNCHES != {"ipp_stage_large": 1}:
                bad.append(f"K7 n={n}: rel {err:.3e} {cf.ENTRY_LAUNCHES}")


def timed_forms(dev, n, zshape, rows, d):
    """(form, shape, kernel_fn, dense_fn, library_fn, work, knob_fn)."""
    fwd, inv = (cs.stage_mats(torch, n, f, dev) for f in (True, False))
    out = []
    if zshape is not None:
        zr, zi = d(*zshape), d(*zshape)
        cz = torch.complex(zr, zi)
        for f, m, lib_fn in ((True, fwd, torch.fft.fft),
                             (False, inv, torch.fft.ifft)):
            out.append((
                "fwd z" if f else "inv z", zshape,
                lambda f=f: cf.radix2_stage(zr, zi, None, None, f, 1),
                lambda f=f, m=m: cf.stage_dense(zr, zi, *m, f, 1),
                lambda lib_fn=lib_fn: lib_fn(cz, dim=1),
                cs.work_stage(zr.numel(), n),
                lambda t1, c1, t2, c2, f=f: cf.stage_large(
                    zr, zi, f, 1, threads_per_col1=t1, cols1=c1,
                    threads_per_col=t2, cols=c2)))
    if rows is not None:
        xr, xi, o_r, o_i = d(rows, n), d(rows, n), d(rows, n), d(rows, n)
        cx = torch.complex(xr, xi)
        out += [
            ("fwd x", (rows, n),
             lambda: cf.radix2_stage(xr, xi, None, None, True, -1),
             lambda: cf.stage_dense(xr, xi, *fwd, True, -1),
             lambda: torch.fft.fft(cx, dim=-1), cs.work_stage(xr.numel(), n),
             lambda t1, c1, t2, c2: cf.stage_large(
                 xr, xi, True, -1, threads_per_col1=t1, cols1=c1,
                 threads_per_col=t2, cols=c2)),
            ("K6 inv x", (rows, n),
             lambda: cf.radix2_stage(xr, xi, None, None, False, -1),
             lambda: cf.stage_dense(xr, xi, *inv, False, -1,
                                    name="radix2_stage_inv_last"),
             lambda: torch.fft.ifft(cx, dim=-1), cs.work_stage(xr.numel(), n),
             None),
            ("K4 otf", (rows, n),
             lambda: cf.radix2_stage_inv_otf(xr, xi, o_r, o_i, None, None,
                                             False),
             lambda: cf.stage_dense(xr, xi, *inv, False, -1, (o_r, o_i),
                                    name="radix2_stage_inv_otf"),
             lambda: torch.fft.ifft(cx, dim=-1),
             cs.work_stage(xr.numel(), n, xr.numel()),
             lambda t1, c1, t2, c2: cf.stage_large(
                 xr, xi, False, -1, (o_r, o_i), threads_per_col1=t1,
                 cols1=c1, threads_per_col=t2, cols=c2))]
    return out


K7_ROWS = 256


def timed_k7(dev, n, d):
    """K7's DFT at (K7_ROWS, n) on the large-axis kernel (natural order,
    through `cplx_matmul(..., dft=...)`) against the dense Karatsuba kernel
    with the (n, n) DFT matrices (`dft=None`), the plain version, one
    torch.fft call and the bound."""
    xr, xi = d(K7_ROWS, n), d(K7_ROWS, n)
    cx = torch.complex(xr, xi)
    for forward in (True, False):
        mats = cs.dft_triple(torch, n, forward, dev)
        kfn = lambda: cf.cplx_matmul(xr, xi, *mats, dft=forward)  # noqa
        lfn = (lambda: torch.fft.fft(cx, dim=-1)) if forward else (
            lambda: torch.fft.ifft(cx, dim=-1))
        cf.reset_launch_counts()
        kfn()
        entry = dict(cf.ENTRY_LAUNCHES)
        g_ms, g_lib = cs.graph_ms(torch, kfn), cs.graph_ms(torch, lfn)
        dense_ms = cs.time_ms(
            torch, lambda: cf.cplx_matmul(xr, xi, *mats), 2)
        plain_ms = cs.time_ms(
            torch, lambda: cf.cplx_matmul_plain(xr, xi, *mats), 2)
        b_ms, by = cs.bound(*cs.work_stage(xr.numel(), n))
        print(f"K7 {'fwd' if forward else 'inv'} ({K7_ROWS}, {n})   large "
              f"{g_ms:8.4f} ms  dense {dense_ms:9.3f}  plain {plain_ms:8.3f}  "
              f"torch.fft {g_lib:8.4f}  bound {b_ms:7.4f} ({by})  "
              f"large/bound {g_ms / b_ms:5.2f}  {entry}", flush=True)
        del mats
        torch.cuda.empty_cache()


def sweep_grid(n, z):
    """(tpr1, cols1, tpr2, cols2) knob settings for the sweep."""
    plan = stage_large_plan(n, not z)
    if not plan[1]:   # Form A: threads a row
        return [(0, 0, t, 0) for t in (128, 256, 384, 512)]
    grid = [(t1, c1, 0, 0) for t1 in (0, 1, 2) for c1 in (16, 32, 64, 128,
                                                           256, 0)]
    grid += [(0, 0, t2, c2) for c2 in (4, 8, 16) for t2 in (0, 8, 16, 32,
                                                            64)]
    return grid


PLAN_BYTES = """
import sys, torch
sys.path.insert(0, {root!r})
from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3
dev = torch.device("cuda", 0)
torch.cuda.init()
torch.cuda.reset_peak_memory_stats()
base = torch.cuda.memory_allocated()
plan = MatmulFFT3({shape!r}, dev)
torch.cuda.synchronize()
print(torch.cuda.max_memory_allocated() - base,
      torch.cuda.memory_allocated() - base)
"""


def plan_bytes(root: Path):
    """(peak, held) device bytes of MatmulFFT3(PLAN_SHAPE) built by the
    package at `root`, in a process of its own."""
    out = subprocess.run([sys.executable, "-c", PLAN_BYTES.format(
        root=str(root), shape=PLAN_SHAPE)], capture_output=True, text=True,
        timeout=600, cwd=str(root))
    if out.returncode:
        raise RuntimeError(out.stderr[-2000:])
    peak, held = map(int, out.stdout.split()[-2:])
    return peak, held


class Tee:
    """Standard output, also written whole to
    chiprun_out/stage_large_bench.txt."""

    def __init__(self, path: Path):
        path.parent.mkdir(exist_ok=True)
        self.file, self.out = open(path, "w"), sys.stdout

    def write(self, text):
        self.file.write(text)
        return self.out.write(text)

    def flush(self):
        self.file.flush()
        self.out.flush()


def main() -> int:
    sys.stdout = Tee(ROOT / "chiprun_out" / "stage_large_bench.txt")
    check_only, sweep = "--check" in sys.argv, "--sweep" in sys.argv
    only = (sys.argv[sys.argv.index("--only") + 1]
            if "--only" in sys.argv else "")
    parent = (Path(sys.argv[sys.argv.index("--parent") + 1])
              if "--parent" in sys.argv else None)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    load_library()
    info = build_info()
    print(f"card: {cs.card_line()}; built in {info['seconds']:.1f} s")
    entry = ""
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "large_" in entry and ("Used" in line or "stack frame" in line
                                    or "spill" in line):
            print(f"  {entry}: {line.strip()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def d(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5

    bad = []
    check(dev, gen, bad)
    if not check_only:
        for label, n, zshape, rows in TIMED:
            if only not in label:
                continue
            for form, shape, kfn, dfn, lfn, work, knob in timed_forms(
                    dev, n, zshape, rows, d):
                cf.reset_launch_counts()
                kfn()
                entry = dict(cf.ENTRY_LAUNCHES)
                g_ms, g_lib = cs.graph_ms(torch, kfn), cs.graph_ms(torch, lfn)
                g_ms2 = cs.graph_ms(torch, kfn)
                dense_ms = cs.time_ms(torch, dfn, 2)
                b_ms, by = cs.bound(*work)
                ms = min(g_ms, g_ms2)
                print(f"{label:<22s} {form:<9s} {str(shape):<17s} large "
                      f"{g_ms:8.4f} / {g_ms2:8.4f} ms  dense {dense_ms:9.3f}"
                      f"  torch.fft {g_lib:8.4f}  bound {b_ms:7.4f} ({by})  "
                      f"large/bound {ms / b_ms:5.2f}  torch.fft/large "
                      f"{g_lib / ms:5.2f}  {entry}", flush=True)
                if entry != {"ipp_stage_large": 1}:
                    bad.append(f"{label} {form}: {entry}")
                if sweep and knob is not None:
                    for t1, c1, t2, c2 in sweep_grid(n, "z" in form):
                        try:
                            t_ms = cs.graph_ms(
                                torch, lambda: knob(t1, c1, t2, c2))
                        except (RuntimeError, ValueError):
                            continue
                        print(f"    sweep {form} n={n} pass1 threads "
                              f"{t1 or 'own'} cols {c1 or 'own'}, pass2 / "
                              f"Form A threads {t2 or 'own'} cols "
                              f"{c2 or 'own'}: {t_ms:8.4f} ms", flush=True)
            torch.cuda.empty_cache()
        for n in K7_LENGTHS if not only or "K7" in only else ():
            timed_k7(dev, n, d)
        peak, held = plan_bytes(ROOT)
        print(f"plan {PLAN_SHAPE}: device bytes peak {peak}, held {held}")
        if parent is not None:
            peak, held = plan_bytes(parent.resolve())
            print(f"plan {PLAN_SHAPE} ({parent}): device bytes peak {peak}, "
                  f"held {held}")
    print(f"card: {cs.card_line()}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
