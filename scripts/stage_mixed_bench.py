#!/usr/bin/env python3
"""Time the radix-2 stage's mixed-radix FFT kernel of ipp_tpu_torch
(csrc/stage_mixed.cuh) on one CUDA card.

    python3 scripts/stage_mixed_bench.py [--quick] [--sweep]

First every stage form (forward and inverse over z, forward over x, K6, K4,
K4 conj, K4b with an OTF period of 3 rows) at lengths that cover every
pass kind, against its plain version (<= 1e-5 of max), each one launch of
`ipp_stage_mixed`.  Then the forward z stage, K6 and K4 at the shapes
`chip_smoke.py` times them (n = 384, 2176, 2560, 12288) and the forms of
the (256, 256, 2304) RL block and the (2304, 64, 256) convolve: the mixed
kernel, the dense stage kernel it replaced at these lengths (called
directly), one torch.fft call, the plain version and the bound, in ms by
CUDA events.  `--sweep` adds the middle-axis form's columns and threads a
column and the last-axis form's rows a block.  `--quick`: the checks and
n = 384 and 2560 only.  Each time is by CUDA events over back-to-back
calls, the kernel's and torch.fft's also over calls replayed from one CUDA
graph (the device's time without the host's per call).  Prints ptxas' registers and spills first, the
card's name and power limit last.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ipp_tpu_torch.ops import cuda_fft as cf  # noqa: E402
from ipp_tpu_torch.ops._build import build_info, load_library  # noqa: E402
from ipp_tpu_torch.ops.dft_mats import stage_mats_t  # noqa: E402
# the dense stage kernels called directly (this script's folder is on the
# path when it runs)
from stage_fft_bench import dense_otf, dense_stage  # noqa: E402

CHECK_LENGTHS = (128, 384, 640, 2176, 2304, 2560, 3456, 7296, 12288)
# (label, n, (P, n, X) of the z form, rows of the x forms)
TIMED = [("384", 384, (64, 384, 256), 16384),
         ("2560", 2560, (16, 2560, 256), 4096),
         ("2176", 2176, (16, 2176, 256), 4096),
         ("12288", 12288, (4, 12288, 256), 1024),
         ("RL (256,256,2304) x", 2304, None, 136 * 256),
         ("convolve (2304,64,256) z", 2304, (40, 2304, 256), None)]


def rel_err(got, ref):
    return max(float((g - r).abs().max()) for g, r in zip(got, ref)) / \
        max(float(r.abs().max()) for r in ref)


def check(dev, gen, bad):
    for n in CHECK_LENGTHS:
        worst = 0.0
        for form, counter, kfn, pfn in cs.stage_form_cases(torch, n, gen,
                                                            dev):
            cf.reset_launch_counts()
            got, ref = kfn(), pfn()
            torch.cuda.synchronize()
            counts = {k: v for k, v in cf.LAUNCHES.items() if v}
            err = rel_err(got, ref)
            worst = max(worst, err)
            if counts != {counter: 1} or \
                    cf.ENTRY_LAUNCHES != {"ipp_stage_mixed": 1}:
                bad.append(f"n={n} {form}: launches {counts} "
                           f"{cf.ENTRY_LAUNCHES}")
            if not err <= 1e-5:
                bad.append(f"n={n} {form}: rel {err:.3e}")
        print(f"check n={n:<5d} 7 forms: worst rel {worst:.2e}", flush=True)


def timed_forms(lib, dev, n, zshape, rows, d):
    """(form, shape, kernel_fn, dense_fn, plain_fn, library_fn, work,
    knob_fn(tpr, cols))."""
    fwd, inv = (tuple(torch.tensor(m, device=dev) for m in stage_mats_t(n, f))
                for f in (True, False))
    out = []
    if zshape is not None:
        zr, zi = d(*zshape), d(*zshape)
        cz = torch.complex(zr, zi)
        for f, m, lib_fn in ((True, fwd, torch.fft.fft),
                             (False, inv, torch.fft.ifft)):
            out.append((
                "fwd z" if f else "inv z", zshape,
                lambda f=f, m=m: cf.radix2_stage(zr, zi, *m, f, 1),
                lambda f=f, m=m: dense_stage(lib, zr, zi, m, f, 1),
                lambda f=f, m=m: cf.radix2_stage_plain(zr, zi, *m, f, 1),
                lambda lib_fn=lib_fn: lib_fn(cz, dim=1),
                cs.work_stage(zr.numel(), n),
                lambda tpr, cols, f=f: cf.stage_mixed(
                    zr, zi, f, 1, threads_per_col=tpr, cols=cols)))
    if rows is not None:
        xr, xi, o_r, o_i = d(rows, n), d(rows, n), d(rows, n), d(rows, n)
        cx = torch.complex(xr, xi)
        out += [
            ("fwd x", (rows, n),
             lambda: cf.radix2_stage(xr, xi, *fwd, True, -1),
             lambda: dense_stage(lib, xr, xi, fwd, True, -1),
             lambda: cf.radix2_stage_plain(xr, xi, *fwd, True, -1),
             lambda: torch.fft.fft(cx, dim=-1), cs.work_stage(xr.numel(), n),
             lambda tpr, cols: cf.stage_mixed(xr, xi, True, -1,
                                              threads_per_col=tpr,
                                              cols=cols)),
            ("K6 inv x", (rows, n),
             lambda: cf.radix2_stage(xr, xi, *inv, False, -1),
             lambda: dense_stage(lib, xr, xi, inv, False, -1),
             lambda: cf.radix2_stage_plain(xr, xi, *inv, False, -1),
             lambda: torch.fft.ifft(cx, dim=-1), cs.work_stage(xr.numel(), n),
             None),
            ("K4 otf", (rows, n),
             lambda: cf.radix2_stage_inv_otf(xr, xi, o_r, o_i, *inv, False),
             lambda: dense_otf(lib, xr, xi, o_r, o_i, inv, False),
             lambda: cf.radix2_stage_inv_otf_plain(xr, xi, o_r, o_i, *inv,
                                                   False),
             lambda: torch.fft.ifft(cx, dim=-1),
             cs.work_stage(xr.numel(), n, xr.numel()),
             lambda tpr, cols: cf.stage_mixed(
                 xr, xi, False, -1, (o_r, o_i), False, threads_per_col=tpr,
                 cols=cols))]
    return out


def main() -> int:
    quick, sweep = "--quick" in sys.argv, "--sweep" in sys.argv
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    lib = load_library()
    info = build_info()
    print(f"card: {cs.card_line()}; built in {info['seconds']:.1f} s")
    for line in cs.ptxas_summary(info["ptxas"]):
        if "stage_mixed" in line or "dft_last" in line:
            print(" ", line)
    entry = ""
    for line in info["ptxas"].splitlines():   # local memory: stack frames
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "stack frame" in line and ("stage_mixed" in entry
                                        or "dft_last" in entry):
            print(f"  {entry}: {line.strip()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def d(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5

    bad = []
    check(dev, gen, bad)
    for label, n, zshape, rows in TIMED:
        if quick and n not in (384, 2560):
            continue
        for form, shape, kfn, dfn, pfn, lfn, work, knob in timed_forms(
                lib, dev, n, zshape, rows, d):
            cf.reset_launch_counts()
            err = rel_err(kfn(), pfn())
            entry = dict(cf.ENTRY_LAUNCHES)
            ms = cs.time_ms(torch, kfn, 10)
            dense_ms = cs.time_ms(torch, dfn, 3)
            plain_ms = cs.time_ms(torch, pfn, 3)
            lib_ms = cs.time_ms(torch, lfn, 10)
            ms2 = cs.time_ms(torch, kfn, 10)
            g_ms, g_lib = cs.graph_ms(torch, kfn), cs.graph_ms(torch, lfn)
            b_ms, by = cs.bound(*work)
            print(f"{label:<26s} {form:<9s} {str(shape):<20s} rel {err:.2e} "
                  f"mixed {ms:8.4f} / {ms2:8.4f} ms (graph {g_ms:8.4f})  "
                  f"dense {dense_ms:8.3f}  plain {plain_ms:8.3f}  torch.fft "
                  f"{lib_ms:8.4f} (graph {g_lib:8.4f})  bound {b_ms:7.4f} "
                  f"({by})  mixed/bound {min(ms, ms2) / b_ms:5.2f} (graph "
                  f"{g_ms / b_ms:5.2f})  {entry}", flush=True)
            if not err <= 1e-5 or entry != {"ipp_stage_mixed": 1}:
                bad.append(f"{label} {form}: rel {err:.3e}, {entry}")
            if sweep and knob is not None:
                z = "z" in form
                grid = ([(tpr, c) for c in (1, 2, 4, 8, 16)
                         for tpr in (0, 16, 32, 64, 128, 256)] if z else
                        [(tpr, c) for c in (0, 1, 2, 4)
                         for tpr in (0, n // 8, n // 16, n // 32)])
                for tpr, c in grid:
                    try:
                        t_ms = cs.time_ms(torch, lambda: knob(tpr, c), 10)
                    except (RuntimeError, ValueError):
                        continue
                    print(f"    sweep {form} n={n} threads {tpr or 'own'} "
                          f"{'cols' if z else 'rows'} {c or 'own'}: "
                          f"{t_ms:8.4f} ms", flush=True)
        torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
