#!/usr/bin/env python3
"""Time K7, the dense-axis DFT of the v1 walk, on one CUDA card.

    python3 scripts/dft_fft_bench.py [--quick] [--sweep]

For every (rows, n) at which the paths run K7 — the edge taper's slab
blurs of the deconvolution CLI's block, of a 512^3 block and of a (248,
1100, 1100) block, the FNT cubes' (136, 136, 136) and the v1 RL block's
(256, 1152, 1152): the nine lengths 40, 48, 136, 264, 280, 528, 1072, 1120,
1152 — forward and inverse: the FFT kernel (csrc/dft_fft.cuh) against the
plain version (<= 1e-5 of max), then the FFT kernel, the dense kernel it
replaced (csrc/fft_walk.cu, the same inputs and matrices), one
torch.fft.fft / ifft call on the complex tensor and the bytes bound, in ms
by CUDA events.  Prints ptxas' registers and spills first, the card's name
and power limit last.  `--quick` runs one case per length, forward only.
`--sweep` then times the kernel's knobs at the largest case of each
length: the threads per row, the rows per block, the shared-memory pad,
and other pass lists.
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
from ipp_tpu_torch.ops.dft_mats import cplx_triple, dft_fft_plan  # noqa: E402
from ipp_tpu_torch.ops.matmul_fft import _kp, stage_axes  # noqa: E402

PSF9, PSF_CLI = (9, 9, 9), (13, 9, 9)
WORK_SHAPES = (cs.taper_work_shapes((256, 1056, 256), PSF_CLI)
               + cs.taper_work_shapes((512, 512, 512), PSF9)
               + cs.taper_work_shapes(cs.V1_RL_BLOCK, PSF9)
               + [(136, 136, 136), (256, 1152, 1152)])

# other pass lists for the sweep, by length
OTHER_PLANS = {1152: [(16, 8, 9), (8, 8, 2, 9), (8, 16, 3, 3)],
               1120: [(16, 2, 5, 7), (8, 4, 7, 5)],
               1072: [(8, 2, 67)], 528: [(8, 2, 3, 11)],
               48: [(8, 2, 3)]}


def k7_cases():
    """(rows, n) of every dense stage of the work shapes, largest first
    within a length."""
    seen = set()
    for shape in WORK_SHAPES:
        nz, ny, nx = shape
        radix = stage_axes(shape)
        for n, rows, r in ((nz, ny * _kp(nx), radix[0]),
                           (ny, nz * _kp(nx), radix[1])):
            if not r:
                seen.add((n, -rows))
    return [(-rows, n) for n, rows in sorted(seen)]


def main() -> int:
    quick, sweep = "--quick" in sys.argv, "--sweep" in sys.argv
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    load_library()
    info = build_info()
    print(f"built in {info['seconds']:.1f} s")
    for line in cs.ptxas_summary(info["ptxas"]):
        if "dft_last" in line or "cplx_matmul" in line:
            print(" ", line)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cases = k7_cases()
    if quick:
        cases = list({n: (rows, n) for rows, n in cases[::-1]}.values())[::-1]
    bad, biggest = [], {}
    for rows, n in cases:
        biggest.setdefault(n, rows)
        re = torch.rand((rows, n), generator=gen, device=dev) - 0.5
        im = torch.rand((rows, n), generator=gen, device=dev) - 0.5
        c = torch.complex(re, im)
        for forward in (True,) if quick else (True, False):
            mats = tuple(torch.tensor(m, device=dev)
                         for m in cplx_triple(n, forward))
            lib_fn = torch.fft.fft if forward else torch.fft.ifft
            got = cf.cplx_matmul(re, im, *mats, dft=forward)
            ref = cf.cplx_matmul_plain(re, im, *mats)
            rel = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in zip(got, ref))
            del got, ref
            reps = 10 if rows * n < 2 ** 26 else 5
            ms = cs.time_ms(torch, lambda: cf.cplx_matmul(
                re, im, *mats, dft=forward), reps)
            dense_ms = cs.time_ms(torch, lambda: cf.cplx_matmul(
                re, im, *mats), 2)
            lib_ms = cs.time_ms(torch, lambda: lib_fn(c, dim=-1), reps)
            ms2 = cs.time_ms(torch, lambda: cf.cplx_matmul(
                re, im, *mats, dft=forward), reps)
            b_ms, by = cs.bound(*cs.work_stage(rows * n, n))
            print(f"n={n:<5d} rows={rows:<7d} {'fwd' if forward else 'inv'} "
                  f"plan {dft_fft_plan(n)}: rel {rel:.2e}  fft kernel "
                  f"{ms:8.4f} / {ms2:8.4f} ms  dense kernel {dense_ms:8.3f}  "
                  f"torch.fft {lib_ms:8.4f}  bound {b_ms:7.4f} ({by})  "
                  f"kernel/bound {min(ms, ms2) / b_ms:5.2f}  kernel/torch.fft"
                  f" {min(ms, ms2) / lib_ms:5.2f}", flush=True)
            if not rel <= 1e-5:
                bad.append(f"n={n} rows={rows} fwd={forward}: rel {rel:.3e}")
            del mats
        del re, im, c
        torch.cuda.empty_cache()
    if sweep:
        print("sweep (ms forward; threads per row x rows per block x pad, then "
              "other plans):")
        for n, rows in biggest.items():
            re = torch.rand((rows, n), generator=gen, device=dev) - 0.5
            im = torch.rand((rows, n), generator=gen, device=dev) - 0.5
            own = dft_fft_plan(n)
            for plan in [own] + OTHER_PLANS.get(n, []):
                line = []
                for tpr in sorted({n // 8, max(1, n // 16)}):
                    for cols in sorted({max(1, tgt // tpr)
                                        for tgt in (96, 160, 256)}):
                        for pad in (0, 1):
                            ms = cs.time_ms(torch, lambda: cf.dft_last_fft(
                                re, im, True, pad, tpr, cols, plan), 5)
                            line.append(f"T={tpr} cols={cols} pad={pad}: "
                                        f"{ms:.4f}")
                print(f"  n={n} rows={rows} plan {plan}: " + "  ".join(line),
                      flush=True)
            del re, im
            torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
