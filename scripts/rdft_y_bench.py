#!/usr/bin/env python3
"""Time K1 and K2, the v2 walk's y-axis real DFT and its inverse, on one
CUDA card.

    python3 scripts/rdft_y_bench.py [--quick] [--sweep]

At the shapes the paths run them — the deconvolution CLI's block (256,
1056, 256), a 512^3 block, the batched call's (4, 256, 1056, 256) — and at
(128, ny, 256) for the lengths ny = 8, 24, 40, 136, 536, 1120, 1152, 2008,
2048 that cover every radix of the plan, each plain and with its fused
stream (the RL ratio, |mul * y|): the real-FFT kernel (csrc/rdft_y.cuh)
against the plain version (<= 1e-5 of max), then the real-FFT kernel, the
dense GEMM kernel it replaced (csrc/fft_walk.cu, the same inputs and the
fold matrix), one torch.fft.rfft / irfft call over dim -2 and the bytes
bound, in ms by CUDA events.  Prints ptxas' registers and spills first, the
card's name and power limit last.  `--quick` runs the plain variants only.
`--sweep` then times the kernel's knobs at the three path shapes and at ny
= 768, 1120, 1152, 1536, 2048: the column pairs per block and the threads
per pair (T=0: the kernel's own choice; blocks of at most 384 threads whose
two shared-memory buffers fit).
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
from ipp_tpu_torch.ops.dft_mats import dft_fft_plan, rfft_fold_mats  # noqa: E402
from ipp_tpu_torch.ops.matmul_fft import _kp  # noqa: E402

PATH_SHAPES = [(1, 256, 1056, 256), (1, 512, 512, 512), (4, 256, 1056, 256)]
SHAPES = PATH_SHAPES + [(1, cs.RDFT_PLANES, ny, cs.RDFT_NX)
                        for ny in cs.RDFT_LENGTHS]
SWEEP_SHAPES = PATH_SHAPES + [(1, cs.RDFT_PLANES, ny, cs.RDFT_NX)
                              for ny in (768, 1120, 1152, 1536, 2048)]


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
        if "rdft_y" in line:
            print(" ", line)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def d(*shape, lo=0.0):
        return torch.rand(shape, generator=gen, device=dev) * (1 - lo) + lo

    bad = []
    for nb, nz, ny, nx in SHAPES:
        kp, kx = _kp(ny), ny // 2 + 1
        fwd, inv = (torch.tensor(m, device=dev)
                    for m in rfft_fold_mats(ny, kp))
        x, den, mul = (d(nb, nz, ny, nx), d(nb, nz, ny, nx, lo=0.5),
                       d(nb, nz, ny, nx))
        sr, si = d(nb, kp, nz, nx, lo=-1), d(nb, kp, nz, nx, lo=-1)
        half = torch.complex(sr[:, :kx], si[:, :kx]).transpose(1, 2).contiguous()
        vox = nb * nz * ny * nx
        reps = 10 if vox < 2 ** 27 else 5
        for variant, fused in (("plain", None),) + (
                () if quick else (("fused", True),)):
            for way in ("fwd", "inv"):
                if way == "fwd":
                    extra = den if fused else None

                    def run(fold):
                        return cf.rdft_y_fwd_batched(x, fwd, extra, fold=fold)

                    def plain():
                        return cf.rdft_y_fwd_plain(x, fwd, extra)

                    def lib():
                        return torch.fft.rfft(x, dim=-2)
                else:
                    extra = mul if fused else None

                    def run(fold):
                        return (cf.rdft_y_inv_batched(sr, si, inv, extra,
                                                      fold=fold),)

                    def plain():
                        return (cf.rdft_y_inv_plain(sr, si, inv, extra),)

                    def lib():
                        return torch.fft.irfft(half, n=ny, dim=-2)
                got, ref = run(True), plain()
                rel = cs.err_of_max(got, ref)[1]
                del got, ref
                ms = cs.time_ms(torch, lambda: run(True), reps)
                dense_ms = cs.time_ms(torch, lambda: run(False), 2)
                lib_ms = cs.time_ms(torch, lib, reps)
                ms2 = cs.time_ms(torch, lambda: run(True), reps)
                b_ms, by = cs.bound(*cs.work_rdft(vox, ny, kp,
                                                  int(bool(fused))))
                best = min(ms, ms2)
                print(f"{way} {variant:<5s} {str((nb, nz, ny, nx)):<22s} "
                      f"plan {dft_fft_plan(ny)}: rel {rel:.2e}  fft kernel "
                      f"{ms:8.4f} / {ms2:8.4f} ms  dense kernel "
                      f"{dense_ms:8.3f}  torch.fft {lib_ms:8.4f}  bound "
                      f"{b_ms:7.4f} ({by})  kernel/bound {best / b_ms:5.2f}  "
                      f"kernel/torch.fft {best / lib_ms:5.2f}", flush=True)
                if not rel <= 1e-5:
                    bad.append(f"{way} {variant} {(nb, nz, ny, nx)}: rel "
                               f"{rel:.3e}")
        del x, den, mul, sr, si, half, fwd, inv
        torch.cuda.empty_cache()
    if sweep:
        print("sweep (ms, K1 / K2 plain; pairs per block x threads per pair):")
        for nb, nz, ny, nx in SWEEP_SHAPES:
            kp = _kp(ny)
            x = d(nb, nz, ny, nx)
            sr, si = d(nb, kp, nz, nx, lo=-1), d(nb, kp, nz, nx, lo=-1)
            for pairs in (2, 4, 8, 16):
                line = []
                for tpp in sorted({0, ny // 8, ny // 11, ny // 12, ny // 16,
                                   ny // 22, ny // 24, ny // 32}):
                    if pairs * tpp > 384 or 16 * ny * pairs > 227 * 1024:
                        continue
                    k1 = cs.time_ms(torch, lambda: cf.rdft_y_fwd_fft(
                        x, kp, None, "rdft_y_fwd_batched", tpp, pairs), 5)
                    k2 = cs.time_ms(torch, lambda: cf.rdft_y_inv_fft(
                        sr, si, ny, None, "rdft_y_inv_batched", tpp, pairs),
                        5)
                    line.append(f"T={tpp}: {k1:.4f} / {k2:.4f}")
                print(f"  {(nb, nz, ny, nx)} pairs={pairs}: "
                      + "  ".join(line), flush=True)
            del x, sr, si
            torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
