#!/usr/bin/env python3
"""Check and time K1d and K2d, the dense forms of the y real DFT and its
inverse (csrc/rdft_dense.cu: three TF32 products on wgmma), on one CUDA card.

    python3 scripts/rdft_dense_bench.py [--quick] [--variants]

First every form against its plain version (max |kernel - plain| / max
|plain| <= 1e-5): K1d plain and with the ratio, K2d plain and with |mul *
y|, at shapes ragged against every tile (odd nx, ny not 8*j, a random
non-DFT matrix) and at the deconvolution CLI's block (256, 1056, 256) with
the fold matrices; then at that block and at (4, 256, 1056, 256) each
form's kernel, plain version and one torch.matmul of the same product in ms
by CUDA events after a warm call, beside the bound (three bf16 products at
989 TFLOP/s, or the bytes at 3.35 TB/s, `chip_smoke.work_rdft_dense`).
`--quick` checks the small shapes and times the plain forms at the CLI
block only.  `--variants` then builds csrc/rdft_dense.cu alone with
IPP_RDFT_DENSE_DIAG = 1, 2, 3 (timing only, results wrong: no wgmma; no
global loads; the wgmmas and barriers alone) and times each form at the
CLI block: where the time goes.  Prints ptxas' registers and spills of the
kernels and any wgmma warning first, the card's name and power limit last;
details to chiprun_out/rdft_dense_bench.json.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ipp_tpu_torch.ops import _build  # noqa: E402
from ipp_tpu_torch.ops import cuda_fft as cf  # noqa: E402
from ipp_tpu_torch.ops.dft_mats import rfft_fold_mats  # noqa: E402

CLI = (256, 1056, 256, 536)          # nz, ny, nx, kp of the CLI's block
# (nz, ny, nx, kp, matrix): ragged against the 128-column and 216 / 128-row
# tiles and the 32-deep stages; "fold" the real-DFT fold, "random" any matrix
SMALL = [(3, 100, 70, 56, "fold"), (4, 24, 33, 16, "fold"),
         (5, 1100, 255, 552, "fold"), (3, 300, 130, 100, "random"),
         (2, 2560, 64, 1288, "fold")]
VARIANTS = {"diag_no_wgmma": 1, "diag_no_loads": 2, "diag_wgmma_only": 3}


def mats(n_y, kp, kind, dev, gen):
    if kind == "fold":
        return tuple(torch.tensor(m, device=dev)
                     for m in rfft_fold_mats(n_y, kp))
    return (torch.rand(2 * kp, n_y, generator=gen, device=dev) - 0.5,
            torch.rand(n_y, 2 * kp, generator=gen, device=dev) - 0.5)


def forms(x, den, mul, sr, si, fwd, inv, batched):
    """(name, kernel_fn, plain_fn, library_fn, extra streams) of the four
    forms; the library call is one torch.matmul of the same product."""
    k1 = cf.rdft_y_fwd_batched if batched else cf.rdft_y_fwd
    k2 = cf.rdft_y_inv_batched if batched else cf.rdft_y_inv
    both = torch.cat([sr, si], -3).transpose(-3, -2).contiguous()
    return [
        ("K1d", lambda: k1(x, fwd), lambda: cf.rdft_y_fwd_plain(x, fwd),
         lambda: torch.matmul(fwd, x), 0),
        ("K1d ratio", lambda: k1(x, fwd, den),
         lambda: cf.rdft_y_fwd_plain(x, fwd, den),
         lambda: torch.matmul(fwd, x), 1),
        ("K2d", lambda: k2(sr, si, inv), lambda: cf.rdft_y_inv_plain(sr, si, inv),
         lambda: torch.matmul(inv, both), 0),
        ("K2d mul", lambda: k2(sr, si, inv, mul),
         lambda: cf.rdft_y_inv_plain(sr, si, inv, mul),
         lambda: torch.matmul(inv, both), 1),
    ]


def volumes(lead, nz, ny, nx, kp, gen, dev):
    def d(*shape, lo=0.0):
        return torch.rand(lead + shape, generator=gen, device=dev) * (1 - lo) + lo

    return (d(nz, ny, nx), d(nz, ny, nx, lo=0.5), d(nz, ny, nx, lo=-1),
            d(kp, nz, nx, lo=-1), d(kp, nz, nx, lo=-1))


def build_variants():
    """{name: library} of csrc/rdft_dense.cu built alone with each
    IPP_RDFT_DENSE_DIAG value (all nvcc processes at once)."""
    out = ROOT / "build" / "rdft_dense_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = ROOT / "ipp_tpu_torch" / "csrc" / "rdft_dense.cu"
    log = _build._run([[_build._nvcc(), *_build._ARCH, "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                        f"-DIPP_RDFT_DENSE_DIAG={v}", "-shared", "-o",
                        str(out / f"{name}.so"), str(src)]
                       for name, v in VARIANTS.items()])
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for entry in ("ipp_rdft_y_fwd", "ipp_rdft_y_inv"):
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs, log


def variant_fns(lib, x, den, mul, sr, si, fwd, inv):
    """The four forms through a variant library, outputs preallocated."""
    nz, ny, nx = x.shape
    kp = sr.shape[0]
    re, im, out = (torch.empty_like(sr), torch.empty_like(si),
                   torch.empty_like(x))
    counts = {"variant": 0}

    def call(entry, *ptrs):
        return lambda: cf._launch("variant", x.device, getattr(lib, entry),
                                  *ptrs, 1, nz, ny, nx, kp, counts=counts)

    p = torch.Tensor.data_ptr
    return {"K1d": call("ipp_rdft_y_fwd", p(x), None, p(fwd), p(re), p(im)),
            "K1d ratio": call("ipp_rdft_y_fwd", p(x), p(den), p(fwd), p(re),
                              p(im)),
            "K2d": call("ipp_rdft_y_inv", p(sr), p(si), p(inv), None, p(out)),
            "K2d mul": call("ipp_rdft_y_inv", p(sr), p(si), p(inv), p(mul),
                            p(out))}


def main() -> int:
    quick, variants = "--quick" in sys.argv, "--variants" in sys.argv
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    _build.load_library()
    info = _build.build_info()
    print(f"built in {info['seconds']:.1f} s")
    for line in cs.ptxas_summary(info["ptxas"]):
        if "rdft_dense" in line:
            print(" ", line)
    serialized = [line.strip() for line in info["ptxas"].splitlines()
                  if "C7515" in line or "serialized" in line]
    for line in serialized:
        print("  ptxas:", line)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    bad, checks, rows = [], [], []
    for nz, ny, nx, kp, kind in SMALL + [CLI + ("fold",)]:
        fwd, inv = mats(ny, kp, kind, dev, gen)
        x, den, mul, sr, si = volumes((), nz, ny, nx, kp, gen, dev)
        for name, kfn, pfn, _, _ in forms(x, den, mul, sr, si, fwd, inv,
                                           False):
            cf.reset_launch_counts()
            got, ref = kfn(), pfn()
            torch.cuda.synchronize()
            launched = {k: v for k, v in cf.LAUNCHES.items() if v}
            abs_err, rel = cs.err_of_max(got, ref)
            want = {("rdft_y_fwd_dense" if name.startswith("K1d")
                     else "rdft_y_inv_dense"): 1}
            checks.append(dict(form=name, shape=[nz, ny, nx, kp], matrix=kind,
                               rel_err=rel, max_abs_err=abs_err,
                               launches=launched))
            print(f"  {name:<10s} {str((nz, ny, nx, kp)):<24s} {kind:<6s} "
                  f"rel {rel:.2e}  launches {launched}")
            if not rel <= 1e-5 or launched != want:
                bad.append(f"{name} at {(nz, ny, nx, kp)} {kind}: rel "
                           f"{rel:.3e}, launches {launched}")
            del got, ref
        if kind == "fold":   # the fold's zero rows give exactly 0
            re, im = cf.rdft_y_fwd(x, fwd)
            kx = ny // 2 + 1
            if not (bool((re[kx:] == 0).all()) and bool((im[kx:] == 0).all())):
                bad.append(f"K1d at {(nz, ny, nx, kp)}: zero rows not 0")
        del x, den, mul, sr, si
    shapes = [((), CLI)] if quick else [((), CLI), ((4,), CLI)]
    for lead, (nz, ny, nx, kp) in shapes:
        fwd, inv = mats(ny, kp, "fold", dev, gen)
        x, den, mul, sr, si = volumes(lead, nz, ny, nx, kp, gen, dev)
        vox = x.numel()
        for name, kfn, pfn, lfn, extra in forms(x, den, mul, sr, si, fwd,
                                                inv, bool(lead)):
            if quick and name.endswith(("ratio", "mul")):
                continue
            ms = cs.time_ms(torch, kfn, 10)
            plain_ms = cs.time_ms(torch, pfn, 5)
            lib_ms = cs.time_ms(torch, lfn, 10)
            ms2 = cs.time_ms(torch, kfn, 10)
            b_ms, by = cs.bound(*cs.work_rdft_dense(vox, ny, kp, extra))
            rows.append(dict(form=name, shape=list(lead) + [nz, ny, nx],
                             ms=ms, ms_again=ms2, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=by))
            print(f"  {name:<10s} {str(lead + (nz, ny, nx)):<22s} kernel "
                  f"{ms:8.3f} / {ms2:8.3f} ms  plain {plain_ms:8.3f}  "
                  f"torch.matmul {lib_ms:8.3f}  bound {b_ms:7.3f} ({by})")
        del x, den, mul, sr, si
        torch.cuda.empty_cache()
    variant_rows = []
    if variants:
        libs, log = build_variants()
        for line in cs.ptxas_summary(log):
            print("  variants:", line)
        nz, ny, nx, kp = CLI
        fwd, inv = mats(ny, kp, "fold", dev, gen)
        x, den, mul, sr, si = volumes((), nz, ny, nx, kp, gen, dev)
        for vname, lib in libs.items():
            for name, fn in variant_fns(lib, x, den, mul, sr, si, fwd,
                                        inv).items():
                ms = cs.time_ms(torch, fn, 10)
                variant_rows.append(dict(variant=vname, form=name, ms=ms))
                print(f"  {vname:<16s} {name:<10s} {ms:8.3f} ms")
    card = cs.card_line()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "rdft_dense_bench.json").write_text(json.dumps(dict(
        card=card, checks=checks, times=rows, variants=variant_rows,
        ptxas=info["ptxas"]), indent=1))
    print(f"card: {card}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
