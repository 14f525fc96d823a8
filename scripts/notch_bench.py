#!/usr/bin/env python3
"""Time K8, the destripe notch, on one CUDA card.

    python3 scripts/notch_bench.py [--variants] [--tag T]

At every notch the destripe chain runs on `chip_smoke.py` phase 6's padded
batches of 8 (`chip_smoke.notch_level_cases`: cH along x and cV along y at
levels 1-7 of (8, 2688, 2688) and (8, 2304, 2688)): the kernel against its
plain version (max |kernel - plain| / max |plain| <= 1e-5), then the
kernel, the plain version, the library call (torch.fft's rfft * g, irfft)
and the bound (`chip_smoke.work_notch`: 8 bytes a value over the HBM rate),
in ms by CUDA events and, for the kernel, by CUDA-graph replay (the
device's time alone: the wrapper's host time hides it at the deep levels).
Prints ptxas' registers and spills first, the card's name and power limit
last; writes chiprun_out/notch_bench[_TAG].json.

`--variants` then builds csrc/notch.cu alone with `IPP_NOTCH_DIAG` set
(timing-only builds: 1 skips the passes, so the loads and stores of device
memory alone run; 2 skips those, so the passes alone run) and times each
by graph replay at levels 1 and 2 of the 2000^2 batch on both axes beside
this build and one clone of the same bytes: where the kernel's time goes.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ipp_tpu_torch.ops import cuda_notch as cn  # noqa: E402
from ipp_tpu_torch.ops import destripe as dsm  # noqa: E402
from ipp_tpu_torch.ops._build import (_ARCH, _SIGNATURES, _nvcc, _run,  # noqa: E402
                                      build_info, load_library)
from ipp_tpu_torch.ops.cuda_fft import _launch  # noqa: E402

VARIANTS = {"diag_nopasses": ["-DIPP_NOTCH_DIAG=1"],
            "diag_noglobal": ["-DIPP_NOTCH_DIAG=2"]}


def arg(name, default=None):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def build_variants():
    """{name: library} of csrc/notch.cu built with each VARIANTS flag (all
    nvcc processes at once) into build/notch_variants/."""
    out = ROOT / "build" / "notch_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = ROOT / "ipp_tpu_torch" / "csrc" / "notch.cu"
    log = _run([[_nvcc(), *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", *flags, "-shared", "-o",
                 str(out / f"{name}.so"), str(src)]
                for name, flags in VARIANTS.items()])
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.ipp_notch.argtypes = _SIGNATURES["ipp_notch"]
        lib.ipp_notch.restype = ctypes.c_int
        libs[name] = lib
    return libs, log


def lib_fn(lib, x, g, axis):
    """K8 through `lib`'s C entry (this build or a variant), x -> one
    output allocated here."""
    _, B, H, W, _ = cn._check(x, g, axis)
    y = torch.empty_like(x)
    args, scratch = cn._kernel_args(x, y, g, B, H, W, axis)
    counts = {"variant": 0}

    def run(scratch=scratch):   # the scratch lives as long as the call
        _launch("variant", x.device, lib.ipp_notch, *args, counts=counts)
        return y
    return run


def main() -> int:
    tag = arg("--tag")
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}")
    lib = load_library()
    info = build_info()
    print(f"built in {info['seconds']:.1f} s")
    for line in cs.ptxas_summary(info["ptxas"]):
        if "notch" in line:
            print(" ", line)
    variants = {}
    if "--variants" in sys.argv:
        variants, log = build_variants()
        for line in cs.ptxas_summary(log):
            print("  variants:", line)
    gen = np.random.default_rng(19)
    rows, bad, variant_rows = [], [], []
    cases = cs.notch_level_cases()
    for shape, axis, sigma in cases:
        n = shape[axis]
        x = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)
                             ).to(dev)
        g = dsm.notch(n // 2 + 1, 0.5 * sigma)
        gt = torch.from_numpy(g).to(dev).reshape((-1, 1) if axis == -2
                                                 else (-1,))
        kfn = lambda: cn.notch_filter(x, g, axis)  # noqa: E731
        pfn = lambda: cn.notch_filter_plain(x, g, axis)  # noqa: E731
        lfn = lambda: torch.fft.irfft(  # noqa: E731
            torch.fft.rfft(x, dim=axis) * gt, n=n, dim=axis)
        _, rel = cs.err_of_max(kfn(), pfn())
        ms, graph = cs.time_ms(torch, kfn, 20), cs.graph_ms(torch, kfn, 20)
        plain, lib_ms = cs.time_ms(torch, pfn, 20), cs.time_ms(torch, lfn, 20)
        bound_ms, by = cs.bound(*cs.work_notch(x.numel(), n))
        geo = cn.notch_geometry(shape[0], shape[1], shape[2], axis == -2)
        rows.append(dict(shape=list(shape), axis=axis, n=n, rel_err=rel,
                         ms=ms, graph_ms=graph, plain_ms=plain,
                         library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
                         plan=list(cn.notch_plan(n)), geometry=geo))
        print(f"  K8 {str(shape):<17s} axis {axis:2d} n {n:5d} plan "
              f"{cn.notch_plan(n)} rel {rel:.2e}  kernel {ms:7.4f} ms (graph "
              f"{graph:7.4f})  plain {plain:7.4f}  library {lib_ms:7.4f}  "
              f"bound {bound_ms:7.4f} ({by})  graph/bound "
              f"{graph / bound_ms:5.2f}  CP {geo['CP']} T {geo['T']}")
        if not rel <= 1e-5:
            bad.append(f"K8 {shape} axis {axis}: {rel:.2e}")
        if variants and shape[1] in (1344, 672) and shape[2] == shape[1]:
            for vname, vlib in {"this build": lib, **variants}.items():
                vms = cs.graph_ms(torch, lib_fn(vlib, x, g, axis), 20)
                variant_rows.append(dict(variant=vname, shape=list(shape),
                                         axis=axis, ms=vms,
                                         bound_ms=bound_ms))
                print(f"    variant {vname:<14s} {vms:7.4f} ms "
                      f"({vms / bound_ms:5.2f}x bound)")
            vms = cs.graph_ms(torch, lambda: x.clone(), 20)
            variant_rows.append(dict(variant="clone", shape=list(shape),
                                     axis=axis, ms=vms, bound_ms=bound_ms))
            print(f"    variant {'x.clone()':<14s} {vms:7.4f} ms "
                  f"({vms / bound_ms:5.2f}x bound)")
        del x
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"notch_bench{'_' + tag if tag else ''}.json").write_text(
        json.dumps(dict(card=card, rows=rows, variants=variant_rows,
                        ptxas=[s for s in cs.ptxas_summary(info["ptxas"])
                               if "notch" in s]), indent=1))
    print(f"card: {cs.card_line()}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
