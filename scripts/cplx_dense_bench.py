#!/usr/bin/env python3
"""Check and time K7d, the dense complex product (rr + i ii) = (re + i im) @
(mr + i mi) on the tensor cores (csrc/cplx_dense.cu: Karatsuba's three real
products, each as three TF32 products on wgmma), on one CUDA card.

    python3 scripts/cplx_dense_bench.py [--quick] [--variants]
                                        [--parent DIR]

First the kernel against its plain version (max |kernel - plain| / max
|plain| <= 1e-5, one `cplx_matmul_dense` launch a call) at shapes ragged
against every tile (M against 128 rows, N against 64 columns, K against
the 32-deep stages and the flushes every 256, K not a multiple of 4, data
off 16-byte alignment) with DFT and random matrices; then at the cases of
`chip_smoke.K7_DENSE_CASES` the kernel (twice), the plain version and one
complex torch.matmul of the same product in ms (CUDA events; CUDA-graph
replay where chip_smoke says so), beside the bound (`chip_smoke.work_cplx`:
three bf16 products a real product at 989 TFLOP/s, or the bytes at 3.35
TB/s).  Before the times, at the same cases, every row: the kernel's
arithmetic as tests/test_torch_cplx_dense.py emulates it
(`emulate_cplx`), with the TF32 split the kernel uses and with the TPU's
bf16 split, each against the float64 product beside the kernel's own
error: whether the model holds at full size, and whether bf16 x 3, at
twice the TF32 rate and so the bound's yardstick, is f32-grade (<= 1e-5
of max) there.  `--quick` runs the two smallest cases only.  `--variants`
builds csrc/cplx_dense.cu alone with IPP_CPLX_DENSE_DIAG = 1, 2, 3 (timing
only, results wrong: no wgmma; no global loads; the wgmmas and barriers
alone: where the time goes) and times each case with them.  `--parent
DIR` loads the kernel library of the package unpacked at DIR (another
commit's `git archive`), built by DIR's own ops/_build.py, and times its
ipp_cplx_matmul at the same cases in the same call; and compares the SASS
of DIR's csrc/rdft_dense.cu with this tree's (K1d / K2d must compile to
the same code).  Fails if a check, a case or the bf16 yardstick misses
1e-5.  Prints ptxas' registers, spills and stack frames of the
kernels and any wgmma warning first, the card's name and power limit
last; details to chiprun_out/cplx_dense_bench.json.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ipp_tpu_torch.ops import _build  # noqa: E402
from ipp_tpu_torch.ops import cuda_fft as cf  # noqa: E402
from ipp_tpu_torch.ops.dft_mats import cplx_triple  # noqa: E402

# (M, K, N, matrix, dft, data offset in floats): ragged shapes; "dft" the
# forward DFT triple of length K == N, "random" any matrices
CHECKS = [(300, 30, 30, "dft", True, 0), (257, 50, 50, "dft", False, 0),
          (70, 70, 70, "dft", None, 0), (1, 1, 1, "random", None, 0),
          (129, 300, 65, "random", None, 0), (1000, 136, 136, "dft", None, 0),
          (500, 200, 72, "random", None, 0), (333, 136, 136, "dft", None, 1),
          (4100, 1100, 1100, "dft", True, 0), (256, 2600, 40, "random", None, 0),
          (130, 516, 129, "random", None, 0)]
VARIANTS = {"diag_no_wgmma": ["IPP_CPLX_DENSE_DIAG=1"],
            "diag_no_loads": ["IPP_CPLX_DENSE_DIAG=2"],
            "diag_wgmma_only": ["IPP_CPLX_DENSE_DIAG=3"]}
ENTRY = "ipp_cplx_matmul"


def operands(m, k, n, kind, dev, gen, offset=0):
    """(re, im, mr, mi, mri) on the card; re and im `offset` floats into
    their storage (off 16-byte alignment for an odd offset)."""
    def data():
        flat = torch.rand(m * k + offset, generator=gen, device=dev) - 0.5
        return flat[offset:].view(m, k)

    re_, im = data(), data()
    if kind == "dft":
        return (re_, im) + tuple(torch.tensor(a, device=dev)
                                 for a in cplx_triple(n, True))
    mr = torch.rand(k, n, generator=gen, device=dev) - 0.5
    mi = torch.rand(k, n, generator=gen, device=dev) - 0.5
    return re_, im, mr, mi, mr + mi


def build_alone(builds):
    """{name: (library, its ptxas report)} of csrc/cplx_dense.cu built
    alone with each entry's -D defines (builds maps name -> defines); all
    nvcc processes at once.  The libraries have ipp_cplx_matmul bound."""
    out = ROOT / "build" / "cplx_dense_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = ROOT / "ipp_tpu_torch" / "csrc" / "cplx_dense.cu"
    cmds = [[_build._nvcc(), *_build._ARCH, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", *[f"-D{d}" for d in defines],
             "-shared", "-o", str(out / f"{name}.so"), str(src)]
            for name, defines in builds.items()]
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in zip(builds, cmds)}
    libs = {}
    for name, proc in procs.items():
        out_text, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = _build._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        libs[name] = (lib, err + out_text)
    return libs


def parent_library(parent: Path):
    """The kernel library of the package at `parent`, built into its own
    build directory by its own ops/_build.py (every C entry bound)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "ipp_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_library()


def precision(dev, gen, cases):
    """max |x - exact| / max |exact| at each case, every row: the kernel,
    and its arithmetic emulated with the TF32 split and with bf16's; the
    exact product in float64 on the card."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_cplx_dense as emu

    rows = []
    for m, k, n, kind, _ in cases:
        ops = operands(m, k, n, "random" if kind == "random" else "dft", dev,
                       gen)
        c = torch.complex(ops[0].double(), ops[1].double()) @ torch.complex(
            ops[2].double(), ops[3].double())
        exact = (c.real, c.imag)
        row = dict(shape=[m, k, n], matrix=kind, kernel=emu.err_of_max(
            cf.cplx_matmul(*ops, dft=True if kind == "dft=True" else None),
            exact))
        for split in (emu.split_tf32, emu.split_bf16):
            row[split.__name__] = emu.err_of_max(
                emu.emulate_cplx(*ops, split=split), exact)
        print(f"  precision {str((m, k, n)):<20s} {kind:<8s} kernel "
              f"{row['kernel']:.3e}  emulated 3xTF32 {row['split_tf32']:.3e}"
              f"  bf16x3 {row['split_bf16']:.3e}", flush=True)
        rows.append(row)
        del ops, c, exact
        torch.cuda.empty_cache()
    return rows


def lib_fn(lib, ops):
    """K7d of another library on ops, its outputs preallocated."""
    re_, im, mr, mi, mri = ops
    m, k = re_.shape
    n = mr.shape[1]
    rr, ii = (torch.empty(m, n, device=re_.device) for _ in range(2))
    counts = {"other": 0}
    p = torch.Tensor.data_ptr

    def call():
        cf._launch("other", re_.device, getattr(lib, ENTRY), p(re_), p(im),
                   p(mr), p(mi), p(mri), p(rr), p(ii), m, k, n,
                   counts=counts)
        return rr, ii
    return call


def sass(src: Path, tag: str) -> str:
    """The SASS of one source compiled alone, addresses stripped."""
    out = ROOT / "build" / "cplx_dense_variants" / f"{tag}.cubin"
    _build._run([[_build._nvcc(), *_build._ARCH, "-std=c++17", "-O3",
                  "-cubin", "-o", str(out), str(src)]])
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(out)], check=True,
                          capture_output=True, text=True).stdout
    return "\n".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
                     for line in text.splitlines()
                     if line.strip() and "Function" not in line
                     and "code for" not in line)


def ptxas_lines(log: str, needle: str):
    """ptxas' lines of the kernels whose mangled name contains `needle`."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = needle in line
        if keep and ("registers" in line or "stack frame" in line
                     or "Compiling" in line):
            out.append(line.split("ptxas info    :")[-1].strip())
    return out


def main() -> int:
    quick, variants = "--quick" in sys.argv, "--variants" in sys.argv
    parent = (Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
              if "--parent" in sys.argv else None)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    _build.load_library()
    info = _build.build_info()
    print(f"built in {info['seconds']:.1f} s")
    for line in cs.ptxas_summary(info["ptxas"]):
        if "cplx_dense" in line or "rdft_dense" in line:
            print(" ", line)
    for line in ptxas_lines(info["ptxas"], "cplx_dense"):
        print("  ptxas:", line)
    for line in info["ptxas"].splitlines():
        if "C7515" in line or "serialized" in line or "warning" in line:
            print("  ptxas:", line.strip())
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    bad, checks, rows, others = [], [], [], []
    for m, k, n, kind, dft, offset in CHECKS:
        ops = operands(m, k, n, kind, dev, gen, offset)
        cf.reset_launch_counts()
        got = cf.cplx_matmul(*ops, dft=dft)
        ref = cf.cplx_matmul_plain(*ops)
        torch.cuda.synchronize()
        launched = {k_: v for k_, v in cf.LAUNCHES.items() if v}
        abs_err, rel = cs.err_of_max(got, ref)
        checks.append(dict(shape=[m, k, n], matrix=kind, dft=dft,
                           offset=offset, rel_err=rel, max_abs_err=abs_err,
                           launches=launched))
        print(f"  check {str((m, k, n)):<20s} {kind:<6s} dft={str(dft):<5s} "
              f"offset {offset}: rel {rel:.2e}  launches {launched}")
        if not rel <= 1e-5 or launched != {"cplx_matmul_dense": 1}:
            bad.append(f"{(m, k, n)} {kind} offset {offset}: rel {rel:.3e}, "
                       f"launches {launched}")
        del ops, got, ref
    libs = {}
    for name, (lib, log) in (build_alone(VARIANTS) if variants
                             else {}).items():
        libs[name] = lib
        for line in ptxas_lines(log, "cplx_dense"):
            print(f"  {name} ptxas:", line)
        for line in log.splitlines():
            if "C7515" in line:
                print(f"  {name} ptxas:", line.strip())
    if parent is not None:
        libs["parent"] = parent_library(parent)
        same = (sass(parent / "ipp_tpu_torch" / "csrc" / "rdft_dense.cu",
                     "rdft_parent")
                == sass(ROOT / "ipp_tpu_torch" / "csrc" / "rdft_dense.cu",
                        "rdft_here"))
        print(f"  rdft_dense.cu SASS equal to {parent}'s: {same}")
        others.append(dict(rdft_dense_sass_equal=same))
        if not same:
            bad.append("rdft_dense.cu compiles to other code than the parent's")
    cases = cs.K7_DENSE_CASES
    if quick:
        cases = sorted(cases, key=lambda c: c[0] * c[1] * c[2])[:2]
    others.append(dict(precision=precision(dev, gen, cases)))
    bad += [f"{r['shape']}: emulated bf16 x 3 {r['split_bf16']:.3e}"
            for r in others[-1]["precision"] if not r["split_bf16"] <= 1e-5]
    for m, k, n, kind, timer_name in cases:
        timer = cs.graph_ms if timer_name == "graph" else cs.time_ms
        reps = 10 if m * k * n < 2 ** 34 else 3
        ops = operands(m, k, n, "random" if kind == "random" else "dft", dev,
                       gen)
        dft = True if kind == "dft=True" else None
        c = torch.complex(ops[0], ops[1])
        cm = torch.complex(ops[2], ops[3])
        kfn = lambda: cf.cplx_matmul(*ops, dft=dft)  # noqa: E731
        got, ref = kfn(), cf.cplx_matmul_plain(*ops)
        abs_err, rel = cs.err_of_max(got, ref)
        del got, ref
        ms = timer(torch, kfn, reps)
        plain_ms = timer(torch, lambda: cf.cplx_matmul_plain(*ops), reps)
        lib_ms = timer(torch, lambda: torch.matmul(c, cm), reps)
        ms2 = timer(torch, kfn, reps)
        b_ms, by = cs.bound(*cs.work_cplx(m, k, n))
        row = dict(shape=[m, k, n], matrix=kind, timer=timer_name, rel_err=rel,
                   ms=ms, ms_again=ms2, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=by)
        print(f"  {str((m, k, n)):<20s} {kind:<8s} rel {rel:.2e}  kernel "
              f"{ms:8.3f} / {ms2:8.3f} ms  plain {plain_ms:8.3f}  "
              f"torch.matmul {lib_ms:8.3f}  bound {b_ms:7.3f} ({by})")
        if not rel <= 1e-5:
            bad.append(f"{(m, k, n)}: rel {rel:.3e}")
        for name, lib in libs.items():
            fn = lib_fn(lib, ops)
            o_abs, o_rel = cs.err_of_max(fn(), cf.cplx_matmul_plain(*ops))
            row[name + "_ms"] = timer(torch, fn, reps)
            row[name + "_rel_err"] = o_rel
            print(f"    {name:<8s} {row[name + '_ms']:8.3f} ms  rel {o_rel:.2e}")
        rows.append(row)
        del ops, c, cm
        torch.cuda.empty_cache()
    card = cs.card_line()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "cplx_dense_bench.json").write_text(json.dumps(dict(
        card=card, checks=checks, times=rows, other=others,
        ptxas=info["ptxas"]), indent=1))
    print(f"card: {card}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
