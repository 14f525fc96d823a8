#!/usr/bin/env python3
"""Time K8, the destripe notch, on one CUDA card.

    python3 scripts/notch_bench.py [--variants] [--sweep] [--chain]
                                   [--long] [--root DIR] [--tag T]

At every notch the destripe chain runs on `chip_smoke.py` phase 6's padded
batches of 8 (`chip_smoke.notch_level_cases`: cH along x and cV along y at
levels 1-7 of (8, 2688, 2688) and (8, 2304, 2688)): the kernel against its
plain version (max |kernel - plain| / max |plain| <= 1e-5), then the
kernel, the plain version, the library call (torch.fft's rfft * g, irfft)
and the bound (`chip_smoke.work_notch`: 8 bytes a value over the HBM rate),
in ms by CUDA events and, for the kernel, by CUDA-graph replay (the
device's time alone: the wrapper's host time hides it at the deep levels).
Then the 14 notches of each batch in one grouped call (`notch_filter_group`,
what `destripe.filter_subband` runs) by graph replay against the sum of
the one-subband calls' and of the bounds.  Prints ptxas' registers and
spills first, the card's name and power limit last; writes
chiprun_out/notch_bench[_TAG].json.

`--root DIR`: DIR holds another tree of the repository (an unpacked `git
archive` of an earlier commit, `mkdir -p build/parent && git archive
<commit> | tar -x -C build/parent`); its `ipp_tpu_torch` package is
imported under another name (`parent_notch`), so its library builds
through DIR's own `_build.py` and its wrapper builds its own tables: its
K8 runs on the same inputs at every level shape, timed by graph replay in
turns with this tree's (this, DIR, DIR, this), its error against the plain
version beside, and its output compared with this tree's bit for bit (a
difference fails the run); with `--long` its K8l too, by CUDA events in
turns, beside this tree's.

`--long`: K8's long form (K8l) at `chip_smoke.NOTCH_LONG_CASES` and a few
more lengths past shared memory (35328, 45312, 65536, 65856, 131072,
16672, and 32512 / 32128 with an odd factor of 127 / 251 in their
rows), each against the plain version, then kernel / plain / library ms
by CUDA events, the bound and the launches; at every length whose rows
hold a generic radix or a larger odd factor (23, 59, 127, 251, 521) the
rows also forced three ways on the same split (`forced_plans`: table
rows the bench writes itself through `cuda_notch._long_row` with the
split given): the generic pass of p in the rows, Rader's algorithm (p
prime, p - 1 on the specialised radices), the rows' chirp-z transform:
where the threshold stands and which algorithm takes a large prime.
Each K8l row also times `torch.fft` by graph replay beside the kernel's
and splits the kernel's time among its launches from a torch.profiler
trace of ten calls.

`--sweep`: at the level-1 shapes, K8 with other pass lists beside
`notch_plan`'s (the table takes any plan K8 can run; the bench writes
those rows itself, with the gains of each plan), each checked against the
plain version and timed by graph replay.

`--chain`: the destripe chain (`ops.process._chain`, phase 6's stage-1
settings) on one uploaded batch of 8 2000^2 tiles, in a process of its
own for this tree and, with `--root`, for DIR's, in turns (this, DIR, DIR,
this): ms by CUDA events (three means of 10 calls) and by CUDA-graph
replay where the chain can be captured.

`--variants` then builds csrc/notch.cu alone with `IPP_NOTCH_DIAG` set
(timing-only builds: 1 runs no butterfly, so the loads and stores of device
memory and the shared-memory round trip of the first and last pass alone
run; 2 reads and writes no device memory, so the passes alone run) and
times each by graph replay at levels 1 and 2 of the 2000^2 batch on both
axes beside this build and one clone of the same bytes: where the
kernel's time goes.
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
from ipp_tpu_torch.ops.cuda_fft import _launch, _stage_twiddles  # noqa: E402

VARIANTS = {"diag_nopasses": ["-DIPP_NOTCH_DIAG=1"],
            "diag_noglobal": ["-DIPP_NOTCH_DIAG=2"]}
# (shape, axis): pass lists to time beside notch_plan's
SWEEP = {((8, 1344, 1344), -1): [(12, 16, 7), (16, 12, 7), (8, 8, 3, 7)],
         ((8, 1344, 1344), -2): [(12, 16, 7), (16, 12, 7), (8, 8, 3, 7)],
         ((8, 1152, 1344), -2): [(12, 12, 8), (8, 16, 9)],
         ((8, 672, 672), -1): [(12, 8, 7), (8, 4, 3, 7)]}


def arg(name, default=None):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


PARENT = Path(arg("--root")).resolve() if "--root" in sys.argv else None


def build_variants(variants=VARIANTS):
    """{name: library} of csrc/notch.cu built with each set of flags (all
    nvcc processes at once) into build/notch_variants/; the log of the
    builds."""
    out = ROOT / "build" / "notch_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = ROOT / "ipp_tpu_torch" / "csrc" / "notch.cu"
    log = _run([[_nvcc(), *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", *flags, "-shared", "-o",
                 str(out / f"{name}.so"), str(src)]
                for name, flags in variants.items()])
    libs = {}
    for name in variants:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for entry in ("ipp_notch_group", "ipp_notch_long"):
            getattr(lib, entry).argtypes = _SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs, log


CHAIN = r"""
import json, numpy as np, torch
from ipp_tpu_torch.ops.process import ProcessConfig, _chain
from ipp_tpu_torch.utils.transfer import upload
gen = np.random.default_rng(5)
x = (gen.random((8, 2000, 2000)) * 3000 + 100).astype(np.uint16)
cfg = ProcessConfig(sigma=(250.0, 250.0), wavelet="db9",
                    padding_mode="reflect", bidirectional=True, dark=100.0)
xb, u16 = upload(x, torch.device("cuda", 0)), np.dtype(np.uint16)
run = lambda: _chain(xb, cfg, u16)
def events(reps):
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps
run()
torch.cuda.synchronize()
out = dict(events_ms=[events(10) for _ in range(3)], graph_ms=None)
try:
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(5):
            run()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    out["graph_ms"] = a.elapsed_time(b) / 5
except Exception as exc:
    out["graph_error"] = str(exc)[:300]
print(json.dumps(out))
"""


def chain_rows(parent):
    """CHAIN in its own process for this tree and `parent` (or this tree
    alone), in turns."""
    import os
    import subprocess

    trees = [("this", ROOT)] + ([("parent", parent)] if parent else [])
    order = trees + trees[::-1]
    out = []
    for name, tree in order:
        env = dict(os.environ, PYTHONPATH=str(tree))
        res = subprocess.run([sys.executable, "-c", CHAIN], cwd=str(tree),
                             env=env, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"chain of {name}: {res.stderr[-2000:]}")
        row = dict(tree=name, **json.loads(res.stdout.splitlines()[-1]))
        out.append(row)
        print(f"  chain of {name}: events "
              + ", ".join(f"{v:.3f}" for v in row["events_ms"])
              + f" ms; graph {row['graph_ms']} "
              + row.get("graph_error", "")[:120])
    return out


def parent_notch(parent: Path):
    """The `ops.cuda_notch` module of the tree at `parent`, its package
    imported under the name parent_ipp_tpu_torch: its relative imports
    resolve in that tree, its library builds through its own `_build.py`
    into its own build directory."""
    import importlib
    import importlib.util

    name = "parent_ipp_tpu_torch"
    pkg = parent / "ipp_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".ops.cuda_notch")


def group_fn(lib, xs, gs, axes):
    """`notch_filter_group` through `lib`'s C entries (this build or a
    variant), xs -> outputs allocated here."""
    ys = [torch.empty_like(x) for x in xs]
    launches = cn._launches(
        xs, [cn._check(x, g, a) for x, g, a in zip(xs, gs, axes)], axes, ys)
    counts = {"variant": 0}

    def run(launches=launches):   # the tables live as long as the call
        for _, entry, args, kernels, _ in launches:
            _launch("variant", xs[0].device, getattr(lib, entry), *args,
                    counts=counts, kernels=kernels)
        return ys
    return run


def lib_fn(lib, x, g, axis):
    """K8 through `lib`'s C entries (this build or a variant), x -> one
    output allocated here."""
    run = group_fn(lib, [x], [g], [axis])
    return lambda: run()[0]


def plan_fn(lib, x, g, axis, plan):
    """K8 on the pass list `plan` in place of `notch_plan(n)`: a table row
    of csrc/notch.cu's layout (x, y, tw, gp, B, H, W, cols, passes,
    generic, radices) with the gains of that plan, x -> one output
    allocated here."""
    _, B, H, W, n = cn._check(x, g, axis)
    y = torch.empty_like(x)
    tw = _stage_twiddles(x.device, n)
    gp = torch.from_numpy(cn.notch_gains(g, n, plan)).to(x.device)
    generic = int(plan[-1] not in cn.NOTCH_RADICES)
    table = np.asarray([[x.data_ptr(), y.data_ptr(), tw.data_ptr(),
                         gp.data_ptr(), B, H, W, int(axis == -2), len(plan),
                         generic] + list(plan)
                        + [1] * (cn.MAX_PASSES - len(plan))], np.int64)
    counts = {"variant": 0}

    def run(keep=(tw, gp)):   # the tables live as long as the call
        _launch("variant", x.device, lib.ipp_notch_group, table.ctypes.data,
                1, counts=counts)
        return y
    return run


# K8l beside chip_smoke.NOTCH_LONG_CASES: lines past shared memory of the
# wide planes' other levels and sides, a power of two, and rows with a
# generic radix of 127 and 251
LONG_MORE = [((1, 4, 35328), -1), ((1, 45312, 4), -2), ((1, 2, 65536), -1),
             ((1, 4, 65856), -1), ((1, 131072, 2), -2), ((2, 1344, 16672), -1),
             ((1, 2, 32512), -1), ((1, 2, 32128), -1)]
def forced_plans(n):
    """{label: split} of lines of n beside `notch_long_plan(n)`'s where its
    rows hold an odd factor past 13 (a generic radix, Rader's or the
    chirp-z transform): the same n1 x n2 with the rows three ways, the
    generic pass of `notch_plan(n2)`, Rader's algorithm (n2 prime, n2 - 1
    on the specialised radices), the rows' chirp-z transform, each where
    the kernel takes it.  The threshold `GENERIC_MAX` and the choice of
    Rader's algorithm rest on these times."""
    lp = cn.notch_long_plan(n)
    if lp.route != "mixed" or (lp.rows == "mixed"
                               and not cn._generic(lp.plan2)):
        return {}
    n2 = lp.n2
    out = {"generic rows": lp._replace(rows="mixed", m2=n2,
                                       plan2=cn.notch_plan(n2))}
    sub = cn.notch_plan(n2 - 1)
    if (all(n2 % d for d in range(2, int(n2 ** 0.5) + 1))
            and not cn._generic(sub) and len(sub) >= 2):
        out["rader rows"] = lp._replace(rows="rader", m2=n2 - 1, plan2=sub)
    m2 = cn._pow2ceil(2 * n2 - 1)
    if m2 <= cn.ROW_MAX:
        out["chirp rows"] = lp._replace(rows="chirp", m2=m2, plan2=tuple(
            cn._pow2_passes(m2.bit_length() - 1)))
    return {k: v for k, v in out.items() if v != lp}


def long_fn(lib, x, g, axis, plan):
    """K8l on the split `plan`: the row `cuda_notch._long_row` writes for
    it (its tables and gains for that split), x -> one output allocated
    here; with its launches a call."""
    _, B, H, W, _ = cn._check(x, g, axis)
    y = torch.empty_like(x)
    row, keep = cn._long_row(x, y, g, B, H, W, axis, plan)
    table = np.asarray(row, np.int64)
    kernels = 6 if plan.route == "chirp" else 3
    counts = {"variant": 0}

    def run(keep=(table, keep)):   # the tables live as long as the call
        _launch("variant", x.device, lib.ipp_notch_long, table.ctypes.data,
                counts=counts, kernels=kernels)
        return y
    return run, kernels


def kernel_split(fn, reps=10):
    """The device ms of each kernel one call of fn launches, in launch
    order (the long form's a, b, c, twice on the chirp route), from a
    torch.profiler trace of `reps` calls: the mean of each place; None
    where the trace holds no kernel of the long form."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if "notch_long_kernel" in e.name
                  and e.time_range.elapsed_us() > 0),
                 key=lambda e: e.time_range.start)
    if not evs or len(evs) % reps:
        return None
    k = len(evs) // reps
    return [sum(e.time_range.elapsed_us() for e in evs[j::k]) / reps / 1e3
            for j in range(k)]


def long_rows(gen, dev, lib, parent):
    """K8l at the long cases: error against the plain version, kernel /
    plain / library ms by CUDA events, kernel and library by CUDA-graph
    replay (the device's time alone), the bound, the launches, the ms of
    each kernel from a profiler trace; the parent tree's K8l in turns
    (this, parent, parent, this) where `parent` (its cuda_notch) is given;
    the rows forced three ways where they hold an odd factor past 13
    (`forced_plans`)."""
    out = []
    cases = [(s, a, sg) for s, a, sg in cs.NOTCH_LONG_CASES] + [
        (s, a, 2.0) for s, a in LONG_MORE]
    for shape, axis, sigma in cases:
        n = shape[axis]
        x = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)
                             ).to(dev)
        g = dsm.notch(n // 2 + 1, 0.5 * sigma)
        gt = torch.from_numpy(g).to(dev).reshape((-1, 1) if axis == -2
                                                 else (-1,))
        ref = cn.notch_filter_plain(x, g, axis)
        lfn = lambda: torch.fft.irfft(  # noqa: E731
            torch.fft.rfft(x, dim=axis) * gt, n=n, dim=axis)
        plain = cs.time_ms(torch, lambda: cn.notch_filter_plain(x, g, axis),
                           5)
        lib_ms = cs.time_ms(torch, lfn, 5)
        lib_graph = cs.graph_ms(torch, lfn, 10)
        bound_ms, by = cs.bound(*cs.work_notch(x.numel(), n))
        wrapper = lambda: cn.notch_filter(x, g, axis)  # noqa: E731
        variants = [("default", cn.notch_long_plan(n))] + list(
            forced_plans(n).items())
        for label, plan in variants:
            if label == "default":
                kfn = wrapper
                cn.reset_launch_counts()
                _, rel = cs.err_of_max(kfn(), ref)
                launches = cn.LAUNCHES["notch_long"]
            else:
                kfn, launches = long_fn(lib, x, g, axis, plan)
                _, rel = cs.err_of_max(kfn(), ref)
            ms = cs.time_ms(torch, kfn, 10)
            graph = cs.graph_ms(torch, kfn, 10)
            split = kernel_split(kfn)
            row = dict(shape=list(shape), axis=axis, n=n, variant=label,
                       plan=plan._asdict(), rel_err=rel, launches=launches,
                       ms=ms, graph_ms=graph, kernel_profile_ms=split,
                       plain_ms=plain, library_ms=lib_ms,
                       library_graph_ms=lib_graph, bound_ms=bound_ms,
                       bound_by=by)
            old = ""
            if parent is not None and label == "default":
                pfn = lambda: parent.notch_filter(x, g, axis)  # noqa: E731
                _, prel = cs.err_of_max(pfn(), ref)
                p1, p2 = (cs.time_ms(torch, pfn, 3) for _ in range(2))
                again = cs.time_ms(torch, kfn, 10)
                row.update(parent_rel_err=prel, parent_ms=(p1 + p2) / 2,
                           ms_again=again)
                old = (f"  parent {(p1 + p2) / 2:8.3f} (rel {prel:.1e}; "
                       f"this again {again:8.3f})")
            out.append(row)
            parts = ("not measured" if split is None else
                     " + ".join(f"{v:.3f}" for v in split))
            print(f"  K8l {str(shape):<18s} axis {axis:2d} n {n:7d} {label} "
                  f"split {plan.n1} x {plan.n2} rows {plan.rows} "
                  f"{plan.plan1}:{plan.plan2} rel {rel:.2e} launches "
                  f"{launches}  kernel {ms:8.3f} ms (graph {graph:8.3f}; "
                  f"profile {parts}){old}  plain {plain:7.3f}  library "
                  f"{lib_ms:7.3f} (graph {lib_graph:7.3f})  bound "
                  f"{bound_ms:7.4f} ({by})", flush=True)
            if not rel <= 1e-5:
                raise AssertionError(f"K8l {shape} axis {axis} {label}: "
                                     f"rel {rel:.2e}")
        del x, ref
    return out


def sweep_rows(gen, dev, lib):
    """SWEEP's pass lists: error against the plain version, graph-replay
    ms, beside the bound."""
    out = []
    for (shape, axis), plans in SWEEP.items():
        n = shape[axis]
        x = torch.from_numpy(gen.standard_normal(shape, dtype=np.float32)
                             ).to(dev)
        g = dsm.notch(n // 2 + 1, n / 8.0)
        ref = cn.notch_filter_plain(x, g, axis)
        bound_ms = cs.bound(*cs.work_notch(x.numel(), n))[0]
        for plan in plans:
            fn = plan_fn(lib, x, g, axis, plan)
            _, rel = cs.err_of_max(fn(), ref)
            ms = cs.graph_ms(torch, fn, 20)
            out.append(dict(shape=list(shape), axis=axis, plan=list(plan),
                            default=tuple(plan) == cn.notch_plan(n),
                            rel_err=rel, graph_ms=ms, bound_ms=bound_ms))
            print(f"  sweep {str(shape):<17s} axis {axis:2d} plan "
                  f"{str(plan):<14s} rel {rel:.1e} {ms:7.4f} ms "
                  f"({ms / bound_ms:4.2f}x bound)")
            if not rel <= 1e-5:
                raise AssertionError(f"plan {plan} at {shape} axis {axis}: "
                                     f"rel {rel:.2e}")
        del x, ref
    return out


def group_rows(gen, dev):
    """The grouped call of the 14 notches of each batch, by graph replay,
    beside the one-subband calls' and the bounds' sums."""
    out = []
    for H, W in cs.NOTCH_TILES:
        cases = cs.notch_level_cases(((H, W),))
        xs = [torch.from_numpy(gen.standard_normal(s, dtype=np.float32)
                               ).to(dev) for s, _, _ in cases]
        axes = [a for _, a, _ in cases]
        gs = [dsm.notch(s[a] // 2 + 1, 0.5 * sg) for s, a, sg in cases]
        group = cs.graph_ms(
            torch, lambda: cn.notch_filter_group(xs, gs, axes), 20)
        singles = sum(cs.graph_ms(torch, lambda x=x, g=g, a=a:
                                  cn.notch_filter(x, g, a), 20)
                      for x, g, a in zip(xs, gs, axes))
        bound_ms = sum(cs.bound(*cs.work_notch(x.numel(), x.shape[a]))[0]
                       for x, a in zip(xs, axes))
        out.append(dict(tile=[8, H, W], subbands=len(xs), graph_ms=group,
                        singles_graph_ms=singles, bound_ms=bound_ms))
        print(f"  K8 group of {len(xs)} (8, {H}, {W}): graph {group:7.4f} "
              f"ms; one-subband calls {singles:7.4f} ms; bound "
              f"{bound_ms:7.4f} ({group / bound_ms:5.2f}x)")
        del xs
    return out


def main() -> int:
    tag = arg("--tag")
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; parent tree: {PARENT}")
    lib = load_library()
    info = build_info()
    print(f"built in {info['seconds']:.1f} s")
    for line in cs.ptxas_summary(info["ptxas"]):
        if "notch" in line:
            print(" ", line)
    parent = parent_notch(PARENT) if PARENT is not None else None
    variants, sweep = {}, []
    if "--variants" in sys.argv:
        variants, log = build_variants()
        for line in cs.ptxas_summary(log):
            print("  variants:", line)
    gen = np.random.default_rng(19)
    rows, bad, variant_rows = [], [], []
    for shape, axis, sigma in cs.notch_level_cases():
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
        ref = pfn()
        _, rel = cs.err_of_max(kfn(), ref)
        ms, graph = cs.time_ms(torch, kfn, 20), cs.graph_ms(torch, kfn, 20)
        plain, lib_ms = cs.time_ms(torch, pfn, 20), cs.time_ms(torch, lfn, 20)
        bound_ms, by = cs.bound(*cs.work_notch(x.numel(), n))
        geo = cn.notch_geometry(shape[0], shape[1], shape[2], axis == -2)
        row = dict(shape=list(shape), axis=axis, n=n, rel_err=rel, ms=ms,
                   graph_ms=graph, plain_ms=plain, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=by,
                   plan=list(cn.notch_plan(n)), geometry=geo)
        old = ""
        if parent is not None:
            pf = lambda: parent.notch_filter(x, g, axis)  # noqa: E731
            _, prel = cs.err_of_max(pf(), ref)
            p1 = cs.graph_ms(torch, pf, 20)
            p2 = cs.graph_ms(torch, pf, 20)
            again = cs.graph_ms(torch, kfn, 20)
            same = torch.equal(kfn(), pf())
            row.update(parent_rel_err=prel, parent_graph_ms=(p1 + p2) / 2,
                       graph_ms_again=again, parent_bit_equal=same)
            old = (f"  parent {(p1 + p2) / 2:7.4f} (rel {prel:.1e}, "
                   f"{'bit-equal' if same else 'DIFFERS'}; this again "
                   f"{again:7.4f})")
            if not prel <= 1e-5:
                bad.append(f"parent K8 {shape} axis {axis}: {prel:.2e}")
            if not same:
                bad.append(f"K8 {shape} axis {axis}: not bit-equal to the "
                           f"parent's")
        rows.append(row)
        print(f"  K8 {str(shape):<17s} axis {axis:2d} n {n:5d} plan "
              f"{cn.notch_plan(n)} rel {rel:.2e}  kernel {ms:7.4f} ms (graph "
              f"{graph:7.4f}){old}  plain {plain:7.4f}  library "
              f"{lib_ms:7.4f}  bound {bound_ms:7.4f} ({by})  graph/bound "
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
    groups = group_rows(gen, dev)
    longs = long_rows(gen, dev, lib, parent) if "--long" in sys.argv else []
    chain = chain_rows(PARENT) if "--chain" in sys.argv else []
    if "--sweep" in sys.argv:
        sweep = sweep_rows(gen, dev, lib)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"notch_bench{'_' + tag if tag else ''}.json").write_text(
        json.dumps(dict(card=card, parent=str(PARENT), rows=rows,
                        groups=groups, variants=variant_rows, sweep=sweep,
                        long=longs, chain=chain,
                        ptxas=[s for s in cs.ptxas_summary(info["ptxas"])
                               if "notch" in s]), indent=1))
    print(f"card: {cs.card_line()}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
