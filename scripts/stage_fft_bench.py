#!/usr/bin/env python3
"""Time the radix-2 stage kernels of ipp_tpu_torch on one CUDA card.

    python3 scripts/stage_fft_bench.py [--quick]

For every stage form at the shapes the deconvolution paths run it (the
CLI block (256, 1056, 256), four such blocks, a 512^3 block, and the v1
walk's (256, 1152, 1152) and (256, 1024, 264)): the FFT kernel
(csrc/stage_fft.cuh) against its plain version (<= 1e-5 of max), then the
FFT kernel, the dense stage kernel it replaced (csrc/fft_walk.cu, called
directly on the same inputs), one torch.fft call and the bytes bound, in
ms by CUDA events.  Prints ptxas' registers and spills first, the card's
name and power limit last.  `--quick` checks and times the CLI block's
forms only.
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


def dense_stage(lib, re, im, mats, forward, axis):
    """The dense stage kernel on the same operands (no route choice)."""
    rr, ii = torch.empty_like(re), torch.empty_like(re)
    if axis == 1:
        batch, n, ncols = re.shape
        bs, ldk, ldc = n * ncols, ncols, 1
    else:
        (ncols, n), batch = re.shape, 1
        bs, ldk, ldc = 0, 1, n
    st = torch.cuda.current_stream().cuda_stream
    err = lib.ipp_radix2_stage(re.data_ptr(), im.data_ptr(),
                               mats[0].data_ptr(), mats[1].data_ptr(),
                               rr.data_ptr(), ii.data_ptr(), int(forward),
                               batch, n, ncols, bs, ldk, ldc, st)
    assert err == 0, err
    return rr, ii


def dense_otf(lib, re, im, o_r, o_i, mats, conj):
    rr, ii = torch.empty_like(re), torch.empty_like(re)
    st = torch.cuda.current_stream().cuda_stream
    err = lib.ipp_radix2_stage_inv_otf(
        re.data_ptr(), im.data_ptr(), o_r.data_ptr(), o_i.data_ptr(),
        mats[0].data_ptr(), mats[1].data_ptr(), rr.data_ptr(), ii.data_ptr(),
        int(conj), re.shape[0], o_r.shape[0], re.shape[1], st)
    assert err == 0, err
    return rr, ii


def main() -> int:
    quick = "--quick" in sys.argv
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    lib = load_library()
    info = build_info()
    print(f"built in {info['seconds']:.1f} s")
    for line in cs.ptxas_summary(info["ptxas"]):
        if "stage_fft" in line:
            print(" ", line)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def d(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5

    # (label, axis, operand shape, OTF rows or None)
    cases = [("CLI z", 1, (536, 256, 256), None),
             ("CLI x", -1, (137216, 256), None),
             ("CLI K4", -1, (137216, 256), 137216)]
    if not quick:
        cases += [("4 blocks K4b", -1, (548864, 256), 137216),
                  ("512^3 z", 1, (264, 512, 512), None),
                  ("512^3 x", -1, (135168, 512), None),
                  ("512^3 K4", -1, (135168, 512), 135168),
                  ("v1 z (256,1152,1152)", -1, (672768, 256), None),
                  ("v1 y (256,1024,264)", -1, (34816, 1024), None),
                  ("v1 y K4 (256,1024,264)", -1, (34816, 1024), 34816),
                  ("768 z", 1, (136, 768, 768), None),
                  ("768 x", -1, (104448, 768), None),
                  ("2048 z", 1, (32, 2048, 1024), None),
                  ("2048 x", -1, (32768, 2048), None)]
    bad = []
    for label, axis, shape, orows in cases:
        n = shape[1] if axis == 1 else shape[-1]
        re, im = d(*shape), d(*shape)
        c = torch.complex(re, im)
        elems = re.numel()
        mats = {f: tuple(torch.tensor(m, device=dev)
                         for m in stage_mats_t(n, f)) for f in (True, False)}
        forms = []
        if orows is None:
            for fwd in (True, False):
                lib_fn = torch.fft.fft if fwd else torch.fft.ifft
                forms.append((
                    "fwd" if fwd else "inv",
                    lambda fwd=fwd: cf.radix2_stage(re, im, *mats[fwd], fwd,
                                                    axis),
                    lambda fwd=fwd: cf.radix2_stage_plain(re, im, *mats[fwd],
                                                          fwd, axis),
                    lambda fwd=fwd: dense_stage(lib, re, im, mats[fwd], fwd,
                                                axis),
                    lambda lib_fn=lib_fn: lib_fn(c, dim=1 if axis == 1
                                                 else -1),
                    cs.work_stage(elems, n)))
        else:
            o_r, o_i = d(orows, n), d(orows, n)
            batched = orows != shape[0]
            k4 = (cf.radix2_stage_inv_otf_batched if batched
                  else cf.radix2_stage_inv_otf)
            for conj in (False, True):
                forms.append((
                    "conj" if conj else "otf",
                    lambda conj=conj: k4(re, im, o_r, o_i, *mats[False],
                                         conj),
                    lambda conj=conj: cf.radix2_stage_inv_otf_plain(
                        re, im, o_r, o_i, *mats[False], conj),
                    lambda conj=conj: dense_otf(lib, re, im, o_r, o_i,
                                                mats[False], conj),
                    lambda: torch.fft.ifft(c, dim=-1),
                    cs.work_stage(elems, n, orows * n)))
        for form, kfn, pfn, dfn, lfn, work in forms:
            got, ref = kfn(), pfn()
            rel = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in zip(got, ref))
            del got, ref
            ms = cs.time_ms(torch, kfn, 10)
            dense_ms = cs.time_ms(torch, dfn, 3)
            lib_ms = cs.time_ms(torch, lfn, 10)
            ms2 = cs.time_ms(torch, kfn, 10)
            b_ms, by = cs.bound(*work)
            print(f"{label:<26s} {form:<5s} n={n:<5d} rel {rel:.2e}  fft "
                  f"kernel {ms:8.3f} / {ms2:8.3f} ms  dense kernel "
                  f"{dense_ms:8.3f}  library {lib_ms:8.3f}  bound "
                  f"{b_ms:7.3f} ({by})  kernel/bound {ms / b_ms:5.2f}",
                  flush=True)
            if not rel <= 1e-5:
                bad.append(f"{label} {form}: rel {rel:.3e}")
        del re, im, c, mats
        torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}")
    if bad:
        print("FAIL: " + "; ".join(bad))
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
