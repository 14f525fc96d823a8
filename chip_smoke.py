#!/usr/bin/env python3
"""Chip smoke test of ipp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases:
1. build the CUDA kernels from ipp_tpu_torch/csrc with nvcc; registers
   and spills of every kernel from ptxas;
2. each kernel against its plain PyTorch version on the card, at the work
   shapes (256,256,256), (512,512,512), one with 768 axes, and the CLI's
   block shape; max |kernel - plain| / max |plain| must be <= 1e-5 (both
   f32); kernel and plain times by CUDA events after a warm call; K1 and
   K2 run their real-FFT kernels (`fold=True`) and, once per shape, their
   dense GEMM kernels (no keyword), each counted under its own name; then
   K1 and K2 (plain, ratio, mul) at the lengths ny = 8, 24, 40, 136, 536,
   1120, 1152, 2008, 2048 that cover every radix of the plan, with a
   single bright column, with junk in the rows and imaginary parts the
   Hermitian fold ignores, and K1's padded rows held to exactly 0; then
   K1d and K2d, the dense GEMMs on the tensor cores (3xTF32 wgmma), in
   every form (plain, ratio, mul) at the CLI block, a batch of four of
   it, an odd nx (255), ny = 1100 and ny = 2560 with the fold stated, and
   a random matrix: <= 1e-5, one `_dense` launch a call, kernel, plain and
   torch.matmul times and the bound (three bf16 products at 989 TFLOP/s),
   the fold's zero rows exactly 0, a batch of three equal to its single
   calls bit for bit; then every form of the radix-2 stage (forward and
   inverse in both layouts, K4 with the OTF and its conjugate, K4b with
   an OTF period, K6) at a small row count: on the stage FFT kernels at
   each of their eight lengths 256 * j, on the mixed-radix FFT kernel
   (csrc/stage_mixed.cuh) at n = 384, 2176, 2304, 2560 and 12288, on the
   large-axis FFT kernel (csrc/stage_large.cuh) at n = 12416, 12544,
   24576 and 24832 (one launch each on its C entry point, none of a
   dense kernel), and on the dense stage kernels at n = 12416 through
   their own entry (`cuda_fft.stage_dense`); <= 1e-5, each counted under
   its own name; K7's DFT at n = 16384 and 24832 (the large-axis kernel
   in natural order) against `cplx_matmul_plain`, both directions (the
   plain versions' matrices built on the card from the host's float64
   expressions, held to the host's at n = 384 and 2304); and the mixed
   kernel's forms
   (forward z, K6, K4) timed at n = 384, 2176, 2560 and 12288, with the
   RL block's forward x stage at (34816, 2304), the large kernel's at
   (512, 12416), (4096, 12544) (the (256, 16, 12544) RL block's x
   stages), (4, 12544, 256) and (256, 24832) / (2, 24832, 256), each
   beside the dense kernel it replaced there, and K6's dense kernel at
   (512, 12416) held to its plain version, beside torch.fft and their
   bound (device times: calls replayed from a CUDA graph);
3. richardson_lucy on one (512,512,512) block (16-voxel halo, 9^3
   gaussian PSF, 10 iterations): the kernel walk against the torch.fft
   route, inner region within rtol=2e-3, atol=2e-1, and exact launch
   counts (K1 = 2n+1, K2 = 2n, K3 = 6n+2, K4 = 2n; the edge taper's six
   slab blurs lie outside the v2 domain and take torch.fft); then the
   same on a (256, 256, 2304) work shape, whose x stages run the mixed-
   radix stage kernel: within 1e-3 of max on the core, the same launch
   formula (with the taper's y-face blurs, which lie in the v2 domain),
   no dense launch, the mixed kernel's launches on its entry point; and
   MatmulFFT3.convolve at (2304, 64, 256) (the middle-axis form at n =
   2304) against torch.fft within rtol=2e-3, atol=2e-1; and the same on a
   (256, 16, 12544) work shape, whose x stages run the large-axis kernel's
   one-pass form (the core: all of y), and a convolve at (12544, 8, 256)
   (its two-pass form on the middle axis; the PSF cut to 7 along y), with
   the device bytes of the
   walk's plan (no stage matrices on the card);
4. the deconvolution CLI end to end on a synthetic 512 x 1024 x 1024 u16
   TIFF series (PSF-blurred, Poisson-noised beads from a numpy seed,
   written by a minimal baseline TIFF writer here and read back through
   the port's TiffDirVolume): every block in the kernel domain and routed
   through the kernels (the taper slabs through torch.fft), 512 u16
   output planes, beads sharper than in the input, manifest complete;
5. the DWT kernel K5 against its plain version (strided conv1d) on the
   card: db9 on both axes at the destripe CLI's padded tile batches
   (8, 2688, 2688) and (8, 2304, 2688), the filter lengths 2, 6, 68, 90 and
   102 (haar, db3, db34, coif15, coif17) at (8, 2688, 2688), a row shorter
   than the filter (n = 16, db9), one 2D level as the destripe path runs
   it, and every level shape of that path (rows of 2688 ... 42, db9); max
   |K5 - plain| / max |plain| <= 1e-5 (f32); kernel, plain and F.conv1d
   times by CUDA events after a warm call; and a batch of 8 bit-equal to
   its 8 single calls on both axes;
6. the pystripe CLI end to end with process_images' stage-1 settings
   (sigma 250/250, db9, reflect, bidirectional, dark 100, batch 8) on a
   synthetic tile tree (2 x 2 stacks x 64 planes of 2000 x 2000 and one
   stack x 16 planes of 1600 x 2000 u16: a smooth field with beads and
   multiplicative stripes along x and y, from a numpy seed): rc 0 (no
   failed tile), 272 u16 outputs of the input shapes, stripe power down
   more than 3x, K5 launched batches x 3 x levels times, and 8 sampled
   tiles within 1 count of the same chain with the plain DWT on the card;
   then one batch of 8 tiles through process_batch_fn with bleach
   correction on (the first-order Butterworth filtfilt as a scan), and one
   with lightsheet correction on (dark 100 first), each card's result
   within 1 count of the CPU's, its device ms printed;
7. the batched walk: each batched kernel form (K1 and K2 on a batch, K4
   with one OTF wrapped over the batch) against its plain version at
   (4, 256, 1056, 256) (the CLI's block shape, four blocks: the group one
   mesh step forms on four devices) and (1, 512, 512, 512) (one block, as
   the sharded RL runs per device), max |kernel - plain| / max |plain|
   <= 1e-5, kernel and plain times by CUDA events after a warm call; then
   richardson_lucy_batched on four such blocks (9^3 gaussian PSF, 10
   iterations): exact launch counts of the batched forms, each block
   within 1e-5 of max of its single-block richardson_lucy (edge taper off
   on both: the batched taper blurs whole blocks), the torch.fft
   route within rtol=2e-3, atol=2e-1 on the inner region, and an
   early-stop run whose per-block iteration counts equal the single-block
   runs; and richardson_lucy_spatial on a 64^3 block, card vs CPU within
   1e-4 of max;
8. the deconvolution CLI with --adaptive-psf (blind-Wiener RL through
   torch.fft) on the phase-4 series: 512 planes, manifest complete, beads
   sharper than in the input;
9. the FNT-cube CLI on 8 u16 cubes of 128^3 cut from the phase-4 series
   (written by a minimal raw NRRD writer here), with --destripe (the
   axial destripe through K5) and 10 RL iterations: 8 outputs of the
   input shape and dtype, K5 launched, and exact walk launch counts (the
   cubes' work shape lies outside the v2 domain: RL and the taper take
   torch.fft, no walk launch);
10. the v1 walk (work shapes outside the v2 domain): K6 (the inverse
   radix-2 stage over the last axis) and K7 (the dense-axis DFT as a
   mixed-radix FFT kernel) against their plain versions at every stage the
   paths run them: the taper slabs of the phase-4 block, of a 512^3 block
   and of the (248, 1100, 1100) block, (136, 136, 136) and (256, 1152,
   1152) (K7's nine lengths 40 ... 1152, forward and inverse), plus K6 at
   (256, 1024, 264), and K7d, K7's dense kernel (any matrix, any length;
   csrc/cplx_dense.cu, 3xTF32 on wgmma), at (9792, 136) x (136, 136),
   (149504, 1152) x (1152, 1152), (136648, 1100) x (1100, 1100) (a length
   without an FFT plan, `dft=True`), a random (65536, 200) x (200, 72) and
   phase 11's y and z products, (2160, 50) x (50, 50) and (3600, 30) x
   (30, 30) (`dft=True`; rows of 200 and 120 bytes: 4-byte data copies),
   beside complex torch.matmul and its bound (three bf16 products a real
   product at 989 TFLOP/s); max |kernel - plain| / max |plain| <= 1e-5; the v1
   convolve (and the fused RL update) against torch.fft at (256, 1024,
   264) and (256, 1152, 1152), <= 1e-4 of max, exact launch counts; and
   richardson_lucy on a (248, 1100, 1100) block (9^3 gaussian PSF, 10
   iterations, work shape (256, 1152, 1152)) on the walk1 route (forced:
   the default there is torch.fft) against the torch.fft route at the
   same work shape, within 1e-3 of max on the core, exact launch counts
   with no dense K7 launch, and the block's time split by CUDA events into
   the x matmuls, the layout copies, the OTF product, the RL arithmetic,
   the taper and the kernels; then RL on a 128^3 cube (the FNT CLI's),
   walk1 beside torch.fft;
11. the canonical transforms MatmulFFT3.rfftn / irfftn / otf (natural
   order, any shape) against torch.fft at (40, 136, 264), whose y and z
   axes take K7's FFT kernel, and at (30, 50, 70), whose axes are no
   multiples of 8 and take K7's dense kernel: <= 1e-5 of the spectrum's
   max, exact launch counts of each kernel;
12. the stitch chain: align_pairs_batched on 12 pairs whose xy MIPs are
   (150, 1024), search radius 20, card vs CPU equal and equal to the
   known shifts, pairs/s; then process_images on a synthetic 3 x 3 grid of
   32-plane stacks of 2000 x 2000 u16 tiles (288 tiles, 2.3 GB; --objective
   15x, nominal overlap 200 px; beads with z extent on a smooth field and
   multiplicative stripes along x, from a seeded generator on the card;
   known integer jitter |dy|, |dx| <= 8, dz in {-1, 0, 1}) with the
   stage-1 settings of phase 6 and --downsampled-voxel 10: rc 0, every
   stack's offset in the placement XML equal to its truth, the series of
   the bounding box's plane count and shape in u16, every isolated bead's
   intensity-weighted centroid within 0.5 px of its true position, the
   npz at its planned shape, K5 launched batches x 3 x levels times;
   stitch Mpix/s, the per-stage seconds and the peak device memory;
13. process_images --rgb-composite on two channels (Ex_647_Em_690, red,
   the merge's reference; Ex_561_Em_600, green, its content shifted by
   (1, -4, 6)) of a 2 x 2 grid of 16-plane stacks of 2000 x 2000 u16 tiles
   cut at phase 12's kind of jitter from one bead phantom: rc 0, exact K5
   launches, the channel offsets equal to the shift, the composite of the
   reference channel's plane count and every plane equal to its host
   recomputation from the two stitched series and the offsets, and ECC on
   the sections merge_channels aligned, card vs CPU (within 0.02 px, the
   same integer offsets, ms of each);
14. the converter CLI (convert.main) with --destripe (sigma 250, db9),
   -dt 10 at (2, 1.8, 1.8) um and a TeraFly export on 64 striped 2000 x
   2000 u16 planes: rc 0, exact K5 launches, four planes within 1 count
   of the same chain on the CPU, the npz within 1e-4 of max of its CPU
   recomputation from the written planes, TeraFly's level 0 equal to the
   series; Mpix/s with the read / device / write / downsample / export
   split;
15. scan_stitch on a Dragonfly tree (2 x 2 columns x 2 piezo substacks of
   16 planes of 2048 x 2048 u16, 200 px overlap, known jitter |dx|, |dy|
   <= 8, |dz| <= 1): positions equal to the truth, its links equal to the
   alignment's on the CPU; then tsv_tools downsample on phase 14's series,
   every plane equal to the host block sum;
16. the mesh: every card when there are several, else two entries on card
   0 (two shards, two dispatch threads); `parallel.mesh.default_mesh` is
   pointed at it, so the CLIs take the branch of a host with that many
   cards (phases 1-15 point it at none: one card's runs on any host).
   (a) the deconvolution CLI on phase 4's series: planes within 1 count
   of phase 4's, K1-K4 launches equal to phase 4's, the manifest's mesh
   set; (b) richardson_lucy_sharded_z on a (480, 248, 248) cut of the
   series over a 2-entry z mesh (slabs at a (256, 256, 256) work shape on
   the v2 walk): within 1e-5 of max of the same overlap-discard slabs run
   one by one on card 0, the batched forms' launches equal to that run's;
   (c) process_images on phase 12's tree: placement equal to phase 12's,
   planes within 1 count, K5 launches exact (phase 12's batches, each split
   into one shard per mesh entry); (d) the pystripe CLI on phase 6's tree:
   tiles within 1 count, K5 exact likewise; (e) a one-rank NCCL group over
   localhost TCP (device_put_global, process_slice, all_gather), and with
   two or more cards two processes over NCCL (the NCC maps' all-gather and
   z-sharded RL with halos across processes) equal to one process.
   Each step prints its wall seconds beside the card's name and power;
   (a) and (c) run again in turns (one card, then the mesh) on the same
   inputs, (b) once more warm.

Every kernel case records its time, its plain version's, one PyTorch
library call's that computes the same function (torch.matmul, torch.fft,
F.conv1d; timed here only, the port never calls it) and its bound: the
larger of the function's FLOPs over the f32 peak (a matrix product's for
an FFT's 5 n log2 n per complex transform for K3, K4, K6 and K7 and half
that per real column for K1 and K2, the taps' for K5; for K1d, K2d and
K7d, f32-grade products on the tensor cores, three bf16 products a real
product over the bf16 peak) and its bytes (each input read once, each
output written once) over the HBM rate.  Outside the v2 domain every convolution takes
torch.fft unless a caller forces "walk1" (phase 10 does), so only phase 10
and phase 11 launch K6 and K7.

Phases 8 and 9 read phase 4's series, phase 15 phase 14's, phase 16
phase 4's, 6's and 12's inputs and outputs.  The script
exits non-zero when there is no CUDA device, when the port is not beside
it, or when any phase fails.  On success its last two lines are the kernels' JSON record
and {"ok": true, "device": {...}}.
Details go to chiprun_out/chip_smoke.json; scratch data to
build/chip_smoke/ (removed at the end).
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import struct
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "rdft_y_fwd": ("K1", "ipp_tpu/ops/pallas_fft.py:579"),
    "rdft_y_inv": ("K2", "ipp_tpu/ops/pallas_fft.py:604"),
    "radix2_stage": ("K3", "ipp_tpu/ops/pallas_fft.py:437"),
    "radix2_stage_inv_otf": ("K4", "ipp_tpu/ops/pallas_fft.py:208"),
}
# the dense GEMM kernels of K1 and K2: any matrix, and shapes off the
# real-FFT route; on no main path (their counters stay 0 there)
RDFT_DENSE = {
    "rdft_y_fwd_dense": (
        "K1d", "ipp_tpu/ops/pallas_fft.py:579 (the y real DFT as a product "
        "with an arbitrary (2kp, ny) matrix)"),
    "rdft_y_inv_dense": (
        "K2d", "ipp_tpu/ops/pallas_fft.py:604 (the inverse as a product "
        "with an arbitrary (ny, 2kp) matrix)"),
}
BATCHED = {
    "rdft_y_fwd_batched": (
        "K1b", "ipp_tpu/ops/pallas_fft.py:498 (_v2_rfft_call); "
        "ipp_tpu/ops/pallas_fft.py:772 (_v2_rfft_ratio_call)"),
    "rdft_y_inv_batched": (
        "K2b", "ipp_tpu/ops/pallas_fft.py:524 (_v2_irfft_call); "
        "ipp_tpu/ops/pallas_fft.py:811 (_v2_irfft_mul_call)"),
    "radix2_stage_inv_otf_batched": (
        "K4b", "ipp_tpu/ops/pallas_fft.py:301 (_fused_stage_otf_call, one "
        "OTF wrapped over the batch)"),
}
V1 = {
    "radix2_stage_inv_last": (
        "K6", "ipp_tpu/ops/pallas_fft.py:252 (_fused_stage_call, "
        "forward=False: kernel _stage_inv_kernel :191)"),
    "cplx_matmul": (
        "K7", "ipp_tpu/ops/pallas_fft.py:66 (_fused_call via "
        "fused_cplx_matmul: inline kernel :54; the dense DFT of an axis)"),
}
# K7's dense kernel: any matrix, and the lengths without an FFT plan
K7_DENSE = ("cplx_matmul_dense", "K7d", "ipp_tpu/ops/pallas_fft.py:66 "
            "(_fused_call via fused_cplx_matmul: an arbitrary matrix)")
# its cases, (rows, K, N, matrix, timer): the y stage of a 136^3 work shape
# and of the (256, 1152, 1152) one with their DFT matrices taken as any
# matrix (`dft=None`; both lengths run K7's FFT kernel on the walks), the
# canonical transform's y axis of a (248, 1100, 1100) volume (1100 has no
# FFT plan: `dft=True` takes K7d), a random non-square matrix, and the y
# and z products of phase 11's forward transform of two (30, 50, 70)
# volumes (K not a multiple of 4: the kernel's 4-byte data copies); calls
# near 0.1 ms are timed by CUDA-graph replay
K7_DENSE_CASES = [(9792, 136, 136, "dft=None", "graph"),
                  (149504, 1152, 1152, "dft=None", "events"),
                  (136648, 1100, 1100, "dft=True", "events"),
                  (65536, 200, 72, "random", "graph"),
                  (2160, 50, 50, "dft=True", "graph"),
                  (3600, 30, 30, "dft=True", "graph")]
K7_DENSE_SOURCE = "ipp_tpu_torch/csrc/cplx_dense.cu"
SOURCE = "ipp_tpu_torch/csrc/fft_walk.cu"
# K1d and K2d: 3xTF32 GEMMs on the tensor cores
RDFT_DENSE_SOURCE = "ipp_tpu_torch/csrc/rdft_dense.cu"
DFT_SOURCE = "ipp_tpu_torch/csrc/dft_fft.cuh"
# K1, K2 and their batched forms run their real-FFT kernels on every path
RDFT_SOURCE = "ipp_tpu_torch/csrc/rdft_y.cuh"
RDFT_KERNELS = {"rdft_y_fwd", "rdft_y_inv", "rdft_y_fwd_batched",
                "rdft_y_inv_batched"}
# the radix-2 stages run their FFT kernels at every main-path shape
STAGE_SOURCE = "ipp_tpu_torch/csrc/stage_fft.cuh"
STAGE_KERNELS = {"radix2_stage", "radix2_stage_inv_otf",
                 "radix2_stage_inv_otf_batched", "radix2_stage_inv_last"}
# the same stage forms at every other multiple of 128 up to 12288 (counted
# under the names above; `ENTRY_LAUNCHES["ipp_stage_mixed"]` apart), and
# the dense stage kernels above it (the names above with `_dense`)
STAGE_PALLAS = ("ipp_tpu/ops/pallas_fft.py:550 (_v2_stage_call), :252 "
                "(_fused_stage_call), :301 (_fused_stage_otf_call)")
STAGE_MIXED = ("K3m", "stage_mixed", "ipp_tpu_torch/csrc/stage_mixed.cuh",
               STAGE_PALLAS + " at lengths off 256 * j <= 2048 up to 12288")
STAGE_LARGE = ("K3l", "stage_large", "ipp_tpu_torch/csrc/stage_large.cuh",
               STAGE_PALLAS + " above 12288; ipp_tpu/ops/pallas_fft.py:66 "
               "(_fused_call, the dense DFT of an axis) above 12288")
STAGE_DENSE = ("K3d", "radix2_stage_dense", SOURCE,
               STAGE_PALLAS + " at lengths without an FFT plan")
# the C entry points of the stage kernels whose launches count under the
# wrappers' names, by `stage_route`
STAGE_ENTRIES = {"mixed": "ipp_stage_mixed", "large": "ipp_stage_large"}
DWT_KERNEL = ("K5 dwt_analysis", "ipp_tpu_torch/csrc/dwt.cuh",
              "ipp_tpu/ops/pallas_dwt.py:80 (dwt_analysis_pallas, axis -1); "
              "scripts/dwt_ykernel_exp.py:87 (dwt_y_pallas, axis -2)")
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): f32 FMA outside the
# tensor cores, dense bf16 on the tensor cores, and HBM3
F32_FLOPS, BF16_FLOPS, HBM_BYTES_S = 67e12, 989e12, 3.35e12
NITER = 10
VOL_SHAPE = (512, 1024, 1024)  # the phase-4 series, z planes x y x x
N_BEADS = 4000
# the phase-6 tile tree: (stacks, planes, tile shape)
TILE_STACKS = [(4, 64, (2000, 2000)), (1, 16, (1600, 2000))]
STAGE1 = ["--sigma1", "250", "--sigma2", "250", "--wavelet", "db9",
          "--padding-mode", "reflect", "--bidirectional", "--dark", "100",
          "--batch-size", "8"]


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def time_ms(torch, fn, reps: int = 5) -> float:
    """Mean ms per call over `reps` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, reps: int = 5) -> float:
    """Mean ms per call of `reps` calls captured in one CUDA graph and
    replayed: the device's time alone.  Timed call by call (`time_ms`), a
    kernel of ~0.1 ms can wait on the host, whose wrapper takes tens of
    microseconds a call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS):
    """(bound ms, "operations" or "bytes"): the least time the card could
    take for this work, the larger of FLOPs over the peak of their type
    (f32 unless the work says otherwise) and bytes over the HBM rate."""
    t_op, t_mem = flops / peak, nbytes / HBM_BYTES_S
    return max(t_op, t_mem) * 1e3, ("operations" if t_op >= t_mem
                                    else "bytes")


# The work of one call of each kernel form, (FLOPs, bytes[, peak]), counted
# for the function it computes: a product against an arbitrary matrix where
# the wrapper takes one (the dense kernels K1d, K2d and K7d, as the three
# bf16 products a real product of an f32-grade product on the tensor
# cores), an FFT's 5 n log2 n FLOPs per complex transform of length n
# where the function is a DFT along an axis (K3, K4, K6, K7, and at half
# that per real column K1 and K2, as torch.fft computes it); each input read
# once, each output written once.

def work_rdft(vox: int, ny: int, kp: int, extra_streams: int):
    """K1 / K2 on vox = nz*ny*nx voxels, the function: a real DFT of
    length ny per column at 2.5 ny log2 ny FLOPs, the volume and the two
    (kp, nz, nx) planes moved once; `extra_streams` more volumes read (the
    ratio's den, the update's mul).  No matrix is counted."""
    cols = vox // ny
    return (2.5 * vox * math.log2(ny),
            4.0 * (vox * (1 + extra_streams) + 2 * kp * cols))


def work_rdft_dense(vox: int, ny: int, kp: int, extra_streams: int):
    """The dense kernels of K1 / K2: a (2kp x ny) product per column with
    a matrix the kernel must read, f32-grade on the tensor cores: three
    products (hi.hi, lo.hi, hi.lo) at the bf16 peak.  The kernels split
    into TF32, at half that rate; the least time is bf16's, the
    reference's split, which is f32-grade here too (within 1e-5 of max:
    tests/test_torch_tf32_split.py)."""
    cols = vox // ny
    return (3 * 2.0 * 2 * kp * ny * cols,
            4.0 * (vox * (1 + extra_streams) + 2 * kp * cols + 2 * kp * ny),
            BF16_FLOPS)


def work_stage(rows_x_n: int, n: int, otf_elems: int = 0):
    """K3 / K4 / K6 / K7 over rows_x_n complex values along an axis of length
    n: a length-n DFT of each row at the FFT's count, the spectrum read
    once and written once, and with an OTF its product and its two f32
    streams.  The same work whatever implements it: no stage matrix or
    twiddle table is counted."""
    return (5.0 * rows_x_n * math.log2(n) + 6.0 * otf_elems,
            4.0 * (4 * rows_x_n + 2 * otf_elems))


def work_cplx(rows: int, k: int, n: int):
    """K7's dense kernel: a (rows x k) @ (k x n) complex product against
    matrices the kernel must read, f32-grade on the tensor cores:
    Karatsuba's three real products at three products each (hi.hi, lo.hi,
    hi.lo) at the bf16 peak.  The kernel splits into TF32, at half that
    rate; bf16's split is f32-grade at every case here too (within 1e-5 of
    max: scripts/cplx_dense_bench.py --precision)."""
    return (9 * 2.0 * rows * k * n,
            4.0 * (2 * rows * k + 3 * k * n + 2 * rows * n), BF16_FLOPS)


def work_dwt(elems: int, taps: int):
    """K5: one level of two taps-long filters at stride 2 over elems."""
    return 2.0 * elems * taps, 4.0 * (2 * elems + 2 * taps)


def walk_launches(shape, forward: int, inverse: int, route=None):
    """Kernel launches of `forward` transforms and `inverse` transforms
    (each with its OTF product) at a work shape, on the route that takes
    it (`ops.deconv.conv_route`): the v2 walk inside its domain; outside
    it torch.fft (no launch), or the v1 walk when `route` forces "walk1".
    `cplx_matmul` is K7's FFT kernel: the walks' dense axes are multiples
    of 8, so the callers, which compare every counter, hold
    `cplx_matmul_dense` to 0."""
    from ipp_tpu_torch.ops.matmul_fft import in_kernel_domain, stage_axes

    if in_kernel_domain(shape) and route != "fft":
        return {"rdft_y_fwd": forward, "radix2_stage": 2 * forward + inverse,
                "radix2_stage_inv_otf": inverse, "rdft_y_inv": inverse}
    if route != "walk1":
        return {}
    z, y = stage_axes(shape)
    dense = (not z) + (not y)
    return {"radix2_stage": forward * (z + y),
            "radix2_stage_inv_last": inverse * z,
            "radix2_stage_inv_otf": inverse * y,
            "cplx_matmul": (forward + inverse) * dense}


def taper_work_shapes(vol_shape, psf_shape, face_slabs: bool = True):
    """The FFT work shape of every blur ops.deconv.edge_taper_3d runs on a
    volume: one per face slab (each slab the taper width plus the PSF
    support deep), or one of the whole volume; each rounded as
    _fft_conv_same rounds it (edge padding, full convolution, multiples
    of 8)."""
    tws = [min(max(8, int(round(p / 2))), s // 2)
           for p, s in zip(psf_shape, vol_shape)]

    def work(shape):
        return tuple(-(-(s + 2 * (k // 2) + k - 1) // 8) * 8
                     for s, k in zip(shape, psf_shape))

    if not face_slabs or any(tw + k > s for tw, k, s in
                             zip(tws, psf_shape, vol_shape)):
        return [work(vol_shape)]
    out = []
    for d in range(3):
        slab = list(vol_shape)
        slab[d] = tws[d] + psf_shape[d]
        out += [work(slab)] * 2
    return out


def add_launches(want, *counts):
    for c in counts:
        for k, v in c.items():
            want[k] = want.get(k, 0) + v
    return want


def taper_launches(vol_shape, psf_shape, face_slabs: bool = True,
                   route=None):
    """Launches of one edge taper on the card: an OTF and a convolve per
    blur."""
    return add_launches({}, *(walk_launches(s, 2, 1, route) for s in
                              taper_work_shapes(vol_shape, psf_shape,
                                                face_slabs)))


def rl_launches(fft_shape, niter: int, route=None):
    """Launches of richardson_lucy's loop on the walk: the OTF, then two
    convolves per iteration."""
    return walk_launches(fft_shape, 1 + 2 * niter, 2 * niter, route)


# -- phase 2 -----------------------------------------------------------------

def rdft_cases(torch, cf, x, den, mul, sr, si, fwd, inv):
    """(kernel, variant, kernel_fn, plain_fn, library_fn, work) of K1 and K2
    on the real-FFT route (`fold=True`), each with and without its fused
    stream: the unbatched wrappers on a (nz, ny, nx) volume and its (kp, nz,
    nx) spectrum, the batched ones with a leading batch.  The library call
    of K2 takes the half spectrum as torch.fft lays it out, (..., nz, kx,
    nx), and gives K2's (..., nz, ny, nx)."""
    batched = x.dim() == 4
    k1, k2 = ((cf.rdft_y_fwd_batched, cf.rdft_y_inv_batched) if batched
              else (cf.rdft_y_fwd, cf.rdft_y_inv))
    n1, n2 = (("rdft_y_fwd_batched", "rdft_y_inv_batched") if batched
              else ("rdft_y_fwd", "rdft_y_inv"))
    ny, kp, vox = x.shape[-2], sr.shape[-3], x.numel()
    kx = ny // 2 + 1
    half = torch.complex(sr[..., :kx, :, :], si[..., :kx, :, :]).transpose(
        -3, -2).contiguous()
    return [
        (n1, "plain", lambda: k1(x, fwd, fold=True),
         lambda: cf.rdft_y_fwd_plain(x, fwd),
         lambda: torch.fft.rfft(x, dim=-2), work_rdft(vox, ny, kp, 0)),
        (n1, "ratio", lambda: k1(x, fwd, den, fold=True),
         lambda: cf.rdft_y_fwd_plain(x, fwd, den),
         lambda: torch.fft.rfft(x, dim=-2), work_rdft(vox, ny, kp, 1)),
        (n2, "plain", lambda: k2(sr, si, inv, fold=True),
         lambda: cf.rdft_y_inv_plain(sr, si, inv),
         lambda: torch.fft.irfft(half, n=ny, dim=-2),
         work_rdft(vox, ny, kp, 0)),
        (n2, "mul", lambda: k2(sr, si, inv, mul, fold=True),
         lambda: cf.rdft_y_inv_plain(sr, si, inv, mul),
         lambda: torch.fft.irfft(half, n=ny, dim=-2),
         work_rdft(vox, ny, kp, 1)),
    ]


def kernel_cases(torch, plan, rng, dev):
    """(kernel, variant, kernel_fn, plain_fn, library_fn, work) for every
    variant on the walk, at this plan's work shape; library_fn is one
    PyTorch call of the same function (the kernel's fused prologue or
    epilogue aside)."""
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf

    nz, ny, nx = plan.shape
    kp = plan.kp
    vox = nz * ny * nx

    def t(*shape, lo=0.0, hi=1.0):
        a = rng.random(shape, dtype=np.float32) * (hi - lo) + lo
        return torch.from_numpy(a).to(dev)

    x, den, mul = t(nz, ny, nx), t(nz, ny, nx, lo=0.5), t(nz, ny, nx)
    sr, si = t(kp, nz, nx, lo=-1), t(kp, nz, nx, lo=-1)
    or_, oi = t(kp * nz, nx, lo=-1), t(kp * nz, nx, lo=-1)
    # the kernels take the plan's (no) stage matrices, the plain versions
    # their own
    kz, kx = plan._z, plan._x
    fz, iz = (stage_mats(torch, nz, f, dev) for f in (True, False))
    fx, ix = (stage_mats(torch, nx, f, dev) for f in (True, False))
    r2, i2 = sr.view(-1, nx), si.view(-1, nx)
    both = torch.cat([sr, si], 0).transpose(0, 1).contiguous()  # (nz, 2kp, nx)
    c = torch.complex(sr, si)
    c2 = c.view(-1, nx)
    spec = kp * nz * nx
    fwd, inv = plan._rfwd, plan._rinv
    return rdft_cases(torch, cf, x, den, mul, sr, si, fwd, inv) + [
        # the dense GEMM kernels: the route without the keyword
        ("rdft_y_fwd_dense", "plain", lambda: cf.rdft_y_fwd(x, fwd),
         lambda: cf.rdft_y_fwd_plain(x, fwd),
         lambda: torch.matmul(fwd, x), work_rdft_dense(vox, ny, kp, 0)),
        ("rdft_y_inv_dense", "plain", lambda: cf.rdft_y_inv(sr, si, inv),
         lambda: cf.rdft_y_inv_plain(sr, si, inv),
         lambda: torch.matmul(inv, both), work_rdft_dense(vox, ny, kp, 0)),
        ("radix2_stage", "fwd_z",
         lambda: cf.radix2_stage(sr, si, *kz[True], True, 1),
         lambda: cf.radix2_stage_plain(sr, si, *fz, True, 1),
         lambda: torch.fft.fft(c, dim=1), work_stage(spec, nz)),
        ("radix2_stage", "fwd_x",
         lambda: cf.radix2_stage(r2, i2, *kx[True], True, -1),
         lambda: cf.radix2_stage_plain(r2, i2, *fx, True, -1),
         lambda: torch.fft.fft(c2, dim=-1), work_stage(spec, nx)),
        ("radix2_stage", "inv_z",
         lambda: cf.radix2_stage(sr, si, *kz[False], False, 1),
         lambda: cf.radix2_stage_plain(sr, si, *iz, False, 1),
         lambda: torch.fft.ifft(c, dim=1), work_stage(spec, nz)),
        ("radix2_stage_inv_otf", "otf",
         lambda: cf.radix2_stage_inv_otf(r2, i2, or_, oi, *kx[False], False),
         lambda: cf.radix2_stage_inv_otf_plain(r2, i2, or_, oi, *ix, False),
         lambda: torch.fft.ifft(c2, dim=-1), work_stage(spec, nx, spec)),
        ("radix2_stage_inv_otf", "conj",
         lambda: cf.radix2_stage_inv_otf(r2, i2, or_, oi, *kx[False], True),
         lambda: cf.radix2_stage_inv_otf_plain(r2, i2, or_, oi, *ix, True),
         lambda: torch.fft.ifft(c2, dim=-1), work_stage(spec, nx, spec)),
    ]


def err_of_max(got, ref):
    """(max |got - ref|, that over max |ref|) of a tensor or of a tuple of
    tensors taken together: re and im of one spectrum share one scale."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return abs_err, abs_err / max(scale, 1e-30)


def check_case(torch, tag, name, variant, shape, kfn, pfn, lfn, work, reps,
               rows, bad, timer=time_ms):
    """One kernel against its plain version on the same inputs: max
    |kernel - plain| / max |plain| <= 1e-5; then the kernel, the plain
    version and the library call timed by `timer`, and the kernel's
    bound."""
    got, ref = kfn(), pfn()
    torch.cuda.synchronize()
    abs_err, rel = err_of_max(got, ref)
    del got, ref
    ms, plain_ms = timer(torch, kfn, reps), timer(torch, pfn, reps)
    lib_ms = timer(torch, lfn, reps) if lfn is not None else None
    bound_ms, bound_by = bound(*work)
    rows.append(dict(kernel=name, variant=variant, shape=list(shape),
                     max_abs_err=abs_err, rel_err=rel, ms=ms,
                     plain_ms=plain_ms, library_ms=lib_ms, flops=work[0],
                     bytes=work[1], bound_ms=bound_ms, bound_by=bound_by))
    lib = "—" if lib_ms is None else f"{lib_ms:9.3f}"
    say(f"  {tag} {name:<28s} {variant:<6s} {str(shape):<20s} rel "
        f"{rel:.2e} abs {abs_err:.2e}  kernel {ms:9.3f} ms  plain "
        f"{plain_ms:9.3f}  library {lib}  bound {bound_ms:8.3f} ({bound_by})")
    if not rel <= 1e-5:
        bad.append(f"{name}/{variant} at {shape}: rel {rel:.3e}")


# ny that cover every radix of the real-FFT kernels' plans: 8 and 16 alone,
# 4, 2, 3, 5, 7, 9, and the generic pass at 17, 67 and 251
RDFT_LENGTHS = (8, 24, 40, 136, 536, 1120, 1152, 2008, 2048)
RDFT_PLANES, RDFT_NX = 128, 256


def phase_rdft_forms(torch, dev, record):
    """K1 and K2 at the lengths of RDFT_LENGTHS on (128, ny, 256) volumes:
    kernel vs plain <= 1e-5 of max with the times, torch.fft and the bytes
    bound; then, per length, a volume whose only bright column sits beside
    dark ones, a spectrum with junk in the rows kx..kp-1 and in im at k = 0
    and ny/2 (which the fold ignores), K1's padded rows exactly 0, and a
    batch of three against the three single calls, bit for bit."""
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.dft_mats import dft_fft_plan, rfft_fold_mats
    from ipp_tpu_torch.ops.matmul_fft import _kp

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    nz, nx = RDFT_PLANES, RDFT_NX
    rows, bad, extra = [], [], []

    def d(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    for ny in RDFT_LENGTHS:
        kp, kx = _kp(ny), ny // 2 + 1
        fwd, inv = (torch.tensor(m, device=dev)
                    for m in rfft_fold_mats(ny, kp))
        x, den, mul = d(nz, ny, nx), d(nz, ny, nx, lo=0.5), d(nz, ny, nx)
        sr, si = d(kp, nz, nx, lo=-1), d(kp, nz, nx, lo=-1)
        shape = (nz, ny, nx)
        cf.reset_launch_counts()
        for name, variant, kfn, pfn, lfn, work in rdft_cases(
                torch, cf, x, den, mul, sr, si, fwd, inv):
            check_case(torch, KERNELS[name][0], name, variant, shape, kfn,
                       pfn, lfn, work, 5, rows, bad)
            rows[-1]["plan"] = list(dft_fft_plan(ny))
        # one bright column among dark ones: its pair partner's error is
        # bounded by the tensor's max, and the dark columns' own values
        # must still come out within that bound
        xb = x * 1e-3
        xb[:, :, 77] = x[:, :, 77] * 1e3
        got = cf.rdft_y_fwd(xb, fwd, fold=True)
        ref = cf.rdft_y_fwd_plain(xb, fwd)
        rel_b = err_of_max(got, ref)[1]
        zero_rows = all(bool((g[kx:] == 0).all()) for g in got)
        edges = all(bool((got[1][k] == 0).all()) for k in (0, ny // 2))
        back = cf.rdft_y_inv(*got, inv, fold=True)
        rel_rt = rel_max(back, xb)
        # junk where the Hermitian fold has zero columns
        jr, ji = sr.clone(), si.clone()
        jr[kx:], ji[kx:] = 1e6, -1e6
        ji[0], ji[ny // 2] = 3e5, -7e5
        rel_j = rel_max(cf.rdft_y_inv(jr, ji, inv, fold=True),
                        cf.rdft_y_inv_plain(jr, ji, inv))
        ci = si.clone()
        ci[0], ci[ny // 2] = 0, 0
        same = torch.equal(cf.rdft_y_inv(jr, ji, inv, fold=True),
                           cf.rdft_y_inv(sr, ci, inv, fold=True))
        # a batch of three against three single calls, bit for bit
        xs = torch.stack([x, xb, den])[:, :8].contiguous()
        bre, bim = cf.rdft_y_fwd_batched(xs, fwd, fold=True)
        bout = cf.rdft_y_inv_batched(bre, bim, inv, mul=xs, fold=True)
        equal = True
        for i in range(3):
            one = cf.rdft_y_fwd(xs[i], fwd, fold=True)
            equal &= torch.equal(bre[i], one[0]) and torch.equal(bim[i], one[1])
            equal &= torch.equal(bout[i], cf.rdft_y_inv(*one, inv, mul=xs[i],
                                                        fold=True))
        torch.cuda.synchronize()
        dense = {k: v for k, v in cf.LAUNCHES.items()
                 if v and k.endswith("_dense")}
        extra.append(dict(ny=ny, plan=list(dft_fft_plan(ny)),
                          bright_rel=rel_b, round_trip_rel=rel_rt,
                          junk_rel=rel_j, junk_ignored=same,
                          zero_rows=zero_rows, edges=edges,
                          batch_equal=equal))
        say(f"  K1/K2 forms at ny={ny:<5d} plan {dft_fft_plan(ny)}: bright "
            f"column rel {rel_b:.2e}, round trip {rel_rt:.2e}, junk ignored "
            f"rel {rel_j:.2e}, padded rows 0 {zero_rows}, edge im 0 {edges}, "
            f"batch == singles {equal}")
        if not (rel_b <= 1e-5 and rel_rt <= 1e-5 and rel_j <= 1e-5):
            bad.append(f"ny={ny}: bright {rel_b:.3e}, round trip "
                       f"{rel_rt:.3e}, junk {rel_j:.3e}")
        if not (zero_rows and edges and equal and same):
            bad.append(f"ny={ny}: padded rows 0 {zero_rows}, edge im 0 "
                       f"{edges}, batch == singles {equal}, junk == no junk "
                       f"bit for bit {same}")
        if dense:
            bad.append(f"ny={ny}: dense launches {dense}")
        del x, den, mul, sr, si, xb, got, ref, back, jr, ji, ci, xs
        torch.cuda.empty_cache()
    cf.reset_launch_counts()
    record["rdft_forms"] = dict(kernels=rows, checks=extra)
    if bad:
        raise AssertionError("K1/K2 real-FFT kernels: " + "; ".join(bad))


# stage lengths of the mixed-radix FFT kernel (csrc/stage_mixed.cuh): 3 and 5
# after the powers of two, the generic pass (17), 9, and the largest length
# with one column a block on the middle axis; of the large-axis kernel
# (csrc/stage_large.cuh, above DFT_FFT_MAX_N = 12288): Form A on the last
# axis with a generic pass of 97 (12416 = 128 * 97), with 7 * 7 (12544) and
# at its largest length (24576), Form B on both axes (24832 = 256 * 97);
# the dense stage kernels, held through their own entry at 12416; K7's DFT
# above 12288 on the large-axis kernel (natural order)
STAGE_MIXED_LENGTHS = (384, 2176, 2304, 2560, 12288)
STAGE_LARGE_LENGTHS = (12416, 12544, 24576, 24832)
STAGE_DENSE_N = 12416   # 128 * 97
K7_LARGE_LENGTHS = (16384, 24832)


def stage_mats(torch, n, forward, dev):
    """The radix-2 stage matrices (mr_t, mi_t) of `dft_mats.stage_mats_t(n,
    forward)` on the card, for the plain versions and the dense kernels
    (the walk's plans hold none there: no stage kernel on their routes reads
    them).  Built on the card from the same float64 expressions, rounded
    once to f32 (`check_card_mats` holds them to the host's): at n = 24832
    the host's build took ~15 s and 5 GB a direction."""
    m = n // 2
    a = torch.arange(m, device=dev, dtype=torch.int64)
    jk = ((a[:, None] * a[None, :]) % m).double() / m   # (j k % m) / m
    ad = a.double()
    mr, mi = [], []
    for s in (0, 1):
        if forward:   # [s, k, t] = M_s[t, k] = exp(-2 pi i (t s / n + jk))
            th = -2 * math.pi * (ad[None, :] * s / n + jk)
            mr.append(torch.cos(th).float())
            mi.append(torch.sin(th).float())
        else:   # [s, t, k] = Minv_s[k, t] = exp(2 pi i (jk + s t / n)) / m
            th = 2 * math.pi * (jk + ad[:, None] * s / n)
            mr.append((torch.cos(th) / m).float())
            mi.append((torch.sin(th) / m).float())
        del th
    del jk
    return torch.stack(mr), torch.stack(mi)


def dft_triple(torch, n, forward, dev):
    """`dft_mats.cplx_triple(n, forward)` on the card, as `stage_mats`:
    (mr, mi, mr + mi) of the dense DFT exp(-2 pi i (j k % n) / n), or of
    its inverse (the transpose, conjugated, over n; the matrix is
    symmetric)."""
    a = torch.arange(n, device=dev, dtype=torch.int64)
    th = (-2 * math.pi * a.double() / n)[(a[:, None] * a[None, :]) % n]
    mr, mi = torch.cos(th), torch.sin(th)
    del th
    if forward:
        mr, mi = mr.float(), mi.float()
    else:
        mr, mi = (mr / n).float(), (-mi / n).float()
    return mr, mi, mr + mi


def check_card_mats(torch, dev):
    """The card's stage matrices and DFT triples against the host's
    (`dft_mats`) at small lengths: max |card - host| (0 or an f32 ulp)."""
    from ipp_tpu_torch.ops.dft_mats import cplx_triple, stage_mats_t

    worst = 0.0
    for n in (384, 2304):
        for f in (True, False):
            for c, h in zip(stage_mats(torch, n, f, dev), stage_mats_t(n, f)):
                worst = max(worst, float((c.cpu() - torch.from_numpy(
                    h.copy())).abs().max()))
            for c, h in zip(dft_triple(torch, n, f, dev), cplx_triple(n, f)):
                worst = max(worst, float((c.cpu() - torch.from_numpy(
                    h.copy())).abs().max()))
    return worst


def stage_form_cases(torch, n, gen, dev, dense=False):
    """(form, counter, kernel_fn, plain_fn) for every form of the radix-2
    stage at axis length n and a small row count: ragged against the
    kernels' column and row tiles, the batched OTF with a period.  The
    kernel calls go through the wrappers (the large-axis kernel's with no
    stage matrices, which it does not read), or with `dense` through the
    dense kernels' own entry, `cuda_fft.stage_dense`."""
    from ipp_tpu_torch.ops import cuda_fft as cf

    def d(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5

    fwd, inv = (stage_mats(torch, n, f, dev) for f in (True, False))
    kf, ki = ((None, None), (None, None)) if (
        cf.stage_route(n) == "large" and not dense) else (fwd, inv)
    zr, zi = d(3, n, 40), d(3, n, 40)
    xr, xi, pr, pi = d(21, n), d(21, n), d(21, n), d(21, n)
    br, bi, o_r, o_i = d(192, n), d(192, n), d(64, n), d(64, n)
    if dense:
        def stage(re, im, m, f, axis):
            name = "radix2_stage_inv_last" if axis == -1 and not f else \
                "radix2_stage"
            return cf.stage_dense(re, im, *m, f, axis, name=name)

        def otf_stage(re, im, o1, o2, m, conj, name="radix2_stage_inv_otf"):
            return cf.stage_dense(re, im, *m, False, -1, (o1, o2), conj, name)

        def otf_batched(re, im, o1, o2, m, conj):
            return otf_stage(re, im, o1, o2, m, conj,
                             "radix2_stage_inv_otf_batched")
    else:
        def stage(re, im, m, f, axis):
            return cf.radix2_stage(re, im, *m, f, axis)

        def otf_stage(re, im, o1, o2, m, conj):
            return cf.radix2_stage_inv_otf(re, im, o1, o2, *m, conj)

        def otf_batched(re, im, o1, o2, m, conj):
            return cf.radix2_stage_inv_otf_batched(re, im, o1, o2, *m, conj)

    return [
        ("fwd z", "radix2_stage",
         lambda: stage(zr, zi, kf, True, 1),
         lambda: cf.radix2_stage_plain(zr, zi, *fwd, True, 1)),
        ("inv z", "radix2_stage",
         lambda: stage(zr, zi, ki, False, 1),
         lambda: cf.radix2_stage_plain(zr, zi, *inv, False, 1)),
        ("fwd x", "radix2_stage",
         lambda: stage(xr, xi, kf, True, -1),
         lambda: cf.radix2_stage_plain(xr, xi, *fwd, True, -1)),
        ("K6 inv x", "radix2_stage_inv_last",
         lambda: stage(xr, xi, ki, False, -1),
         lambda: cf.radix2_stage_plain(xr, xi, *inv, False, -1)),
        ("K4 otf", "radix2_stage_inv_otf",
         lambda: otf_stage(xr, xi, pr, pi, ki, False),
         lambda: cf.radix2_stage_inv_otf_plain(xr, xi, pr, pi, *inv, False)),
        ("K4 conj", "radix2_stage_inv_otf",
         lambda: otf_stage(xr, xi, pr, pi, ki, True),
         lambda: cf.radix2_stage_inv_otf_plain(xr, xi, pr, pi, *inv, True)),
        ("K4b period", "radix2_stage_inv_otf_batched",
         lambda: otf_batched(br, bi, o_r, o_i, ki, True),
         lambda: cf.radix2_stage_inv_otf_plain(br, bi, o_r, o_i, *inv, True)),
    ]


def phase_stage_forms(torch, dev, record):
    """Every stage form at every length of the FFT route, at the lengths of
    STAGE_MIXED_LENGTHS (the mixed-radix kernel) and STAGE_LARGE_LENGTHS
    (the large-axis kernel), and on the dense kernels (their own entry,
    `cuda_fft.stage_dense`) at STAGE_DENSE_N: kernel vs plain <= 1e-5 of
    max, each launch counted under the name of the kernel that ran (the FFT
    kernels under the wrapper's own, the dense ones with `_dense`
    appended), and the mixed-radix and large-axis kernels' launches on
    their C entry points (`ENTRY_LAUNCHES`): one there at their lengths,
    none elsewhere.  Then K7's DFT at K7_LARGE_LENGTHS (the large-axis
    kernel, natural order) against `cplx_matmul_plain`, forward and
    inverse, one launch each.  The plain versions' matrices are built on
    the card (`stage_mats`, `dft_triple`), held to the host's first."""
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.dft_mats import STAGE_FFT_LENGTHS

    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    rows, bad = [], []
    mats_diff = check_card_mats(torch, dev)
    say(f"  the card's stage and DFT matrices against the host's at n = 384, "
        f"2304: max |diff| {mats_diff:.2e}")
    if not mats_diff <= 1e-6:
        bad.append(f"card-built matrices {mats_diff:.3e} off the host's")
    lengths = STAGE_FFT_LENGTHS + STAGE_MIXED_LENGTHS + STAGE_LARGE_LENGTHS
    for n in lengths + (-STAGE_DENSE_N,):
        dense = n < 0
        n = abs(n)
        route = "dense" if dense else cf.stage_route(n)
        worst = 0.0
        for form, counter, kfn, pfn in stage_form_cases(torch, n, gen, dev,
                                                        dense):
            cf.reset_launch_counts()
            got, ref = kfn(), pfn()
            torch.cuda.synchronize()
            counts = {k: v for k, v in cf.LAUNCHES.items() if v}
            rel = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in zip(got, ref))
            worst = max(worst, rel)
            rows.append(dict(n=n, route=route, form=form, rel_err=rel,
                             launches=counts,
                             entries=dict(cf.ENTRY_LAUNCHES)))
            want = ({STAGE_ENTRIES[route]: 1} if route in STAGE_ENTRIES
                    else {})
            got_entries = {k: v for k, v in cf.ENTRY_LAUNCHES.items()
                           if k in STAGE_ENTRIES.values()}
            if counts != {counter + ("_dense" if dense else ""): 1} \
                    or got_entries != want:
                bad.append(f"n={n} {form}: launches {counts}, "
                           f"{cf.ENTRY_LAUNCHES}")
            if not rel <= 1e-5:
                bad.append(f"n={n} {form}: rel {rel:.3e}")
            del got, ref
        say(f"  stage forms at n={n:<5d} ({route} kernels, 7 forms): worst "
            f"rel {worst:.2e}")
        torch.cuda.empty_cache()
    for n in K7_LARGE_LENGTHS:
        re = torch.rand((5, n), generator=gen, device=dev) - 0.5
        im = torch.rand((5, n), generator=gen, device=dev) - 0.5
        for forward in (True, False):
            mats = dft_triple(torch, n, forward, dev)
            cf.reset_launch_counts()
            got = cf.cplx_matmul(re, im, *mats, dft=forward)
            torch.cuda.synchronize()
            counts = {k: v for k, v in cf.LAUNCHES.items() if v}
            entry = dict(cf.ENTRY_LAUNCHES)
            ref = cf.cplx_matmul_plain(re, im, *mats)
            _, rel = err_of_max(got, ref)
            rows.append(dict(n=n, route=cf.dft_route(n),
                             form="K7 " + ("fwd" if forward else "inv"),
                             rel_err=rel, launches=counts, entries=entry))
            say(f"  K7 DFT at n={n} {'fwd' if forward else 'inv'} "
                f"({cf.dft_route(n)} kernel): rel {rel:.2e}, {entry}")
            if counts != {"cplx_matmul": 1} or \
                    entry != {"ipp_stage_large": 1}:
                bad.append(f"K7 n={n}: launches {counts}, {entry}")
            if not rel <= 1e-5:
                bad.append(f"K7 n={n}: rel {rel:.3e}")
            del mats, got, ref
            torch.cuda.empty_cache()
    cf.reset_launch_counts()
    record["stage_forms"] = rows
    record["card_mats_diff"] = mats_diff
    if bad:
        raise AssertionError("stage kernel != plain: " + "; ".join(bad))


# K1d / K2d off the real-FFT route: (nz, ny, nx, matrix): an odd nx, ny not
# 8 * j, ny above RDFT_FFT_MAX_NY (each with the fold), a random matrix
RDFT_DENSE_CASES = [(64, 1056, 255, "fold"), (64, 1100, 256, "fold"),
                    (16, 2560, 256, "fold"), (64, 300, 130, "random")]


def rdft_dense_cases(torch, cf, x, den, mul, sr, si, fwd, inv, fold):
    """(kernel, variant, kernel_fn, plain_fn, library_fn, work) of every form
    of K1d and K2d (the dense GEMMs) on a volume (nz, ny, nx) or a batch of
    them: plain, the ratio, |mul * y|, with the wrappers' `fold` as given;
    the library call is one torch.matmul of the same product."""
    batched = x.dim() == 4
    k1, k2 = ((cf.rdft_y_fwd_batched, cf.rdft_y_inv_batched) if batched
              else (cf.rdft_y_fwd, cf.rdft_y_inv))
    n1, n2 = (("rdft_y_fwd_batched_dense", "rdft_y_inv_batched_dense")
              if batched else ("rdft_y_fwd_dense", "rdft_y_inv_dense"))
    ny, kp, vox = x.shape[-2], sr.shape[-3], x.numel()
    both = torch.cat([sr, si], -3).transpose(-3, -2).contiguous()
    return [
        (n1, "plain", lambda: k1(x, fwd, fold=fold),
         lambda: cf.rdft_y_fwd_plain(x, fwd),
         lambda: torch.matmul(fwd, x), work_rdft_dense(vox, ny, kp, 0)),
        (n1, "ratio", lambda: k1(x, fwd, den, fold=fold),
         lambda: cf.rdft_y_fwd_plain(x, fwd, den),
         lambda: torch.matmul(fwd, x), work_rdft_dense(vox, ny, kp, 1)),
        (n2, "plain", lambda: k2(sr, si, inv, fold=fold),
         lambda: cf.rdft_y_inv_plain(sr, si, inv),
         lambda: torch.matmul(inv, both), work_rdft_dense(vox, ny, kp, 0)),
        (n2, "mul", lambda: k2(sr, si, inv, mul, fold=fold),
         lambda: cf.rdft_y_inv_plain(sr, si, inv, mul),
         lambda: torch.matmul(inv, both), work_rdft_dense(vox, ny, kp, 1)),
    ]


def phase_rdft_dense(torch, dev, cli_shape, record):
    """K1d and K2d, the tensor-core GEMMs (csrc/rdft_dense.cu), in every
    form: at the CLI block and a batch of four of it, and at the shapes of
    RDFT_DENSE_CASES, which state the fold (`fold=True`: the route by shape
    must still pick the dense kernel; the CLI block states nothing).  Each
    case: one call launches its `_dense` kernel once and nothing else;
    kernel vs plain <= 1e-5 of max with kernel, plain and torch.matmul ms
    and the bound (three bf16 products); the fold's zero rows exactly 0;
    and a batch of three equal to its single calls, bit for bit."""
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.dft_mats import rfft_fold_mats
    from ipp_tpu_torch.ops.matmul_fft import _kp

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    rows, bad, checks = [], [], []

    def d(*shape, lo=0.0):
        return torch.rand(shape, generator=gen, device=dev) * (1 - lo) + lo

    nz, ny, nx = cli_shape
    cases = [((), (nz, ny, nx), "fold"), ((4,), (nz, ny, nx), "fold")] + [
        ((), c[:3], c[3]) for c in RDFT_DENSE_CASES]
    for lead, (nz, ny, nx), kind in cases:
        kp = _kp(ny)
        if kind == "fold":
            fwd, inv = (torch.tensor(m, device=dev)
                        for m in rfft_fold_mats(ny, kp))
        else:
            fwd, inv = d(2 * kp, ny, lo=-1), d(ny, 2 * kp, lo=-1)
        x, den = d(*lead, nz, ny, nx), d(*lead, nz, ny, nx, lo=0.5)
        mul = d(*lead, nz, ny, nx)
        sr, si = d(*lead, kp, nz, nx, lo=-1), d(*lead, kp, nz, nx, lo=-1)
        shape = list(lead) + [nz, ny, nx]
        stated = kind == "fold" and cf.rdft_route(ny, nx) == "dense"
        for name, variant, kfn, pfn, lfn, work in rdft_dense_cases(
                torch, cf, x, den, mul, sr, si, fwd, inv, stated):
            cf.reset_launch_counts()
            kfn()
            torch.cuda.synchronize()
            counts = {k: v for k, v in cf.LAUNCHES.items() if v}
            if counts != {name: 1}:
                bad.append(f"{name}/{variant} at {shape}: launches {counts}")
            check_case(torch, "K1d" if "fwd" in name else "K2d", name,
                       variant, shape, kfn, pfn, lfn, work, 3, rows, bad)
            rows[-1].update(matrix=kind, fold=stated)
        zero = True
        if kind == "fold":
            re, im = cf.rdft_y_fwd(x[(0,) * len(lead)], fwd)
            zero = all(bool((g[ny // 2 + 1:] == 0).all()) for g in (re, im))
        equal = True
        if not lead:   # a batch of three against its single calls
            xs = torch.stack([x, den, mul])[:, :4].contiguous()
            ms = torch.stack([mul, x, den])[:, :4].contiguous()
            bre, bim = cf.rdft_y_fwd_batched(xs, fwd, ms)
            bout = cf.rdft_y_inv_batched(bre, bim, inv, xs)
            for i in range(3):
                one = cf.rdft_y_fwd(xs[i], fwd, ms[i])
                equal &= (torch.equal(bre[i], one[0])
                          and torch.equal(bim[i], one[1])
                          and torch.equal(bout[i],
                                          cf.rdft_y_inv(*one, inv, xs[i])))
        torch.cuda.synchronize()
        checks.append(dict(shape=shape, matrix=kind, zero_rows=zero,
                           batch_equal=equal))
        say(f"  K1d/K2d at {shape} ({kind}): fold rows 0 {zero}, batch == "
            f"singles {equal}")
        if not (zero and equal):
            bad.append(f"{shape} {kind}: fold rows 0 {zero}, batch == "
                       f"singles {equal}")
        del x, den, mul, sr, si, fwd, inv
        torch.cuda.empty_cache()
    cf.reset_launch_counts()
    record["rdft_dense"] = dict(kernels=rows, checks=checks)
    if bad:
        raise AssertionError("K1d/K2d tensor-core kernels: " + "; ".join(bad))


# the stage forms of the mixed-radix and large-axis kernels, timed: (n,
# planes of (P, n, X) for the middle-axis forms or None, rows of (R, n) for
# the last-axis forms or None); the (256, 256, 2304) RL block's x stages
# (kp * nz = 136 * 256 rows of 2304) and the (256, 16, 12544) one's (16 *
# 256 rows of 12544, Form A); K6 at (512, 12416), the dense kernel's worst
# loss; Form B on the middle axis at (4, 12544, 256) and on the last axis at
# (256, 24832)
STAGE_TIMES = [(384, 64, 16384), (2560, 16, 4096), (2176, 16, 4096),
               (12288, 4, 1024), (2304, None, 136 * 256),
               (12416, None, 512), (12544, 4, 16 * 256), (24832, 2, 256)]
STAGE_DENSE_TIME = (STAGE_DENSE_N, 512)   # K6's dense kernel: n, rows


def phase_stage_times(torch, dev, record):
    """The stage forms (forward z, K6, K4; forward x on the last axis) at
    the shapes of STAGE_TIMES, which run the mixed-radix kernel
    (csrc/stage_mixed.cuh) or the large-axis one (csrc/stage_large.cuh;
    inverse z too), and K6 on the dense kernel (csrc/fft_walk.cu, its own
    entry `cuda_fft.stage_dense`) at STAGE_DENSE_TIME: each against its
    plain version (<= 1e-5 of max), one torch.fft call and the bound
    (`work_stage`), with one launch under the wrapper's counter (the dense
    one with `_dense` appended) and on its C entry point.  Above 12288 each
    form's dense kernel on the same inputs is timed too (`dense_ms`, the
    "<-" of PERF.md).  Times are the device's, from calls replayed out of a
    CUDA graph (`graph_ms`): at ~0.1 ms a call the host's per-call time
    would show in `time_ms`; the dense kernels' (10-100 ms) by events."""
    from ipp_tpu_torch.ops import cuda_fft as cf

    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    rows, bad = [], []

    def d(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5

    for n, planes, nrows in STAGE_TIMES + [(-STAGE_DENSE_TIME[0], None,
                                            STAGE_DENSE_TIME[1])]:
        dense = n < 0
        n = abs(n)
        route = "dense" if dense else cf.stage_route(n)
        large = route == "large"
        fwd, inv = (stage_mats(torch, n, f, dev) for f in (True, False))
        kf, ki = ((None, None), (None, None)) if large else (fwd, inv)
        cases = []
        if planes is not None:
            zr, zi = d(planes, n, 256), d(planes, n, 256)
            cz = torch.complex(zr, zi)
            cases.append((
                "radix2_stage", "fwd z", [planes, n, 256],
                lambda: cf.radix2_stage(zr, zi, *kf, True, 1),
                lambda: cf.radix2_stage_plain(zr, zi, *fwd, True, 1),
                lambda: torch.fft.fft(cz, dim=1), work_stage(zr.numel(), n),
                lambda: cf.stage_dense(zr, zi, *fwd, True, 1)))
            if large:
                cases.append((
                    "radix2_stage", "inv z", [planes, n, 256],
                    lambda: cf.radix2_stage(zr, zi, *ki, False, 1),
                    lambda: cf.radix2_stage_plain(zr, zi, *inv, False, 1),
                    lambda: torch.fft.ifft(cz, dim=1),
                    work_stage(zr.numel(), n),
                    lambda: cf.stage_dense(zr, zi, *inv, False, 1)))
        xr, xi, o_r, o_i = d(nrows, n), d(nrows, n), d(nrows, n), d(nrows, n)
        cx = torch.complex(xr, xi)
        if dense:
            cases.append((
                "radix2_stage_inv_last_dense", "K6 inv x", [nrows, n],
                lambda: cf.stage_dense(xr, xi, *inv, False, -1,
                                       name="radix2_stage_inv_last"),
                lambda: cf.radix2_stage_plain(xr, xi, *inv, False, -1),
                lambda: torch.fft.ifft(cx, dim=-1), work_stage(xr.numel(), n),
                None))
        else:
            if planes is None or large:
                cases.append((
                    "radix2_stage", "fwd x", [nrows, n],
                    lambda: cf.radix2_stage(xr, xi, *kf, True, -1),
                    lambda: cf.radix2_stage_plain(xr, xi, *fwd, True, -1),
                    lambda: torch.fft.fft(cx, dim=-1),
                    work_stage(xr.numel(), n),
                    lambda: cf.stage_dense(xr, xi, *fwd, True, -1)))
            cases += [(
                "radix2_stage_inv_last", "K6 inv x", [nrows, n],
                lambda: cf.radix2_stage(xr, xi, *ki, False, -1),
                lambda: cf.radix2_stage_plain(xr, xi, *inv, False, -1),
                lambda: torch.fft.ifft(cx, dim=-1), work_stage(xr.numel(), n),
                lambda: cf.stage_dense(xr, xi, *inv, False, -1,
                                       name="radix2_stage_inv_last")), (
                "radix2_stage_inv_otf", "K4 otf", [nrows, n],
                lambda: cf.radix2_stage_inv_otf(xr, xi, o_r, o_i, *ki, False),
                lambda: cf.radix2_stage_inv_otf_plain(xr, xi, o_r, o_i, *inv,
                                                      False),
                lambda: torch.fft.ifft(cx, dim=-1),
                work_stage(xr.numel(), n, xr.numel()),
                lambda: cf.stage_dense(xr, xi, *inv, False, -1, (o_r, o_i),
                                       name="radix2_stage_inv_otf"))]
        for name, variant, shape, kfn, pfn, lfn, work, dfn in cases:
            cf.reset_launch_counts()
            kfn()
            torch.cuda.synchronize()
            counts = {k: v for k, v in cf.LAUNCHES.items() if v}
            got_entries = dict(cf.ENTRY_LAUNCHES)
            want = ({STAGE_ENTRIES[route]: 1} if route in STAGE_ENTRIES
                    else {"ipp_radix2_stage": 1})
            if counts != {name: 1} or got_entries != want:
                bad.append(f"{name} at n={n}: launches {counts}, "
                           f"{got_entries}")
            check_case(torch, "stage", name, variant, shape, kfn, pfn, lfn,
                       work, 3, rows, bad, timer=graph_ms)
            rows[-1].update(route=route, n=n, timer="graph")
            if large:
                rows[-1]["dense_ms"] = time_ms(torch, dfn, 2)
                say(f"    <- the dense kernel {rows[-1]['dense_ms']:9.3f} ms")
        del cases, fwd, inv, kf, ki, xr, xi, o_r, o_i, cx
        torch.cuda.empty_cache()
    cf.reset_launch_counts()
    record["stage_times"] = rows
    if bad:
        raise AssertionError("stage kernels: " + "; ".join(bad))


def ptxas_summary(log: str):
    """One line per kernel of ptxas' -v report: name (template arguments of
    the stage FFT kernels decoded), registers, spill bytes."""
    import re

    out, name = [], None
    spill = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"stage_fftILi(\d+)ELb([01])ELi(\d)E", name)
            if t:
                name = (f"stage_fft<{t.group(1)}, "
                        f"{'last' if t.group(2) == '1' else 'middle'}, "
                        f"{('FWD', 'INV', 'INV_OTF')[int(t.group(3))]}>")
            t = re.search(r"stage_mixedILb([01])ELi(\d)E", name)
            if t:
                name = (f"stage_mixed<"
                        f"{'last' if t.group(1) == '1' else 'middle'}, "
                        f"{('FWD', 'INV', 'INV_OTF')[int(t.group(2))]}>")
            t = re.search(r"large_(a|b1|b2)ILi(\d)ELb([01])E", name)
            if t:
                form = {"a": "A", "b1": "B pass 1", "b2": "B pass 2"}
                name = (f"stage_large<{form[t.group(1)]}, "
                        f"{('FWD', 'INV', 'INV_OTF')[int(t.group(2))]}"
                        f"{', natural' if t.group(3) == '1' else ''}>")
            t = re.search(r"dft_lastILb([01])E", name)
            if t:
                name = f"dft_last<{('FWD', 'INV')[int(t.group(1))]}>"
            t = re.search(r"dwt_(rows|cols)ILi(\d+)ELi(\d+)E", name)
            if t:
                name = (f"dwt_{t.group(1)}<R={t.group(2)}, H="
                        f"{t.group(3) if t.group(3) != '0' else 'any'}>")
            t = re.search(r"rdft_denseILi(\d)ELb([01])E", name)
            if t:
                mode = ("FWD", "FWD_RATIO", "INV", "INV_MUL")[int(t.group(1))]
                name = (f"rdft_dense<{mode}, "
                        f"{'16' if t.group(2) == '1' else '4'}-byte matrix loads>")
            t = re.search(r"cplx_denseILb([01])E", name)
            if t:
                name = (f"cplx_dense<"
                        f"{'16' if t.group(1) == '1' else '4'}-byte data copies>")
            t = re.search(r"rdft_y_(fwd|inv)_fftILb([01])E", name)
            if t:
                fused = {"fwd": "RATIO", "inv": "MUL"}[t.group(1)]
                name = (f"rdft_y_{t.group(1)}_fft<"
                        f"{fused if t.group(2) == '1' else 'plain'}>")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill {m.group(1)} / {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


def phase_kernels(torch, dev, shapes, cli_shape, record):
    import numpy as np

    from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3

    from ipp_tpu_torch.ops import cuda_fft as cf

    rng = np.random.default_rng(2)
    rows, bad = [], []
    tags = {**KERNELS, **RDFT_DENSE}
    for shape in shapes:
        plan = MatmulFFT3(shape, dev)
        for name, variant, kfn, pfn, lfn, work in kernel_cases(torch, plan,
                                                                rng, dev):
            cf.reset_launch_counts()
            check_case(torch, tags[name][0], name, variant, shape, kfn,
                       pfn, lfn, work, 3 if np.prod(shape) > 2 ** 27 else 5,
                       rows, bad)
            routed = {k for k, v in cf.LAUNCHES.items() if v}
            if routed != {name}:
                bad.append(f"{name}/{variant} at {shape} launched {routed}")
        del plan
        torch.cuda.empty_cache()
    cf.reset_launch_counts()
    record["kernels"] = rows
    if bad:
        raise AssertionError("kernel != plain: " + "; ".join(bad))
    phase_rdft_forms(torch, dev, record)
    phase_rdft_dense(torch, dev, cli_shape, record)
    phase_stage_forms(torch, dev, record)
    phase_stage_times(torch, dev, record)


# -- phase 3 -----------------------------------------------------------------

def phase_rl_block(torch, dev, record):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.deconv import richardson_lucy
    from ipp_tpu_torch.ops.psf import gaussian_psf

    shape, halo = (512, 512, 512), 16
    rng = np.random.default_rng(0)
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32) * 1000).to(dev)
    psf = torch.from_numpy(gaussian_psf((9, 9, 9), (2.0, 2.0, 2.0))).to(dev)

    def run(route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = richardson_lucy(vol, psf, niter=NITER, fft_shape=shape,
                              route=route)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cf.reset_launch_counts()
    walk, t_walk0 = run(None)
    counts = dict(cf.LAUNCHES)
    # the RL loop on the v2 walk (K1 2n+1, K2 2n, K3 6n+2, K4 2n); the
    # edge taper's six slab blurs lie outside the v2 domain and take
    # torch.fft; no batched form
    want = add_launches({k: 0 for k in counts}, rl_launches(shape, NITER),
                        taper_launches(shape, psf.shape))
    fft, t_fft0 = run("fft")
    # warm times: the better of two runs each (a single ~0.11 s torch.fft
    # run now and then takes ~0.16 s)
    t_walk = min(run(None)[1] for _ in range(2))
    t_fft = min(run("fft")[1] for _ in range(2))
    inner = (slice(halo, -halo),) * 3
    a, b = walk[inner], fft[inner]
    excess = float(((a - b).abs() - (0.2 + 2e-3 * b.abs())).max())
    rel = float((a - b).abs().max() / b.abs().max())
    core = float(np.prod([s - 2 * halo for s in shape]))
    record["rl_block"] = dict(
        shape=list(shape), halo=halo, niter=NITER, launches=counts,
        walk_s=t_walk, fft_s=t_fft, walk_first_s=t_walk0,
        fft_first_s=t_fft0, walk_core_mvox_s=core / t_walk / 1e6,
        fft_core_mvox_s=core / t_fft / 1e6, max_rel_diff=rel,
        tol_excess=excess)
    say(f"  launches {counts}")
    say(f"  walk {t_walk:.3f} s/block ({core / t_walk / 1e6:.1f} core Mvox/s)"
        f", torch.fft {t_fft:.3f} s/block ({core / t_fft / 1e6:.1f}); "
        f"max |walk-fft|/max|fft| {rel:.2e}, tolerance excess {excess:.3e}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not excess <= 0:
        raise AssertionError("walk vs torch.fft outside rtol=2e-3, atol=2e-1")
    if not bool(torch.isfinite(walk).all()):
        raise AssertionError("non-finite RL output")


def entry_stage_launches(shape, forward: int, inverse: int,
                         route: str) -> int:
    """Launches of the stage kernel of `route` ("mixed": `ENTRY_LAUNCHES
    ["ipp_stage_mixed"]`, "large": `["ipp_stage_large"]`) by `forward` and
    `inverse` transforms on the v2 walk at a work shape: a z stage and an x
    stage each (the x inverse is K4), on each axis whose length
    `stage_route` sends to that kernel."""
    from ipp_tpu_torch.ops.cuda_fft import stage_route
    from ipp_tpu_torch.ops.matmul_fft import in_kernel_domain

    if not in_kernel_domain(shape):
        return 0
    nz, _, nx = shape
    return (forward + inverse) * ((stage_route(nz) == route)
                                  + (stage_route(nx) == route))


RL_MIXED_SHAPE = (256, 256, 2304)   # x: K3 forward over x and K4 at n = 2304
CONV_MIXED_SHAPE = (2304, 64, 256)  # z: the middle-axis form at n = 2304
RL_LARGE_SHAPE = (256, 16, 12544)   # x: Form A at n = 12544
CONV_LARGE_SHAPE = (12544, 8, 256)  # z: Form B on the middle axis


def phase_rl_route(torch, dev, record, route, shape, cshape, seed):
    """The v2 walk at full width through the `route` stage kernel
    ("mixed" or "large"): richardson_lucy on a `shape` block (9^3 gaussian
    PSF, 10 iterations) on the walk against the torch.fft route, <= 1e-3 of
    max on the core (a 16-voxel halo; all of an axis of 32 or fewer),
    exact launch counts with no dense launch and the kernel's launches on
    its C entry point; then one MatmulFFT3.convolve at `cshape` (the PSF
    cut to an odd extent within it) against torch.fft at the walk's
    tolerance (rtol 2e-3, atol 0.2).  Recorded as
    record["rl_" + route]; with the walk plan's device bytes (built alone,
    `torch.cuda.max_memory_allocated`)."""
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.deconv import _rolled_psf, richardson_lucy
    from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3
    from ipp_tpu_torch.ops.psf import gaussian_psf

    halo, entry = 16, STAGE_ENTRIES[route]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plan = MatmulFFT3(shape, dev)
    torch.cuda.synchronize()
    plan_bytes = torch.cuda.max_memory_allocated() - base
    del plan
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32) * 1000).to(dev)
    psf = torch.from_numpy(gaussian_psf((9, 9, 9), (2.0, 2.0, 2.0))).to(dev)

    def run(how):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = richardson_lucy(vol, psf, niter=NITER, fft_shape=shape,
                              route=how)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cf.reset_launch_counts()
    walk, _ = run(None)
    counts = dict(cf.LAUNCHES)
    launched = cf.ENTRY_LAUNCHES.get(entry, 0)
    want = add_launches({k: 0 for k in counts}, rl_launches(shape, NITER),
                        taper_launches(shape, psf.shape))
    want_entry = entry_stage_launches(shape, 1 + 2 * NITER, 2 * NITER,
                                      route) + sum(
        entry_stage_launches(s, 2, 1, route)
        for s in taper_work_shapes(shape, psf.shape))
    fft, _ = run("fft")
    t_walk = min(run(None)[1] for _ in range(2))
    t_fft = min(run("fft")[1] for _ in range(2))
    inner = tuple(slice(halo, -halo) if s > 2 * halo else slice(None)
                  for s in shape)
    rel = float((walk[inner] - fft[inner]).abs().max()
                / fft[inner].abs().max())
    finite = bool(torch.isfinite(walk).all())
    del walk, fft, vol
    torch.cuda.empty_cache()

    plan = MatmulFFT3(cshape, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 24)
    x = torch.rand(cshape, generator=gen, device=dev) * 1000
    # the PSF's centre, cut to an odd extent within the shape (y = 8: 7)
    cut = psf[tuple(slice((p - min(p, c - 1 + c % 2)) // 2,
                          (p + min(p, c - 1 + c % 2)) // 2)
                    for p, c in zip(psf.shape, cshape))]
    k = _rolled_psf(cut / cut.sum(), cshape).contiguous()
    cf.reset_launch_counts()
    otf = plan.otf_packed(k)
    got = plan.convolve(x, otf)
    torch.cuda.synchronize()
    c_counts = {n: v for n, v in cf.LAUNCHES.items() if v}
    c_launched = cf.ENTRY_LAUNCHES.get(entry, 0)
    c_want = walk_launches(cshape, 2, 1)
    ref = torch.fft.irfftn(torch.fft.rfftn(x) * torch.fft.rfftn(k), s=cshape)
    c_excess = float(((got - ref).abs() - (0.2 + 2e-3 * ref.abs())).max())
    c_rel = float((got - ref).abs().max() / ref.abs().max())
    c_ms = time_ms(torch, lambda: plan.convolve(x, otf), 3)
    c_fft_ms = time_ms(torch, lambda: torch.fft.irfftn(
        torch.fft.rfftn(x) * torch.fft.rfftn(k), s=cshape), 3)
    del plan, x, k, otf, got, ref
    torch.cuda.empty_cache()

    record["rl_" + route] = dict(
        shape=list(shape), halo=halo, niter=NITER, launches=counts,
        entry_launches=launched, walk_s=t_walk, fft_s=t_fft,
        max_rel_diff=rel, plan_bytes=plan_bytes,
        convolve=dict(shape=list(cshape), launches=c_counts,
                      entry_launches=c_launched, rel=c_rel,
                      tol_excess=c_excess, ms=c_ms, fft_ms=c_fft_ms))
    say(f"  RL {shape}: launches {counts}, {entry} {launched}; the walk's "
        f"plan {plan_bytes} device bytes")
    say(f"  walk {t_walk:.3f} s, torch.fft {t_fft:.3f} s; max |walk-fft| / "
        f"max |fft| on the core {rel:.2e}")
    say(f"  convolve {cshape}: launches {c_counts}, {entry} {c_launched}; vs "
        f"torch.fft rel {c_rel:.2e}, tolerance excess {c_excess:.3e}; "
        f"{c_ms:.2f} ms vs torch.fft {c_fft_ms:.2f} ms")
    if counts != want or launched != want_entry or launched == 0:
        raise AssertionError(f"RL launches {counts}, {entry} {launched} != "
                             f"{want}, {want_entry}")
    if not (rel <= 1e-3 and finite):
        raise AssertionError(f"RL walk vs torch.fft {rel:.3e} > 1e-3 of max "
                             f"on the core (finite: {finite})")
    c_want_entry = entry_stage_launches(cshape, 2, 1, route)
    if c_counts != c_want or c_launched != c_want_entry or c_launched == 0:
        raise AssertionError(f"convolve launches {c_counts}, {entry} "
                             f"{c_launched} != {c_want}, {c_want_entry}")
    if not c_excess <= 0:
        raise AssertionError("convolve vs torch.fft outside rtol=2e-3, "
                             "atol=2e-1")


# -- phase 4 -----------------------------------------------------------------

def bead_widths(vol, beads, r=8):
    """Equivalent width (area / peak above the local floor) of each bead's
    x profile; smaller is sharper."""
    import numpy as np

    widths = []
    for z, y, x in beads:
        p = vol[z, y, x - r:x + r + 1].astype(np.float64)
        p = p - min(p[0], p[-1])
        peak = p[r]
        if peak > 0:
            widths.append(np.clip(p, 0, None).sum() / peak)
    return np.asarray(widths)


def write_u16_tiff(path: Path, plane) -> None:
    """One uncompressed, single-strip, little-endian baseline TIFF of a
    2-D u16 plane."""
    h, w = plane.shape
    n_tags = 10
    data_off = 8 + 2 + 12 * n_tags + 4
    tags = [(256, 4, w), (257, 4, h), (258, 3, 16), (259, 3, 1),
            (262, 3, 1), (273, 4, data_off), (277, 3, 1), (278, 4, h),
            (279, 4, h * w * 2), (339, 3, 1)]
    ifd = struct.pack("<H", n_tags) + b"".join(
        struct.pack("<HHII", tag, typ, 1, val) for tag, typ, val in tags)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8) + ifd
                + struct.pack("<I", 0))
        f.write(plane.astype("<u2", copy=False).tobytes())


def make_series(torch, dev, psf_zyx, out_dir, seed=7):
    """Synthetic bead phantom, blurred by the PSF with torch.fft on the
    card, Poisson-noised, written as z-plane u16 TIFFs."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    shape = VOL_SHAPE
    rng = np.random.default_rng(seed)
    beads = np.stack([rng.integers(32, s - 32, N_BEADS) for s in shape], 1)
    truth = torch.full(shape, 100.0, device=dev)
    amp = torch.from_numpy(rng.uniform(20000, 40000, N_BEADS).astype(np.float32))
    idx = torch.from_numpy(beads).to(dev)
    truth[idx[:, 0], idx[:, 1], idx[:, 2]] += amp.to(dev)
    psf = torch.from_numpy(np.ascontiguousarray(psf_zyx, np.float32)).to(dev)
    pad = torch.zeros(shape, device=dev)
    pad[tuple(slice(0, s) for s in psf.shape)] = psf
    pad = torch.roll(pad, tuple(-(s // 2) for s in psf.shape), (0, 1, 2))
    spec = torch.fft.rfftn(truth)
    del truth
    spec *= torch.fft.rfftn(pad)
    del pad
    blurred = torch.fft.irfftn(spec, s=shape).clamp_(min=0)
    del spec
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    noisy = torch.poisson(blurred, generator=gen).clamp_(0, 65535)
    del blurred
    host = noisy.to(torch.int32).cpu().numpy().astype(np.uint16)
    del noisy
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        futs = [pool.submit(write_u16_tiff, out_dir / f"img_{z:06d}.tif",
                            host[z]) for z in range(shape[0])]
        for f in futs:
            f.result()
    return host, beads


def phase_cli(torch, dev, psf_zyx, record, shared):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.matmul_fft import in_kernel_domain
    from ipp_tpu_torch.pipeline import deconvolve as pdc

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    src, dst = work / "input", work / "output"
    t0 = time.perf_counter()
    host, beads = make_series(torch, dev, psf_zyx, src)
    t_data = time.perf_counter() - t0
    shared.update(src=src, host=host, beads=beads)   # phases 8 and 9
    vol_shape = host.shape
    plans, halo, planned = pdc.autosplit(vol_shape, psf_zyx.shape,
                                         strict_accuracy=True,
                                         kernel_domain=True)
    uni = pdc.fft_work_shape(plans, halo, planned)
    fft_shape = pdc._fft_shape_for_backend(uni)
    nb = len(plans)
    say(f"  input {vol_shape} u16 written in {t_data:.1f} s; plan: {nb} "
        f"blocks, halo {halo}, work shape {fft_shape}")
    if not in_kernel_domain(fft_shape):
        raise AssertionError(f"work shape {fft_shape} outside kernel domain")
    torch.cuda.reset_peak_memory_stats()
    cf.reset_launch_counts()
    t0 = time.perf_counter()
    rc = pdc.main(["-i", str(src), "-o", str(dst), "--niter", str(NITER)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cf.LAUNCHES)
    vox = float(np.prod(vol_shape))
    record["cli"] = dict(
        vol_shape=list(vol_shape), n_blocks=nb, halo=list(halo),
        work_shape=list(fft_shape), wall_s=wall, data_s=t_data,
        core_mvox_s=vox / wall / 1e6, launches=counts,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    say(f"  CLI rc {rc}: {nb} blocks in {wall:.1f} s, "
        f"{vox / wall / 1e6:.2f} core Mvox/s; launches {counts}; the taper "
        f"slabs {sorted(set(taper_work_shapes(uni, psf_zyx.shape)))} on "
        f"torch.fft")
    # per block: RL on the v2 walk and the taper's slab blurs through
    # torch.fft; one block at a time, so no batched form
    per_block = add_launches({}, rl_launches(fft_shape, NITER),
                             taper_launches(uni, psf_zyx.shape))
    want = {k: nb * per_block.get(k, 0) for k in counts}
    if rc != 0 or counts != want:
        raise AssertionError(f"not every block ran the kernel walk: "
                             f"{counts} != {want}")
    outs = sorted(dst.glob("img_*.tif"))
    if len(outs) != vol_shape[0]:
        raise AssertionError(f"{len(outs)} output planes, want {vol_shape[0]}")
    man = json.loads((dst / "blocks_manifest.json").read_text())
    if (man.get("n_blocks") != nb or len(man.get("quant", {})) != nb
            or "finished" not in man):
        raise AssertionError("manifest incomplete")
    out = pdc.TiffDirVolume(dst).read_block(
        tuple((0, s) for s in vol_shape))
    if out.dtype != np.uint16 or out.shape != vol_shape:
        raise AssertionError(f"output {out.dtype} {out.shape}")
    w_in = float(np.median(bead_widths(host, beads)))
    w_out = float(np.median(bead_widths(out, beads)))
    record["cli"].update(bead_width_in=w_in, bead_width_out=w_out)
    say(f"  bead equivalent width (x, voxels, median of {len(beads)}): "
        f"input {w_in:.3f}, output {w_out:.3f}")
    if not w_out < w_in:
        raise AssertionError("beads are not sharper than in the input")
    shared["cli_out"] = dst   # phase 16 holds its mesh run to these planes


# -- phase 5 -----------------------------------------------------------------

DWT_MAIN_SHAPE = (8, 2688, 2688)


def dwt_level_cases():
    """The destripe CLI's levels of its padded batch: level k's 2D step runs
    axis -1 on (8, h, h) and axis -2 on (8, h, h / 2), h = 2688 >> k (level
    0's axis -1 is the main case)."""
    out = []
    for k in range(7):
        h = DWT_MAIN_SHAPE[1] >> k
        if k:
            out.append(("db9", (8, h, h), -1))
        out.append(("db9", (8, h, h // 2), -2))
    return out


def phase_dwt(torch, dev, record):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_dwt as cd
    from ipp_tpu_torch.ops import wavelets as wv

    rng = np.random.default_rng(5)
    cases = [("db9", DWT_MAIN_SHAPE, -1), ("db9", DWT_MAIN_SHAPE, -2),
             ("db9", (8, 2304, 2688), -1), ("db9", (8, 2304, 2688), -2),
             ("coif15", DWT_MAIN_SHAPE, -1), ("coif15", DWT_MAIN_SHAPE, -2),
             ("db3", DWT_MAIN_SHAPE, -1), ("db3", DWT_MAIN_SHAPE, -2),
             ("haar", DWT_MAIN_SHAPE, -1), ("haar", DWT_MAIN_SHAPE, -2),
             ("db34", DWT_MAIN_SHAPE, -1), ("db34", DWT_MAIN_SHAPE, -2),
             ("coif17", DWT_MAIN_SHAPE, -1), ("coif17", DWT_MAIN_SHAPE, -2),
             ("db9", (8, 336, 16), -1), ("db9", (8, 16, 336), -2),
             ("db9", DWT_MAIN_SHAPE, "level")] + dwt_level_cases()
    rows, bad = [], []
    x_main = None
    for name, shape, axis in cases:
        if shape == DWT_MAIN_SHAPE and x_main is not None:
            x = x_main
        else:
            x = torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(dev)
            if shape == DWT_MAIN_SHAPE:
                x_main = x
        taps = wv.filter_taps(name, dev)
        L = int(taps.shape[1])
        lfn = None   # one level of three calls has no single library call
        if axis == "level":   # one 2D level of wavedec2: x, then y twice
            def kfn():
                a1, d1 = cd.dwt_analysis(x, taps, -1)
                return cd.dwt_analysis(a1, taps, -2) + \
                    cd.dwt_analysis(d1, taps, -2)

            def pfn():
                a1, d1 = cd.dwt_analysis_plain(x, taps, -1)
                return cd.dwt_analysis_plain(a1, taps, -2) + \
                    cd.dwt_analysis_plain(d1, taps, -2)
            f1, b1 = work_dwt(x.numel(), L)
            work = (2 * f1, 2 * b1)   # x once, then both halves along y
        else:
            def kfn():
                return cd.dwt_analysis(x, taps, axis)

            def pfn():
                return cd.dwt_analysis_plain(x, taps, axis)
            # the library call: one strided F.conv1d of both filters over
            # the circular extension along the axis, built beforehand
            rows_ = x if axis == -1 else x.transpose(-1, -2)
            n = rows_.shape[-1]
            ext = torch.cat([rows_] * (1 + -(-L // n)), -1)[..., :n + L]
            ext = ext.reshape(-1, 1, n + L).contiguous()
            w = taps.unsqueeze(1)

            def lfn():
                return torch.nn.functional.conv1d(ext, w, stride=2)
            work = work_dwt(x.numel(), L)
        got, ref = kfn(), pfn()
        torch.cuda.synchronize()
        abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        rel = abs_err / max(scale, 1e-30)
        ms, plain_ms = time_ms(torch, kfn, 10), time_ms(torch, pfn, 10)
        lib_ms = time_ms(torch, lfn, 10) if lfn is not None else None
        bound_ms, bound_by = bound(*work)
        rows.append(dict(wavelet=name, shape=list(shape), axis=axis,
                         taps=L, max_abs_err=abs_err,
                         rel_err=rel, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        lib = "—" if lib_ms is None else f"{lib_ms:8.3f}"
        say(f"  K5 dwt_analysis {name:<6s} {str(shape):<16s} axis "
            f"{str(axis):<5s} rel {rel:.2e} abs {abs_err:.2e}  kernel "
            f"{ms:8.3f} ms  plain {plain_ms:8.3f}  library {lib}  bound "
            f"{bound_ms:7.3f} ({bound_by})")
        if not rel <= 1e-5:
            bad.append(f"{name} {shape} axis {axis}: rel {rel:.3e}")
        del got, ref
    # a batch of 8 gives bit for bit its 8 single calls: each output is the
    # same sum in the same order whatever the batch
    for name, axis in (("db9", -1), ("db9", -2), ("coif15", -2)):
        taps = wv.filter_taps(name, dev)
        got = cd.dwt_analysis(x_main, taps, axis)
        same = all(torch.equal(g[i:i + 1], s_)
                   for i in range(x_main.shape[0])
                   for g, s_ in zip(got, cd.dwt_analysis(x_main[i:i + 1],
                                                         taps, axis)))
        say(f"  K5 dwt_analysis {name:<6s} {str(DWT_MAIN_SHAPE):<16s} axis "
            f"{axis:<5d} batch of 8 vs 8 single calls: "
            f"{'bit-equal' if same else 'DIFFER'}")
        rows.append(dict(wavelet=name, shape=list(DWT_MAIN_SHAPE), axis=axis,
                         batch_equals_single=same))
        if not same:
            bad.append(f"{name} axis {axis}: a batch differs from its singles")
        del got
    record["dwt"] = rows
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("K5 != plain: " + "; ".join(bad))


# -- phase 6 -----------------------------------------------------------------

def striped_tile(rng, field):
    """One u16 tile: the smooth field plus 3000 beads (a pixel and its four
    neighbours), times stripes along x (rows) and along y (columns), each
    on ~15% of the lines at +-30%, plus gaussian noise."""
    import numpy as np

    h, w = field.shape
    img = field.copy()
    n = 3000
    ys, xs = rng.integers(2, h - 2, n), rng.integers(2, w - 2, n)
    amp = rng.uniform(2000, 8000, n).astype(np.float32)
    for dy, dx, f in ((0, 0, 1.0), (1, 0, 0.5), (-1, 0, 0.5), (0, 1, 0.5),
                      (0, -1, 0.5)):
        np.add.at(img, (ys + dy, xs + dx), amp * f)
    rows = 1 + 0.3 * rng.standard_normal((h, 1), dtype=np.float32) \
        * (rng.random((h, 1)) < 0.15)
    cols = 1 + 0.3 * rng.standard_normal((1, w), dtype=np.float32) \
        * (rng.random((1, w)) < 0.15)
    img = img * np.clip(rows, 0.3, None) * np.clip(cols, 0.3, None)
    img += rng.standard_normal((h, w), dtype=np.float32) * 15
    return np.clip(img, 0, 65535).astype(np.uint16)


def make_tile_tree(root, seed=11):
    """The phase-6 tile tree, written by the smoke's own TIFF writer;
    returns {stack dir: (planes, tile shape)}."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    jobs, stacks = [], {}
    k = 0
    for n_stacks, planes, (h, w) in TILE_STACKS:
        yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
        xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
        for _ in range(n_stacks):
            d = root / f"Ex_488_Em_525/{100000 + 1000 * k}/{100000 + 1000 * k}_200000"
            d.mkdir(parents=True)
            field = 600 + 1400 * np.exp(
                -((yy - 0.3 - 0.1 * k) ** 2 + (xx - 0.45) ** 2) / 0.08)
            stacks[d] = (planes, (h, w))
            for z in range(planes):
                jobs.append((d / f"{z * 20:06d}.tif", field, seed + 1000 * k + z))
            k += 1

    def one(job):
        path, field, s = job
        write_u16_tiff(path, striped_tile(np.random.default_rng(s), field))

    with ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(one, j) for j in jobs]:
            f.result()
    return stacks


def stripe_power(torch, vol):
    """Mean |line mean - 31-line moving average| of log1p, along x (row
    means) and along y (column means), of a (z, h, w) stack on the card."""
    v = torch.log1p(vol.float())
    out = []
    for d in (-1, -2):
        m = v.mean(d)
        k = 31
        sm = torch.nn.functional.avg_pool1d(torch.nn.functional.pad(
            m[:, None], (k // 2, k // 2), mode="replicate"), k, 1)[:, 0]
        out.append(float((m - sm).abs().mean()))
    return out


def phase_destripe_cli(torch, dev, record, shared):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_dwt as cd
    from ipp_tpu_torch.ops import destripe as dsm
    from ipp_tpu_torch.ops import wavelets as wv
    from ipp_tpu_torch.ops.process import (ProcessConfig, _chain,
                                           process_batch_fn, process_img)
    from ipp_tpu_torch.pipeline import deconvolve as pdc
    from ipp_tpu_torch.pipeline import pystripe_cli as psc
    from ipp_tpu_torch.utils.transfer import upload

    work = ROOT / "build" / "chip_smoke_tiles"
    shutil.rmtree(work, ignore_errors=True)
    src, dst = work / "input", work / "output"
    t0 = time.perf_counter()
    stacks = make_tile_tree(src)
    t_data = time.perf_counter() - t0
    n_tiles = sum(p for p, _ in stacks.values())
    n_px = sum(p * h * w for p, (h, w) in stacks.values())
    per_shape = {}   # the executor batches tiles by shape
    for planes, shape in stacks.values():
        per_shape[shape] = per_shape.get(shape, 0) + planes
    batches = {shape: -(-n // 8) for shape, n in per_shape.items()}
    levels = {shape: dsm._plan_padding(shape, (250.0, 250.0), 0, "db9")[3]
              for shape in per_shape}
    want = sum(b * 3 * levels[shape] for shape, b in batches.items())
    batches = sum(batches.values())
    say(f"  input: {n_tiles} tiles ({n_px * 2 / 1e9:.2f} GB u16) in "
        f"{len(stacks)} stacks written in {t_data:.1f} s; levels {levels}; "
        f"{batches} batches of 8 -> expect {want} K5 launches")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cd.reset_launch_counts()
    t0 = time.perf_counter()
    rc = psc.main(["-i", str(src), "-o", str(dst), *STAGE1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cd.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rate = n_px / wall / 1e6
    card = card_line()
    say(f"  CLI rc {rc}: {n_tiles} tiles in {wall:.1f} s, {rate:.1f} Mpix/s "
        f"({card}); K5 launches {launches['dwt_analysis']}; "
        f"torch.cuda.max_memory_allocated {peak}")
    rec = record["destripe_cli"] = dict(
        tiles=n_tiles, pixels=n_px, batches=batches, levels=str(levels),
        wall_s=wall, mpix_s=rate, data_s=t_data, launches=launches,
        want_launches=want, peak_mem_bytes=peak, card=card, rc=rc)
    # rc 0 <=> the executor counted no failed tile (pystripe_cli.main)
    if rc != 0:
        raise AssertionError(f"CLI rc {rc}: some tiles failed")
    if launches["dwt_analysis"] != want:
        raise AssertionError(f"K5 launches {launches} != {want}")
    powers_in, powers_out, sampled = [], [], {}
    for d, (planes, shape) in stacks.items():
        out_d = dst / d.relative_to(src)
        outs = sorted(out_d.glob("*.tif"))
        if len(outs) != planes:
            raise AssertionError(f"{out_d}: {len(outs)} outputs, want {planes}")
        box = ((0, planes), (0, shape[0]), (0, shape[1]))
        a = pdc.TiffDirVolume(d).read_block(box)
        b = pdc.TiffDirVolume(out_d).read_block(box)
        if b.dtype != np.uint16 or b.shape != a.shape:
            raise AssertionError(f"{out_d}: output {b.dtype} {b.shape}")
        ta = torch.from_numpy(a.view(np.int16)).to(dev).to(torch.int32) & 0xFFFF
        tb = torch.from_numpy(b.view(np.int16)).to(dev).to(torch.int32) & 0xFFFF
        powers_in.append(stripe_power(torch, ta))
        powers_out.append(stripe_power(torch, tb))
        del ta, tb
        if shape not in sampled:   # 4 planes of each tile shape
            sampled[shape] = (a[:4], b[:4])
            if len(sampled) == 1:  # a whole batch, for the chain's time
                batch8 = a[:8]
    p_in = np.mean(powers_in, axis=0)
    p_out = np.mean(powers_out, axis=0)
    drop = float(p_in.sum() / max(p_out.sum(), 1e-30))
    say(f"  stripe power (along x, along y): input {p_in[0]:.3e} "
        f"{p_in[1]:.3e}, output {p_out[0]:.3e} {p_out[1]:.3e}: "
        f"{drop:.1f}x lower")
    # 8 sampled tiles (4 of each shape) through the same chain with the
    # plain DWT on the card
    cfg = ProcessConfig(sigma=(250.0, 250.0), wavelet="db9",
                        padding_mode="reflect", bidirectional=True,
                        dark=100.0)
    # and the device time of the chain on one uploaded batch of 8, with K5
    # and with the plain DWT (CUDA events; no host IO)
    xb = upload(batch8, dev)
    u16 = np.dtype(np.uint16)
    chain_ms = time_ms(torch, lambda: _chain(xb, cfg, u16), 5)
    saved = wv.dwt_analysis
    wv.dwt_analysis = cd.dwt_analysis_plain
    try:
        diffs = [int(np.abs(process_img(a, cfg).astype(np.int64)
                            - b.astype(np.int64)).max())
                 for a, b in sampled.values()]
        chain_plain_ms = time_ms(torch, lambda: _chain(xb, cfg, u16), 5)
    finally:
        wv.dwt_analysis = saved
    del xb
    say(f"  8 sampled tiles, CLI (K5) vs plain DWT on the card: max |diff| "
        f"{max(diffs)} counts")
    dev_s = batches * chain_ms / 1e3
    say(f"  device chain per batch of 8 {batch8.shape[1:]} tiles: "
        f"{chain_ms:.2f} ms with K5, {chain_plain_ms:.2f} ms with the plain "
        f"DWT; x {batches} batches = {dev_s:.2f} s of the {wall:.1f} s wall")
    rec.update(stripe_power_in=p_in.tolist(), stripe_power_out=p_out.tolist(),
               stripe_drop=drop, sample_max_diff=max(diffs),
               chain_ms=chain_ms, chain_plain_ms=chain_plain_ms,
               device_s_est=dev_s)
    if not drop > 3:
        raise AssertionError(f"stripe power dropped only {drop:.2f}x")
    if max(diffs) > 1:
        raise AssertionError(f"sampled tiles differ by {max(diffs)} counts")
    # bleach correction on: the same batch of 8 through the CLI's batch
    # callable on the card and on the CPU
    bcfg = ProcessConfig(sigma=(250.0, 250.0), wavelet="db9",
                         padding_mode="reflect", bidirectional=True,
                         dark=100.0, bleach_correction_frequency=0.01,
                         bleach_correction_clip_min=6.0,
                         bleach_correction_clip_med=7.0,
                         bleach_correction_clip_max=8.5)
    on_card = np.asarray(process_batch_fn(bcfg, dev)(batch8))
    t0 = time.perf_counter()
    on_cpu = np.asarray(process_batch_fn(bcfg, "cpu")(batch8))
    cpu_s = time.perf_counter() - t0
    plain_out = np.asarray(process_batch_fn(cfg, dev)(batch8))
    bleach_diff = int(np.abs(on_card.astype(np.int64)
                             - on_cpu.astype(np.int64)).max())
    bleach_moved = float(np.abs(on_card.astype(np.float64)
                                - plain_out.astype(np.float64)).mean())
    xb = upload(batch8, dev)
    bleach_ms = time_ms(torch, lambda: _chain(xb, bcfg, u16), 5)
    del xb
    say(f"  bleach correction on, one batch of 8 {batch8.shape[1:]} tiles: "
        f"card vs CPU max |diff| {bleach_diff} counts; device chain "
        f"{bleach_ms:.2f} ms ({chain_ms:.2f} without); mean |change| "
        f"{bleach_moved:.1f} counts; the CPU took {cpu_s:.1f} s")
    rec.update(bleach_max_diff=bleach_diff, bleach_chain_ms=bleach_ms,
               bleach_mean_change=bleach_moved, bleach_cpu_s=cpu_s)
    if (on_card.dtype != np.uint16 or on_card.shape != batch8.shape
            or bleach_diff > 1):
        raise AssertionError(f"bleach correction: card vs CPU differ by "
                             f"{bleach_diff} counts ({on_card.dtype} "
                             f"{on_card.shape})")
    if not bleach_moved > 0:
        raise AssertionError("bleach correction changed nothing")
    # lightsheet correction on: the same batch of 8 through the batch
    # callable on the card and on the CPU (u16 samples after an exact dark
    # subtraction, so both run the same counting search)
    lcfg = ProcessConfig(dark=100.0, lightsheet=True)
    on_card = np.asarray(process_batch_fn(lcfg, dev)(batch8))
    t0 = time.perf_counter()
    on_cpu = np.asarray(process_batch_fn(lcfg, "cpu")(batch8))
    ls_cpu_s = time.perf_counter() - t0
    ls_diff = int(np.abs(on_card.astype(np.int64)
                         - on_cpu.astype(np.int64)).max())
    ls_moved = float(np.abs(on_card.astype(np.float64)
                            - np.clip(batch8.astype(np.float64) - 100, 0,
                                      None)).mean())
    xb = upload(batch8, dev)
    ls_ms = time_ms(torch, lambda: _chain(xb, lcfg, u16), 5)
    del xb
    say(f"  lightsheet correction, one batch of 8 {batch8.shape[1:]} tiles: "
        f"card vs CPU max |diff| {ls_diff} counts; device chain "
        f"{ls_ms:.2f} ms; mean |change| {ls_moved:.1f} counts; the CPU "
        f"took {ls_cpu_s:.1f} s")
    rec.update(lightsheet_max_diff=ls_diff, lightsheet_chain_ms=ls_ms,
               lightsheet_mean_change=ls_moved, lightsheet_cpu_s=ls_cpu_s)
    if (on_card.dtype != np.uint16 or on_card.shape != batch8.shape
            or ls_diff > 1):
        raise AssertionError(f"lightsheet: card vs CPU differ by {ls_diff} "
                             f"counts ({on_card.dtype} {on_card.shape})")
    if not ls_moved > 0:
        raise AssertionError("lightsheet correction changed nothing")
    # phase 16 runs the CLI again on a mesh and holds it to these tiles
    shared["tiles"] = dict(src=src, dst=dst, per_shape=per_shape,
                           levels=levels, launches=want)


# -- phase 7 -----------------------------------------------------------------

def batched_cases(torch, plan, nb, gen, dev):
    """(kernel, variant, kernel_fn, plain_fn, library_fn, work) for every
    batched form at this plan's work shape and nb blocks."""
    from ipp_tpu_torch.ops import cuda_fft as cf

    nz, ny, nx = plan.shape
    kp = plan.kp
    spec = nb * kp * nz * nx

    def t(*shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo)
                + lo)

    x, den, mul = (t(nb, nz, ny, nx), t(nb, nz, ny, nx, lo=0.5),
                   t(nb, nz, ny, nx))
    sr, si = t(nb, kp, nz, nx, lo=-1), t(nb, kp, nz, nx, lo=-1)
    or_, oi = t(kp * nz, nx, lo=-1), t(kp * nz, nx, lo=-1)
    r2, i2 = sr.view(-1, nx), si.view(-1, nx)
    kx = plan._x[False]                         # the kernel's: none
    ix = stage_mats(torch, nx, False, dev)      # the plain version's
    c2 = torch.complex(r2, i2)
    otf = kp * nz * nx
    return rdft_cases(torch, cf, x, den, mul, sr, si, plan._rfwd,
                      plan._rinv) + [
        ("radix2_stage_inv_otf_batched", "otf",
         lambda: cf.radix2_stage_inv_otf_batched(r2, i2, or_, oi, *kx, False),
         lambda: cf.radix2_stage_inv_otf_plain(r2, i2, or_, oi, *ix, False),
         lambda: torch.fft.ifft(c2, dim=-1), work_stage(spec, nx, otf)),
        ("radix2_stage_inv_otf_batched", "conj",
         lambda: cf.radix2_stage_inv_otf_batched(r2, i2, or_, oi, *kx, True),
         lambda: cf.radix2_stage_inv_otf_plain(r2, i2, or_, oi, *ix, True),
         lambda: torch.fft.ifft(c2, dim=-1), work_stage(spec, nx, otf)),
    ]


def bead_blocks(torch, dev, gen, nb, shape, psf):
    """nb blocks on a floor of 1 with beads of rising density and
    amplitude, blurred by the PSF: blocks that converge at different
    iterations."""
    import numpy as np

    from ipp_tpu_torch.ops.deconv import _make_otf

    n = int(np.prod(shape))
    blocks = torch.ones((nb,) + tuple(shape), device=dev)
    for b in range(nb):
        count = int(20 * 3 ** b * n / 393216)
        idx = [torch.randint(0, s_, (count,), generator=gen, device=dev)
               for s_ in shape]
        blocks[b].index_put_(tuple(idx), torch.full(
            (count,), 3.0 * 10 ** b, device=dev), accumulate=True)
    otf = _make_otf(psf / psf.sum(), shape)
    dims = (-3, -2, -1)
    return torch.fft.irfftn(torch.fft.rfftn(blocks, dim=dims) * otf,
                            s=shape, dim=dims).clamp_(min=0).contiguous()


def phase_batched(torch, dev, shape, record):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.deconv import (_rl_fft_iterations,
                                          richardson_lucy,
                                          richardson_lucy_batched,
                                          richardson_lucy_spatial)
    from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3
    from ipp_tpu_torch.ops.psf import gaussian_psf

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows, bad = [], []
    for bshape in [(4,) + tuple(shape), (1, 512, 512, 512)]:
        nb = bshape[0]
        plan = MatmulFFT3(bshape[1:], dev)
        for name, variant, kfn, pfn, lfn, work in batched_cases(
                torch, plan, nb, gen, dev):
            check_case(torch, BATCHED[name][0], name, variant, bshape, kfn,
                       pfn, lfn, work, 3, rows, bad)
        del plan
        torch.cuda.empty_cache()
    record["batched_kernels"] = rows
    if bad:
        raise AssertionError("batched kernel != plain: " + "; ".join(bad))

    nb, halo = 4, 16
    psf = torch.from_numpy(gaussian_psf((9, 9, 9), (2.0, 2.0, 2.0))).to(dev)
    vols = torch.rand((nb,) + tuple(shape), generator=gen, device=dev) * 1000
    vox = float(np.prod(shape))

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    cf.reset_launch_counts()
    walk, t_walk = run(lambda: richardson_lucy_batched(
        vols, psf, niter=NITER, fft_shape=shape))
    counts = dict(cf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counts}
    want.update(rdft_y_fwd=1, radix2_stage=6 * NITER + 2,
                rdft_y_fwd_batched=2 * NITER, rdft_y_inv_batched=2 * NITER,
                radix2_stage_inv_otf_batched=2 * NITER)
    # each block's full-volume taper blur, on the v1 walk
    add_launches(want, *[taper_launches(shape, psf.shape, False)] * nb)
    fft, t_fft = run(lambda: richardson_lucy_batched(
        vols, psf, niter=NITER, fft_shape=shape, route="fft"))
    inner = (slice(None),) + (slice(halo, -halo),) * 3
    a, b = walk[inner], fft[inner]
    excess = float(((a - b).abs() - (0.2 + 2e-3 * b.abs())).max())
    rel_fft = float((a - b).abs().max() / b.abs().max())
    finite = bool(torch.isfinite(walk).all())
    del walk, fft, a, b
    # per block against richardson_lucy; edge_taper off on both sides,
    # since the batched taper blurs whole blocks and the single one slabs
    nt, t_nt = run(lambda: richardson_lucy_batched(
        vols, psf, niter=NITER, fft_shape=shape, edge_taper=False))
    rel_blocks, equal, t_single = [], [], 0.0
    for i in range(nb):
        one, t1 = run(lambda: richardson_lucy(
            vols[i], psf, niter=NITER, fft_shape=shape, edge_taper=False))
        t_single += t1
        rel_blocks.append(float((nt[i] - one).abs().max() / one.abs().max()))
        equal.append(bool(torch.equal(nt[i], one)))
    del nt, one
    # early stop on blocks that converge at different iterations: the RL
    # loop itself, which reports the iterations each block ran, against
    # the same loop on each block alone and the public batched call
    es_vols = bead_blocks(torch, dev, gen, nb, shape, psf)
    es_kw = dict(niter=NITER, fft_shape=tuple(shape), lam=0.0,
                 stop_criterion=1.0, regularize_interval=0, classic=True)
    psf_n = psf / psf.sum()
    (es, iters), t_es = run(lambda: _rl_fft_iterations(es_vols, psf_n,
                                                       **es_kw))
    public = richardson_lucy_batched(es_vols, psf, niter=NITER,
                                     fft_shape=shape, edge_taper=False,
                                     stop_criterion=1.0)
    rel_es = [float((public - es).abs().max() / es.abs().max())]
    single_iters = []
    for i in range(nb):
        one, k = _rl_fft_iterations(es_vols[i], psf_n, **es_kw)
        single_iters.append(k)
        rel_es.append(float((es[i] - one).abs().max() / one.abs().max()))
    del es, es_vols, one, vols, public
    torch.cuda.empty_cache()
    record["batched_rl"] = dict(
        blocks=nb, shape=list(shape), niter=NITER, launches=counts,
        want_launches=want, walk_s=t_walk, fft_s=t_fft,
        walk_mvox_s=nb * vox / t_walk / 1e6, fft_mvox_s=nb * vox / t_fft / 1e6,
        no_taper_batched_s=t_nt, no_taper_single_sum_s=t_single,
        no_taper_batched_mvox_s=nb * vox / t_nt / 1e6,
        no_taper_single_mvox_s=nb * vox / t_single / 1e6,
        rel_fft=rel_fft, tol_excess=excess, rel_blocks=rel_blocks,
        bitwise_equal=equal, early_stop_iters=iters,
        single_iters=single_iters, rel_early_stop=rel_es, es_s=t_es,
        peak_mem_bytes=peak)
    say(f"  launches {counts}")
    say(f"  batched walk {t_walk:.3f} s for {nb} blocks "
        f"({nb * vox / t_walk / 1e6:.1f} Mvox/s of work shape), torch.fft "
        f"{t_fft:.3f} s ({nb * vox / t_fft / 1e6:.1f}); max |walk-fft|/max|fft| "
        f"{rel_fft:.2e}, tolerance excess {excess:.3e}; peak {peak}")
    say(f"  no taper: batched {t_nt:.3f} s vs {nb} single blocks "
        f"{t_single:.3f} s; per block rel {max(rel_blocks):.2e}, "
        f"bitwise equal {equal}")
    say(f"  early stop (1%): batched iterations {iters}, single {single_iters}"
        f", rel {max(rel_es):.2e}, {t_es:.3f} s")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not excess <= 0:
        raise AssertionError("walk vs torch.fft outside rtol=2e-3, atol=2e-1")
    if not finite:
        raise AssertionError("non-finite batched RL output")
    if not max(rel_blocks) <= 1e-5:
        raise AssertionError(f"batched != single blocks: {rel_blocks}")
    if iters != single_iters or not max(rel_es) <= 1e-5:
        raise AssertionError(f"early stop: {iters} vs {single_iters}, "
                             f"rel {rel_es}")
    # spatial RL (direct cuDNN convolutions, TF32 off) on the card against
    # the same call on the CPU
    small = torch.rand((64, 64, 64), generator=gen, device=dev) * 1000
    psf5 = torch.from_numpy(gaussian_psf((5, 5, 5), (1.2, 1.2, 1.2)))
    sp, t_sp = run(lambda: richardson_lucy_spatial(small, psf5.to(dev),
                                                   niter=4))
    ref = richardson_lucy_spatial(small.cpu(), psf5, niter=4)
    rel_sp = float((sp.cpu() - ref).abs().max() / ref.abs().max())
    record["batched_rl"].update(spatial_rel=rel_sp, spatial_s=t_sp)
    say(f"  richardson_lucy_spatial (64^3, 5^3 PSF, 4 iterations) card vs "
        f"CPU rel {rel_sp:.2e}, {t_sp:.3f} s")
    if not rel_sp <= 1e-4:
        raise AssertionError(f"spatial RL card vs CPU rel {rel_sp:.3e}")


# -- phase 8 -----------------------------------------------------------------

def phase_adaptive_cli(torch, dev, record, shared):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.pipeline import deconvolve as pdc

    if "src" not in shared:
        raise AssertionError("phase 4 wrote no series")
    src, host, beads = shared["src"], shared["host"], shared["beads"]
    dst = src.parent / "output_adaptive"
    vol_shape = host.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cf.reset_launch_counts()
    t0 = time.perf_counter()
    rc = pdc.main(["-i", str(src), "-o", str(dst), "--niter", str(NITER),
                   "--adaptive-psf"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    vox = float(np.prod(vol_shape))
    outs = sorted(dst.glob("img_*.tif"))
    man = json.loads((dst / "blocks_manifest.json").read_text())
    nb = man.get("n_blocks")
    rec = record["adaptive_cli"] = dict(
        rc=rc, planes=len(outs), n_blocks=nb, wall_s=wall,
        core_mvox_s=vox / wall / 1e6, launches=dict(cf.LAUNCHES),
        peak_mem_bytes=peak, card=card_line())
    say(f"  CLI --adaptive-psf rc {rc}: {nb} blocks, {len(outs)} planes in "
        f"{wall:.1f} s, {vox / wall / 1e6:.2f} core Mvox/s ({rec['card']}); "
        f"walk launches {rec['launches']} (the Wiener RL runs on torch.fft); "
        f"peak {peak}")
    if rc != 0 or len(outs) != vol_shape[0]:
        raise AssertionError(f"rc {rc}, {len(outs)} planes")
    if (nb != record.get("cli", {}).get("n_blocks", nb)
            or len(man.get("quant", {})) != nb or "finished" not in man):
        raise AssertionError("manifest incomplete")
    out = pdc.TiffDirVolume(dst).read_block(tuple((0, s) for s in vol_shape))
    if out.dtype != np.uint16 or out.shape != vol_shape:
        raise AssertionError(f"output {out.dtype} {out.shape}")
    w_in = float(np.median(bead_widths(host, beads)))
    w_out = float(np.median(bead_widths(out, beads)))
    rec.update(bead_width_in=w_in, bead_width_out=w_out)
    say(f"  bead equivalent width (x, voxels, median of {len(beads)}): "
        f"input {w_in:.3f}, output {w_out:.3f}")
    if not w_out < w_in:
        raise AssertionError("beads are not sharper than in the input")
    shutil.rmtree(dst, ignore_errors=True)


# -- phase 9 -----------------------------------------------------------------

FNT_CUBE, FNT_CUBES = 128, 8   # the converter's default --fnt-cube edge


def write_nrrd_u16(path: Path, a) -> None:
    """A raw little-endian uint16 NRRD of a 3-D array."""
    z, y, x = a.shape
    head = (f"NRRD0004\ntype: uint16\ndimension: 3\nsizes: {x} {y} {z}\n"
            f"encoding: raw\nendian: little\n\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        f.write(a.astype("<u2", copy=False).tobytes())


def read_nrrd_3d(path: Path):
    """(array, header) of a raw or gzip NRRD of u16 / f32 voxels."""
    import gzip

    import numpy as np

    with open(path, "rb") as f:
        header = {}
        for line in iter(f.readline, b""):
            text = line.decode("ascii").strip()
            if not text:
                break
            if ":" in text and not text.startswith("#"):
                k, v = text.split(":", 1)
                header[k.strip()] = v.strip()
        data = f.read()
    if header.get("encoding") in ("gzip", "gz"):
        data = gzip.decompress(data)
    dtype = {"uint16": "<u2", "float": "<f4"}[header["type"]]
    sizes = [int(s) for s in header["sizes"].split()][::-1]
    return np.frombuffer(data, dtype).reshape(sizes), header


def phase_fnt(torch, dev, record, shared):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_dwt as cd
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.deconv import fft_shape_for
    from ipp_tpu_torch.pipeline import fnt_cubes as fnt
    from ipp_tpu_torch.utils.log import Logger

    if "host" not in shared:
        raise AssertionError("phase 4 wrote no series")
    host = shared["host"]
    work = ROOT / "build" / "chip_smoke_fnt"
    shutil.rmtree(work, ignore_errors=True)
    src, dst = work / "input", work / "output"
    src.mkdir(parents=True)
    e = FNT_CUBE
    Z, Y, X = host.shape
    corners = [(z, y, x) for z in (Z // 4, Z // 2) for y in (Y // 4, Y // 2)
               for x in (X // 4, X // 2)][:FNT_CUBES]
    cubes = {}
    for i, (z, y, x) in enumerate(corners):
        cubes[f"cube_{i:03d}.nrrd"] = host[z:z + e, y:y + e, x:x + e]
        write_nrrd_u16(src / f"cube_{i:03d}.nrrd", cubes[f"cube_{i:03d}.nrrd"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cd.reset_launch_counts()
    cf.reset_launch_counts()
    t0 = time.perf_counter()
    rc = fnt.main(["-i", str(src), "-o", str(dst), "--destripe",
                   "--niter", str(NITER)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = cd.LAUNCHES["dwt_analysis"]
    walk = dict(cf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # per cube: RL at the cube's work shape and the face-slab taper, with
    # the PSF the CLI builds from its default optics
    a = fnt.build_parser().parse_args(["-i", str(src), "-o", str(dst)])
    psf_shape = fnt._load_psf(
        None, tuple(a.voxel), a.na, a.nimm, a.wavelength_ex,
        a.wavelength_em, a.f_cylinder_lens, a.slit_width, False,
        Logger()).shape
    cube = (e, e, e)
    want = add_launches({k: 0 for k in walk}, *[
        rl_launches(fft_shape_for(cube, psf_shape, dev), NITER),
        taper_launches(cube, psf_shape)] * FNT_CUBES)
    vox = FNT_CUBES * e ** 3
    rec = record["fnt_cli"] = dict(
        rc=rc, cubes=FNT_CUBES, edge=e, wall_s=wall, mvox_s=vox / wall / 1e6,
        k5_launches=k5, launches=walk, want_launches=want,
        psf_shape=list(psf_shape), peak_mem_bytes=peak, card=card_line())
    say(f"  FNT CLI rc {rc}: {FNT_CUBES} cubes of {e}^3 u16 in {wall:.2f} s, "
        f"{vox / wall / 1e6:.2f} Mvox/s ({rec['card']}); K5 launches {k5}; "
        f"walk launches {walk} (work shape "
        f"{fft_shape_for(cube, psf_shape, dev)}: torch.fft); peak {peak}")
    outs = sorted(dst.glob("*.nrrd"))
    if rc != 0 or len(outs) != FNT_CUBES:
        raise AssertionError(f"rc {rc}, {len(outs)} output cubes")
    changed = 0
    for p in outs:
        a, _ = read_nrrd_3d(p)
        if a.dtype != np.uint16 or a.shape != (e, e, e):
            raise AssertionError(f"{p.name}: {a.dtype} {a.shape}")
        changed += int(not np.array_equal(a, cubes[p.name]))
    rec["changed"] = changed
    if k5 < 1:
        raise AssertionError("K5 never launched: no axial destripe ran")
    if walk != want:
        raise AssertionError(f"walk launches {walk} != {want}")
    if changed != FNT_CUBES:
        raise AssertionError(f"only {changed} cubes differ from the input")
    shutil.rmtree(work, ignore_errors=True)


# -- phase 10 ----------------------------------------------------------------

V1_CONV_SHAPES = [(256, 1024, 264), (256, 1152, 1152)]
V1_RL_BLOCK = (248, 1100, 1100)   # plans to the work shape (256, 1152, 1152)


def v1_stage_cases(torch, plan, gen, dev, seen):
    """(kernel, variant, (rows, n), kernel_fn, plain_fn, library_fn, work)
    for every stage of the v1 walk at this plan's work shape that runs K3
    (forward, radix-2 axes), K6 (the inverse over a radix-2 z) or K7 (the
    dense axes, both directions, as `_stage` calls it), each (kernel, rows, n, direction) once
    over the calls that share `seen`.  The operand is the stage's (rows, n)
    data: z runs over (y, kxp, z), y over (Z, kxp, y).  The inverse over a
    radix-2 y is K4, with the OTF product (phases 2 and 3)."""
    from ipp_tpu_torch.ops import cuda_fft as cf

    nz, ny, _ = plan.shape
    for axis, n, rows in (("z", nz, ny * plan.kxp), ("y", ny, nz * plan.kxp)):
        for forward in (True, False):
            radix = plan._radix.get((axis, forward))
            if radix is None:
                name = "cplx_matmul"
            elif forward:
                name = "radix2_stage"
            elif axis == "z":
                name = "radix2_stage_inv_last"
            else:
                continue
            if (name, rows, n, forward) in seen:
                continue
            seen.add((name, rows, n, forward))
            re = torch.rand((rows, n), generator=gen, device=dev) - 0.5
            im = torch.rand((rows, n), generator=gen, device=dev) - 0.5
            c = torch.complex(re, im)
            variant = (f"{axis} {'fwd' if forward else 'inv'} of "
                       f"{tuple(plan.shape)}")
            lib = torch.fft.fft if forward else torch.fft.ifft
            if radix is None:
                mats = plan._dense[axis, forward]
                yield (name, variant, (rows, n),
                       lambda: cf.cplx_matmul(re, im, *mats, dft=forward),
                       lambda: cf.cplx_matmul_plain(re, im, *mats),
                       lambda: lib(c, dim=-1), work_stage(rows * n, n))
            else:   # the plan holds no stage matrices on the card
                mats = stage_mats(torch, n, forward, dev)
                yield (name, variant, (rows, n),
                       lambda: cf.radix2_stage(re, im, *radix, forward, -1),
                       lambda: cf.radix2_stage_plain(re, im, *mats, forward,
                                                     -1),
                       lambda: lib(c, dim=-1), work_stage(rows * n, n))


def v1_parts_ms(torch, plan, x, otf, num, mul, eps):
    """ms of each step of one v1 convolve that is plain PyTorch, on
    tensors of the step's own shapes: the forward and inverse x matmuls,
    the layout copies of a forward transform (four) and of an inverse (two
    and the concatenation), the OTF product before the dense inverse y
    stage, and the RL update's ratio and |mul * out|."""
    k = plan.kxp
    both = torch.matmul(x, plan._fx)                     # (z, y, 2k)
    out = {"matmul_x_fwd": time_ms(torch, lambda: torch.matmul(x, plan._fx), 3),
           "matmul_x_inv": time_ms(torch, lambda: torch.matmul(both, plan._ix),
                                   3)}

    def copies_fwd():
        re = both[..., :k].movedim(-3, -1).contiguous()  # (y, k, z)
        im = both[..., k:].movedim(-3, -1).contiguous()
        return (re.transpose(-3, -1).contiguous(),       # (Z, k, y)
                im.transpose(-3, -1).contiguous())

    out["copies_fwd"] = time_ms(torch, copies_fwd, 3)
    re, im = copies_fwd()
    del both
    otf_re, otf_im = otf

    def product():
        o_im = -otf_im
        return re * otf_re - im * o_im, re * o_im + im * otf_re

    out["otf_product"] = time_ms(torch, product, 3)

    def copies_inv():
        rr = re.transpose(-3, -1).contiguous()           # (y, k, Z)
        ii = im.transpose(-3, -1).contiguous()
        return torch.cat([rr.movedim(-1, -3), ii.movedim(-1, -3)], -1)

    out["copies_inv"] = time_ms(torch, copies_inv, 3)
    del re, im
    out["ratio"] = time_ms(torch, lambda: num / torch.clamp(x, min=eps), 3)
    out["abs_mul"] = time_ms(torch, lambda: torch.abs(mul * x), 3)
    return out


def rel_max(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def k7_dense_rows(torch, dev, gen, bad):
    """K7d, K7's dense kernel (csrc/cplx_dense.cu), at K7_DENSE_CASES
    against its plain version, each case one `cplx_matmul_dense` launch;
    kernel, plain and complex torch.matmul times beside the bound."""
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.dft_mats import cplx_triple

    dense_rows = []
    for m, k, n, kind, timer in K7_DENSE_CASES:
        re = torch.rand((m, k), generator=gen, device=dev) - 0.5
        im = torch.rand((m, k), generator=gen, device=dev) - 0.5
        if kind == "random":
            mr = torch.rand((k, n), generator=gen, device=dev) - 0.5
            mi = torch.rand((k, n), generator=gen, device=dev) - 0.5
            mats = (mr, mi, mr + mi)
            del mr, mi
        else:
            mats = tuple(torch.tensor(a, device=dev)
                         for a in cplx_triple(n, True))
        dft = True if kind == "dft=True" else None
        c, cm = torch.complex(re, im), torch.complex(mats[0], mats[1])
        cf.reset_launch_counts()
        check_case(torch, K7_DENSE[1], K7_DENSE[0], kind, (m, k, n),
                   lambda: cf.cplx_matmul(re, im, *mats, dft=dft),
                   lambda: cf.cplx_matmul_plain(re, im, *mats),
                   lambda: torch.matmul(c, cm), work_cplx(m, k, n),
                   5 if m * k * n < 2 ** 34 else 2, dense_rows, bad,
                   graph_ms if timer == "graph" else time_ms)
        if set(k_ for k_, v in cf.LAUNCHES.items() if v) != {K7_DENSE[0]}:
            bad.append(f"{kind} at {(m, k, n)} did not take the dense kernel")
        del re, im, c, cm, mats
        torch.cuda.empty_cache()
    return dense_rows


def phase_v1(torch, dev, slab_shapes, record):
    import numpy as np

    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.deconv import (_rolled_psf, conv_route,
                                          edge_taper_3d, fft_shape_for,
                                          richardson_lucy)
    from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3
    from ipp_tpu_torch.ops.psf import gaussian_psf

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    psf = torch.from_numpy(gaussian_psf((9, 9, 9), (2.0, 2.0, 2.0))).to(dev)
    rl_shape = fft_shape_for(V1_RL_BLOCK, psf.shape, dev, "walk1")
    rows, bad, seen = [], [], set()
    tags = {**KERNELS, **V1}
    slab_shapes = (list(slab_shapes)
                   + taper_work_shapes((512, 512, 512), psf.shape)
                   + taper_work_shapes(V1_RL_BLOCK, psf.shape))
    for shape in (list(dict.fromkeys(slab_shapes)) + [(136, 136, 136)]
                  + V1_CONV_SHAPES[::-1]):
        plan = MatmulFFT3(shape, dev)
        for name, variant, op, kfn, pfn, lfn, work in v1_stage_cases(
                torch, plan, gen, dev, seen):
            check_case(torch, tags[name][0], name, variant, op, kfn, pfn,
                       lfn, work, 3 if op[0] * op[1] > 2 ** 26 else 5, rows,
                       bad)
            rows[-1]["work_shape"] = list(shape)
        del plan
        torch.cuda.empty_cache()
    dense_rows = k7_dense_rows(torch, dev, gen, bad)
    cf.reset_launch_counts()
    rec = record["v1"] = dict(kernels=rows, rl_shape=list(rl_shape),
                              dense=dense_rows)
    if bad:
        raise AssertionError("v1 kernel != plain: " + "; ".join(bad))

    # the v1 convolve (plain and the fused RL update) against torch.fft,
    # with a gaussian PSF as the RL convolver builds it
    eps = float(np.finfo(np.float32).eps)
    convs = []
    for shape in V1_CONV_SHAPES:
        if conv_route(shape, dev) != "fft":
            raise AssertionError(f"{shape} does not take torch.fft by "
                                 "default")
        plan = MatmulFFT3(shape, dev)
        x = torch.rand(shape, generator=gen, device=dev) * 100 + 1
        num = torch.rand(shape, generator=gen, device=dev) * 100 + 1
        mul = torch.rand(shape, generator=gen, device=dev)
        k = _rolled_psf(psf / psf.sum(), shape).contiguous()
        cf.reset_launch_counts()
        otf = plan.otf_packed(k)
        got = plan.convolve(x, otf)
        torch.cuda.synchronize()
        counts = dict(cf.LAUNCHES)
        want = add_launches({n: 0 for n in counts},
                            walk_launches(shape, 2, 1, "walk1"))
        fk = torch.fft.rfftn(k)
        ref = torch.fft.irfftn(torch.fft.rfftn(x) * fk, s=shape)
        rel = rel_max(got, ref)
        del got, ref
        got = plan.convolve(x, otf, conj=True, ratio_num=num, mul_abs=mul)
        ref = torch.abs(mul * torch.fft.irfftn(
            torch.fft.rfftn(num / torch.clamp(x, min=eps)) * torch.conj(fk),
            s=shape))
        rel_u = rel_max(got, ref)
        del got, ref
        ms = time_ms(torch, lambda: plan.convolve(x, otf), 3)
        fft_ms = time_ms(torch, lambda: torch.fft.irfftn(
            torch.fft.rfftn(x) * fk, s=shape), 3)
        x_ms = None
        if tuple(shape) == tuple(rl_shape):
            # the convolve's steps that are no kernel of this port, each
            # alone by CUDA events: the x axis as a plain matmul, the
            # layout copies, the OTF product, the RL update's arithmetic
            parts = v1_parts_ms(torch, plan, x, otf, num, mul, eps)
            x_ms = [parts["matmul_x_fwd"], parts["matmul_x_inv"]]
            rec["parts_ms"] = parts
        convs.append(dict(shape=list(shape), rel=rel, rel_update=rel_u,
                          launches=counts, ms=ms, fft_ms=fft_ms,
                          x_matmul_ms=x_ms))
        say(f"  v1 convolve {shape}: vs torch.fft rel {rel:.2e}, fused "
            f"update rel {rel_u:.2e}; {ms:.2f} ms vs torch.fft {fft_ms:.2f} "
            f"ms; launches {counts}" + (f"; x matmuls {x_ms[0]:.2f} / "
                                        f"{x_ms[1]:.2f} ms" if x_ms else ""))
        if counts != want:
            bad.append(f"convolve {shape}: launches {counts} != {want}")
        if not (rel <= 1e-4 and rel_u <= 1e-4):
            bad.append(f"convolve {shape}: rel {rel:.3e} / {rel_u:.3e}")
        del plan, x, num, mul, k, otf, fk
        torch.cuda.empty_cache()
    rec["convolve"] = convs
    if bad:
        raise AssertionError("; ".join(bad))

    # richardson_lucy on a block whose work shape leaves the v2 domain:
    # walk1 (forced; its taper blurs too) against torch.fft (the default
    # route there) at the same shape
    block = torch.rand(V1_RL_BLOCK, generator=gen, device=dev) * 1000
    if conv_route(rl_shape, dev) != "fft":
        raise AssertionError(f"{rl_shape} does not take torch.fft by default")

    def run(route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = richardson_lucy(block, psf, niter=NITER, fft_shape=rl_shape,
                              route=route)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    cf.reset_launch_counts()
    walk, t_walk0 = run("walk1")
    counts = dict(cf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = add_launches({n: 0 for n in counts},
                        rl_launches(rl_shape, NITER, "walk1"),
                        taper_launches(V1_RL_BLOCK, psf.shape, route="walk1"))
    fft, t_fft0 = run("fft")
    _, t_walk = run("walk1")
    _, t_fft = run("fft")
    taper_ms = time_ms(torch, lambda: edge_taper_3d(block, psf / psf.sum(),
                                                    route="walk1"), 2)
    halo = 16
    inner = (slice(halo, -halo),) * 3
    rel = rel_max(walk[inner], fft[inner])
    finite = bool(torch.isfinite(walk).all())
    del walk, fft, block
    torch.cuda.empty_cache()
    core = float(np.prod([s - 2 * halo for s in V1_RL_BLOCK]))
    # the kernels' share: launches x the per-call times measured above
    per_call = {(r["kernel"], r["variant"].split(" of ")[0]): r["ms"]
                for r in rows if r["work_shape"] == list(rl_shape)}
    rec["rl"] = dict(
        block=list(V1_RL_BLOCK), work_shape=list(rl_shape), niter=NITER,
        launches=counts, want_launches=want, walk_s=t_walk, fft_s=t_fft,
        walk_first_s=t_walk0, fft_first_s=t_fft0,
        walk_core_mvox_s=core / t_walk / 1e6,
        fft_core_mvox_s=core / t_fft / 1e6, max_rel_diff=rel,
        per_call_ms={" ".join(k): v for k, v in per_call.items()},
        peak_mem_bytes=peak)
    say(f"  RL {V1_RL_BLOCK} at {tuple(rl_shape)}: launches {counts}")
    say(f"  walk1 {t_walk:.3f} s/block ({core / t_walk / 1e6:.1f} core "
        f"Mvox/s), torch.fft {t_fft:.3f} s/block ({core / t_fft / 1e6:.1f}); "
        f"{t_walk / t_fft:.1f}x; max |walk1-fft|/max|fft| on the core "
        f"{rel:.2e}; per-call ms at the work shape {rec['rl']['per_call_ms']}"
        f"; peak {peak}")
    # where the block's time goes: transforms x per-call ms (an OTF and two
    # convolves an iteration: 2n + 1 forward, 2n inverse; the fused update
    # n times), the taper once, and what is left (padding, the loop's own
    # arithmetic, allocation)
    parts = rec.get("parts_ms")
    if parts is not None:
        fwd, inv = 2 * NITER + 1, 2 * NITER
        split = {
            "x matmuls": fwd * parts["matmul_x_fwd"] + inv * parts["matmul_x_inv"],
            "layout copies": fwd * parts["copies_fwd"] + inv * parts["copies_inv"],
            "OTF product": inv * parts["otf_product"],
            "RL ratio and |mul*out|": inv * parts["ratio"] + NITER * parts["abs_mul"],
            "K7 (y)": fwd * per_call.get(("cplx_matmul", "y fwd"), 0.0)
            + inv * per_call.get(("cplx_matmul", "y inv"), 0.0),
            "K3 + K6 (z)": fwd * per_call.get(("radix2_stage", "z fwd"), 0.0)
            + inv * per_call.get(("radix2_stage_inv_last", "z inv"), 0.0),
            "edge taper": taper_ms}
        split = {k: v / 1e3 for k, v in split.items()}
        split["other"] = t_walk - sum(split.values())
        rec["rl"]["split_s"] = split
        say("  walk1 block split (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) + f"; of {t_walk:.3f}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not finite or not rel <= 1e-3:
        raise AssertionError(f"walk1 RL vs torch.fft rel {rel:.3e} "
                             f"(finite {finite})")

    # the FNT cubes' work: richardson_lucy on one cube, walk1 (forced, at
    # its multiple-of-8 work shape) beside the default route (torch.fft at
    # 2,3,5,7-smooth sizes); the two pad differently, so only the times
    # are compared
    cube = torch.rand((FNT_CUBE,) * 3, generator=gen, device=dev) * 1000
    shapes = {r: fft_shape_for(cube.shape, psf.shape, dev, r)
              for r in ("walk1", None)}

    def run_cube(route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = richardson_lucy(cube, psf, niter=NITER, route=route)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for r in shapes:
        run_cube(r)
    t_cube = {r: min(run_cube(r)[1] for _ in range(2)) for r in shapes}
    out_cube = {r: run_cube(r)[0] for r in shapes}
    rel_cube = rel_max(out_cube["walk1"], out_cube[None])
    rec["cube"] = dict(edge=FNT_CUBE, walk1_shape=list(shapes["walk1"]),
                       fft_shape=list(shapes[None]), walk1_s=t_cube["walk1"],
                       fft_s=t_cube[None], max_rel_diff=rel_cube)
    say(f"  RL on a {FNT_CUBE}^3 cube: walk1 at {shapes['walk1']} "
        f"{t_cube['walk1'] * 1e3:.1f} ms, torch.fft at {shapes[None]} "
        f"{t_cube[None] * 1e3:.1f} ms ({t_cube['walk1'] / t_cube[None]:.1f}"
        f"x); max |walk1-fft|/max|fft| {rel_cube:.2e} (different padding)")
    if not all(bool(torch.isfinite(o).all()) for o in out_cube.values()):
        raise AssertionError("non-finite RL output on the cube")


# -- phase 11 ----------------------------------------------------------------

CANONICAL_SHAPES = [(40, 136, 264), (30, 50, 70)]


def phase_canonical(torch, dev, record):
    """MatmulFFT3.rfftn / irfftn / otf against torch.fft on the card: the
    first shape's y and z take K7's FFT kernel, the second's its dense
    kernel (no multiples of 8)."""
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.matmul_fft import MatmulFFT3

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rows, bad = [], []
    for shape in CANONICAL_SHAPES:
        route = {cf.dft_route(n) for n in shape[:2]}
        name = "cplx_matmul" if route == {"fft"} else "cplx_matmul_dense"
        plan = MatmulFFT3(shape, dev)
        x = torch.rand((2,) + tuple(shape), generator=gen, device=dev)
        cf.reset_launch_counts()
        re, im = plan.rfftn(x)
        back = plan.irfftn(re, im)
        o_re, o_im = plan.otf(x[0])
        torch.cuda.synchronize()
        counts = {k: v for k, v in cf.LAUNCHES.items() if v}
        ref = torch.fft.rfftn(x, dim=(-3, -2, -1))
        top = float(ref.abs().max())   # of the complex spectrum

        def err(re_, im_, want):
            return max(float((re_ - want.real).abs().max()),
                       float((im_ - want.imag).abs().max())) / top

        rel = max(err(re, im, ref), err(o_re, o_im, ref[0]))
        rel_back = rel_max(back, x)
        rows.append(dict(shape=list(shape), kernel=name, launches=counts,
                         rel=rel, rel_round_trip=rel_back))
        say(f"  rfftn / irfftn / otf at {shape} (2 volumes): vs torch.fft "
            f"rel {rel:.2e}, round trip rel {rel_back:.2e}; launches "
            f"{counts}")
        if counts != {name: 6}:
            bad.append(f"{shape}: launches {counts}, want 6 of {name}")
        if not (rel <= 1e-5 and rel_back <= 1e-5):
            bad.append(f"{shape}: rel {rel:.3e}, round trip {rel_back:.3e}")
    cf.reset_launch_counts()
    record["canonical"] = rows
    if bad:
        raise AssertionError("; ".join(bad))


# -- phase 12 ----------------------------------------------------------------

STITCH_GRID = (3, 3)            # rows x cols of stacks
STITCH_TILE = (2000, 2000)
STITCH_PLANES = 32
STITCH_OVERLAP = 200            # nominal overlap, px (10%)
STITCH_VOX = (0.41, 0.41, 2.0)  # the 15x preset's pitch (y, x) and a z step, um
STITCH_MARGIN = 8               # phantom margin = the largest jitter
STITCH_BEADS = 20000
NCC_SHAPE = (12, 150, 1024)     # pairs, overlap rows, width: a production MIP
NCC_RADIUS = 20
STITCH_FLAGS = ["--objective", "15x", "--sigma1", "250", "--sigma2", "250",
                "--wavelet", "db9", "--padding-mode", "reflect",
                "--bidirectional", "--dark", "100",
                "--downsampled-voxel", "10"]
BEAD_SIGMA = (1.5, 2.0, 2.0)    # z, y, x, px
STRIPES = 0.15                  # std of the stripe factors on 15% of rows
BEAD_HALF = (3, 6, 6)
MIN_BEADS = 1000                # isolated beads the centroid check needs


def stitch_phantom(torch, dev, shape, seed, n_beads=None):
    """A smooth field plus beads with z extent (gaussian, sigma BEAD_SIGMA)
    and gaussian noise, f32 on the card from a seeded generator; returns
    (volume, bead centres (n, 3) int64 on the host)."""
    import numpy as np

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, H, W = shape
    yy = torch.linspace(0, 1, H, device=dev)[:, None]
    xx = torch.linspace(0, 1, W, device=dev)[None, :]
    field = 500 + 900 * torch.exp(-((yy - 0.4) ** 2 + (xx - 0.55) ** 2)
                                  / 0.15)
    vol = torch.empty((D, H, W), device=dev)
    for z in range(D):
        vol[z] = field + 15 * torch.randn((H, W), generator=gen, device=dev)
    n = STITCH_BEADS if n_beads is None else n_beads
    hz, hy, hx = BEAD_HALF
    cz = torch.randint(hz, D - hz, (n,), generator=gen, device=dev)
    cy = torch.randint(hy, H - hy, (n,), generator=gen, device=dev)
    cx = torch.randint(hx, W - hx, (n,), generator=gen, device=dev)
    amp = 3000 + 5000 * torch.rand(n, generator=gen, device=dev)
    axes = []
    for h, sg in zip(BEAD_HALF, BEAD_SIGMA):
        t = torch.arange(-h, h + 1, device=dev)
        axes.append((t, torch.exp(-0.5 * (t / sg) ** 2)))
    (tz, kz), (ty, ky), (tx, kx) = axes
    k = (kz[:, None, None] * ky[None, :, None] * kx[None, None, :]).reshape(-1)
    off = ((tz[:, None, None] * H + ty[None, :, None]) * W
           + tx[None, None, :]).reshape(-1)
    centre = (cz * H + cy) * W + cx
    vol.view(-1).index_add_(0, (centre[:, None] + off[None, :]).reshape(-1),
                            (amp[:, None] * k[None, :]).reshape(-1))
    beads = torch.stack([cz, cy, cx], 1).cpu().numpy()
    return vol, beads


def write_stitch_tree(torch, dev, root, seed=12):
    """The phase-12 tile tree: a 3 x 3 grid of 32-plane stacks of 2000 x
    2000 u16 tiles cut from one phantom at known integer jitter
    (|dy|, |dx| <= 8, dz in {-1, 0, 1}; stack (0, 0) none), each tile with
    its own multiplicative stripes along x, in the SmartSPIM layout
    (folders in tenths of um at the 15x pitch, files z in tenths of um).
    Returns (phantom bead centres, {(row, col): origin (z, y, x) in the
    phantom})."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    rows, cols = STITCH_GRID
    th, tw = STITCH_TILE
    step_y, step_x = th - STITCH_OVERLAP, tw - STITCH_OVERLAP
    m = STITCH_MARGIN
    shape = (STITCH_PLANES + 2, 2 * m + (rows - 1) * step_y + th,
             2 * m + (cols - 1) * step_x + tw)
    vol, beads = stitch_phantom(torch, dev, shape, seed)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    origins, jobs = {}, []
    pool = ThreadPoolExecutor(8)
    for r in range(rows):
        for c in range(cols):
            jz, jy, jx = ((0, 0, 0) if r == c == 0 else
                          (int(rng.integers(-1, 2)),
                           int(rng.integers(-m, m + 1)),
                           int(rng.integers(-m, m + 1))))
            z0, y0, x0 = 1 + jz, m + r * step_y + jy, m + c * step_x + jx
            origins[r, c] = (z0, y0, x0)
            tile = vol[z0:z0 + STITCH_PLANES, y0:y0 + th, x0:x0 + tw]
            lines = 1 + STRIPES * torch.randn(
                (STITCH_PLANES, th, 1), generator=gen, device=dev) * (
                torch.rand((STITCH_PLANES, th, 1), generator=gen,
                           device=dev) < 0.15)
            host = (tile * lines.clamp(min=0.5)).clamp_(0, 65535).round_() \
                .to(torch.int32).cpu().numpy().astype(np.uint16)
            xt = int(c * step_x * 10 * STITCH_VOX[1])
            yt = int(r * step_y * 10 * STITCH_VOX[0])
            d = root / "Ex_488_Em_525" / f"{xt:06d}" / f"{xt:06d}_{yt:06d}"
            d.mkdir(parents=True)
            for z in range(STITCH_PLANES):
                zt = int(round(z * STITCH_VOX[2] * 10))
                jobs.append(pool.submit(write_u16_tiff, d / f"{zt:06d}.tif",
                                        host[z]))
    for f in jobs:
        f.result()
    pool.shutdown()
    del vol
    torch.cuda.empty_cache()
    return beads, origins


def bead_centroids(vol, idx):
    """Intensity-weighted centroids (n, 3) of the beads at integer
    positions idx (n, 3) of a (z, y, x) u16 volume: each window of
    BEAD_HALF around the position, less its 20th percentile."""
    import numpy as np

    hz, hy, hx = BEAD_HALF
    tz, ty, tx = (np.arange(-h, h + 1) for h in BEAD_HALF)
    win = vol[idx[:, 0, None, None, None] + tz[None, :, None, None],
              idx[:, 1, None, None, None] + ty[None, None, :, None],
              idx[:, 2, None, None, None] + tx[None, None, None, :]]
    win = win.astype(np.float64)
    bg = np.percentile(win.reshape(len(idx), -1), 20, axis=1)
    w = np.clip(win - bg[:, None, None, None], 0, None)
    tot = w.sum(axis=(1, 2, 3))
    cz = (w.sum(axis=(2, 3)) * tz).sum(1) / tot
    cy = (w.sum(axis=(1, 3)) * ty).sum(1) / tot
    cx = (w.sum(axis=(1, 2)) * tx).sum(1) / tot
    return idx + np.stack([cz, cy, cx], 1)


def phase_ncc_pairs(torch, dev, record):
    """align_pairs_batched on 12 pairs whose xy MIPs are (150, 1024) with
    search radius 20, card vs CPU, from a bead phantom made on the card."""
    import numpy as np

    from ipp_tpu_torch.ops import ncc

    P, ov, width = NCC_SHAPE
    D, V = STITCH_PLANES, 2 * ov
    vol, _ = stitch_phantom(torch, dev, (D + 4, 4 * V, 3 * width), 21,
                            STITCH_BEADS // 8)
    host = vol.clamp_(0, 65535).round_().to(torch.int32).cpu().numpy() \
        .astype(np.uint16)
    del vol
    rng = np.random.default_rng(21)
    a, b, truth = [], [], []
    for i in range(P):
        dv, dh = (int(t) for t in rng.integers(-12, 13, 2))
        dd = int(rng.integers(-1, 2))
        y0 = 20 + (i % 3) * V
        x0 = 20 + (i // 3) % 2 * width
        a.append(host[2:2 + D, y0:y0 + V, x0:x0 + width])
        b.append(host[2 + dd:2 + dd + D, y0 + V - ov + dv:y0 + 2 * V - ov + dv,
                      x0 + dh:x0 + dh + width])
        truth.append((V - ov + dv, dh, dd))
    a, b = np.stack(a), np.stack(b)
    args = (a, b, "ns", ov, NCC_RADIUS, NCC_RADIUS, NCC_RADIUS)
    ncc.align_pairs_batched(*args, device=dev)           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ncc.align_pairs_batched(*args, device=dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = ncc.align_pairs_batched(*args, device="cpu")
    cpu_s = time.perf_counter() - t0
    # the device chain alone: the three map kinds of the batch
    mips = [np.max(a[:, :, V - ov:, :], axis=1).astype(np.float32),
            np.max(b[:, :, :ov, :], axis=1).astype(np.float32)]
    m1, m2 = (torch.from_numpy(m).to(dev) for m in mips)
    r = NCC_RADIUS + min(NCC_RADIUS, ncc.S_NCC_WIDTH_MAX - 1)
    map_ms = time_ms(torch, lambda: ncc.ncc_maps_batched(m1, m2, r, r), 5)
    coords = [g.coord for g in got]
    rec = record["ncc_pairs"] = dict(
        shape=list(NCC_SHAPE), radius=NCC_RADIUS, wall_s=wall,
        pairs_s=P / wall, cpu_s=cpu_s, xy_map_ms=map_ms,
        xy_map_pairs_s=P / map_ms * 1e3, coords=coords, truth=truth,
        equal=coords == [g.coord for g in ref], card=card_line())
    say(f"  {P} pairs, xy MIPs {tuple(m1.shape[1:])}, radius {NCC_RADIUS}: "
        f"{wall * 1e3:.1f} ms ({P / wall:.0f} pairs/s with the host MIPs); "
        f"the xy maps alone {map_ms:.2f} ms on the card "
        f"({P / map_ms * 1e3:.0f} pairs/s); the CPU took {cpu_s:.2f} s; "
        f"card == CPU: {rec['equal']}; == truth: {coords == truth}")
    if not rec["equal"]:
        raise AssertionError(f"card {coords} != CPU "
                             f"{[g.coord for g in ref]}")
    if coords != truth:
        raise AssertionError(f"displacements {coords} != truth {truth}")


def phase_stitch(torch, dev, record, shared):
    import numpy as np

    from ipp_tpu_torch.geometry.stacks import TileGrid
    from ipp_tpu_torch.ops import cuda_dwt as cd
    from ipp_tpu_torch.ops import destripe as dsm
    from ipp_tpu_torch.pipeline import deconvolve as pdc
    from ipp_tpu_torch.pipeline import process_images as pim
    from ipp_tpu_torch.utils.progress import StageTimer

    phase_ncc_pairs(torch, dev, record)
    work = ROOT / "build" / "chip_smoke_stitch"
    shutil.rmtree(work, ignore_errors=True)
    src, st = work / "raw", work / "stitched"
    t0 = time.perf_counter()
    beads, origins = write_stitch_tree(torch, dev, src)
    t_data = time.perf_counter() - t0
    rows, cols = STITCH_GRID
    n_tiles = rows * cols * STITCH_PLANES
    n_px = n_tiles * STITCH_TILE[0] * STITCH_TILE[1]
    batches = -(-n_tiles // 8)
    levels = dsm._plan_padding(STITCH_TILE, (250.0, 250.0), 0, "db9")[3]
    want = batches * 3 * levels
    say(f"  input: {n_tiles} tiles ({n_px * 2 / 1e9:.2f} GB u16) in "
        f"{rows * cols} stacks written in {t_data:.1f} s; jitter "
        f"{ {k: tuple(np.subtract(v, origins[0, 0])) for k, v in origins.items()} }"
        f"; expect {want} K5 launches")

    timers = []

    class Recorded(StageTimer):   # the CLI's per-stage seconds
        def __init__(self):
            super().__init__()
            timers.append(self)

    saved = pim.StageTimer
    pim.StageTimer = Recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cd.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = pim.main(["--input", str(src), "--preprocessed",
                       str(work / "pre"), "--stitched", str(st),
                       *STITCH_FLAGS])
    finally:
        pim.StageTimer = saved
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = cd.LAUNCHES["dwt_analysis"]
    peak = torch.cuda.max_memory_allocated()
    stages = dict(timers[0].stages) if timers else {}
    card = card_line()
    rate = n_px / wall / 1e6
    say(f"  CLI rc {rc}: {n_tiles} tiles in {wall:.1f} s, {rate:.1f} Mpix/s "
        f"({card}); K5 launches {k5}; torch.cuda.max_memory_allocated "
        f"{peak}")
    say("  stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     stages.items()))
    rec = record["stitch"] = dict(
        tiles=n_tiles, pixels=n_px, wall_s=wall, mpix_s=rate, data_s=t_data,
        stages_s=stages, k5_launches=k5, want_k5=want, peak_mem_bytes=peak,
        card=card, rc=rc)
    if rc != 0:
        raise AssertionError(f"CLI rc {rc}")
    if k5 != want:
        raise AssertionError(f"K5 launches {k5} != {want}")
    # the placement: every stack's offset from stack (0, 0) is the truth
    grid = TileGrid.from_xml(st / "Ex_488_Em_525_placement.xml")
    s00 = grid.stacks[0][0]
    a00 = (s00.abs_d, s00.abs_v, s00.abs_h)
    placed, wrong = {}, []
    for r in range(rows):
        for c in range(cols):
            s = grid.stacks[r][c]
            got = tuple(np.subtract((s.abs_d, s.abs_v, s.abs_h), a00))
            want_off = tuple(np.subtract(origins[r, c], origins[0, 0]))
            placed[f"{r},{c}"] = [int(v) for v in got]
            if got != want_off:
                wrong.append(f"({r}, {c}): {got} != {want_off}")
    rec["placement"] = placed
    say(f"  placement (z, y, x from stack (0, 0)): "
        f"{'equal to the truth' if not wrong else wrong}")
    if wrong:
        raise AssertionError("placement: " + "; ".join(wrong))
    # the series: the bounding box's planes and shape, u16
    bb = grid.volume
    want_shape = (bb.z1 - bb.z0, bb.y1 - bb.y0, bb.x1 - bb.x0)
    out = pdc.TiffDirVolume(st / "Ex_488_Em_525")
    rec["series_shape"] = list(out.shape)
    if tuple(out.shape) != want_shape or out.dtype != np.uint16:
        raise AssertionError(f"series {out.shape} {out.dtype}, want "
                             f"{want_shape} uint16")
    vol = out.read_block(tuple((0, n) for n in want_shape))
    # every isolated bead well inside the union of the stacks and away from
    # tile borders: its centroid in the stitched planes within 0.5 px of
    # where the truth puts it
    shift = np.add(np.subtract(a00, origins[0, 0]),
                   (-bb.z0, -bb.y0, -bb.x0))
    pos = beads + shift
    lo_z = max(o[0] for o in origins.values()) - origins[0, 0][0] + a00[0] \
        - bb.z0 + BEAD_HALF[0] + 1
    hi_z = min(o[0] for o in origins.values()) - origins[0, 0][0] + a00[0] \
        - bb.z0 + STITCH_PLANES - BEAD_HALF[0] - 2
    keep = ((pos[:, 0] >= lo_z) & (pos[:, 0] <= hi_z)
            & (pos[:, 1] >= 3 * STITCH_MARGIN)
            & (pos[:, 1] < want_shape[1] - 3 * STITCH_MARGIN)
            & (pos[:, 2] >= 3 * STITCH_MARGIN)
            & (pos[:, 2] < want_shape[2] - 3 * STITCH_MARGIN))
    counts = [int(keep.sum())]
    th, tw = STITCH_TILE
    for z0, y0, x0 in origins.values():   # away from every tile border
        for e, ax in ((y0, 1), (y0 + th, 1), (x0, 2), (x0 + tw, 2)):
            keep &= np.abs(beads[:, ax] - e) > 12
    # isolated: no other bead closer than 4 half-windows + 2 on every axis
    from scipy.spatial import cKDTree

    sep = np.asarray([4 * h + 2 for h in BEAD_HALF], np.float64)
    close = cKDTree(beads / sep).query_pairs(1.0 - 1e-9, p=np.inf,
                                             output_type="ndarray")
    counts.append(int(keep.sum()))
    keep[close.reshape(-1)] = False
    counts.append(int(keep.sum()))
    say(f"  beads: {len(beads)}; inside {counts[0]}, away from tile borders "
        f"{counts[1]}, isolated {counts[2]}")
    idx = pos[keep].astype(np.int64)
    if len(idx) < MIN_BEADS:
        raise AssertionError(f"only {len(idx)} isolated beads to check")
    cen = bead_centroids(vol, idx)
    err = np.abs(cen - idx)
    worst = float(err.max()) if len(err) else float("nan")
    bias = (cen - idx).mean(0)
    rec.update(beads_checked=int(keep.sum()), bead_err_max=worst,
               bead_err_mean=[float(v) for v in err.mean(0)],
               bead_bias=[float(v) for v in bias])
    say(f"  {int(keep.sum())} isolated beads: centroid vs truth max "
        f"{worst:.3f} px, mean |error| (z, y, x) "
        f"{tuple(round(float(v), 4) for v in err.mean(0))}, mean error "
        f"{tuple(round(float(v), 4) for v in bias)}")
    if not worst <= 0.5:
        raise AssertionError(f"bead centroids: {len(err)} checked, worst "
                             f"{worst:.3f} px")
    # the npz at the planned shape
    npz = sorted(st.glob("Ex_488_Em_525_zyx*.npz"))
    vz, vy, vx = STITCH_VOX[2], STITCH_VOX[0], STITCH_VOX[1]
    planned = tuple(max(1, int(round(n / (10.0 / v)))) for n, v in
                    zip(want_shape, (vz, vy, vx)))
    got_npz = np.load(npz[0], allow_pickle=True)["I"].shape if npz else None
    rec["npz_shape"] = got_npz
    say(f"  npz {npz[0].name if npz else None}: {got_npz} (planned "
        f"{planned})")
    if got_npz != planned:
        raise AssertionError(f"npz {got_npz} != {planned}")
    # phase 16 stitches the raw tree again on a mesh: keep it and the series
    shutil.rmtree(work / "pre", ignore_errors=True)
    shared["stitch"] = dict(src=src, stitched=st, k5=k5, batches=batches,
                            levels=levels)


# -- phase 13 ----------------------------------------------------------------

COMP_GRID = (2, 2)              # rows x cols of stacks per channel
COMP_PLANES = 16
COMP_BEADS = 9000
# (channel, its content's shift against the phantom, (dz, dy, dx) px): red
# is merge_channels' reference, green is moved onto it
COMP_CHANNELS = (("Ex_647_Em_690", (0, 0, 0)),
                 ("Ex_561_Em_600", (1, -4, 6)))
COMP_FLAGS = ["--objective", "15x", "--sigma1", "250", "--sigma2", "250",
              "--wavelet", "db9", "--padding-mode", "reflect",
              "--bidirectional", "--dark", "100", "--rgb-composite"]


def write_composite_tree(torch, dev, root, seed=13):
    """Two channels of one phantom in the SmartSPIM layout: a 2 x 2 grid
    of 16-plane stacks of 2000 x 2000 u16 tiles per channel, the tiles cut
    at the same jittered origins (as phase 12's), the second channel's
    content shifted by its known (dz, dy, dx), each tile with its own
    stripes along x."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    rows, cols = COMP_GRID
    th, tw = STITCH_TILE
    step_y, step_x = th - STITCH_OVERLAP, tw - STITCH_OVERLAP
    m = STITCH_MARGIN + max(max(abs(v) for v in s) for _, s in COMP_CHANNELS)
    shape = (COMP_PLANES + 4, 2 * m + (rows - 1) * step_y + th,
             2 * m + (cols - 1) * step_x + tw)
    vol, _ = stitch_phantom(torch, dev, shape, seed, COMP_BEADS)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    jobs = []
    pool = ThreadPoolExecutor(8)
    for r in range(rows):
        for c in range(cols):
            jz, jy, jx = ((0, 0, 0) if r == c == 0 else
                          (int(rng.integers(-1, 2)),
                           int(rng.integers(-STITCH_MARGIN, STITCH_MARGIN + 1)),
                           int(rng.integers(-STITCH_MARGIN, STITCH_MARGIN + 1))))
            z0, y0, x0 = 2 + jz, m + r * step_y + jy, m + c * step_x + jx
            xt = int(c * step_x * 10 * STITCH_VOX[1])
            yt = int(r * step_y * 10 * STITCH_VOX[0])
            for ch, (sz, sy, sx) in COMP_CHANNELS:
                tile = vol[z0 - sz:z0 - sz + COMP_PLANES,
                           y0 - sy:y0 - sy + th, x0 - sx:x0 - sx + tw]
                lines = 1 + STRIPES * torch.randn(
                    (COMP_PLANES, th, 1), generator=gen, device=dev) * (
                    torch.rand((COMP_PLANES, th, 1), generator=gen,
                               device=dev) < 0.15)
                host = (tile * lines.clamp(min=0.5)).clamp_(0, 65535) \
                    .round_().to(torch.int32).cpu().numpy().astype(np.uint16)
                d = root / ch / f"{xt:06d}" / f"{xt:06d}_{yt:06d}"
                d.mkdir(parents=True)
                for z in range(COMP_PLANES):
                    zt = int(round(z * STITCH_VOX[2] * 10))
                    jobs.append(pool.submit(write_u16_tiff,
                                            d / f"{zt:06d}.tif", host[z]))
    for f in jobs:
        f.result()
    pool.shutdown()
    del vol
    torch.cuda.empty_cache()


def roll_zero(a, shift):
    """a (z, y, x) moved by integer `shift` with zeros shifted in."""
    import numpy as np

    out = np.zeros_like(a)
    src, dst = [], []
    for n, s in zip(a.shape, shift):
        src.append(slice(max(0, -s), n - max(0, s)))
        dst.append(slice(max(0, s), n - max(0, -s)))
    out[tuple(dst)] = a[tuple(src)]
    return out


def read_series(d):
    """The TIFF planes of a directory, stacked on the host."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ipp_tpu_torch.io import tiff as tio

    with ThreadPoolExecutor(8) as pool:
        return np.stack(list(pool.map(tio.imread,
                                      sorted(Path(d).glob("*.tif")))))


def phase_composite(torch, dev, record):
    """process_images --rgb-composite on two channels, the second shifted:
    the offsets, the composite against a host recomputation, ECC card vs
    CPU on the same sections, exact K5 launches."""
    import numpy as np

    from ipp_tpu_torch.ops import cuda_dwt as cd
    from ipp_tpu_torch.ops import destripe as dsm
    from ipp_tpu_torch.pipeline import align_channels as ac
    from ipp_tpu_torch.pipeline import merge_channels as mc
    from ipp_tpu_torch.pipeline import process_images as pim
    from ipp_tpu_torch.utils.progress import StageTimer

    work = ROOT / "build" / "chip_smoke_composite"
    shutil.rmtree(work, ignore_errors=True)
    src, st = work / "raw", work / "stitched"
    t0 = time.perf_counter()
    write_composite_tree(torch, dev, src)
    t_data = time.perf_counter() - t0
    (ref_ch, _), (mov_ch, shift) = COMP_CHANNELS
    rows, cols = COMP_GRID
    n_tiles = 2 * rows * cols * COMP_PLANES
    n_px = n_tiles * STITCH_TILE[0] * STITCH_TILE[1]
    levels = dsm._plan_padding(STITCH_TILE, (250.0, 250.0), 0, "db9")[3]
    want_k5 = 2 * -(-(rows * cols * COMP_PLANES) // 8) * 3 * levels
    want_off = tuple(-v for v in shift)
    say(f"  input: 2 channels x {rows * cols} stacks x {COMP_PLANES} planes "
        f"of {STITCH_TILE} u16 ({n_px * 2 / 1e9:.2f} GB) written in "
        f"{t_data:.1f} s; {mov_ch} shifted by {shift}: expect offsets "
        f"{want_off} and {want_k5} K5 launches")

    timers, aligned = [], []

    class Recorded(StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    def align_recorded(*a, **k):
        t = time.perf_counter()
        out = real_align(*a, **k)
        aligned.append((out[1], time.perf_counter() - t))
        return out

    saved, real_align = pim.StageTimer, mc.align_volumes
    pim.StageTimer, mc.align_volumes = Recorded, align_recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cd.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = pim.main(["--input", str(src), "--preprocessed",
                       str(work / "pre"), "--stitched", str(st),
                       *COMP_FLAGS])
    finally:
        pim.StageTimer, mc.align_volumes = saved, real_align
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = cd.LAUNCHES["dwt_analysis"]
    peak = torch.cuda.max_memory_allocated()
    stages = {}
    for i, tm in enumerate(timers):
        for k, v in tm.stages.items():
            stages[f"{i}:{k}"] = v
    t_align = sum(s for _, s in aligned)
    card = card_line()
    say(f"  CLI rc {rc}: {n_tiles} tiles in {wall:.1f} s, "
        f"{n_px / wall / 1e6:.1f} Mpix/s ({card}); channel alignment "
        f"{t_align:.2f} s, offsets {[o for o, _ in aligned]}; K5 launches "
        f"{k5}; torch.cuda.max_memory_allocated {peak}")
    say("  stages (s, channel:stage): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    rec = record["composite"] = dict(
        tiles=n_tiles, pixels=n_px, wall_s=wall, data_s=t_data,
        stages_s=stages, align_s=t_align,
        offsets=[list(o) for o, _ in aligned], want_offsets=list(want_off),
        k5_launches=k5, want_k5=want_k5, peak_mem_bytes=peak, card=card,
        rc=rc)
    if rc != 0:
        raise AssertionError(f"CLI rc {rc}")
    if k5 != want_k5:
        raise AssertionError(f"K5 launches {k5} != {want_k5}")
    if [o for o, _ in aligned] != [want_off]:
        raise AssertionError(f"offsets {[o for o, _ in aligned]} != "
                             f"[{want_off}]")
    # the composite: the reference channel's plane count, and each plane
    # the host recomputation from the two stitched series and the offsets
    t0 = time.perf_counter()
    red, green = (read_series(st / ch) for ch, _ in COMP_CHANNELS)
    comp_dir = st / "composite"
    names = sorted(p.name for p in comp_dir.glob("composite_*.tif"))
    rec["composite_planes"] = len(names)
    if len(names) != red.shape[0] or red.shape != green.shape:
        raise AssertionError(f"{len(names)} composite planes for series "
                             f"{red.shape} / {green.shape}")
    want = np.zeros(red.shape + (3,), np.uint16)
    want[..., 0] = red
    want[..., 1] = roll_zero(green, want_off)
    comp = read_series(comp_dir)
    t_check = time.perf_counter() - t0
    if comp.shape != want.shape or not np.array_equal(comp, want):
        bad = (int((comp != want).any(axis=(1, 2, 3)).sum())
               if comp.shape == want.shape else comp.shape)
        raise AssertionError(f"composite != recomputation ({bad} planes)")
    # ECC on the sections merge_channels aligned: card vs CPU
    ref = mc._load_central_block(st / ref_ch)
    mov = mc._load_central_block(st / mov_ch)
    secs = list(zip(ac._central_slices(ref), ac._central_slices(mov)))
    card_ms, cpu_ms, card_f, cpu_f = [], [], [], []
    for a, b in secs:
        ac._ecc_translation(a, b, dev)                 # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_f.append(ac._ecc_translation(a, b, dev))
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        cpu_f.append(ac._ecc_translation(a, b, "cpu"))
        cpu_ms.append((time.perf_counter() - t0) * 1e3)
    card_int = ac.get_offsets_ecc(ref, mov, dev)
    # get_offsets_ecc's rounding of the CPU's per-section translations
    (dy1, dx1), (dz1, dx2), (dz2, dy2) = cpu_f
    cpu_int = tuple(int(round((a + b) / 2.0)) for a, b in
                    ((dz1, dz2), (dy1, dy2), (dx1, dx2)))
    diff = max(abs(x - y) for c, p in zip(card_f, cpu_f)
               for x, y in zip(c, p))
    rec.update(ecc_card_ms=card_ms, ecc_cpu_ms=cpu_ms,
               ecc_sections=[list(a.shape) for a, _ in secs],
               ecc_card=card_f, ecc_cpu=cpu_f, ecc_max_diff_px=diff,
               offsets_card=list(card_int), offsets_cpu=list(cpu_int),
               check_s=t_check)
    say(f"  composite: {len(names)} planes of {comp.shape[1:]} equal to the "
        f"recomputation from the stitched series ({t_check:.1f} s)")
    say("  ECC per section " + ", ".join(
        f"{tuple(a.shape)}: card {c:.1f} ms, CPU {p:.0f} ms" for (a, _), c, p
        in zip(secs, card_ms, cpu_ms))
        + f"; |card - CPU| <= {diff:.2e} px; get_offsets_ecc card "
        f"{card_int}, CPU {cpu_int} ({card})")
    if not diff <= 0.02:
        raise AssertionError(f"ECC card vs CPU differs by {diff} px")
    if card_int != cpu_int or card_int != shift:
        # the first call sees the whole shift (align_volumes then moves
        # the channel by its negative)
        raise AssertionError(f"get_offsets_ecc card {card_int}, CPU "
                             f"{cpu_int}, shift {shift}")
    shutil.rmtree(work, ignore_errors=True)


# -- phase 14 ----------------------------------------------------------------

CONV_PLANES = 64
CONV_VOXEL = (2.0, 1.8, 1.8)    # z, y, x um
CONV_TARGET = 10.0              # -dt, um
CONV_CHECK = (0, 21, 42, 63)    # planes held against the CPU
CONV_FLAGS = ["--destripe", "--sigma1", "250", "--sigma2", "250",
              "--wavelet", "db9", "--voxel", *map(str, CONV_VOXEL),
              "-dt", str(CONV_TARGET), "--terafly", "-zl", "0"]


class StageClock:
    """Seconds spent in wrapped calls, by stage name."""

    def __init__(self):
        self.s = {}

    def wrap(self, name, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[name] = self.s.get(name, 0.0) + (
                    time.perf_counter() - t0)
        return timed


def phase_convert(torch, dev, record, shared):
    """The converter CLI with --destripe, -dt 10 and a TeraFly export on
    a striped 64-plane 2000 x 2000 u16 series."""
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    import numpy as np

    from ipp_tpu_torch.io.terafly import TeraFlyVolume
    from ipp_tpu_torch.ops import cuda_dwt as cd
    from ipp_tpu_torch.ops import destripe as dsm
    from ipp_tpu_torch.ops.process import process_img
    from ipp_tpu_torch.ops.resample import IsotropicAccumulator
    from ipp_tpu_torch.pipeline import convert as conv
    from ipp_tpu_torch.stitch.merge import downsampled_npz

    work = ROOT / "build" / "chip_smoke_convert"
    shutil.rmtree(work, ignore_errors=True)
    src, out = work / "in", work / "tif"
    src.mkdir(parents=True)
    h, w = STITCH_TILE
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    field = 600 + 1400 * np.exp(-((yy - 0.4) ** 2 + (xx - 0.5) ** 2) / 0.08)
    t0 = time.perf_counter()
    raw = {}

    def one(z):
        img = striped_tile(np.random.default_rng(140 + z), field)
        write_u16_tiff(src / f"img_{z:06d}.tif", img)
        if z in CONV_CHECK:
            raw[z] = img

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(CONV_PLANES)))
    t_data = time.perf_counter() - t0
    levels = dsm._plan_padding(STITCH_TILE, (250.0, 250.0), 0, "db9")[3]
    # plane 0 goes first on its own (the downsample's geometry), then
    # batches of 8
    batches = 1 + -(-(CONV_PLANES - 1) // conv._BATCH)
    want_k5 = batches * 3 * levels
    n_px = CONV_PLANES * h * w
    say(f"  input: {CONV_PLANES} striped u16 planes of {STITCH_TILE} "
        f"written in {t_data:.1f} s; expect {want_k5} K5 launches")

    clock, seen = StageClock(), {}
    real = SimpleNamespace(
        open=conv._open_source, batch=conv.process_batch_fn,
        acc=conv.IsotropicAccumulator, terafly=conv.tif_series_to_terafly,
        tio=conv.tio, convert=conv.convert)

    def open_timed(*a, **k):
        reader, nz = real.open(*a, **k)
        return clock.wrap("read", reader), nz

    class Fetch:   # the device result's wait, timed where the CLI reads it
        def __init__(self, handle):
            self.handle = handle

        def copy_to_host_async(self):
            self.handle.copy_to_host_async()

        def __array__(self, dtype=None, copy=None):
            return clock.wrap("device wait", np.asarray)(self.handle, dtype)

    def batch_timed(*a, **k):
        run = real.batch(*a, **k)
        return lambda *b, **c: Fetch(clock.wrap("device dispatch", run)(
            *b, **c))

    class Acc(real.acc):
        def add(self, plane):
            return clock.wrap("downsample", super().add)(plane)

    def convert_seen(*a, **k):
        seen["cfg"] = a[2]
        return real.convert(*a, **k)

    conv._open_source, conv.process_batch_fn = open_timed, batch_timed
    conv.IsotropicAccumulator, conv.convert = Acc, convert_seen
    conv.tif_series_to_terafly = clock.wrap("terafly export", real.terafly)
    conv.tio = SimpleNamespace(**{k: getattr(real.tio, k) for k in
                                  dir(real.tio) if not k.startswith("__")})
    conv.tio.imwrite = clock.wrap("write", real.tio.imwrite)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cd.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = conv.main(["-i", str(src), "-o", str(out), *CONV_FLAGS])
    finally:
        conv._open_source, conv.process_batch_fn = real.open, real.batch
        conv.IsotropicAccumulator, conv.convert = real.acc, real.convert
        conv.tif_series_to_terafly, conv.tio = real.terafly, real.tio
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = cd.LAUNCHES["dwt_analysis"]
    peak = torch.cuda.max_memory_allocated()
    card = card_line()
    stages = dict(clock.s)
    stages["other"] = wall - sum(stages.values())
    say(f"  CLI rc {rc}: {CONV_PLANES} planes in {wall:.1f} s, "
        f"{n_px / wall / 1e6:.1f} Mpix/s ({card}); K5 launches {k5}; "
        f"torch.cuda.max_memory_allocated {peak}")
    say("  stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     stages.items()))
    rec = record["convert"] = dict(
        planes=CONV_PLANES, pixels=n_px, wall_s=wall, mpix_s=n_px / wall / 1e6,
        data_s=t_data, stages_s=stages, k5_launches=k5, want_k5=want_k5,
        peak_mem_bytes=peak, card=card, rc=rc)
    if rc != 0:
        raise AssertionError(f"CLI rc {rc}")
    if k5 != want_k5:
        raise AssertionError(f"K5 launches {k5} != {want_k5}")
    planes = sorted(out.glob("img_*.tif"))
    if len(planes) != CONV_PLANES:
        raise AssertionError(f"{len(planes)} planes written")
    shared["convert_series"] = out
    series = read_series(out)
    if series.dtype != np.uint16 or series.shape[1:] != (h, w):
        raise AssertionError(f"series {series.shape} {series.dtype}")
    # four planes against the same chain on the CPU
    t0 = time.perf_counter()
    cpu = process_img(np.stack([raw[z] for z in CONV_CHECK]), seen["cfg"],
                      device="cpu")
    t_cpu = time.perf_counter() - t0
    d1 = int(np.abs(cpu.astype(np.int64)
                    - series[list(CONV_CHECK)].astype(np.int64)).max())
    # the downsample against its recomputation on the CPU from the series
    acc = IsotropicAccumulator((h, w), CONV_VOXEL, CONV_TARGET,
                               alternating=False, device="cpu")
    for z in range(CONV_PLANES):
        acc.add(series[z])
    acc.flush()
    npz_cpu = downsampled_npz(acc.volume(), work / "cpu.npz", CONV_VOXEL,
                              series.shape, CONV_TARGET, device="cpu")
    got = np.load(work / f"tif_zyx{CONV_TARGET:.1f}um.npz",
                  allow_pickle=True)["I"]
    want = np.load(npz_cpu, allow_pickle=True)["I"]
    dn = float(np.abs(got - want).max()) / float(np.abs(want).max())
    tf = TeraFlyVolume(work / "tif_terafly")
    tf_ok = all(np.array_equal(tf[z], series[z]) for z in CONV_CHECK)
    rec.update(cpu_planes_max_diff=d1, cpu_s=t_cpu, npz_shape=list(got.shape),
               npz_rel_diff=dn, terafly_level0_equal=tf_ok)
    say(f"  planes {CONV_CHECK} vs the CPU: max |diff| {d1} count(s) (CPU "
        f"{t_cpu:.1f} s); npz {got.shape} vs its CPU recomputation: "
        f"{dn:.2e} of max; TeraFly level 0 == series: {tf_ok}")
    if d1 > 1:
        raise AssertionError(f"planes differ from the CPU by {d1}")
    if got.shape != want.shape or not dn <= 1e-4:
        raise AssertionError(f"npz {got.shape} vs {want.shape}: {dn}")
    if not tf_ok:
        raise AssertionError("TeraFly level 0 != the series")


# -- phase 15 ----------------------------------------------------------------

SCAN_TILE = (2048, 2048)        # the Dragonfly's planes
SCAN_GRID = (2, 2)              # x, y stack columns
SCAN_SUB, SCAN_NSUB = 16, 2     # planes per piezo substack, substacks
SCAN_OVERLAP = 200
SCAN_ZSTEP = 12                 # stepper advance between substacks, px
SCAN_FLAGS = ["--voxel-size", "1,1,1", "--z-step", str(SCAN_ZSTEP),
              "--piezo-distance", str(SCAN_SUB), "--x-slop", "10",
              "--y-slop", "10", "--z-slop", "3", "--dark", "100",
              "--threshold", "0.5", "--rounds", "1", "--compression", "0"]


def write_scan_tree(torch, dev, root, seed=15):
    """A Dragonfly X / X_Y / Z tree (coordinates in tenths of um at 1 um
    voxels; plane names continue across a column's substacks, so a gap
    of SCAN_SUB um starts the next substack) cut from one phantom at known
    jitter (|dx|, |dy| <= 8, |dz| <= 1; substack (0, 0, 0) none).
    Returns {(xi, yi, zi): (x0, y0, z0)} in the phantom."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    nx, ny = SCAN_GRID
    th, tw = SCAN_TILE
    step_x, step_y = tw - SCAN_OVERLAP, th - SCAN_OVERLAP
    m = STITCH_MARGIN
    shape = (SCAN_ZSTEP * (SCAN_NSUB - 1) + SCAN_SUB + 4,
             2 * m + (ny - 1) * step_y + th, 2 * m + (nx - 1) * step_x + tw)
    vol, _ = stitch_phantom(torch, dev, shape, seed, COMP_BEADS)
    rng = np.random.default_rng(seed)
    truth, jobs = {}, []
    pool = ThreadPoolExecutor(8)
    for xi in range(nx):
        for yi in range(ny):
            d = root / f"{xi * step_x * 10}" / \
                f"{xi * step_x * 10}_{yi * step_y * 10}"
            d.mkdir(parents=True)
            for zi in range(SCAN_NSUB):
                jx, jy, jz = ((0, 0, 0) if xi == yi == zi == 0 else
                              (int(rng.integers(-m, m + 1)),
                               int(rng.integers(-m, m + 1)),
                               int(rng.integers(-1, 2))))
                x0, y0 = m + xi * step_x + jx, m + yi * step_y + jy
                z0 = 2 + zi * SCAN_ZSTEP + jz
                truth[xi, yi, zi] = (x0, y0, z0)
                host = vol[z0:z0 + SCAN_SUB, y0:y0 + th, x0:x0 + tw] \
                    .clamp(0, 65535).round().to(torch.int32).cpu().numpy() \
                    .astype(np.uint16)
                for p in range(SCAN_SUB):
                    jobs.append(pool.submit(
                        write_u16_tiff,
                        d / f"{(zi * SCAN_SUB + p) * 10:06d}.tif", host[p]))
    for f in jobs:
        f.result()
    pool.shutdown()
    del vol
    torch.cuda.empty_cache()
    return truth


def phase_scan_tsv(torch, dev, record, shared):
    """scan_stitch on a Dragonfly tree (positions vs the truth and the
    CPU), then tsv_tools downsample on phase 14's series (vs the host
    block reduction)."""
    import io
    import os

    import numpy as np

    from ipp_tpu_torch.io import tiff as tio
    from ipp_tpu_torch.pipeline import scan_stitch as ss
    from ipp_tpu_torch.pipeline import tsv_tools as tsv
    from ipp_tpu_torch.stitch.scan import Scanner

    work = ROOT / "build" / "chip_smoke_scan"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "tree"
    t0 = time.perf_counter()
    truth = write_scan_tree(torch, dev, root)
    t_data = time.perf_counter() - t0
    n_px = len(truth) * SCAN_SUB * SCAN_TILE[0] * SCAN_TILE[1]
    say(f"  input: {len(truth)} substacks of {SCAN_SUB} x {SCAN_TILE} u16 "
        f"({n_px * 2 / 1e9:.2f} GB) written in {t_data:.1f} s")
    clock = StageClock()
    real = (Scanner.align_all_stacks, Scanner.imread)
    Scanner.align_all_stacks = clock.wrap("align", real[0])
    # blend: the CLI's writer threads' blending, summed over the threads
    Scanner.imread = clock.wrap("blend (thread-summed)", real[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = ss.main(["--input", str(root), *SCAN_FLAGS, "--output-pattern",
                      str(work / "out" / "img_%04d.tif"),
                      "--stack-offset-output", str(work / "offsets.json"),
                      "--stacks", str(work / "stacks.json")])
    finally:
        Scanner.align_all_stacks, Scanner.imread = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    card = card_line()
    placed = {tuple(d["key"]): (d["x0"], d["y0"], d["z0"]) for d in
              json.loads((work / "stacks.json").read_text())}
    k0 = (0, 0, 0)
    rel = {k: tuple(np.subtract(p, placed[k0])) for k, p in placed.items()}
    want = {k: tuple(np.subtract(t, truth[k0])) for k, t in truth.items()}
    n_out = len(list((work / "out").glob("img_*.tif")))
    stages = dict(clock.s)
    say(f"  scan_stitch rc {rc}: {len(placed)} substacks in {wall:.1f} s, "
        f"{n_px / wall / 1e6:.1f} Mpix/s ({card}), {n_out} planes; "
        f"torch.cuda.max_memory_allocated {peak}")
    say("  stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     stages.items()))
    # the alignment again on the CPU from the same tree
    t0 = time.perf_counter()
    saved = os.environ.get("IPP_TPU_PLATFORM")
    os.environ["IPP_TPU_PLATFORM"] = "cpu"
    try:
        args = ss.parse_args(["--input", str(root), *SCAN_FLAGS,
                              "--output-pattern", "unused"])
        sc = Scanner(ss.discover_scan_stacks(
            root, (1.0, 1.0, 1.0), z_stepper_distance=args.z_step,
            piezo_distance=args.piezo_distance),
            dark=float(args.dark), slop=(args.y_slop, args.x_slop,
                                         args.z_slop),
            min_support=args.min_support)
        sc.align_all_stacks(rounds=args.rounds)
        links = io.StringIO()
        ss._dump_offsets(sc, links)
    finally:
        if saved is None:
            os.environ.pop("IPP_TPU_PLATFORM")
        else:
            os.environ["IPP_TPU_PLATFORM"] = saved
    t_cpu = time.perf_counter() - t0
    coords = [(d["k0"], d["k1"], d["coord"]) for d in
              json.loads((work / "offsets.json").read_text())["links"]]
    coords_cpu = [(d["k0"], d["k1"], d["coord"]) for d in
                  json.loads(links.getvalue())["links"]]
    rec = record["scan"] = dict(
        substacks=len(placed), pixels=n_px, wall_s=wall,
        mpix_s=n_px / wall / 1e6, data_s=t_data, stages_s=stages,
        cpu_align_s=t_cpu, peak_mem_bytes=peak, card=card, rc=rc,
        placed={",".join(map(str, k)): list(map(int, v))
                for k, v in rel.items()},
        links_equal_cpu=coords == coords_cpu, planes=n_out)
    say(f"  positions from substack (0, 0, 0): "
        f"{'equal to the truth' if rel == want else rel}; links card == "
        f"CPU: {coords == coords_cpu} (CPU alignment {t_cpu:.1f} s)")
    if rc != 0:
        raise AssertionError(f"scan_stitch rc {rc}")
    if rel != want:
        raise AssertionError(f"positions {rel} != truth {want}")
    if coords != coords_cpu:
        raise AssertionError(f"links card {coords} != CPU {coords_cpu}")
    # tsv_tools downsample on phase 14's series, vs the host reduction
    src = shared.get("convert_series")
    if src is None:
        raise AssertionError("phase 14 wrote no series")
    t0 = time.perf_counter()
    rc = tsv.main(["downsample", "--src", str(src), "--dest",
                   str(work / "ds"), "--compression", "0"])
    t_ds = time.perf_counter() - t0
    names = sorted(p.name for p in src.glob("*.tif"))

    def same(n):   # skimage's block_reduce(sum), cast back as the tool does
        img = tio.imread(src / n)
        hh, ww = img.shape
        want_ds = img.reshape(hh // 2, 2, ww // 2, 2).astype(np.int64) \
            .sum(axis=(1, 3)).astype(np.uint16)
        return img.size, np.array_equal(tio.imread(work / "ds" / n), want_ds)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        checked = list(pool.map(same, names))
    n_ds = sum(k for k, _ in checked)
    bad = [n for n, (_, ok) in zip(names, checked) if not ok]
    rec.update(tsv_downsample_s=t_ds, tsv_downsample_planes=len(names),
               tsv_downsample_bad=bad)
    say(f"  tsv_tools downsample rc {rc}: {len(names)} planes in "
        f"{t_ds:.1f} s, {n_ds / t_ds / 1e6:.1f} Mpix/s; equal to the host "
        f"block sum: {not bad} ({card})")
    if rc != 0 or bad:
        raise AssertionError(f"downsample rc {rc}, planes off: {bad}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(src.parent, ignore_errors=True)


# -- phase 16 ----------------------------------------------------------------

# z-sharded RL: two z slabs of 240 planes, each extended by 4-plane halos
# (the 9^3 PSF's half) to (248, 248, 248), a (256, 256, 256) work shape on
# the v2 walk; cut from the phase-4 series
MESH_ZRL_SHAPE = (480, 248, 248)
MESH_PSF = ((9, 9, 9), (1.5, 1.5, 1.5))
# the multi-process children (one card each): NCC maps, and z-sharded RL
# on one (240, 120, 248) slab a process, (256, 128, 256) on the v2 walk
CHILD_MAPS = (8, 150, 1024)
CHILD_SLAB = (240, 120, 248)


def smoke_mesh(torch):
    """Phase 16's mesh: every card when there are several, else two
    entries on card 0 (two shards and two dispatch threads on one card)."""
    from ipp_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() > 1:
        return make_mesh(), "distinct cards"
    return make_mesh(devices=["cuda:0", "cuda:0"]), "two shards on card 0"


class DefaultMesh:
    """Within the block, `parallel.mesh.default_mesh()` gives `mesh`: the
    CLIs then take the branch they take on a host with that many cards."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        from ipp_tpu_torch.parallel import mesh as mm

        self.saved = mm.default_mesh
        mm.default_mesh = lambda: (self.mesh, 1 if self.mesh else 4)

    def __exit__(self, *exc):
        from ipp_tpu_torch.parallel import mesh as mm

        mm.default_mesh = self.saved


def timed_cli(torch, mesh, fn, argv, out: Path):
    """Wall seconds of fn(argv) with default_mesh() giving (mesh, 1) (None:
    one card, (None, 4)), its StageTimer seconds where it has one; the
    output directory `out` is removed after."""
    from ipp_tpu_torch.pipeline import process_images as pim
    from ipp_tpu_torch.utils.progress import StageTimer

    timers = []

    class Recorded(StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    saved = pim.StageTimer
    pim.StageTimer = Recorded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with DefaultMesh(mesh):
            rc = fn(argv)
    finally:
        pim.StageTimer = saved
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    if rc != 0:
        raise AssertionError(f"rc {rc} in a timing run")
    return wall, (dict(timers[0].stages) if timers else {})


def planes_max_diff(a_dir: Path, b_dir: Path, pattern="*.tif"):
    """(files, max |a - b| over every file of b_dir, files missing in a)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ipp_tpu_torch.io import tiff as tio

    names = sorted(p.relative_to(b_dir) for p in b_dir.rglob(pattern))
    missing = [n for n in names if not (a_dir / n).exists()]

    def one(n):
        a, b = tio.imread(a_dir / n), tio.imread(b_dir / n)
        if a.shape != b.shape or a.dtype != b.dtype:
            return 1 << 30
        return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())

    with ThreadPoolExecutor(8) as pool:
        diffs = list(pool.map(one, [n for n in names if n not in missing]))
    return len(names), max(diffs, default=0), missing


def mesh_k5_launches(n_tiles_by_shape, levels, n_dev, batch_size=8):
    """K5 launches of the tile chain on a mesh of n_dev entries: every
    batch (batch_size rounded to a multiple of n_dev; a short one padded
    to it) splits into n_dev shards, each running 3 launches a level."""
    bs = max(batch_size, n_dev) // n_dev * n_dev
    return sum(-(-n // bs) * n_dev * 3 * levels[shape]
               for shape, n in n_tiles_by_shape.items())


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_child(rank: int, nprocs: int, port: int, out: str) -> int:
    """One of `nprocs` processes over NCCL, each seeing one card (over
    gloo with CPU entries under IPP_TPU_PLATFORM=cpu, to rehearse): the
    sharded NCC maps with their all-gather and z-sharded RL with halos
    across the process boundaries; writes this process's rows to `out`."""
    import os

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from ipp_tpu_torch.ops.deconv import richardson_lucy_sharded_z
    from ipp_tpu_torch.ops.ncc import _ncc_maps_sharded
    from ipp_tpu_torch.ops.psf import gaussian_psf
    from ipp_tpu_torch.parallel import distributed as D
    from ipp_tpu_torch.parallel.mesh import z_sharding

    local = (["cpu"] if os.environ.get("IPP_TPU_PLATFORM", "").lower()
             == "cpu" else None)
    if not D.initialize(f"127.0.0.1:{port}", nprocs, rank):
        return 1
    a, b, zv = child_inputs(nprocs)
    maps = _ncc_maps_sharded(a, b, 20, 20,
                             D.global_mesh(local_devices=local))
    mesh_z = D.global_mesh(z_parallel=nprocs, local_devices=local)
    lo, hi = D.process_slice(zv.shape[0])
    g = D.device_put_global(zv[lo:hi], z_sharding(mesh_z, 3))
    out_z = richardson_lucy_sharded_z(g, gaussian_psf(*MESH_PSF), mesh_z,
                                      niter=NITER)
    zrows = torch.cat([t.cpu() for t in out_z.local_tensors()]).numpy()
    np.savez(out, maps=maps, zrl=zrows, lo=lo, hi=hi,
             backend=D.backend())
    torch.distributed.destroy_process_group()
    return 0


def child_inputs(nprocs: int):
    """The children's inputs, the same in every process."""
    import numpy as np

    rng = np.random.default_rng(16)
    a = rng.random(CHILD_MAPS).astype(np.float32)
    b = (np.roll(a, (3, -2), axis=(1, 2))
         + rng.normal(0, 0.01, CHILD_MAPS)).astype(np.float32)
    zv = (rng.random((CHILD_SLAB[0] * nprocs,) + CHILD_SLAB[1:])
          * 1000).astype(np.float32)
    return a, b, zv


def mesh_processes(torch, devices, work: Path):
    """len(devices) processes (one card each: CUDA_VISIBLE_DEVICES; or CPU
    entries): their NCC maps and z-sharded RL against one process on
    `devices`.  Returns (record, errors)."""
    import os

    import numpy as np

    from ipp_tpu_torch.ops.deconv import richardson_lucy_sharded_z
    from ipp_tpu_torch.ops.ncc import _ncc_maps_sharded
    from ipp_tpu_torch.ops.psf import gaussian_psf
    from ipp_tpu_torch.parallel.mesh import make_mesh

    n = len(devices)
    port = free_port()
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for rank in range(n):
        env = dict(os.environ)
        if torch.device(devices[rank]).type == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(torch.device(
                devices[rank]).index)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-child",
             str(rank), str(n), str(port), str(work / f"rank{rank}.npz")],
            env=env))
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    t_child = time.perf_counter() - t0
    if rcs != [0] * n:
        return {}, [f"{n} processes exited {rcs}"]
    d = [np.load(work / f"rank{r}.npz") for r in range(n)]
    a, b, zv = child_inputs(n)
    maps = _ncc_maps_sharded(a, b, 20, 20, None,
                             device=torch.device(devices[0]))
    one = richardson_lucy_sharded_z(
        zv, gaussian_psf(*MESH_PSF),
        make_mesh(n, z_parallel=n, devices=devices),
        niter=NITER).cpu().numpy()
    zrl = np.concatenate([x["zrl"] for x in d])
    map_err = max(float(np.abs(x["maps"] - maps).max()) for x in d)
    z_err = float(np.abs(zrl - one).max() / np.abs(one).max())
    rec = dict(processes=n, s=t_child, map_err=map_err, zrl_err=z_err,
               backend=str(d[0]["backend"]))
    say(f"  {n} processes over {rec['backend']} ({t_child:.1f} s): NCC "
        f"maps max |diff| to one process {map_err:.2e}, z-sharded RL "
        f"{z_err:.2e} of max")
    shutil.rmtree(work, ignore_errors=True)
    if not (map_err <= 1e-6 and z_err <= 1e-5):
        return rec, [f"{n} processes: maps {map_err}, z RL {z_err}"]
    return rec, []


def phase_mesh(torch, psf_zyx, record, shared):
    """The port's multi-device branches on the card(s): the deconvolution
    CLI, z-sharded RL, process_images, the pystripe CLI, and
    torch.distributed, each held to its single-device phase."""
    import numpy as np

    from ipp_tpu_torch.geometry.stacks import TileGrid
    from ipp_tpu_torch.ops import cuda_dwt as cd
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops.deconv import (fft_shape_for,
                                          richardson_lucy_batched,
                                          richardson_lucy_sharded_z)
    from ipp_tpu_torch.ops.matmul_fft import in_kernel_domain
    from ipp_tpu_torch.ops.psf import gaussian_psf
    from ipp_tpu_torch.parallel import distributed as D
    from ipp_tpu_torch.parallel.mesh import data_sharding, gather, make_mesh
    from ipp_tpu_torch.pipeline import deconvolve as pdc
    from ipp_tpu_torch.pipeline import process_images as pim
    from ipp_tpu_torch.pipeline import pystripe_cli as psc

    for key in ("cli_out", "tiles", "stitch"):
        if key not in shared:
            raise AssertionError(f"an earlier phase left no {key}")
    n_cards = torch.cuda.device_count()
    mesh, kind = smoke_mesh(torch)
    n_dev = mesh.size
    card = card_line()
    say(f"  mesh {mesh.shape} over {[str(d) for d in mesh.devices.flat]} "
        f"({kind}; torch.cuda.device_count() {n_cards}; {card})")
    rec = record["mesh"] = dict(cards=n_cards, kind=kind, shape=mesh.shape,
                                card=card)
    dev = torch.device("cuda", 0)
    errors = []

    # (a) the deconvolution CLI on phase 4's series
    src = shared["src"]
    ref_dir = shared["cli_out"]
    dst = src.parent / "output_mesh"
    cf.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with DefaultMesh(mesh):
        rc = pdc.main(["-i", str(src), "-o", str(dst), "--niter",
                       str(NITER)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cf.LAUNCHES)
    want = record["cli"]["launches"]
    man = json.loads((dst / "blocks_manifest.json").read_text())
    n_planes, diff, missing = planes_max_diff(dst, ref_dir, "img_*.tif")
    wall4 = record["cli"]["wall_s"]
    rec["deconvolve"] = dict(
        rc=rc, wall_s=wall, phase4_wall_s=wall4, wall_ratio=wall / wall4,
        speedup_per_card=wall4 / wall / n_cards,
        launches=counts, planes=n_planes, max_diff=diff,
        manifest_mesh=man["params"]["mesh"],
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    say(f"  (a) deconvolution CLI rc {rc}: {wall:.1f} s against phase 4's "
        f"{wall4:.1f} s (x{wall / wall4:.3f}; {card}); {n_planes} planes, "
        f"max |diff| to phase 4 {diff} counts; launches equal phase 4's: "
        f"{counts == want}; manifest mesh {man['params']['mesh']}")
    if rc != 0 or missing or diff > 1:
        errors.append(f"(a) rc {rc}, missing {missing[:3]}, diff {diff}")
    if counts != want:
        errors.append(f"(a) launches {counts} != phase 4's {want}")
    if man["params"]["mesh"] != mesh.shape:
        errors.append(f"(a) manifest mesh {man['params']['mesh']}")
    shutil.rmtree(dst, ignore_errors=True)
    # in turns on the same series: one card, then the mesh again
    argv = ["-i", str(src), "-o", str(dst), "--niter", str(NITER)]
    one, _ = timed_cli(torch, None, pdc.main, argv, dst)
    again, _ = timed_cli(torch, mesh, pdc.main, argv, dst)
    rec["deconvolve"].update(turns_s=dict(mesh=[wall, again], one=one))
    say(f"  (a) in turns: mesh {wall:.1f} s, one card {one:.1f} s, mesh "
        f"{again:.1f} s ({card})")

    # (b) z-sharded RL over a z mesh, against the same overlap-discard
    # decomposition slab by slab on one device
    zdevs = (["cuda:0", "cuda:1"] if n_cards > 1 else ["cuda:0"] * 2)
    zmesh = make_mesh(2, z_parallel=2, devices=zdevs)
    Z, H, W = MESH_ZRL_SHAPE
    vol = shared["host"][:Z, :H, :W].astype(np.float32)
    psf = gaussian_psf(*MESH_PSF).astype(np.float32)
    psf = psf / psf.sum()
    halo, step = MESH_PSF[0][0] // 2, Z // 2
    fshape = fft_shape_for((step + 2 * halo, H, W), psf.shape, None)
    if not in_kernel_domain(fshape):
        raise AssertionError(f"slab work shape {fshape} is off the walk")
    cf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = richardson_lucy_sharded_z(vol, psf, zmesh, niter=NITER)
    torch.cuda.synchronize()
    t_z = time.perf_counter() - t0
    counts_z = dict(cf.LAUNCHES)
    cf.reset_launch_counts()
    t0 = time.perf_counter()
    ref = torch.empty((Z, H, W), device=dev)
    for i in range(2):
        z0, z1 = i * step, (i + 1) * step
        idx = np.clip(np.arange(z0 - halo, z1 + halo), 0, Z - 1)
        blk = torch.from_numpy(vol[idx]).to(dev)
        ref[z0:z1] = richardson_lucy_batched(
            blk[None], psf, niter=NITER, fft_shape=fshape, edge_taper=True,
            device=dev)[0, halo:halo + step]
    torch.cuda.synchronize()
    t_serial = time.perf_counter() - t0
    counts_serial = dict(cf.LAUNCHES)
    t0 = time.perf_counter()   # warm: the first run built the constants
    richardson_lucy_sharded_z(vol, psf, zmesh, niter=NITER)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    zerr = float((got - ref).abs().max() / ref.abs().max())
    batched = {k: counts_z.get(k, 0) for k in BATCHED}
    rec["sharded_z"] = dict(shape=list(MESH_ZRL_SHAPE), work_shape=fshape,
                            s=t_z, warm_s=t_warm, serial_s=t_serial,
                            err_of_max=zerr,
                            launches=counts_z, serial_launches=counts_serial)
    say(f"  (b) richardson_lucy_sharded_z {MESH_ZRL_SHAPE} over {zdevs}, "
        f"slabs at {fshape}: {t_z:.3f} s first, {t_warm:.3f} s warm (slab "
        f"by slab on one card {t_serial:.3f} s; {card}); max |diff| / max "
        f"{zerr:.2e}; "
        f"batched launches {batched}, equal to the serial run's: "
        f"{counts_z == counts_serial}")
    if not zerr <= 1e-5:
        errors.append(f"(b) z-sharded RL off by {zerr:.2e} of max")
    if counts_z != counts_serial or 0 in batched.values():
        errors.append(f"(b) launches {counts_z} != {counts_serial}")
    del got, ref

    # (c) process_images on phase 12's tree
    st = shared["stitch"]
    work = st["src"].parent / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--input", str(st["src"]), "--preprocessed", str(work / "pre"),
            "--stitched", str(work / "stitched"), *STITCH_FLAGS]
    cd.reset_launch_counts()
    wall, stages = timed_cli(torch, mesh, pim.main, argv, work / "pre")
    k5 = cd.LAUNCHES["dwt_analysis"]
    n_tiles = STITCH_GRID[0] * STITCH_GRID[1] * STITCH_PLANES
    want_k5 = mesh_k5_launches({STITCH_TILE: n_tiles},
                               {STITCH_TILE: st["levels"]}, n_dev)
    ch = "Ex_488_Em_525"
    grid = TileGrid.from_xml(work / "stitched" / f"{ch}_placement.xml")
    s00 = grid.stacks[0][0]
    placed = {f"{r},{c}": [int(v) for v in np.subtract(
        (s.abs_d, s.abs_v, s.abs_h), (s00.abs_d, s00.abs_v, s00.abs_h))]
        for r, row in enumerate(grid.stacks) for c, s in enumerate(row)}
    n_planes, diff, missing = planes_max_diff(work / "stitched" / ch,
                                              st["stitched"] / ch)
    wall12 = record["stitch"]["wall_s"]
    rec["stitch"] = dict(wall_s=wall, phase12_wall_s=wall12,
                         k5=k5, want_k5=want_k5, phase12_k5=st["k5"],
                         placement_equal=placed == record["stitch"][
                             "placement"], planes=n_planes, max_diff=diff)
    say(f"  (c) process_images rc 0: {wall:.1f} s against phase 12's "
        f"{wall12:.1f} s ({card}); placement equal to phase 12's: "
        f"{placed == record['stitch']['placement']}; {n_planes} planes, max "
        f"|diff| {diff} counts; K5 launches {k5} (phase 12's {st['k5']} "
        f"split over {n_dev} shards: {want_k5})")
    if missing or diff > 1:
        errors.append(f"(c) missing {missing[:3]}, diff {diff}")
    if placed != record["stitch"]["placement"]:
        errors.append(f"(c) placement {placed}")
    if k5 != want_k5:
        errors.append(f"(c) K5 launches {k5} != {want_k5}")
    shutil.rmtree(work, ignore_errors=True)
    # in turns on the same tree: one card, then the mesh again
    one, one_st = timed_cli(torch, None, pim.main, argv, work)
    again, again_st = timed_cli(torch, mesh, pim.main, argv, work)
    rec["stitch"].update(stages_s=stages, turns_s=dict(
        mesh=[wall, again], one=one, one_stages=one_st,
        mesh_stages=again_st))
    say(f"  (c) stages (s) of the mesh run: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    say(f"  (c) in turns: mesh {wall:.1f} s, one card {one:.1f} s "
        f"(merge {one_st.get('merge (step 6)', 0):.2f}, preprocess "
        f"{one_st.get('preprocess', 0):.2f}), mesh {again:.1f} s (merge "
        f"{again_st.get('merge (step 6)', 0):.2f}, preprocess "
        f"{again_st.get('preprocess', 0):.2f}) ({card})")

    # (d) the pystripe CLI on phase 6's tree
    tl = shared["tiles"]
    dst = tl["src"].parent / "output_mesh"
    cd.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with DefaultMesh(mesh):
        rc = psc.main(["-i", str(tl["src"]), "-o", str(dst), *STAGE1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = cd.LAUNCHES["dwt_analysis"]
    want_k5 = mesh_k5_launches(tl["per_shape"], tl["levels"], n_dev)
    n_tiles, diff, missing = planes_max_diff(dst, tl["dst"])
    wall6 = record["destripe_cli"]["wall_s"]
    rec["destripe"] = dict(rc=rc, wall_s=wall, phase6_wall_s=wall6, k5=k5,
                           want_k5=want_k5, phase6_k5=tl["launches"],
                           tiles=n_tiles, max_diff=diff)
    say(f"  (d) pystripe CLI rc {rc}: {wall:.1f} s against phase 6's "
        f"{wall6:.1f} s ({card}); {n_tiles} tiles, max |diff| {diff} "
        f"counts; K5 launches {k5} (phase 6's {tl['launches']} split over "
        f"{n_dev} shards: {want_k5})")
    if rc != 0 or missing or diff > 1:
        errors.append(f"(d) rc {rc}, missing {missing[:3]}, diff {diff}")
    if k5 != want_k5:
        errors.append(f"(d) K5 launches {k5} != {want_k5}")
    shutil.rmtree(dst, ignore_errors=True)

    # (e) torch.distributed: a one-rank NCCL group over localhost TCP
    t0 = time.perf_counter()
    multi = D.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    backend = D.backend()
    gmesh = D.global_mesh()
    rows = np.arange(8 * gmesh.size * 6, dtype=np.float32).reshape(
        8 * gmesh.size, 6)
    placed_ok = bool(np.array_equal(gather(D.device_put_global(
        rows, data_sharding(gmesh, 2))).cpu().numpy(), rows))
    t = torch.arange(12.0, device=dev)
    gathered_ok = bool(torch.equal(D.all_gather(t), t))
    slice_ok = D.process_slice(10) == (0, 10)
    torch.distributed.destroy_process_group()
    t_dist = time.perf_counter() - t0
    rec["distributed"] = dict(backend=backend, multi=multi,
                              put_gather=placed_ok, all_gather=gathered_ok,
                              process_slice=slice_ok, s=t_dist)
    say(f"  (e) one-rank {backend} group: device_put_global / gather "
        f"{placed_ok}, all_gather {gathered_ok}, process_slice {slice_ok} "
        f"in {t_dist:.1f} s ({card})")
    if backend != "nccl" or multi or not (placed_ok and gathered_ok
                                          and slice_ok):
        errors.append(f"(e) {rec['distributed']}")
    if n_cards > 1:
        rec["two_process"], errs = mesh_processes(
            torch, ["cuda:0", "cuda:1"], ROOT / "build" / "chip_smoke_dist")
        say(f"  (e) two processes over NCCL ({card})")
        errors += [f"(e) {e}" for e in errs]
    else:
        say("  (e) one card: the two-process NCCL exchange needs two cards "
            "(NCCL refuses two ranks on one card); the CPU tests run it "
            "over gloo")
    if errors:
        raise AssertionError("; ".join(errors))


# -- main ---------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        say("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    if not (ROOT / "ipp_tpu_torch" / "__init__.py").exists():
        say(f"FAIL: the ipp_tpu_torch package is not beside {__file__}")
        return 1
    sys.path.insert(0, str(ROOT))
    import ipp_tpu_torch  # noqa: F401
    from ipp_tpu_torch.ops import cuda_fft as cf
    from ipp_tpu_torch.ops._build import build_info, load_library
    from ipp_tpu_torch.ops.psf import make_psf

    say(f"card: {card_line()}")
    dev = torch.device("cuda", 0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    record, failed = {"card": card_line()}, []

    def phase(num, title, fn, *a):
        say(f"phase {num}: {title}")
        t0 = time.perf_counter()
        try:
            # phases 1-15 are one card's runs on a host with any number of
            # cards (the CLIs' default mesh is none); phase 16 sets its own
            with DefaultMesh(None) if num < 16 else contextlib.nullcontext():
                fn(*a)
            say(f"phase {num}: ok in {time.perf_counter() - t0:.1f} s")
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc(file=sys.stdout)
            say(f"phase {num}: FAILED after {time.perf_counter() - t0:.1f} s")
            failed.append(num)
        record.setdefault("phase_s", {})[num] = time.perf_counter() - t0

    def build():
        load_library()
        info = build_info()
        say(f"  built {info['path']} in {info['seconds']:.1f} s")
        for line in ptxas_summary(info["ptxas"]):
            say(f"  {line}")
        record["build"] = info

    phase(1, "build the CUDA kernels", build)
    if 1 in failed:
        return 1
    psf_xyz, _, _ = make_psf(dxy=406.0, dz=800.0)
    psf = psf_xyz.transpose(2, 1, 0)
    from ipp_tpu_torch.pipeline import deconvolve as pdc

    plans, halo, planned = pdc.autosplit(VOL_SHAPE, psf.shape,
                                         strict_accuracy=True,
                                         kernel_domain=True)
    cli_shape = pdc._fft_shape_for_backend(
        pdc.fft_work_shape(plans, halo, planned))
    shapes = [(256, 256, 256), (512, 512, 512), (768, 256, 768)]
    if tuple(cli_shape) not in shapes:
        shapes.append(tuple(cli_shape))
    phase(2, f"kernels vs plain at {shapes}", phase_kernels, torch, dev,
          shapes, tuple(cli_shape), record)
    phase(3, f"richardson_lucy (512,512,512), {RL_MIXED_SHAPE} and "
          f"{RL_LARGE_SHAPE}, the convolves at {CONV_MIXED_SHAPE} and "
          f"{CONV_LARGE_SHAPE}: walk vs torch.fft",
          lambda: (phase_rl_block(torch, dev, record),
                   phase_rl_route(torch, dev, record, "mixed",
                                  RL_MIXED_SHAPE, CONV_MIXED_SHAPE, 1),
                   phase_rl_route(torch, dev, record, "large",
                                  RL_LARGE_SHAPE, CONV_LARGE_SHAPE, 2)))
    # the phase-4 series and output (phases 8, 9, 16), phase 6's and
    # phase 12's trees and outputs (phase 16), phase 14's series (15)
    shared = {}
    phase(4, f"CLI on a {VOL_SHAPE} u16 series", phase_cli, torch, dev, psf,
          record, shared)
    phase(5, "K5 dwt_analysis vs plain", phase_dwt, torch, dev, record)
    phase(6, "pystripe CLI on a 272-tile tree", phase_destripe_cli, torch, dev,
          record, shared)
    phase(7, f"batched walk at (4,) + {tuple(cli_shape)} and (1, 512, 512, "
          "512), richardson_lucy_batched", phase_batched, torch, dev,
          tuple(cli_shape), record)
    phase(8, "CLI --adaptive-psf on the phase-4 series", phase_adaptive_cli,
          torch, dev, record, shared)
    phase(9, f"FNT-cube CLI on {FNT_CUBES} u16 cubes of {FNT_CUBE}^3",
          phase_fnt, torch, dev, record, shared)
    phase(10, f"the v1 walk: K6 and K7 vs plain, the v1 convolve, "
          f"richardson_lucy on a {V1_RL_BLOCK} block", phase_v1, torch, dev,
          taper_work_shapes(cli_shape, psf.shape), record)
    phase(11, f"rfftn / irfftn / otf vs torch.fft at {CANONICAL_SHAPES}",
          phase_canonical, torch, dev, record)
    phase(12, f"NCC pairs at {NCC_SHAPE}, then process_images on a "
          f"{STITCH_GRID[0]} x {STITCH_GRID[1]} grid of {STITCH_PLANES}-plane "
          f"stacks of {STITCH_TILE} u16", phase_stitch, torch, dev, record,
          shared)
    phase(13, f"process_images --rgb-composite on two channels of a "
          f"{COMP_GRID[0]} x {COMP_GRID[1]} grid of {COMP_PLANES}-plane stacks "
          f"of {STITCH_TILE} u16", phase_composite, torch, dev, record)
    phase(14, f"convert --destripe -dt {CONV_TARGET} --terafly on "
          f"{CONV_PLANES} planes of {STITCH_TILE} u16", phase_convert, torch,
          dev, record, shared)
    phase(15, f"scan_stitch on a Dragonfly tree of {SCAN_GRID[0]} x "
          f"{SCAN_GRID[1]} x {SCAN_NSUB} substacks of {SCAN_TILE}, then "
          f"tsv_tools downsample", phase_scan_tsv, torch, dev, record, shared)
    phase(16, f"the mesh on {torch.cuda.device_count()} card(s): the "
          f"deconvolution, z-sharded RL, the stitch, the destripe CLI, "
          f"torch.distributed", phase_mesh, torch, psf, record, shared)
    for d in ("chip_smoke", "chip_smoke_tiles", "chip_smoke_stitch"):
        shutil.rmtree(ROOT / "build" / d, ignore_errors=True)
    peaks = {k: v["peak_mem_bytes"] for k, v in record.items()
             if isinstance(v, dict) and "peak_mem_bytes" in v}
    say(f"peak device memory by phase (torch.cuda.max_memory_allocated, "
        f"bytes): {peaks}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                        default=str))
    if "jax" in sys.modules:
        say("FAIL: jax was imported")
        failed.append("jax")
    if failed:
        say(f"FAIL: phases {failed}")
        return 1
    main_shape = list(cli_shape)

    def entry(tag, name, source, replaces, launches, rows, at):
        return dict(
            name=f"{tag} {name}", route="cuda",
            source=(STAGE_SOURCE if name in STAGE_KERNELS
                    else DFT_SOURCE if name == "cplx_matmul"
                    else RDFT_SOURCE if name in RDFT_KERNELS else source),
            replaces=replaces, launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=at["ms"],
            plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by=at["bound_by"], library_ms=at["library_ms"])

    kernels = []
    for name, (tag, replaces) in KERNELS.items():
        rows = [r for r in record["kernels"] + record["rdft_forms"]["kernels"]
                if r["kernel"] == name]
        at = [r for r in rows if r["shape"] == main_shape][0]
        kernels.append(entry(tag, name, SOURCE, replaces,
                             record["cli"]["launches"][name], rows, at))
    # the dense GEMM kernels of K1 and K2, held at the same shape through
    # the route without the keyword: on no main path, so their count is 0
    off_path = set(RDFT_DENSE)
    for name, (tag, replaces) in RDFT_DENSE.items():
        rows = [r for r in record["kernels"] + record["rdft_dense"]["kernels"]
                if r["kernel"] in (name, name.replace("_dense",
                                                      "_batched_dense"))]
        at = [r for r in rows if r["shape"] == main_shape
              and r["variant"] == "plain"][0]
        kernels.append(entry(tag, name, RDFT_DENSE_SOURCE, replaces,
                             record["cli"]["launches"][name], rows, at))
    for name, (tag, replaces) in BATCHED.items():
        rows = [r for r in record["batched_kernels"] if r["kernel"] == name]
        at = [r for r in rows if r["shape"] == [4] + main_shape][0]
        kernels.append(entry(tag, name, SOURCE, replaces,
                             record["batched_rl"]["launches"][name], rows,
                             at))
    # K5 at the destripe CLI's padded tile batch, along x (one launch)
    dwt_rows = [r for r in record["dwt"] if "ms" in r]
    at = [r for r in dwt_rows if r["axis"] == -1 and r["wavelet"] == "db9"
          and r["shape"] == list(DWT_MAIN_SHAPE)][0]
    tag, name = DWT_KERNEL[0].split()
    kernels.append(entry(tag, name, DWT_KERNEL[1], DWT_KERNEL[2],
                         record["destripe_cli"]["launches"]["dwt_analysis"],
                         dwt_rows, at))
    # K6 and K7 at the v1 RL block's work shape (K6: the inverse z stage,
    # K7: the FFT kernel on the forward y stage), launches from that RL run
    v1 = record["v1"]
    rl_shape = v1["rl_shape"]
    for name, (tag, replaces) in V1.items():
        rows = [r for r in v1["kernels"] if r["kernel"] == name]
        at = [r for r in rows if r["work_shape"] == rl_shape][0]
        kernels.append(entry(tag, name, SOURCE, replaces,
                             v1["rl"]["launches"][name], rows, at))
    # K7's dense kernel: launches of phase 11's transforms at a shape with
    # no FFT plan (0 on every other path, as the phases checked), times at
    # their y product
    name, tag, replaces = K7_DENSE
    dense_launches = sum(r["launches"].get(name, 0)
                         for r in record["canonical"])
    at = [r for r in v1["dense"] if r["shape"] == [2160, 50, 50]][0]
    kernels.append(entry(tag, name, K7_DENSE_SOURCE, replaces,
                         dense_launches, v1["dense"], at))
    # the mixed-radix and large-axis stage kernels at their RL blocks'
    # forward x stages, their launches those of phase 3's RL runs at
    # RL_MIXED_SHAPE and RL_LARGE_SHAPE; the dense stage kernels (for
    # lengths without an FFT plan) on no main path
    stage_rows = record["stage_times"]
    for (tag, name, source, replaces), route, rl_shape in (
            (STAGE_MIXED, "mixed", RL_MIXED_SHAPE),
            (STAGE_LARGE, "large", RL_LARGE_SHAPE)):
        rows = [r for r in stage_rows if r["route"] == route]
        at = [r for r in rows if r["variant"] == "fwd x"
              and r["shape"] == [16 * rl_shape[0] if route == "large"
                                 else 136 * rl_shape[0], rl_shape[2]]][0]
        kernels.append(entry(tag, name, source, replaces,
                             record["rl_" + route]["entry_launches"], rows,
                             at))
    rows = [r for r in stage_rows if r["route"] == "dense"]
    off_path.add(STAGE_DENSE[1])
    kernels.append(entry(*STAGE_DENSE[:3], STAGE_DENSE[3], sum(
        v for k, v in record["cli"]["launches"].items()
        if k.startswith("radix2_stage") and k.endswith("_dense")), rows,
        rows[0]))
    if any(k["launches"] == 0 for k in kernels
           if k["name"].split()[1] not in off_path):
        say("FAIL: a kernel of the path was never launched")
        return 1
    if any(k["launches"] != 0 for k in kernels
           if k["name"].split()[1] in off_path):
        say("FAIL: the main path launched a dense kernel of K1, K2 or a "
            "stage")
        return 1
    say(f"card: {card_line()}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(int(sys.argv[2]), int(sys.argv[3]),
                            int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
