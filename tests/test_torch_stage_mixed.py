"""The radix-2 stage as a mixed-radix FFT with a run-time plan
(ipp_tpu_torch/csrc/stage_mixed.cuh), on the CPU.

The kernel runs only on a card.  What is held here:
- `emulate_stage_mixed`, a step-by-step PyTorch emulation of the kernel's
  last-axis forms: the permuted load of the inverse with the OTF product
  (data row r taking OTF row r % orows), the passes of `dft_fft_plan(n)`
  with the twiddles and generic roots of `stage_twiddles(n)`
  (`emulate_dft_fft`, the emulation of the engine the kernel shares with
  K7), the 1/n and the permuted store of the forward transform; and
  `emulate_middle`, its middle-axis form's in-place passes (decimation in
  time, digit-reversed first loads); both against the plain versions at n
  = 384, 640, 2176 (the generic pass), 2304 and 2560, and against the
  float64 definition there and at 12288 (whose plain version needs 1.2 GB
  of stage matrices: the card holds it, `chip_smoke.py` phase 2);
- the plain versions against the Pallas kernels they stand for, in
  interpret mode, at n = 2304 (`_v2_stage_call`, `fused_stage_inv_otf`);
- the header built by the host compiler (tests/torch_stage_mixed_host/):
  the plan rule, both geometries within 227 KB and 512 threads, COLS by n,
  the middle-axis slot map, the index maps through the header's own
  passes, and no bank conflict in the middle-axis form;
- the route by n, the CPU path and the wrapper's refusals;
- on a card (marked `gpu`): every form against the plain version, one
  launch each under the wrapper's counter and on `ipp_stage_mixed`.

Tolerance: 1e-5 of the reference's max, the bound the chip smoke holds the
stage kernels to; the Pallas twins 1e-4 (their 3-pass bf16 products), the
bound of the walk tests.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ipp_tpu.ops import pallas_fft as pf
from ipp_tpu_torch.ops import cuda_fft as cf
from ipp_tpu_torch.ops.dft_mats import (DFT_FFT_MAX_N, DFT_FFT_RADICES,
                                        STAGE_FFT_LENGTHS, dft_fft_plan,
                                        stage_mats_t, stage_twiddles)
from tests.test_torch_dft_fft import emulate_dft_fft
from tests.test_torch_stage_fft import permutation, reference_stage

# off STAGE_FFT_LENGTHS: 3 and 5 after the powers of two, the generic pass
# (17), 9, and 5 after three passes of 8
LENGTHS = (384, 640, 2176, 2304, 2560)
TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def rng():
    return np.random.default_rng(13)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def mats(n, forward, device="cpu"):
    return tuple(torch.tensor(m, device=device)
                 for m in stage_mats_t(n, forward))


def rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def emulate_stage_mixed(re, im, forward, otf=None, conj=False):
    """The mixed-radix stage kernel's arithmetic on (rows, n) f32 tensors,
    as csrc/stage_mixed.cuh runs it: element e of the inverse's input read
    from the permuted position (f & 1) * n/2 + (f >> 1), times OTF row
    r % orows (conjugated with `conj`); the passes of `dft_fft_plan(n)`;
    element f of the forward's output stored at that position.  Complex64
    throughout."""
    rows, n = re.shape
    pos = torch.from_numpy(permutation(n))
    x = torch.complex(re, im)
    if otf is not None:
        o_re, o_im = otf
        r = torch.arange(rows) % o_re.shape[0]
        x = x * torch.complex(o_re[r], -o_im[r] if conj else o_im[r])
    if not forward:
        x = x[:, pos]
    rr, ii = emulate_dft_fft(x.real.contiguous(), x.imag.contiguous(),
                             forward)
    if forward:
        y = torch.empty_like(x)
        y[:, pos] = torch.complex(rr, ii)
        rr, ii = y.real.contiguous(), y.imag.contiguous()
    return rr, ii


def dit_source(plan, g):
    """csrc/stage_mixed.cuh `dit_source`: the input index of element g R0 +
    k0 of the middle-axis form's first pass, less k0 n / R0."""
    n, idx = int(np.prod(plan)), 0
    rest = n // plan[0]
    for r in plan[1:]:
        rest //= r
        idx = idx + (g % r) * rest
        g = g // r
    return idx


def emulate_middle(re, im, forward):
    """The middle-axis form's arithmetic on (P, n, X) f32 tensors, as
    csrc/stage_mixed.cuh runs it on each column: in place, decimation in
    time, the passes of `dft_fft_plan(n)` in order.  The first pass reads
    its inputs in digit-reversed order (`dit_source`, through the permuted
    load of the inverse); pass p turns element g L + j + k Lp by w^(j k n /
    L) and transforms the R elements in place; a generic last radix's
    twiddles (the kernel applies them to the outputs of the pass before)
    turn the same values, its roots come from the table; the spectrum ends in
    natural order (then the permuted store of the forward, or the 1/n of
    the inverse).  Complex64 throughout."""
    p_, n, x_ = re.shape
    x = torch.complex(re, im).transpose(1, 2).reshape(-1, n)
    pos = torch.from_numpy(permutation(n))
    tab = torch.from_numpy(stage_twiddles(n).copy())
    w = torch.complex(tab[:, 0], tab[:, 1])
    if not forward:
        w = w.conj()
        x = x[:, pos]                                   # natural order

    def roots(r, stride):
        jk = (np.arange(r)[:, None] * np.arange(r)[None, :]) % r
        if r in DFT_FFT_RADICES:
            ang = (-2 if forward else 2) * np.pi * jk / r
            return torch.from_numpy(np.exp(1j * ang).astype(np.complex64))
        return w[torch.from_numpy(jk * stride)]

    plan = dft_fft_plan(n)
    r0 = plan[0]
    nb = n // r0
    g = np.arange(nb)
    k = np.arange(r0)
    a = x[:, torch.from_numpy(dit_source(plan, g)[:, None] + k[None] * nb)]
    buf = torch.empty_like(x)
    buf[:, torch.from_numpy(g[:, None] * r0 + k[None])] = a @ roots(r0, 0)
    lp = r0
    for r in plan[1:]:
        i = np.arange(n // r)
        k = np.arange(r)
        j, g = i % lp, i // lp
        idx = torch.from_numpy((g * lp * r + j)[:, None] + k[None] * lp)
        v = buf[:, idx] * w[torch.from_numpy(
            (n // (lp * r)) * j[:, None] * k[None])]
        buf[:, idx] = v @ roots(r, n // r)
        lp *= r
    assert lp == n
    if forward:
        out = torch.empty_like(buf)
        out[:, pos] = buf
    else:
        out = buf / n
    out = out.reshape(p_, x_, n).transpose(1, 2)
    return out.real.contiguous(), out.imag.contiguous()


# -- the emulation against the plain versions and the definition --------------

@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_stage_equals_the_plain_stage(rng, n, forward, axis):
    shape = (2, n, 3) if axis == 1 else (5, n)
    re, im = (t(rng.standard_normal(shape)) for _ in range(2))
    emu = emulate_middle if axis == 1 else emulate_stage_mixed
    got = emu(re, im, forward)
    ref = cf.radix2_stage_plain(re, im, *mats(n, forward), forward, axis)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
    assert max(rel(g.numpy(), r.numpy()) for g, r in zip(got, ref)) <= TOL


@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulated_otf_stage_equals_the_plain_otf_stage(rng, n, conj):
    # an OTF period of 3 rows: no multiple of 64 (the dense kernel's tile)
    re, im = (t(rng.standard_normal((6, n))) for _ in range(2))
    otf = tuple(t(rng.standard_normal((3, n))) for _ in range(2))
    got = emulate_stage_mixed(re, im, False, otf, conj)
    ref = cf.radix2_stage_inv_otf_plain(re, im, *otf, *mats(n, False), conj)
    assert max(rel(g.numpy(), r.numpy()) for g, r in zip(got, ref)) <= TOL


@pytest.mark.parametrize("n", LENGTHS + (12288,))
def test_emulated_stage_equals_the_definition(rng, n):
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    xz = x.T[None]                                  # (1, n, 2): the z form
    for forward in (True, False):
        rr, ii = emulate_stage_mixed(t(x.real), t(x.imag), forward)
        ref = reference_stage(x.astype(np.complex64), forward, -1)
        assert rel(rr.numpy(), ref.real) <= TOL
        assert rel(ii.numpy(), ref.imag) <= TOL
        rr, ii = emulate_middle(t(xz.real), t(xz.imag), forward)
        ref = reference_stage(xz.astype(np.complex64), forward, 1)
        assert rel(rr.numpy(), ref.real) <= TOL
        assert rel(ii.numpy(), ref.imag) <= TOL
    # the inverse with a conjugated OTF of period 3 (rows 0 and 3 share it)
    o = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    x4 = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    rr, ii = emulate_stage_mixed(t(x4.real), t(x4.imag), False,
                                 (t(o.real), t(o.imag)), True)
    prod = x4.astype(np.complex64) * np.conj(o.astype(np.complex64))[
        np.arange(4) % 3]
    ref = reference_stage(prod, False, -1)
    assert rel(rr.numpy(), ref.real) <= TOL
    assert rel(ii.numpy(), ref.imag) <= TOL


def test_every_stage_length_has_a_plan_with_the_powers_of_two_first():
    for n in range(128, DFT_FFT_MAX_N + 1, 128):
        plan = dft_fft_plan(n)
        assert int(np.prod(plan)) == n and plan[0] in (8, 16)
        twos = [r for r in plan if r % 2 == 0]
        assert plan[:len(twos)] == tuple(twos) and int(np.prod(twos)) >= 128
        assert all(r in DFT_FFT_RADICES for r in plan[:-1])


# -- the Pallas kernels at a length the new kernel takes ------------------------

N_TWIN = 2304


@pytest.mark.parametrize("forward", [True, False])
def test_plain_z_stage_matches_the_pallas_twin_at_2304(rng, forward):
    # the smallest block _v2_stage_call admits: 8 planes of 128 lanes
    sr, si = (rng.standard_normal((8, N_TWIN, 128)).astype(np.float32)
              for _ in range(2))
    hi, lo = pf.prep_v2_stage_mats(N_TWIN)[0 if forward else 1]
    ref = pf._v2_stage_call(sr, si, hi, lo, forward, interpret=True)
    got = cf.radix2_stage_plain(t(sr), t(si), *mats(N_TWIN, forward),
                                forward, 1)
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-4 * scale


@pytest.mark.parametrize("conj", [False, True], ids=["otf", "conj"])
def test_plain_otf_stage_matches_the_pallas_twin_at_2304(rng, conj):
    # one STAGE_TM row tile of data and OTF
    r2, i2, o_r, o_i = (rng.standard_normal((pf.STAGE_TM, N_TWIN)).astype(
        np.float32) for _ in range(4))
    ref = pf.fused_stage_inv_otf(r2, i2, o_r, o_i, pf.prep_stage_mats(N_TWIN),
                                 conj, interpret=True)
    got = cf.radix2_stage_inv_otf_plain(t(r2), t(i2), t(o_r), t(o_i),
                                        *mats(N_TWIN, False), conj)
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-4 * scale


# -- the header on the host ------------------------------------------------------

HOST_LENGTHS = (128, 384, 640, 1152, 2176, 2304, 2560, 3456, 7296, 8320,
                12288)


def expected_cols(n):
    """COLS of the middle-axis form: one (n, COLS) float2 buffer in 227 KB."""
    return 16 if n <= 1792 else 8 if n <= 3584 else 4 if n <= 7168 else 2


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """tests/torch_stage_mixed_host/check.cpp built by g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    exe = tmp_path_factory.mktemp("stage_mixed_host") / "check"
    subprocess.run(
        [gxx, "-std=c++17", "-O2", "-I",
         str(ROOT / "tests" / "torch_dft_fft_host"), "-I",
         str(ROOT / "ipp_tpu_torch" / "csrc"),
         str(ROOT / "tests" / "torch_stage_mixed_host" / "check.cpp"), "-o",
         str(exe)], check=True, capture_output=True, text=True)
    return exe


def test_header_maps_and_geometry_on_the_host(host_check):
    args = []
    for n in HOST_LENGTHS:
        plan = dft_fft_plan(n)
        args += [str(n), str(int(plan[-1] not in DFT_FFT_RADICES)),
                 *map(str, plan), "/"]
    out = subprocess.run([str(host_check), *args], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == len(HOST_LENGTHS)
    for n, line in zip(HOST_LENGTHS, lines):
        fields = dict(f.split("=") for f in line.split() if "=" in f)
        assert int(fields["n"]) == n
        assert int(fields["cols"]) == expected_cols(n), line
        assert int(fields["smem"]) <= 227 * 1024
        assert int(fields["bijective"]) == 1


def test_the_host_check_refuses_a_plan_off_the_rule(host_check):
    # 192 is no multiple of 128; 12416 lies above the limit
    for args in (["192", "0", "8", "8", "3"], ["12416", "1", "8", "16", "97"]):
        out = subprocess.run([str(host_check), *args], capture_output=True,
                             text=True, timeout=60)
        assert out.returncode == 1 and "refused" in out.stdout


# -- the route, the CPU path, the refusals ---------------------------------------

def test_route_is_mixed_at_every_multiple_of_128_off_the_fft_lengths():
    for n in range(128, DFT_FFT_MAX_N + 1, 128):
        assert cf.stage_route(n) == ("fft" if n in STAGE_FFT_LENGTHS
                                     else "mixed")


@pytest.mark.parametrize("n", [384, 2304])
def test_the_cpu_takes_the_plain_stage_at_mixed_lengths(rng, n):
    re, im = (t(rng.standard_normal((3, n))) for _ in range(2))
    cf.reset_launch_counts()
    for fwd in (True, False):
        got = cf.radix2_stage(re, im, *mats(n, fwd), fwd, -1)
        ref = cf.radix2_stage_plain(re, im, *mats(n, fwd), fwd, -1)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = cf.radix2_stage_inv_otf_batched(re, im, re[:1], im[:1],
                                          *mats(n, False), True)
    ref = cf.radix2_stage_inv_otf_plain(re, im, re[:1], im[:1],
                                        *mats(n, False), True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert set(cf.LAUNCHES.values()) == {0} and not cf.ENTRY_LAUNCHES


def test_the_mixed_kernel_refuses_cpu_tensors(rng):
    re, im = (t(rng.standard_normal((3, 384))) for _ in range(2))
    with pytest.raises(ValueError):
        cf.stage_mixed(re, im, True, -1)


# -- on the card --------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 384, 2176, 2304, 2560, 12288])
def test_mixed_kernel_matches_plain_on_the_card(cuda, n):
    from tests.test_torch_stage_fft import _card_cases

    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    cf.reset_launch_counts()
    for what, got, ref in _card_cases(n, cuda, gen):
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref)) / \
            max(float(r.abs().max()) for r in ref)
        assert err <= TOL, (n, what, err)
    assert not any(v for k, v in cf.LAUNCHES.items() if k.endswith("_dense"))
    assert sum(cf.LAUNCHES.values()) == 6
    assert cf.ENTRY_LAUNCHES == {"ipp_stage_mixed": 6}
