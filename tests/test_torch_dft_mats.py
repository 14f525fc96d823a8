"""The port's DFT matrices and PSF equal the JAX package's."""

import numpy as np
import pytest

from ipp_tpu.ops import mxu_fft, pallas_fft
from ipp_tpu.ops import psf as psf_jax
from ipp_tpu_torch.ops import dft_mats as dm
from ipp_tpu_torch.ops import psf as psf_port

NS = [16, 256, 768]


def _kp(n):
    return -(-(n // 2 + 1) // 8) * 8


def _hilo_sum(pair):
    """f32 value of a bf16 (hi, lo) split."""
    hi, lo = pair
    return hi.astype(np.float32) + lo.astype(np.float32)


def _close_to_split(port, pair):
    """A bf16 hi/lo pair keeps ~16 mantissa bits: its f32 sum is within
    2^-15 of the largest entry of the f32 matrix it splits."""
    ref = _hilo_sum(pair)
    assert ref.shape == port.shape
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=2.0 ** -15 * np.abs(port).max())


@pytest.mark.parametrize("n", NS)
def test_half_spectrum_mats_bit_equal(n):
    for port, ref in ((dm.dft_mats(n), mxu_fft._dft_mats(n)),
                      (dm.rdft_mats(n), mxu_fft._rdft_mats(n)),
                      (dm.irdft_mats(n), mxu_fft._irdft_mats(n))):
        for a, b in zip(port, ref):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", NS)
def test_radix2_mats_bit_equal(n):
    for port, ref in ((dm.radix_fwd_mats(n, 2), mxu_fft._radix_fwd_mats(n, 2)),
                      (dm.radix_inv_mats(n, 2), mxu_fft._radix_inv_mats(n, 2))):
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", NS)
def test_rfft_fold_mats_equal_prep_v2_split_sum(n):
    kp = _kp(n)
    fwd, inv = dm.rfft_fold_mats(n, kp)
    (fhi, flo), (ihi, ilo) = pallas_fft.prep_v2_rfft_mats(n, kp)
    _close_to_split(fwd, (fhi, flo))
    _close_to_split(inv, (ihi, ilo))
    kx = n // 2 + 1
    assert not fwd[kx:kp].any() and not fwd[kp + kx:].any()
    assert not inv[:, kx:kp].any() and not inv[:, kp + kx:].any()


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("forward", [True, False])
def test_stage_mats_equal_prep_split_sums(n, forward):
    mr_t, mi_t = dm.stage_mats_t(n, forward)
    which = 0 if forward else 1
    v2 = pallas_fft.prep_v2_stage_mats(n)[which]      # (6, m, m): M_s^T
    v1 = pallas_fft.prep_stage_mats(n)[which]         # (6, m, m): M_s
    for s in range(2):
        for port, k in ((mr_t[s], 3 * s), (mi_t[s], 3 * s + 1)):
            _close_to_split(port, (v2[0][k], v2[1][k]))
            _close_to_split(port.T, (v1[0][k], v1[1][k]))


@pytest.mark.parametrize("optics", [
    dict(dxy=400.0, dz=800.0),
    dict(dxy=406.0, dz=1000.0, NA=0.3, lambda_em=600.0),
])
def test_make_psf_bit_equal(optics):
    a, fxy_a, fz_a = psf_port.make_psf(**optics)
    b, fxy_b, fz_b = psf_jax.make_psf(**optics)
    np.testing.assert_array_equal(a, b)
    assert (fxy_a, fz_a) == (fxy_b, fz_b)
