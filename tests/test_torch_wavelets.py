"""The port's wavelet layer and DWT kernel K5 against the JAX package.

Filter banks bit-equal; the plain one-level analysis (K5's CPU version)
along axis -1 against the JAX conv path and the Pallas kernel
`dwt_analysis_pallas` (interpret mode, as tests/test_wavelets.py runs it),
along axis -2 against JAX `_dwt_last` on moved axes and the Pallas
prototype `dwt_y_pallas` (interpret mode): atol 2e-5.  wavedec2 at 7
levels (parity rolls on) within 1e-5 of the largest coefficient, and
round trips.  On a CUDA card only: K5 against its plain version, rel 1e-5
(both f32), at every filter length on both axes, and a batch bit-equal to
its single calls."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipp_tpu.ops import wavelets as J
from ipp_tpu.ops.pallas_dwt import dwt_analysis_pallas
from ipp_tpu_torch.ops import cuda_dwt as K
from ipp_tpu_torch.ops import wavelets as P

ROOT = Path(__file__).resolve().parent.parent


def _taps(name):
    return P.filter_taps(name, "cpu")


@pytest.fixture(scope="module")
def dwt_y_pallas():
    """scripts/dwt_ykernel_exp.py's `dwt_y_pallas`, loaded from its file."""
    path = ROOT / "scripts" / "dwt_ykernel_exp.py"
    spec = importlib.util.spec_from_file_location("dwt_ykernel_exp", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.dwt_y_pallas


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")
    return torch.device("cuda", 0)


BANKS = ["haar", "db1", "db3", "db9", "db20", "db34", "sym2", "sym8",
         "sym20", "coif1", "coif5", "coif6", "coif15", "coif17"]


@pytest.mark.parametrize("name", BANKS)
def test_filter_banks_bit_equal(name):
    for a, b in zip(P.filter_bank(name), J.filter_bank(name)):
        np.testing.assert_array_equal(a, b)
    assert P.dwt_max_level(2688, name) == J.dwt_max_level(2688, name)


def test_coif_high_table_equal():
    from ipp_tpu.ops.coif_data import COIF_HIGH as ref
    from ipp_tpu_torch.ops.coif_data import COIF_HIGH

    assert COIF_HIGH == ref


@pytest.mark.parametrize("L", [2, 4, 6, 18, 34, 90, 102])
def test_parity_rolls_equal(L):
    assert P._parity_rolls(L, 7) == J._parity_rolls(L, 7)


@pytest.mark.parametrize("name,n", [("db2", 64), ("db9", 64), ("coif15", 96),
                                    ("db9", 16), ("coif17", 24)])
def test_analysis_last_axis_matches_jax(name, n, rng):
    """n = 16, 24: the row is shorter than the filter (several wraps)."""
    _, _, lo, hi = J.filter_bank(name)
    x = rng.standard_normal((5, n)).astype(np.float32)
    ca, cd = K.dwt_analysis_plain(torch.from_numpy(x), _taps(name), -1)
    ra, rd = J._dwt_last(jnp.asarray(x), lo, hi)
    np.testing.assert_allclose(ca.numpy(), np.asarray(ra), atol=2e-5)
    np.testing.assert_allclose(cd.numpy(), np.asarray(rd), atol=2e-5)
    if len(lo) <= n:
        pa, pd = dwt_analysis_pallas(jnp.asarray(x), lo, hi,
                                     rows_per_block=4, interpret=True)
        np.testing.assert_allclose(ca.numpy(), np.asarray(pa), atol=2e-5)
        np.testing.assert_allclose(cd.numpy(), np.asarray(pd), atol=2e-5)


@pytest.mark.parametrize("name", ["db3", "db9"])
def test_analysis_axis_minus2_matches_jax(name, rng, dwt_y_pallas):
    _, _, lo, hi = J.filter_bank(name)
    x = rng.standard_normal((2, 48, 40)).astype(np.float32)
    ca, cd = K.dwt_analysis(torch.from_numpy(x), _taps(name), -2)
    assert ca.shape == cd.shape == (2, 24, 40)
    ra, rd = J._dwt_last(jnp.moveaxis(jnp.asarray(x), -2, -1), lo, hi)
    np.testing.assert_allclose(ca.numpy(), np.moveaxis(np.asarray(ra), -1, -2),
                               atol=2e-5)
    np.testing.assert_allclose(cd.numpy(), np.moveaxis(np.asarray(rd), -1, -2),
                               atol=2e-5)
    ya, yd = dwt_y_pallas(jnp.asarray(x), lo, hi, tx=128, interpret=True)
    np.testing.assert_allclose(ca.numpy(), np.asarray(ya), atol=2e-5)
    np.testing.assert_allclose(cd.numpy(), np.asarray(yd), atol=2e-5)


@pytest.mark.parametrize("name", ["db3", "db4", "db9"])
def test_wavedec2_waverec2_match_jax_at_7_levels(name, rng):
    img = rng.standard_normal((1, 128, 256)).astype(np.float32)
    cj = J.wavedec2(jnp.asarray(img), name, 7)
    cp = P.wavedec2(torch.from_numpy(img), name, 7)
    assert len(cp) == 8 and cp[0].shape == (1, 1, 2)
    flat_j = [cj[0]] + [c for det in cj[1:] for c in det]
    flat_p = [cp[0]] + [c for det in cp[1:] for c in det]
    scale = max(float(np.abs(np.asarray(c)).max()) for c in flat_j)
    for a, b in zip(flat_p, flat_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-5 * scale)
    rec = P.waverec2(cp, name)
    np.testing.assert_allclose(rec.numpy(), img, atol=1e-4)
    rj = np.asarray(J.waverec2(cj, name))
    np.testing.assert_allclose(rec.numpy(), rj, atol=1e-4)


def test_dwt2_idwt2_on_other_axes(rng):
    img = rng.standard_normal((16, 3, 24)).astype(np.float32)
    a, det = P.dwt2(torch.from_numpy(img), "db2", axes=(0, 2))
    ja, jdet = J.dwt2(jnp.asarray(img), "db2", axes=(0, 2))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=2e-5)
    for c, jc in zip(det, jdet):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-5)
    back = P.idwt2(a, det, "db2", axes=(0, 2))
    np.testing.assert_allclose(back.numpy(), img, atol=2e-5)


def test_cpu_calls_take_the_plain_version_and_count_nothing(rng):
    K.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    got = K.dwt_analysis(x, _taps("db9"), -1)
    ref = K.dwt_analysis_plain(x, _taps("db9"), -1)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert K.LAUNCHES == {"dwt_analysis": 0}


@pytest.mark.parametrize("shape,taps,axis", [
    ((4, 31), (2, 18), -1),       # odd axis
    ((4, 32), (2, 17), -1),       # odd filter
    ((4, 32), (2, 130), -1),      # filter longer than the kernel takes
    ((4, 32), (3, 18), -1),       # not a (lo, hi) pair
    ((32,), (2, 18), -2),         # no axis -2
])
def test_wrapper_refuses_what_the_kernel_does_not_take(shape, taps, axis):
    with pytest.raises(ValueError):
        K.dwt_analysis(torch.zeros(shape), torch.zeros(taps), axis)


def test_wrapper_refuses_devices_it_cannot_launch_on():
    x = torch.empty((4, 32), device="meta")
    with pytest.raises(ValueError):
        K.dwt_analysis(x, torch.empty((2, 18), device="meta"), -1)


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,axis", [
    ("db9", (3, 2688, 336), -1), ("db9", (3, 336, 2688), -2),
    ("coif15", (2, 168, 1344), -2), ("db3", (2, 100, 42), -1),
    ("db9", (5, 16), -1), ("db9", (2, 16, 40), -2),
    # every other filter length the tests name, both axes, ragged widths
    ("haar", (4, 2688), -1), ("haar", (2, 84, 33), -2),
    ("db34", (3, 1344), -1), ("db34", (2, 336, 31), -2),
    ("coif17", (3, 42), -1), ("coif17", (2, 1344, 42), -2),
    ("coif15", (2, 2688), -1), ("db9", (2, 2, 21), -2),
])
def test_kernel_matches_plain_on_the_card(cuda, name, shape, axis, rng):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    taps = P.filter_taps(name, cuda)
    K.reset_launch_counts()
    got = K.dwt_analysis(x, taps, axis)
    assert K.LAUNCHES == {"dwt_analysis": 1}
    ref = K.dwt_analysis_plain(x, taps, axis)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        rel = float((g - r).abs().max() / r.abs().max())
        assert rel <= 1e-5, rel


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [-1, -2])
def test_kernel_batch_equals_single_calls_on_the_card(cuda, axis, rng):
    """Each output is the same sum in the same order whatever the batch, so
    a batch gives bit for bit what its single calls give."""
    x = torch.from_numpy(
        rng.standard_normal((8, 336, 168)).astype(np.float32)).to(cuda)
    taps = P.filter_taps("coif15", cuda)
    got = K.dwt_analysis(x, taps, axis)
    for i in range(x.shape[0]):
        for g, s in zip(got, K.dwt_analysis(x[i:i + 1], taps, axis)):
            assert torch.equal(g[i:i + 1], s)
