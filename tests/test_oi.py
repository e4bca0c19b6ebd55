import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oisat.ops.oi import oi, regularization_grid
from tests.reference_impl import oi_numpy


def make_fields(seed=0, shape=(40, 60), nan_frac=0.15, zero_frac=0.05):
    rng = np.random.default_rng(seed)
    xa = rng.uniform(0.0, 8.0, shape)
    y = rng.uniform(-0.5, 8.0, shape)  # includes negatives -> clamp path
    sa = (xa * 0.5) ** 2
    so = rng.uniform(0.0, 4.0, shape) ** 2
    for f in (xa, y, sa, so):
        f[rng.random(shape) < nan_frac] = np.nan
    # Sa == 0 cells exercise the 0/0 -> NaN averaging-kernel path
    zmask = rng.random(shape) < zero_frac
    xa[zmask] = 0.0
    sa[zmask] = 0.0
    return xa, y, sa, so


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oi_matches_numpy_f64(seed):
    xa, y, sa, so = make_fields(seed)
    ref_xb, ref_ak, ref_inc, ref_err, ref_idx, ref_curve = oi_numpy(xa, y, sa, so)
    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    assert int(res.reg_index) == ref_idx
    np.testing.assert_allclose(np.asarray(res.curve), ref_curve, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.xb), ref_xb, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.averaging_kernel), ref_ak, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.increment), ref_inc, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.error), ref_err, rtol=1e-8, atol=1e-12)


def test_oi_f32_within_tolerance():
    xa, y, sa, so = make_fields(3)
    ref_xb, _, _, ref_err, ref_idx, _ = oi_numpy(xa, y, sa, so)
    res = oi(
        jnp.asarray(xa, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(sa, jnp.float32),
        jnp.asarray(so, jnp.float32),
    )
    assert int(res.reg_index) == ref_idx
    np.testing.assert_allclose(np.asarray(res.xb), ref_xb, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.error), ref_err, rtol=1e-4, atol=1e-6)


def test_oi_no_regularization():
    xa, y, sa, so = make_fields(4)
    ref = oi_numpy(xa, y, sa, so, regularization_on=False)
    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so), regularization_on=False)
    assert float(res.reg_factor) == 1.0
    np.testing.assert_allclose(np.asarray(res.xb), ref[0], rtol=1e-8, atol=1e-12)


def test_oi_negative_y_clamp():
    xa = np.array([[1.0]])
    y = np.array([[-3.0]])
    sa = np.array([[1.0]])
    so = np.array([[1.0]])
    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so), regularization_on=False)
    # y clamped to 0 -> increment = 0.5*(0-1)
    np.testing.assert_allclose(float(res.increment[0, 0]), -0.5)


def test_oi_jit_and_grid():
    assert regularization_grid().size == 99
    xa, y, sa, so = make_fields(5)
    f = jax.jit(lambda *a: oi(*a))
    r1 = f(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    r2 = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    np.testing.assert_allclose(np.asarray(r1.xb), np.asarray(r2.xb), rtol=0, atol=0)


def test_inf_observation_variance_matches_reference_and_pallas():
    """so=inf (an unusable observation): the reference computes K=0, AK=0
    and KEEPS the cell in the mean-AK curve; the stable product form's
    inf/inf would have NaN'd it, making the curve and the chosen fields
    disagree on the knee."""
    import numpy as np
    import jax.numpy as jnp

    from oisat.ops.oi import ak_curve, oi, regularization_grid

    sa = np.array([1.0, 2.0])
    so = np.array([1.0, np.inf])
    regs = regularization_grid()
    curve = np.asarray(ak_curve(jnp.asarray(sa), jnp.asarray(so),
                                jnp.asarray(regs)))
    # reference f64: cell 1 contributes AK=0 -> curve[0] = (0.1/1.1 + 0)/2
    np.testing.assert_allclose(curve[0], (0.1 / 1.1) / 2.0, rtol=1e-6)

    # and the full update keeps xb = xa at the inf-so cell (K = 0)
    xa = np.array([3.0, 5.0])
    y = np.array([4.0, 100.0])
    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    assert float(np.asarray(res.xb)[1]) == 5.0
    assert float(np.asarray(res.averaging_kernel)[1]) == 0.0


def test_curve_engines_agree_on_edge_value_cross_product():
    """The hoisted r/(r+So/Sa) curve (ops/oi.curve_inputs) must
    reproduce the reference's literal f64 per-factor formulation on the full cross-product of edge values (0, normal, inf,
    NaN) for (Sa, So) — the validity hoist claims each case is
    factor-independent; this pins every one of them."""
    import warnings

    from oisat.ops.oi import ak_curve, regularization_grid

    vals = np.array([0.0, 1.5, np.inf, np.nan])
    sa2, so2 = np.meshgrid(vals, vals)
    sa = sa2.ravel()
    so = so2.ravel()
    regs = regularization_grid()

    # the reference's literal per-factor f64 loop
    # (reference optimal_interpolation.py:26-33)
    ref = np.empty(regs.size)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, r in enumerate(regs):
            k = sa * r / (sa * r + so)
            sb = (1.0 - k) * sa * r
            ak = 1.0 - sb / (sa * r)
            ref[i] = np.nanmean(np.where(np.isfinite(ak), ak, np.nan))

    got_xla = np.asarray(ak_curve(jnp.asarray(sa, jnp.float32),
                                  jnp.asarray(so, jnp.float32),
                                  jnp.asarray(regs, jnp.float32)))
    np.testing.assert_allclose(got_xla, ref, rtol=2e-6, atol=1e-7)

    # all-invalid grid -> NaN curve (count 0)
    nan_sa = np.full(8, np.nan, np.float32)
    assert np.isnan(np.asarray(ak_curve(jnp.asarray(nan_sa),
                                        jnp.asarray(nan_sa),
                                        jnp.asarray(regs, jnp.float32)))).all()
