import numpy as np
import jax.numpy as jnp
import pytest
from scipy import interpolate as si

from oisat.ops.vertical import (
    air_partial_column,
    ak_conv_gosat_fields,
    ak_conv_mopitt_fields,
    amf_recal_fields,
    amf_recal_noak_fields,
    interp_linear_batched,
    partial_column,
    pwv_fields,
)
from tests.reference_impl import (
    ak_conv_gosat_pixelwise,
    ak_conv_mopitt_pixelwise,
    amf_recal_pixelwise,
)


def column_setup(seed=0, H=12, W=15, Ls=34, Lc=47):
    rng = np.random.default_rng(seed)
    # decreasing pressures (bottom-to-top, like the flipped CTM fields)
    sat_pmid = np.sort(rng.uniform(50, 1000, (Ls, H, W)), axis=0)[::-1].copy()
    ctm_pmid = np.sort(rng.uniform(30, 1010, (Lc, H, W)), axis=0)[::-1].copy()
    sat_sw = np.abs(rng.normal(1, 0.3, (Ls, H, W)))
    dp = rng.uniform(5, 30, (Lc, H, W))
    prof = np.abs(rng.normal(20, 5, (Lc, H, W)))
    vcd = np.abs(rng.normal(3, 1, (H, W)))
    vcd[rng.random((H, W)) < 0.15] = np.nan
    amf_old = np.abs(rng.normal(2, 0.2, (H, W)))
    trop = rng.uniform(100, 250, (H, W))
    return sat_pmid, sat_sw, ctm_pmid, dp, prof, vcd, amf_old, trop


@pytest.mark.parametrize("extrapolate", [True, False])
def test_interp_matches_scipy(extrapolate):
    rng = np.random.default_rng(1)
    Ls, Lt, H, W = 10, 7, 4, 5
    xp = np.sort(rng.uniform(0, 10, (Ls, H, W)), axis=0)[::-1].copy()  # decreasing
    fp = rng.standard_normal((Ls, H, W))
    xq = rng.uniform(-2, 12, (Lt, H, W))
    got = np.asarray(interp_linear_batched(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(xq), extrapolate))
    for i in range(H):
        for j in range(W):
            if extrapolate:
                f = si.interp1d(xp[:, i, j], fp[:, i, j], fill_value="extrapolate")
            else:
                f = si.interp1d(xp[:, i, j], fp[:, i, j], fill_value=np.nan, bounds_error=False)
            np.testing.assert_allclose(got[:, i, j], f(xq[:, i, j]), rtol=1e-10, atol=1e-12)


def test_interp_nan_column():
    xp = np.array([[[1.0]], [[np.nan]], [[3.0]]])
    fp = np.ones((3, 1, 1))
    xq = np.array([[[2.0]]])
    got = np.asarray(interp_linear_batched(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(xq), True))
    assert np.isnan(got).all()


def test_partial_column_formula():
    dp, q = 25.0, 40.0
    expect = dp * q / 9.80665 / 28.97e-3 * 6.02214076e23 * 1e-4 * 1e-15 * 100.0 * 1e-9
    np.testing.assert_allclose(float(partial_column(dp, q)), expect)
    np.testing.assert_allclose(float(air_partial_column(dp)), expect / (40.0 * 1e-9))


@pytest.mark.parametrize("with_trop", [True, False])
def test_amf_recal_matches_pixelwise(with_trop):
    sat_pmid, sat_sw, ctm_pmid, dp, prof, vcd, amf_old, trop = column_setup()
    pc = np.asarray(partial_column(jnp.asarray(dp), jnp.asarray(prof)))
    ref = amf_recal_pixelwise(sat_pmid, sat_sw, ctm_pmid, pc, trop if with_trop else None, vcd, amf_old)
    got = amf_recal_fields(
        jnp.asarray(sat_pmid), jnp.asarray(sat_sw), jnp.asarray(ctm_pmid), jnp.asarray(pc),
        jnp.asarray(trop if with_trop else np.zeros_like(vcd)), jnp.asarray(vcd),
        jnp.asarray(amf_old), with_trop)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), r, rtol=1e-9, atol=1e-12)


def test_amf_recal_noak_matches():
    sat_pmid, sat_sw, ctm_pmid, dp, prof, vcd, amf_old, trop = column_setup(3)
    pc = np.asarray(partial_column(jnp.asarray(dp), jnp.asarray(prof)))
    # reference no-AK branch: tropopause-mask everywhere, sum, NaN by vcd
    pc_m = np.where(ctm_pmid < trop[None], np.nan, pc)
    ref = np.nansum(pc_m, axis=0)
    ref[np.isnan(vcd)] = np.nan
    got = np.asarray(amf_recal_noak_fields(jnp.asarray(ctm_pmid), jnp.asarray(pc),
                                           jnp.asarray(trop), jnp.asarray(vcd), True))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_ak_conv_mopitt_matches_pixelwise():
    rng = np.random.default_rng(5)
    H, W, Ls, Lc = 10, 12, 9, 47
    sat_pmid = np.sort(rng.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy()
    ctm_pmid = np.sort(rng.uniform(30, 1010, (Lc, H, W)), axis=0)[::-1].copy()
    prof = np.abs(rng.normal(80, 20, (Lc, H, W)))
    dp = rng.uniform(5, 30, (Lc, H, W))
    airpc = np.asarray(air_partial_column(jnp.asarray(dp)))
    aks = rng.uniform(0, 0.6, (Ls + 1, H, W))
    aprior_col = np.abs(rng.normal(2, 0.3, (H, W)))
    apriori_profile = np.abs(rng.normal(80, 15, (Ls, H, W)))
    apriori_surface = np.abs(rng.normal(90, 10, (H, W)))
    vcd = np.abs(rng.normal(2, 0.5, (H, W)))
    vcd[rng.random((H, W)) < 0.2] = np.nan
    ref = ak_conv_mopitt_pixelwise(ctm_pmid, prof, airpc, sat_pmid, aks,
                                   aprior_col, apriori_profile, apriori_surface, vcd)
    got = ak_conv_mopitt_fields(
        jnp.asarray(ctm_pmid), jnp.asarray(prof), jnp.asarray(airpc), jnp.asarray(sat_pmid),
        jnp.asarray(aks), jnp.asarray(aprior_col), jnp.asarray(apriori_profile),
        jnp.asarray(apriori_surface), jnp.asarray(vcd))
    np.testing.assert_allclose(np.asarray(got[0]), ref[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got[1]), ref[1], rtol=1e-9, atol=1e-12)


def test_ak_conv_gosat_matches_pixelwise():
    rng = np.random.default_rng(6)
    H, W, Ls, Lc = 8, 9, 20, 72
    sat_pmid = np.sort(rng.uniform(50, 990, (Ls, H, W)), axis=0)[::-1].copy()
    ctm_pmid = np.sort(rng.uniform(30, 1010, (Lc, H, W)), axis=0)[::-1].copy()
    prof = np.abs(rng.normal(1800, 100, (Lc, H, W)))
    aks = rng.uniform(0, 1.2, (Ls, H, W))
    apriori_profile = np.abs(rng.normal(1800, 80, (Ls, H, W)))
    pw = rng.uniform(0, 0.1, (Ls, H, W))
    x_col = np.abs(rng.normal(1.8, 0.1, (H, W)))
    x_col[rng.random((H, W)) < 0.2] = np.nan
    ref = ak_conv_gosat_pixelwise(ctm_pmid, prof, sat_pmid, aks, apriori_profile, pw, x_col)
    got = np.asarray(ak_conv_gosat_fields(
        jnp.asarray(ctm_pmid), jnp.asarray(prof), jnp.asarray(sat_pmid), jnp.asarray(aks),
        jnp.asarray(apriori_profile), jnp.asarray(pw), jnp.asarray(x_col)))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)


def test_pwv():
    rng = np.random.default_rng(7)
    L, H, W = 5, 6, 7
    pc = rng.uniform(0, 3, (L, H, W))
    vcd = np.ones((H, W))
    vcd[0, 0] = np.nan
    got = np.asarray(pwv_fields(jnp.asarray(pc), jnp.asarray(vcd)))
    ref = np.nansum(pc / 1000.0, axis=0)
    ref[0, 0] = np.nan
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_interp_nonmonotone_column_nans():
    """Deliberate deviation (documented in interp_linear_batched): a
    genuinely unsorted abscissa column yields NaN — the flip-based sort
    handles any MONOTONIC order only (no physical pressure grid is
    unsorted; scipy would argsort)."""
    xp = np.array([[[1.0]], [[5.0]], [[3.0]]])  # not monotone either way
    fp = np.ones((3, 1, 1))
    xq = np.array([[[2.0]]])
    got = np.asarray(interp_linear_batched(
        jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(xq), True))
    assert np.isnan(got).all()
    # both monotonic directions still interpolate
    for sl in (slice(None), slice(None, None, -1)):
        got = np.asarray(interp_linear_batched(
            jnp.asarray(np.sort(xp, axis=0)[sl]),
            jnp.asarray(np.array([[[10.0]], [[20.0]], [[30.0]]])[sl]),
            jnp.asarray(xq), True))
        assert np.isfinite(got).all()
