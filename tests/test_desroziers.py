"""Desroziers So/Sa re-estimation + weighted temporal averaging
(capability extensions; VERDICT r1 item 7, CLAUDE.md round-2 priority 5)."""

import numpy as np
import jax.numpy as jnp
import pytest

from oisat.driver import oisatgmi
from oisat.ops.averaging import monthly_stats, monthly_stats_weighted
from oisat.ops.diagnostics import desroziers_estimates, innovation_stats
from oisat.ops.oi import oi


def _misspecified_analysis(factor=4.0, H=64, W=96, seed=0):
    """Truth + unbiased background/obs noise, with prescribed standard
    deviations ``factor``x too large (chi^2 ~ 1/factor^2 before
    re-estimation)."""
    rng = np.random.default_rng(seed)
    truth = np.abs(rng.normal(5, 0.5, (H, W)))
    sig_b, sig_o = 0.4, 0.3
    xa = truth + rng.normal(0, sig_b, (H, W))
    y = truth + rng.normal(0, sig_o, (H, W))
    sa = np.full((H, W), (factor * sig_b) ** 2)
    so = np.full((H, W), (factor * sig_o) ** 2)
    return xa, y, sa, so


def test_desroziers_chi2_converges_to_one():
    xa, y, sa, so = _misspecified_analysis()
    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so),
             regularization_on=True)
    chi0 = float(innovation_stats(xa, y, res.xb, sa, so).chi2)
    assert chi0 < 0.15  # badly over-dispersed priors
    for _ in range(3):
        est = desroziers_estimates(xa, y, np.asarray(res.xb), sa, so)
        sa = sa * float(est.sa_scale)
        so = so * float(est.so_scale)
        res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so),
                 regularization_on=True)
    chi = float(innovation_stats(xa, y, res.xb, sa, so).chi2)
    assert abs(chi - 1.0) < 0.05, chi
    # the diagnosed total innovation variance is matched
    assert float(np.mean(sa + so)) == pytest.approx(0.4**2 + 0.3**2, rel=0.1)


def test_desroziers_identity_total_variance():
    """sa_hat + so_hat == E[d_ob^2] exactly (the Desroziers moment identity
    d_oa + d_ab = d_ob)."""
    xa, y, sa, so = _misspecified_analysis(seed=3)
    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    est = desroziers_estimates(xa, y, np.asarray(res.xb), sa, so)
    total = float(np.mean((y - xa) ** 2))
    assert float(est.sa_hat + est.so_hat) == pytest.approx(total, rel=1e-6)


def test_driver_desroziers_option():
    """The driver option re-runs the OI and records the scales + chi^2."""
    xa, y, sa, so = _misspecified_analysis(H=32, W=48, seed=5)
    obj = oisatgmi()
    obj.ctm_averaged_vcd = xa
    obj.sat_averaged_vcd = y
    # driver derives sa from error_ctm: (xa * e/100)^2; pick e to match the
    # misspecified sa on average
    e = 100.0 * np.sqrt(np.mean(sa)) / np.mean(xa)
    obj.sat_averaged_error = np.sqrt(so)
    obj.aux1 = obj.aux2 = np.full_like(xa, np.nan)
    obj.oi("OMI", error_ctm=e, desroziers_iterations=3)
    d = obj.oi_diagnostics
    assert d["desroziers_iterations"] == 3
    assert d["desroziers_sa_scale"] < 0.5  # shrank the inflated prior error
    assert d["desroziers_so_scale"] < 0.5
    assert abs(d["chi2"] - 1.0) < 0.1


def test_weighted_mean_uniform_matches_reference():
    rng = np.random.default_rng(7)
    g = rng.normal(3, 1, (5, 8, 9))
    e = np.abs(rng.normal(1, 0.2, (5, 8, 9)))
    g[rng.random(g.shape) < 0.2] = np.nan
    ref = monthly_stats(*map(jnp.asarray, (g, e, g, g, g)))
    w = np.ones_like(g)
    got = monthly_stats_weighted(*map(jnp.asarray, (g, e, g, g, g, w)))
    np.testing.assert_allclose(np.asarray(got.sat_vcd), np.asarray(ref.sat_vcd),
                               rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(np.asarray(got.sat_error), np.asarray(ref.sat_error),
                               rtol=1e-6, equal_nan=True)


def test_inverse_variance_weighting_is_optimal():
    """Two granules, one 3x noisier: the IV-weighted mean must match the
    closed-form optimal combination."""
    v = np.stack([np.full((4, 4), 2.0), np.full((4, 4), 4.0)])
    e = np.stack([np.full((4, 4), 1.0), np.full((4, 4), 3.0)])
    w = 1.0 / e**2
    got = monthly_stats_weighted(*map(jnp.asarray, (v, e, v, v, v, w)))
    expect = (2.0 / 1.0 + 4.0 / 9.0) / (1.0 + 1.0 / 9.0)
    np.testing.assert_allclose(np.asarray(got.sat_vcd), expect, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got.sat_error),
                               np.sqrt(1.0 / (1.0 + 1.0 / 9.0)), rtol=1e-6)


def test_averaging_weighting_modes(tmp_path):
    """End-to-end averaging() with weighting: IV works for any granule;
    'ak' requires opt granules and weights by AK information content."""
    import datetime
    from types import SimpleNamespace

    from oisat.datamodel import satellite_amf, satellite_opt
    from oisat.ops.averaging import averaging

    hw = (6, 7)
    t = datetime.datetime(2019, 7, 10)

    def amf_granule(val, err):
        return satellite_amf(
            vcd=np.full(hw, val), amf=np.full(hw, 1.0), time=t,
            tropopause=np.empty(1), latitude_center=np.zeros(hw),
            longitude_center=np.zeros(hw), latitude_corner=[], longitude_corner=[],
            uncertainty=np.full(hw, err), quality_flag=[], pressure_mid=np.empty(1),
            scattering_weights=np.empty(1), ctm_upscaled_needed=False,
            ctm_vcd=np.full(hw, val), ctm_time_at_sat=[], old_amf=np.empty(1),
            new_amf=np.empty(1))

    ro = SimpleNamespace(sat_data=[amf_granule(2.0, 1.0), amf_granule(4.0, 3.0)])
    vcd, err, *_ = averaging("2019-07-01", "2019-08-01", ro,
                             weighting="inverse_variance")
    expect = (2.0 / 1.0 + 4.0 / 9.0) / (1.0 + 1.0 / 9.0)
    np.testing.assert_allclose(vcd, expect, rtol=1e-6)
    with pytest.raises(ValueError, match="averaging-kernel granules"):
        averaging("2019-07-01", "2019-08-01", ro, weighting="ak")

    def opt_granule(val, ak):
        return satellite_opt(
            vcd=np.full(hw, val), time=t, profile=[], tropopause=np.empty(1),
            latitude_center=np.zeros(hw), longitude_center=np.zeros(hw),
            latitude_corner=[], longitude_corner=[],
            uncertainty=np.full(hw, 1.0), quality_flag=[],
            pressure_mid=np.zeros((3,) + hw),
            averaging_kernels=np.full((3,) + hw, ak),
            ctm_upscaled_needed=False, ctm_vcd=np.full(hw, val),
            ctm_xcol=np.full(hw, val), ctm_time_at_sat=[],
            aprior_column=np.zeros(hw), apriori_profile=np.zeros((3,) + hw),
            surface_pressure=np.zeros(hw), apriori_surface=np.zeros(hw),
            x_col=np.full(hw, val), pressure_weight=np.zeros((3,) + hw),
            sensor="MOPITT")

    ro2 = SimpleNamespace(sat_data=[opt_granule(2.0, 0.9), opt_granule(4.0, 0.1)])
    vcd, *_ = averaging("2019-07-01", "2019-08-01", ro2, weighting="ak")
    np.testing.assert_allclose(vcd, (2.0 * 0.9 + 4.0 * 0.1) / 1.0, rtol=1e-6)


def test_driver_desroziers_full_covariance():
    """desroziers_iterations also applies to method='full' (the
    distance-decay covariance solve is re-run with rescaled error stds)."""
    from types import SimpleNamespace

    xa, y, sa, so = _misspecified_analysis(H=12, W=16, seed=11)
    lon, lat = np.meshgrid(np.linspace(-10, 10, 16), np.linspace(30, 41, 12))
    obj = oisatgmi()
    obj.ctm_averaged_vcd = xa
    obj.sat_averaged_vcd = y
    obj.sat_averaged_error = np.sqrt(so)
    obj.aux1 = obj.aux2 = np.full_like(xa, np.nan)
    g = SimpleNamespace(latitude_center=lat, longitude_center=lon)
    obj.reader_obj = SimpleNamespace(sat_data=[g])
    e = 100.0 * np.sqrt(np.mean(sa)) / np.mean(xa)
    obj.oi("OMI", error_ctm=e, method="full", length_scale_km=150.0)
    err_plain = np.nanmean(obj.error_OI)
    obj.oi("OMI", error_ctm=e, method="full", length_scale_km=150.0,
           desroziers_iterations=2)
    err_tuned = np.nanmean(obj.error_OI)
    assert np.isfinite(obj.ctm_averaged_vcd_corrected).all()
    # re-estimation deflates the (4x inflated) prescribed errors
    assert err_tuned < err_plain


def test_inverse_variance_excludes_zero_uncertainty():
    """sigma = 0 (fill / unavailable retrieval error) cannot be
    inverse-variance weighted: such cells are excluded from the weighted
    mean (the unweighted parity mode still includes them)."""
    v = np.stack([np.full((3, 3), 2.0), np.full((3, 3), 10.0)])
    e = np.stack([np.full((3, 3), 1.0), np.zeros((3, 3))])  # granule 2: fill
    from oisat.ops.averaging import _granule_weights
    from types import SimpleNamespace

    sel = [SimpleNamespace(uncertainty=e[0]), SimpleNamespace(uncertainty=e[1])]
    w = _granule_weights(sel, "inverse_variance")
    got = monthly_stats_weighted(*map(jnp.asarray, (v, e, v, v, v, w)))
    np.testing.assert_allclose(np.asarray(got.sat_vcd), 2.0)  # granule 2 out


def _north_south_analysis(H=64, W=96, seed=11):
    """Truth + unbiased noise whose TRUE observation error std is 3x larger
    in the north half; the prescribed So is uniform (wrong in both halves)."""
    rng = np.random.default_rng(seed)
    truth = np.abs(rng.normal(5, 0.5, (H, W)))
    sig_b = 0.4
    sig_o = np.where(np.arange(H)[:, None] >= H // 2, 0.6, 0.2) * np.ones((H, W))
    xa = truth + rng.normal(0, sig_b, (H, W))
    y = truth + rng.normal(0, 1.0, (H, W)) * sig_o
    sa = np.full((H, W), sig_b**2)
    so = np.full((H, W), 0.16)  # uniform prescription
    lat = np.linspace(-45.0, 45.0, H)[:, None] * np.ones((H, W))
    return xa, y, sa, so, lat


def test_binned_desroziers_recovers_spatial_contrast():
    """VERDICT r2 item 7: per-lat-band moments recover a prescribed
    north/south error contrast the global estimator cannot (it rescales
    uniformly by construction).  Identifiability honesty: for the scalar
    H=I analysis the within-bin Sa/So split stays gain-determined
    (d_oa = (1-K) d_ob cell-by-cell) — what the bins recover is the
    spatial structure of the TOTAL error (per-band sa+so = per-band
    innovation variance, per-band chi^2 -> 1)."""
    from oisat.ops.diagnostics import desroziers_binned, lat_band_index

    xa, y, sa, so, lat = _north_south_analysis()
    bins = lat_band_index(lat, 2)
    assert bins.min() == 0 and bins.max() == 1
    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    for _ in range(3):
        est = desroziers_binned(xa, y, np.asarray(res.xb), sa, so, bins, 2)
        sa = sa * np.asarray(est.sa_scale)[bins]
        so = so * np.asarray(est.so_scale)[bins]
        res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    south, north = slice(0, 32), slice(32, 64)
    # the north/south contrast IS recovered (true totals: 0.20 vs 0.52)
    tot_south = float(np.mean((sa + so)[south]))
    tot_north = float(np.mean((sa + so)[north]))
    assert tot_south == pytest.approx(0.4**2 + 0.2**2, rel=0.15)
    assert tot_north == pytest.approx(0.4**2 + 0.6**2, rel=0.15)
    assert float(np.mean(so[north])) / float(np.mean(so[south])) > 2.0
    # per-band chi^2 consistency after the binned re-estimation
    for half, sl in (("south", south), ("north", north)):
        chi = float(innovation_stats(xa[sl], y[sl], np.asarray(res.xb)[sl],
                                     sa[sl], so[sl]).chi2)
        assert abs(chi - 1.0) < 0.15, (half, chi)


def test_global_desroziers_cannot_recover_contrast():
    """The degeneracy the binned estimator breaks: the global scalar scale
    keeps the prescribed (uniform) So spatially flat, so per-band chi^2
    stays wrong wherever the true errors vary."""
    xa, y, sa, so, _lat = _north_south_analysis()
    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    for _ in range(3):
        est = desroziers_estimates(xa, y, np.asarray(res.xb), sa, so)
        sa = sa * float(est.sa_scale)
        so = so * float(est.so_scale)
        res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
    assert float(np.std(so)) < 1e-12  # still uniform: no spatial structure
    chi_s = float(innovation_stats(xa[:32], y[:32], np.asarray(res.xb)[:32],
                                   sa[:32], so[:32]).chi2)
    chi_n = float(innovation_stats(xa[32:], y[32:], np.asarray(res.xb)[32:],
                                   sa[32:], so[32:]).chi2)
    assert abs(chi_s - 1.0) > 0.25 and abs(chi_n - 1.0) > 0.25


def test_driver_desroziers_bins_option():
    """Driver plumbing: desroziers_bins estimates per-lat-band scales and
    records the spread in oi_diagnostics."""
    from types import SimpleNamespace

    xa, y, sa, so, lat = _north_south_analysis()
    obj = oisatgmi()
    obj.ctm_averaged_vcd = xa
    obj.sat_averaged_vcd = y
    e = 100.0 * np.sqrt(np.mean(sa)) / np.mean(xa)
    obj.sat_averaged_error = np.sqrt(so)
    obj.aux1 = obj.aux2 = np.full_like(xa, np.nan)
    obj.reader_obj = SimpleNamespace(
        sat_data=[SimpleNamespace(latitude_center=lat)])
    obj.oi("OMI", error_ctm=e, desroziers_iterations=3, desroziers_bins=2)
    d = obj.oi_diagnostics
    assert d["desroziers_bins"] == 2
    assert d["desroziers_so_scale_max"] / d["desroziers_so_scale_min"] > 2.0
    assert abs(d["chi2"] - 1.0) < 0.15
    assert obj.desroziers_so_scale_map.shape == xa.shape


def test_binned_scale_maps_persist_to_diag(tmp_path):
    """The per-cell Sa/So scale maps of a binned Desroziers run land in the
    diag file (global runs write no such fields)."""
    import datetime
    from types import SimpleNamespace

    from oisat.ncwriter import read_diag_nc

    xa, y, sa, so, lat = _north_south_analysis()
    obj = oisatgmi()
    obj.ctm_averaged_vcd = xa
    obj.sat_averaged_vcd = y
    obj.sat_averaged_error = np.sqrt(so)
    obj.aux1 = obj.aux2 = np.full_like(xa, np.nan)
    lon = np.linspace(-100.0, -60.0, xa.shape[1])[None, :] * np.ones((xa.shape[0], 1))
    obj.reader_obj = SimpleNamespace(
        sat_data=[SimpleNamespace(latitude_center=lat, longitude_center=lon)])
    obj.avg_time = datetime.datetime(2005, 7, 15)
    e = 100.0 * np.sqrt(np.mean(sa)) / np.mean(xa)
    obj.oi("OMI", error_ctm=e, desroziers_iterations=2, desroziers_bins=2)
    obj.write_to_nc("binned", str(tmp_path))
    fields, _ = read_diag_nc(tmp_path / "binned.nc")
    np.testing.assert_allclose(fields["desroziers_so_scale"],
                               obj.desroziers_so_scale_map, rtol=1e-6)
    np.testing.assert_allclose(fields["desroziers_sa_scale"],
                               obj.desroziers_sa_scale_map, rtol=1e-6)
    # a global (1-bin) run writes no map fields
    obj.oi("OMI", error_ctm=e, desroziers_iterations=1)
    obj.write_to_nc("global", str(tmp_path))
    fields, _ = read_diag_nc(tmp_path / "global.nc")
    assert "desroziers_so_scale" not in fields


def test_driver_desroziers_bins_full_covariance():
    """method='full' honours desroziers_bins too (per-band scales applied to
    the sigma fields before the covariance solve)."""
    from types import SimpleNamespace

    xa, y, sa, so, lat = _north_south_analysis(H=24, W=32, seed=21)
    lon = np.linspace(-100.0, -60.0, 32)[None, :] * np.ones((24, 1))
    obj = oisatgmi()
    obj.ctm_averaged_vcd = xa
    obj.sat_averaged_vcd = y
    obj.sat_averaged_error = np.sqrt(so)
    obj.aux1 = obj.aux2 = np.full_like(xa, np.nan)
    obj.reader_obj = SimpleNamespace(sat_data=[SimpleNamespace(
        latitude_center=lat[:24, :32], longitude_center=lon)])
    e = 100.0 * np.sqrt(np.mean(sa)) / np.mean(xa)
    obj.oi("OMI", error_ctm=e, method="full", length_scale_km=150.0,
           desroziers_iterations=2, desroziers_bins=2)
    d = obj.oi_diagnostics
    assert d["desroziers_bins"] == 2
    assert d["desroziers_so_scale_max"] > d["desroziers_so_scale_min"]
    assert obj.desroziers_so_scale_map.shape == xa[:24, :32].shape
    # a following global run must not carry the stale maps
    obj.oi("OMI", error_ctm=e, desroziers_iterations=1)
    assert obj.desroziers_so_scale_map is None
