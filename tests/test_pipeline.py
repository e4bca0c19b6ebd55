import datetime
import os
from types import SimpleNamespace

import numpy as np
import pytest

from oisat.datamodel import ctm_model, satellite_amf
from oisat.driver import oisatgmi
from oisat.ncwriter import read_diag_nc
from oisat.ops.averaging import averaging, monthly_stats
from oisat.readers.ctm import free_ctm
from oisat.regridder import regrid_granule
from tests.reference_impl import error_average_numpy

import jax.numpy as jnp


def ctm_grid():
    return np.meshgrid(np.arange(-10, 11, 1.25), np.arange(30, 46, 1.0))


def synthetic_ctm(seed=0, nt=8, nz=12):
    rng = np.random.default_rng(seed)
    clon, clat = ctm_grid()
    H, W = clat.shape
    pmid = np.sort(rng.uniform(60, 1000, (nt, nz, H, W)), axis=1)[:, ::-1].copy()
    dp = rng.uniform(10, 40, (nt, nz, H, W))
    prof = np.abs(rng.normal(15, 4, (nt, nz, H, W)))
    times = [datetime.datetime(2019, 7, 5, 3 * h) for h in range(nt)]
    return ctm_model(clat, clon, times, prof.astype("float32"),
                     pmid.astype("float32"), [], dp.astype("float32"), "GMI", False)


def synthetic_granule(seed, day, nz=6):
    rng = np.random.default_rng(seed)
    ny, nx = 80, 50
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
    qa = np.ones((ny, nx))
    qa[rng.random((ny, nx)) < 0.01] = 0.0
    return satellite_amf(
        vcd=np.abs(rng.normal(3, 1, (ny, nx))),
        amf=np.abs(rng.normal(2, 0.3, (ny, nx))),
        time=datetime.datetime(2019, 7, day, 13, 30),
        tropopause=rng.uniform(100, 200, (ny, nx)),
        latitude_center=lat, longitude_center=lon,
        uncertainty=np.abs(rng.normal(1, 0.2, (ny, nx))),
        quality_flag=qa,
        pressure_mid=np.sort(rng.uniform(100, 950, (nz, ny, nx)), axis=0)[::-1].copy(),
        scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))),
    )


def test_monthly_stats_matches_reference_semantics():
    rng = np.random.default_rng(2)
    G, H, W = 6, 10, 12
    vcd = rng.normal(3, 1, (G, H, W))
    vcd[rng.random((G, H, W)) < 0.2] = np.nan
    vcd[0, 0, 0] = np.inf
    err = np.abs(rng.normal(1, 0.2, (G, H, W)))
    err[rng.random((G, H, W)) < 0.2] = np.nan
    err[1, 2, 3] = np.inf
    ctm = rng.normal(2, 0.5, (G, H, W))
    a1 = rng.normal(0, 1, (G, H, W))
    a2 = rng.normal(0, 1, (G, H, W))
    stats = monthly_stats(*(jnp.asarray(x) for x in (vcd, err, ctm, a1, a2)))
    vcd_s = np.where(np.isinf(vcd), np.nan, vcd)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        np.testing.assert_allclose(np.asarray(stats.sat_vcd), np.nanmean(vcd_s, 0), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(stats.ctm_vcd), np.nanmean(ctm, 0), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(stats.aux1), np.nanmean(a1, 0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(stats.sat_error), error_average_numpy(err**2), rtol=1e-12)


def test_end_to_end_synthetic(tmp_path):
    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    granules = [regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5) for s in range(4)]
    granules.append(None)  # a failed granule, like a corrupt L2 file
    for g, raw_seed in zip(granules[:4], range(4)):
        assert g is not None

    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    obj.gasname = "N"
    obj.recal_amf()
    for g in granules[:4]:
        assert g.ctm_vcd is not None and np.isfinite(g.ctm_vcd).sum() > 50
        assert np.isfinite(g.new_amf).sum() > 50
    obj.average("2019-07-01", "2019-08-01")
    assert obj.sat_averaged_vcd.shape == clat.shape
    obj.bias_correct("OMI", "NO2")
    obj.oi("OMI", error_ctm=50.0)
    assert obj.ctm_averaged_vcd_corrected.shape == clat.shape
    # posterior pulled toward observations where data exists
    m = np.isfinite(obj.ctm_averaged_vcd_corrected) & np.isfinite(obj.ctm_averaged_vcd)
    assert m.sum() > 50
    obj.write_to_nc("diag_test", str(tmp_path))
    fields, tstr = read_diag_nc(tmp_path / "diag_test.nc")
    assert set(fields) == {
        "sat_averaged_vcd", "ctm_averaged_vcd_prior", "ctm_averaged_vcd_posterior",
        "sat_averaged_error", "ak_OI", "error_OI", "scaling_factor", "lon", "lat",
        "aux1", "aux2"}
    assert tstr.startswith("2019-07")
    sf = fields["scaling_factor"]
    assert np.isfinite(sf).all()
    assert (sf[~np.isclose(sf, 1.0)] != 0).all()
    # savedaily writes a .mat per granule
    obj.savedaily(str(tmp_path / "mats"), "NO2", "201907")
    assert len(os.listdir(tmp_path / "mats")) == 4


def test_averaging_buckets_and_time():
    clon, clat = ctm_grid()
    granules = [regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5) for s in range(3)]
    for g in granules:
        g.ctm_vcd = np.ones_like(g.vcd)
        g.new_amf = np.ones_like(g.vcd)
        g.old_amf = np.ones_like(g.vcd)
    robj = SimpleNamespace(sat_data=granules)
    vcd, err, ctmv, a1, a2, t = averaging("2019-07-01", "2019-08-01", robj)
    assert vcd.shape == clat.shape
    assert t.year == 2019 and t.month == 7
    np.testing.assert_allclose(a1[np.isfinite(a1)], 1.0)


def test_free_ctm(tmp_path):
    p = tmp_path / "control_free.yml"
    p.write_text("latll: 20\nlatur: 50\nlonll: -120\nlonur: -60\ngridsize: 1.0\n")
    data = free_ctm(str(p))
    assert len(data) == 1
    assert data[0].ctmtype == "FREE"
    assert data[0].averaged is True
    assert data[0].latitude.shape == (31, 61)
    assert np.isnan(data[0].gas_profile).all()


def test_driver_full_covariance_oi():
    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    granules = [regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5) for s in range(2)]
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    obj.recal_amf()
    obj.average("2019-07-01", "2019-08-01")
    obj.oi("OMI", error_ctm=50.0, method="full", length_scale_km=250.0)
    m = np.isfinite(obj.ctm_averaged_vcd_corrected)
    assert m.sum() > 50
    assert np.nanmax(obj.ak_OI) <= 1.0 + 1e-6
    # and the scalar method still works on the same state
    obj.oi("OMI", error_ctm=50.0)
    assert np.isfinite(obj.ctm_averaged_vcd_corrected).sum() > 50


def test_innovation_diagnostics():
    from oisat.ops.diagnostics import innovation_stats

    rng = np.random.default_rng(12)
    H, W = 40, 50
    xa = np.abs(rng.normal(3, 1, (H, W)))
    sa = np.full((H, W), 0.5**2)
    so = np.full((H, W), 0.3**2)
    # consistent errors: innovation variance == Sa + So
    y = xa + rng.normal(0, np.sqrt(sa + so), (H, W))
    xb = 0.5 * (xa + y)
    xa[0, :5] = np.nan
    st = innovation_stats(xa, y, xb, sa, so)
    assert int(st.n) == H * W - 5
    assert abs(float(st.chi2) - 1.0) < 0.15          # chi2 ~ 1 when consistent
    assert float(st.oma_rms) < float(st.omb_rms)     # analysis closer to obs
    # inflated obs error -> chi2 << 1
    st2 = innovation_stats(xa, y, xb, sa, so * 100)
    assert float(st2.chi2) < 0.2


def test_driver_reports_diagnostics():
    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    granules = [regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5) for s in range(2)]
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    obj.recal_amf()
    obj.average("2019-07-01", "2019-08-01")
    obj.oi("OMI")
    assert set(obj.oi_diagnostics) == {"n", "omb_mean", "omb_rms", "oma_mean",
                                       "oma_rms", "chi2"}
    assert obj.oi_diagnostics["n"] > 50


def test_multi_year_averaging_buckets():
    """Multi-year ranges (the GOSAT 2005-2019 reanalysis shape): granules
    bucket into a (H, W, months, years) array — correctly per month, unlike
    the reference's year-level store quirk (documented deviation)."""
    clon, clat = ctm_grid()
    granules = []
    for year in (2010, 2011):
        for month in (6, 7):
            g = regrid_granule(1, 0.25, synthetic_granule(year + month, 4), clon, clat,
                               flag_thresh=0.5)
            g.time = datetime.datetime(year, month, 15)
            g.ctm_vcd = np.full_like(g.vcd, float(year + month))
            g.new_amf = np.ones_like(g.vcd)
            g.old_amf = np.ones_like(g.vcd)
            granules.append(g)
    robj = SimpleNamespace(sat_data=granules)
    vcd, err, ctmv, a1, a2, t = averaging("2010-06-01", "2011-08-01", robj)
    # a range crossing the year boundary covers all 12 calendar months
    # (reference month-range semantics), over 2 years
    assert vcd.shape == clat.shape + (12, 2)
    # each bucket carries its own month's data (no last-month overwrite)
    for yi, year in enumerate((2010, 2011)):
        for month in (6, 7):
            vals = ctmv[:, :, month - 1, yi]
            np.testing.assert_allclose(vals[np.isfinite(vals)], year + month)


def test_diag_carries_oi_diagnostics(tmp_path):
    import h5py

    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    granules = [regrid_granule(1, 0.25, synthetic_granule(0, 4), clon, clat,
                               flag_thresh=0.5)]
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    obj.recal_amf()
    obj.average("2019-07-01", "2019-08-01")
    obj.oi("OMI")
    obj.write_to_nc("d", str(tmp_path))
    with h5py.File(tmp_path / "d.nc") as f:
        assert "chi2" in f.attrs and "omb_rms" in f.attrs
