"""Differential tests against the reference's OWN importable kernels.

Everything else in the suite asserts parity against independently
re-derived float64 goldens (tests/reference_impl.py).  These tests close
the authorship loop: they import the ACTUAL reference modules from
/root/reference (read-only) and assert our staged operators and
parity-mode regrid agree with the reference binary itself.

Import strategy: ``oisatgmi/__init__.py`` pulls in the driver (netCDF4,
Basemap — not installed), so we register a bare package whose ``__path__``
points at the reference checkout and import submodules directly; the
science kernels themselves are numpy/scipy-only
(reference interpolator.py:1-8, amf_recal.py:1-4, ak_conv_mopitt.py:1-5,
ak_conv_gosat.py:1-5, pwv_cal.py:1-4, averaging.py:1-4).

Two environment shims, both test-harness-side (the reference is never
edited):

* scipy >= 1.13 moved ``_ndim_coords_from_arrays`` to
  ``scipy.interpolate._interpnd``; we re-expose it at the old name.
* ``kneed`` is not installed; ``optimal_interpolation`` gets a stub
  KneeLocator backed by our own Kneedle.  The OI differential therefore
  validates the OI update math around a SHARED knee pick; the Kneedle
  implementation itself is validated separately against the frozen
  kneed-spec corpus (test_knee.py / tests/golden/knee_corpus.json).
  ``regularization_on=False`` cases share nothing.
"""

from __future__ import annotations

import copy
import datetime
import importlib
import os
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp

REF_ROOT = "/root/reference"


def _ref(name):
    """Import ``oisatgmi.<name>`` from the read-only reference checkout."""
    if "oisatgmi" not in sys.modules or not getattr(
            sys.modules["oisatgmi"], "__path__", [""])[0].startswith(REF_ROOT):
        pkg = types.ModuleType("oisatgmi")
        pkg.__path__ = [REF_ROOT + "/oisatgmi"]
        sys.modules["oisatgmi"] = pkg
    import scipy.interpolate.interpnd as interpnd

    if not hasattr(interpnd, "_ndim_coords_from_arrays"):
        from scipy.interpolate._interpnd import _ndim_coords_from_arrays

        interpnd._ndim_coords_from_arrays = _ndim_coords_from_arrays
    if "kneed" not in sys.modules:
        # NOTE: a plain `import importlib.machinery` here would bind
        # `importlib` as a function-local and shadow the module-level
        # import for the whole function body
        from importlib.machinery import ModuleSpec

        from oisat.ops.knee import kneedle_index_np

        kneed = types.ModuleType("kneed")
        # a bare ModuleType has __spec__ = None, which makes a later
        # importlib.util.find_spec("kneed") RAISE ValueError instead of
        # reporting the module — give the stub a real (loader-less) spec
        kneed.__spec__ = ModuleSpec("kneed", None)

        class KneeLocator:
            def __init__(self, x, y, S=1.0, curve="concave",
                         direction="increasing", **kw):
                assert direction == "increasing" and curve == "concave"
                x = np.asarray(x, np.float64)
                idx = kneedle_index_np(x, np.asarray(y, np.float64),
                                       S=S, fallback=-1)
                self.knee = None if idx < 0 else x[idx]

        kneed.KneeLocator = KneeLocator
        sys.modules["kneed"] = kneed
    mod = importlib.import_module("oisatgmi." + name)
    assert mod.__file__.startswith(REF_ROOT)
    return mod


def _as_ref(obj, ref_cls):
    """Rebuild one of our dataclass instances as the reference's config
    dataclass (same field names; reference functions isinstance-check
    against their own classes, e.g. interpolator.py:169, averaging.py:82)."""
    import dataclasses

    kw = {f.name: copy.deepcopy(getattr(obj, f.name, None))
          for f in dataclasses.fields(ref_cls)}
    return ref_cls(**kw)


@pytest.fixture(autouse=True)
def _reference_tree():
    """These tests import the reference checkout itself; without it there
    is nothing to compare against (decided here, at run time, so every
    xdist worker collects the same tests)."""
    if not os.path.isdir(os.path.join(REF_ROOT, "oisatgmi")):
        pytest.skip(f"reference checkout {REF_ROOT} is absent")


@pytest.fixture(autouse=True)
def _full_precision(monkeypatch):
    """Reference comparisons run the parity path: scipy weight builders +
    full-precision transfers (the production f16/fast-swath switches are
    covered by their own tests)."""
    monkeypatch.setenv("OISAT_PARITY", "1")
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")


# ---------------------------------------------------------------- OI core


@pytest.mark.parametrize("reg_on", [False, True])
def test_oi_matches_reference(reg_on):
    """ops.oi.oi vs reference optimal_interpolation.OI (:6-52)."""
    ref_oi = _ref("optimal_interpolation")
    rng = np.random.default_rng(11)
    H, W = 24, 31
    xa = np.abs(rng.normal(3.0, 1.0, (H, W)))
    y = rng.normal(3.2, 1.1, (H, W))  # keep negatives: the y<0 clamp path
    sa = np.abs(rng.normal(1.0, 0.3, (H, W))) ** 2
    so = np.abs(rng.normal(0.8, 0.2, (H, W))) ** 2
    nan = rng.random((H, W)) < 0.15
    for a in (xa, y, sa, so):
        a[nan] = np.nan

    xb_r, ak_r, inc_r, sbs_r = ref_oi.OI(
        xa.copy(), y.copy(), sa.copy(), so.copy(), regularization_on=reg_on)

    from oisat.ops.oi import oi

    res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa),
             jnp.asarray(so), regularization_on=reg_on)
    kw = dict(rtol=1e-12, atol=1e-15, equal_nan=True)
    np.testing.assert_allclose(np.asarray(res.xb), xb_r, **kw)
    np.testing.assert_allclose(np.asarray(res.averaging_kernel), ak_r, **kw)
    np.testing.assert_allclose(np.asarray(res.increment), inc_r, **kw)
    np.testing.assert_allclose(np.asarray(res.error), sbs_r, **kw)


# ------------------------------------------------------------- _upscaler


def _ctm_grid(dlon=1.25, dlat=1.0):
    return np.meshgrid(np.arange(-10, 11, dlon), np.arange(30, 46, dlat))


def test_upscaler_matches_reference():
    """make_upscaler parity path vs reference _upscaler (interpolator.py:48-97)."""
    ref_interp = _ref("interpolator")
    rng = np.random.default_rng(5)
    clon, clat = _ctm_grid()
    grid_size = 0.25
    lon_g = np.arange(clon.min(), clon.max() + grid_size, grid_size)
    lat_g = np.arange(clat.min(), clat.max() + grid_size, grid_size)
    lons, lats = np.meshgrid(lon_g, lat_g)
    Z = rng.normal(2.0, 1.0, lons.shape)
    Z[rng.random(lons.shape) < 0.1] = np.nan
    threshold = np.hypot(1.25, 1.0)

    for error in (False, True):
        _, _, z_ref, needed = ref_interp._upscaler(
            lons, lats, Z.copy(), {"Longitude": clon, "Latitude": clat},
            grid_size, threshold, error=error)
        assert needed is False

        from oisat.regridder import make_upscaler

        up = make_upscaler(lons, lats, clon, clat, grid_size, threshold,
                           method=4, far_factor=2.0, fast=False)
        z_ours = np.asarray(up.apply(jnp.asarray(Z), error=error), np.float64)
        np.testing.assert_allclose(z_ours, z_ref, rtol=1e-10, equal_nan=True)


# ------------------------------------------------- regrid (interpolator)


def _amf_granule(seed=3, ny=60, nx=40, nz=4):
    from oisat.datamodel import satellite_amf

    rng = np.random.default_rng(seed)
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
    lat += rng.normal(0, 0.01, lat.shape)
    lon += rng.normal(0, 0.01, lon.shape)
    qa = np.ones((ny, nx))
    qa[rng.random((ny, nx)) < 0.05] = 0.0
    return satellite_amf(
        vcd=np.abs(rng.normal(3, 1, (ny, nx))),
        amf=np.abs(rng.normal(2, 0.3, (ny, nx))),
        time=datetime.datetime(2019, 7, 4, 13, 30),
        tropopause=rng.uniform(100, 200, (ny, nx)),
        latitude_center=lat, longitude_center=lon,
        uncertainty=np.abs(rng.normal(1, 0.2, (ny, nx))),
        quality_flag=qa,
        pressure_mid=np.sort(rng.uniform(100, 950, (nz, ny, nx)), axis=0)[::-1].copy(),
        scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))),
    )


@pytest.mark.parametrize("method", [1, 2, 4])
def test_regrid_amf_matches_reference_interpolator(method):
    """Parity-mode regrid_granule vs the reference interpolator
    (interpolator.py:100-291) on a satellite_amf granule."""
    ref_interp = _ref("interpolator")
    ref_cfg = _ref("config")
    clon, clat = _ctm_grid()
    g = _amf_granule()
    ref_g = _as_ref(g, ref_cfg.satellite_amf)

    out_ref = ref_interp.interpolator(
        method, 0.25, ref_g, {"Longitude": clon, "Latitude": clat},
        flag_thresh=0.5)
    assert out_ref is not None

    from oisat.regridder import regrid_granule

    out = regrid_granule(method, 0.25, copy.deepcopy(g), clon, clat,
                         flag_thresh=0.5, dtype=np.float64, fast_swath=False)
    assert out is not None
    for name in ("vcd", "amf", "tropopause", "uncertainty",
                 "scattering_weights", "pressure_mid"):
        ours = np.asarray(getattr(out, name), np.float64)
        ref = np.asarray(getattr(out_ref, name), np.float64)
        assert ours.shape == ref.shape, name
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=1e-12,
                                   equal_nan=True, err_msg=name)
    np.testing.assert_allclose(np.asarray(out.latitude_center),
                               out_ref.latitude_center, rtol=0)
    np.testing.assert_allclose(np.asarray(out.longitude_center),
                               out_ref.longitude_center, rtol=0)
    assert bool(out.ctm_upscaled_needed) == bool(out_ref.ctm_upscaled_needed)


def _opt_granule(sensor, seed=7, ny=50, nx=36, nz=5):
    from oisat.datamodel import satellite_opt

    rng = np.random.default_rng(seed)
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
    lat += rng.normal(0, 0.01, lat.shape)
    lon += rng.normal(0, 0.01, lon.shape)
    qa = np.ones((ny, nx))
    qa[rng.random((ny, nx)) < 0.05] = 0.0
    nak = nz + 1 if sensor == "MOPITT" else nz
    return satellite_opt(
        vcd=np.abs(rng.normal(2, 0.5, (ny, nx))),
        time=datetime.datetime(2019, 7, 9, 10, 30),
        profile=np.empty((1,)),
        tropopause=np.empty((1,)),
        latitude_center=lat, longitude_center=lon,
        latitude_corner=np.empty((1,)), longitude_corner=np.empty((1,)),
        uncertainty=np.abs(rng.normal(0.5, 0.1, (ny, nx))),
        quality_flag=qa,
        pressure_mid=np.sort(rng.uniform(100, 950, (nz, ny, nx)), axis=0)[::-1].copy(),
        averaging_kernels=np.abs(rng.normal(0.8, 0.2, (nak, ny, nx))),
        ctm_upscaled_needed=False,
        aprior_column=np.abs(rng.normal(1.5, 0.3, (ny, nx))),
        apriori_profile=np.abs(rng.normal(80, 10, (nz, ny, nx))),
        surface_pressure=rng.uniform(900, 1010, (ny, nx)),
        apriori_surface=np.abs(rng.normal(90, 10, (ny, nx))),
        x_col=np.abs(rng.normal(1800, 15, (ny, nx))),
        pressure_weight=np.abs(rng.normal(0.2, 0.02, (nz, ny, nx))),
        sensor=sensor,
    )


@pytest.mark.parametrize("sensor", ["MOPITT", "GOSAT"])
def test_regrid_opt_matches_reference_interpolator(sensor):
    """Parity-mode regrid_granule vs the reference interpolator on a
    satellite_opt granule (interpolator.py:216-279 sensor branches)."""
    ref_interp = _ref("interpolator")
    ref_cfg = _ref("config")
    clon, clat = _ctm_grid()
    g = _opt_granule(sensor)
    ref_g = _as_ref(g, ref_cfg.satellite_opt)

    out_ref = ref_interp.interpolator(
        1, 0.25, ref_g, {"Longitude": clon, "Latitude": clat}, flag_thresh=0.5)
    assert out_ref is not None

    from oisat.regridder import regrid_granule

    out = regrid_granule(1, 0.25, copy.deepcopy(g), clon, clat,
                         flag_thresh=0.5, dtype=np.float64, fast_swath=False)
    assert out is not None
    fields = ["vcd", "uncertainty", "pressure_mid", "averaging_kernels",
              "apriori_profile", "aprior_column", "surface_pressure",
              "apriori_surface", "x_col"]
    if sensor == "GOSAT":
        fields.append("pressure_weight")
    for name in fields:
        ours = np.asarray(getattr(out, name), np.float64)
        ref = np.asarray(getattr(out_ref, name), np.float64)
        assert ours.shape == ref.shape, name
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=1e-12,
                                   equal_nan=True, err_msg=name)


# ------------------------------------------------------ staged operators


def _gridded_amf_granules(clon, clat, n=2, nz=4, seed0=20, trop=True):
    """Granules already on the CTM grid (the post-regrid state amf_recal
    consumes when no upscaling is needed)."""
    from oisat.datamodel import satellite_amf

    H, W = clat.shape
    out = []
    for k in range(n):
        rng = np.random.default_rng(seed0 + k)
        vcd = np.abs(rng.normal(3, 1, (H, W)))
        vcd[rng.random((H, W)) < 0.1] = np.nan
        out.append(satellite_amf(
            vcd=vcd,
            amf=np.abs(rng.normal(2, 0.3, (H, W))),
            time=datetime.datetime(2019, 7, 3 + k, 13, 30),
            tropopause=(rng.uniform(100, 200, (H, W)) if trop
                        else np.empty((1,))),
            latitude_center=clat, longitude_center=clon,
            uncertainty=np.abs(rng.normal(1, 0.2, (H, W))),
            quality_flag=np.ones((H, W)),
            pressure_mid=np.sort(rng.uniform(100, 950, (nz, H, W)), axis=0)[::-1].copy(),
            scattering_weights=np.abs(rng.normal(1, 0.2, (nz, H, W))),
            ctm_upscaled_needed=False,
        ))
    return out


def _gmi_ctm(clon, clat, nt=8, nzc=9, seed=2):
    from oisat.datamodel import ctm_model

    rng = np.random.default_rng(seed)
    H, W = clat.shape
    pmid = np.sort(rng.uniform(60, 1000, (nt, nzc, H, W)), axis=1)[:, ::-1].copy()
    dp = rng.uniform(10, 40, (nt, nzc, H, W))
    prof = np.abs(rng.normal(15, 4, (nt, nzc, H, W)))
    times = [datetime.datetime(2019, 7, 5, 3 * h) for h in range(nt)]
    return ctm_model(clat, clon, times, prof, pmid, [], dp, "GMI", False)


@pytest.mark.parametrize("trop", [True, False])
def test_amf_recal_matches_reference(trop):
    """obs_operators.amf_recal vs reference amf_recal (amf_recal.py:121-185),
    same-grid (non-upscaled) path."""
    ref_amf = _ref("amf_recal")
    ref_cfg = _ref("config")
    clon, clat = _ctm_grid()
    ctm = _gmi_ctm(clon, clat)
    sats = _gridded_amf_granules(clon, clat, n=2, trop=trop) + [None]

    ref_ctm = _as_ref(ctm, ref_cfg.ctm_model)
    ref_sats = [None if g is None else _as_ref(g, ref_cfg.satellite_amf)
                for g in sats]
    ref_out = ref_amf.amf_recal([ref_ctm], ref_sats)

    from oisat.obs_operators import amf_recal

    out = amf_recal([ctm], sats)
    for g, rg in zip(out, ref_out):
        if g is None:
            assert rg is None
            continue
        np.testing.assert_allclose(np.asarray(g.new_amf, np.float64),
                                   rg.new_amf, rtol=1e-6, atol=1e-10,
                                   equal_nan=True)
        np.testing.assert_allclose(np.asarray(g.vcd, np.float64), rg.vcd,
                                   rtol=1e-6, atol=1e-10, equal_nan=True)
        np.testing.assert_allclose(np.asarray(g.ctm_vcd, np.float64),
                                   rg.ctm_vcd, rtol=1e-6, atol=1e-10,
                                   equal_nan=True)
        assert float(g.ctm_time_at_sat) == float(rg.ctm_time_at_sat)


def test_amf_recal_noak_matches_reference():
    """The no-scattering-weights branch (amf_recal.py:160-172)."""
    ref_amf = _ref("amf_recal")
    ref_cfg = _ref("config")
    clon, clat = _ctm_grid()
    ctm = _gmi_ctm(clon, clat)
    sats = _gridded_amf_granules(clon, clat, n=1)
    sats[0].scattering_weights = np.empty((1,))

    ref_ctm = _as_ref(ctm, ref_cfg.ctm_model)
    ref_sats = [_as_ref(g, ref_cfg.satellite_amf) for g in sats]
    ref_out = ref_amf.amf_recal([ref_ctm], ref_sats)

    from oisat.obs_operators import amf_recal

    out = amf_recal([ctm], sats)
    np.testing.assert_allclose(np.asarray(out[0].ctm_vcd, np.float64),
                               ref_out[0].ctm_vcd, rtol=1e-6, atol=1e-10,
                               equal_nan=True)
    assert np.size(out[0].new_amf) == 1


def _eccoh_ctm(clon, clat, nzc=9, seed=4, gas=80.0):
    from oisat.datamodel import ctm_model

    rng = np.random.default_rng(seed)
    H, W = clat.shape
    pmid = np.sort(rng.uniform(60, 1000, (nzc, H, W)), axis=0)[::-1].copy()
    dp = rng.uniform(10, 40, (nzc, H, W))
    prof = np.abs(rng.normal(gas, gas / 8, (nzc, H, W)))
    return ctm_model(clat, clon, [datetime.datetime(2019, 7, 1)], prof,
                     pmid, [], dp, "ECCOH", True)


def test_ak_conv_mopitt_matches_reference():
    """obs_operators.ak_conv_mopitt vs reference ak_conv_mopitt.py:118-146."""
    ref_mod = _ref("ak_conv_mopitt")
    ref_cfg = _ref("config")
    clon, clat = _ctm_grid()
    H, W = clat.shape
    ctm = _eccoh_ctm(clon, clat)
    g = _opt_granule("MOPITT", ny=H, nx=W)
    g.latitude_center, g.longitude_center = clat, clon
    g.vcd[np.random.default_rng(1).random((H, W)) < 0.1] = np.nan
    sats = [g, None]

    ref_ctm = _as_ref(ctm, ref_cfg.ctm_model)
    ref_sats = [_as_ref(g, ref_cfg.satellite_opt), None]
    ref_out = ref_mod.ak_conv_mopitt([ref_ctm], ref_sats)

    from oisat.obs_operators import ak_conv_mopitt

    out = ak_conv_mopitt([ctm], sats)
    np.testing.assert_allclose(np.asarray(out[0].ctm_vcd, np.float64),
                               ref_out[0].ctm_vcd, rtol=1e-6, atol=1e-10,
                               equal_nan=True)
    np.testing.assert_allclose(np.asarray(out[0].ctm_xcol, np.float64),
                               ref_out[0].ctm_xcol, rtol=1e-6, atol=1e-10,
                               equal_nan=True)


def test_ak_conv_gosat_matches_reference():
    """obs_operators.ak_conv_gosat vs reference ak_conv_gosat.py:118-141."""
    ref_mod = _ref("ak_conv_gosat")
    ref_cfg = _ref("config")
    clon, clat = _ctm_grid()
    H, W = clat.shape
    ctm = _eccoh_ctm(clon, clat, gas=1800.0)
    g = _opt_granule("GOSAT", ny=H, nx=W)
    g.latitude_center, g.longitude_center = clat, clon
    g.x_col[np.random.default_rng(2).random((H, W)) < 0.1] = np.nan
    sats = [g]

    ref_ctm = _as_ref(ctm, ref_cfg.ctm_model)
    ref_sats = [_as_ref(g, ref_cfg.satellite_opt)]
    ref_out = ref_mod.ak_conv_gosat([ref_ctm], ref_sats)

    from oisat.obs_operators import ak_conv_gosat

    out = ak_conv_gosat([ctm], sats)
    np.testing.assert_allclose(np.asarray(out[0].ctm_xcol, np.float64),
                               ref_out[0].ctm_xcol, rtol=1e-6, atol=1e-10,
                               equal_nan=True)


def test_pwv_matches_reference():
    """obs_operators.pwv_calculator vs reference pwv_cal.py:7-105."""
    ref_mod = _ref("pwv_cal")
    ref_cfg = _ref("config")
    from oisat.datamodel import satellite_ssmis

    clon, clat = _ctm_grid()
    H, W = clat.shape
    ctm = _eccoh_ctm(clon, clat, gas=3e-3, seed=9)
    rng = np.random.default_rng(12)
    vcd = np.abs(rng.normal(20, 5, (H, W)))
    vcd[rng.random((H, W)) < 0.1] = np.nan
    g = satellite_ssmis(vcd=vcd, uncertainty=np.abs(rng.normal(1, 0.2, (H, W))),
                        time=datetime.datetime(2019, 7, 2, 6),
                        latitude_center=clat, longitude_center=clon,
                        ctm_upscaled_needed=False)
    ref_ctm = _as_ref(ctm, ref_cfg.ctm_model)
    ref_sats = [_as_ref(g, ref_cfg.satellite_ssmis), None]
    ref_out = ref_mod.pwv_calculator([ref_ctm], ref_sats)

    from oisat.obs_operators import pwv_calculator

    out = pwv_calculator([ctm], [g, None])
    np.testing.assert_allclose(np.asarray(out[0].ctm_vcd, np.float64),
                               ref_out[0].ctm_vcd, rtol=1e-6, atol=1e-12,
                               equal_nan=True)


def test_amf_recal_upscaled_matches_reference():
    """The ctm_upscaled_needed=True path: CTM finer than the granule grid,
    reference upscales per level via _upscaler (amf_recal.py:62-88)."""
    ref_amf = _ref("amf_recal")
    ref_cfg = _ref("config")
    # coarse sat grid (2 deg), fine CTM (1.25 x 1 deg)
    slon, slat = np.meshgrid(np.arange(-10, 11, 2.0), np.arange(30, 46, 2.0))
    clon, clat = _ctm_grid()
    ctm = _gmi_ctm(clon, clat)
    sats = _gridded_amf_granules(slon, slat, n=1, trop=True)
    sats[0].ctm_upscaled_needed = True

    ref_ctm = _as_ref(ctm, ref_cfg.ctm_model)
    ref_sats = [_as_ref(sats[0], ref_cfg.satellite_amf)]
    ref_out = ref_amf.amf_recal([ref_ctm], ref_sats)

    from oisat.obs_operators import amf_recal

    out = amf_recal([ctm], sats)
    np.testing.assert_allclose(np.asarray(out[0].new_amf, np.float64),
                               ref_out[0].new_amf, rtol=1e-6, atol=1e-10,
                               equal_nan=True)
    np.testing.assert_allclose(np.asarray(out[0].ctm_vcd, np.float64),
                               ref_out[0].ctm_vcd, rtol=1e-6, atol=1e-10,
                               equal_nan=True)


# -------------------------------------------------------------- averaging


def test_averaging_matches_reference():
    """ops.averaging.averaging vs reference averaging.py:26-120 on a
    single-month mixed bucket."""
    ref_avg = _ref("averaging")
    ref_cfg = _ref("config")
    clon, clat = _ctm_grid()
    sats = _gridded_amf_granules(clon, clat, n=3)
    rng = np.random.default_rng(31)
    H, W = clat.shape
    for g in sats:
        g.ctm_vcd = np.abs(rng.normal(2.5, 0.6, (H, W)))
        g.new_amf = np.abs(rng.normal(2, 0.3, (H, W)))
        g.old_amf = np.abs(rng.normal(2, 0.3, (H, W)))
        g.uncertainty[rng.random((H, W)) < 0.1] = np.nan
    sats.append(None)

    ref_sats = [None if g is None else _as_ref(g, ref_cfg.satellite_amf)
                for g in sats]
    ref_res = ref_avg.averaging("2019-07-01", "2019-08-01",
                                SimpleNamespace(sat_data=ref_sats))

    from oisat.ops.averaging import averaging

    res = averaging("2019-07-01", "2019-08-01", SimpleNamespace(sat_data=sats))
    names = ("sat_vcd", "sat_error", "ctm_vcd", "aux1", "aux2")
    for ours, ref, name in zip(res[:5], ref_res[:5], names):
        np.testing.assert_allclose(np.asarray(ours, np.float64),
                                   np.asarray(ref, np.float64), rtol=1e-9,
                                   atol=1e-12, equal_nan=True, err_msg=name)
    assert abs((res[5] - ref_res[5]).total_seconds()) < 1.0


# ------------------------------------------------------ SSMIS and filler


def test_regrid_ssmis_matches_reference():
    """regrid_ssmis_granule vs reference interpolator_ssmis (:96-168).

    The reference casts the fine-grid coords to float16
    (interpolator_ssmis.py:141) — a documented deviation on our side.  On
    this domain every 0.25-degree coordinate is exactly representable in
    float16, so the two geometries coincide and the comparison is tight.
    """
    ref_mod = _ref("interpolator_ssmis")
    ref_cfg = _ref("config")
    from oisat.datamodel import satellite_ssmis

    rng = np.random.default_rng(17)
    ny, nx = 70, 44
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
    lat += rng.normal(0, 0.01, lat.shape)
    lon += rng.normal(0, 0.01, lon.shape)
    vcd = np.abs(rng.normal(20, 5, (ny, nx)))
    vcd[rng.random((ny, nx)) < 0.05] = np.nan
    g = satellite_ssmis(vcd=vcd,
                        uncertainty=np.abs(rng.normal(1, 0.2, (ny, nx))),
                        time=datetime.datetime(2019, 7, 2, 6),
                        latitude_center=lat, longitude_center=lon)
    clon, clat = _ctm_grid()
    ref_out = ref_mod.interpolator_ssmis(
        1, 0.25, _as_ref(g, ref_cfg.satellite_ssmis),
        {"Longitude": clon, "Latitude": clat})
    assert ref_out is not None

    from oisat.regridder import regrid_ssmis_granule

    out = regrid_ssmis_granule(0.25, g, clon, clat, dtype=np.float64,
                               fast_swath=False)
    assert out is not None
    np.testing.assert_allclose(np.asarray(out.vcd, np.float64), ref_out.vcd,
                               rtol=1e-8, atol=1e-12, equal_nan=True)
    np.testing.assert_allclose(np.asarray(out.uncertainty, np.float64),
                               ref_out.uncertainty, rtol=1e-8, atol=1e-12,
                               equal_nan=True)


def test_filler_gosat_matches_reference():
    """sensors.gosat.filler_gosatxch4 vs reference filler_gosat.py:87-201.

    grid_size=0.5 keeps the reference's float16 fine-grid coordinates
    exact, and its fake 0.1-degree CTM makes the upscaler a passthrough,
    so the documented f16-coord deviation does not bite here.
    """
    ref_mod = _ref("filler_gosat")
    ref_cfg = _ref("config")
    from oisat.datamodel import satellite_opt

    rng = np.random.default_rng(23)
    n, nz = 400, 5  # 1-D sounding arrays, like the reference GOSAT reader
    g = satellite_opt(
        vcd=np.abs(rng.normal(1800, 15, n)),
        time=datetime.datetime(2019, 7, 9, 10, 30),
        profile=np.empty((1,)), tropopause=np.empty((1,)),
        latitude_center=rng.uniform(-60, 60, n),
        longitude_center=rng.uniform(-150, 150, n),
        latitude_corner=np.empty((1,)), longitude_corner=np.empty((1,)),
        uncertainty=np.abs(rng.normal(8, 1, n)),
        quality_flag=np.ones(n),
        pressure_mid=np.sort(rng.uniform(100, 950, (nz, n)), axis=0)[::-1].copy(),
        averaging_kernels=np.abs(rng.normal(0.8, 0.2, (nz, n))),
        aprior_column=np.empty((1,)),
        apriori_profile=np.abs(rng.normal(1800, 30, (nz, n))),
        surface_pressure=np.empty((1,)), apriori_surface=np.empty((1,)),
        x_col=np.abs(rng.normal(1800, 15, n)),
        pressure_weight=np.abs(rng.normal(0.2, 0.02, (nz, n))),
        sensor="GOSAT")

    ref_out = ref_mod.filler_gosatxch4(
        0.5, _as_ref(g, ref_cfg.satellite_opt), flag_thresh=0.5)
    assert ref_out is not None

    from oisat.readers.sensors.gosat import filler_gosatxch4

    out = filler_gosatxch4(0.5, copy.deepcopy(g), flag_thresh=0.5)
    assert out is not None
    np.testing.assert_allclose(np.asarray(out.x_col, np.float64),
                               ref_out.x_col, rtol=1e-8, atol=1e-12,
                               equal_nan=True)
    np.testing.assert_allclose(np.asarray(out.uncertainty, np.float64),
                               ref_out.uncertainty, rtol=1e-8, atol=1e-12,
                               equal_nan=True)


@pytest.mark.parametrize("method", [2, 4])
def test_regrid_fast_nearest_matches_reference(method, monkeypatch):
    """The NATIVE fast-swath builder's nearest modes (hash ring search)
    make the same pixel picks as the reference's cKDTree — differential
    against the actual reference interpolator, not our scipy path.
    (Linear method 1 is excluded by design: the fast path's quad
    triangulation differs from qhull in the in-quad diagonal choice.)"""
    from oisat import native

    if not native.available():
        pytest.skip("native builder unavailable: fast_swath would fall "
                    "back to scipy and this differential would be vacuous")
    monkeypatch.setenv("OISAT_PARITY", "0")  # fast builder ON
    ref_interp = _ref("interpolator")
    ref_cfg = _ref("config")
    clon, clat = _ctm_grid()
    g = _amf_granule(seed=9)
    ref_g = _as_ref(g, ref_cfg.satellite_amf)

    out_ref = ref_interp.interpolator(
        method, 0.25, ref_g, {"Longitude": clon, "Latitude": clat},
        flag_thresh=0.5)
    assert out_ref is not None

    from oisat.regridder import regrid_granule

    out = regrid_granule(method, 0.25, copy.deepcopy(g), clon, clat,
                         flag_thresh=0.5, dtype=np.float64, fast_swath=True)
    assert out is not None
    for name in ("vcd", "amf", "uncertainty"):
        ours = np.asarray(getattr(out, name), np.float64)
        ref = np.asarray(getattr(out_ref, name), np.float64)
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=1e-12,
                                   equal_nan=True, err_msg=name)
