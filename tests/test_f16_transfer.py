"""Production float16-transfer mode, end-to-end (VERDICT r2 items 1/3).

The default production mode transfers per-level 3-D field stacks host->device
as float16 (the reference's own storage precision for those fields).  Fields
whose finite magnitude exceeds f16 range must NOT be narrowed: the cast
overflows to inf and one inf abscissa NaNs whole interpolation columns
(ops/vertical.py guard) — the OMPS reader's column-as-surface-pressure quirk
(reference reader.py:1089, pressure_mid ~1e15) is the live case.  These tests
run the production default (f16 ON) and assert finiteness + closeness to the
full-precision path for OMPS, OMI-like and TEMPO granules, with
RuntimeWarning promoted to an error so any overflow cast fails loudly.
"""

import datetime
import warnings

import numpy as np
import pytest

from oisat.datamodel import satellite_amf
from oisat.regridder import F16_SAFE_MAX, fits_f16, regrid_granule
from tests.test_pipeline import ctm_grid, synthetic_ctm


def _production_f16(monkeypatch):
    monkeypatch.setenv("OISAT_PARITY", "0")
    monkeypatch.setenv("OISAT_F16_TRANSFER", "1")


def _full_precision(monkeypatch):
    monkeypatch.setenv("OISAT_PARITY", "0")
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")


def test_fits_f16_unit():
    assert fits_f16(np.array([1.0, 6e4 - 1, np.nan], np.float32))
    assert not fits_f16(np.array([1.0, 1e15], np.float32))
    assert not fits_f16(np.array([-7e4], np.float32))
    assert fits_f16(np.array([np.nan, np.nan]))  # all-NaN fits
    assert fits_f16(np.zeros((0,)))  # empty fits
    assert not fits_f16(np.array([np.inf]))  # inf source never narrows
    assert F16_SAFE_MAX < np.finfo(np.float16).max


def _omps_like_granule(seed=0, ny=60, nx=40, nz=8):
    """An OMPS-shaped granule: pressure_mid carries the column-as-pressure
    quirk (~6e15, reference reader.py:1089), far beyond f16 range."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
    sur = np.full((ny, nx), 6.0e15)
    frac = np.linspace(1.0, 0.05, nz)[:, None, None]
    return satellite_amf(
        vcd=np.abs(rng.normal(6, 1, (ny, nx))).astype(np.float32),
        amf=np.full((ny, nx), 1.5, np.float32),
        time=datetime.datetime(2019, 7, 5, 13, 30),
        tropopause=np.empty((1,)),
        latitude_center=lat, longitude_center=lon,
        uncertainty=np.abs(rng.normal(2, 0.3, (ny, nx))).astype(np.float32),
        quality_flag=np.ones((ny, nx)),
        pressure_mid=(sur[None] * frac).astype(np.float32),
        scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))).astype(np.float32),
    )


def _regrid(monkeypatch, mode, granule):
    (_production_f16 if mode == "f16" else _full_precision)(monkeypatch)
    clon, clat = ctm_grid()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # overflow cast -> fail
        return regrid_granule(2, 0.25, granule, clon, clat, flag_thresh=0.5,
                              dtype=np.float32)


def test_omps_regrid_f16_default_no_overflow(monkeypatch):
    """The production f16 mode must keep the OMPS pressure stack finite and
    match the full-precision path (the overflow made it inf -> NaN AMFs)."""
    got16 = _regrid(monkeypatch, "f16", _omps_like_granule())
    got32 = _regrid(monkeypatch, "full", _omps_like_granule())
    m = np.isfinite(got32.pressure_mid)
    assert m.sum() > 100
    # out-of-range rows ride at full precision: identical, not just close
    np.testing.assert_allclose(got16.pressure_mid[m], got32.pressure_mid[m],
                               rtol=1e-6)
    assert np.isfinite(got16.pressure_mid).sum() == m.sum()
    # in-range rows (scattering weights) differ only by f16 quantization
    msw = np.isfinite(got32.scattering_weights)
    np.testing.assert_allclose(got16.scattering_weights[msw],
                               got32.scattering_weights[msw], rtol=2e-3, atol=1e-6)


def test_omps_amf_recal_f16_default_end_to_end(monkeypatch):
    """Full OMPS chain under production defaults: regrid -> amf_recal must
    produce a real analysis input (finite ctm_vcd / new_amf), matching the
    full-precision path (reference amf_recal.py:93-119)."""
    from oisat.obs_operators import amf_recal

    ctm = synthetic_ctm()
    outs = {}
    for mode in ("f16", "full"):
        g = _regrid(monkeypatch, mode, _omps_like_granule())
        assert g is not None
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            outs[mode] = amf_recal([ctm], [g])[0]
    m = np.isfinite(np.asarray(outs["full"].ctm_vcd))
    assert m.sum() > 100, "full-precision OMPS chain must produce data"
    got = np.asarray(outs["f16"].ctm_vcd)
    assert np.isfinite(got[m]).all(), "f16 production mode NaN'd the OMPS analysis"
    np.testing.assert_allclose(got[m], np.asarray(outs["full"].ctm_vcd)[m],
                               rtol=2e-2, atol=1e-7)
    # new_amf integrates the f16-quantized scattering weights against the
    # degenerate OMPS pseudo-pressure geometry (all-extrapolation columns),
    # amplifying the ~5e-4 quantization to a few percent; finiteness and
    # the analysis input (ctm_vcd, above) are the load-bearing checks
    mn = np.isfinite(np.asarray(outs["full"].new_amf))
    np.testing.assert_allclose(np.asarray(outs["f16"].new_amf)[mn],
                               np.asarray(outs["full"].new_amf)[mn],
                               rtol=0.1, atol=0.05)


def _amf_granule_f32(seed=1, ny=70, nx=45, nz=6, trop=True):
    """OMI/TEMPO-like granule with in-range f32 fields (narrowed in prod)."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
    return satellite_amf(
        vcd=np.abs(rng.normal(3, 1, (ny, nx))).astype(np.float32),
        amf=np.abs(rng.normal(2, 0.3, (ny, nx))).astype(np.float32),
        time=datetime.datetime(2019, 7, 5, 13, 30),
        tropopause=(rng.uniform(100, 200, (ny, nx)).astype(np.float32)
                    if trop else np.empty((1,))),
        latitude_center=lat, longitude_center=lon,
        uncertainty=np.abs(rng.normal(1, 0.2, (ny, nx))).astype(np.float32),
        quality_flag=np.ones((ny, nx)),
        pressure_mid=np.sort(rng.uniform(100, 950, (nz, ny, nx)), axis=0)[::-1]
        .copy().astype(np.float32),
        scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))).astype(np.float32),
    )


@pytest.mark.parametrize("trop", [True, False], ids=["omi_hcho", "tempo_like"])
def test_amf_sensor_f16_default_close_to_full(monkeypatch, trop):
    """OMI-HCHO-like (tropopause) and TEMPO-like (no tropopause granule
    here) chains: production f16 stays within quantization (~1e-2) of the
    full-precision path, and loses no coverage."""
    from oisat.obs_operators import amf_recal

    ctm = synthetic_ctm()
    outs = {}
    for mode in ("f16", "full"):
        g = _regrid(monkeypatch, mode, _amf_granule_f32(trop=trop))
        assert g is not None
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            outs[mode] = amf_recal([ctm], [g])[0]
    ref = np.asarray(outs["full"].ctm_vcd)
    got = np.asarray(outs["f16"].ctm_vcd)
    m = np.isfinite(ref)
    assert m.sum() > 200
    assert np.isfinite(got).sum() >= m.sum()
    np.testing.assert_allclose(got[m], ref[m], rtol=2e-2, atol=1e-6)
    np.testing.assert_allclose(np.asarray(outs["f16"].vcd)[m],
                               np.asarray(outs["full"].vcd)[m],
                               rtol=2e-2, atol=1e-6)


def test_fused_inputs_stack_lv_range_guard(monkeypatch):
    """driver._fused_inputs must keep out-of-range level stacks (the OMPS
    pressure quirk) at f32 while still narrowing in-range stacks."""
    from types import SimpleNamespace

    from oisat.driver import oisatgmi

    _production_f16(monkeypatch)
    ctm = synthetic_ctm()
    grans = []
    for s in range(2):
        g = _regrid(monkeypatch, "f16", _omps_like_granule(seed=s))
        assert g is not None
        grans.append(g)
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    inputs, _maker = obj._fused_inputs("amf", "OMPS", [ctm], grans)
    # OMPS' eta-structured pressure quirk takes the compressed Eta path:
    # the carrier level (~1e15) must keep f32, in-range stacks narrow
    assert inputs.sat_pmid_carrier.dtype == np.float32  # beyond f16 range
    assert np.isfinite(np.asarray(inputs.sat_pmid_carrier, np.float64)).any()
    assert inputs.sat_sw.dtype == np.float16  # in-range stack still narrows
    assert inputs.ctm_pmid.dtype == np.float16


def test_staged_amf_recal_eta_matches_full(monkeypatch):
    """The staged amf_recal's transfer-compressed batch (carrier + tables +
    deduplicated CTM slices) must reproduce the full-stack batch."""
    import copy

    import oisat.obs_operators as oo
    import oisat.regridder as R
    from tests.test_fused_month import _eta_granules

    _full_precision(monkeypatch)
    ctm = synthetic_ctm()
    grans = _eta_granules()
    assert all(R._affine_stack(np.asarray(g.pressure_mid)) is not None
               for g in grans)
    got = oo.amf_recal([ctm], copy.deepcopy(grans))
    monkeypatch.setattr(R, "_affine_stack", lambda *a, **k: None)
    ref = oo.amf_recal([ctm], copy.deepcopy(grans))
    for g1, g0 in zip(got, ref):
        m = np.isfinite(np.asarray(g0.ctm_vcd))
        assert m.sum() > 50
        np.testing.assert_allclose(np.asarray(g1.ctm_vcd)[m],
                                   np.asarray(g0.ctm_vcd)[m],
                                   rtol=1e-6, atol=1e-9)
        mn = np.isfinite(np.asarray(g0.new_amf))
        np.testing.assert_allclose(np.asarray(g1.new_amf)[mn],
                                   np.asarray(g0.new_amf)[mn],
                                   rtol=1e-6, atol=1e-9)


def test_device_mode_mixed_rows_match_host(monkeypatch):
    """Device-granule mode with a MIXED f16/wide level-stack batch must
    restore the caller's row order inside the jitted finisher
    (_finish_device_fields' ``inv`` gather): the device batch travels as
    [2-D fields, f16-fitting rows, wide rows], and a wrong permutation
    would silently swap whole fields/levels between e.g. scattering
    weights and pressures."""
    import jax

    _production_f16(monkeypatch)
    g = _amf_granule_f32(seed=3)
    # push ONE scattering-weight level beyond f16 range so the batch
    # splits (the random pressure stack is non-affine, so its levels all
    # travel too — fitting); everything else narrows
    g.scattering_weights[2] *= 1.0e5
    clon, clat = ctm_grid()
    host = regrid_granule(1, 0.25, g, clon, clat, flag_thresh=0.5,
                          device=False)
    dev = regrid_granule(1, 0.25, g, clon, clat, flag_thresh=0.5,
                         device=True)
    assert host is not None
    assert isinstance(dev.vcd, jax.Array)
    assert bool(np.asarray(dev._device_valid))
    for name in ("vcd", "amf", "uncertainty", "tropopause",
                 "pressure_mid", "scattering_weights"):
        h = np.asarray(getattr(host, name))
        d = np.asarray(getattr(dev, name))
        assert h.shape == d.shape, name
        np.testing.assert_allclose(d, h, rtol=1e-6, atol=0,
                                   equal_nan=True, err_msg=name)
    # the wide level really is wide on the output too (reorder proof)
    sw = np.asarray(dev.scattering_weights)
    m2 = np.isfinite(sw[2])
    assert m2.any() and np.nanmax(np.abs(sw[2][m2])) > 6.0e4
    others = np.concatenate([sw[:2], sw[3:]])
    mo = np.isfinite(others)
    assert np.nanmax(np.abs(others[mo])) < 6.0e4


def test_2d_narrowing_follows_reference_storage(monkeypatch):
    """2-D rows narrow ONLY where the reference reader itself stores f16:
    vcd/tropopause/uncertainty quantize for AMF sensors, while amf (native
    file precision in the reference, no astype) ships wide — so the f16
    and full-precision runs agree to f32 rounding on amf but only to f16
    quantization on vcd."""
    g16 = _regrid(monkeypatch, "f16", _amf_granule_f32(seed=5))
    g32 = _regrid(monkeypatch, "full", _amf_granule_f32(seed=5))
    m = np.isfinite(np.asarray(g32.vcd))
    assert m.sum() > 200
    # narrow rows: f16 quantization visible but bounded
    np.testing.assert_allclose(np.asarray(g16.vcd)[m], np.asarray(g32.vcd)[m],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g16.uncertainty)[m],
                               np.asarray(g32.uncertainty)[m],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g16.tropopause)[m],
                               np.asarray(g32.tropopause)[m],
                               rtol=2e-3, atol=1e-6)
    # wide row: no f16 step anywhere in its path
    np.testing.assert_allclose(np.asarray(g16.amf)[m], np.asarray(g32.amf)[m],
                               rtol=1e-6, atol=0)


def test_2d_narrow_range_guard(monkeypatch):
    """A vcd far beyond f16 range (unscaled columns ~1e15) must take the
    wide path automatically — identical to the full-precision run, not
    inf/NaN."""
    g = _amf_granule_f32(seed=6)
    g.vcd = (g.vcd * 1.0e15).astype(np.float32)
    g16 = _regrid(monkeypatch, "f16", g)
    g2 = _amf_granule_f32(seed=6)
    g2.vcd = (g2.vcd * 1.0e15).astype(np.float32)
    g32 = _regrid(monkeypatch, "full", g2)
    m = np.isfinite(np.asarray(g32.vcd))
    assert m.sum() > 200
    assert np.isfinite(np.asarray(g16.vcd)[m]).all()
    np.testing.assert_allclose(np.asarray(g16.vcd)[m], np.asarray(g32.vcd)[m],
                               rtol=1e-6, atol=0)


def test_opt_2d_narrowing_policy(monkeypatch):
    """MOPITT: vcd/aprior_column narrow (reference reader.py:1165, :1179)
    but x_col and uncertainty are f32 in the reference and must not
    quantize; GOSAT stores every 2-D field f32 — nothing narrows."""
    from oisat.datamodel import satellite_opt

    def mopitt_like(seed=2, ny=50, nx=40, nz=5):
        rng = np.random.default_rng(seed)
        lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
        lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
        return satellite_opt(
            vcd=np.abs(rng.normal(2000, 100, (ny, nx))).astype(np.float32),
            time=datetime.datetime(2019, 7, 5), tropopause=np.empty((1,)),
            latitude_center=lat, longitude_center=lon,
            uncertainty=np.abs(rng.normal(30, 5, (ny, nx))).astype(np.float32),
            quality_flag=np.ones((ny, nx)),
            pressure_mid=np.sort(rng.uniform(100, 950, (nz, ny, nx)),
                                 axis=0)[::-1].copy().astype(np.float32),
            averaging_kernels=rng.uniform(0, 0.5, (nz + 1, ny, nx)).astype(np.float32),
            aprior_column=np.abs(rng.normal(1800, 100, (ny, nx))).astype(np.float32),
            apriori_profile=np.abs(rng.normal(80, 15, (nz, ny, nx))).astype(np.float32),
            surface_pressure=np.full((ny, nx), 1000.0, np.float32),
            apriori_surface=np.abs(rng.normal(90, 10, (ny, nx))).astype(np.float32),
            x_col=np.abs(rng.normal(0.1, 0.02, (ny, nx))).astype(np.float32),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    g16 = _regrid(monkeypatch, "f16", mopitt_like())
    g32 = _regrid(monkeypatch, "full", mopitt_like())
    m = np.isfinite(np.asarray(g32.vcd))
    assert m.sum() > 200
    np.testing.assert_allclose(np.asarray(g16.vcd)[m], np.asarray(g32.vcd)[m],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g16.aprior_column)[m],
                               np.asarray(g32.aprior_column)[m],
                               rtol=2e-3, atol=1e-6)
    # reference-f32 rows: no quantization allowed
    np.testing.assert_allclose(np.asarray(g16.x_col)[m],
                               np.asarray(g32.x_col)[m], rtol=1e-6, atol=0)
    np.testing.assert_allclose(np.asarray(g16.uncertainty)[m],
                               np.asarray(g32.uncertainty)[m], rtol=1e-6, atol=0)
    np.testing.assert_allclose(np.asarray(g16.apriori_surface)[m],
                               np.asarray(g32.apriori_surface)[m],
                               rtol=1e-6, atol=0)


def test_pmid_tables_provenance_skips_fit(monkeypatch):
    """A granule tagged with construction tables (attach_pmid_tables) must
    regrid identically to the per-orbit affine fit it replaces — including
    the b==0 fixed-table case — and a stack edited AFTER tagging must be
    caught by the spot-check and fall back to the full fit."""
    from oisat.readers.sensors.common import attach_pmid_tables, eta_mid_tables
    from oisat import regridder

    edges_a = np.linspace(0.0, 120.0, 7)
    edges_b = np.linspace(1.0, 0.05, 7)

    def eta_granule(seed=9):
        g = _amf_granule_f32(seed=seed)
        a_mid, b_mid = eta_mid_tables(edges_a, edges_b)
        ps = 1000.0 + 30.0 * np.random.default_rng(seed).standard_normal(g.vcd.shape)
        g.pressure_mid = (a_mid[:, None, None]
                          + b_mid[:, None, None] * ps[None]).astype(np.float32)
        return g, (a_mid, b_mid)

    g_fit, tabs = eta_granule()
    g_tab, _ = eta_granule()
    attach_pmid_tables(g_tab, *tabs)

    calls = []
    orig = regridder._affine_stack
    monkeypatch.setattr(regridder, "_affine_stack",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    out_tab = _regrid(monkeypatch, "full", g_tab)
    assert not calls, "tables present: the full fit must not run"
    out_fit = _regrid(monkeypatch, "full", g_fit)
    assert calls, "no tables: the full fit runs"
    m = np.isfinite(np.asarray(out_fit.pressure_mid))
    assert m.sum() > 500
    np.testing.assert_allclose(np.asarray(out_tab.pressure_mid)[m],
                               np.asarray(out_fit.pressure_mid)[m],
                               rtol=1e-6, atol=1e-6)

    # b == 0 fixed table: masked pixels must STAY NaN (0*NaN carrier ride).
    # The mask must be spatially coherent — the boxfilter NaN-propagates
    # (reference semantics), so a random mask NaNs every window.
    g_fix, _ = eta_granule(seed=11)
    tab1d = np.linspace(900.0, 100.0, 6)
    g_fix.pressure_mid = np.broadcast_to(
        tab1d[:, None, None], g_fix.pressure_mid.shape).astype(np.float32).copy()
    qa = np.ones(g_fix.vcd.shape)
    qa[: qa.shape[0] // 2] = 0.0  # mask the southern half of the swath
    g_fix.quality_flag = qa
    attach_pmid_tables(g_fix, tab1d, np.zeros(6))
    calls.clear()
    out_fix = _regrid(monkeypatch, "full", g_fix)
    assert not calls
    pm = np.asarray(out_fix.pressure_mid)
    vc = np.asarray(out_fix.vcd)
    assert np.isnan(pm[0][np.isnan(vc)]).all(), "mask lost through b==0 tables"

    # corrupted stack after tagging -> spot-check rejects, full fit runs
    g_bad, tabs_b = eta_granule(seed=13)
    g_bad.pressure_mid = g_bad.pressure_mid + np.random.default_rng(1).normal(
        0, 5.0, g_bad.pressure_mid.shape).astype(np.float32)  # non-affine now
    attach_pmid_tables(g_bad, *tabs_b)
    calls.clear()
    _regrid(monkeypatch, "full", g_bad)
    assert calls, "edited stack must fall back to the full fit"


def test_affine_from_tables_catches_localized_edits():
    """The tables-path validation must check EVERY pixel and level: a
    localized post-construction scrub (a handful of pixels rescaled, or a
    sub-swath re-masked on one level) would slip through a strided
    spot-check and silently regrid with reconstructed pressures."""
    from oisat.regridder import _affine_from_tables

    L, H, W = 6, 30, 8
    A = np.linspace(0.0, 120.0, L)
    B = np.linspace(1.0, 0.05, L)
    rng = np.random.default_rng(3)
    ps = 1000.0 + 30.0 * rng.standard_normal((H, W))
    stack = (A[:, None, None] + B[:, None, None] * ps[None]).astype(np.float64)

    assert _affine_from_tables(stack, (A, B)) is not None

    # a 5-pixel rescale on one level (all inside one stride-97 gap)
    s_val = stack.copy()
    s_val[2].ravel()[1:6] *= 1.5
    assert _affine_from_tables(s_val, (A, B)) is None

    # a small re-masked patch on a NON-carrier level only (reconstruction
    # would un-NaN it, because every level rides the carrier's pattern)
    s_nan = stack.copy()
    s_nan[4, 3:5, 2:5] = np.nan
    assert _affine_from_tables(s_nan, (A, B)) is None


def test_opt_3d_narrowing_policy(monkeypatch):
    """Per-field 3-D narrow policy follows the reference's own storage:
    MOPITT AKs/pressures are f16 there (narrow allowed) but its apriori
    profile is full-precision; GOSAT stores AKs/pressure weights/apriori
    profiles/pressures ALL full-precision — a ~1900 ppb CH4 apriori at
    f16 (spacing 1.0) would corrupt ~10 ppb xcol-pair innovations."""
    from oisat.datamodel import satellite_opt

    def gosat_like(seed=4, ny=48, nx=36, nz=5):
        rng = np.random.default_rng(seed)
        lat = np.linspace(30.5, 45.2, ny)[:, None] * np.ones((ny, nx))
        lon = np.ones((ny, 1)) * np.linspace(-9.8, 9.9, nx)[None, :]
        return satellite_opt(
            vcd=np.abs(rng.normal(4, 0.5, (ny, nx))).astype(np.float32),
            time=datetime.datetime(2019, 7, 5), tropopause=np.empty((1,)),
            latitude_center=lat, longitude_center=lon,
            uncertainty=np.abs(rng.normal(10, 2, (ny, nx))).astype(np.float32),
            quality_flag=np.ones((ny, nx)),
            pressure_mid=np.sort(rng.uniform(100, 950, (nz, ny, nx)),
                                 axis=0)[::-1].copy().astype(np.float32),
            averaging_kernels=rng.uniform(0.2, 1.1, (nz, ny, nx)).astype(np.float32),
            aprior_column=[], apriori_profile=np.abs(
                rng.normal(1800, 60, (nz, ny, nx))).astype(np.float32),
            surface_pressure=[], apriori_surface=np.empty((1,)),
            x_col=np.abs(rng.normal(1800, 30, (ny, nx))).astype(np.float32),
            pressure_weight=np.abs(rng.normal(1.0 / nz, 0.02,
                                              (nz, ny, nx))).astype(np.float32),
            sensor="GOSAT", ctm_upscaled_needed=False)

    g16 = _regrid(monkeypatch, "f16", gosat_like())
    g32 = _regrid(monkeypatch, "full", gosat_like())
    m = np.isfinite(np.asarray(g32.x_col))
    assert m.sum() > 200
    # every GOSAT per-level stack: NO narrow-dtype quantization allowed
    for fld in ("apriori_profile", "averaging_kernels", "pressure_weight",
                "pressure_mid"):
        a = np.asarray(getattr(g16, fld))
        b = np.asarray(getattr(g32, fld))
        mm = np.isfinite(b)
        assert mm.sum() > 200, fld
        np.testing.assert_allclose(a[mm], b[mm], rtol=1e-6, atol=0,
                                   err_msg=fld)
