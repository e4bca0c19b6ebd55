"""Composed-pipeline parity: regrid_granule and amf_recal (upscale branch)
against scipy-composed float64 implementations of the reference flow."""

import numpy as np
import jax.numpy as jnp
import pytest

from oisat.obs_operators import amf_recal
from oisat.ops.vertical import partial_column
from oisat.regridder import regrid_granule
from tests.reference_impl import amf_recal_pixelwise, interpolator_amf_scipy, upscaler_scipy
from tests.test_pipeline import ctm_grid, synthetic_ctm, synthetic_granule


@pytest.mark.parametrize("method", [1, 2, 4])
def test_regrid_granule_matches_composed_reference(method):
    g = synthetic_granule(0, 4)
    clon, clat = ctm_grid()
    ref = interpolator_amf_scipy(method, 0.25, g, clon, clat, flag_thresh=0.5)
    # parity mode (fast_swath=False): bit-matching the reference's qhull
    # path; the default-on native fast path is covered by tests/test_native.py
    got = regrid_granule(method, 0.25, g, clon, clat, flag_thresh=0.5,
                         dtype=np.float64, fast_swath=False)
    assert (ref is None) == (got is None)
    for name in ("vcd", "amf", "tropopause", "uncertainty"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)), ref[name],
                                   rtol=1e-9, atol=1e-11, err_msg=name)
    np.testing.assert_allclose(got.scattering_weights, ref["scattering_weights"],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got.pressure_mid, ref["pressure_mid"], rtol=1e-9, atol=1e-9)
    assert got.ctm_upscaled_needed == ref["upneeded"] == False  # noqa: E712


def test_amf_recal_upscale_branch(monkeypatch):
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")  # parity-tight: full-precision transfer
    """CTM coarser than the granule grid -> ctm_upscaled_needed=True: the
    CTM pmids/partial columns must be box-filtered + KD-mapped onto the
    satellite grid before the vertical kernel (reference amf_recal.py:58-83)."""
    clon, clat = ctm_grid()
    ctm = synthetic_ctm(nt=8, nz=12)
    g = regrid_granule(1, 0.25, synthetic_granule(1, 5), clon, clat, flag_thresh=0.5)
    # force the upscale branch: pretend the granule grid is the fine grid
    g.ctm_upscaled_needed = True
    import dataclasses

    g2 = dataclasses.replace(g)
    g2.vcd = g.vcd.copy()
    out = amf_recal([ctm], [g2])[0]
    # golden: upscale ctm fields with the scipy upscaler, then pixelwise AMF
    hour = 4  # 13:30 -> closest 3-hourly slot (13.5/3=4.5 -> idx 4 or 5)
    import datetime

    tsat = g.time
    times = [t for t in ctm.time]
    diffs = [abs((tsat - t).total_seconds()) for t in times]
    hour = int(np.argmin(diffs))
    pmid = np.squeeze(ctm.pressure_mid[hour]).astype(np.float64)
    prof = np.squeeze(ctm.gas_profile[hour]).astype(np.float64)
    dp = np.squeeze(ctm.delta_p[hour]).astype(np.float64)
    pc = np.asarray(partial_column(jnp.asarray(dp), jnp.asarray(prof)))
    gridsize_ctm = np.hypot(1.25, 1.0)
    thr_sat = np.hypot(abs(g.longitude_center[0, 0] - g.longitude_center[0, 1]),
                       abs(g.latitude_center[0, 0] - g.latitude_center[1, 0]))
    pmid_u = np.stack([upscaler_scipy(clon, clat, pmid[z], g.longitude_center,
                                      g.latitude_center, gridsize_ctm, thr_sat)[2]
                       for z in range(pmid.shape[0])])
    pc_u = np.stack([upscaler_scipy(clon, clat, pc[z], g.longitude_center,
                                    g.latitude_center, gridsize_ctm, thr_sat)[2]
                     for z in range(pc.shape[0])])
    ref = amf_recal_pixelwise(np.asarray(g.pressure_mid, np.float64),
                              np.asarray(g.scattering_weights, np.float64),
                              pmid_u, pc_u,
                              np.asarray(g.tropopause, np.float64),
                              np.asarray(g.vcd, np.float64),
                              np.asarray(g.amf, np.float64))
    np.testing.assert_allclose(np.asarray(out.new_amf), ref[0], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.ctm_vcd), ref[2], rtol=2e-5, atol=1e-7)


def _eccoh_like_ctm(H, W, nz=20, seed=8):
    import datetime

    from oisat.datamodel import ctm_model

    rng = np.random.default_rng(seed)
    pmid = np.sort(rng.uniform(60, 1000, (nz, H, W)), axis=0)[::-1].copy().astype("float32")
    return ctm_model(np.zeros((H, W)), np.zeros((H, W)),
                     [datetime.datetime(2019, 7, 1)],
                     np.abs(rng.normal(80, 20, (nz, H, W))).astype("float32"),
                     pmid, [], rng.uniform(10, 40, (nz, H, W)).astype("float32"),
                     "ECCOH", False)


def test_ak_conv_mopitt_batched_orchestration(monkeypatch):
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")  # parity-tight vs f64 golden
    import datetime

    from oisat.datamodel import satellite_opt
    from oisat.obs_operators import ak_conv_mopitt
    from oisat.ops.vertical import air_partial_column, partial_column
    from tests.reference_impl import ak_conv_mopitt_pixelwise
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    H, W, Ls = 12, 14, 9
    ctm = _eccoh_like_ctm(H, W)

    def gran(seed, day):
        r = np.random.default_rng(seed)
        vcd = np.abs(r.normal(2, 0.5, (H, W)))
        vcd[r.random((H, W)) < 0.2] = np.nan
        return satellite_opt(
            vcd=vcd, time=datetime.datetime(2019, 7, day), tropopause=np.empty((1,)),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            uncertainty=np.ones((H, W)), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy(),
            averaging_kernels=r.uniform(0, 0.5, (Ls + 1, H, W)),
            aprior_column=np.abs(r.normal(2, 0.3, (H, W))),
            apriori_profile=np.abs(r.normal(80, 15, (Ls, H, W))),
            surface_pressure=np.full((H, W), 1000.0),
            apriori_surface=np.abs(r.normal(90, 10, (H, W))),
            x_col=np.abs(r.normal(0.1, 0.02, (H, W))),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    granules = [gran(s, 2 + s) for s in range(3)] + [None]
    out = ak_conv_mopitt([ctm], [g for g in granules])
    pc = np.asarray(partial_column(jnp.asarray(ctm.delta_p), jnp.asarray(ctm.gas_profile)))
    airpc = np.asarray(air_partial_column(jnp.asarray(ctm.delta_p)))
    for g in out[:3]:
        ref_vcd, ref_xcol = ak_conv_mopitt_pixelwise(
            np.asarray(ctm.pressure_mid, np.float64), np.asarray(ctm.gas_profile, np.float64),
            airpc, np.asarray(g.pressure_mid, np.float64),
            np.asarray(g.averaging_kernels, np.float64),
            np.asarray(g.aprior_column, np.float64), np.asarray(g.apriori_profile, np.float64),
            np.asarray(g.apriori_surface, np.float64), np.asarray(g.vcd, np.float64))
        np.testing.assert_allclose(g.ctm_vcd, ref_vcd, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g.ctm_xcol, ref_xcol, rtol=1e-5, atol=1e-7)
    assert out[3] is None


def test_ak_conv_gosat_batched_orchestration(monkeypatch):
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")  # parity-tight vs f64 golden
    import datetime

    from oisat.datamodel import satellite_opt
    from oisat.obs_operators import ak_conv_gosat
    from tests.reference_impl import ak_conv_gosat_pixelwise

    H, W, Ls = 10, 11, 20
    ctm = _eccoh_like_ctm(H, W, nz=30, seed=9)

    def gran(seed, day):
        r = np.random.default_rng(seed)
        x_col = np.abs(r.normal(1.8, 0.1, (H, W)))
        x_col[r.random((H, W)) < 0.2] = np.nan
        return satellite_opt(
            vcd=x_col.copy(), time=datetime.datetime(2019, 7, day), tropopause=np.empty((1,)),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            uncertainty=np.ones((H, W)), quality_flag=[],
            pressure_mid=np.sort(r.uniform(50, 990, (Ls, H, W)), axis=0)[::-1].copy(),
            averaging_kernels=r.uniform(0, 1.2, (Ls, H, W)),
            aprior_column=np.zeros((1,)),
            apriori_profile=np.abs(r.normal(1800, 80, (Ls, H, W))),
            surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)),
            x_col=x_col, pressure_weight=r.uniform(0, 0.1, (Ls, H, W)),
            sensor="GOSAT", ctm_upscaled_needed=False)

    granules = [gran(s, 3 + s) for s in range(2)]
    out = ak_conv_gosat([ctm], granules)
    for g in out:
        ref = ak_conv_gosat_pixelwise(
            np.asarray(ctm.pressure_mid, np.float64), np.asarray(ctm.gas_profile, np.float64),
            np.asarray(g.pressure_mid, np.float64), np.asarray(g.averaging_kernels, np.float64),
            np.asarray(g.apriori_profile, np.float64), np.asarray(g.pressure_weight, np.float64),
            np.asarray(g.x_col, np.float64))
        np.testing.assert_allclose(g.ctm_xcol, ref, rtol=5e-5, atol=1e-7)
        assert np.isnan(g.ctm_vcd).all()


def test_amf_recal_compressed_ctm_matches_pixelwise_golden(monkeypatch):
    """With hybrid-eta CTM pressure stacks the staged batch ships the CTM
    slices as carrier + tables; the decompressed result must still match
    the f64 pixelwise reference."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import datetime

    from oisat.datamodel import ctm_model

    clon, clat = ctm_grid()
    H, W = clat.shape
    nt, nz = 8, 12
    rng = np.random.default_rng(12)
    eta_a = np.concatenate([[0.0], np.linspace(40.0, 600.0, nz - 1)])
    eta_b = np.concatenate([[1.0], np.linspace(0.9, 0.01, nz - 1)])
    ps = 1000.0 + 30.0 * rng.standard_normal((nt, H, W))
    pmid4 = (eta_a[None, :, None, None]
             + eta_b[None, :, None, None] * ps[:, None]).astype("float32")
    ctm = ctm_model(clat, clon,
                    [datetime.datetime(2019, 7, 5, 3 * h) for h in range(nt)],
                    np.abs(rng.normal(15, 4, (nt, nz, H, W))).astype("float32"),
                    pmid4, [],
                    rng.uniform(10, 40, (nt, nz, H, W)).astype("float32"),
                    "GMI", False)
    # eta-shaped granule so the sat side compresses too
    nzs = 6
    g0 = synthetic_granule(1, 5, nz=nzs)
    sa = np.linspace(5.0, 900.0, nzs)[::-1].copy()
    sb = np.linspace(1.0, 0.01, nzs)
    pss = np.abs(np.random.default_rng(7).normal(1000, 30, g0.vcd.shape))
    g0.pressure_mid = sa[:, None, None] + sb[:, None, None] * pss[None]
    g = regrid_granule(1, 0.25, g0, clon, clat, flag_thresh=0.5)

    out = amf_recal([ctm], [g])[0]

    hour = int(np.argmin([abs((g.time - t).total_seconds()) for t in ctm.time]))
    pmid = np.squeeze(ctm.pressure_mid[hour]).astype(np.float64)
    prof = np.squeeze(ctm.gas_profile[hour]).astype(np.float64)
    dp = np.squeeze(ctm.delta_p[hour]).astype(np.float64)
    pc = np.asarray(partial_column(jnp.asarray(dp), jnp.asarray(prof)))
    ref = amf_recal_pixelwise(np.asarray(g.pressure_mid, np.float64),
                              np.asarray(g.scattering_weights, np.float64),
                              pmid, pc,
                              np.asarray(g.tropopause, np.float64),
                              np.asarray(g.vcd, np.float64),
                              np.asarray(g.amf, np.float64))
    np.testing.assert_allclose(np.asarray(out.new_amf), ref[0],
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.ctm_vcd), ref[2],
                               rtol=2e-5, atol=1e-7)


def test_amf_recal_upscale_affine_carrier_matches_per_level(monkeypatch):
    """With an eta-structured CTM the upscale branch ships only the
    carrier level; the reconstructed stack must match the scipy per-level
    upscale golden (partition-of-unity weights commute with the affine)."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import dataclasses
    import datetime

    from oisat.datamodel import ctm_model

    clon, clat = ctm_grid()
    H, W = clat.shape
    nt, nz = 8, 12
    rng = np.random.default_rng(4)
    a = np.concatenate([[0.0], np.linspace(40.0, 600.0, nz - 1)])
    b = np.concatenate([[1.0], np.linspace(0.9, 0.01, nz - 1)])
    ps = 1000.0 + 30.0 * rng.standard_normal((nt, H, W))
    pmid4 = (a[None, :, None, None]
             + b[None, :, None, None] * ps[:, None]).astype("float32")
    ctm = ctm_model(clat, clon,
                    [datetime.datetime(2019, 7, 5, 3 * h) for h in range(nt)],
                    np.abs(rng.normal(15, 4, (nt, nz, H, W))).astype("float32"),
                    pmid4, [],
                    rng.uniform(10, 40, (nt, nz, H, W)).astype("float32"),
                    "GMI", False)
    g = regrid_granule(1, 0.25, synthetic_granule(1, 5), clon, clat,
                       flag_thresh=0.5)
    g.ctm_upscaled_needed = True
    g2 = dataclasses.replace(g)
    g2.vcd = g.vcd.copy()
    out = amf_recal([ctm], [g2])[0]

    hour = int(np.argmin([abs((g.time - t).total_seconds()) for t in ctm.time]))
    pmid = np.squeeze(ctm.pressure_mid[hour]).astype(np.float64)
    prof = np.squeeze(ctm.gas_profile[hour]).astype(np.float64)
    dp = np.squeeze(ctm.delta_p[hour]).astype(np.float64)
    pc = np.asarray(partial_column(jnp.asarray(dp), jnp.asarray(prof)))
    gridsize_ctm = np.hypot(1.25, 1.0)
    thr_sat = np.hypot(abs(g.longitude_center[0, 0] - g.longitude_center[0, 1]),
                       abs(g.latitude_center[0, 0] - g.latitude_center[1, 0]))
    pmid_u = np.stack([upscaler_scipy(clon, clat, pmid[z], g.longitude_center,
                                      g.latitude_center, gridsize_ctm, thr_sat)[2]
                       for z in range(pmid.shape[0])])
    pc_u = np.stack([upscaler_scipy(clon, clat, pc[z], g.longitude_center,
                                    g.latitude_center, gridsize_ctm, thr_sat)[2]
                     for z in range(pc.shape[0])])
    ref = amf_recal_pixelwise(np.asarray(g.pressure_mid, np.float64),
                              np.asarray(g.scattering_weights, np.float64),
                              pmid_u, pc_u,
                              np.asarray(g.tropopause, np.float64),
                              np.asarray(g.vcd, np.float64),
                              np.asarray(g.amf, np.float64))
    np.testing.assert_allclose(np.asarray(out.new_amf), ref[0],
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.ctm_vcd), ref[2],
                               rtol=2e-4, atol=1e-6)


def _eta_ecoh_ctm(H, W, Lc=12, seed=6):
    """ECCOH-like CTM whose pressure AND delta-p stacks are hybrid-eta
    (affine in one surface-pressure field) — the compressed staged/fused
    layouts engage on it."""
    import datetime

    from oisat.datamodel import ctm_model

    rng = np.random.default_rng(seed)
    a = np.concatenate([[0.0], np.linspace(40.0, 600.0, Lc - 1)])
    b = np.concatenate([[1.0], np.linspace(0.9, 0.01, Lc - 1)])
    ps = 1000.0 + 30.0 * rng.standard_normal((H, W))
    pmid = (a[:, None, None] + b[:, None, None] * ps[None]).astype("float32")
    da = np.linspace(5.0, 40.0, Lc)
    db = np.linspace(0.02, 0.001, Lc)
    dp = (da[:, None, None] + db[:, None, None] * ps[None]).astype("float32")
    return ctm_model(np.zeros((H, W)), np.zeros((H, W)),
                     [datetime.datetime(2019, 7, 1)],
                     np.abs(rng.normal(80, 20, (Lc, H, W))).astype("float32"),
                     pmid, [], dp, "ECCOH", False)


def test_ak_conv_mopitt_compressed_matches_pixelwise_golden(monkeypatch):
    """With an eta CTM the staged MOPITT batch ships carrier + tables for
    both the pressure and air-column stacks; the decompressed result must
    match the f64 pixelwise reference."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import datetime

    from oisat.datamodel import satellite_opt
    from oisat.obs_operators import ak_conv_mopitt
    from oisat.ops.vertical import air_partial_column
    from tests.reference_impl import ak_conv_mopitt_pixelwise

    H, W, Ls = 12, 14, 9
    ctm = _eta_ecoh_ctm(H, W)

    def gran(seed, day):
        r = np.random.default_rng(seed)
        vcd = np.abs(r.normal(2, 0.5, (H, W)))
        vcd[r.random((H, W)) < 0.2] = np.nan
        return satellite_opt(
            vcd=vcd, time=datetime.datetime(2019, 7, day), tropopause=np.empty((1,)),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            uncertainty=np.ones((H, W)), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy(),
            averaging_kernels=r.uniform(0, 0.5, (Ls + 1, H, W)),
            aprior_column=np.abs(r.normal(2, 0.3, (H, W))),
            apriori_profile=np.abs(r.normal(80, 15, (Ls, H, W))),
            surface_pressure=np.full((H, W), 1000.0),
            apriori_surface=np.abs(r.normal(90, 10, (H, W))),
            x_col=np.abs(r.normal(0.1, 0.02, (H, W))),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    out = ak_conv_mopitt([ctm], [gran(s, 2 + s) for s in range(2)])
    airpc = np.asarray(air_partial_column(jnp.asarray(ctm.delta_p)))
    for g in out:
        ref_vcd, ref_xcol = ak_conv_mopitt_pixelwise(
            np.asarray(ctm.pressure_mid, np.float64),
            np.asarray(ctm.gas_profile, np.float64),
            airpc, np.asarray(g.pressure_mid, np.float64),
            np.asarray(g.averaging_kernels, np.float64),
            np.asarray(g.aprior_column, np.float64),
            np.asarray(g.apriori_profile, np.float64),
            np.asarray(g.apriori_surface, np.float64),
            np.asarray(g.vcd, np.float64))
        np.testing.assert_allclose(g.ctm_vcd, ref_vcd, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(g.ctm_xcol, ref_xcol, rtol=2e-5, atol=1e-7)


def test_ak_conv_gosat_compressed_matches_pixelwise_golden(monkeypatch):
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import datetime

    from oisat.datamodel import satellite_opt
    from oisat.obs_operators import ak_conv_gosat
    from tests.reference_impl import ak_conv_gosat_pixelwise

    H, W, Ls = 12, 14, 6
    ctm = _eta_ecoh_ctm(H, W, seed=7)
    r = np.random.default_rng(2)
    g = satellite_opt(
        vcd=np.abs(r.normal(1800, 30, (H, W))),
        time=datetime.datetime(2019, 7, 4), tropopause=np.empty((1,)),
        latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
        uncertainty=np.ones((H, W)), quality_flag=[],
        pressure_mid=np.sort(r.uniform(100, 950, (Ls, H, W)), axis=0)[::-1].copy(),
        averaging_kernels=r.uniform(0.2, 1.0, (Ls, H, W)),
        aprior_column=np.empty((1,)),
        apriori_profile=np.abs(r.normal(1750, 50, (Ls, H, W))),
        surface_pressure=np.full((H, W), 1000.0),
        apriori_surface=np.empty((1,)),
        x_col=np.abs(r.normal(1800, 30, (H, W))),
        pressure_weight=np.full((Ls, H, W), 1.0 / Ls),
        sensor="GOSAT", ctm_upscaled_needed=False)
    out = ak_conv_gosat([ctm], [g])[0]
    ref_xcol = ak_conv_gosat_pixelwise(
        np.asarray(ctm.pressure_mid, np.float64),
        np.asarray(ctm.gas_profile, np.float64),
        np.asarray(out.pressure_mid, np.float64),
        np.asarray(out.averaging_kernels, np.float64),
        np.asarray(out.apriori_profile, np.float64),
        np.asarray(out.pressure_weight, np.float64),
        np.asarray(out.x_col, np.float64))
    np.testing.assert_allclose(out.ctm_xcol, ref_xcol, rtol=2e-5, atol=1e-7)
    assert np.isnan(np.asarray(out.ctm_vcd)).all()
