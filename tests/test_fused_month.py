"""The fused on-device month analysis (driver.analyze_month_fused — the
parallel/ full-month step wired into the production driver) must reproduce
the staged recal_amf -> average -> bias_correct -> oi pipeline."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest

from oisat.driver import oisatgmi
from oisat.regridder import regrid_granule
from tests.test_pipeline import ctm_grid, synthetic_ctm, synthetic_granule


def _month_state(nmonths_granules=4):
    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    granules = [regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5) for s in range(nmonths_granules)]
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    return obj


def test_fused_matches_staged(monkeypatch):
    # full-precision transfers on both paths so the only differences are
    # reduction orders (f32-level)
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    staged = _month_state()
    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(
        ctm_data=staged.reader_obj.ctm_data,
        sat_data=copy.deepcopy(staged.reader_obj.sat_data))

    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0)

    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)

    for name in ("sat_averaged_vcd", "ctm_averaged_vcd", "aux1", "aux2",
                 "sat_averaged_error", "ctm_averaged_vcd_corrected",
                 "ak_OI", "error_OI"):
        a = getattr(fused, name)
        b = getattr(staged, name)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5,
                                   equal_nan=True, err_msg=name)
    assert abs(fused.avg_time.timestamp() - staged.avg_time.timestamp()) < 1.0


def test_fused_rejects_unfusable_months():
    obj = _month_state(2)
    # granule without scattering weights
    obj.reader_obj.sat_data[0].scattering_weights = np.empty(1)
    with pytest.raises(ValueError, match="scattering weights"):
        obj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01")

    obj3 = _month_state(2)
    obj3.reader_obj.sat_data = [None, None]
    with pytest.raises(ValueError, match="no valid"):
        obj3.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01")


def test_job_runner_fused_month(tmp_path, monkeypatch):
    """control.yml `fused_month: true` runs the one-program path end to end
    and produces the standard diag; an unfusable month (FREE CTM -> no
    scattering weights in this recipe) falls back to the staged pipeline."""
    import importlib.util
    import os

    import yaml

    from tests.test_ctm_readers import write_gmi_pair
    from tests.test_sensors import write_omi_no2

    (tmp_path / "ctm").mkdir()
    (tmp_path / "sat").mkdir()
    write_gmi_pair(tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20190710.nc4",
                   tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_tac_Nv.20190710.nc4", 10,
                   nlat=16, nlon=17)
    write_omi_no2(tmp_path / "sat" / "OMI-Aura_L2-OMNO2_2019m0710.nc")
    ctrl = {
        "python_bin": "python3", "debug": False, "save_daily": False, "num_job": 1,
        "ctm_name": "GMI", "ctm_dir": str(tmp_path / "ctm"), "mcip_dir": str(tmp_path),
        "ctm_freq": "3-hourly", "ctm_avg": True, "ctm_error": 50.0,
        "gas": "NO2", "sensor": "OMI", "read_AK": True, "troposphere_only": True,
        "sat_dir": str(tmp_path / "sat"),
        "start_date": "2019-07", "end_date": "2019-07",
        "output_pdf_dir": str(tmp_path / "report"),
        "output_nc_dir": str(tmp_path / "diag"),
        "fused_month": True,
    }
    with open(tmp_path / "control.yml", "w") as f:
        yaml.safe_dump(ctrl, f)
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "run_job", os.path.join(os.path.dirname(__file__), "..", "run", "job.py"))
    run_job = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_job)
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        run_job.run_month(ctrl, 2019, 7)
    # the fused path must actually have run, not silently fallen back
    assert "fused month not applicable" not in buf.getvalue()
    from oisat.ncwriter import read_diag_nc

    fields, tstr = read_diag_nc(tmp_path / "diag" / "NO2_201907.nc")
    assert tstr.startswith("2019-07")
    assert np.isfinite(fields["sat_averaged_vcd"]).sum() > 10
    assert np.isfinite(fields["scaling_factor"]).all()
    assert np.isfinite(fields["aux1"]).sum() > 10  # new AMF computed on device


def _compare(fused, staged, names, rtol=2e-4, atol=2e-5):
    for name in names:
        np.testing.assert_allclose(getattr(fused, name), getattr(staged, name),
                                   rtol=rtol, atol=atol, equal_nan=True,
                                   err_msg=name)


def test_fused_mopitt_matches_staged(monkeypatch):
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import datetime

    from tests.test_parity_composed import _eccoh_like_ctm

    from oisat.datamodel import satellite_opt

    H, W, Ls = 12, 14, 9
    ctm = _eccoh_like_ctm(H, W)

    def gran(seed, day):
        r = np.random.default_rng(seed)
        vcd = np.abs(r.normal(2, 0.5, (H, W)))
        vcd[r.random((H, W)) < 0.2] = np.nan
        return satellite_opt(
            vcd=vcd, time=datetime.datetime(2019, 7, day, 12), tropopause=np.empty((1,)),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            uncertainty=np.abs(r.normal(0.3, 0.05, (H, W))), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy().astype("float32"),
            averaging_kernels=r.uniform(0, 0.5, (Ls + 1, H, W)).astype("float32"),
            aprior_column=np.abs(r.normal(2, 0.3, (H, W))).astype("float32"),
            apriori_profile=np.abs(r.normal(80, 15, (Ls, H, W))).astype("float32"),
            surface_pressure=np.full((H, W), 1000.0, "float32"),
            apriori_surface=np.abs(r.normal(90, 10, (H, W))).astype("float32"),
            x_col=np.abs(r.normal(0.1, 0.02, (H, W))).astype("float32"),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    grans = [gran(s, 2 + s) for s in range(3)]
    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=copy.deepcopy(grans))
    staged.conv_ak("MOPITT")
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("MOPITT", "CO")
    staged.oi("MOPITT", error_ctm=50.0)

    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    fused.analyze_month_fused("MOPITT", "CO", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    _compare(fused, staged, ("sat_averaged_vcd", "ctm_averaged_vcd", "aux1",
                             "aux2", "ctm_averaged_vcd_corrected", "error_OI"))

    # AK information-content weighting composes in-program for the opt
    # kinds: the full |AK| stack (surface row included) vertical-nanmean
    # must match the staged _granule_weights formula
    staged_ak = oisatgmi()
    staged_ak.reader_obj = SimpleNamespace(ctm_data=[ctm],
                                           sat_data=copy.deepcopy(grans))
    staged_ak.conv_ak("MOPITT")
    staged_ak.average("2019-07-01", "2019-08-01", weighting="ak")
    staged_ak.bias_correct("MOPITT", "CO")
    staged_ak.oi("MOPITT", error_ctm=50.0)
    fused_ak = oisatgmi()
    fused_ak.reader_obj = SimpleNamespace(ctm_data=[ctm],
                                          sat_data=copy.deepcopy(grans))
    fused_ak.analyze_month_fused("MOPITT", "CO", "2019-07-01", "2019-08-01",
                                 error_ctm=50.0, weighting="ak")
    _compare(fused_ak, staged_ak,
             ("sat_averaged_vcd", "sat_averaged_error", "ctm_averaged_vcd",
              "ctm_averaged_vcd_corrected", "error_OI"))
    # the weighting changed the month (vs the unweighted fused run)
    assert np.nansum(np.abs(np.nan_to_num(fused_ak.sat_averaged_error)
                            - np.nan_to_num(fused.sat_averaged_error))) > 0


def test_fused_gosat_matches_staged(monkeypatch):
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import datetime

    from oisat.datamodel import satellite_opt
    from tests.test_parity_composed import _eccoh_like_ctm

    H, W, Ls = 10, 11, 6
    ctm = _eccoh_like_ctm(H, W, nz=20, seed=9)

    def gran(seed, day):
        r = np.random.default_rng(seed)
        x_col = np.abs(r.normal(1.8, 0.1, (H, W))).astype("float32")
        x_col[r.random((H, W)) < 0.2] = np.nan
        return satellite_opt(
            vcd=x_col.copy(), time=datetime.datetime(2019, 7, day, 12),
            tropopause=np.empty((1,)),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            uncertainty=np.abs(r.normal(0.05, 0.01, (H, W))).astype("float32"),
            quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy().astype("float32"),
            averaging_kernels=r.uniform(0.2, 1.0, (Ls, H, W)).astype("float32"),
            aprior_column=np.zeros((H, W), "float32"),
            apriori_profile=np.abs(r.normal(1750, 40, (Ls, H, W))).astype("float32"),
            surface_pressure=np.zeros((H, W), "float32"),
            apriori_surface=np.zeros((H, W), "float32"),
            x_col=x_col,
            pressure_weight=np.full((Ls, H, W), 1.0 / Ls, "float32"),
            sensor="GOSAT", ctm_upscaled_needed=False)

    grans = [gran(s, 3 + s) for s in range(3)]
    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=copy.deepcopy(grans))
    staged.conv_ak("GOSAT")
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("GOSAT", "CH4")
    staged.oi("GOSAT", error_ctm=50.0)

    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    fused.analyze_month_fused("GOSAT", "CH4", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    # GOSAT assimilates the xcol pair; model VCD is intentionally NaN
    assert np.isnan(fused.ctm_averaged_vcd).all()
    # ... and the diagnostics must therefore use the xcol pair, not the
    # NaN model VCD (review finding: all-NaN chi2 in the diag attributes)
    assert np.isfinite(fused.oi_diagnostics["chi2"])
    assert fused.oi_diagnostics["n"] > 0
    _compare(fused, staged, ("sat_averaged_vcd", "aux1", "aux2",
                             "ctm_averaged_vcd_corrected", "error_OI"),
             rtol=1e-3, atol=1e-3)


def test_fused_ssmis_matches_staged(monkeypatch):
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import datetime

    from oisat.datamodel import satellite_ssmis
    from tests.test_parity_composed import _eccoh_like_ctm

    H, W = 10, 12
    ctm = _eccoh_like_ctm(H, W, nz=15, seed=4)

    def gran(seed, day):
        r = np.random.default_rng(seed)
        vcd = np.abs(r.normal(20, 5, (H, W))).astype("float32")
        vcd[r.random((H, W)) < 0.2] = np.nan
        return satellite_ssmis(
            vcd=vcd, uncertainty=np.abs(r.normal(1, 0.2, (H, W))).astype("float32"),
            time=datetime.datetime(2019, 7, day, 12),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            ctm_upscaled_needed=False, ctm_vcd=[], sensor="SSMIS")

    grans = [gran(s, 5 + s) for s in range(3)]
    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=copy.deepcopy(grans))
    staged.cal_pwv()
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("SSMIS", "H2O")
    staged.oi("SSMIS", error_ctm=50.0)

    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    fused.analyze_month_fused("SSMIS", "H2O", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    _compare(fused, staged, ("sat_averaged_vcd", "ctm_averaged_vcd",
                             "ctm_averaged_vcd_corrected", "error_OI"))


def test_mopitt_xcol_survives_default_f16_transfers():
    """Regression: air partial columns (~1e9 per layer) must NEVER take the
    f16 transfer path — with the production default transfers ON, the
    MOPITT model xcol must stay finite and match the full-precision result
    to f16 profile-quantization tolerance (an f16 airpc would turn inf and
    zero every xcol)."""
    import datetime

    from oisat.datamodel import satellite_opt
    from oisat.obs_operators import ak_conv_mopitt
    from tests.test_parity_composed import _eccoh_like_ctm

    H, W, Ls = 8, 9, 5
    ctm = _eccoh_like_ctm(H, W, nz=12, seed=6)
    r = np.random.default_rng(0)
    g = satellite_opt(
        vcd=np.abs(r.normal(2, 0.5, (H, W))).astype("float32"),
        time=datetime.datetime(2019, 7, 3, 12), tropopause=np.empty((1,)),
        latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
        uncertainty=np.full((H, W), 0.3, "float32"), quality_flag=[],
        pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy().astype("float32"),
        averaging_kernels=r.uniform(0, 0.5, (Ls + 1, H, W)).astype("float32"),
        aprior_column=np.abs(r.normal(2, 0.3, (H, W))).astype("float32"),
        apriori_profile=np.abs(r.normal(80, 15, (Ls, H, W))).astype("float32"),
        surface_pressure=np.full((H, W), 1000.0, "float32"),
        apriori_surface=np.abs(r.normal(90, 10, (H, W))).astype("float32"),
        x_col=np.abs(r.normal(0.1, 0.02, (H, W))).astype("float32"),
        pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    import os

    assert os.environ.get("OISAT_F16_TRANSFER") != "0"
    out = ak_conv_mopitt([ctm], [copy.deepcopy(g)])[0]
    assert np.isfinite(out.ctm_xcol).any()
    assert np.nanmax(np.abs(out.ctm_xcol)) > 0  # not zeroed by an inf airpc

    # fused path, same default transfers
    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=[copy.deepcopy(g)])
    fused.analyze_month_fused("MOPITT", "CO", "2019-07-01", "2019-08-01")
    assert np.isfinite(fused.aux2).any()
    np.testing.assert_allclose(fused.aux2[np.isfinite(fused.aux2)],
                               out.ctm_xcol[np.isfinite(out.ctm_xcol)],
                               rtol=5e-3)


def test_fused_o3_matches_staged(monkeypatch):
    """O3 months convert the CTM column to DU between averaging and OI
    (reference driver.py:62-63); the fused program applies the same scale
    through analysis_step's ctm_scale hook."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    staged = _month_state()
    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(
        ctm_data=staged.reader_obj.ctm_data,
        sat_data=copy.deepcopy(staged.reader_obj.sat_data))

    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01", gasname="O3")
    staged.bias_correct("OMI", "O3")
    staged.oi("OMI", error_ctm=50.0)

    fused.analyze_month_fused("OMI", "O3", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    for name in ("sat_averaged_vcd", "ctm_averaged_vcd",
                 "ctm_averaged_vcd_corrected", "ak_OI", "error_OI"):
        np.testing.assert_allclose(getattr(fused, name), getattr(staged, name),
                                   rtol=2e-4, atol=2e-5, equal_nan=True,
                                   err_msg=name)
    # the DU scale really was applied: the fused prior equals the raw
    # granule-mean CTM column divided by 2.69e16*1e-15
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN columns
        raw = np.nanmean(np.stack([np.asarray(g.ctm_vcd, np.float64)
                                   for g in staged.reader_obj.sat_data]), axis=0)
    np.testing.assert_allclose(fused.ctm_averaged_vcd, raw / (2.69e16 * 1e-15),
                               rtol=2e-4, atol=2e-5, equal_nan=True)


def test_fused_upscaled_ctm_matches_staged(monkeypatch):
    """Months whose granules stayed on a grid finer than the CTM
    (ctm_upscaled_needed) now fuse: the matched CTM slices are upscaled
    onto the granule grid through the cached upscaler plans, matching the
    staged operators (reference amf_recal.py:58-83)."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    # grid_size 2.0 deg > CTM pitch (1.25 x 1.0): the upscaler decision
    # flips to pass-through and the CTM must be upscaled instead
    granules = [regrid_granule(1, 2.0, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5) for s in range(3)]
    assert all(g is not None and g.ctm_upscaled_needed for g in granules)
    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm],
                                       sat_data=copy.deepcopy(granules))

    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0)

    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    for name in ("sat_averaged_vcd", "ctm_averaged_vcd", "aux1", "aux2",
                 "ctm_averaged_vcd_corrected", "ak_OI", "error_OI"):
        np.testing.assert_allclose(getattr(fused, name), getattr(staged, name),
                                   rtol=2e-4, atol=2e-5, equal_nan=True,
                                   err_msg=name)


def test_job_runner_tempo_hours_fused(tmp_path, monkeypatch):
    """TEMPO per-hour pipelines route through the fused path too — each UTC
    hour is just another fusable batch of granules (reference
    run/job.py:36-59 loops hours; VERDICT r2 item 6)."""
    import importlib.util
    import io
    import os
    from contextlib import redirect_stdout

    import yaml

    from tests.test_ctm_readers import write_gmi_pair
    from tests.test_sensors import write_tempo_no2

    (tmp_path / "ctm").mkdir()
    (tmp_path / "sat").mkdir()
    write_gmi_pair(tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20230905.nc4",
                   tmp_path / "ctm" / "MERRA2_GMI.tavg3_3d_tac_Nv.20230905.nc4", 5,
                   nlat=16, nlon=17)
    write_tempo_no2(tmp_path / "sat" / "TEMPO_NO2_L2_20230905T180000.nc")
    ctrl = {
        "python_bin": "python3", "debug": False, "save_daily": False, "num_job": 1,
        "ctm_name": "GMI", "ctm_dir": str(tmp_path / "ctm"), "mcip_dir": str(tmp_path),
        "ctm_freq": "3-hourly", "ctm_avg": True, "ctm_error": 50.0,
        "gas": "NO2", "sensor": "TEMPO", "read_AK": True, "troposphere_only": True,
        "sat_dir": str(tmp_path / "sat"),
        "start_date": "2023-09", "end_date": "2023-09",
        "output_pdf_dir": str(tmp_path / "report"),
        "output_nc_dir": str(tmp_path / "diag"),
        "fused_month": True,
    }
    with open(tmp_path / "control.yml", "w") as f:
        yaml.safe_dump(ctrl, f)
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "run_job", os.path.join(os.path.dirname(__file__), "..", "run", "job.py"))
    run_job = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_job)
    buf = io.StringIO()
    with redirect_stdout(buf):
        run_job.run_month(ctrl, 2023, 9)
    # the 23 empty hours fall back (no granules) and fail per-hour as
    # always; the ONE hour with data must have fused, not fallen back
    assert buf.getvalue().count("fused month not applicable") == 23
    assert (tmp_path / "diag" / "NO2_202309_18UTC.nc").exists()
    assert not (tmp_path / "diag" / "NO2_202309_17UTC.nc").exists()


def _eta_granules(n=3):
    """Granules with hybrid-eta pressure stacks (like every real product),
    regridded — the affine structure survives the regrid, so the fused
    month takes the transfer-compressed Eta path."""
    clon, clat = ctm_grid()
    nz = 6
    eta_a = np.linspace(5.0, 900.0, nz)[::-1].copy()
    eta_b = np.linspace(1.0, 0.01, nz)
    grans = []
    for s in range(n):
        g = synthetic_granule(s, 4 + s, nz=nz)
        ps = np.abs(np.random.default_rng(50 + s).normal(1000, 30, g.vcd.shape))
        g.pressure_mid = (eta_a[:, None, None] + eta_b[:, None, None] * ps[None])
        grans.append(regrid_granule(1, 0.25, g, clon, clat, flag_thresh=0.5))
    return grans


def test_fused_eta_compressed_matches_staged(monkeypatch):
    """The Eta-compressed fused month (carrier pmid + deduplicated CTM
    slices, decompressed on device) must reproduce the staged pipeline."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    from oisat.parallel.analysis import FullMonthEtaInputs

    ctm = synthetic_ctm()
    grans = _eta_granules()
    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm],
                                        sat_data=copy.deepcopy(grans))
    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)

    # the compressed input class is actually selected, with slice dedup
    inputs, _maker = fused._fused_inputs("amf", "OMI", [ctm], grans)
    assert isinstance(inputs, FullMonthEtaInputs)
    assert inputs.ctm_pmid.shape[0] <= len(grans) + 1  # unique slices + NaN pad
    assert inputs.ctm_idx.shape == (len(grans),)

    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0)
    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    _compare(fused, staged, ("sat_averaged_vcd", "ctm_averaged_vcd", "aux1",
                             "aux2", "ctm_averaged_vcd_corrected", "ak_OI",
                             "error_OI"))


def test_fused_device_granules_match_host_granules(monkeypatch):
    """OISAT_DEVICE_GRANULES=1: regrid leaves granule fields on device (no
    D2H), the fused month stacks them in place — results must match the
    host-granule fused month, and the deferred domain check must drop
    off-domain granules like the eager one."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import jax

    clon, clat = ctm_grid()
    ctm = synthetic_ctm()

    def build(device):
        grans = []
        for s in range(3):
            g = regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5, device=device)
            grans.append(g)
        # an off-domain granule: all-NaN vcd after QA
        far = synthetic_granule(9, 8)
        far.latitude_center = far.latitude_center + 60.0  # misses the domain
        far.time = far.time.replace(day=9)
        fg = regrid_granule(1, 0.25, far, clon, clat, flag_thresh=0.5,
                            device=device)
        if fg is not None:  # device mode defers the check
            grans.append(fg)
        return grans

    host = oisatgmi()
    host.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=build(False))
    host.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                             error_ctm=50.0)

    dev_grans = build(True)
    assert all(isinstance(g.vcd, jax.Array) for g in dev_grans)
    assert hasattr(dev_grans[0], "_device_valid")
    dev = oisatgmi()
    dev.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=dev_grans)
    dev.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                            error_ctm=50.0)

    _compare(dev, host, ("sat_averaged_vcd", "ctm_averaged_vcd", "aux1",
                         "aux2", "ctm_averaged_vcd_corrected", "ak_OI",
                         "error_OI"), rtol=1e-5, atol=1e-7)
    # the off-domain granule must not have shifted the averaging time
    assert abs(dev.avg_time.timestamp() - host.avg_time.timestamp()) < 1.0


def test_fused_device_granules_eta_path(monkeypatch):
    """Device granules from eta-structured products carry carrier + tables
    and take the compressed Eta inputs without pulling stacks back."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import jax

    from oisat.parallel.analysis import FullMonthEtaInputs

    monkeypatch.setenv("OISAT_DEVICE_GRANULES", "1")
    ctm = synthetic_ctm()
    grans = _eta_granules()
    assert all(isinstance(g.vcd, jax.Array) for g in grans)
    assert all(hasattr(g, "_pmid_ab") for g in grans)
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    inputs, _maker = obj._fused_inputs("amf", "OMI", [ctm], grans)
    assert isinstance(inputs, FullMonthEtaInputs)
    assert isinstance(inputs.sat_pmid_carrier, jax.Array)
    assert isinstance(inputs.vcd, jax.Array)

    monkeypatch.setenv("OISAT_DEVICE_GRANULES", "0")
    host = oisatgmi()
    host.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=_eta_granules())
    host.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                             error_ctm=50.0)
    obj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                            error_ctm=50.0)
    _compare(obj, host, ("sat_averaged_vcd", "ctm_averaged_vcd",
                         "ctm_averaged_vcd_corrected"), rtol=1e-5, atol=1e-7)


def test_settle_device_granules_matches_host_drop(monkeypatch):
    """When the fused path falls back with device granules, the driver's
    settle applies the deferred off-domain check so the staged pipeline
    sees what host mode would (granule -> None)."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    clon, clat = ctm_grid()
    far = synthetic_granule(9, 8)
    far.latitude_center = far.latitude_center + 60.0
    # host mode drops it at regrid
    assert regrid_granule(1, 0.25, far, clon, clat, flag_thresh=0.5) is None
    far2 = synthetic_granule(9, 8)
    far2.latitude_center = far2.latitude_center + 60.0
    fg = regrid_granule(1, 0.25, far2, clon, clat, flag_thresh=0.5, device=True)
    ok = regrid_granule(1, 0.25, synthetic_granule(0, 4), clon, clat,
                        flag_thresh=0.5, device=True)
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[], sat_data=[ok, fg, None])
    obj.settle_device_granules()
    assert obj.reader_obj.sat_data[0] is ok
    assert obj.reader_obj.sat_data[1] is None  # deferred drop applied
    assert obj.reader_obj.sat_data[2] is None


# ---- extension composition (VERDICT r3 item 4 + item 1) --------------------


def _fresh_pair():
    """(staged, fused) objects over identical granule months."""
    staged = _month_state()
    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(
        ctm_data=staged.reader_obj.ctm_data,
        sat_data=copy.deepcopy(staged.reader_obj.sat_data))
    return staged, fused


AVG_FIELDS = ("sat_averaged_vcd", "ctm_averaged_vcd", "aux1", "aux2",
              "sat_averaged_error")
OI_FIELDS = ("ctm_averaged_vcd_corrected", "ak_OI", "error_OI")


def test_fused_weighting_matches_staged(monkeypatch):
    """averaging_weighting runs IN the fused program (weights computed on
    device with the staged _granule_weights formulas)."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    staged, fused = _fresh_pair()
    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01", weighting="inverse_variance")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0)
    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0, weighting="inverse_variance")
    _compare(fused, staged, AVG_FIELDS + OI_FIELDS)
    # weighted error differs from the unweighted month (the switch did
    # something): compare against an unweighted fused run
    plain, _ = _fresh_pair()
    plain.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    assert np.nansum(np.abs(np.nan_to_num(plain.sat_averaged_error)
                            - np.nan_to_num(fused.sat_averaged_error))) > 0


def test_fused_weighting_ak_needs_opt_granules():
    staged, fused = _fresh_pair()
    with pytest.raises(ValueError, match="averaging-kernel"):
        fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                                  weighting="ak")


def test_fused_desroziers_matches_staged(monkeypatch):
    """desroziers_iterations composes: the fused program supplies the
    averaged fields, the Desroziers re-estimated OI tail re-runs on them."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    staged, fused = _fresh_pair()
    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0, desroziers_iterations=2)
    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0, desroziers_iterations=2)
    _compare(fused, staged, AVG_FIELDS + OI_FIELDS)
    assert "desroziers_sa_scale" in fused.oi_diagnostics
    np.testing.assert_allclose(
        fused.oi_diagnostics["desroziers_sa_scale"],
        staged.oi_diagnostics["desroziers_sa_scale"], rtol=2e-3)


def test_fused_save_daily_matches_staged(tmp_path, monkeypatch):
    """save_daily composes: per-granule operator outputs come back in one
    batched pull and land in the same sat_data_*.mat files."""
    from scipy.io import loadmat

    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    staged, fused = _fresh_pair()
    staged.recal_amf()
    staged.savedaily(str(tmp_path / "staged"), "NO2", "201907")
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0)
    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0,
                              save_daily=(str(tmp_path / "fused"), "201907"))
    s_files = sorted(p.name for p in (tmp_path / "staged").glob("*.mat"))
    f_files = sorted(p.name for p in (tmp_path / "fused").glob("*.mat"))
    assert s_files == f_files and len(s_files) == 4
    for name in s_files:
        a = loadmat(tmp_path / "staged" / name)
        b = loadmat(tmp_path / "fused" / name)
        for key in ("vcd_sat", "vcd_ctm", "vcd_err", "time_sat", "lat", "lon"):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-4, atol=2e-5,
                                       equal_nan=True, err_msg=f"{name}:{key}")
    _compare(fused, staged, AVG_FIELDS + OI_FIELDS)


def test_fused_oi_full_tail_matches_staged(monkeypatch):
    """oi_method='full' composes: fused averages + the full-covariance
    blocked-Cholesky OI tail equal the staged method='full' month."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    staged, fused = _fresh_pair()
    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0, method="full", length_scale_km=200.0)
    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0, oi_method="full",
                              length_scale_km=200.0)
    _compare(fused, staged, AVG_FIELDS)
    # the full-covariance tail regularizes via a knee scan: the ~1e-4
    # f32-vs-f64 averaging deltas can shift the chosen regularization one
    # notch, which moves xb by a few percent — compare at that scale (both
    # runs are the same deterministic dense solve; only the inputs differ)
    _compare(fused, staged, ("ctm_averaged_vcd_corrected",), rtol=5e-2,
             atol=5e-3)
    # the posterior error is the most reg-sensitive output; its values are
    # O(0.1-1) here, so an absolute tolerance is the meaningful bound
    _compare(fused, staged, ("error_OI",), rtol=5e-2, atol=2e-2)
    assert "chi2" in fused.oi_diagnostics


def test_fused_device_month_has_no_eager_assembly_programs(monkeypatch):
    """The device-granule fused month must assemble in FUSED programs only:
    the field stacks ride _stack_fields, the validity pull rides it too,
    and the regrid collect defers reorder/reshape into
    _finish_device_fields — no eager jnp ops (each would be a separate
    compiled program + a per-granule dispatch; the compile census pinned
    the cold-month floor here)."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import jax

    from oisat.utils.compile_census import CompileCensus

    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    # a granule count no other test uses, so any eager per-field stack
    # would be a FRESH signature and show up in the census
    grans = []
    for s in range(5):
        g = regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                           flag_thresh=0.5, device=True)
        g.time = g.time.replace(day=4 + s)
        grans.append(g)
    far = synthetic_granule(9, 12)
    far.latitude_center = far.latitude_center + 60.0
    far.time = far.time.replace(day=12)
    grans.append(regrid_granule(1, 0.25, far, clon, clat, flag_thresh=0.5,
                                device=True))
    assert all(isinstance(g.vcd, jax.Array) for g in grans)

    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    with CompileCensus(capture_names=True) as census:
        obj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                                error_ctm=50.0)
    eager = {"jit(concatenate)", "jit(broadcast_in_dim)", "jit(reshape)",
             "jit(squeeze)", "jit(sqrt)", "jit(isfinite)", "jit(_reduce_any)",
             "jit(dynamic_slice)", "jit(convert_element_type)"}
    names = [n for _, n in census.names]
    assert not (set(names) & eager), f"eager assembly programs: {names}"
    assert np.isfinite(np.asarray(obj.ctm_averaged_vcd_corrected)).any()


def test_fused_and_staged_diagnostics_agree_with_negative_obs(monkeypatch):
    """chi2/OmB/OmA must agree between the staged and fused paths when the
    averaged observation goes NEGATIVE somewhere: both now compute the
    moments on the y<0 -> 0 clamped observation the OI assimilated (the
    staged scalar path used the raw y until round 4 session 2)."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    granules = []
    for s in range(4):
        g = synthetic_granule(s, 4 + s)
        g.vcd = g.vcd - 2.5  # plenty of negative columns
        granules.append(regrid_granule(1, 0.25, g, clon, clat,
                                       flag_thresh=0.5))
    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm],
                                       sat_data=copy.deepcopy(granules))

    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0)
    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)

    # the clamp must actually have bitten for the test to mean anything
    assert np.nanmin(staged.sat_averaged_vcd) < 0
    assert staged.oi_diagnostics["n"] == fused.oi_diagnostics["n"] > 0
    for k in ("omb_mean", "omb_rms", "oma_mean", "oma_rms", "chi2"):
        np.testing.assert_allclose(fused.oi_diagnostics[k],
                                   staged.oi_diagnostics[k],
                                   rtol=5e-4, err_msg=k)


def test_settled_valid_alignment():
    """_settled_valid keeps the flag<->granule alignment with Nones
    interleaved (flagless granules resolve True, device flags in order)."""
    import jax.numpy as jnp

    from oisat.driver import _settled_valid

    t = jnp.asarray(True)
    f = jnp.asarray(False)
    assert _settled_valid([]) == []
    assert _settled_valid([None, None]) == [True, True]
    assert _settled_valid([None, f, t, None, f]) == [True, False, True, True, False]


def test_fused_compresses_affine_ctm_stack(monkeypatch):
    """When the matched CTM pmid slices are hybrid-eta affine (GMI/ECCOH),
    the fused assembly ships carrier + tables instead of the full stack,
    and the month matches the staged pipeline."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    # rebuild the CTM pressure grid as exactly hybrid-eta: pmid = a + b*ps
    nt, nz = ctm.pressure_mid.shape[:2]
    H, W = ctm.latitude.shape
    r = np.random.default_rng(3)
    a = np.concatenate([[0.0], np.linspace(40, 600, nz - 1)])
    b = np.concatenate([[1.0], np.linspace(0.9, 0.01, nz - 1)])
    ps = 1000.0 + 30.0 * r.standard_normal((nt, H, W))
    ctm.pressure_mid = (a[None, :, None, None]
                        + b[None, :, None, None] * ps[:, None]).astype("float32")

    def state():
        # eta-shaped SAT stacks too: the compressed-CTM route lives inside
        # the Eta variant, which requires affine sat pmids
        obj = oisatgmi()
        obj.reader_obj = SimpleNamespace(ctm_data=[ctm],
                                         sat_data=_eta_granules())
        return obj

    fused, staged = state(), state()
    # prove the assembly actually took the compressed route
    import oisat.driver as drv
    built = {}
    orig = drv.oisatgmi._fused_inputs
    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        built["inputs"] = out[0]
        return out
    monkeypatch.setattr(drv.oisatgmi, "_fused_inputs", spy, raising=False)

    staged.recal_amf()
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("OMI", "NO2")
    staged.oi("OMI", error_ctm=50.0)
    fused.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    inp = built.get("inputs")
    if inp is not None:  # spy seam present
        assert inp.ctm_pmid_a.shape[-1] > 1, "compressed route not taken"
        assert inp.ctm_pmid.shape[1] == 1
    _compare(fused, staged, ("sat_averaged_vcd", "ctm_averaged_vcd",
                             "ctm_averaged_vcd_corrected", "aux1"))


def test_fused_mopitt_compressed_ctm_matches_staged(monkeypatch):
    """A GMI/eta-structured CTM makes the fused MOPITT assembly ship the
    pressure AND air-column stacks as carrier + tables; results must still
    match the staged conv_ak pipeline."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import datetime

    from oisat.datamodel import ctm_model, satellite_opt

    H, W, Ls, Lc = 12, 14, 9, 12
    rng = np.random.default_rng(6)
    a = np.concatenate([[0.0], np.linspace(40.0, 600.0, Lc - 1)])
    b = np.concatenate([[1.0], np.linspace(0.9, 0.01, Lc - 1)])
    ps = 1000.0 + 30.0 * rng.standard_normal((H, W))
    pmid = (a[:, None, None] + b[:, None, None] * ps[None]).astype("float32")
    # eta delta-p too: dp[l] = da[l] + db[l]*ps -> affine air columns
    da = np.linspace(5.0, 40.0, Lc)
    db = np.linspace(0.02, 0.001, Lc)
    dp = (da[:, None, None] + db[:, None, None] * ps[None]).astype("float32")
    ctm = ctm_model(np.zeros((H, W)), np.zeros((H, W)),
                    [datetime.datetime(2019, 7, 1)],
                    np.abs(rng.normal(80, 20, (Lc, H, W))).astype("float32"),
                    pmid, [], dp, "ECCOH", False)

    def gran(seed, day):
        r = np.random.default_rng(seed)
        vcd = np.abs(r.normal(2, 0.5, (H, W)))
        vcd[r.random((H, W)) < 0.2] = np.nan
        return satellite_opt(
            vcd=vcd, time=datetime.datetime(2019, 7, day, 12),
            tropopause=np.empty((1,)),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            uncertainty=np.abs(r.normal(0.3, 0.05, (H, W))), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy().astype("float32"),
            averaging_kernels=r.uniform(0, 0.5, (Ls + 1, H, W)).astype("float32"),
            aprior_column=np.abs(r.normal(2, 0.3, (H, W))).astype("float32"),
            apriori_profile=np.abs(r.normal(80, 15, (Ls, H, W))).astype("float32"),
            surface_pressure=np.full((H, W), 1000.0, "float32"),
            apriori_surface=np.abs(r.normal(90, 10, (H, W))).astype("float32"),
            x_col=np.abs(r.normal(0.1, 0.02, (H, W))).astype("float32"),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    grans = [gran(s, 2 + s) for s in range(3)]
    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=copy.deepcopy(grans))
    staged.conv_ak("MOPITT")
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("MOPITT", "CO")
    staged.oi("MOPITT", error_ctm=50.0)

    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    built = {}
    orig = oisatgmi._fused_inputs
    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        built["inputs"] = out[0]
        return out
    monkeypatch.setattr(oisatgmi, "_fused_inputs", spy)
    fused.analyze_month_fused("MOPITT", "CO", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    inp = built["inputs"]
    assert inp.ctm_pmid_a.shape[-1] > 1, "pmid not compressed"
    assert inp.ctm_pmid.shape[1] == 1
    assert inp.ctm_airpc_a.shape[-1] > 1, "airpc not compressed"
    assert inp.ctm_airpc.shape[1] == 0
    _compare(fused, staged, ("sat_averaged_vcd", "ctm_averaged_vcd", "aux1",
                             "aux2", "ctm_averaged_vcd_corrected", "error_OI"))


def test_fused_mopitt_compressed_narrow_mode(monkeypatch):
    """The mode the compression actually targets: DEFAULT narrow (f16)
    transfers.  The air columns must keep f32-grade agreement with the
    staged path (they reconstruct from an f32 carrier — the 'NEVER f16'
    air-column rule), while the f16-shipped pressure stacks bound the
    rest at ~1e-3."""
    monkeypatch.delenv("OISAT_F16_TRANSFER", raising=False)
    import datetime

    from oisat.datamodel import ctm_model, satellite_opt

    H, W, Ls, Lc = 12, 14, 9, 12
    rng = np.random.default_rng(16)
    a = np.concatenate([[0.0], np.linspace(40.0, 600.0, Lc - 1)])
    b = np.concatenate([[1.0], np.linspace(0.9, 0.01, Lc - 1)])
    ps = 1000.0 + 30.0 * rng.standard_normal((H, W))
    pmid = (a[:, None, None] + b[:, None, None] * ps[None]).astype("float32")
    da = np.linspace(5.0, 40.0, Lc)
    db = np.linspace(0.02, 0.001, Lc)
    dp = (da[:, None, None] + db[:, None, None] * ps[None]).astype("float32")
    ctm = ctm_model(np.zeros((H, W)), np.zeros((H, W)),
                    [datetime.datetime(2019, 7, 1)],
                    np.abs(rng.normal(80, 20, (Lc, H, W))).astype("float32"),
                    pmid, [], dp, "ECCOH", False)

    def gran(seed, day):
        r = np.random.default_rng(seed)
        vcd = np.abs(r.normal(2, 0.5, (H, W)))
        vcd[r.random((H, W)) < 0.2] = np.nan
        return satellite_opt(
            vcd=vcd, time=datetime.datetime(2019, 7, day, 12),
            tropopause=np.empty((1,)),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            uncertainty=np.abs(r.normal(0.3, 0.05, (H, W))), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy().astype("float32"),
            averaging_kernels=r.uniform(0, 0.5, (Ls + 1, H, W)).astype("float32"),
            aprior_column=np.abs(r.normal(2, 0.3, (H, W))).astype("float32"),
            apriori_profile=np.abs(r.normal(80, 15, (Ls, H, W))).astype("float32"),
            surface_pressure=np.full((H, W), 1000.0, "float32"),
            apriori_surface=np.abs(r.normal(90, 10, (H, W))).astype("float32"),
            x_col=np.abs(r.normal(0.1, 0.02, (H, W))).astype("float32"),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    grans = [gran(s, 2 + s) for s in range(3)]
    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=copy.deepcopy(grans))
    staged.conv_ak("MOPITT")
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("MOPITT", "CO")
    staged.oi("MOPITT", error_ctm=50.0)

    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    built = {}
    orig = oisatgmi._fused_inputs
    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        built["inputs"] = out[0]
        return out
    monkeypatch.setattr(oisatgmi, "_fused_inputs", spy)
    fused.analyze_month_fused("MOPITT", "CO", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    inp = built["inputs"]
    assert inp.ctm_airpc.shape[1] == 0  # compression engaged in narrow mode
    # the pressure carrier must NOT be f16: air columns (slopes ~1e6)
    # reconstruct from it
    assert np.asarray(inp.ctm_pmid).dtype == np.float32
    # bound: the STAGED path ships pmid at f16 (~0.25 hPa rounding) while
    # the fused path reconstructs it at f32 — log-p interpolation turns
    # that into up to ~3e-3 relative on individual cells
    _compare(fused, staged, ("sat_averaged_vcd", "ctm_averaged_vcd", "aux1",
                             "aux2", "ctm_averaged_vcd_corrected"),
             rtol=4e-3, atol=1e-4)


def test_fused_mopitt_mixed_affinity_falls_back_whole_month(monkeypatch):
    """One granule matched to a non-affine CTM slice must push the WHOLE
    month to the full layout (a month is one stacked batch — mixing
    carrier and full granules is impossible), with identical results."""
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")
    import datetime

    from tests.test_parity_composed import _eccoh_like_ctm

    from oisat.datamodel import ctm_model, satellite_opt

    H, W, Ls, Lc = 12, 14, 9, 20
    # day 1: eta CTM (affine); day 2: random CTM (not affine)
    rng = np.random.default_rng(31)
    a = np.concatenate([[0.0], np.linspace(40.0, 600.0, Lc - 1)])
    b = np.concatenate([[1.0], np.linspace(0.9, 0.01, Lc - 1)])
    ps = 1000.0 + 30.0 * rng.standard_normal((H, W))
    pmid = (a[:, None, None] + b[:, None, None] * ps[None]).astype("float32")
    eta_ctm = ctm_model(np.zeros((H, W)), np.zeros((H, W)),
                        [datetime.datetime(2019, 7, 1)],
                        np.abs(rng.normal(80, 20, (Lc, H, W))).astype("float32"),
                        pmid, [],
                        rng.uniform(10, 40, (Lc, H, W)).astype("float32"),
                        "ECCOH", False)
    rnd_ctm = _eccoh_like_ctm(H, W)
    rnd_ctm.time = [datetime.datetime(2019, 7, 20)]

    def gran(seed, day):
        r = np.random.default_rng(seed)
        vcd = np.abs(r.normal(2, 0.5, (H, W)))
        return satellite_opt(
            vcd=vcd, time=datetime.datetime(2019, 7, day, 12),
            tropopause=np.empty((1,)),
            latitude_center=np.zeros((H, W)), longitude_center=np.zeros((H, W)),
            uncertainty=np.abs(r.normal(0.3, 0.05, (H, W))), quality_flag=[],
            pressure_mid=np.sort(r.uniform(100, 900, (Ls, H, W)), axis=0)[::-1].copy().astype("float32"),
            averaging_kernels=r.uniform(0, 0.5, (Ls + 1, H, W)).astype("float32"),
            aprior_column=np.abs(r.normal(2, 0.3, (H, W))).astype("float32"),
            apriori_profile=np.abs(r.normal(80, 15, (Ls, H, W))).astype("float32"),
            surface_pressure=np.full((H, W), 1000.0, "float32"),
            apriori_surface=np.abs(r.normal(90, 10, (H, W))).astype("float32"),
            x_col=np.abs(r.normal(0.1, 0.02, (H, W))).astype("float32"),
            pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

    grans = [gran(1, 2), gran(2, 21)]  # day 2 -> eta slice, day 21 -> random
    fused = oisatgmi()
    fused.reader_obj = SimpleNamespace(ctm_data=[eta_ctm, rnd_ctm],
                                       sat_data=grans)
    built = {}
    orig = oisatgmi._fused_inputs
    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        built["inputs"] = out[0]
        return out
    monkeypatch.setattr(oisatgmi, "_fused_inputs", spy)
    fused.analyze_month_fused("MOPITT", "CO", "2019-07-01", "2019-08-01",
                              error_ctm=50.0)
    inp = built["inputs"]
    assert inp.ctm_pmid_a.shape == (1, 1)  # full layout for the whole month
    assert inp.ctm_pmid.shape[1] == Lc
    assert inp.ctm_airpc.shape[1] == Lc

    staged = oisatgmi()
    staged.reader_obj = SimpleNamespace(ctm_data=[eta_ctm, rnd_ctm],
                                        sat_data=copy.deepcopy(grans))
    staged.conv_ak("MOPITT")
    staged.average("2019-07-01", "2019-08-01")
    staged.bias_correct("MOPITT", "CO")
    staged.oi("MOPITT", error_ctm=50.0)
    _compare(fused, staged, ("ctm_averaged_vcd", "aux2",
                             "ctm_averaged_vcd_corrected"))
