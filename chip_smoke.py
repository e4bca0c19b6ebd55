#!/usr/bin/env python3
"""Smoke check of the month pipeline on one NVIDIA GPU, at the sizes users run.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # phase 2's fused month on a 4-card mesh
                                       # against the same month on one card

Phases (each prints one JSON line with its numbers, its tolerances and the
card's name and power limit):

1. scalar OI on a 1440 x 2880 grid (4.1M cells) in f32 against the float64
   NumPy reference, plus the mean-AK curve timed against its bound;
2. one OMI-NO2-shaped month (42 orbits of 1644 x 60 pixels, 35 levels) on
   a GMI-shaped global CTM (288 x 181 cells, 72 levels, 8 three-hourly
   times) through ``run/job.py``'s ``run_month``, fused and staged;
3. dense full-covariance OI (``oi_full_dense`` at n = 8192,
   ``oi_full_dense_scan`` at n = 6144) against float64 NumPy solves, the
   covariance builder against its write bound, and ``oi_full`` on ~10,000
   cells through the device float64 exact tail;
4. matrix-free full-covariance OI on the 1-degree global grid (64,800 cells).

Every check raises on failure, so the script exits non-zero; it also fails
when JAX finds no GPU.  The last line is the JSON device record
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "run"))
sys.path.insert(0, str(REPO / "tests"))  # reference_impl: float64 goldens

import oisat  # noqa: E402,F401  (fails here when the package is absent)

CARD = None  # nvidia-smi "name, power.limit" line(s), set in main()


def require_gpu():
    """The devices, or RuntimeError when JAX's default backend is not a GPU
    (this script never carries on on the CPU)."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"chip_smoke.py needs an NVIDIA GPU; JAX's default backend is "
            f"{backend!r}")
    return jax.devices()


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields, "card": CARD},
                     default=_jsonable), flush=True)


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def timed(fn, n=5):
    """Median wall seconds of ``fn()`` (each call ends in
    ``block_until_ready``), after one untimed call."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def rel_err(got, ref, floor=0.0):
    """max |got - ref| / max(|ref|, floor) over the cells finite in both."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    m = np.isfinite(got) & np.isfinite(ref)
    if not m.any():
        return float("nan")
    return float(np.max(np.abs(got[m] - ref[m])
                        / np.maximum(np.abs(ref[m]), floor)))


def field_rel_err(got, ref):
    """max |got - ref| / max |ref| over the cells finite in both."""
    ref = np.asarray(ref, np.float64)
    m = np.isfinite(ref) & np.isfinite(np.asarray(got, np.float64))
    return rel_err(got, ref, floor=float(np.max(np.abs(ref[m]))))


def same_nan_pattern(a, b):
    return bool(np.array_equal(np.isnan(np.asarray(a, np.float64)),
                               np.isnan(np.asarray(b, np.float64))))


# --------------------------------------------------------------------- 1


def phase_scalar_oi(H=1440, W=2880):
    """Scalar OI in f32 against ``bench.numpy_reference_oi`` in float64."""
    import jax
    import jax.numpy as jnp

    import bench
    from oisat.ops.oi import ak_curve, oi, regularization_grid

    f32 = bench.make_fields(H, W, dtype=np.float32)
    # the reference sees the same (f32-representable) inputs in float64
    xb_r, ak_r, inc_r, err_r, idx_r = bench.numpy_reference_oi(
        *(f.astype(np.float64) for f in f32))
    dev = tuple(jnp.asarray(f) for f in f32)
    step = jax.jit(oi)
    t0 = time.perf_counter()
    compiled = step.lower(*dev).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*dev))
    t_warm = timed(lambda: compiled(*dev), n=21)

    tol = 1e-4
    errs = {"xb": rel_err(out.xb, xb_r),
            "averaging_kernel": field_rel_err(out.averaging_kernel, ak_r),
            "increment": field_rel_err(out.increment, inc_r),
            "error": rel_err(out.error, err_r)}
    check(int(out.reg_index) == int(idx_r),
          f"reg_index {int(out.reg_index)} != reference {int(idx_r)}")
    for k, e in errs.items():
        check(e <= tol, f"scalar OI {k} rel err {e:.3e} > {tol}")
    check(same_nan_pattern(out.xb, xb_r), "scalar OI NaN pattern differs")

    # the mean-AK curve against its bound: u read once (4 B/cell) or 99
    # f32 divides per cell at the SFU rate (132 SMs x 16 SFUs x 1.98 GHz)
    regs = jnp.asarray(regularization_grid(), jnp.float32)
    curve = jax.jit(ak_curve)
    curve_rows = {}
    for cells in (H * W, NLAT * NLON):
        sa, so = jax.block_until_ready((dev[2].ravel()[:cells],
                                        dev[3].ravel()[:cells]))
        t = timed(lambda: curve(sa, so, regs), n=21)
        bound = max(cells * 4 / 3.35e12, cells * 99 / (132 * 16 * 1.98e9))
        curve_rows[str(cells)] = {"ms": t * 1e3, "bound_ms": bound * 1e3,
                                  "x_bound": t / bound}
    emit("1_scalar_oi", grid=[H, W], cells=H * W, reg_index=int(out.reg_index),
         compile_s=t_compile, warm_ms=t_warm * 1e3, rel_err=errs,
         tolerance={"rel": tol, "reg_index": "equal",
                    "rule": "xb/error per cell; AK/increment per field max"},
         ak_curve=curve_rows)
    return curve_rows


# --------------------------------------------------------------------- 2

NLON, NLAT, NLEV, NTIME = 288, 181, 72, 8   # GMI 1.25 x 1 deg, 72 levels
NY, NX, NZ = 1644, 60, 35                   # OMI swath, scattering weights
ORBITS_PER_DAY, DAYS = 14, 3


def gmi_ctm(seed=0):
    """A GMI-shaped month-averaged CTM on the global 1.25 x 1 degree grid:
    72 hybrid levels (p = a + b * ps, bottom first) at 8 three-hourly
    times, NO2 in ppbv."""
    from oisat.datamodel import ctm_model

    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(-180.0 + (360.0 / NLON) * np.arange(NLON),
                           np.linspace(-90.0, 90.0, NLAT))
    x = np.linspace(0.0, 1.0, NLEV, dtype=np.float32)
    eta_b = (1.0 - x) ** 3
    ps = (1000.0 + 20.0 * rng.standard_normal((NTIME, 1, NLAT, NLON))
          ).astype(np.float32)
    pmid = 0.01 + eta_b[None, :, None, None] * ps
    dp = np.abs(np.gradient(pmid, axis=1)).astype(np.float32)
    prof = np.abs(rng.normal(0.03, 0.01, (NTIME, NLEV, NLAT, NLON))).astype(
        np.float32)
    prof[:, :10] *= 5.0  # boundary-layer enhancement
    times = [datetime.datetime(2019, 7, 1, h) for h in range(0, 24, 3)]
    return ctm_model(lat, lon, times, prof, pmid.astype(np.float32), [], dp,
                     "GMI", True)


def omi_orbit(k, day, seed):
    """An OMI-NO2-shaped L2 orbit: 1644 x 60 pixels along a daylight
    half-orbit, 35 hybrid-eta levels of scattering weights."""
    from oisat.datamodel import satellite_amf
    from oisat.readers.sensors.common import attach_pmid_tables

    rng = np.random.default_rng(seed)
    along = np.linspace(-75.0, 75.0, NY)[:, None]
    lon0 = -150.0 + (k + 0.37 * day) * (300.0 / ORBITS_PER_DAY)
    across = np.linspace(-13.0, 13.0, NX)[None, :]
    lat = along + 0.02 * rng.standard_normal((NY, NX))
    lon = (lon0 + across / np.maximum(np.cos(np.deg2rad(along)), 0.5)
           + 0.02 * rng.standard_normal((NY, NX)))
    eta_a = np.linspace(0.0, 100.0, NZ)
    eta_b = np.linspace(1.0, 0.02, NZ)
    psurf = 1000.0 + 30.0 * rng.standard_normal((NY, NX))
    pm = eta_a[:, None, None] + eta_b[:, None, None] * psurf[None]
    hour = (13.5 - lon0 / 15.0) % 24.0  # 13:30 local overpass in UTC
    when = (datetime.datetime(2019, 7, 1 + day)
            + datetime.timedelta(hours=float(hour)))
    g = satellite_amf(
        vcd=2.0 + np.sin(lon / 5.0) * np.cos(lat / 7.0)
        + 0.3 * rng.standard_normal((NY, NX)),
        amf=np.full((NY, NX), 1.5), time=when,
        tropopause=np.full((NY, NX), 150.0),
        latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.full((NY, NX), 0.5), quality_flag=np.ones((NY, NX)),
        pressure_mid=pm,
        scattering_weights=np.abs(rng.normal(1.0, 0.2, (NZ, NY, NX))),
        ctm_upscaled_needed=False, ctm_vcd=[], ctm_time_at_sat=[],
        old_amf=[], new_amf=[])
    return attach_pmid_tables(g, eta_a, eta_b)


def regrid_month(ctm, device, mesh=None):
    """The month's orbits regridded onto the CTM grid the way the OMI
    reader does it (returns the granules and the wall seconds)."""
    import contextlib

    from oisat.readers.registry import SENSORS
    from oisat.regridder import regrid_granule, regrid_mesh

    spec = SENSORS["OMI_NO2"]
    t0 = time.perf_counter()
    grans = []
    ctx = regrid_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        for day in range(DAYS):
            for k in range(ORBITS_PER_DAY):
                g = regrid_granule(spec.interpolator_type, spec.grid_size,
                                   omi_orbit(k, day, seed=100 * day + k),
                                   ctm.longitude, ctm.latitude,
                                   flag_thresh=spec.flag_thresh, device=device)
                if g is not None:
                    grans.append(g)
    return grans, time.perf_counter() - t0


def month_ctrl(out_dir, fused, mesh_devices=1):
    return {
        "python_bin": sys.executable, "debug": False, "save_daily": False,
        "num_job": 1, "ctm_name": "GMI", "ctm_dir": str(out_dir),
        "mcip_dir": str(out_dir), "ctm_freq": "3-hourly", "ctm_avg": True,
        "ctm_error": 50.0, "gas": "NO2", "sensor": "OMI", "read_AK": True,
        "troposphere_only": True, "sat_dir": str(out_dir),
        "start_date": "2019-07", "end_date": "2019-07",
        "output_pdf_dir": str(out_dir / "report"),
        "output_nc_dir": str(out_dir / "diag"),
        "fused_month": fused, "mesh_devices": mesh_devices,
    }


def run_month_timed(ctrl, ctm, grans, outputs):
    """One month through ``run_month``'s ``pre_read`` seam; returns
    (session, wall seconds, stage report).  ``outputs`` False runs only
    the analysis (the nc/PDF writers' packages are missing)."""
    import job
    from oisat.driver import oisatgmi
    from oisat.utils import profiling

    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
    obj.gasname = "NO2"
    profiling.reset()
    t0 = time.perf_counter()
    if outputs:
        job.run_month(ctrl, 2019, 7, pre_read=obj)
    else:
        mesh = job._month_env_setup(ctrl)
        start, end = job.month_window(2019, 7)
        job._analyze(obj, ctrl, "OMI", "NO2", start, end,
                     savedaily=(ctrl["output_nc_dir"], "2019_07"), mesh=mesh)
    wall = time.perf_counter() - t0
    return obj, wall, json.loads(profiling.report())


RESULT_FIELDS = ("ctm_averaged_vcd_corrected", "ak_OI", "increment_OI",
                 "error_OI")


def scaling_factor(obj):
    """The diag file's scaling factor, derived as write_to_nc derives it."""
    with np.errstate(invalid="ignore", divide="ignore"):
        sf = (np.asarray(obj.ctm_averaged_vcd_corrected, np.float64)
              / np.asarray(obj.ctm_averaged_vcd, np.float64))
    return np.where(np.isnan(sf) | np.isinf(sf) | (sf == 0.0), 1.0, sf)


def compare_months(a, b, tol):
    errs = {f: field_rel_err(getattr(a, f), getattr(b, f))
            for f in RESULT_FIELDS}
    errs["scaling_factor"] = field_rel_err(scaling_factor(a), scaling_factor(b))
    for k, e in errs.items():
        check(e <= tol, f"month {k} rel err {e:.3e} > {tol}")
    check(a.reg_factor == b.reg_factor,
          f"reg factor {a.reg_factor} != {b.reg_factor}")
    return errs


def output_packages():
    return {name: importlib.util.find_spec(name) is not None
            for name in ("h5py", "yaml", "matplotlib")}


def phase_month(work, curve_rows):
    """Phase 2: the fused and the staged month on the same inputs.

    Both run with full-precision host->device transfers
    (``OISAT_F16_TRANSFER=0``): the default f16 narrowing rounds some
    fields on one path and not the other, which alone moves the posterior
    by ~3e-4 relative, so with it the comparison would measure the
    narrowing policy rather than the two pipelines."""
    prev = os.environ.get("OISAT_F16_TRANSFER")
    os.environ["OISAT_F16_TRANSFER"] = "0"
    try:
        return _phase_month(work, curve_rows)
    finally:
        if prev is None:
            os.environ.pop("OISAT_F16_TRANSFER")
        else:
            os.environ["OISAT_F16_TRANSFER"] = prev


def _phase_month(work, curve_rows):
    import jax

    from oisat import native
    from oisat.parallel.analysis import _STEP_JIT_CACHE
    from oisat.utils.compile_census import CompileCensus
    from oisat.utils.compile_cache import enable_compile_cache
    from reference_impl import oi_numpy

    pkgs = output_packages()
    outputs = pkgs["h5py"] and pkgs["matplotlib"]
    if not outputs:
        missing = [k for k in ("h5py", "matplotlib") if not pkgs[k]]
        print(f"phase 2: diag .nc and PDF report NOT written: {missing} "
              f"not installed; the month stops after the analysis",
              flush=True)
    cache_dir = Path(enable_compile_cache())
    cached_before = len(list(cache_dir.glob("*"))) if cache_dir.exists() else 0

    ctm = gmi_ctm()
    dev_grans, t_regrid_dev = regrid_month(ctm, device=True)
    host_grans, t_regrid_host = regrid_month(ctm, device=False)
    check(len(dev_grans) == len(host_grans) == ORBITS_PER_DAY * DAYS,
          f"granules regridded: {len(dev_grans)} device / {len(host_grans)} "
          f"host, expected {ORBITS_PER_DAY * DAYS}")
    host_warm = copy.deepcopy(host_grans)

    with CompileCensus() as cold:
        fused, t_fused_cold, st_f = run_month_timed(
            month_ctrl(work / "fused", True), ctm, dev_grans, outputs)
        staged, t_staged_cold, st_s = run_month_timed(
            month_ctrl(work / "staged", False), ctm, host_grans, outputs)
    # the fused month must not have fallen back to the staged pipeline
    check("fused_month" in st_f and "amf_recal" not in st_f,
          f"fused month fell back to the staged pipeline: stages {list(st_f)}")
    check("amf_recal" in st_s and "fused_month" not in st_s,
          f"staged month took the fused path: stages {list(st_s)}")
    _, t_fused_warm, st_fw = run_month_timed(
        month_ctrl(work / "fused", True), ctm, dev_grans, outputs)
    _, t_staged_warm, _ = run_month_timed(
        month_ctrl(work / "staged", False), ctm, host_warm, outputs)

    # compile again from the persistent cache: drop every in-memory program
    jax.clear_caches()
    _STEP_JIT_CACHE.clear()
    with CompileCensus() as warm:
        run_month_timed(month_ctrl(work / "fused", True), ctm, dev_grans,
                        outputs)

    tol = 1e-5
    fused_vs_staged = compare_months(fused, staged, tol)

    # the month's OI against the float64 NumPy reference on the same
    # averaged inputs
    xa = np.asarray(fused.ctm_averaged_vcd, np.float64)
    y = np.asarray(fused.sat_averaged_vcd, np.float64)
    sa = (xa * 50.0 / 100.0) ** 2
    so = np.asarray(fused.sat_averaged_error, np.float64) ** 2
    xb_r, ak_r, inc_r, err_r, idx_r, _ = oi_numpy(xa, y, sa, so)
    ref_tol = 1e-4
    vs_ref = {"xb": field_rel_err(fused.ctm_averaged_vcd_corrected, xb_r),
              "averaging_kernel": field_rel_err(fused.ak_OI, ak_r),
              "increment": field_rel_err(fused.increment_OI, inc_r),
              "error": field_rel_err(fused.error_OI, err_r)}
    for k, e in vs_ref.items():
        check(e <= ref_tol, f"month OI {k} vs oi_numpy {e:.3e} > {ref_tol}")
    reg_r = float(np.arange(0.1, 10.0, 0.1)[idx_r])
    check(abs(fused.reg_factor - reg_r) < 1e-6,
          f"month reg factor {fused.reg_factor} != reference {reg_r}")

    written = {}
    if outputs:
        from oisat.ncwriter import read_diag_nc

        nc = work / "fused" / "diag" / "NO2_201907.nc"
        fields, _ = read_diag_nc(nc)
        # 11 fields + the time string: the reference's 12-variable file
        check(len(fields) + 1 == 12, f"diag file has {len(fields)} fields "
                                     f"+ time, expected 11: {sorted(fields)}")
        check(field_rel_err(fields["scaling_factor"], scaling_factor(fused))
              <= 1e-6, "diag scaling_factor differs from the analysis")
        pdf = work / "fused" / "report" / "OI_report_NO2_201907.pdf"
        check(pdf.exists(), f"{pdf} not written")
        written = {"diag_nc_variables": len(fields) + 1,
                   "pdf_bytes": pdf.stat().st_size}
    finite = int(np.isfinite(np.asarray(fused.ctm_averaged_vcd_corrected)).sum())
    check(finite > 1000, f"only {finite} analysed cells")
    fused_step = st_fw["fused_month"]["total_s"]
    curve_52k = curve_rows[str(NLAT * NLON)]["ms"] / 1e3
    emit("2_month", ctm_grid=[NLAT, NLON], levels=NLEV, times=NTIME,
         granules=len(dev_grans), swath=[NY, NX, NZ], analysed_cells=finite,
         reg_factor=fused.reg_factor,
         regrid_s={"device_granules": t_regrid_dev,
                   "host_granules": t_regrid_host},
         fused_s={"cold": t_fused_cold, "warm": t_fused_warm,
                  "warm_fused_month_stage": fused_step},
         staged_s={"cold": t_staged_cold, "warm": t_staged_warm},
         compile_s={"cold": cold.total_seconds, "cold_programs": cold.n_compiles,
                    "warm_from_cache": warm.total_seconds,
                    "warm_programs": warm.n_compiles},
         compile_cache={"dir": str(cache_dir), "files_before": cached_before,
                        "files_after": len(list(cache_dir.glob("*")))},
         curve_share_of_fused_step=curve_52k / fused_step,
         fused_vs_staged=fused_vs_staged, vs_oi_numpy=vs_ref,
         tolerance={"fused_vs_staged": tol, "vs_oi_numpy": ref_tol,
                    "rule": "per field: max |a - b| / max |b|"},
         native_weight_builder=native.available(), packages=pkgs,
         transfers="full precision (OISAT_F16_TRANSFER=0)",
         outputs=written or "analysis only")
    return fused


def phase_four_cards(work):
    """The fused month on one card and sharded over a 2 x 2 mesh of four."""
    from oisat.parallel.mesh import make_mesh

    ctm = gmi_ctm()
    pkgs = output_packages()
    outputs = pkgs["h5py"] and pkgs["matplotlib"]
    one_grans, _ = regrid_month(ctm, device=True)
    one, t_one, st1 = run_month_timed(month_ctrl(work / "one", True), ctm,
                                      one_grans, outputs)
    mesh = make_mesh(4)
    four_grans, t_regrid4 = regrid_month(ctm, device=True, mesh=mesh)
    four, t_four, st4 = run_month_timed(month_ctrl(work / "four", True, 4),
                                        ctm, four_grans, outputs)
    _, t_four_warm, _ = run_month_timed(month_ctrl(work / "four", True, 4),
                                        ctm, four_grans, outputs)
    check("fused_month" in st4 and "amf_recal" not in st4,
          f"four-card month fell back to the staged pipeline: {list(st4)}")
    tol = 1e-5
    errs = compare_months(four, one, tol)
    emit("2_month_four_cards", mesh=dict(mesh.shape), granules=len(four_grans),
         one_card_cold_s=t_one, four_cards_cold_s=t_four,
         four_cards_warm_s=t_four_warm, four_card_regrid_s=t_regrid4,
         reg_factor=four.reg_factor, four_vs_one=errs,
         tolerance={"rel": tol, "reg_factor": "equal",
                    "rule": "per field: max |a - b| / max |b|"})


# --------------------------------------------------------------------- 3


def _regional_points(n, seed):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.normal(3, 1, n)), np.abs(rng.normal(3, 1, n)),
            np.abs(rng.normal(1, 0.2, n)), np.abs(rng.normal(0.6, 0.1, n)),
            rng.uniform(20, 60, n), rng.uniform(-130, -60, n))


def _f64_dense_reference(xa, y, sb, so, lat, lon, L):
    """xb, AK, increment, error of the dense full-covariance update in
    float64 NumPy/SciPy from build_covariance_reference."""
    import scipy.linalg as sla

    from oisat.ops.covariance import build_covariance_reference

    b = build_covariance_reference(lat, lon, sb, L)
    a = b + np.diag(so ** 2)
    c = sla.cho_factor(a, lower=True)
    inc = b @ sla.cho_solve(c, y - xa)
    ainv_b = sla.cho_solve(c, b)
    sb_diag = np.diag(b) - np.einsum("ij,ij->j", b, ainv_b)
    return xa + inc, 1.0 - sb_diag / np.diag(b), inc, np.sqrt(
        np.maximum(sb_diag, 0.0))


def _f64_scan_reference(xa, y, sb, so, lat, lon, L, regs):
    """The regularized dense update in float64: the 99-factor mean-AK curve
    from one eigendecomposition, the Kneedle knee, the chosen fields."""
    from oisat.ops.covariance import build_covariance_reference
    from oisat.ops.knee import kneedle_index_np

    b = build_covariance_reference(lat, lon, sb, L)
    dinv = 1.0 / so
    lam, q = np.linalg.eigh(b * dinv[:, None] * dinv[None, :])
    m2 = (q.T @ (b * dinv[:, None])) ** 2
    bd = np.diag(b)
    curve = np.array([np.mean(r * ((1.0 / (r * lam + 1.0)) @ m2) / bd)
                      for r in regs])
    idx = kneedle_index_np(regs, curve, fallback=0)
    r = regs[idx]
    coef = 1.0 / (r * lam + 1.0)
    w = dinv * (q @ (coef * (q.T @ ((y - xa) * dinv))))
    inc = r * (b @ w)
    sb_diag = r * bd - r * r * (coef @ m2)
    return xa + inc, 1.0 - sb_diag / (r * bd), inc, idx


def _tight_domain(side, seed):
    """A side x side regional 0.25-degree domain at monthly-average
    conditioning (sigma_o = sigma_b / 150), which sends oi_full's dense
    path to the float64 exact tail."""
    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(np.linspace(-100, -100 + 0.25 * side, side),
                           np.linspace(30, 30 + 0.25 * side, side))
    xa = np.abs(rng.normal(3, 1, (side, side)))
    y = xa * rng.uniform(0.8, 1.3, (side, side))
    sb = 0.5 * xa
    return xa, y, sb, sb / 150.0, lat, lon


def phase_full_covariance(n_dense=8192, n_scan=6144, n_build=10240,
                          sides=(45, 100)):
    import jax
    import jax.numpy as jnp

    from oisat.ops import oi_full as mod
    from oisat.ops.covariance import build_covariance
    from oisat.ops.oi import regularization_grid

    L = 300.0
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    rows = {}

    # oi_full_dense at n = 8192 (a multiple of 128, as oi_full pads)
    pts = _regional_points(n_dense, seed=1)
    args = tuple(f32(a) for a in pts)
    t0 = time.perf_counter()
    dense = mod.oi_full_dense.lower(*args, L).compile()
    t_c = time.perf_counter() - t0
    got = jax.block_until_ready(dense(*args))
    t_w = timed(lambda: dense(*args), n=3)
    ref = _f64_dense_reference(*pts, L)
    tol = {"xb": (2e-4, 1e-4), "averaging_kernel": (2e-3, 2e-4),
           "increment": (0.0, 5e-4)}
    errs = {}
    for name, g, r in zip(("xb", "averaging_kernel", "increment"),
                          got[:3], ref[:3]):
        g = np.asarray(g, np.float64)
        rt, at = tol[name]
        excess = np.max(np.abs(g - r) - (at + rt * np.abs(r)))
        errs[name] = float(np.max(np.abs(g - r)))
        check(excess <= 0, f"oi_full_dense {name}: |err| {errs[name]:.3e} "
                           f"beyond rtol {rt} / atol {at}")
    rows["oi_full_dense"] = {
        "n": n_dense, "compile_s": t_c, "warm_s": t_w, "max_abs_err": errs,
        "max_rel_increment_err": field_rel_err(got[2], ref[2]),
        "tolerance": {k: {"rtol": v[0], "atol": v[1]} for k, v in tol.items()}}

    # oi_full_dense_scan at n = 6144
    pts = _regional_points(n_scan, seed=2)
    args = tuple(f32(a) for a in pts)
    regs = regularization_grid()
    t0 = time.perf_counter()
    scan = mod.oi_full_dense_scan.lower(*args, L, f32(regs)).compile()
    t_c = time.perf_counter() - t0
    got = jax.block_until_ready(scan(*args, f32(regs)))
    t_w = timed(lambda: scan(*args, f32(regs)), n=3)
    ref = _f64_scan_reference(*pts, L, regs)
    check(int(got[4]) == int(ref[3]),
          f"oi_full_dense_scan knee {int(got[4])} != reference {int(ref[3])}")
    tol = {"xb": (5e-4, 5e-4), "averaging_kernel": (5e-3, 5e-3),
           "increment": (0.0, 5e-4)}
    errs = {}
    for name, g, r in zip(("xb", "averaging_kernel", "increment"),
                          (got[0], got[1], got[2]), ref[:3]):
        g = np.asarray(g, np.float64)
        rt, at = tol[name]
        excess = np.max(np.abs(g - r) - (at + rt * np.abs(r)))
        errs[name] = float(np.max(np.abs(g - r)))
        check(excess <= 0, f"oi_full_dense_scan {name}: |err| "
                           f"{errs[name]:.3e} beyond rtol {rt} / atol {at}")
    rows["oi_full_dense_scan"] = {
        "n": n_scan, "compile_s": t_c, "warm_s": t_w, "reg_index": int(got[4]),
        "max_abs_err": errs,
        "max_rel_increment_err": field_rel_err(got[2], ref[2]),
        "tolerance": {k: {"rtol": v[0], "atol": v[1]} for k, v in tol.items()}}

    # memory of the dense programs at the solver-switch limits
    def memory(fn, n, *extra):
        spec = jax.ShapeDtypeStruct((n,), jnp.float32)
        ma = fn.lower(*([spec] * 6), L, *extra).compile().memory_analysis()
        return {k: getattr(ma, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}
    rows["memory_at_limits"] = {
        f"oi_full_dense@{mod.DENSE_MAX_CELLS}":
            memory(mod.oi_full_dense, mod.DENSE_MAX_CELLS),
        f"oi_full_dense_scan@{mod.DENSE_SCAN_MAX_CELLS}":
            memory(mod.oi_full_dense_scan, mod.DENSE_SCAN_MAX_CELLS,
                   jax.ShapeDtypeStruct((99,), jnp.float32))}

    # the covariance builder against its write bound N^2 * 4 B
    n = n_build
    lat, lon, sig = (f32(a) for a in _regional_points(n, seed=3)[4:6]
                     + (np.ones(n),))
    t_b = timed(lambda: build_covariance(lat, lon, sig, L), n=21)
    bound = n * n * 4 / 3.35e12
    rows["build_covariance"] = {"n": n, "ms": t_b * 1e3,
                                "write_bound_ms": bound * 1e3,
                                "share_of_bound": bound / t_b}

    # oi_full through the float64 device exact tail (buckets 2048, 10240)
    for side in sides:
        dom = _tight_domain(side, seed=side)
        t0 = time.perf_counter()
        res = mod.oi_full(*dom, L)
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = mod.oi_full(*dom, L)
        t_warm = time.perf_counter() - t0
        info = res.info or {}
        check(info.get("solver") == "dense+direct_f64_dev",
              f"oi_full at {side * side} cells took {info.get('solver')!r}, "
              f"not the device f64 exact tail")
        check(info["f64_resid"] <= mod.DEVICE_EXACT_RESID_GATE,
              f"exact-tail residual {info['f64_resid']:.2e}")
        check(np.isfinite(res.xb).all(), "exact-tail xb not finite")
        rows[f"exact_tail@{side * side}"] = {
            "cells": side * side,
            "bucket": -(-side * side // mod.EXACT_TAIL_BUCKET)
            * mod.EXACT_TAIL_BUCKET,
            "solver": info["solver"], "f64_resid": info["f64_resid"],
            "cold_s": t_cold, "warm_s": t_warm,
            "compile_s_estimate": t_cold - t_warm}
    emit("3_full_covariance", **rows,
         resid_gate=mod.DEVICE_EXACT_RESID_GATE)


# --------------------------------------------------------------------- 4


def phase_matfree(n_cells=64800):
    from oisat.ops.oi_full import oi_full_matfree

    H, W = 180, n_cells // 180
    rng = np.random.default_rng(0)
    lon, lat = np.meshgrid(np.linspace(-179.5, 179.5, W),
                           np.linspace(-89.5, 89.5, H))
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = xa * rng.uniform(0.8, 1.3, (H, W))
    sigb = np.abs(rng.normal(1.0, 0.2, (H, W)))
    sigo = np.abs(rng.normal(0.6, 0.1, (H, W)))
    args = (xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(),
            lat.ravel(), lon.ravel(), 300.0)
    t0 = time.perf_counter()
    oi_full_matfree(*args, block=2048)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    xb, ak, inc, err, info = oi_full_matfree(*args, block=2048)
    t_warm = time.perf_counter() - t0
    for name, f in (("xb", xb), ("ak", ak), ("increment", inc),
                    ("error", err)):
        check(np.isfinite(f).all(), f"matrix-free {name} not finite")
    check(info["cg_resid"] < 1e-3, f"matrix-free cg_resid {info['cg_resid']}")
    emit("4_matfree", cells=H * W, cold_s=t_cold, warm_s=t_warm,
         tolerance={"cg_resid": 1e-3, "fields": "finite"},
         info={k: v for k, v in info.items()})


# --------------------------------------------------------------------- main


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 2's fused month sharded over four "
                         "cards, against the same month on one card")
    opts = ap.parse_args(argv)

    from oisat.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = require_gpu()
    CARD = nvidia_smi()
    print(CARD, flush=True)
    print(json.dumps({"packages": output_packages(),
                      "jax_devices": [d.device_kind for d in devices]}),
          flush=True)
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        if opts.four_cards:
            check(len(devices) >= 4, f"--four-cards needs 4 GPUs, JAX sees "
                                     f"{len(devices)}")
            phase_four_cards(work)
        else:
            curve_rows = phase_scalar_oi()
            phase_month(work, curve_rows)
            phase_full_covariance()
            phase_matfree()
    check("jax._src.pallas.pallas_call" not in sys.modules,
          "a Pallas kernel was loaded; every kernel here is compiled by XLA")
    print(json.dumps({"total_s": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
