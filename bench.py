"""Headline benchmark: OI analysis throughput (grid-cells/sec).

Runs the complete OI update — 99-factor regularization scan, Kneedle knee
pick, final Kalman fields — on the GPU over a large analysis grid, and
compares against the reference's NumPy formulation (vectorized per-factor
loop + knee pick, float64, as in reference optimal_interpolation.py:6-52)
on this host's CPU.  The NumPy baseline is run without storing the 99
per-factor field triples the reference keeps in RAM, which only makes the
baseline *faster*, so ``vs_baseline`` is conservative.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline", "detail"};
``detail.device`` stamps the platform, device kind, device count and the
card's power limit on every row.  A run that finds no GPU fails.

``bench.py --all`` runs every row, one JSON line each: the dense Kalman
solve TFLOP/s, the swath→grid regrid ms/orbit (parity and fast host
builders), the 64k-cell matrix-free full-covariance OI, the synthetic
months, the bandwidth-regime OI, TEMPO, TROPOMI and the campaign prefetch
(``--month`` and the other flags below run single rows).  Device step
times end in ``block_until_ready``; compilation is warmed up first.
"""

import json
import subprocess
import time
import warnings

import numpy as np

# Published per-device peaks, keyed by ``jax.devices()[0].device_kind``
# (NVIDIA H100 SXM data sheet: dense rates, no sparsity, at the 700 W
# power limit).  A device missing from the table is an error, not a
# default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 SXM data sheet",
        "hbm_gbps": 3350.0,
        "f32_tflops": 67.0,       # outside the tensor cores
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "f64_tflops": 34.0,
        "f64_tensor_tflops": 67.0,
    },
}


def device_peaks(kind=None):
    """The peak table row of ``kind`` (default: the first JAX device)."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def gpu_power_limit():
    """``name, power.limit`` of the cards as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def device_stamp():
    """Platform, kind, count and power limit of the devices a row ran on."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "nvidia_smi": gpu_power_limit()}


def _roofline_bw(bytes_moved, seconds):
    """Achieved device-memory bandwidth for a bytes/cell traffic model, as
    (GB/s, % of the device's published peak)."""
    gbps = bytes_moved / seconds / 1e9
    return round(gbps, 1), round(100.0 * gbps / device_peaks()["hbm_gbps"], 1)


def _step_times(step_fn, n_steps=20):
    """Per-step device times: each step ends in ``block_until_ready``
    (compilation must already be warm).  Returns the sorted times."""
    import jax

    ts = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        jax.block_until_ready(step_fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)


def make_fields(H, W, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xa = np.abs(rng.normal(3.0, 1.0, (H, W)))
    y = xa * rng.uniform(0.7, 1.4, (H, W)) + rng.normal(0, 0.3, (H, W))
    sa = (xa * 0.5) ** 2
    so = np.abs(rng.normal(0.4, 0.1, (H, W))) ** 2
    nanmask = rng.random((H, W)) < 0.2
    for f in (xa, y, sa, so):
        f[nanmask] = np.nan
    return (xa.astype(dtype), y.astype(dtype), sa.astype(dtype), so.astype(dtype))


def numpy_reference_oi(xa, y, sa, so):
    """The reference's OI update in float64 NumPy: (xb, AK, increment,
    error, the knee's index into the factor grid)."""
    import sys

    sys.path.insert(0, ".")
    from oisat.ops.knee import kneedle_index_np

    y = np.array(y, np.float64, copy=True)
    xa = xa.astype(np.float64)
    sa = sa.astype(np.float64)
    so = so.astype(np.float64)
    y[y < 0] = 0.0
    regs = np.arange(0.1, 10.0, 0.1)
    curve = np.empty(len(regs))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, r in enumerate(regs):
            k = sa * r / (sa * r + so)
            sb = (1.0 - k) * sa * r
            ak = 1.0 - sb / (sa * r)
            curve[i] = np.nanmean(ak)
        idx = kneedle_index_np(regs, curve, fallback=0)
        r = regs[idx]
        k = sa * r / (sa * r + so)
        sb = (1.0 - k) * sa * r
        ak = 1.0 - sb / (sa * r)
    inc = k * (y - xa)
    return xa + inc, ak, inc, np.sqrt(sb), idx


def _emit(metric, value, unit, vs_baseline, detail):
    detail = dict(detail, device=device_stamp())
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "vs_baseline": vs_baseline, "detail": detail}),
          flush=True)


def main(metric_name="oi_analysis_throughput"):
    H, W = 1440, 2880  # a global 0.125-deg analysis grid, 4.1M cells
    cells = H * W

    # ---- NumPy reference baseline (CPU, float64 like the reference) -------
    fields64 = make_fields(H, W, dtype=np.float64)
    t0 = time.perf_counter()
    ref = numpy_reference_oi(*fields64)
    ref[0].sum()
    t_np = time.perf_counter() - t0

    # ---- device ------------------------------------------------------------
    import jax
    import jax.numpy as jnp

    import sys

    sys.path.insert(0, ".")
    from oisat.ops.oi import oi

    fields32 = tuple(jnp.asarray(f, jnp.float32) for f in make_fields(H, W))
    step = jax.jit(oi)
    out = step(*fields32)
    np.asarray(out.xb)  # compile + settle

    ts = _step_times(lambda: step(*fields32), n_steps=21)
    t_dev = ts[len(ts) // 2]

    # sanity: same knee, fields agree where finite
    xb_t = np.asarray(out.xb, np.float64)
    agree = np.nanmax(np.abs((xb_t - ref[0]) / np.where(np.abs(ref[0]) > 1e-12, ref[0], 1.0)))

    value = cells / t_dev
    vs_baseline = (cells / t_dev) / (cells / t_np)
    # roofline: the whole OI is bandwidth-bound at its floor — each of the
    # 4 input fields must be read >= once and the 4 output fields written
    # once (32 B/cell at f32); the 99-factor curve adds no device-memory
    # traffic when fused (sa/so stay on-chip across factors)
    gbps, pct = _roofline_bw(32 * cells, t_dev)
    _emit(metric_name, value, "grid-cells/sec", vs_baseline, {
        "grid": [H, W],
        "device_ms": t_dev * 1e3,
        "device_ms_min_max": [ts[0] * 1e3, ts[-1] * 1e3],
        "numpy_ms": t_np * 1e3,
        "max_rel_diff_vs_f64_reference": float(agree),
        "roofline": {"model": "32 B/cell minimal device-memory traffic",
                     "achieved_gbps": gbps, "pct_of_hbm_peak": pct},
    })


def bench_kalman(n=8192):
    """Dense full-covariance solve (covariance build + blocked Cholesky +
    column-block posterior diagonal) in TFLOP/s.  FLOP model (documented, matmul-only):
    chol N^3/3 + half-solve diag blocks V=L^-1 B at N^3/2 + B@w 2N^2 +
    covariance build ~8N^2."""
    import jax.numpy as jnp

    from oisat.ops.oi_full import oi_full_dense

    rng = np.random.default_rng(1)
    f = lambda a: jnp.asarray(a, jnp.float32)
    xa = f(np.abs(rng.normal(3, 1, n)))
    y = f(np.abs(rng.normal(3, 1, n)))
    sigb = f(np.abs(rng.normal(1, 0.2, n)))
    sigo = f(np.abs(rng.normal(0.6, 0.1, n)))
    lat = f(rng.uniform(20, 60, n))
    lon = f(rng.uniform(-130, -60, n))
    run = lambda: oi_full_dense(xa, y, sigb, sigo, lat, lon, 300.0)
    np.asarray(run()[0])  # compile
    ts = _step_times(run, n_steps=11)
    t = ts[len(ts) // 2]
    # task-level flops: the standard algorithm (chol N^3/3 + forward/back
    # solve pair per diag block, N^3 each) — the historical row's model,
    # so the number stays comparable across rounds; the implementation
    # does the SAME task with the half-solve trick (V = L^-1 B: ONE
    # triangular solve, N^3 under the same convention), which shows up
    # here as a higher task rate, not a flop-model change
    task_flops = n**3 / 3 + 2 * n**3 + 10 * n**2
    impl_flops = n**3 / 3 + n**3 + 10 * n**2
    tflops = task_flops / t / 1e12
    achieved = impl_flops / t / 1e12
    _emit("kalman_full_solve", tflops, "TFLOP/s", None,
          {"n_cells": n, "ms": t * 1e3,
           "flop_model": "task N^3/3+2N^3+10N^2; impl half-solve N^3/3+N^3",
           "impl_tflops": achieved,
           # the solve runs full f32 (Precision.HIGHEST), so its ceiling is
           # the f32 rate outside the tensor cores
           "roofline": {"pct_of_f32_peak":
                        100 * achieved / device_peaks()["f32_tflops"]}})


def _synthetic_orbit(seed=0, ny=1644, nx=60, nz=35):
    """An OMI-NO2-shaped orbit: 74 interpolated fields (vcd, amf, trop,
    err + 35 SW + 35 pmid levels) over a 1644x60 swath.  The pressure
    stack is hybrid-eta structured (A + B*psurf) like every real product
    (reference reader.py:954-957) — which also exercises the regridder's
    affine carrier-level fast path."""
    from oisat.datamodel import satellite_amf

    rng = np.random.default_rng(seed)
    along = np.linspace(25.0, 55.0, ny)[:, None]
    across = np.linspace(-15.0, 5.0, nx)[None, :]
    lat = along + 0.02 * rng.standard_normal((ny, nx))
    lon = across + 3.0 * np.sin(np.linspace(0, 2.0, ny))[:, None] + 0.02 * rng.standard_normal((ny, nx))
    eta_a = np.linspace(0.0, 100.0, nz)
    eta_b = np.linspace(1.0, 0.02, nz)
    psurf = 1000.0 + 30.0 * rng.standard_normal((ny, nx))
    pm = eta_a[:, None, None] + eta_b[:, None, None] * psurf[None]
    from oisat.readers.sensors.common import attach_pmid_tables

    g = satellite_amf(
        vcd=2.0 + np.sin(lon / 5.0) * np.cos(lat / 7.0),
        amf=np.full((ny, nx), 1.5), time=None, tropopause=np.full((ny, nx), 150.0),
        latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.full((ny, nx), 0.5), quality_flag=np.ones((ny, nx)),
        pressure_mid=pm, scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))),
        ctm_upscaled_needed=False, ctm_vcd=[], ctm_time_at_sat=[],
        old_amf=[], new_amf=[],
    )
    # construction provenance, like the real readers (skips the affine re-fit)
    return attach_pmid_tables(g, eta_a, eta_b)


def bench_regrid(fast: bool, orbits=8):
    """Swath→grid regrid ms/orbit, host weight build +
    fused device apply, parity (qhull builders, full per-level transfer —
    the complete OISAT_PARITY=1 configuration) vs the native fast-swath
    production path (affine carrier + f16 transfers)."""
    import os

    clat = np.arange(20.0, 60.0, 0.25)
    clon = np.arange(-20.0, 10.0, 0.25)
    clon2, clat2 = np.meshgrid(clon, clat)

    from oisat.regridder import regrid_granule

    prev = os.environ.get("OISAT_PARITY")
    os.environ["OISAT_PARITY"] = "0" if fast else "1"
    out = None
    try:
        # 0.25 deg: the OMI NO2 recipe this orbit mimics (reference
        # reader.py:899-901); the fine grid is ~19k targets
        regrid_granule(1, 0.25, _synthetic_orbit(0), clon2, clat2,
                       flag_thresh=0.0, fast_swath=fast)  # compile + warm caches
        t0 = time.perf_counter()
        for s in range(orbits):
            out = regrid_granule(1, 0.25, _synthetic_orbit(s + 1), clon2, clat2,
                                 flag_thresh=0.0, fast_swath=fast)
        t = (time.perf_counter() - t0) / orbits
    finally:
        if prev is None:
            os.environ.pop("OISAT_PARITY", None)
        else:
            os.environ["OISAT_PARITY"] = prev
    assert out is not None
    _emit(f"regrid_orbit_{'fast' if fast else 'parity'}", round(t * 1e3, 1),
          "ms/orbit", None,
          {"fields": 74, "swath": [1644, 60], "grid_deg": 0.25, "orbits": orbits})
    return t


def bench_regrid_pipelined(orbits=8):
    """The PRODUCTION regrid path: orbits dispatched through
    readers.sensors.common.fleet_map, which pipelines 2-deep (granule k+1's
    host build overlaps granule k's device transfer/collect).  Effective
    s/orbit should drop below the sequential fast row when the host build
    and the transfer are of similar size."""
    clat = np.arange(20.0, 60.0, 0.25)
    clon = np.arange(-20.0, 10.0, 0.25)
    clon2, clat2 = np.meshgrid(clon, clat)

    from oisat.readers.sensors.common import fleet_map
    from oisat.regridder import regrid_granule

    reader = lambda s: regrid_granule(1, 0.25, _synthetic_orbit(s), clon2, clat2,
                                      flag_thresh=0.0, fast_swath=True)
    reader(0)  # compile + warm caches
    t0 = time.perf_counter()
    outs = fleet_map(reader, list(range(1, orbits + 1)), 1, "bench")
    t = (time.perf_counter() - t0) / orbits
    assert all(o is not None for o in outs)
    _emit("regrid_orbit_fast_pipelined", round(t * 1e3, 1), "ms/orbit", None,
          {"fields": 74, "swath": [1644, 60], "grid_deg": 0.25,
           "orbits": orbits, "pipeline": "fleet_map 2-deep"})
    return t


def bench_matfree(n_cells=64800):
    """64k-cell matrix-free full-covariance OI: one CG
    solve + colored-probing posterior diagonal on a 1-deg global grid."""
    from oisat.ops.oi_full import oi_full_matfree

    H, W = 180, n_cells // 180
    rng = np.random.default_rng(0)
    lon, lat = np.meshgrid(np.linspace(-179.5, 179.5, W), np.linspace(-89.5, 89.5, H))
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = xa * rng.uniform(0.8, 1.3, (H, W))
    sigb = np.abs(rng.normal(1.0, 0.2, (H, W)))
    sigo = np.abs(rng.normal(0.6, 0.1, (H, W)))
    args = (xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(),
            lat.ravel(), lon.ravel(), 300.0)
    _ = oi_full_matfree(*args, block=2048)  # compile
    t0 = time.perf_counter()
    xb, ak, inc, err, info = oi_full_matfree(*args, block=2048)
    t = time.perf_counter() - t0
    _emit("oi_full_matfree_64k", round(t, 2), "s", None,
          {"cells": H * W, **info})


def _eta_pmid(nz, hw, rng):
    """A hybrid-eta CTM pressure stack (A + B*psurf), like every real CTM
    backend (GMI PL, ECCOH, the OMI/OMPS eta tables) — random-sorted
    pressures would keep the production carrier-compression paths idle in
    the benchmark and misrepresent real-month transfer volumes.  Workload
    changed round 4 session 3; rows since stamp `ctm: eta`."""
    eta_a = np.concatenate([[0.0], np.linspace(40.0, 600.0, nz - 1)])
    eta_b = np.concatenate([[1.0], np.linspace(0.9, 0.01, nz - 1)])
    ps = 1000.0 + 30.0 * rng.standard_normal(hw)
    return eta_a[:, None, None] + eta_b[:, None, None] * ps[None]


def bench_month(orbits=60, fused=False, oi_method="scalar"):
    """Synthetic-month steady state: regrid + AMF recal +
    averaging + OI for `orbits` orbits.  vs_baseline = the reference's 12 h
    month budget over the measured wall time.  ``fused=True`` runs the
    analysis as ONE device program (driver.analyze_month_fused) instead of
    the staged pipeline.  ``oi_method="full"`` is the production-path
    full-covariance month (`oi_method: full` in control.yml): the fused
    averages feed the blocked-Cholesky Kalman solve of ops/oi_full —
    a capability month, not just a solver microbenchmark."""
    import datetime
    from types import SimpleNamespace

    import jax.numpy as jnp

    from oisat.driver import oisatgmi
    from oisat.obs_operators import amf_recal
    from oisat.ops.vertical import partial_column
    from oisat.regridder import regrid_granule

    clat = np.arange(20.0, 60.0, 0.25)
    clon = np.arange(-20.0, 10.0, 0.25)
    clon2, clat2 = np.meshgrid(clon, clat)
    nz = 20
    hw = clat2.shape

    def run_once():
        from oisat.readers.sensors.common import fleet_map

        t_start = time.perf_counter()

        def one(s):
            g = _synthetic_orbit(s, ny=822, nx=60)  # half orbits: 30-day pace
            # fused: regrid leaves the granule on device (the production
            # fused_month configuration — no D2H/H2D round trip)
            return regrid_granule(1, 0.25, g, clon2, clat2, flag_thresh=0.0,
                                  device=fused)

        # the production path: fleet_map's single-threaded submit/collect
        # double-buffer (device computes orbit k while the host builds k+1)
        outs = fleet_map(one, list(range(orbits)), 1, "bench-month")
        grans = []
        for s, g in enumerate(outs):
            if g is not None:
                g.time = datetime.datetime(2019, 7, 1 + (s % 28), 12)
                grans.append(g)
        t_regrid = time.perf_counter()
        rng = np.random.default_rng(0)
        ctm = SimpleNamespace(
            ctmtype="FREE", averaged=True, latitude=clat2, longitude=clon2,
            time=[datetime.datetime(2019, 7, 15, h) for h in range(0, 24, 3)],
            pressure_mid=_eta_pmid(nz, hw, rng), delta_p=np.full((nz,) + hw, 40.0),
            gas_profile=np.abs(rng.normal(2, 0.5, (nz,) + hw)),
        )
        if fused:
            obj = oisatgmi()
            obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
            obj.analyze_month_fused("OMI", "NO2", "2019-07-01", "2019-08-01",
                                    oi_method=oi_method)
            t_amf = time.perf_counter()
        else:
            amf_recal([ctm], grans)
            t_amf = time.perf_counter()
            obj = oisatgmi()
            obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=grans)
            obj.average("2019-07-01", "2019-08-01")
            obj.bias_correct("OMI", "NO2")
            obj.oi("OMI")
        np.asarray(obj.ctm_averaged_vcd_corrected)
        t_end = time.perf_counter()
        return t_end - t_start, t_regrid - t_start, t_amf - t_regrid

    cold, *_ = run_once()
    steady, t_re, t_amf = run_once()
    name = "synthetic_month_fused" if fused else "synthetic_month_steady"
    if oi_method == "full":
        name = "synthetic_month_fused_oifull"
    _emit(name, round(steady, 1), "s", round(43200.0 / steady, 0),
          {"orbits": orbits, "cold_s": round(cold, 1),
           "regrid_s": round(t_re, 1),
           ("analysis_s" if fused else "amf_s"): round(t_amf, 1),
           "oi_method": oi_method, "ctm": "eta",
           "reference_budget_s": 43200})


def bench_year(orbits=60):
    """A full synthetic campaign year — 12 months x all FOUR granule kinds (OMI-like
    AMF sensor with the real swath regrid, MOPITT CO AK-convolution, GOSAT
    XCH4, SSMIS PWV) — in ONE process.  Months 2..12 reuse month 1's
    compiled programs: this in-process sweep replaces the reference's 48
    independent cluster jobs (4 sensors x 12 months, 12 h/month budget —
    reference run/job_submitter_sbatch.py:45-68).  Emits ONE JSON row:
    total wall seconds, with per-kind month medians and the month-1
    (compile) vs steady-month split."""
    import datetime
    from types import SimpleNamespace

    from oisat.datamodel import satellite_opt, satellite_ssmis
    from oisat.driver import oisatgmi
    from oisat.regridder import regrid_granule

    clat = np.arange(20.0, 60.0, 0.25)
    clon = np.arange(-20.0, 10.0, 0.25)
    clon2, clat2 = np.meshgrid(clon, clat)
    hw = clat2.shape
    nz, ls = 20, 9
    rng = np.random.default_rng(0)
    pm3 = _eta_pmid(nz, hw, rng)

    def ctm(month):
        return SimpleNamespace(
            ctmtype="FREE", averaged=True, latitude=clat2, longitude=clon2,
            time=[datetime.datetime(2019, month, 15, h) for h in range(0, 24, 3)],
            pressure_mid=pm3, delta_p=np.full((nz,) + hw, 40.0),
            gas_profile=np.abs(rng.normal(2, 0.5, (nz,) + hw)))

    def omi_month(month):
        from oisat.readers.sensors.common import fleet_map

        def one(s):
            g = _synthetic_orbit(s + 100 * month, ny=822, nx=60)
            # device granules: the fused month stacks them in place
            return regrid_granule(1, 0.25, g, clon2, clat2, flag_thresh=0.0,
                                  device=True)

        # the production fleet_map submit/collect pipeline
        outs = fleet_map(one, list(range(orbits)), 1, "bench-year")
        grans = []
        for s, g in enumerate(outs):
            if g is not None:
                g.time = datetime.datetime(2019, month, 1 + (s % 28), 12)
                grans.append(g)
        return grans

    def mopitt_month(month, G=28):
        r = np.random.default_rng(1000 + month)
        f32 = "float32"

        def gran(day):
            vcd = np.abs(r.normal(2, 0.5, hw))
            vcd[r.random(hw) < 0.2] = np.nan
            return satellite_opt(
                vcd=vcd.astype(f32), time=datetime.datetime(2019, month, 1 + day, 12),
                tropopause=np.empty((1,)), latitude_center=clat2, longitude_center=clon2,
                uncertainty=np.abs(r.normal(0.3, 0.05, hw)).astype(f32), quality_flag=[],
                pressure_mid=np.sort(r.uniform(100, 900, (ls,) + hw), axis=0)[::-1].copy().astype(f32),
                averaging_kernels=r.uniform(0, 0.5, (ls + 1,) + hw).astype(f32),
                aprior_column=np.abs(r.normal(2, 0.3, hw)).astype(f32),
                apriori_profile=np.abs(r.normal(80, 15, (ls,) + hw)).astype(f32),
                surface_pressure=np.full(hw, 1000.0, f32),
                apriori_surface=np.abs(r.normal(90, 10, hw)).astype(f32),
                x_col=np.abs(r.normal(0.1, 0.02, hw)).astype(f32),
                pressure_weight=[], sensor="MOPITT", ctm_upscaled_needed=False)

        return [gran(d) for d in range(G)]

    def gosat_month(month, G=28):
        r = np.random.default_rng(2000 + month)
        f32 = "float32"

        def gran(day):
            x_col = np.abs(r.normal(1.8, 0.1, hw))
            x_col[r.random(hw) < 0.3] = np.nan
            return satellite_opt(
                vcd=np.abs(r.normal(2, 0.5, hw)).astype(f32),
                time=datetime.datetime(2019, month, 1 + day, 12),
                tropopause=np.empty((1,)), latitude_center=clat2, longitude_center=clon2,
                uncertainty=np.abs(r.normal(0.05, 0.01, hw)).astype(f32), quality_flag=[],
                pressure_mid=np.sort(r.uniform(100, 900, (ls,) + hw), axis=0)[::-1].copy().astype(f32),
                averaging_kernels=r.uniform(0.2, 1.0, (ls,) + hw).astype(f32),
                aprior_column=np.zeros(hw, f32),
                apriori_profile=np.abs(r.normal(1.7, 0.1, (ls,) + hw)).astype(f32),
                surface_pressure=np.zeros(hw, f32), apriori_surface=np.zeros(hw, f32),
                x_col=x_col.astype(f32),
                pressure_weight=np.full((ls,) + hw, 1.0 / ls, f32),
                sensor="GOSAT", ctm_upscaled_needed=False)

        return [gran(d) for d in range(G)]

    def ssmis_month(month, G=28):
        r = np.random.default_rng(3000 + month)

        def gran(day):
            vcd = np.abs(r.normal(20, 5, hw))
            vcd[r.random(hw) < 0.2] = np.nan
            return satellite_ssmis(
                vcd=vcd.astype("float32"),
                uncertainty=np.abs(r.normal(1.0, 0.2, hw)).astype("float32"),
                time=datetime.datetime(2019, month, 1 + day, 12),
                latitude_center=clat2, longitude_center=clon2,
                ctm_upscaled_needed=False, ctm_vcd=[], sensor="SSMIS")

        return [gran(d) for d in range(G)]

    plan = [("OMI", "NO2", omi_month), ("MOPITT", "CO", mopitt_month),
            ("GOSAT", "CH4", gosat_month), ("SSMIS", "PWV", ssmis_month)]
    month_times = {sensor: [] for sensor, *_ in plan}
    from oisat.utils.compile_census import CompileCensus

    t_year0 = time.perf_counter()
    with CompileCensus(capture_names=True) as census:
        for month in range(1, 13):
            c = [ctm(month)]
            end = f"2019-{month + 1:02}-01" if month < 12 else "2020-01-01"
            for sensor, gas, maker in plan:
                census.phase(f"m{month:02}-{sensor}")
                t0 = time.perf_counter()
                grans = maker(month)
                obj = oisatgmi()
                obj.reader_obj = SimpleNamespace(ctm_data=c, sat_data=grans)
                obj.analyze_month_fused(sensor, gas, f"2019-{month:02}-01", end)
                np.asarray(obj.ctm_averaged_vcd_corrected)
                month_times[sensor].append(time.perf_counter() - t0)
    total = time.perf_counter() - t_year0
    med = {k: round(sorted(v)[len(v) // 2], 2) for k, v in month_times.items()}
    first = round(sum(v[0] for v in month_times.values()), 1)
    steady = round(sum(med.values()), 2)
    # reference budget: 4 sensors x 12 months x 12 h cluster jobs
    _emit("full_year_all_sensor", round(total, 1), "s",
          round(48 * 43200.0 / total, 0),
          {"months": 12, "kinds": 4, "omi_orbits_per_month": orbits,
           "median_month_s_per_kind": med,
           "first_month_all_kinds_s": first,
           "steady_month_all_kinds_s": steady,
           "compile_amortization_x": round(first / max(steady, 1e-9), 2),
           "ctm": "eta",
           "reference_budget_s": 48 * 43200,
           "compile_census": census.report()})


def bench_oi_bandwidth(H=6144, W=12288):
    """A bandwidth-regime OI headline variant: at 4.1M cells the OI step
    is a few launches' worth of work, so its share of the memory peak says
    little about the kernel.  At 75M cells the minimal device-memory
    traffic (32 B/cell = 2.4 GB) is large enough that pct_of_hbm_peak
    measures the fused update against the card.  Fields are generated ON
    DEVICE from a seed (an array that is a pure function of seed + shape
    is never shipped from the host)."""
    import jax
    import jax.numpy as jnp

    import sys

    sys.path.insert(0, ".")
    from oisat.ops.oi import oi

    cells = H * W

    @jax.jit
    def make_dev(key):
        ka, ky, ks, ko = jax.random.split(key, 4)
        xa = jnp.abs(3.0 + jax.random.normal(ka, (H, W), jnp.float32))
        y = xa * jax.random.uniform(ky, (H, W), jnp.float32, 0.8, 1.3)
        sa = (xa * 0.5) ** 2
        so = jnp.abs(0.8 + 0.2 * jax.random.normal(ko, (H, W), jnp.float32)) ** 2
        return xa, y, sa, so

    fields = jax.block_until_ready(make_dev(jax.random.key(0)))
    # regularization OFF: the pure Kalman update genuinely moves ~32 B/cell
    # (one read of each input, one write of each output); the 99-factor
    # curve scan would re-stream sa/so from device memory per factor at
    # this size, making the traffic model — and hence pct_of_hbm_peak —
    # wrong by ~50x
    step = jax.jit(lambda a, b, c, d: oi(a, b, c, d,
                                         regularization_on=False))
    jax.block_until_ready(step(*fields))  # compile + settle

    ts = _step_times(lambda: step(*fields), n_steps=21)
    t_dev = ts[len(ts) // 2]
    gbps, pct = _roofline_bw(32 * cells, t_dev)
    _emit("oi_analysis_throughput_bw", cells / t_dev,
          "grid-cells/sec", None, {
              "grid": [H, W], "cells": cells,
              "device_ms": t_dev * 1e3,
              "device_ms_min_max": [ts[0] * 1e3, ts[-1] * 1e3],
              "roofline": {"model": "32 B/cell minimal device-memory traffic",
                           "achieved_gbps": gbps, "pct_of_hbm_peak": pct},
              "note": "regularization off (pure Kalman update; the "
                      "99-factor scan would re-stream inputs per factor "
                      "at this size, breaking the 32 B/cell model); "
                      "fields generated on device"})


# ---- job-level sensor-family rows ------------------------------------------
# Synthetic L2/CTM product FILES in the real formats, so the rows run the
# ACTUAL readers (TROPOMI trop-index gather + SW = AK * AMF; TEMPO eta
# tables + hour-filtered glob) and the real run/job.py path — not
# pre-built granule objects like bench_year's kinds.


def _write_bench_gmi_pair(met_path, gas_path, yyyymm, day, nt=8, nz=20,
                          nlat=160, nlon=120, gas="NO2"):
    """MERRA2-GMI file pair in the layout the GMI reader consumes
    (hybrid-eta PL so the carrier compression engages)."""
    import h5py

    minutes = np.arange(nt) * 180.0 + 90.0
    with h5py.File(met_path, "w") as f:
        f["lon"] = np.linspace(-20.0, 9.75, nlon)
        f["lat"] = np.linspace(20.0, 59.75, nlat)
        t = f.create_dataset("time", data=minutes)
        t.attrs["begin_date"] = np.int32(yyyymm * 100 + day)
        t.attrs["begin_time"] = np.int32(0)
        f["DELP"] = np.full((nt, nz, nlat, nlon), 4000.0, np.float32)
        eta_a = np.linspace(10000.0, 0.0, nz)
        eta_b = np.linspace(0.0, 0.9, nz)
        ps = 100000.0 + 3000.0 * np.random.default_rng(day).standard_normal(
            (nt, 1, nlat, nlon))
        f["PL"] = (eta_a[None, :, None, None]
                   + eta_b[None, :, None, None] * ps).astype(np.float32)
    with h5py.File(gas_path, "w") as f:
        f[gas] = np.full((nt, nz, nlat, nlon), 2e-9, np.float32)


def _write_bench_tempo(path, hour, ny=360, nx=240, nl=26, seed=0):
    """One TEMPO L2 NO2 granule file (geolocation/product/support_data
    layout with Eta_A/Eta_B surface-pressure attrs)."""
    import datetime as _dt

    import h5py

    r = np.random.default_rng(seed)
    lat = np.linspace(24.0, 44.0, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-18.0, 6.0, nx)[None, :]
    with h5py.File(path, "w") as f:
        g = f.create_group("geolocation")
        g["time"] = np.full(ny, (_dt.datetime(2023, 9, 5, hour)
                                 - _dt.datetime(1980, 1, 6)).total_seconds())
        g["latitude"] = lat
        g["longitude"] = lon
        p = f.create_group("product")
        p["vertical_column_troposphere"] = np.abs(
            r.normal(4.0e15, 1e15, (ny, nx))).astype(np.float32)
        p["vertical_column_troposphere_uncertainty"] = np.full(
            (ny, nx), 1.0e15, np.float32)
        p["main_data_quality_flag"] = np.zeros((ny, nx), np.float32)
        s = f.create_group("support_data")
        s["amf_troposphere"] = np.full((ny, nx), 1.8, np.float32)
        s["eff_cloud_fraction"] = np.full((ny, nx), 0.05, np.float32)
        ps = s.create_dataset(
            "surface_pressure", data=np.full((ny, nx), 1000.0, np.float32))
        ps.attrs["Eta_A"] = np.linspace(0, 1, nl + 1)
        ps.attrs["Eta_B"] = np.linspace(1, 0, nl + 1)
        s["scattering_weights"] = np.abs(
            r.normal(1.0, 0.2, (nl, ny, nx))).astype(np.float32)
        s["tropopause_pressure"] = np.full((ny, nx), 140.0, np.float32)


def _write_bench_tropomi(path, day, ny=600, nx=300, nl=34, seed=0, month=7):
    """One TROPOMI L2 NO2 orbit file (PRODUCT group layout: tm5 a/b
    tables, per-pixel averaging_kernel, tm5_tropopause_layer_index — the
    reader's trop-index gather + SW = AK * AMF path)."""
    import datetime as _dt

    import h5py

    r = np.random.default_rng(seed)
    lat = np.linspace(21.0, 59.0, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-19.0, 9.0, nx)[None, :]
    with h5py.File(path, "w") as f:
        p = f.create_group("PRODUCT")
        p["time"] = np.array([(_dt.datetime(2019, month, day)
                               - _dt.datetime(2010, 1, 1)).total_seconds()])
        p["delta_time"] = np.full(ny, 3_600_000.0)
        p["latitude"] = lat
        p["longitude"] = lon
        p["air_mass_factor_total"] = np.full((ny, nx), 2.2, np.float32)
        p["nitrogendioxide_tropospheric_column"] = np.abs(
            r.normal(8e-5, 2e-5, (ny, nx))).astype(np.float32)
        p["air_mass_factor_troposphere"] = np.full((ny, nx), 1.9, np.float32)
        p["nitrogendioxide_tropospheric_column_precision"] = np.full(
            (ny, nx), 2e-5, np.float32)
        p["qa_value"] = np.full((ny, nx), 0.9, np.float32)
        p["tm5_constant_a"] = np.column_stack(
            [np.linspace(0, 1, nl), np.linspace(1, 2, nl)])
        p["tm5_constant_b"] = np.column_stack(
            [np.linspace(1, 0, nl), np.linspace(0.9, 0, nl)])
        p["averaging_kernel"] = np.abs(
            r.normal(1.0, 0.2, (ny, nx, nl))).astype(np.float32)
        p["tm5_tropopause_layer_index"] = np.full((ny, nx), 20, np.int32)
        sd = p.create_group("SUPPORT_DATA")
        sd.create_group("INPUT_DATA")["surface_pressure"] = np.full(
            (ny, nx), 101325.0, np.float32)
        sd.create_group("DETAILED_RESULTS")


def _bench_job_ctrl(tmp, sensor, yyyymm):
    return {
        "python_bin": "python3", "debug": False, "save_daily": False,
        "num_job": 1, "ctm_name": "GMI", "ctm_dir": str(tmp / "ctm"),
        "mcip_dir": str(tmp), "ctm_freq": "3-hourly", "ctm_avg": True,
        "ctm_error": 50.0, "gas": "NO2", "sensor": sensor, "read_AK": True,
        "troposphere_only": True, "sat_dir": str(tmp / "sat"),
        "start_date": f"{yyyymm // 100}-{yyyymm % 100:02}",
        "end_date": f"{yyyymm // 100}-{yyyymm % 100:02}",
        "output_pdf_dir": str(tmp / "report"),
        "output_nc_dir": str(tmp / "diag"), "fused_month": True,
    }


def bench_tempo(days=3):
    """A TEMPO month through run/job.py's REAL 24-hour loop: each UTC hour is its own fused sub-month (hour-filtered
    glob -> reader -> fused analysis -> report + nc), and the compile
    census must show hours 2..24 compiling ZERO new programs (all hours
    share shapes, so the _STEP_JIT_CACHE/jit caches carry across the
    loop)."""
    import shutil
    import sys
    import tempfile
    from pathlib import Path

    sys.path.insert(0, ".")
    sys.path.insert(0, "./run")
    from job import run_month

    from oisat.utils.compile_census import CompileCensus

    tmp = Path(tempfile.mkdtemp(prefix="bench_tempo_"))
    try:
        (tmp / "ctm").mkdir()
        (tmp / "sat").mkdir()
        for d in range(1, days + 1):
            _write_bench_gmi_pair(
                tmp / "ctm" / f"MERRA2_GMI.tavg3_3d_met_Nv.202309{d:02}.nc4",
                tmp / "ctm" / f"MERRA2_GMI.tavg3_3d_tac_Nv.202309{d:02}.nc4",
                202309, d)
            for hour in range(24):
                _write_bench_tempo(
                    tmp / "sat" / f"TEMPO_NO2_L2_202309{d:02}T{hour:02d}0000.nc",
                    hour, seed=d * 100 + hour)
        ctrl = _bench_job_ctrl(tmp, "TEMPO", 202309)
        t0 = time.perf_counter()
        with CompileCensus(capture_names=True) as census:
            run_month(ctrl, 2023, 9,
                      on_hour=lambda h: census.phase(f"h{h:02}"))
        total = time.perf_counter() - t0
        import glob as _glob

        n_nc = len(_glob.glob(str(tmp / "diag" / "*.nc")))
        rep = census.report()
        # the jit-cache claim, made checkable: hours after the first that
        # compiled ANY program (must be 0 — all 24 hours share shapes)
        late = [ph for ph, d in rep["by_phase"].items()
                if ph.startswith("h") and ph != "h00" and d["compiles"] > 0]
        _emit("tempo_month_24h", round(total, 1), "s",
              round(43200.0 / total, 0), {
                  "days": days, "hours": 24, "diag_files": n_nc,
                  "hours_compiling_after_first": late,
                  "compile_census": rep,
                  "reference_budget_s": 43200})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_tropomi(orbits=8):
    """A TROPOMI-shaped month through run/job.py: the
    real reader path (trop-index gather over the tm5 layer index,
    SW = AK * AMF_total, eta pressure tables) feeding the fused month."""
    import shutil
    import sys
    import tempfile
    from pathlib import Path

    sys.path.insert(0, ".")
    sys.path.insert(0, "./run")
    from job import run_month

    tmp = Path(tempfile.mkdtemp(prefix="bench_tropomi_"))
    try:
        (tmp / "ctm").mkdir()
        (tmp / "sat").mkdir()
        _write_bench_gmi_pair(
            tmp / "ctm" / "MERRA2_GMI.tavg3_3d_met_Nv.20190715.nc4",
            tmp / "ctm" / "MERRA2_GMI.tavg3_3d_tac_Nv.20190715.nc4",
            201907, 15)
        for k in range(orbits):
            _write_bench_tropomi(
                tmp / "sat" / f"S5P_OFFL_L2__NO2____201907{1 + k:02}.nc",
                1 + k, seed=k)
        ctrl = _bench_job_ctrl(tmp, "TROPOMI", 201907)
        t0 = time.perf_counter()
        run_month(ctrl, 2019, 7)
        total = time.perf_counter() - t0
        _emit("tropomi_month", round(total, 1), "s",
              round(43200.0 / total, 0), {
                  "orbits": orbits,
                  "reference_budget_s": 43200})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_campaign_prefetch(months=3, orbits=6, repeats=3):
    """Measures the campaign prefetch overlap: the
    SAME multi-month TROPOMI campaign through run/campaign.py with
    prefetch off vs on, after a warmup sweep that absorbs every compile.
    The prefetch thread starts month k+1's read_data (file IO + regrid
    dispatches + H2D submits) during month k's report/nc tail.

    A ~2% effect cannot be told from run-to-run noise with one off/on
    pair — the sweeps ALTERNATE off/on ``repeats`` times and the row
    reports the median per-pair ratio."""
    import shutil
    import sys
    import tempfile
    from pathlib import Path

    sys.path.insert(0, ".")
    sys.path.insert(0, "./run")
    import campaign as camp

    assert months <= 6, "hardcoded July start cannot cross the year end"
    tmp = Path(tempfile.mkdtemp(prefix="bench_campaign_"))
    try:
        (tmp / "ctm").mkdir()
        (tmp / "sat").mkdir()
        for m in range(7, 7 + months):
            _write_bench_gmi_pair(
                tmp / "ctm" / f"MERRA2_GMI.tavg3_3d_met_Nv.2019{m:02}15.nc4",
                tmp / "ctm" / f"MERRA2_GMI.tavg3_3d_tac_Nv.2019{m:02}15.nc4",
                201900 + m, 15)
            for k in range(orbits):
                _write_bench_tropomi(
                    tmp / "sat" / f"S5P_OFFL_L2__NO2____2019{m:02}{1 + k:02}.nc",
                    1 + k, seed=100 * m + k, month=m)
        ctrl = _bench_job_ctrl(tmp, "TROPOMI", 201907)
        ctrl["start_date"] = "2019-07"
        ctrl["end_date"] = f"2019-{6 + months:02}"
        camp.run_campaign(dict(ctrl), prefetch=False)  # warmup: compiles

        def sweep(prefetch):
            t0 = time.perf_counter()
            failed = camp.run_campaign(dict(ctrl), prefetch=prefetch)
            dt = time.perf_counter() - t0
            assert not failed
            return dt

        pairs = []
        for _ in range(repeats):
            off_s = sweep(False)
            on_s = sweep(True)
            pairs.append({"off_s": off_s, "on_s": on_s,
                          "ratio": off_s / on_s})
        ratios = sorted(p["ratio"] for p in pairs)
        _emit("campaign_prefetch", ratios[len(ratios) // 2], "x", None, {
            "months": months, "orbits_per_month": orbits,
            "pairs": pairs})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_all():
    main()
    bench_kalman(2048)
    bench_kalman(8192)
    t_parity = bench_regrid(fast=False)
    t_fast = bench_regrid(fast=True)
    _emit("regrid_fast_speedup", round(t_parity / t_fast, 2), "x", None, {})
    bench_regrid_pipelined()
    bench_matfree()
    bench_month()
    bench_month(fused=True)
    bench_month(fused=True, oi_method="full")
    bench_oi_bandwidth()
    bench_tempo()
    bench_tropomi()
    bench_campaign_prefetch()


if __name__ == "__main__":
    import sys

    sys.path.insert(0, ".")
    from oisat.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if "--all" in sys.argv:
        run_all()
    elif "--month-full" in sys.argv:
        bench_month(fused=True, oi_method="full")
    elif "--month-fused" in sys.argv:
        bench_month(fused=True)
    elif "--month" in sys.argv:
        bench_month()
    elif "--matfree" in sys.argv:
        bench_matfree()
    elif "--year" in sys.argv:
        bench_year()
    elif "--oi-bw" in sys.argv:
        bench_oi_bandwidth()
    elif "--tempo" in sys.argv:
        bench_tempo()
    elif "--tropomi" in sys.argv:
        bench_tropomi()
    elif "--campaign" in sys.argv:
        bench_campaign_prefetch()
    else:
        main()
