import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oisat.parallel import make_mesh
from oisat.parallel.analysis import (
    AnalysisInputs,
    analysis_step,
    full_month_step,
    make_analysis_step,
    make_full_month_step,
)


def synth_inputs(G=4, H=16, W=24, seed=0):
    rng = np.random.default_rng(seed)
    def f():
        x = rng.normal(3, 1, (G, H, W))
        x[rng.random((G, H, W)) < 0.15] = np.nan
        return jnp.asarray(np.abs(x))
    return AnalysisInputs(vcd=f(), uncertainty=f(), ctm_vcd=f(), aux1=f(), aux2=f())


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_analysis_matches_single_device():
    inputs = synth_inputs()
    ref = analysis_step(inputs, bias_offset=0.3, bias_slope=0.7)
    mesh = make_mesh(8)
    fn, shard = make_analysis_step(mesh, bias_offset=0.3, bias_slope=0.7)
    got = fn(shard(inputs))
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(got.oi.curve), np.asarray(ref.oi.curve), rtol=1e-12)
    assert int(got.oi.reg_index) == int(ref.oi.reg_index)
    np.testing.assert_allclose(np.asarray(got.scaling_factor), np.asarray(ref.scaling_factor), rtol=1e-12)


def test_full_month_step_sharded():
    import __graft_entry__ as ge

    inputs = ge._synthetic_full_month(G=4, H=16, W=24)
    ref = full_month_step(inputs)
    mesh = make_mesh(8)
    fn, shard = make_full_month_step(mesh)
    got = fn(shard(inputs))
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb), rtol=1e-5, atol=1e-6)
    assert int(got.oi.reg_index) == int(ref.oi.reg_index)


def test_dryrun_entrypoints():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.asarray(out.oi.xb).shape == args[0].vcd.shape[1:]


@pytest.mark.parametrize("step", ["analysis", "full_month"])
def test_sharded_month_step_curve_matches_ak_curve(step):
    """The mean-AK curve of a month step sharded over the 8-device mesh
    (grid rows split; jit turns the per-factor sums into cross-device
    sums) equals the single-device ak_curve on the same Sa/So, and picks
    the same knee."""
    import __graft_entry__ as ge
    from oisat.ops.knee import kneedle_index_np
    from oisat.ops.oi import ak_curve, regularization_grid

    mesh = make_mesh(8)
    if step == "analysis":
        fn, shard = make_analysis_step(mesh, bias_offset=0.1, bias_slope=0.9)
        got = fn(shard(synth_inputs(G=4, H=16, W=24, seed=7)))
        rtol = 1e-12
    else:
        fn, shard = make_full_month_step(mesh)
        got = fn(shard(ge._synthetic_full_month(G=4, H=16, W=24)))
        rtol = 2e-6
    xa = np.asarray(got.ctm_vcd)
    sa = (xa * 50.0 / 100.0) ** 2
    so = np.asarray(got.sat_error) ** 2
    regs = regularization_grid()
    ref = np.asarray(ak_curve(jnp.asarray(sa), jnp.asarray(so),
                              jnp.asarray(regs, xa.dtype)))
    np.testing.assert_allclose(np.asarray(got.oi.curve), ref, rtol=rtol)
    assert int(got.oi.reg_index) == kneedle_index_np(regs, ref, fallback=0)


def test_mopitt_month_step_sharded_matches_single_device():
    """The opt-sensor (AK conv -> xcol-pair aux) sharded month step must
    reproduce the unsharded computation (VERDICT r1 item 3)."""
    import __graft_entry__ as ge
    from oisat.parallel.analysis import (
        make_mopitt_month_step,
        mopitt_month_step,
    )

    inputs = ge._synthetic_mopitt_month(G=4, H=16, W=24)
    ref = mopitt_month_step(inputs)
    mesh = make_mesh(8)
    fn, shard = make_mopitt_month_step(mesh)
    got = fn(shard(inputs))
    assert int(got.oi.reg_index) == int(ref.oi.reg_index)
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb),
                               rtol=1e-5, atol=1e-7, equal_nan=True)
    np.testing.assert_allclose(np.asarray(got.aux2), np.asarray(ref.aux2),
                               rtol=1e-5, atol=1e-8, equal_nan=True)


def test_gosat_month_step_sharded_matches_single_device():
    from oisat.parallel.analysis import (
        GosatMonthInputs,
        gosat_month_step,
        make_gosat_month_step,
    )

    rng = np.random.default_rng(3)
    G, Ls, Lc, H, W = 4, 6, 12, 16, 24
    f32 = np.float32
    vcd = np.abs(rng.normal(1800, 30, (G, H, W))).astype(f32)
    vcd[rng.random((G, H, W)) < 0.1] = np.nan
    inputs = GosatMonthInputs(
        ctm_pmid=np.sort(rng.uniform(60, 1000, (G, Lc, H, W)), axis=1)[:, ::-1].astype(f32),
        ctm_profile=np.abs(rng.normal(1800, 50, (G, Lc, H, W))).astype(f32),
        sat_pmid=np.sort(rng.uniform(100, 950, (G, Ls, H, W)), axis=1)[:, ::-1].astype(f32),
        aks=rng.uniform(0.2, 1.0, (G, Ls, H, W)).astype(f32),
        apriori_profile=np.abs(rng.normal(1750, 50, (G, Ls, H, W))).astype(f32),
        pressure_weight=np.full((G, Ls, H, W), 1.0 / Ls, f32),
        vcd=vcd,
        x_col=np.abs(rng.normal(1800, 30, (G, H, W))).astype(f32),
        uncertainty=np.abs(rng.normal(10, 2, (G, H, W))).astype(f32),
    )
    ref = gosat_month_step(inputs)
    mesh = make_mesh(8)
    fn, shard = make_gosat_month_step(mesh)
    got = fn(shard(inputs))
    assert int(got.oi.reg_index) == int(ref.oi.reg_index)
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb),
                               rtol=1e-5, atol=1e-4, equal_nan=True)
    # GOSAT: model VCD intentionally all-NaN (reference ak_conv_gosat.py:138)
    assert np.isnan(np.asarray(got.ctm_vcd)).all()


def test_ssmis_month_step_sharded_matches_single_device():
    import __graft_entry__ as ge
    from oisat.parallel.analysis import (
        make_ssmis_month_step,
        ssmis_month_step,
    )

    inputs = ge._synthetic_ssmis_month(G=4, H=16, W=24)
    ref = ssmis_month_step(inputs)
    mesh = make_mesh(8)
    fn, shard = make_ssmis_month_step(mesh)
    got = fn(shard(inputs))
    assert int(got.oi.reg_index) == int(ref.oi.reg_index)
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb),
                               rtol=1e-5, atol=1e-6, equal_nan=True)


def test_month_step_pads_non_divisible_shapes():
    """A real month has an arbitrary granule count and odd grid heights;
    shard_inputs must NaN-pad (G, H) up to mesh-divisible shapes and the
    step must crop back — numerics identical to the unsharded step
    (padded NaN granules/rows are invisible to the nanmean statistics and
    the masked mean-AK curve)."""
    import __graft_entry__ as ge

    inputs = ge._synthetic_full_month(G=5, H=17, W=24)
    ref = full_month_step(inputs)
    mesh = make_mesh(8)  # 2x4: neither G=5 nor H=17 divides
    fn, shard = make_full_month_step(mesh)
    got = fn(shard(inputs))
    assert np.asarray(got.oi.xb).shape == (17, 24)
    # f32 inputs: sharded reductions reorder sums (~1 ulp on the curve)
    np.testing.assert_allclose(np.asarray(got.oi.curve), np.asarray(ref.oi.curve),
                               rtol=1e-5)
    assert int(got.oi.reg_index) == int(ref.oi.reg_index)
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got.scaling_factor),
                               np.asarray(ref.scaling_factor), rtol=1e-5, atol=1e-7)


def test_mesh_from_ctrl_key():
    """The production mesh_devices control key reaches a real multi-device
    mesh (VERDICT r2 item 2)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "run"))
    from job import mesh_from_ctrl

    assert mesh_from_ctrl({}) is None
    assert mesh_from_ctrl({"mesh_devices": 1}) is None
    m = mesh_from_ctrl({"mesh_devices": 8})
    assert m.devices.size == 8 and set(m.axis_names) == {"obs", "grid"}
    m = mesh_from_ctrl({"mesh_devices": "all"})
    assert m.devices.size == len(jax.devices())


def test_shard_inputs_interleaved_months_crop_correctly():
    """One compiled maker serving several months (the campaign compile-reuse
    pattern) must crop each month to ITS OWN height — interleaved shard()
    calls must not leak one month's padding into another's output."""
    import __graft_entry__ as ge

    mesh = make_mesh(8)  # 2x4
    fn, shard = make_full_month_step(mesh)
    a = shard(ge._synthetic_full_month(G=5, H=17, W=24))
    b = shard(ge._synthetic_full_month(G=6, H=20, W=24, seed=1))
    out_a = fn(a)
    out_b = fn(b)
    assert np.asarray(out_a.oi.xb).shape == (17, 24)
    assert np.asarray(out_b.oi.xb).shape == (20, 24)


def test_make_mesh_rejects_overrequest():
    import pytest

    from oisat.parallel.mesh import make_mesh as mm

    with pytest.raises(RuntimeError, match="mesh_devices"):
        mm(len(jax.devices()) + 1)


def test_eta_month_step_sharded_pads_non_divisible():
    """The transfer-compressed Eta month step shards with its explicit
    field specs and the Eta-aware padding (G=5, H=17 on a 2x4 mesh; padded
    granules gather the trailing NaN CTM slice, so they are invisible)."""
    from oisat.parallel.analysis import (
        FullMonthEtaInputs,
        full_month_eta_step,
        make_full_month_eta_step,
    )

    rng = np.random.default_rng(9)
    G, Ls, Lc, H, W, U = 5, 6, 12, 17, 24, 3
    f32 = np.float32
    carrier = np.abs(rng.normal(1000, 30, (G, H, W))).astype(f32)
    a = np.linspace(5, 800, Ls)[::-1].astype(f32) * np.ones((G, 1), f32)
    b = np.linspace(1.0, 0.01, Ls).astype(f32) * np.ones((G, 1), f32)
    vcd = np.abs(rng.normal(3, 1, (G, H, W))).astype(f32)
    vcd[rng.random((G, H, W)) < 0.1] = np.nan
    ctm_pmid = np.sort(rng.uniform(60, 1000, (U + 1, Lc, H, W)),
                       axis=1)[:, ::-1].astype(f32)
    ctm_pmid[-1] = np.nan  # trailing pad slice
    ctm_pc = np.abs(rng.normal(5, 1, (U + 1, Lc, H, W))).astype(f32)
    ctm_pc[-1] = np.nan
    inputs = FullMonthEtaInputs(
        sat_pmid_carrier=carrier, sat_pmid_a=a, sat_pmid_b=b,
        sat_sw=np.abs(rng.normal(1, 0.2, (G, Ls, H, W))).astype(f32),
        vcd=vcd, amf=np.abs(rng.normal(2, 0.3, (G, H, W))).astype(f32),
        uncertainty=np.abs(rng.normal(1, 0.2, (G, H, W))).astype(f32),
        tropopause=rng.uniform(100, 200, (G, H, W)).astype(f32),
        ctm_pmid=ctm_pmid, ctm_pc=ctm_pc,
        ctm_idx=(np.arange(G) % U).astype(np.int32),
    )
    ref = full_month_eta_step(inputs)
    mesh = make_mesh(8)  # 2x4: neither G=5 nor H=17 divides
    fn, shard = make_full_month_eta_step(mesh)
    got = fn(shard(inputs))
    assert np.asarray(got.oi.xb).shape == (H, W)
    assert int(got.oi.reg_index) == int(ref.oi.reg_index)
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb),
                               rtol=1e-5, atol=1e-7, equal_nan=True)
    np.testing.assert_allclose(np.asarray(got.ctm_vcd), np.asarray(ref.ctm_vcd),
                               rtol=1e-5, atol=1e-7, equal_nan=True)


def test_month_step_extensions_sharded_non_divisible():
    """weighting + return_granules (the fused save_daily pull) must work
    under a non-divisible sharded mesh: weights computed in-program match
    the host monthly_stats_weighted, and the DailyGranules leaves crop
    back to the true (G-padded, H, W)."""
    import __graft_entry__ as ge
    from oisat.ops.averaging import monthly_stats_weighted
    from oisat.parallel.analysis import DailyGranules

    inputs = ge._synthetic_full_month(G=5, H=17, W=24)
    mesh = make_mesh(8)  # 2x4: neither G=5 nor H=17 divides
    fn, shard = make_full_month_step(mesh, weighting="inverse_variance",
                                     return_granules=True)
    out, daily = fn(shard(inputs))
    assert isinstance(daily, DailyGranules)
    assert np.asarray(out.sat_vcd).shape == (17, 24)
    # padded granules trail: the first G rows are the real ones
    vcd_g = np.asarray(daily.vcd)[:5]
    assert np.asarray(daily.vcd).shape[-2:] == (17, 24)
    # reference: unsharded weighted stats on the per-granule outputs
    err = np.asarray(inputs.uncertainty, np.float64)
    w = np.where(err**2 > 0, 1.0 / err.astype(np.float32)**2, np.nan)
    ctm_g = np.asarray(daily.ctm_vcd)[:5]
    stats = monthly_stats_weighted(
        jnp.asarray(vcd_g), jnp.asarray(err, jnp.float32),
        jnp.asarray(ctm_g), jnp.asarray(vcd_g), jnp.asarray(vcd_g),
        jnp.asarray(w, jnp.float32))
    # out.sat_vcd is bias-corrected with (0,1) -> identity here
    np.testing.assert_allclose(np.asarray(out.sat_vcd),
                               np.asarray(stats.sat_vcd), rtol=2e-5,
                               atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(np.asarray(out.sat_error),
                               np.asarray(stats.sat_error), rtol=2e-5,
                               atol=1e-6, equal_nan=True)


def test_analysis_step_run_oi_false_skips_oi_stage():
    """run_oi=False: the averaged/bias-corrected fields are identical to the
    run_oi=True program, the oi slot carries NaN placeholders, and the
    scaling factor is exactly 1 (the host OI tail overwrites all of it —
    driver.analyze_month_fused with oi_method='full' / Desroziers)."""
    inputs = synth_inputs()
    full = analysis_step(inputs, bias_offset=0.3, bias_slope=0.7)
    skip = analysis_step(inputs, bias_offset=0.3, bias_slope=0.7,
                         run_oi=False)
    for field in ("sat_vcd", "sat_error", "ctm_vcd", "aux1", "aux2"):
        np.testing.assert_array_equal(np.asarray(getattr(skip, field)),
                                      np.asarray(getattr(full, field)))
    assert np.all(np.isnan(np.asarray(skip.oi.xb)))
    assert np.all(np.isnan(np.asarray(skip.oi.curve)))
    assert int(skip.oi.reg_index) == -1
    np.testing.assert_array_equal(np.asarray(skip.scaling_factor), 1.0)
    # the sharded maker threads run_oi through the cached jit wrapper
    mesh = make_mesh(8)
    fn, shard = make_analysis_step(mesh, bias_offset=0.3, bias_slope=0.7,
                                   run_oi=False)
    got = fn(shard(inputs))
    np.testing.assert_allclose(np.asarray(got.sat_vcd),
                               np.asarray(full.sat_vcd), rtol=1e-12,
                               equal_nan=True)
    assert np.all(np.isnan(np.asarray(got.oi.xb)))


def test_sharded_regrid_matches_single_device():
    """The SPMD regrid (regrid_mesh ambient -> _sharded_regrid_fn): fine
    grid sharded by rows over every mesh axis, identical outputs to the
    single-device program.  The test fine grid has 61 rows over 8 devices
    — a NON-divisible split — proving GSPMD's uneven-shard handling (the
    reason the constraint is mid-program, not an in_shardings)."""
    from oisat.regridder import regrid_granule, regrid_mesh
    from tests.test_pipeline import ctm_grid, synthetic_granule

    clon, clat = ctm_grid()
    base = regrid_granule(1, 0.25, synthetic_granule(7, 11), clon, clat,
                          flag_thresh=0.5)
    mesh = make_mesh(8)
    with regrid_mesh(mesh):
        spmd = regrid_granule(1, 0.25, synthetic_granule(7, 11), clon, clat,
                              flag_thresh=0.5)
    for n in ("vcd", "amf", "uncertainty", "tropopause", "pressure_mid",
              "scattering_weights"):
        a = np.asarray(getattr(base, n))
        b = np.asarray(getattr(spmd, n))
        assert a.shape == b.shape, n
        np.testing.assert_allclose(b, a, rtol=1e-6, equal_nan=True, err_msg=n)


def test_sharded_regrid_program_is_partitioned():
    """The compiled SPMD regrid must actually partition: 8-way row shards
    plus the halo-exchange / gather collectives in the HLO (a silently
    ignored sharding constraint would pass the equality test above while
    running replicated)."""
    import re

    import jax.numpy as jnp

    from oisat.regridder import _sharded_regrid_fn

    mesh = make_mesh(8)
    fn = _sharded_regrid_fn(mesh)
    F, N, T = 3, 1024, 61 * 81
    rng = np.random.default_rng(0)
    args = (jnp.asarray(rng.normal(size=(F, N)).astype(np.float32)),
            jnp.zeros((0, N), np.float16), jnp.zeros((0, N), np.float32),
            jnp.asarray(rng.normal(size=(1, N)).astype(np.float32)),
            jnp.asarray(rng.integers(0, N, (T, 3)).astype(np.int32)),
            jnp.asarray(rng.uniform(0, 1, (T, 3)).astype(np.float32)),
            jnp.zeros((T,), bool),
            jnp.asarray(rng.integers(0, T, (16 * 17, 1)).astype(np.int32)),
            jnp.ones((16 * 17, 1), np.float32),
            jnp.zeros((16 * 17,), bool))
    txt = fn.func.lower(*args, fine_shape=(61, 81), ky=4, kx=5,
                        passthrough=False,
                        row_sharding=fn.keywords["row_sharding"]
                        ).compile().as_text()
    ops = set(re.findall(r"(all-gather|collective-permute)", txt))
    assert "collective-permute" in ops or "all-gather" in ops, ops
    assert "8,81" in txt.replace(" ", "")  # ceil(61/8)-row shards exist


def test_regrid_mesh_visible_in_fleet_pool_threads(monkeypatch):
    """set_regrid_mesh must be process-wide: fleet_map's multi-core branch
    regrids in ThreadPoolExecutor workers, and a thread-local mesh set by
    the job runner's main thread would silently disable the SPMD regrid
    exactly on the hosts with cores to fan out."""
    import os

    import oisat.readers.sensors.common as C
    from oisat.regridder import _regrid_mesh_default, regrid_mesh

    mesh = make_mesh(8)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)  # force the pool branch
    with regrid_mesh(mesh):
        seen = C.fleet_map(lambda f: _regrid_mesh_default(), [0, 1, 2], 3,
                           "mesh-vis")
    assert all(m is mesh for m in seen)
    assert _regrid_mesh_default() is None  # context restored


def test_sharded_regrid_ssmis_matches_single_device():
    """The SSMIS regrid variant (own one-program finisher) through the
    SPMD regrid path must match single-device too."""
    from oisat.datamodel import satellite_ssmis
    from oisat.regridder import regrid_mesh, regrid_ssmis_granule

    lat = np.arange(-89.5, 90, 2.0)
    lon = np.arange(-179.5, 180, 2.0)
    lon2, lat2 = np.meshgrid(lon, lat)
    vcd = 20 + 5 * np.sin(lon2 / 20.0) * np.cos(lat2 / 15.0)

    def g():
        return satellite_ssmis(vcd=vcd.copy(),
                               uncertainty=np.full(lat2.shape, 1.0),
                               time=None, latitude_center=lat2,
                               longitude_center=lon2,
                               ctm_upscaled_needed=False, ctm_vcd=[],
                               sensor="SSMIS")

    clon2, clat2 = np.meshgrid(np.arange(-20.0, 10.0, 2.0),
                               np.arange(20.0, 60.0, 2.0))
    base = regrid_ssmis_granule(2.0, g(), clon2, clat2)
    with regrid_mesh(make_mesh(8)):
        spmd = regrid_ssmis_granule(2.0, g(), clon2, clat2)
    for n in ("vcd", "uncertainty"):
        a, b = np.asarray(getattr(base, n)), np.asarray(getattr(spmd, n))
        np.testing.assert_allclose(b, a, rtol=1e-6, equal_nan=True, err_msg=n)


def test_sharded_regrid_passthrough_matches_single_device():
    """SPMD regrid with the upscaler in pass-through mode (granule grid
    coarser than the CTM: ctm_upscaled_needed): the program returns the
    row-sharded fine grid directly, a different exit than the
    boxfilter+upscale path the other tests cover."""
    from oisat.regridder import regrid_granule, regrid_mesh
    from tests.test_pipeline import ctm_grid, synthetic_granule

    clon, clat = ctm_grid()
    base = regrid_granule(1, 2.0, synthetic_granule(5, 9), clon, clat,
                          flag_thresh=0.5)
    with regrid_mesh(make_mesh(8)):
        spmd = regrid_granule(1, 2.0, synthetic_granule(5, 9), clon, clat,
                              flag_thresh=0.5)
    assert base is not None and base.ctm_upscaled_needed
    assert spmd.ctm_upscaled_needed
    for n in ("vcd", "amf", "uncertainty", "pressure_mid",
              "scattering_weights"):
        a = np.asarray(getattr(base, n))
        b = np.asarray(getattr(spmd, n))
        assert a.shape == b.shape, n
        np.testing.assert_allclose(b, a, rtol=1e-6, equal_nan=True, err_msg=n)


def test_analysis_step_innovation_fold():
    """The in-program innovation/chi2 diagnostics must equal the
    standalone innovation_stats computed on the step's own outputs with
    the y<0 clamp the OI applies (the staged driver path's convention)."""
    from oisat.ops.diagnostics import innovation_stats

    inputs = synth_inputs()
    out = analysis_step(inputs, bias_offset=0.1, bias_slope=0.9)
    xa = np.asarray(out.ctm_vcd, np.float64)
    y = np.asarray(out.sat_vcd, np.float64)
    y = np.where(y < 0, 0.0, y)
    st = innovation_stats(xa, y, np.asarray(out.oi.xb, np.float64),
                          (xa * 0.5) ** 2,
                          np.asarray(out.sat_error, np.float64) ** 2)
    assert int(out.innovation.n) == int(st.n) > 0
    for f in ("omb_mean", "omb_rms", "oma_mean", "oma_rms", "chi2"):
        np.testing.assert_allclose(float(getattr(out.innovation, f)),
                                   float(getattr(st, f)), rtol=1e-4,
                                   err_msg=f)
    # run_oi=False: placeholders, not stale numbers
    skip = analysis_step(inputs, bias_offset=0.1, bias_slope=0.9,
                         run_oi=False)
    assert int(skip.innovation.n) == 0
    assert np.isnan(float(skip.innovation.chi2))


def test_eta_step_compressed_ctm_matches_full():
    """Carrier-compressed CTM stacks (hybrid-eta affine pmid) must yield
    the same month analysis as the full (U+1, Lc, H, W) transfer, single
    device AND sharded over a non-divisible mesh."""
    from oisat.parallel.analysis import (
        FullMonthEtaInputs,
        full_month_eta_step,
        make_full_month_eta_step,
    )
    from oisat.parallel.mesh import make_mesh

    rng = np.random.default_rng(21)
    G, Ls, Lc, H, W, U = 5, 6, 12, 17, 24, 3
    f32 = np.float32
    # hybrid-eta CTM stack: pmid[u] = a + b * ps[u]; level 0 IS ps
    a = np.concatenate([[0.0], np.linspace(40, 600, Lc - 1)]).astype(f32)
    b = np.concatenate([[1.0], np.linspace(0.9, 0.01, Lc - 1)]).astype(f32)
    ps = (1000.0 + 30.0 * rng.standard_normal((U + 1, H, W))).astype(f32)
    ctm_pmid = (a[None, :, None, None]
                + b[None, :, None, None] * ps[:, None]).astype(f32)
    ctm_pmid[-1] = np.nan
    ps[-1] = np.nan
    ctm_pc = np.abs(rng.normal(5, 1, (U + 1, Lc, H, W))).astype(f32)
    ctm_pc[-1] = np.nan
    vcd = np.abs(rng.normal(3, 1, (G, H, W))).astype(f32)
    vcd[rng.random((G, H, W)) < 0.1] = np.nan
    common = dict(
        sat_pmid_carrier=np.abs(rng.normal(1000, 30, (G, H, W))).astype(f32),
        sat_pmid_a=(np.linspace(5, 800, Ls)[::-1].astype(f32)
                    * np.ones((G, 1), f32)),
        sat_pmid_b=(np.linspace(1.0, 0.01, Ls).astype(f32)
                    * np.ones((G, 1), f32)),
        sat_sw=np.abs(rng.normal(1, 0.2, (G, Ls, H, W))).astype(f32),
        vcd=vcd,
        amf=np.abs(rng.normal(2, 0.3, (G, H, W))).astype(f32),
        uncertainty=np.abs(rng.normal(1, 0.2, (G, H, W))).astype(f32),
        tropopause=rng.uniform(100, 200, (G, H, W)).astype(f32),
        ctm_idx=(np.arange(G) % U).astype(np.int32),
    )
    full = FullMonthEtaInputs(ctm_pmid=ctm_pmid, ctm_pc=ctm_pc, **common)
    comp = FullMonthEtaInputs(
        ctm_pmid=ps[:, None], ctm_pc=ctm_pc,
        ctm_pmid_a=np.tile(a, (U + 1, 1)), ctm_pmid_b=np.tile(b, (U + 1, 1)),
        **common)
    ref = full_month_eta_step(full)
    got = full_month_eta_step(comp)
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb),
                               rtol=1e-5, atol=1e-7, equal_nan=True)
    np.testing.assert_allclose(np.asarray(got.ctm_vcd),
                               np.asarray(ref.ctm_vcd),
                               rtol=1e-5, atol=1e-7, equal_nan=True)
    # sharded: non-divisible G and H; padded granules gather the NaN slice
    mesh = make_mesh(8)
    fn, shard = make_full_month_eta_step(mesh)
    got_sh = fn(shard(comp))
    np.testing.assert_allclose(np.asarray(got_sh.oi.xb),
                               np.asarray(ref.oi.xb),
                               rtol=1e-5, atol=1e-7, equal_nan=True)


def _eta_ctm_stacks(G, Lc, H, W, seed=5, scale=1.0):
    """(full_stack, carrier, a, b): pmid[g] = a[g] + b[g]*carrier[g]."""
    rng = np.random.default_rng(seed)
    a = (np.concatenate([[0.0], np.linspace(40, 600, Lc - 1)]) * scale)
    b = np.concatenate([[1.0], np.linspace(0.9, 0.01, Lc - 1)]) * scale
    ps = (1000.0 + 30.0 * rng.standard_normal((G, H, W)))
    full = (a[None, :, None, None]
            + b[None, :, None, None] * ps[:, None]).astype(np.float32)
    return (full, ps.astype(np.float32)[:, None],
            np.tile(a, (G, 1)).astype(np.float32),
            np.tile(b, (G, 1)).astype(np.float32))


def test_mopitt_step_compressed_ctm_matches_full():
    """Carrier-compressed CTM pmid AND air-column stacks must reproduce
    the full-layout MOPITT month, single device and sharded (the empty
    (G, 0, H, W) airpc placeholder must shard cleanly too)."""
    import __graft_entry__ as ge
    from oisat.parallel.analysis import (
        make_mopitt_month_step,
        mopitt_month_step,
    )

    G, H, W = 5, 17, 24
    base = ge._synthetic_mopitt_month(G=G, H=H, W=W)
    Lc = base.ctm_pmid.shape[1]
    pm_full, carrier, a, b = _eta_ctm_stacks(G, Lc, H, W)
    # air columns affine in the SAME carrier (dp is eta-structured too)
    ai_a = np.tile(np.linspace(1e8, 9e8, Lc), (G, 1)).astype(np.float32)
    ai_b = np.tile(np.linspace(2e6, 1e5, Lc), (G, 1)).astype(np.float32)
    ai_full = (ai_a[:, :, None, None]
               + ai_b[:, :, None, None] * carrier).astype(np.float32)
    full = base._replace(ctm_pmid=pm_full, ctm_airpc=ai_full)
    comp = base._replace(ctm_pmid=carrier, ctm_pmid_a=a, ctm_pmid_b=b,
                         ctm_airpc=np.zeros((G, 0, H, W), np.float32),
                         ctm_airpc_a=ai_a, ctm_airpc_b=ai_b)
    ref = mopitt_month_step(full)
    got = mopitt_month_step(comp)
    np.testing.assert_allclose(np.asarray(got.oi.xb), np.asarray(ref.oi.xb),
                               rtol=1e-4, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(np.asarray(got.aux2), np.asarray(ref.aux2),
                               rtol=1e-4, atol=1e-7, equal_nan=True)
    mesh = make_mesh(8)  # 2x4: neither G=5 nor H=17 divides
    fn, shard = make_mopitt_month_step(mesh)
    got_sh = fn(shard(comp))
    np.testing.assert_allclose(np.asarray(got_sh.oi.xb),
                               np.asarray(got.oi.xb),
                               rtol=1e-5, atol=1e-7, equal_nan=True)


def test_gosat_step_compressed_ctm_matches_full():
    from oisat.parallel.analysis import (
        GosatMonthInputs,
        gosat_month_step,
        make_gosat_month_step,
    )

    rng = np.random.default_rng(3)
    G, Ls, Lc, H, W = 5, 6, 12, 17, 24
    f32 = np.float32
    pm_full, carrier, a, b = _eta_ctm_stacks(G, Lc, H, W, seed=9)
    vcd = np.abs(rng.normal(1800, 30, (G, H, W))).astype(f32)
    vcd[rng.random((G, H, W)) < 0.1] = np.nan
    common = dict(
        ctm_profile=np.abs(rng.normal(1800, 50, (G, Lc, H, W))).astype(f32),
        sat_pmid=np.sort(rng.uniform(100, 950, (G, Ls, H, W)),
                         axis=1)[:, ::-1].astype(f32),
        aks=rng.uniform(0.2, 1.0, (G, Ls, H, W)).astype(f32),
        apriori_profile=np.abs(rng.normal(1750, 50, (G, Ls, H, W))).astype(f32),
        pressure_weight=np.full((G, Ls, H, W), 1.0 / Ls, f32),
        vcd=vcd,
        x_col=np.abs(rng.normal(1800, 30, (G, H, W))).astype(f32),
        uncertainty=np.abs(rng.normal(10, 2, (G, H, W))).astype(f32),
    )
    ref = gosat_month_step(GosatMonthInputs(ctm_pmid=pm_full, **common))
    comp = GosatMonthInputs(ctm_pmid=carrier, ctm_pmid_a=a, ctm_pmid_b=b,
                            **common)
    got = gosat_month_step(comp)
    np.testing.assert_allclose(np.asarray(got.aux2), np.asarray(ref.aux2),
                               rtol=1e-4, atol=1e-6, equal_nan=True)
    mesh = make_mesh(8)
    fn, shard = make_gosat_month_step(mesh)
    got_sh = fn(shard(comp))
    np.testing.assert_allclose(np.asarray(got_sh.aux2), np.asarray(got.aux2),
                               rtol=1e-5, atol=1e-6, equal_nan=True)


def test_matfree_oi_full_sharded_matches_single_device():
    """`oi_full_matfree(mesh=...)` shards every covariance-tile sweep over
    the mesh (chunk-axis GSPMD constraint; the chunk-partial sum lowers to
    a psum).  Fields must match the single-device solve to f32
    reduction-order noise, and the sharded sweep's HLO must actually
    contain a cross-device reduction."""
    import jax
    from oisat.ops.oi_full import oi_full_matfree, _b_matmat

    mesh = make_mesh(8)
    H, W = 16, 32
    rng = np.random.default_rng(5)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(0.9, 1.2, (H, W))).ravel()
    sb = 0.5 * xa
    so = np.full(H * W, 0.1)
    kw = dict(block=128, precond="nystrom", nystrom_k=128, refine=0)
    ref = oi_full_matfree(xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0, **kw)
    got = oi_full_matfree(xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0,
                          mesh=mesh, **kw)
    # cg_resid is the row-sampled TRUE-operator residual (honest
    # reporting; the f32-internal number reads ~1e-7 here)
    assert got[4]["cg_resid"] < 1e-3
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)

    import jax.numpy as jnp
    u3 = np.random.default_rng(0).standard_normal((512, 3)).astype(np.float32)
    u3 /= np.linalg.norm(u3, axis=1)[:, None]
    hlo = _b_matmat.lower(jnp.asarray(u3), jnp.ones(512, jnp.float32),
                          jnp.ones((512, 8), jnp.float32), 300.0, 128,
                          mesh=mesh).compile().as_text()
    assert "all-reduce" in hlo or "reduce-scatter" in hlo
