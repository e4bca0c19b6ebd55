import numpy as np
import pytest

from oisat.datamodel import satellite_amf, satellite_opt
from oisat.regridder import regrid_granule


def synthetic_amf_granule(seed=0, ny=60, nx=40, nz=5):
    rng = np.random.default_rng(seed)
    # a tilted swath of pixel centers
    lat = np.linspace(31, 44, ny)[:, None] + 0.05 * rng.standard_normal((ny, nx))
    lon = np.linspace(-8, 8, nx)[None, :] + 0.2 * np.linspace(0, 1, ny)[:, None]
    vcd = np.abs(rng.normal(3, 1, (ny, nx)))
    # mostly-good QA with one bad cluster: the box-filter NaN spreading in
    # the upscale stage (a reference semantic) wipes any window touching a
    # bad pixel, so a random mask would blank the whole domain.
    qa = np.ones((ny, nx))
    qa[10:13, 5:8] = 0.0
    return satellite_amf(
        vcd=vcd,
        amf=np.abs(rng.normal(2, 0.3, (ny, nx))),
        time=None,
        tropopause=np.abs(rng.normal(150, 20, (ny, nx))),
        latitude_center=lat,
        longitude_center=lon + 0 * lat,
        latitude_corner=[],
        longitude_corner=[],
        uncertainty=np.abs(rng.normal(1, 0.2, (ny, nx))),
        quality_flag=qa,
        pressure_mid=np.linspace(1000, 100, nz)[:, None, None] * np.ones((nz, ny, nx)),
        scattering_weights=np.abs(rng.normal(1, 0.2, (nz, ny, nx))),
    )


def ctm_grid():
    return np.meshgrid(np.arange(-10, 11, 1.25), np.arange(30, 46, 1.0))


@pytest.mark.parametrize("method", [1, 2, 3, 4])
def test_regrid_amf_granule_shapes(method):
    g = synthetic_amf_granule()
    clon, clat = ctm_grid()
    out = regrid_granule(method, 0.25, g, clon, clat, flag_thresh=0.5)
    assert out is not None
    assert out.vcd.shape == clon.shape
    assert out.amf.shape == clon.shape
    assert out.uncertainty.shape == clon.shape
    assert out.scattering_weights.shape == (5,) + clon.shape
    assert out.pressure_mid.shape == (5,) + clon.shape
    assert out.ctm_upscaled_needed is False
    # interior cells covered, far corners NaN-masked
    assert np.isfinite(out.vcd).sum() > 50
    assert np.isnan(out.vcd[0, 0])  # (30N, -10E) has no swath nearby? swath starts at 31N
    # errors are positive where defined
    assert np.nanmin(out.uncertainty) >= 0


def test_regrid_granule_misses_domain():
    g = synthetic_amf_granule()
    clon, clat = np.meshgrid(np.arange(100, 120, 1.0), np.arange(-40, -20, 1.0))
    assert regrid_granule(1, 0.25, g, clon, clat) is None


def test_regrid_no_ak_branch():
    g = synthetic_amf_granule()
    g.scattering_weights = np.empty((1,))
    clon, clat = ctm_grid()
    out = regrid_granule(1, 0.25, g, clon, clat)
    assert np.size(out.scattering_weights) == 1
    assert out.pressure_mid.shape == (5,) + clon.shape
    assert np.all(out.pressure_mid == 0)


def test_regrid_opt_granule():
    rng = np.random.default_rng(1)
    ny, nx, nz = 50, 30, 4
    lat = np.linspace(31, 44, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(-8, 8, nx)[None, :]
    g = satellite_opt(
        vcd=np.abs(rng.normal(2, 0.5, (ny, nx))),
        time=None,
        tropopause=np.empty((1,)),
        latitude_center=lat,
        longitude_center=lon,
        uncertainty=np.abs(rng.normal(0.5, 0.1, (ny, nx))),
        quality_flag=np.ones((ny, nx)),
        pressure_mid=np.linspace(900, 100, nz)[:, None, None] * np.ones((nz, ny, nx)),
        averaging_kernels=rng.uniform(0, 1, (nz + 1, ny, nx)),  # MOPITT: surface row
        aprior_column=np.abs(rng.normal(2, 0.2, (ny, nx))),
        apriori_profile=np.abs(rng.normal(100, 10, (nz, ny, nx))),
        surface_pressure=np.full((ny, nx), 1000.0),
        apriori_surface=np.abs(rng.normal(100, 5, (ny, nx))),
        x_col=np.abs(rng.normal(0.1, 0.02, (ny, nx))),
        pressure_weight=np.empty((1,)),
        sensor="MOPITT",
    )
    clon, clat = ctm_grid()
    out = regrid_granule(1, 1.0, g, clon, clat, flag_thresh=0.0)
    assert out is not None
    assert out.averaging_kernels.shape == (nz + 1,) + clon.shape
    assert out.apriori_profile.shape == (nz,) + clon.shape
    assert out.x_col.shape == clon.shape
    assert out.sensor == "MOPITT"


def test_fleet_map_lazy_pipeline_order_and_faults():
    """fleet_map's single-threaded submit/collect pipeline (num_job=1):
    regrids inside the reader return PendingGranule (device dispatched,
    collection deferred one step), results come back in file order with
    per-file fault tolerance intact, and values match the eager path."""
    import numpy as np

    from oisat.readers.sensors.common import fleet_map
    from oisat.regridder import regrid_granule
    from tests.test_pipeline import ctm_grid, synthetic_granule

    clon, clat = ctm_grid()

    def reader(s):
        if s == 2:
            raise RuntimeError("synthetic corrupt file")
        return regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                              flag_thresh=0.5)

    out = fleet_map(reader, [0, 1, 2, 3], 1, "test")
    assert len(out) == 4
    assert out[2] is None  # fault tolerance preserved
    for s in (0, 1, 3):
        assert out[s] is not None and not hasattr(out[s], "resolve")
        eager = regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5)
        np.testing.assert_array_equal(out[s].vcd, eager.vcd)
        np.testing.assert_array_equal(out[s].pressure_mid, eager.pressure_mid)


def test_affine_pressure_stack_fast_path_matches_full():
    """Eta-structured pressure stacks (pmid = A + B*psurf, how every
    supported sensor builds them) regrid via ONE carrier level +
    reconstruction; the result must match the full per-level transfer to
    float rounding, NaN pattern included."""
    import dataclasses
    import datetime

    import numpy as np

    import oisat.regridder as R
    from oisat.datamodel import satellite_amf
    from tests.test_pipeline import ctm_grid, synthetic_granule

    clon, clat = ctm_grid()
    g = synthetic_granule(3, 7)
    nz = 6
    eta_a = np.linspace(5.0, 900.0, nz)[::-1].copy()
    eta_b = np.linspace(1.0, 0.01, nz)
    ps = np.abs(np.random.default_rng(5).normal(1000, 30, g.vcd.shape))
    g.pressure_mid = (eta_a[:, None, None]
                      + eta_b[:, None, None] * ps[None]).astype(np.float64)
    assert R._affine_stack(g.pressure_mid) is not None

    got = R.regrid_granule(1, 0.25, g, clon, clat, flag_thresh=0.5,
                           dtype=np.float64)
    # force the full per-level path by disabling detection
    orig = R._affine_stack
    R._affine_stack = lambda *a, **k: None
    try:
        g2 = synthetic_granule(3, 7)
        g2.pressure_mid = g.pressure_mid.copy()
        ref = R.regrid_granule(1, 0.25, g2, clon, clat, flag_thresh=0.5,
                               dtype=np.float64)
    finally:
        R._affine_stack = orig
    np.testing.assert_array_equal(np.isnan(got.pressure_mid),
                                  np.isnan(ref.pressure_mid))
    np.testing.assert_allclose(got.pressure_mid, ref.pressure_mid,
                               rtol=1e-12, atol=1e-9, equal_nan=True)
    # and the non-pressure fields are untouched by the fast path
    np.testing.assert_array_equal(got.vcd, ref.vcd)

    # a genuinely unstructured stack must NOT take the fast path
    assert R._affine_stack(np.asarray(synthetic_granule(0, 4).pressure_mid)) is None
    # a constant-per-level stack (OMI NO2 / MOPITT pressure tables) does
    const = np.linspace(900, 100, nz)[:, None, None] * np.ones_like(ps)[None]
    ab = R._affine_stack(const)
    assert ab is not None and np.allclose(ab[1], 0.0)


def test_affine_stack_properties():
    """Property sweep for the affine detector: exact recovery on affine
    stacks (any carrier position, b=0 rows, shared NaN patterns, f32
    rounding), rejection of non-affine stacks, mismatched NaN patterns,
    and tiny stacks."""
    import numpy as np

    from oisat.regridder import _affine_stack

    rng = np.random.default_rng(123)
    for trial in range(20):
        L, ny, nx = rng.integers(3, 9), 13, 17
        ps = np.abs(rng.normal(1000, 40, (ny, nx)))
        a = rng.uniform(0, 500, L)
        b = rng.uniform(0, 1.2, L)
        b[rng.random(L) < 0.3] = 0.0  # constant rows are legal
        stack = a[:, None, None] + b[:, None, None] * ps[None]
        nanmask = rng.random((ny, nx)) < 0.2
        stack[:, nanmask] = np.nan  # one shared NaN pattern
        st = stack.astype(np.float32) if trial % 2 else stack
        got = _affine_stack(st)
        assert got is not None, trial
        ga, gb, ci = got
        recon = ga[:, None, None] + gb[:, None, None] * np.asarray(st, np.float64)[ci]
        m = np.isfinite(stack)
        tol = 1e-4 if trial % 2 else 1e-9
        np.testing.assert_allclose(recon[m], np.asarray(st, np.float64)[m],
                                   rtol=tol, atol=tol)

    # non-affine: independent random levels
    bad = np.abs(rng.normal(500, 100, (5, 13, 17)))
    assert _affine_stack(bad) is None
    # one level with its own NaN pattern -> rejected (reconstruction would
    # move NaNs)
    ok = np.linspace(100, 900, 5)[:, None, None] * np.ones((5, 13, 17))
    ok2 = ok.copy()
    ok2[3, 0, 0] = np.nan
    assert _affine_stack(ok2) is None
    # too short to be worth compressing
    assert _affine_stack(ok[:2]) is None
    # all-constant stack (MOPITT-style fixed table): b == 0 everywhere
    got = _affine_stack(ok)
    assert got is not None and np.allclose(got[1], 0.0)


def test_compact_plan_exact_and_threshold():
    """compact_plan is an exact (bitwise) rewrite of the sparse map."""
    from oisat.ops.regrid import apply_plan
    from oisat.ops.weights import build_plan, compact_plan

    rng = np.random.default_rng(7)
    # dense scattered pixels over a small window: a coarse target grid
    # references only a fraction of them (the compaction win case)
    plon = rng.uniform(-5, 5, 4000)
    plat = rng.uniform(30, 40, 4000)
    tlon, tlat = np.meshgrid(np.arange(-4, 4, 0.8), np.arange(31, 39, 0.8))
    plan = build_plan(plon, plat, tlon, tlat, method=1, threshold=0.8)
    cp = compact_plan(plan)
    assert cp.sel is not None and cp.sel.size < plan.npix
    assert cp.npix == plan.npix  # original count preserved
    assert cp.idx.dtype == np.int16  # small compacted axis rides int16
    z = rng.normal(size=(3, 4000))
    z[0, ::17] = np.nan
    a = np.asarray(apply_plan(plan, z))
    b = np.asarray(apply_plan(cp, z))
    assert np.array_equal(a, b, equal_nan=True)
    # device-array input takes the in-program gather, same values
    import jax.numpy as jnp
    c = np.asarray(apply_plan(cp, jnp.asarray(z)))
    mask = np.isfinite(a)
    assert np.array_equal(np.isfinite(c), mask)
    np.testing.assert_allclose(c[mask], a[mask], rtol=2e-6)
    # a plan that references (nearly) every pixel is left alone
    near = build_plan(plon, plat,
                      *np.meshgrid(np.arange(-5, 5, 0.05), np.arange(30, 40, 0.05)),
                      method=4, threshold=0.8)
    frac = np.unique(near.idx[~near.mask]).size / near.npix
    assert frac > 0.85
    assert compact_plan(near).sel is None


def synthetic_opt_granule(seed=0, ny=60, nx=40, nz=6):
    """MOPITT-shaped satellite_opt granule: exercises every add2d/add3d
    route of the assembly (aprior/surface 2-D fields, AK + apriori-profile
    stacks, x_col) plus the narrow2d MOPITT set."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(31, 44, ny)[:, None] + 0.05 * rng.standard_normal((ny, nx))
    lon = np.linspace(-8, 8, nx)[None, :] + 0.2 * np.linspace(0, 1, ny)[:, None]
    qa = np.ones((ny, nx))
    qa[20:23, 10:13] = 0.0
    return satellite_opt(
        vcd=np.abs(rng.normal(2, 0.5, (ny, nx))),
        time=None,
        latitude_center=lat,
        longitude_center=lon + 0 * lat,
        uncertainty=np.abs(rng.normal(0.3, 0.05, (ny, nx))),
        quality_flag=qa,
        pressure_mid=np.linspace(1000, 100, nz)[:, None, None] * np.ones((nz, ny, nx)),
        averaging_kernels=np.abs(rng.normal(0.8, 0.1, (nz, ny, nx))),
        apriori_profile=np.abs(rng.normal(1.5, 0.2, (nz, ny, nx))),
        aprior_column=np.abs(rng.normal(1.8, 0.2, (ny, nx))),
        surface_pressure=np.abs(rng.normal(990, 15, (ny, nx))),
        apriori_surface=np.abs(rng.normal(1.2, 0.1, (ny, nx))),
        x_col=np.abs(rng.normal(90, 5, (ny, nx))),
        pressure_weight=[],
        ctm_upscaled_needed=False, ctm_vcd=[], ctm_time_at_sat=[],
        ctm_xcol=[], sensor="MOPITT",
    )


def test_regrid_opt_granule_compaction_bitwise(monkeypatch):
    """The gather-first assembly is bitwise identical to the full-width
    mask+stack path for the satellite_opt field routes too."""
    import oisat.regridder as R

    clon, clat = ctm_grid()

    def run():
        R._plan_cache.clear()
        g = synthetic_opt_granule(5)
        return regrid_granule(1, 0.25, g, clon, clat, flag_thresh=0.5)

    compacted = run()
    monkeypatch.setattr(R, "compact_plan", lambda p: p)
    plain = run()
    for name in ("vcd", "x_col", "uncertainty", "aprior_column",
                 "surface_pressure", "apriori_surface",
                 "averaging_kernels", "apriori_profile", "pressure_mid"):
        a = np.asarray(getattr(compacted, name))
        b = np.asarray(getattr(plain, name))
        assert np.array_equal(a, b, equal_nan=True), name
    R._plan_cache.clear()


def test_regrid_opt_granule_size1_broadcast(monkeypatch):
    """Nonzero size-1 placeholder fields (they pass the assembly's .any()
    guards) broadcast on the compacted gather path exactly like the
    full-width branch's `field * mask` multiply."""
    import dataclasses
    import oisat.regridder as R

    clon, clat = ctm_grid()

    def run():
        R._plan_cache.clear()
        g = synthetic_opt_granule(7)
        g = dataclasses.replace(
            g,
            aprior_column=np.array([1.75]),
            apriori_surface=np.full((1, g.vcd.shape[1]), 1.25),
        )
        return regrid_granule(1, 0.25, g, clon, clat, flag_thresh=0.5)

    compacted = run()
    assert np.isfinite(np.asarray(compacted.aprior_column)).any()
    monkeypatch.setattr(R, "compact_plan", lambda p: p)
    plain = run()
    for name in ("vcd", "aprior_column", "apriori_surface", "x_col"):
        a = np.asarray(getattr(compacted, name))
        b = np.asarray(getattr(plain, name))
        assert np.array_equal(a, b, equal_nan=True), name
    R._plan_cache.clear()


def test_regrid_granule_compaction_bitwise(monkeypatch):
    """The production regrid path is bitwise identical with the pixel
    compaction disabled (it gathers the same values for the same
    weights)."""
    import oisat.regridder as R

    clon, clat = ctm_grid()

    def run():
        R._plan_cache.clear()
        g = synthetic_amf_granule(3)
        out = regrid_granule(1, 0.25, g, clon, clat, flag_thresh=0.5)
        return out

    compacted = run()
    assert R._plan_cache is not None
    monkeypatch.setattr(R, "compact_plan", lambda p: p)
    plain = run()
    for name in ("vcd", "amf", "uncertainty", "tropopause",
                 "scattering_weights", "pressure_mid"):
        a, b = np.asarray(getattr(compacted, name)), np.asarray(getattr(plain, name))
        assert np.array_equal(a, b, equal_nan=True), name
    R._plan_cache.clear()
