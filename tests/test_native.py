import time

import numpy as np
import pytest

from oisat import native
from oisat.ops.regrid import apply_plan
from oisat.ops.weights import build_plan, build_plan_structured

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native swath_weights not built")


def swath(ny=120, nx=60, seed=0):
    rng = np.random.default_rng(seed)
    lat = np.linspace(30, 45, ny)[:, None] + 0.01 * rng.standard_normal((ny, nx))
    lon = np.linspace(-10, 10, nx)[None, :] + 1.5 * np.sin(np.linspace(0, 3, ny))[:, None]
    return (lon + 0 * lat), (lat + 0 * lon)


def targets():
    return np.meshgrid(np.arange(-12, 12, 0.2), np.arange(28, 47, 0.2))


def test_constant_and_linear_fields_exact():
    lon, lat = swath()
    tlon, tlat = targets()
    plan = build_plan_structured(lon, lat, tlon, tlat, threshold=0.3)
    assert plan is not None
    const = np.full(lon.size, 5.0)
    out = np.asarray(apply_plan(plan, const))
    np.testing.assert_allclose(out[np.isfinite(out)], 5.0, rtol=1e-12)
    # linear field reproduced exactly inside the swath
    lin = (2.0 * lon + 3.0 * lat).ravel()
    out = np.asarray(apply_plan(plan, lin))
    m = np.isfinite(out)
    np.testing.assert_allclose(out[m], (2.0 * tlon + 3.0 * tlat)[m], rtol=1e-9)


def test_matches_delaunay_on_smooth_field():
    lon, lat = swath()
    tlon, tlat = targets()
    sp = build_plan_structured(lon, lat, tlon, tlat, threshold=0.3)
    dp = build_plan(lon.ravel(), lat.ravel(), tlon, tlat, method=1, threshold=0.3)
    z = np.sin(lon / 3) * np.cos(lat / 5)
    a = np.asarray(apply_plan(sp, z.ravel()))
    b = np.asarray(apply_plan(dp, z.ravel()))
    both = np.isfinite(a) & np.isfinite(b)
    assert both.sum() > 1000
    # different triangulations -> tiny differences on curved fields only
    np.testing.assert_allclose(a[both], b[both], atol=5e-3)
    # Delaunay also fills the convex hull across swath concavities, which
    # the structured path (correctly) does not extrapolate into
    assert (np.isfinite(a) & ~np.isfinite(b)).mean() < 0.005
    assert (np.isfinite(b) & ~np.isfinite(a)).mean() < 0.05


def test_distance_mask_close_to_kdtree():
    from scipy.spatial import cKDTree

    lon, lat = swath()
    tlon, tlat = targets()
    tree = cKDTree(np.column_stack([lon.ravel(), lat.ravel()]))
    dists, _ = tree.query(np.column_stack([tlon.ravel(), tlat.ravel()]))
    idx, w, dist, nn, ok = native.structured_weights(lon, lat, tlon.ravel(), tlat.ravel())
    # the native nearest-pixel distance matches the KD-tree exactly
    np.testing.assert_allclose(dist, dists, rtol=0, atol=1e-12)


def test_relaxed_dist_same_far_mask():
    """exact_dist=False only promises the correct SIDE of the cutoff —
    which must make the method-1 far mask identical to the exact scan's."""
    from scipy.spatial import cKDTree

    lon, lat = swath(seed=5)
    tlon, tlat = targets()
    tree = cKDTree(np.column_stack([lon.ravel(), lat.ravel()]))
    dists, _ = tree.query(np.column_stack([tlon.ravel(), tlat.ravel()]))
    for cutoff in (0.2, 0.6, 2.0):
        out = native.structured_weights(lon, lat, tlon.ravel(), tlat.ravel(),
                                        max_dist=cutoff, exact_dist=False)
        assert out is not None
        np.testing.assert_array_equal(out[2] > cutoff, dists > cutoff)


def test_pixel_hash_reaches_antimeridian_isolated_pixels():
    """The NN scan walks a pixel hash, not quad corners: a pixel whose
    every adjacent quad is an antimeridian-crossing skip is still the
    nearest-neighbour pick (the old corner walk could not see it)."""
    # 2-column swath straddling the antimeridian: EVERY quad wraps
    lats = np.linspace(0.0, 10.0, 8)
    lon2d = np.tile(np.array([179.5, -179.5]), (8, 1))
    lat2d = np.tile(lats[:, None], (1, 2))
    out = native.structured_weights(lon2d, lat2d,
                                    np.array([-179.4]), np.array([5.0]))
    assert out is not None
    idx, w, dist, nn, ok = out
    # nearest pixel is in the -179.5 column at lat ~5.0 (flat ids 1,3,5..)
    assert nn[0] % 2 == 1
    assert dist[0] < 0.8


def test_bbox_far_rejection_reports_past_cutoff():
    """Targets farther than max_dist outside the swath bbox skip the ring
    scan entirely but must still land on the far side of the cutoff (and
    inside-bbox results must be unaffected)."""
    lon, lat = swath()
    t_far = (np.array([60.0, -45.0, 0.0]), np.array([37.0, 37.0, 80.0]))
    out = native.structured_weights(lon, lat, t_far[0], t_far[1],
                                    max_dist=0.6)
    assert out is not None
    _, _, dist, _, ok = out
    assert (dist > 0.6).all() and not ok.any()


def test_nearest_mode_matches_kdtree():
    """Native nearest mode (methods 2/4) picks the same pixel as scipy's
    cKDTree query away from exact ties."""
    from scipy.spatial import cKDTree

    lon, lat = swath(seed=3)
    tlon, tlat = targets()
    tree = cKDTree(np.column_stack([lon.ravel(), lat.ravel()]))
    dists, nn_scipy = tree.query(np.column_stack([tlon.ravel(), tlat.ravel()]))
    sp = build_plan_structured(lon, lat, tlon, tlat, threshold=0.3, method=4)
    assert sp is not None and sp.k == 1
    # picks are exact within the far-mask cutoff (the search stops early
    # beyond it — those targets are masked and their pick is unused)
    near = dists <= 2.0 * 0.3
    np.testing.assert_array_equal(sp.idx[near, 0], nn_scipy[near])
    # and applying the plan equals the gather scipy would do
    z = np.sin(lon * 0.7).ravel()
    out = np.asarray(apply_plan(sp, z)).ravel()
    m = np.isfinite(out)
    far = dists > 2.0 * 0.3
    np.testing.assert_array_equal(m, ~far)
    np.testing.assert_allclose(out[m], z[nn_scipy][m], rtol=0, atol=0)


def test_speedup_over_delaunay():
    lon, lat = swath(400, 60, seed=1)
    tlon, tlat = targets()
    t0 = time.perf_counter()
    sp = build_plan_structured(lon, lat, tlon, tlat, threshold=0.3)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = build_plan(lon.ravel(), lat.ravel(), tlon, tlat, method=1, threshold=0.3)
    t_scipy = time.perf_counter() - t0
    print(f"native {t_native*1e3:.1f} ms vs scipy {t_scipy*1e3:.1f} ms")
    assert sp is not None and dp is not None
    assert t_native < t_scipy  # typically 5-20x faster


def test_regrid_granule_fast_swath():
    from tests.test_pipeline import ctm_grid, synthetic_granule
    from oisat.regridder import regrid_granule

    def smooth(seed=0):
        g = synthetic_granule(seed, 4)
        g.vcd = np.sin(g.longitude_center / 3.0) * np.cos(g.latitude_center / 5.0) + 2.0
        return g

    clon, clat = ctm_grid()
    slow = regrid_granule(1, 0.25, smooth(), clon, clat, flag_thresh=0.5, fast_swath=False)
    fast = regrid_granule(1, 0.25, smooth(), clon, clat, flag_thresh=0.5, fast_swath=True)
    assert fast is not None
    m = np.isfinite(slow.vcd) & np.isfinite(fast.vcd)
    assert m.sum() > 50
    np.testing.assert_allclose(fast.vcd[m], slow.vcd[m], atol=1e-3, rtol=1e-3)


def test_regrid_ssmis_fast_matches_parity():
    """SSMIS granules are full regular global grids — the heaviest qhull
    triangulation in the pipeline; the structured fast path (default-on)
    must agree with the Delaunay parity path."""
    from oisat.datamodel import satellite_ssmis
    from oisat.regridder import regrid_ssmis_granule

    lat = np.arange(-89.5, 90, 1.0)
    lon = np.arange(-179.5, 180, 1.0)
    lon2, lat2 = np.meshgrid(lon, lat)
    vcd = 20 + 5 * np.sin(lon2 / 20.0) * np.cos(lat2 / 15.0)

    def g():
        return satellite_ssmis(vcd=vcd.copy(), uncertainty=np.full(lat2.shape, 1.0),
                               time=None, latitude_center=lat2, longitude_center=lon2,
                               ctm_upscaled_needed=False, ctm_vcd=[], sensor="SSMIS")

    clon2, clat2 = np.meshgrid(np.arange(-20.0, 10.0, 2.0), np.arange(20.0, 60.0, 2.0))
    fast = regrid_ssmis_granule(1.0, g(), clon2, clat2, fast_swath=True, dtype=np.float64)
    parity = regrid_ssmis_granule(1.0, g(), clon2, clat2, fast_swath=False, dtype=np.float64)
    a, b = np.asarray(fast.vcd), np.asarray(parity.vcd)
    both = np.isfinite(a) & np.isfinite(b)
    assert both.sum() > 100
    np.testing.assert_allclose(a[both], b[both], rtol=2e-3, atol=2e-2)
    assert (np.isfinite(a) ^ np.isfinite(b)).mean() < 0.02


def test_upscaler_cache_reuse_and_bound():
    import oisat.regridder as R

    R._upscaler_cache.clear()
    src_lon, src_lat = np.meshgrid(np.arange(-10, 10, 0.1), np.arange(30, 45, 0.1))
    tgt_lon, tgt_lat = np.meshgrid(np.arange(-10, 10, 0.5), np.arange(30, 45, 0.5))
    u1 = R.make_upscaler(src_lon, src_lat, tgt_lon, tgt_lat, 0.1, 0.7)
    u2 = R.make_upscaler(src_lon, src_lat, tgt_lon, tgt_lat, 0.1, 0.7)
    assert u1 is u2  # cache hit for the repeated geometry
    for k in range(R._upscaler_cache.maxsize + 5):
        R.make_upscaler(src_lon + 0.001 * (k + 1), src_lat, tgt_lon, tgt_lat, 0.1, 0.7)
        assert len(R._upscaler_cache) <= R._upscaler_cache.maxsize


def test_native_antimeridian_quads_do_not_claim_local_targets():
    """A quad crossing the antimeridian spans ~360 deg of unwrapped lon;
    its sliver triangles overlap the swath elsewhere and must NOT be used
    for interpolation (Delaunay is a partition, quad triangles are not) —
    wrapped quads are skipped, local pixels win."""
    from oisat.ops.weights import build_plan_structured

    lats = np.linspace(0.0, 10.0, 12)
    lon_cols = np.array([-1.0, 1.0, 179.0, -179.0])  # last pair wraps
    lon2d = np.tile(lon_cols, (12, 1))
    lat2d = np.tile(lats[:, None], (1, 4))
    tlon, tlat = np.meshgrid(np.array([0.0]), np.linspace(1.0, 9.0, 7))
    plan = build_plan_structured(lon2d, lat2d, tlon, tlat, threshold=3.0,
                                 method=1)
    assert plan is not None
    m = ~np.asarray(plan.mask)
    assert m.any()  # local targets are inside the (-1, 1) column pair
    cols = np.asarray(plan.idx)[m] % 4
    assert set(np.unique(cols).tolist()) <= {0, 1}, (
        "antimeridian sliver claimed a local target")
