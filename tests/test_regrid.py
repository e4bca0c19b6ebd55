import numpy as np
import jax.numpy as jnp
import pytest
from scipy.interpolate import LinearNDInterpolator, NearestNDInterpolator, RBFInterpolator
from scipy.signal import convolve2d
from scipy.spatial import cKDTree

from oisat.ops.regrid import apply_plan, boxfilter_same_symm
from oisat.ops.weights import build_plan, fine_grid
from oisat.regridder import make_upscaler


def swath(seed=0, n=400, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-10, 10, n)
    lat = rng.uniform(30, 45, n)
    z = np.sin(lon / 3.0) * np.cos(lat / 5.0) + 0.1 * rng.standard_normal(n)
    z[rng.random(n) < nan_frac] = np.nan
    return lon, lat, z


def target_grid():
    lon = np.arange(-12, 12.5, 0.5)
    lat = np.arange(28, 47.5, 0.5)
    return np.meshgrid(lon, lat)


def test_linear_matches_scipy():
    lon, lat, z = swath()
    tlon, tlat = target_grid()
    pts = np.column_stack([lon, lat])
    ref = LinearNDInterpolator(pts, z, fill_value=np.nan)((tlon, tlat))
    tree = cKDTree(pts)
    dists, _ = tree.query(np.column_stack([tlon.ravel(), tlat.ravel()]))
    threshold = 0.5
    ref[dists.reshape(tlon.shape) > 2 * threshold] = np.nan
    plan = build_plan(lon, lat, tlon, tlat, method=1, threshold=threshold)
    got = np.asarray(apply_plan(plan, jnp.asarray(z)))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)


def test_nearest_matches_scipy():
    lon, lat, z = swath(1)
    tlon, tlat = target_grid()
    pts = np.column_stack([lon, lat])
    ref = NearestNDInterpolator(pts, z)((tlon, tlat))
    tree = cKDTree(pts)
    dists, _ = tree.query(np.column_stack([tlon.ravel(), tlat.ravel()]))
    threshold = 0.5
    ref[dists.reshape(tlon.shape) > 2 * threshold] = np.nan
    plan = build_plan(lon, lat, tlon, tlat, method=2, threshold=threshold)
    got = np.asarray(apply_plan(plan, jnp.asarray(z)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=0)


def test_rbf_matches_scipy():
    lon, lat, z = swath(2, nan_frac=0.0)
    tlon, tlat = target_grid()
    pts = np.column_stack([lon, lat])
    ref = RBFInterpolator(pts, z, neighbors=5)(
        np.column_stack([tlon.ravel(), tlat.ravel()])
    ).reshape(tlon.shape)
    plan = build_plan(lon, lat, tlon, tlat, method=3, threshold=1e9)
    got = np.asarray(apply_plan(plan, jnp.asarray(z)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-8)


def test_batched_apply_multiple_fields():
    lon, lat, z = swath(3)
    tlon, tlat = target_grid()
    plan = build_plan(lon, lat, tlon, tlat, method=1, threshold=0.5)
    zz = np.stack([z, 2 * z, z**2])
    got = np.asarray(apply_plan(plan, jnp.asarray(zz)))
    for i, zi in enumerate(zz):
        ref = np.asarray(apply_plan(plan, jnp.asarray(zi)))
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=0)


@pytest.mark.parametrize("ky,kx", [(1, 1), (3, 3), (2, 2), (4, 5), (2, 3), (5, 2)])
def test_boxfilter_matches_convolve2d(ky, kx):
    rng = np.random.default_rng(4)
    z = rng.standard_normal((37, 53))
    kernel = np.ones((ky, kx)) / (ky * kx)
    ref = convolve2d(z, kernel, boundary="symm", mode="same")
    got = np.asarray(boxfilter_same_symm(jnp.asarray(z), ky, kx))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


def test_boxfilter_error_kernel():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((20, 30)) ** 2
    kernel = np.ones((3, 2)) / (3 * 2) ** 2
    ref = convolve2d(z, kernel, boundary="symm", mode="same")
    got = np.asarray(boxfilter_same_symm(jnp.asarray(z), 3, 2, squared=True))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_boxfilter_nan_spread():
    z = np.ones((10, 10))
    z[5, 5] = np.nan
    got = np.asarray(boxfilter_same_symm(jnp.asarray(z), 3, 3))
    ref = convolve2d(z, np.ones((3, 3)) / 9, boundary="symm", mode="same")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))


def upscaler_numpy(src_lon, src_lat, z, ctm_lon, ctm_lat, grid_size, threshold, error=False):
    """NumPy replica of the reference _upscaler (interpolator.py:48-97)."""
    dlon = abs(ctm_lon[0, 0] - ctm_lon[0, 1])
    dlat = abs(ctm_lat[0, 0] - ctm_lat[1, 0])
    if not (dlon >= grid_size or dlat >= grid_size):
        return z, True
    kx = max(int(np.floor(dlon / grid_size)), 1)
    ky = max(int(np.floor(dlat / grid_size)), 1)
    denom = (ky * kx) ** 2 if error else ky * kx
    zf = convolve2d(z, np.ones((ky, kx)) / denom, boundary="symm", mode="same")
    pts = np.column_stack([src_lon.ravel(), src_lat.ravel()])
    tree = cKDTree(pts)
    dists, idx = tree.query(np.column_stack([ctm_lon.ravel(), ctm_lat.ravel()]))
    out = zf.ravel()[idx].reshape(ctm_lon.shape)
    out[dists.reshape(ctm_lon.shape) > 2 * threshold] = np.nan
    return out, False


def test_upscaler_matches_reference_semantics():
    ctm_lon, ctm_lat = np.meshgrid(np.arange(-10, 11, 1.25), np.arange(30, 46, 1.0))
    grid_size = 0.25
    flon, flat_ = fine_grid(ctm_lon, ctm_lat, grid_size)
    rng = np.random.default_rng(6)
    z = rng.standard_normal(flon.shape)
    z[rng.random(flon.shape) < 0.05] = np.nan
    threshold = np.hypot(1.25, 1.0)
    ref, needed_ref = upscaler_numpy(flon, flat_, z, ctm_lon, ctm_lat, grid_size, threshold)
    up = make_upscaler(flon, flat_, ctm_lon, ctm_lat, grid_size, threshold)
    assert up.needed == needed_ref is False
    got = np.asarray(up.apply(jnp.asarray(z)))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    # error kernel path
    ref_e, _ = upscaler_numpy(flon, flat_, z**2, ctm_lon, ctm_lat, grid_size, threshold, error=True)
    got_e = np.asarray(up.apply(jnp.asarray(z**2), error=True))
    np.testing.assert_allclose(got_e, ref_e, rtol=1e-9, atol=1e-12)


def test_upscaler_passthrough_when_model_finer():
    ctm_lon, ctm_lat = np.meshgrid(np.arange(-10, 10, 0.1), np.arange(30, 45, 0.1))
    up = make_upscaler(ctm_lon, ctm_lat, ctm_lon, ctm_lat, grid_size=1.0, threshold=1.0)
    assert up.needed is True
    z = np.ones((5, 5))
    np.testing.assert_array_equal(np.asarray(up.apply(z)), z)


def test_degenerate_swath_returns_none():
    lon = np.full(10, 5.0)  # collinear points, no hull
    lat = np.full(10, 5.0)
    tlon, tlat = target_grid()
    assert build_plan(lon, lat, tlon, tlat, method=1, threshold=0.5) is None


def test_rbf_duplicate_pixels_masked_not_garbage():
    """Duplicate pixel coordinates make the batched RBF KKT solve return
    ~1e15 weights WITHOUT raising (scipy raises LinAlgError); the residual
    check must mask those targets so finite garbage never enters a map."""
    import numpy as np

    from oisat.ops.regrid import apply_plan
    from oisat.ops.weights import build_plan

    rng = np.random.default_rng(0)
    n = 40
    lon = rng.uniform(-5, 5, n)
    lat = rng.uniform(-5, 5, n)
    lon[1] = lon[0]
    lat[1] = lat[0]  # exact duplicate (overlapping scan edge)
    tlon, tlat = np.meshgrid(np.linspace(-4, 4, 9), np.linspace(-4, 4, 9))
    plan = build_plan(lon, lat, tlon, tlat, method=3, threshold=3.0)
    assert plan is not None
    z = np.ones(n)
    z[1] = 1.001  # tiny retrieval-noise difference between the duplicates
    out = np.asarray(apply_plan(plan, z))
    finite = out[np.isfinite(out)]
    # no catastrophic values: either masked (NaN) or a sane interpolation
    assert finite.size == 0 or np.abs(finite).max() < 10.0


def test_rbf_collinear_swath_skips_granule():
    """A single-scanline (collinear) geometry must return None (the
    skip-the-granule contract) instead of raising LinAlgError."""
    import numpy as np

    from oisat.ops.weights import build_plan

    lon = np.linspace(-5, 5, 30)
    lat = np.zeros(30)  # perfectly collinear
    tlon, tlat = np.meshgrid(np.linspace(-4, 4, 5), np.linspace(-1, 1, 5))
    assert build_plan(lon, lat, tlon, tlat, method=3, threshold=3.0) is None


def test_structured_builder_rejects_mismatched_lat():
    import numpy as np

    from oisat.ops.weights import build_plan_structured

    lon = np.ones((4, 5))
    lat = np.ones((5, 4))  # transposed: documented None fallback
    tlon, tlat = np.meshgrid(np.linspace(0, 1, 3), np.linspace(0, 1, 3))
    assert build_plan_structured(lon, lat, tlon, tlat, threshold=1.0) is None


def test_pad_to_bucket_grid():
    """Bucket policy: pow2 default unchanged; sub-octave grid is monotonic,
    never below the data, aligned, and tighter than pow2."""
    from oisat.ops.regrid import pad_to_bucket

    # default = the historical power-of-two grid
    assert pad_to_bucket(1) == 1024
    assert pad_to_bucket(1024) == 1024
    assert pad_to_bucket(1025) == 2048
    assert pad_to_bucket(98640) == 131072
    # quarter-octave: worst-case ~19% padding instead of ~100%
    b = pad_to_bucket(98640, steps_per_octave=4, align=128)
    assert 98640 <= b < 98640 * 1.2
    assert b % 128 == 0
    prev = 0
    for n in range(1, 300000, 997):
        bb = pad_to_bucket(n, steps_per_octave=4, align=128)
        assert bb >= n and bb >= prev  # monotonic, covers the data
        prev = bb
    # quantized: many lengths share few buckets (compile-count bound)
    buckets = {pad_to_bucket(n, steps_per_octave=4, align=128)
               for n in range(1024, 1100000)}
    import math
    assert len(buckets) <= 4 * math.ceil(math.log2(1100000 / 1024)) + 2

    # granule-axis scale: a 60-granule month must NOT pad to 1024
    g = pad_to_bucket(60, min_size=16, steps_per_octave=4)
    assert 60 <= g <= 72


def test_pixel_bucket_escalation(monkeypatch):
    """First pixel count per coarse region gets the tight 8-step bucket
    (fixed-geometry sensors keep <=9% padded waste); later DISTINCT counts
    in the same region escalate to the coarse 4-step bucket so a
    variable-scan sensor (TEMPO truncated hours) compiles at most 2 regrid
    programs per region instead of 8 per octave."""
    from oisat import regridder
    from oisat.ops.regrid import pad_to_bucket

    monkeypatch.setattr(regridder, "_pixel_bucket_first", {})
    n1 = 98640  # OMI 1644x60
    tight = pad_to_bucket(n1, steps_per_octave=8, align=128)
    coarse = pad_to_bucket(n1, steps_per_octave=4, align=128)
    assert regridder._pixel_bucket(n1) == tight
    # the SAME count keeps its tight bucket forever (no new compile)
    assert regridder._pixel_bucket(n1) == tight
    # a different count in the same coarse region -> the coarse bucket
    n2 = n1 - 600
    assert pad_to_bucket(n2, steps_per_octave=4, align=128) == coarse
    assert regridder._pixel_bucket(n2) == coarse
    assert regridder._pixel_bucket(n2 - 32) == coarse
    # the original keeps riding its tight (already compiled) bucket
    assert regridder._pixel_bucket(n1) == tight
    # a count in a FRESH region starts tight again
    n3 = 4 * n1
    assert (regridder._pixel_bucket(n3)
            == pad_to_bucket(n3, steps_per_octave=8, align=128))
