import numpy as np
import jax.numpy as jnp
import pytest

from oisat.ops.covariance import build_covariance, build_covariance_reference
from oisat.ops.oi import oi
from oisat.ops.oi_full import oi_full


def test_covariance_matches_reference():
    rng = np.random.default_rng(0)
    n = 256
    lat = rng.uniform(20, 60, n)
    lon = rng.uniform(-130, -60, n)
    sig = np.abs(rng.normal(1.5, 0.3, n))
    ref = build_covariance_reference(lat, lon, sig, 300.0)
    got = np.asarray(build_covariance(lat, lon, sig, 300.0))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6)
    # symmetric with sigma^2 on the diagonal
    np.testing.assert_allclose(got, got.T, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(got), sig**2, rtol=2e-6)


def test_oi_full_zero_length_matches_diagonal():
    """L -> 0 turns B diagonal: the full solve must agree with the scalar
    per-cell update at the same (unit) regularization."""
    rng = np.random.default_rng(3)
    H, W = 12, 16
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = np.abs(rng.normal(3, 1, (H, W)))
    sigb = np.abs(rng.normal(1.0, 0.2, (H, W)))
    sigo = np.abs(rng.normal(0.6, 0.1, (H, W)))
    xa[0, 0] = np.nan  # a missing cell
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 45, H))
    res = oi_full(xa, y, sigb, sigo, lat, lon, length_scale_km=1e-3)
    ref = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sigb**2), jnp.asarray(sigo**2),
             regularization_on=False)
    m = np.isfinite(np.asarray(ref.xb)) & np.isfinite(res.xb)
    assert m.sum() > 100
    np.testing.assert_allclose(res.xb[m], np.asarray(ref.xb)[m], rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(res.averaging_kernel[m], np.asarray(ref.averaging_kernel)[m],
                               rtol=2e-3, atol=2e-4)
    assert np.isnan(res.xb[0, 0])


def test_oi_full_spreads_information():
    """With a long correlation length, a single observation must update
    neighbouring cells (the defining upgrade over the diagonal OI)."""
    H, W = 8, 16
    lon, lat = np.meshgrid(np.linspace(0, 15, W), np.linspace(40, 47, H))
    xa = np.full((H, W), 2.0)
    y = np.full((H, W), np.nan)
    y[4, 8] = 4.0  # one observation
    sigb = np.full((H, W), 1.0)
    sigo = np.full((H, W), 0.1)
    # only the observed cell is "valid": NaN y elsewhere is compacted out,
    # so build a variant where y is observed everywhere but informative in
    # one cell (tight obs error there, huge elsewhere)
    y2 = np.full((H, W), 2.0)
    y2[4, 8] = 4.0
    sigo2 = np.full((H, W), 1e3)
    sigo2[4, 8] = 0.1
    res = oi_full(xa, y2, sigb, sigo2, lat, lon, length_scale_km=200.0)
    assert res.xb[4, 8] > 3.5  # strong local update
    assert res.xb[4, 9] > 2.2  # neighbour pulled up through B
    assert abs(res.xb[0, 0] - 2.0) < 0.2  # far cells barely move
    res0 = oi_full(xa, y2, sigb, sigo2, lat, lon, length_scale_km=1e-3)
    assert abs(res0.xb[4, 9] - 2.0) < 1e-3  # diagonal B: no spread


def test_oi_full_all_nan():
    nanf = np.full((4, 8), np.nan)
    res = oi_full(nanf, nanf, nanf, nanf, nanf, nanf, 100.0)
    assert np.isnan(res.xb).all()


def test_oi_full_scan_diagonal_limit_matches_scalar():
    """L -> 0 with the regularization scan must reproduce the scalar OI's
    curve, knee choice and fields."""
    rng = np.random.default_rng(11)
    H, W = 10, 13
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = np.abs(rng.normal(3, 1, (H, W)))
    sigb = np.abs(rng.normal(1.0, 0.2, (H, W)))
    sigo = np.abs(rng.normal(0.6, 0.1, (H, W)))
    res = oi_full(xa, y, sigb, sigo, np.zeros((H, W)) + np.linspace(30, 45, H)[:, None],
                  np.zeros((H, W)) + np.linspace(-10, 10, W)[None, :],
                  length_scale_km=1e-3, regularization_on=True)
    ref = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sigb**2), jnp.asarray(sigo**2),
             regularization_on=True)
    m = np.isfinite(res.xb) & np.isfinite(np.asarray(ref.xb))
    assert m.sum() > 100
    np.testing.assert_allclose(res.xb[m], np.asarray(ref.xb)[m], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(res.averaging_kernel[m], np.asarray(ref.averaging_kernel)[m],
                               rtol=5e-3, atol=5e-3)


def test_oi_full_scan_spreads_and_regularizes():
    H, W = 8, 16
    lon, lat = np.meshgrid(np.linspace(0, 15, W), np.linspace(40, 47, H))
    xa = np.full((H, W), 2.0)
    y2 = np.full((H, W), 2.0)
    y2[4, 8] = 4.0
    sigb = np.full((H, W), 1.0)
    sigo2 = np.full((H, W), 1e3)
    sigo2[4, 8] = 0.1
    res = oi_full(xa, y2, sigb, sigo2, lat, lon, length_scale_km=200.0,
                  regularization_on=True)
    assert res.xb[4, 8] > 3.0
    assert res.xb[4, 9] > 2.1  # neighbour updated through B


def _random_domain(H, W, seed=5, lat0=30.0, lat1=45.0, lon0=-20.0, lon1=10.0):
    rng = np.random.default_rng(seed)
    lon, lat = np.meshgrid(np.linspace(lon0, lon1, W), np.linspace(lat0, lat1, H))
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = xa * rng.uniform(0.8, 1.3, (H, W))
    sigb = np.abs(rng.normal(1.0, 0.2, (H, W)))
    sigo = np.abs(rng.normal(0.6, 0.1, (H, W)))
    return xa, y, sigb, sigo, lat, lon


def test_matfree_matches_dense():
    """The matrix-free CG + colored-probing path must reproduce the dense
    blocked-Cholesky solve (VERDICT r1 item 6): xb to CG tolerance, the
    posterior diagonal to the probing cross-term bound."""
    from oisat.ops.oi_full import oi_full_dense, oi_full_matfree

    H, W = 16, 16  # 256 cells: dense is exact ground truth here
    xa, y, sigb, sigo, lat, lon = _random_domain(H, W)
    import jax.numpy as jnp

    f = lambda a: jnp.asarray(a.ravel(), jnp.float32)
    ref = oi_full_dense(f(xa), f(y), f(sigb), f(sigo), f(lat), f(lon),
                        length_scale_km=300.0)
    got_xb, got_ak, got_inc, got_err, info = oi_full_matfree(
        xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(),
        lat.ravel(), lon.ravel(), 300.0, block=256, cg_tol=1e-7,
        probe_sep_factor=6.0)  # 6 sigma separation: cross-terms ~1e-8
    assert info["cg_resid"] < 1e-6
    np.testing.assert_allclose(got_xb, np.asarray(ref[0], np.float64), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_inc, np.asarray(ref[2], np.float64), rtol=0, atol=5e-4)
    np.testing.assert_allclose(got_ak, np.asarray(ref[1], np.float64), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got_err, np.asarray(ref[3], np.float64), rtol=0, atol=2e-3)
    # production default (4 sigma): documented ~3e-4 kernel-scale bound
    _, ak4, _, err4, _ = oi_full_matfree(
        xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(),
        lat.ravel(), lon.ravel(), 300.0, block=256, cg_tol=1e-7)
    np.testing.assert_allclose(err4, np.asarray(ref[3], np.float64), rtol=0, atol=1e-2)


def test_oi_full_auto_switches_to_matfree(monkeypatch):
    """Above DENSE_MAX_CELLS the grid front end must route to the
    matrix-free branch and produce the same analysis (NaN handling and
    scatter-back included)."""
    import oisat.ops.oi_full as mod

    H, W = 20, 26
    xa, y, sigb, sigo, lat, lon = _random_domain(H, W, seed=9)
    xa[3, 4] = np.nan
    y[10, 20] = np.nan
    ref = mod.oi_full(xa, y, sigb, sigo, lat, lon, length_scale_km=250.0)
    monkeypatch.setattr(mod, "DENSE_MAX_CELLS", 64)  # force the large branch
    got = mod.oi_full(xa, y, sigb, sigo, lat, lon, length_scale_km=250.0)
    m = np.isfinite(ref.xb)
    np.testing.assert_array_equal(m, np.isfinite(got.xb))
    np.testing.assert_allclose(got.xb[m], ref.xb[m], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got.error[m], ref.error[m], rtol=0, atol=3e-3)
    assert np.isnan(got.xb[3, 4]) and np.isnan(got.xb[10, 20])


def test_oi_full_matfree_with_regularization(monkeypatch):
    """The large branch with the regularization scan: the knee is picked on
    a dense subsample (here the subsample covers the whole domain, so the
    choice is exact) and the chosen factor scales B in the CG solve."""
    import oisat.ops.oi_full as mod

    H, W = 16, 16
    xa, y, sigb, sigo, lat, lon = _random_domain(H, W, seed=13)
    ref = mod.oi_full(xa, y, sigb, sigo, lat, lon, length_scale_km=250.0,
                      regularization_on=True)
    monkeypatch.setattr(mod, "DENSE_SCAN_MAX_CELLS", 64)
    got = mod.oi_full(xa, y, sigb, sigo, lat, lon, length_scale_km=250.0,
                      regularization_on=True)
    m = np.isfinite(ref.xb)
    # on a 256-cell domain the SLQ trace noise (~5% at the default 8
    # probes; 16x tighter at production sizes) can shift the knee by one
    # grid step, moving xb by ~1%; the tight curve check is
    # test_slq_curve_matches_dense_scan
    np.testing.assert_allclose(got.xb[m], ref.xb[m], rtol=5e-2, atol=1e-2)
    # diagonal at the default 4-sigma probe separation: ~1e-2 bound
    np.testing.assert_allclose(got.error[m], ref.error[m], rtol=0, atol=3e-2)


def test_regularized_midsize_routes_matrix_free(monkeypatch):
    """Between DENSE_SCAN_MAX_CELLS and DENSE_MAX_CELLS the REGULARIZED
    solve must take the matrix-free branch: the dense 99-factor eigen
    scan holds several N^2 eigh workspaces, so its limit sits under the
    Cholesky-only dense limit."""
    import oisat.ops.oi_full as mod

    H, W = 16, 16
    xa, y, sigb, sigo, lat, lon = _random_domain(H, W, seed=21)
    calls = []
    real = mod._oi_full_large

    def spy(*a, **kw):
        calls.append(a[8] if len(a) > 8 else kw.get("regularization_on"))
        return real(*a, **kw)

    monkeypatch.setattr(mod, "_oi_full_large", spy)
    monkeypatch.setattr(mod, "DENSE_SCAN_MAX_CELLS", 64)
    # regularized: routed to the large branch despite n < DENSE_MAX_CELLS
    mod.oi_full(xa, y, sigb, sigo, lat, lon, 250.0, regularization_on=True)
    assert len(calls) == 1
    # unregularized at the same size: the Cholesky dense path is safe
    mod.oi_full(xa, y, sigb, sigo, lat, lon, 250.0, regularization_on=False)
    assert len(calls) == 1


def test_distance_coloring_separation():
    from oisat.ops.covariance import EARTH_RADIUS_KM
    from oisat.ops.oi_full import _distance_coloring

    rng = np.random.default_rng(17)
    lat = rng.uniform(30, 50, 500)
    lon = rng.uniform(-30, 10, 500)
    sep = 500.0
    rep, colors = _distance_coloring(lat, lon, sep, cluster_radius_km=10.0)
    # representatives cover everyone; members point at a representative
    assert (rep >= 0).all()
    assert (colors[rep] >= 0).all()
    # same-color representatives must be >= sep apart (chordal) — the
    # guarantee is never relaxed (no color capping)
    latr, lonr = np.deg2rad(lat), np.deg2rad(lon)
    pts = np.column_stack([np.cos(latr) * np.cos(lonr),
                           np.cos(latr) * np.sin(lonr), np.sin(latr)])
    for c in range(colors.max() + 1):
        p = pts[colors == c]
        if len(p) < 2:
            continue
        d = np.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1) * EARTH_RADIUS_KM
        np.fill_diagonal(d, np.inf)
        assert d.min() >= sep * 0.999
    # members sit within the cluster radius of their representative
    dmem = np.linalg.norm(pts - pts[rep], axis=-1) * EARTH_RADIUS_KM
    assert dmem.max() <= 10.0 * 1.001


def test_matfree_polar_crowding_no_negative_variance():
    """Regression for the capped-coloring bug: on a high-latitude band of a
    1-degree grid, thousands of cells crowd within the probe separation.
    Uncapped chunked coloring + cluster representatives must keep the
    posterior variance physical (0 <= Sb <= Bd, i.e. 0 <= AK <= 1) instead
    of collapsing err to 0 / AK > 1."""
    from oisat.ops.oi_full import oi_full_matfree

    lat1 = np.arange(76.5, 90.0, 1.0)
    lon1 = np.arange(-179.0, 180.0, 2.0)
    lon, lat = np.meshgrid(lon1, lat1)
    rng = np.random.default_rng(23)
    shape = lat.shape
    xa = np.abs(rng.normal(3, 1, shape))
    y = xa * rng.uniform(0.8, 1.3, shape)
    sigb = np.abs(rng.normal(1.0, 0.2, shape))
    sigo = np.abs(rng.normal(0.6, 0.1, shape))
    xb, ak, inc, err, info = oi_full_matfree(
        xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(),
        lat.ravel(), lon.ravel(), 300.0, block=512, cg_maxiter=300)
    assert info["nreps"] < lat.size  # clusters actually formed at the pole
    assert np.isfinite(xb).all()
    # physical posterior: quad never exceeds the prior variance by more
    # than the documented probe/cluster error bounds
    assert (ak > -0.05).all() and (ak < 1.05).all()
    assert (err >= 0).all()
    # and the posterior error must be strictly informative where obs are
    # much tighter than the prior
    tight = (sigo < 0.5 * sigb.ravel().reshape(shape)).ravel()
    assert (err[tight] < sigb.ravel()[tight]).mean() > 0.9

def test_slq_curve_matches_dense_scan():
    """The stochastic-Lanczos-quadrature mean-AK curve (the matrix-free
    path's regularization engine) must match the dense eigendecomposition
    curve on a small domain, and pick the same knee."""
    import jax.numpy as jnp

    from oisat.ops.knee import kneedle_index_np
    from oisat.ops.oi import regularization_grid
    from oisat.ops.oi_full import mean_ak_curve_slq, oi_full_dense_scan

    H, W = 16, 16
    xa, y, sigb, sigo, lat, lon = _random_domain(H, W, seed=5)
    f = lambda a: jnp.asarray(a.ravel(), jnp.float32)
    regs = regularization_grid().astype(np.float32)
    *_, reg_index, curve = oi_full_dense_scan(f(xa), f(y), f(sigb), f(sigo),
                                              f(lat), f(lon), 300.0, regs)
    # block=192 does not divide 256 cells: exercises the self-padding
    c_slq = mean_ak_curve_slq((lat.ravel(), lon.ravel()), sigb.ravel(),
                              sigo.ravel(), regularization_grid(), 300.0,
                              block=192, n_probes=64, m=40, seed=1)
    cd = np.asarray(curve, np.float64)
    # trace-estimator noise ~1/sqrt(K*N_eff): ~2% here (K=64, 256 cells);
    # at production sizes (64k cells) the same K is ~16x tighter
    np.testing.assert_allclose(c_slq, cd, rtol=0.04)
    assert kneedle_index_np(regularization_grid(), c_slq) == int(reg_index)


def test_oi_full_physical_vcd_magnitudes_no_overflow():
    """Total-ozone-scale fields (~8e18 molec/cm2) must not overflow the f32
    intermediates of the dense scan: inputs are normalized to O(1) and the
    outputs rescaled (the update is scale-equivariant)."""
    rng = np.random.default_rng(0)
    H, W = 12, 16
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 41, H))
    xa = np.abs(rng.normal(8e18, 5e17, (H, W)))
    y = xa * rng.uniform(0.9, 1.1, (H, W))
    sigma_b = xa * 0.5
    sigma_o = np.abs(rng.normal(5e16, 5e15, (H, W)))
    res = oi_full(xa, y, sigma_b, sigma_o, lat, lon, 200.0,
                  regularization_on=True)
    assert np.isfinite(res.xb).all()
    assert np.isfinite(res.averaging_kernel).all()
    assert np.isfinite(res.error).all() and (np.asarray(res.error) > 0).all()
    assert (np.asarray(res.averaging_kernel) > 0.1).all()  # data-rich update
    # scale-equivariance: the same analysis at unit scale, times 8e18
    s = 8e18
    ref = oi_full(xa / s, y / s, sigma_b / s, sigma_o / s, lat, lon, 200.0,
                  regularization_on=True)
    np.testing.assert_allclose(res.xb, np.asarray(ref.xb) * s, rtol=1e-4)
    np.testing.assert_allclose(res.averaging_kernel, ref.averaging_kernel,
                               rtol=1e-4)


def test_oi_full_degenerate_cells_masked_not_poisoning():
    """A zero observation error or a NaN coordinate must invalidate ITS
    cell only, not NaN the whole domain through D^-1 / the covariance."""
    rng = np.random.default_rng(1)
    H, W = 10, 12
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 39, H))
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = xa * 1.1
    sigma_b = xa * 0.5
    sigma_o = np.full((H, W), 0.4)
    sigma_o[2, 3] = 0.0  # exact observation: not representable with D^-1
    lat2 = lat.copy()
    lat2[5, 7] = np.nan  # corrupt coordinate
    res = oi_full(xa, y, sigma_b, sigma_o, lat2, lon, 200.0,
                  regularization_on=True)
    bad = np.zeros((H, W), bool)
    bad[2, 3] = bad[5, 7] = True
    assert np.isnan(np.asarray(res.xb)[bad]).all()
    assert np.isfinite(np.asarray(res.xb)[~bad]).all()
    assert np.isfinite(np.asarray(res.averaging_kernel)[~bad]).all()


def test_matfree_nystrom_tight_obs_converges():
    """The production full-covariance regime: monthly-average observation
    errors ~100x tighter than the prior push cond(A) to ~1e7, where
    Jacobi-preconditioned f32 CG diverges (measured on the round-4 fused
    oi_method=full month: resid 0.15-5.9, silently biased fields).  The
    randomized-Nystrom deflation preconditioner + min-residual iterate
    must deliver (a) a small reported residual, (b) a near-exact
    averaging kernel, and (c) increments at the f32 matvec noise floor
    (a few percent RMS), all validated against the f64 dense solve."""
    from oisat.ops.oi_full import oi_full_matfree

    H, W = 16, 32
    rng = np.random.default_rng(5)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(0.1, 0.2, (H, W))).ravel()
    sb = 0.5 * xa
    so = np.full(H * W, 0.0027)  # sb/so ~ 150: the production conditioning

    # f64 ground truth (dense, small domain)
    latr, lonr = np.deg2rad(lat.ravel()), np.deg2rad(lon.ravel())
    u3 = np.stack([np.cos(latr) * np.cos(lonr),
                   np.cos(latr) * np.sin(lonr), np.sin(latr)], 1)
    kappa = (6371.0 / 300.0) ** 2
    B = sb[:, None] * np.exp(kappa * ((u3 @ u3.T) - 1.0)) * sb[None, :]
    A = B + np.diag(so ** 2)
    inc_t = B @ np.linalg.solve(A, y - xa)
    Sb_t = np.einsum("ij,ji->i", B, np.linalg.solve(A, B))
    ak_t = 1.0 - (sb ** 2 - Sb_t) / sb ** 2

    xb, ak, inc, err, info = oi_full_matfree(
        xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0, block=512,
        precond="nystrom", nystrom_k=256)
    # production sizes route the exact direct tail (device or host f64)
    assert info["precond"] == "direct" and info["exact_diag"]
    assert info["cg_resid"] < 1e-3
    rms = np.sqrt(np.mean((inc - inc_t) ** 2)) / np.sqrt(np.mean(inc_t ** 2))
    assert rms < 0.05
    np.testing.assert_allclose(ak, ak_t, atol=2e-4)
    # the posterior diagonal is now EXACT (diag(Sb) = so2 - so4 diag(A^-1))
    np.testing.assert_allclose(err, np.sqrt(np.maximum(sb**2 - Sb_t, 0)),
                               rtol=1e-6, atol=1e-10)

    # the PCG + Woodbury machinery (the beyond-REFINE_MAX path) must still
    # deliver the documented estimates when refinement is pinned off
    xb2, ak2, inc2, err2, info2 = oi_full_matfree(
        xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0, block=512,
        precond="nystrom", nystrom_k=256, refine=0)
    assert info2["precond"].startswith("nystrom") and not info2["exact_diag"]
    np.testing.assert_allclose(ak2, ak_t, atol=2e-4)
    assert (err2 >= 0).all() and (err2 <= sb * (1 + 1e-6)).all()
    assert np.median(err2) < 5 * np.median(np.sqrt(np.maximum(sb**2 - Sb_t, 0)))


def test_matfree_nystrom_auto_threshold():
    """auto picks Nystrom at NYSTROM_MIN_CELLS and Jacobi below."""
    import oisat.ops.oi_full as mod

    H, W = 8, 16
    xa, y, sigb, sigo, lat, lon = _random_domain(H, W, seed=3)
    _, _, _, _, info = mod.oi_full_matfree(
        xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(),
        lat.ravel(), lon.ravel(), 300.0, block=128)
    assert info["precond"] == "jacobi"
    # refine=0 pins the iterative path so the preconditioner choice shows
    # (refine="auto" takes the exact direct tail at this size)
    _, _, _, _, info = mod.oi_full_matfree(
        xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(),
        lat.ravel(), lon.ravel(), 300.0, block=128, precond="nystrom",
        nystrom_k=128, refine=0)
    assert info["precond"] == "nystrom(k=128)"


def test_matfree_nystrom_cholesky_fallback(monkeypatch):
    """If f32 noise ever tips the Woodbury inner matrix I + PSD indefinite,
    the host Cholesky raises and the eigen-clip fallback must produce the
    same posterior diagonal (same S^1/2 up to an orthogonal factor, which
    the row-norm diagonal cannot see) instead of crashing the month."""
    import scipy.linalg
    from oisat.ops.oi_full import oi_full_matfree

    H, W = 8, 16
    xa, y, sigb, sigo, lat, lon = _random_domain(H, W, seed=7)
    args = (xa.ravel(), y.ravel(), sigb.ravel(), sigo.ravel(),
            lat.ravel(), lon.ravel(), 300.0)
    # refine=0 pins the PCG + Woodbury path (refine="auto" would take the
    # exact direct tail, which never touches this Cholesky)
    kw = dict(block=128, precond="nystrom", nystrom_k=128, refine=0)
    _, ak_ref, inc_ref, err_ref, _ = oi_full_matfree(*args, **kw)

    real_chol = scipy.linalg.cholesky

    def boom(*a, **k):
        raise np.linalg.LinAlgError("forced indefinite for the test")

    monkeypatch.setattr(scipy.linalg, "cholesky", boom)
    _, ak_fb, inc_fb, err_fb, info = oi_full_matfree(*args, **kw)
    assert info["precond"] == "nystrom(k=128)"
    np.testing.assert_allclose(ak_fb, ak_ref, atol=1e-5)
    np.testing.assert_allclose(err_fb, err_ref, atol=1e-5)
    np.testing.assert_allclose(inc_fb, inc_ref, rtol=0, atol=1e-6)
    monkeypatch.setattr(scipy.linalg, "cholesky", real_chol)


def test_matfree_refinement_beats_f32_representation_wall():
    """An f32-CONVERGED matrix-free solve still misses the f64 increment by
    percents-to-tens-of-percents at monthly-average conditioning
    (sb/so ~ 300): the ~1 ulp RELATIVE error of the f32 kernel elements is
    an operator perturbation amplified by cond(A).  Mixed-precision
    iterative refinement (f64 host residual + f32 device correction
    solves) contracts ~10x per pass; two passes must land well under 1%
    and the reported residual must be the TRUE-operator f64 residual."""
    from oisat.ops.oi_full import oi_full_matfree

    H, W = 16, 32
    rng = np.random.default_rng(5)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(0.9, 1.2, (H, W))).ravel()
    sb = 0.5 * xa
    so = np.full(H * W, 0.5 / 300.0 * 0.8)  # sb/so ~ 300

    latr, lonr = np.deg2rad(lat.ravel()), np.deg2rad(lon.ravel())
    u3 = np.stack([np.cos(latr) * np.cos(lonr),
                   np.cos(latr) * np.sin(lonr), np.sin(latr)], 1)
    kappa = (6371.0 / 300.0) ** 2
    B = sb[:, None] * np.exp(kappa * ((u3 @ u3.T) - 1.0)) * sb[None, :]
    inc_t = B @ np.linalg.solve(B + np.diag(so ** 2), y - xa)
    rms_t = np.sqrt(np.mean(inc_t ** 2))

    def rms(p):
        _, _, inc, _, info = oi_full_matfree(
            xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0, block=128,
            precond="nystrom", nystrom_k=256, refine=p)
        return np.sqrt(np.mean((inc - inc_t) ** 2)) / rms_t, info

    r0, info0 = rms(0)
    r2, info2 = rms(2)
    # even at refine=0 the returned x is verified against the f64 operator
    # by row sampling, so the reported residual is honest (the f32 CG
    # residual understates it by orders at this conditioning)
    assert info0["refine_passes"] == 0 and info0["f64_resid"] > 1e-3
    assert info2["refine_passes"] == 2
    assert info2["f64_resid"] == info2["cg_resid"]  # true residual reported
    assert r2 < 5e-3
    assert r2 < r0 / 5  # refinement contracted the representation error


def test_matfree_direct_f64_exact_at_production_size():
    """refine='auto' at production-month sizes routes the innovation solve
    to the host f64 direct factor: increments must match the dense f64
    reference at the f64 backward-error floor even at the extreme
    monthly-average conditioning where every f32 iterative path stalls."""
    from oisat.ops.oi_full import oi_full_matfree

    H, W = 16, 32
    rng = np.random.default_rng(5)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(0.9, 1.2, (H, W))).ravel()
    sb = 0.5 * xa
    so = np.full(H * W, 0.5 / 300.0 * 0.8)  # sb/so ~ 300

    latr, lonr = np.deg2rad(lat.ravel()), np.deg2rad(lon.ravel())
    u3 = np.stack([np.cos(latr) * np.cos(lonr),
                   np.cos(latr) * np.sin(lonr), np.sin(latr)], 1)
    kappa = (6371.0 / 300.0) ** 2
    B = sb[:, None] * np.exp(kappa * ((u3 @ u3.T) - 1.0)) * sb[None, :]
    inc_t = B @ np.linalg.solve(B + np.diag(so ** 2), y - xa)

    _, _, inc, _, info = oi_full_matfree(
        xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0, block=128,
        precond="nystrom", nystrom_k=256)
    # default: the DEVICE exact tail (true f64 on the CPU backend)
    assert info["solver"] == "direct_f64_dev" and info["exact_diag"]
    # row-sampled f64 residual estimate: f64 backward-error floor
    assert info["f64_resid"] == info["cg_resid"] < 1e-7
    rms = np.sqrt(np.mean((inc - inc_t) ** 2)) / np.sqrt(np.mean(inc_t ** 2))
    assert rms < 1e-6


def test_matfree_direct_host_fallback_exact(monkeypatch):
    """OISAT_EXACT_DEVICE=0 (and any device-exact failure) falls back to
    the host f64 direct solve, which must now also deliver the EXACT
    posterior diagonal/AK from its own factor (dtrtri route)."""
    from oisat.ops.oi_full import oi_full_matfree

    H, W = 16, 32
    rng = np.random.default_rng(5)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(0.9, 1.2, (H, W))).ravel()
    sb = 0.5 * xa
    so = np.full(H * W, 0.5 / 300.0 * 0.8)

    latr, lonr = np.deg2rad(lat.ravel()), np.deg2rad(lon.ravel())
    u3 = np.stack([np.cos(latr) * np.cos(lonr),
                   np.cos(latr) * np.sin(lonr), np.sin(latr)], 1)
    kappa = (6371.0 / 300.0) ** 2
    B = sb[:, None] * np.exp(kappa * ((u3 @ u3.T) - 1.0)) * sb[None, :]
    A = B + np.diag(so ** 2)
    inc_t = B @ np.linalg.solve(A, y - xa)
    Sb_t = np.einsum("ij,ji->i", B, np.linalg.solve(A, B))
    err_t = np.sqrt(np.maximum(sb ** 2 - Sb_t, 0.0))

    monkeypatch.setenv("OISAT_EXACT_DEVICE", "0")
    _, ak, inc, err, info = oi_full_matfree(
        xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0, block=128,
        precond="nystrom", nystrom_k=256)
    assert info["solver"] == "direct_f64" and info["exact_diag"]
    rms = np.sqrt(np.mean((inc - inc_t) ** 2)) / np.sqrt(np.mean(inc_t ** 2))
    assert rms < 1e-6
    np.testing.assert_allclose(err, err_t, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(ak, 1.0 - (sb**2 - Sb_t) / sb**2,
                               rtol=1e-6, atol=1e-8)


def test_matfree_device_exact_gate_falls_back(monkeypatch):
    """A device exact tail that fails the host-f64 row-sampled residual
    gate must be DISCARDED in favor of the host direct solve (the
    VERDICT-mandated acceptance bar for emulated-f64 precision)."""
    import oisat.ops.oi_full as mod

    H, W = 16, 32
    rng = np.random.default_rng(5)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(0.9, 1.2, (H, W))).ravel()
    sb = 0.5 * xa
    so = np.full(H * W, 0.5 / 300.0 * 0.8)

    def corrupted(u3_64, sb_64, so2_64, d64, kappa):
        n = u3_64.shape[0]
        return np.ones(n), (np.ones(n), np.ones(n))  # garbage "solution"

    monkeypatch.setattr(mod, "_exact_tail_device", corrupted)
    _, _, inc, err, info = mod.oi_full_matfree(
        xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0, block=128,
        precond="nystrom", nystrom_k=256)
    assert info["solver"] == "direct_f64"  # gate rejected the device x
    assert info["exact_diag"] and info["f64_resid"] < 1e-7


def test_dense_path_exact_recompute_at_tight_conditioning():
    """The device dense solve shares the f32 representation wall: at
    sb/so ~ 300 the grid front end must re-solve the innovation exactly in
    host f64 (conditioning-gated) so small production months match the f64
    reference too."""
    from oisat.ops.oi_full import oi_full

    H, W = 8, 16  # 128 cells: dense path
    rng = np.random.default_rng(5)
    lon2, lat2 = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W)))
    y = xa * rng.uniform(0.9, 1.2, (H, W))
    sb = 0.5 * xa
    so = np.full((H, W), 0.5 / 300.0 * 0.8)

    latr, lonr = np.deg2rad(lat2.ravel()), np.deg2rad(lon2.ravel())
    u3 = np.stack([np.cos(latr) * np.cos(lonr),
                   np.cos(latr) * np.sin(lonr), np.sin(latr)], 1)
    kappa = (6371.0 / 300.0) ** 2
    B = (sb.ravel()[:, None] * np.exp(kappa * ((u3 @ u3.T) - 1.0))
         * sb.ravel()[None, :])
    inc_t = B @ np.linalg.solve(B + np.diag(so.ravel() ** 2),
                                (y - xa).ravel())

    res = oi_full(xa, y, sb, so, lat2, lon2, 300.0, regularization_on=False)
    assert res.info is not None
    assert res.info["solver"].startswith("dense+direct_f64")
    assert res.info["exact_diag"]
    rms = (np.sqrt(np.mean((res.increment.ravel() - inc_t) ** 2))
           / np.sqrt(np.mean(inc_t ** 2)))
    assert rms < 1e-6
    # err/AK replaced with the EXACT values from the same factor
    Sb_t = np.einsum("ij,ji->i", B,
                     np.linalg.solve(B + np.diag(so.ravel() ** 2), B))
    err_t = np.sqrt(np.maximum(sb.ravel() ** 2 - Sb_t, 0.0))
    np.testing.assert_allclose(res.error.ravel(), err_t, rtol=1e-6,
                               atol=1e-10)
    np.testing.assert_allclose(res.averaging_kernel.ravel(),
                               1.0 - (sb.ravel() ** 2 - Sb_t) / sb.ravel() ** 2,
                               rtol=1e-6, atol=1e-8)

    # mild conditioning keeps the pure device path (no host recompute)
    res2 = oi_full(xa, y, sb, np.full((H, W), 0.4), lat2, lon2, 300.0)
    assert res2.info is None


def test_matfree_info_scaled_to_physical_units(monkeypatch):
    """oi_full rescales resid_abs/stat_norm back to the caller's physical
    units (they are field-scaled quantities, like xb/increment/err); the
    relative cg_resid stays scale-invariant.  Pinned with a stub so the
    contract is tested without a >10k-cell matfree solve."""
    import oisat.ops.oi_full as mod

    H, W = 8, 16
    xa, y, sigb, sigo, lat2, lon2 = _random_domain(H, W, seed=9)
    scale = 1e15

    captured = {}

    def fake_large(xa_n, y_n, sb_n, so_n, lat2d, lon2d, idx, L, reg_on,
                   mesh=None, **kw):
        captured["max"] = float(np.nanmax(np.abs(xa_n)))
        shaped = np.full(np.shape(xa_n), 1.0)
        return mod.OIFullResult(shaped, shaped.copy(), shaped.copy(),
                                shaped.copy(),
                                {"cg_resid": 1e-5, "resid_abs": 2.0,
                                 "stat_norm": 3.0, "f64_resid": None})

    monkeypatch.setattr(mod, "_oi_full_large", fake_large)
    monkeypatch.setattr(mod, "DENSE_MAX_CELLS", 4)  # force the large branch
    res = mod.oi_full(xa * scale, y * scale, sigb * scale, sigo * scale,
                      lat2, lon2, 300.0)
    assert captured["max"] <= 1.0 + 1e-12  # solver saw normalized fields
    assert res.info["cg_resid"] == 1e-5           # relative: invariant
    # both field-scaled values multiplied by the SAME (field-magnitude)
    # scale, which is at least the 1e15 injected here
    assert res.info["resid_abs"] / 2.0 == res.info["stat_norm"] / 3.0
    assert res.info["resid_abs"] / 2.0 >= scale
    assert res.info["f64_resid"] is None          # None passes through


def test_exact_sb_diag_blended_forms_stable_under_emulation_noise():
    """The device tail's diagonals carry ~1e-6 relative (emulated-f64)
    error.  diag(Sb) = so2 - so4*diag(A^-1) amplifies that by (so/sb)^2
    on loose cells; the blended form must switch to bd - q there and stay
    ~eps-accurate in BOTH regimes (review finding, round 5)."""
    from oisat.ops.oi_full import _exact_sb_diag

    rng = np.random.default_rng(3)
    n = 512
    sb = np.abs(rng.normal(1.0, 0.2, n))
    # so/sb spanning 1e-3 .. 1e3: tight production cells to data-poor ones
    ratio = 10.0 ** rng.uniform(-3, 3, n)
    so2 = (sb * ratio) ** 2
    bd = sb ** 2
    # scalar ground truth (diagonal B): Sb = bd*so2/(bd+so2),
    # diag(A^-1) = 1/(bd+so2), q = bd^2/(bd+so2)
    dainv_t = 1.0 / (bd + so2)
    q_t = bd * bd / (bd + so2)
    sb_diag_t = bd * so2 / (bd + so2)
    # inject 1e-6 relative noise (the emulation's representation floor)
    eps = 1e-6
    dainv = dainv_t * (1.0 + eps * rng.standard_normal(n))
    q = q_t * (1.0 + eps * rng.standard_normal(n))

    blended = _exact_sb_diag(so2, (dainv, q), bd)
    np.testing.assert_allclose(blended, sb_diag_t, rtol=1e-4)

    # form1 alone demonstrably fails on the loose cells
    form1 = np.clip(so2 - so2 * so2 * dainv, 0.0, bd)
    loose = ratio > 30
    rel1 = np.abs(form1[loose] - sb_diag_t[loose]) / sb_diag_t[loose]
    assert np.max(rel1) > 1e-3  # the failure the blend exists to fix


@pytest.mark.parametrize("device_exact", [True, False])
def test_matfree_exact_diag_mixed_noise_regimes(device_exact, monkeypatch):
    """End-to-end validation of the blended posterior diagonal's q piece
    (diag(B A^-1 B)) on BOTH exact-tail paths: a month mixing tight
    (so << sb) and loose (so >> sb) cells must match the dense f64 golden
    on every cell — a wrong q would corrupt the loose cells outright."""
    from oisat.ops.oi_full import oi_full_matfree

    monkeypatch.setenv("OISAT_EXACT_DEVICE", "1" if device_exact else "0")
    H, W = 16, 32
    rng = np.random.default_rng(13)
    lon, lat = np.meshgrid(np.linspace(-3, 3, W), np.linspace(38, 44, H))
    xa = np.abs(rng.normal(0.8, 0.1, (H, W))).ravel()
    y = (xa.reshape(H, W) * rng.uniform(0.9, 1.2, (H, W))).ravel()
    sb = 0.5 * xa
    # so/sb spanning 1e-3 .. 1e2 across cells
    so = sb * 10.0 ** rng.uniform(-3, 2, H * W)

    latr, lonr = np.deg2rad(lat.ravel()), np.deg2rad(lon.ravel())
    u3 = np.stack([np.cos(latr) * np.cos(lonr),
                   np.cos(latr) * np.sin(lonr), np.sin(latr)], 1)
    kappa = (6371.0 / 300.0) ** 2
    B = sb[:, None] * np.exp(kappa * ((u3 @ u3.T) - 1.0)) * sb[None, :]
    A = B + np.diag(so ** 2)
    Sb_t = np.einsum("ij,ji->i", B, np.linalg.solve(A, B))
    err_t = np.sqrt(np.maximum(sb ** 2 - Sb_t, 0.0))

    _, ak, _, err, info = oi_full_matfree(
        xa, y, sb, so, lat.ravel(), lon.ravel(), 300.0, block=128,
        precond="nystrom", nystrom_k=256)
    assert info["exact_diag"]
    assert info["solver"] == ("direct_f64_dev" if device_exact
                              else "direct_f64")
    np.testing.assert_allclose(err, err_t, rtol=1e-6, atol=1e-10)
    ak_t = 1.0 - (sb ** 2 - Sb_t) / sb ** 2
    np.testing.assert_allclose(ak, ak_t, rtol=1e-6, atol=1e-8)


def test_exact_tail_prog_multiblock_matches_numpy():
    """Direct validation of _exact_tail_prog at n > diag_block so the
    trailing-sub-triangle loop's j0 > 0 branch (shrinking solves + the
    q_head row-sums left of the block) actually executes — the e2e tests
    run at a few hundred cells and never leave block 0."""
    import jax

    from oisat.ops import oi_full as M

    n = 4096  # two 2048 blocks
    rng = np.random.default_rng(21)
    lat = rng.uniform(20, 60, n)
    lon = rng.uniform(-20, 10, n)
    u3 = M._sphere_points(lat, lon)
    sb = np.abs(rng.normal(0.4, 0.05, n))
    so2 = (sb * 10.0 ** rng.uniform(-2, 2, n)) ** 2  # mixed regimes
    d = rng.normal(0, 0.1, n)
    kappa = (6371.0 / 300.0) ** 2

    with jax.enable_x64(True):
        x, dainv, q = M._exact_tail_prog(
            jnp.asarray(u3), jnp.asarray(sb), jnp.asarray(so2),
            jnp.asarray(d), jnp.float64(kappa))
    x, dainv, q = (np.asarray(v, np.float64) for v in (x, dainv, q))

    B = sb[:, None] * np.exp(
        np.maximum(kappa * (np.clip(u3 @ u3.T, -1, 1) - 1.0), -60.0)) * sb[None, :]
    A = B + np.diag(so2)
    # BLAS-backed references (a bare 3-operand einsum falls into pure-C
    # n^3 loops and takes minutes at this size); rtol 1e-6: random points
    # can land near-duplicate, locally ill-conditioning the solve a few
    # orders above the f64 floor
    AinvB = np.linalg.solve(A, B)
    np.testing.assert_allclose(x, np.linalg.solve(A, d), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(dainv, np.diag(np.linalg.inv(A)), rtol=1e-6)
    np.testing.assert_allclose(q, np.einsum("ij,ji->i", B, AinvB),
                               rtol=1e-6, atol=1e-12)


def test_covariance_any_n_matches_reference():
    """The builder takes any N (no tile-multiple rule): N = 300 is not a
    multiple of 128."""
    rng = np.random.default_rng(8)
    n = 300
    lat = rng.uniform(-60, 60, n)
    lon = rng.uniform(-180, 180, n)
    sig = np.abs(rng.normal(1.0, 0.3, n))
    sig[-7:] = 0.0  # padding cells decouple
    got = np.asarray(build_covariance(lat, lon, sig, 500.0))
    assert got.shape == (n, n)
    np.testing.assert_allclose(got, build_covariance_reference(lat, lon, sig, 500.0),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(got, got.T)
    assert not got[-7:].any() and not got[:, -7:].any()


def _tail_inputs(n=100, seed=9):
    from oisat.ops.oi_full import _sphere_points

    rng = np.random.default_rng(seed)
    u3 = _sphere_points(rng.uniform(30, 40, n), rng.uniform(-10, 0, n))
    sb = np.abs(rng.normal(1.0, 0.1, n))
    return u3, sb, (sb / 50.0) ** 2, rng.normal(0, 1, n), (6371.0 / 300.0) ** 2


def test_exact_tail_device_reraises_divisibility_guard(monkeypatch):
    """A bucket that the diagonal block does not divide is a programming
    error: the device tail raises it instead of quietly solving on host."""
    from functools import partial

    import oisat.ops.oi_full as mod

    monkeypatch.setattr(mod, "EXACT_TAIL_BUCKET", 100)
    monkeypatch.setattr(mod, "_exact_tail_prog",
                        partial(mod._exact_tail_prog, diag_block=64))
    with pytest.raises(ValueError, match="must be a multiple"):
        mod._exact_tail_device(*_tail_inputs())


def test_exact_tail_device_oom_falls_back_to_host(monkeypatch, capsys):
    import jax

    import oisat.ops.oi_full as mod

    def oom(*a, **k):
        raise jax.errors.JaxRuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate")

    monkeypatch.setattr(mod, "_exact_tail_prog", oom)
    assert mod._exact_tail_device(*_tail_inputs()) == (None, None)
    assert "out of memory" in capsys.readouterr().out


def test_exact_tail_device_other_runtime_errors_propagate(monkeypatch):
    import jax

    import oisat.ops.oi_full as mod

    def broken(*a, **k):
        raise jax.errors.JaxRuntimeError("INTERNAL: cuSolver failed")

    monkeypatch.setattr(mod, "_exact_tail_prog", broken)
    with pytest.raises(jax.errors.JaxRuntimeError, match="INTERNAL"):
        mod._exact_tail_device(*_tail_inputs())
