"""Full-covariance OI: ``K = B (B + R)^-1`` with distance-decay B.

The generalization of the reference's per-cell scalar update (reference
optimal_interpolation.py assumes diagonal B and R; BASELINE.json asks for
the blocked-Cholesky solve with a distance-decay background-error
covariance).  With H = I on the analysis grid:

    A  = B + R                      (R = diag(sigma_o^2))
    w  = A^-1 (y - xa)              (Cholesky solve)
    xb = xa + B w
    Sb = B - B A^-1 B               (posterior covariance)
    AK = 1 - diag(Sb) / diag(B)     (averaging-kernel diagonal)

B is built by :func:`oisat.ops.covariance.build_covariance` (one fused
XLA elementwise loop); the factorization and solves use XLA's Cholesky and
triangular solves (``jax.scipy.linalg`` / ``jax.lax.linalg``).  Every f32
matrix product here runs at ``Precision.HIGHEST``: at the default
precision a GPU may run f32 products in TF32 (10-bit mantissa), which the
conditioning below turns into O(1) increment errors.  Setting
``length_scale_km -> 0`` recovers the reference's diagonal update exactly.

Missing cells (NaN) are compacted out on host; valid cells are padded to a
multiple of 128 with ``sigma_b = 0`` / ``sigma_o = 1`` rows, which decouple
from the solve.

f32 accuracy wall and its repair (measured against full float64 dense
solves): kernel-element rounding (exp at ~1 ulp RELATIVE) is an
operator perturbation whose solution effect scales with
cond_eff ~ (sigma_b/sigma_o)^2 x local obs density — an f32-CONVERGED
CG increment can still sit 10-25% from the f64 solution at
monthly-average conditioning (sigma_b/sigma_o ~ 150-300), invisibly to
the f32 residual, and mixed-precision iterative refinement against the
true kernel stalls once its correction RHS concentrates in the modes
the f32 inner solve cannot resolve (measured: frozen at 4.6e-3 on the
bench month).  The matfree Nystrom path therefore solves the
innovation system EXACTLY for production-size months
(n <= REFINE_MAX_CELLS): on the device in float64
(:func:`_exact_tail_device`, accepted only when the host-f64 row-sampled
TRUE residual passes ``DEVICE_EXACT_RESID_GATE``;
``OISAT_EXACT_DEVICE=0`` opts out), with the host f64 path (blocked dense
kernel + dpotrf) serving when that is opted out or the device reports
out-of-memory; the increment uses the R-form ``inc = d - R x`` (error
bounded by the TRUE residual — R A^-1 is an SPD contraction).  Beyond
that size the f32 deflated PCG stands (huge coarse domains are mildly
conditioned), and explicit ``refine=p`` forces p IR passes.  The
residual warning weighs numerics against statistics:
``info["resid_abs"]`` (the field-error bound) vs ``info["stat_norm"]``
(the posterior-std norm).  On the direct paths the posterior diagonal —
hence ``error`` and the averaging kernel — is EXACT too:
``diag(Sb) = so^2 - so^4 diag(A^-1)`` from the same factor
(:func:`_exact_sb_diag`; ``info["exact_diag"] = True``).  Only the
beyond-REFINE_MAX PCG path keeps estimates: the Woodbury tail-closure
diagonal (never worse than ~2x in std units; AK 3e-5 absolute on the
production month) and colored probing on the Jacobi branch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from oisat.ops.covariance import EARTH_RADIUS_KM, build_covariance

__all__ = ["OIFullResult", "oi_full", "oi_full_dense", "oi_full_dense_scan",
           "oi_full_matfree", "mean_ak_curve_slq"]

LANES = 128
HIGHEST = jax.lax.Precision.HIGHEST  # full-f32 products: no TF32 rounding
DENSE_MAX_CELLS = 10_240  # beyond this oi_full switches to the matrix-free
# CG formulation.  The limit decides which solver serves a month, so it is
# a deployment choice, not a memory wall: measured on an H100 (400 W
# power limit), oi_full_dense at this n needs 1.26 GB of temporaries
# (compiled.memory_analysis) of the card's 80 GB, and the n = 8192 solve
# runs in 0.04 s warm.
DENSE_SCAN_MAX_CELLS = 6_144  # the 99-factor eigen scan's eigh holds
# several ~N^2 f32 workspaces, so the regularized solve hands mid-size
# domains to the matrix-free path (SLQ curve + CG) before the
# Cholesky-only dense limit.  Measured on an H100 (400 W): 0.79 GB of
# temporaries at this n, 0.27 s warm — far from a memory wall here too.


class OIFullResult(NamedTuple):
    xb: np.ndarray
    averaging_kernel: np.ndarray
    increment: np.ndarray
    error: np.ndarray
    info: dict = None  # matrix-free path: CG iterations/residual, colors


@partial(jax.jit, static_argnames=("length_scale_km", "diag_block"))
def oi_full_dense(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float,
                  diag_block: int = 1024):
    """Dense-cell solve: all 1-D inputs length N (multiple of 128), finite.

    The posterior-covariance diagonal ``diag(B - B A^-1 B)`` is accumulated
    in column blocks of ``diag_block`` (a full N-rhs ``cho_solve`` would
    materialize several NxN temporaries).
    With ``A = L L^T`` the quadratic form needs only HALF a solve per
    block: ``diag(B A^-1 B) = colsum(V * V)`` for ``V = L^-1 B`` — one
    lower-triangular solve (N^3 flops over all blocks) instead of
    ``cho_solve``'s forward+back pair (2 N^3), the dominant term of the
    whole dense path.
    """
    b = build_covariance(lat, lon, sigma_b, length_scale_km)
    a = b + jnp.diag(sigma_o.astype(jnp.float32) ** 2)
    chol = jax.scipy.linalg.cho_factor(a, lower=True)
    innov = (y - xa).astype(jnp.float32)
    w = jax.scipy.linalg.cho_solve(chol, innov)
    increment = jnp.matmul(b, w, precision=HIGHEST)
    xb = xa + increment

    n = b.shape[0]
    k = min(diag_block, n)
    nblocks = -(-n // k)
    l = chol[0]  # lower factor; the strict upper triangle is not read

    def block_diag(start):
        cols = jax.lax.dynamic_slice(b, (0, start), (n, k))  # (N, K)
        v = jax.lax.linalg.triangular_solve(
            l, cols, left_side=True, lower=True)  # V = L^-1 B[:, blk]
        return jnp.sum(v * v, axis=0)  # diag entries for this block

    starts = jnp.minimum(jnp.arange(nblocks) * k, n - k)
    parts = jax.lax.map(block_diag, starts)  # (nblocks, K)
    # overlapping final block: recompute positions explicitly
    col_idx = (starts[:, None] + jnp.arange(k)[None, :]).ravel()
    quad = jnp.zeros((n,), b.dtype).at[col_idx].set(parts.ravel())
    bd = jnp.diag(b)
    sb_diag = bd - quad
    ak = 1.0 - sb_diag / bd
    err = jnp.sqrt(jnp.maximum(sb_diag, 0.0))
    return xb, ak, increment, err


@partial(jax.jit, static_argnames=("length_scale_km",))
def oi_full_dense_scan(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float, regs):
    """Full-covariance OI *with* the reference's regularization scan.

    The scalar OI scans 99 factors r, scaling the background variance
    (reference optimal_interpolation.py:16-33).  Densely that would mean 99
    Cholesky factorizations; instead, whiten by R and eigendecompose once:

        C = D^-1 B D^-1 = Q diag(lam) Q^T          (D = diag(sigma_o))
        (rB + R)^-1 = D^-1 Q diag(1/(r lam + 1)) Q^T D^-1

    so every factor costs a few vector ops: with M = Q^T D^-1 B and
    S = colsum(coef * M*M), the posterior-variance diagonal is
    diag(Sb_r) = r diag(B) - r^2 S_r and the mean-AK curve, the Kneedle
    knee, and the chosen factor's fields all come from the same
    decomposition.  One eigh + two GEMMs total.
    """
    f32 = jnp.float32
    b = build_covariance(lat, lon, sigma_b, length_scale_km)
    d = sigma_o.astype(f32)
    dinv = 1.0 / d
    c = b * dinv[:, None] * dinv[None, :]
    lam, q = jnp.linalg.eigh(c)
    innov = ((y - xa) * dinv).astype(f32)
    t = jnp.matmul(q.T, innov, precision=HIGHEST)  # (N,)
    m = jnp.matmul(q.T, b * dinv[:, None], precision=HIGHEST)  # M = Q^T D^-1 B
    m2 = m * m
    bd = jnp.diag(b)
    # valid-cell mask for the mean-AK curve: pad cells carry sigma_b = 0
    valid = bd > 0
    nvalid = jnp.maximum(jnp.sum(valid), 1)

    def curve_point(r):
        coef = 1.0 / (r * lam + 1.0)
        s = jnp.matmul(coef, m2, precision=HIGHEST)  # sum_i coef_i M_ij^2
        ak_diag = jnp.where(valid, r * s / jnp.where(valid, bd, 1.0), jnp.nan)
        return jnp.sum(jnp.where(valid, ak_diag, 0.0)) / nvalid

    regs = jnp.asarray(regs, f32)
    curve = jax.vmap(curve_point)(regs)
    from oisat.ops.knee import kneedle_index

    reg_index = kneedle_index(regs, curve, fallback=0)
    r = regs[reg_index]
    coef = 1.0 / (r * lam + 1.0)
    w = dinv * jnp.matmul(q, coef * t, precision=HIGHEST)  # (rB+R)^-1 innov
    increment = r * jnp.matmul(b, w, precision=HIGHEST)
    xb = xa + increment
    s = jnp.matmul(coef, m2, precision=HIGHEST)
    sb_diag = r * bd - r * r * s
    ak = jnp.where(valid, 1.0 - sb_diag / jnp.where(valid, r * bd, 1.0), jnp.nan)
    err = jnp.sqrt(jnp.maximum(sb_diag, 0.0))
    return xb, ak, increment, err, reg_index, curve


# ---------------------------------------------------------------------------
# matrix-free path: N beyond the dense limits
# ---------------------------------------------------------------------------

def _unit_vectors(lat_deg, lon_deg):
    """(N, 3) float32 unit vectors on the sphere.  The chordal distance the
    covariance kernel uses satisfies d^2 = R^2 |u_i - u_j|^2 = 2 R^2 (1 -
    u_i.u_j)."""
    lat = jnp.deg2rad(jnp.asarray(lat_deg, jnp.float32))
    lon = jnp.deg2rad(jnp.asarray(lon_deg, jnp.float32))
    cl = jnp.cos(lat)
    return jnp.stack([cl * jnp.cos(lon), cl * jnp.sin(lon), jnp.sin(lat)], axis=-1)


@partial(jax.jit, static_argnames=("length_scale_km", "block", "mesh"))
def _b_matmat(u3, sigma_b, v, length_scale_km: float, block: int,
              mesh=None):
    """Y = B V without materializing B: row blocks of the kernel matrix
    C = exp(-kappa |u_i - u_j|^2 / 2) are generated elementwise and
    immediately contracted against ALL right-hand sides in a matmul.
    ``v``: (N, K).  Peak memory O(block * N + N * K) instead of O(N^2).
    Batching K columns into one call costs barely more than one — the
    multi-probe posterior diagonal rides the same sweep as the innovation
    solve.

    The squared chordal distance is computed by EXPLICIT coordinate
    differences, NOT as the algebraically-equal Gram-matmul form
    kappa (u_i.u_j - 1): an f32 dot product carries ~eps ABSOLUTE error,
    which the kappa = (R/L)^2 ~ 450 amplification turns into ~5e-5
    relative error on every kernel element — enough to make the implied
    B indefinite below sigma_o^2 ~ 1e-5 and silently diverge CG on the
    production month's conditioning (measured).  Differences of nearby
    f32 coordinates are exact (Sterbenz), so this form's error is
    RELATIVE to each element (~couple ulp, matching the haversine
    builder and the f64 reference cast to f32), and B stays numerically
    PSD.  precision=HIGHEST on the apply matmul: TF32 or bf16 would round
    the well-conditioned contraction itself.

    The contraction is CHUNKED into ``block``-sized batched matmuls whose
    partials are summed separately: a single f32 matmul over all N
    accumulates ~sqrt(N) eps |B| of rounding noise, which acts as an
    indefinite perturbation of A = B + R and sets the attainable CG
    residual floor on tight-observation solves; chunking caps the
    in-matmul accumulation at sqrt(block) eps and the ~N/block partials
    add only ~sqrt(N/block) eps more — a ~sqrt(N/block) floor reduction
    (measured on the 64k-cell bench: CG residual floor 3.4e-5 -> 9.1e-7,
    i.e. the solve CONVERGES below tol=1e-6 instead of freezing at the
    noise floor) expressed as a chunk-leading batched dot_general (NOT a
    sequential Kahan lax.scan, whose compile time was prohibitive, and NOT
    a reshape+swapaxes into batch form, which adds a minor-axis transpose
    of the whole kernel tile)."""
    kappa = (EARTH_RADIUS_KM / length_scale_km) ** 2
    n = u3.shape[0]
    nchunks = n // block
    dv = sigma_b[:, None] * v  # (N, K)
    dv3 = dv.reshape(nchunks, block, -1)
    starts = jnp.arange(nchunks) * block

    u3c = u3.reshape(nchunks, block, 3)
    # Multi-device: the chunk axis is the natural GSPMD split of each row
    # sweep — a mid-program sharding constraint (the same pattern as
    # regridder._sharded_regrid_fn) partitions the kernel tile and its
    # contraction over ALL mesh devices; the chunk-partial sum lowers to a
    # psum.  Inputs stay replicated (u3: (N, 3) and dv: (N, K) are <~3 MB
    # at the 64k bench — negligible next to the O(block x N) tile).
    spec = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        spec = NamedSharding(mesh, PartitionSpec(tuple(mesh.axis_names),
                                                 None, None))
        dv3 = jax.lax.with_sharding_constraint(dv3, spec)

    def body(start):
        ub = jax.lax.dynamic_slice(u3, (start, 0), (block, 3))
        # chunk axis LEADING from the start: a (block, N) tile reshaped +
        # swapaxes'd into batch form costs a minor-axis transpose of the
        # full 0.5 GB tile per block-row (measured 4.4x on the whole 64k
        # solve); generating d2 directly in (chunk, row, col) layout is
        # transpose-free at the same rounding floor (measured equal
        # 1.22e-7 rel vs f64 at n=8192).
        d2 = sum((ub[None, :, None, k] - u3c[:, None, :, k]) ** 2
                 for k in range(3))
        c = jnp.exp((-0.5 * kappa) * d2)  # (nchunks, block_row, block_col)
        if spec is not None:
            c = jax.lax.with_sharding_constraint(c, spec)
        # batched over the chunk axis: (nchunks, block_row, chunk) x
        # (nchunks, chunk, K) -> (nchunks, block_row, K)
        parts = jax.lax.dot_general(
            c, dv3, (((2,), (1,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(parts, axis=0)

    rows = jax.lax.map(body, starts)  # (nblocks, block, K)
    return sigma_b[:, None] * rows.reshape(n, -1)


def _cg_loop(amat, psolve, rhs, tol, maxiter, stall: int = 50):
    """Preconditioned-CG loop body shared by the Jacobi and Nystrom
    entry points (traced inside their jit wrappers).  A is SPD; ``rhs``:
    (N, K); every iteration costs ONE covariance-tile sweep regardless of
    K.  Converged columns freeze (alpha = 0) while the rest keep
    iterating.

    ``stall``: iterations without a 10% residual improvement before a
    column freezes — f32 matvec roundoff puts a floor under the
    attainable residual, and grinding past it wastes covariance sweeps.
    High-cond solves plateau for long stretches BEFORE converging
    (residual 2-norm oscillates while the A-norm error falls), so the
    deflated path passes a window sized for its spectrum.

    Every column returns its MINIMUM-residual iterate, not its last: the
    f32 covariance matvec carries accumulation noise ~sqrt(N) eps |B|
    that acts as an indefinite perturbation of A below sigma_o^2 ~ 1e-5,
    so on extreme-conditioning solves CG reduces the residual to the
    noise floor and then the spurious negative mode amplifies
    exponentially — the best iterate is the right answer and a column
    whose residual grows 100x past its own best freezes (unambiguous
    divergence — transient 2-norm growth of a few x is NORMAL for
    ill-conditioned CG and must stay live; the stall window handles
    mere plateaus).
    """
    bnorm2 = jnp.sum(rhs * rhs, axis=0)  # (K,)
    tol2 = tol * tol * jnp.maximum(bnorm2, 1e-30)
    STALL = stall

    def cond(state):
        k, _, r, _, _, _, stall, _, best = state
        r2n = jnp.sum(r * r, axis=0)
        alive = (r2n > tol2) & (stall < STALL) & (r2n < 1e4 * best)
        return (k < maxiter) & jnp.any(alive)

    def step(state):
        k, x, r, z, p, anchor, stall, xbest, best = state
        r2n = jnp.sum(r * r, axis=0)
        live = ((r2n > tol2) & (stall < STALL) & (r2n < 1e4 * best))[None, :]
        ap = amat(p)
        rz = jnp.sum(r * z, axis=0)
        den = jnp.sum(p * ap, axis=0)
        alpha = jnp.where((den > 0) & live[0], rz / jnp.where(den > 0, den, 1.0), 0.0)
        x = x + alpha[None, :] * p
        r2 = r - alpha[None, :] * ap
        z2 = psolve(r2)
        beta = jnp.where(rz > 0, jnp.sum(r2 * z2, axis=0) / jnp.where(rz > 0, rz, 1.0), 0.0)
        p2 = z2 + beta[None, :] * p
        r2n_new = jnp.sum(r2 * r2, axis=0)
        record = r2n_new < best
        xbest = jnp.where(record[None, :], x, xbest)
        best = jnp.where(record, r2n_new, best)
        # windowed criterion: compare against the residual at the last
        # reset (the anchor), NOT the running minimum — a slow-but-steady
        # 1%/iteration column improves 40% per window and must stay live
        improved = r2n_new < 0.81 * anchor  # 10% norm improvement (squared)
        anchor = jnp.where(improved, r2n_new, anchor)
        stall = jnp.where(improved, 0, stall + 1)
        return k + 1, x, r2, z2, p2, anchor, stall, xbest, best

    x0 = jnp.zeros_like(rhs)
    z0 = psolve(rhs)
    init = (0, x0, rhs, z0, z0, bnorm2,
            jnp.zeros_like(bnorm2, dtype=jnp.int32), x0, bnorm2)
    k, x, r, _, _, _, _, xbest, best = jax.lax.while_loop(cond, step, init)
    resid = jnp.sqrt(jnp.max(best / jnp.maximum(bnorm2, 1e-30)))
    return xbest, k, resid


@partial(jax.jit, static_argnames=("length_scale_km", "block", "maxiter",
                                     "mesh"))
def _cg_solve_multi(u3, sigma_b, sigma_o2, rhs, length_scale_km: float,
                    block: int, tol: float, maxiter: int, mesh=None):
    """Jacobi-preconditioned CG for A X = RHS (column-wise), A = B +
    diag(sigma_o^2), with the matrix-free blocked B mat-mat.  Adequate
    when sigma_b/sigma_o is O(1); for observation errors far tighter than
    the prior (monthly averages: sigma_b/sigma_o ~ 100) cond(A) reaches
    ~1e7 and f32 CG both stalls and hits its roundoff floor — those
    solves take :func:`_pcg_solve_nystrom`."""

    def amat(v):
        return (_b_matmat(u3, sigma_b, v, length_scale_km, block, mesh=mesh)
                + sigma_o2[:, None] * v)

    minv = (1.0 / (sigma_b**2 + sigma_o2))[:, None]
    return _cg_loop(amat, lambda r: minv * r, rhs, tol, maxiter)


@partial(jax.jit, static_argnames=("length_scale_km", "block", "k", "mesh"))
def _nystrom_factor(u3, sigma_b, key, k: int, length_scale_km: float,
                    block: int, mesh=None):
    """Rank-k randomized Nystrom eigenfactor (U, lam) of the prior
    covariance: B ~= U diag(lam) U^T with U (N, k) orthonormal.  Two
    covariance-tile sweeps' worth of matmuls plus two k x k
    eigendecompositions — no n x n storage.

    Deliberately sketches B UNWHITENED: every f32 quantity here carries
    absolute error ~eps * lam_max(B), and the preconditioner's shift
    floor (4 eps lam_max, see :func:`_pcg_solve_nystrom`) bounds that
    error's effect on the preconditioned spectrum by 1/4.  Sketching the
    whitened kernel D_o^-1 B D_o^-1 instead (spectral range ~cond(A) ~
    1/eps_f32 for monthly-average sigma_o) was measured to make the f32
    factor error O(1) in the units that matter — an indefinite
    preconditioner that diverges CG.  Rank-deficient sketch directions
    drop out cleanly: their columns are zeroed, surfacing as lam = 0 =
    plain shift directions.

    The Gaussian sketch is generated ON DEVICE from ``key`` (the sketch
    needs isotropy, not any particular numbers): materializing it on host
    would ship (N, k) f32 — 0.5 GB at the 64k bench shape — host->device
    on EVERY solve, several times the solve's other traffic combined."""
    omega = jax.random.normal(key, (u3.shape[0], k), jnp.float32)
    y = _b_matmat(u3, sigma_b, omega, length_scale_km, block,
                  mesh=mesh)  # (N, k)
    g = jax.lax.dot_general(omega, y, (((0,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST)
    g = 0.5 * (g + g.T)
    w, v = jnp.linalg.eigh(g)  # ascending
    keep = w > jnp.maximum(w[-1], 0.0) * 3e-6  # f32 eigh noise floor
    wsafe = jnp.where(keep, w, 1.0)
    z = jax.lax.dot_general(y, v * (keep / jnp.sqrt(wsafe))[None, :],
                            (((1,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST)  # (N, k)
    # thin eigenform of Z Z^T via the k x k Gram: Z^T Z = P diag(s) P^T
    # -> U = Z P s^-1/2, lam = s
    zz = jax.lax.dot_general(z, z, (((0,), (0,)), ((), ())),
                             precision=jax.lax.Precision.HIGHEST)
    zz = 0.5 * (zz + zz.T)
    s, p = jnp.linalg.eigh(zz)
    lam = jnp.maximum(s, 0.0)
    skeep = s > jnp.maximum(s[-1], 0.0) * 3e-6
    ssafe = jnp.where(skeep, s, 1.0)
    u = jax.lax.dot_general(z, p * (skeep / jnp.sqrt(ssafe))[None, :],
                            (((1,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST)
    return u, jnp.where(skeep, lam, 0.0)


@partial(jax.jit, static_argnames=("length_scale_km", "block", "maxiter",
                                     "mesh"))
def _pcg_solve_nystrom(u3, sigma_b, sigma_o2, rhs, nys_u, nys_lam, c2,
                       dcomp, length_scale_km: float, block: int,
                       tol: float, maxiter: int, mesh=None):
    """CG with the randomized-Nystrom deflation preconditioner
    (the Frangella, Tropp & Udell SIAM J. Matrix Anal. 2023 pattern,
    projector form for a non-scalar complement):

        M^-1 = P D_c^-1 P + U diag(1/(lam + c2)) U^T,   P = I - U U^T

    SPD by construction (a PSD congruence plus a PSD low-rank term).
    ``dcomp`` = dtail + sigma_o^2 is the per-cell complement diagonal:
    dtail = diag(B) - diag(U lam U^T) is exactly the local prior variance
    the sketch did NOT capture, so complement directions see a Jacobi
    scaling matched to the residual operator P (B - B^) P + P R P — this
    absorbs both the B tail below the f32 eigh floor (only the modes
    above ~3e-6 lam_max survive :func:`_nystrom_factor`) and sigma_o
    heterogeneity, which a scalar 1/c2 complement amplified by
    lam_tail / min sigma_o^2 (measured divergent on the production
    month).  ``c2`` (max of min-valid sigma_o^2 and 4 eps_f32 lam_max)
    keeps the deflated coefficients f32-safe.

    Deflates the eigenvalues of B that make Jacobi CG stall (cond(A) ~
    1e7 when monthly-average observation errors are ~100x tighter than
    the prior); f32 PCG then converges in tens-to-~200 iterations with a
    correspondingly low roundoff floor.  Padding rows (sigma_b = 0,
    sigma_o = 1, rhs = 0) keep zero residual forever."""

    def amat(v):
        return (_b_matmat(u3, sigma_b, v, length_scale_km, block, mesh=mesh)
                + sigma_o2[:, None] * v)

    dinv = (1.0 / dcomp)[:, None]
    dl = (1.0 / (nys_lam + c2))[:, None]

    def ut(v):
        return jax.lax.dot_general(nys_u, v, (((0,), (0,)), ((), ())),
                                   precision=jax.lax.Precision.HIGHEST)

    def u_(t):
        return jax.lax.dot_general(nys_u, t, (((1,), (0,)), ((), ())),
                                   precision=jax.lax.Precision.HIGHEST)

    def psolve(r):
        t = ut(r)
        rp = r - u_(t)          # P r
        z = dinv * rp
        z = z - u_(ut(z))       # P D_c^-1 P r
        return z + u_(dl * t)

    return _cg_loop(amat, psolve, rhs, tol, maxiter, stall=200)


@partial(jax.jit, static_argnames=("length_scale_km", "block", "m", "mesh"))
def _lanczos_tridiag_batch(u3, sigma_b, sigma_o, q0, length_scale_km: float,
                           block: int, m: int, mesh=None):
    """Batched m-step Lanczos tridiagonalization of the whitened covariance
    C = D_o^-1 B D_o^-1, one independent recurrence per column of ``q0``,
    all columns sharing each covariance-tile sweep (one B mat-mat per
    iteration regardless of the column count).  Returns (alpha (m, K),
    beta (m, K), norms (K,)) — the Jacobi matrices for stochastic Lanczos
    quadrature.  Orthogonality drift is accepted: Gauss-quadrature values
    of smooth resolvents f(l) = 1/(r l + 1) converge regardless (standard
    SLQ behaviour)."""
    oin = 1.0 / sigma_o

    def cmat(v):
        return oin[:, None] * _b_matmat(u3, sigma_b, oin[:, None] * v,
                                        length_scale_km, block, mesh=mesh)

    norms = jnp.sqrt(jnp.sum(q0 * q0, axis=0))
    safe = jnp.where(norms > 0, norms, 1.0)
    q = q0 / safe

    def step(carry, _):
        q_prev, q_cur, beta_prev = carry
        w = cmat(q_cur) - beta_prev[None, :] * q_prev
        alpha = jnp.sum(q_cur * w, axis=0)
        w = w - alpha[None, :] * q_cur
        beta = jnp.sqrt(jnp.sum(w * w, axis=0))
        q_next = w / jnp.where(beta > 0, beta, 1.0)[None, :]
        return (q_cur, q_next, beta), (alpha, beta)

    init = (jnp.zeros_like(q), q, jnp.zeros(q.shape[1], q.dtype))
    _, (alphas, betas) = jax.lax.scan(step, init, None, length=m)
    return alphas, betas, norms


def mean_ak_curve_slq(u3_or_latlon, sigma_b, sigma_o, regs,
                      length_scale_km: float, block: int = 1024,
                      n_probes: int = 8, m: int = 60, seed: int = 0,
                      valid=None, mesh=None):
    """Full-domain mean-AK-vs-regularization curve for the matrix-free OI,
    by stochastic Lanczos quadrature (SLQ).

    The scalar reference's curve generalizes to
    ``meanAK(r) = (r / Nv) tr(D_bd^-1 B A_r^-1 B)`` with ``A_r = r B + R``
    (the diagonal of ``r B A_r^-1 B`` over ``r diag(B)``).  Whitening by
    ``D_o`` makes every factor a resolvent of ONE matrix,
    ``(r C + I)^-1`` with ``C = D_o^-1 B D_o^-1``, so a single batched
    Lanczos run prices all 99 factors: per Rademacher probe z the bilinear
    form ``a^T (rC+I)^-1 b`` (a, b = whitened B-weighted probes) is split
    by polarization into two Gauss quadratures whose Jacobi matrices come
    from the shared recurrence; evaluating a factor is then a tiny m x m
    tridiagonal eigenproblem on host.  Cost: (m + 1) covariance sweeps
    total — cheaper than the CG solve itself — vs 99 dense factorizations.
    Trace-estimator noise ~ 1/sqrt(n_probes * N_eff): well under 1% for
    grids this size.
    """
    if mesh is not None and mesh.devices.size == 1:
        mesh = None
    if isinstance(u3_or_latlon, tuple):
        u3 = _unit_vectors(*u3_or_latlon)
    else:
        u3 = u3_or_latlon
    n_in = u3.shape[0]
    n = int(np.ceil(max(n_in, 1) / block)) * block
    if n != n_in:  # self-pad: sigma_b = 0 rows decouple, sigma_o = 1
        pad = n - n_in
        u3 = jnp.concatenate([u3, jnp.zeros((pad, 3), u3.dtype)])
        sigma_b = np.concatenate([np.asarray(sigma_b, np.float64).ravel(),
                                  np.zeros(pad)])
        sigma_o = np.concatenate([np.asarray(sigma_o, np.float64).ravel(),
                                  np.ones(pad)])
        if valid is not None:
            valid = np.concatenate([np.asarray(valid, bool), np.zeros(pad, bool)])
    sigma_b = jnp.asarray(np.asarray(sigma_b, np.float64), jnp.float32)
    sigma_o = jnp.asarray(np.asarray(sigma_o, np.float64), jnp.float32)
    bd = np.asarray(sigma_b, np.float64) ** 2
    if valid is None:
        valid = bd > 0
    valid = np.asarray(valid, bool) & (bd > 0)
    nv = max(int(valid.sum()), 1)

    rng = np.random.default_rng(seed)
    z = rng.choice([-1.0, 1.0], size=(n, n_probes)).astype(np.float32)
    z[~valid] = 0.0
    zd = z / np.where(valid, bd, 1.0)[:, None]  # D_bd^-1 z
    both = jnp.asarray(np.concatenate([zd, z], axis=1), jnp.float32)
    bz = _b_matmat(u3, sigma_b, both, float(length_scale_km), block,
                   mesh=mesh)
    a = np.asarray(bz[:, :n_probes], np.float64)  # B D_bd^-1 z
    b = np.asarray(bz[:, n_probes:], np.float64)  # B z
    oin = 1.0 / np.asarray(sigma_o, np.float64)
    qp = (a + b) * oin[:, None]
    qm = (a - b) * oin[:, None]
    q0 = jnp.asarray(np.concatenate([qp, qm], axis=1), jnp.float32)

    alphas, betas, norms = _lanczos_tridiag_batch(
        u3, sigma_b, sigma_o, q0, float(length_scale_km), block, m,
        mesh=mesh)
    alphas = np.asarray(alphas, np.float64)  # (m, 2K)
    betas = np.asarray(betas, np.float64)
    norms = np.asarray(norms, np.float64)

    regs = np.asarray(regs, np.float64)
    curve = np.zeros(regs.shape[0])
    for j in range(alphas.shape[1]):
        # Gauss quadrature: ||q||^2 * sum_i w_i^2 / (r theta_i + 1)
        from scipy.linalg import eigh_tridiagonal

        try:
            theta, vecs = eigh_tridiagonal(alphas[:, j], betas[:-1, j])
        except np.linalg.LinAlgError:
            t = np.diag(alphas[:, j]) + np.diag(betas[:-1, j], 1) + np.diag(betas[:-1, j], -1)
            theta, vecs = np.linalg.eigh(t)
        w2 = vecs[0, :] ** 2 * norms[j] ** 2
        g = (w2[None, :] / (regs[:, None] * np.maximum(theta, 0.0)[None, :] + 1.0)).sum(axis=1)
        sign = 1.0 if j < n_probes else -1.0
        curve += sign * 0.25 * g
    curve /= n_probes
    return regs * curve / nv


def _sphere_points(lat, lon):
    lat_r = np.deg2rad(np.asarray(lat, np.float64))
    lon_r = np.deg2rad(np.asarray(lon, np.float64))
    cl = np.cos(lat_r)
    return np.column_stack([cl * np.cos(lon_r), cl * np.sin(lon_r), np.sin(lat_r)])


_BALL_CHUNK = 4096  # bound the transient neighbour lists (Python ints are
# ~60 bytes each; a whole-domain query at 4L separation would hold an
# order-GB of them on the 1-CPU host)


def _cluster_reps(pts, radius_km: float, prefer=None):
    """Greedy geometric clustering: every point within ``radius_km`` of an
    earlier representative joins its cluster.  The probing diagonal is then
    evaluated at representatives only and shared within the cluster — the
    fix for grids whose cells crowd in physical distance (lat/lon poles),
    where exact per-cell probing would need one color per crowded
    neighbour.  Clusters only form where the grid pitch is below
    ``radius_km``; on coarser grids every cell is its own representative
    and the result is exact probing.

    ``prefer`` (bool array): candidates to consider FIRST as
    representatives — the matfree caller passes ``sigma_b > 0`` so a
    zero-variance cell never represents a cluster whose members have real
    variance (its probe quadratic would be 0 and the members would
    inherit AK = 0)."""
    from scipy.spatial import cKDTree

    n = len(pts)
    if n == 0:
        return np.zeros(0, np.int64)
    chord = min(radius_km / EARTH_RADIUS_KM, 2.0)
    tree = cKDTree(pts)
    order = (np.arange(n) if prefer is None
             else np.argsort(~np.asarray(prefer, bool), kind="stable"))
    rep = np.full(n, -1, np.int64)
    for s in range(0, n, _BALL_CHUNK):
        chunk = order[s:s + _BALL_CHUNK]
        balls = tree.query_ball_point(pts[chunk], chord)
        for i, ball in zip(chunk, balls):
            if rep[i] >= 0:
                continue
            members = [j for j in ball if rep[j] < 0]
            rep[members] = i
            rep[i] = i
    return rep


def _distance_coloring(lat, lon, sep_km: float, cluster_radius_km: float,
                       prefer=None):
    """Exact distance coloring with cluster representatives.

    Returns (rep, colors): ``rep[i]`` is cell i's representative (itself
    where the grid is coarser than ``cluster_radius_km``), and ``colors``
    a per-cell array holding the representative's color (-1 on
    non-representative members).  Same-color representatives are at least
    ``sep_km`` apart (chordal) — never capped/merged, so the probing
    separation guarantee always holds; the color *count* is bounded by
    ~(sep/cluster_radius)(sep/pitch) instead of growing with local cell
    crowding."""
    from scipy.spatial import cKDTree

    pts = _sphere_points(lat, lon)
    rep = _cluster_reps(pts, cluster_radius_km, prefer=prefer)
    rep_ids = np.flatnonzero(rep == np.arange(len(pts)))
    rpts = pts[rep_ids]
    chord = min(sep_km / EARTH_RADIUS_KM, 2.0)
    tree = cKDTree(rpts)
    rcolors = np.full(len(rpts), -1, np.int64)
    # chunked queries: greedy coloring only consults already-colored
    # neighbours, so chunk boundaries don't change the result
    for s in range(0, len(rpts), _BALL_CHUNK):
        balls = tree.query_ball_point(rpts[s:s + _BALL_CHUNK], chord)
        for k, ball in enumerate(balls):
            used = {rcolors[j] for j in ball if rcolors[j] >= 0}
            c = 0
            while c in used:
                c += 1
            rcolors[s + k] = c
    colors = np.full(len(pts), -1, np.int64)
    colors[rep_ids] = rcolors
    return rep, colors


from oisat.utils.lru import LockedLRU  # noqa: E402

_coloring_cache = LockedLRU(8)


def _distance_coloring_cached(lat, lon, sep_km: float, cluster_radius_km: float,
                              prefer=None):
    import hashlib

    lat = np.ascontiguousarray(lat)
    lon = np.ascontiguousarray(lon)
    # full-content digest: a truncated-prefix + sums key can collide for
    # symmetric masks and silently return another geometry's coloring
    h = hashlib.sha1()
    h.update(lat.tobytes())
    h.update(lon.tobytes())
    if prefer is not None:
        h.update(np.ascontiguousarray(prefer, np.uint8).tobytes())
    key = (lat.shape, h.hexdigest(), float(sep_km), float(cluster_radius_km))
    hit = _coloring_cache.get(key)
    if hit is not None:
        return hit
    out = _distance_coloring(lat, lon, sep_km, cluster_radius_km,
                             prefer=prefer)
    _coloring_cache.put(key, out)
    return out


NYSTROM_MIN_CELLS = 4096  # below this the tests' well-conditioned small
# problems converge in a handful of Jacobi iterations; the sketch would
# cost more than it saves.

REFINE_MAX_CELLS = 16384  # host f64 residual evaluation is O(n^2) dgemm +
# exp per pass (seconds at production month sizes n ~ 10k on one host
# core); beyond this the quadratic host cost outgrows its value and the
# refinement defaults off (the huge-domain bench regimes are mildly
# conditioned, where the f32 solve is already at tolerance).


REFINE_CACHE_BYTES = 8 << 30  # dense f64 kernel cache cap for refinement
# passes (this class of host has 128 GB; n = 16384 needs 2.1 GB)


def _kernel_block_f64(u3_64, s, e, kappa: float, out=None, full=None):
    """Rows [s:e) of the f64 correlation kernel exp(kappa (u.u - 1))
    against the columns of ``full`` (defaults to ``u3_64`` itself).
    The argument is clipped at -60 (elements 8.8e-27 — utterly negligible
    against O(1) elements summed over ~1e4 terms) BEFORE exp: glibc's
    exp takes its ~700 ns/element soft-underflow path for far pairs
    (kappa d2/2 reaches ~900 at antipodes), which measured 65 s for a
    9.7k^2 kernel vs ~3 s clipped.  Callers should keep row blocks SMALL
    (~512 rows): the five elementwise passes run cache-resident per
    block — a 9.7k^2 build measured 0.6-0.9 s at row_block 256-1024 vs
    14.4 s at 4096 on this memory-bandwidth-starved host."""
    cols = u3_64 if full is None else full
    g = np.matmul(u3_64[s:e], cols.T, out=out)  # dgemm, f64
    np.clip(g, -1.0, 1.0, out=g)
    g -= 1.0
    g *= kappa                               # kappa (u.u - 1) = -0.5 kappa d2
    np.maximum(g, -60.0, out=g)
    np.exp(g, out=g)
    return g


def _direct_solve_f64(u3_64, sb_64, so2_64, d64, kappa: float,
                      row_block: int = 512, want_diag: bool = False):
    """EXACT f64 innovation solve A x = d on host for production-size
    full-covariance months: build the dense kernel (row-blocked), scale to
    A = D_b G D_b + D_o^2, Cholesky-factor (dpotrf), solve.  This
    replaces iterative refinement below REFINE_MAX_CELLS: the tight-obs
    regime (monthly-average sigma_o, cond(A) ~ 1e7-1e9) leaves ANY
    f32-matvec inner solver stalled orders above the posterior-std
    significance threshold, while the direct factor lands at the f64
    backward-error floor (~1e-13) for comparable wall time.  The kernel
    is scaled IN PLACE and the factorization overwrites it (a second
    (n, n) buffer costs seconds of pure memory traffic on the host);
    the caller estimates the residual bound with one f32 device sweep.

    ``want_diag``: additionally return ``diag(A^-1)`` from the same
    factor (dtrtri in place, n^3/3 flops + one n^2/2 read — the exact
    posterior diagonal needs nothing else, see :func:`_exact_sb_diag`).

    Returns ``(x64, diag_ainv_or_None)``, or ``(None, None)`` if the f64
    factorization fails (A is PD by construction; failure would mean
    pathological inputs — callers fall back to the iterative path)."""
    import scipy.linalg as _sla

    n = u3_64.shape[0]
    g = np.empty((n, n))
    for s in range(0, n, row_block):
        _kernel_block_f64(u3_64, s, min(s + row_block, n), kappa,
                          out=g[s:min(s + row_block, n)])
    g *= sb_64[None, :]
    g *= sb_64[:, None]
    g[np.arange(n), np.arange(n)] += so2_64
    try:
        # g is symmetric, so g.T is an F-contiguous VIEW of the same data:
        # LAPACK accepts it without the silent Fortran-order copy that
        # overwrite_a=True on a C-ordered array would make (an extra
        # (n, n) f64 buffer + its memory traffic, verified in this env)
        c = _sla.cho_factor(g.T, lower=True, overwrite_a=True,
                            check_finite=False)
        x = _sla.cho_solve(c, d64, check_finite=False)
    except np.linalg.LinAlgError:
        return None, None
    if not want_diag:
        return x, None
    return x, _diag_pack_from_factor(c[0], so2_64)


def _diag_pack_from_factor(l_lower, so2_64, blk: int = 512):
    """``(diag(A^-1), diag(B A^-1 B))`` from a lower Cholesky factor L.

    ``diag(A^-1)_j = sum_i (L^-1)_{ij}^2`` — dtrtri inverts IN PLACE
    (n^3/3); the column sums mask the upper-triangle factorization
    garbage block-wise instead of materializing ``tril`` (an (n, n) f64
    copy costs seconds of memory traffic on the host).

    ``q_j = diag(B A^-1 B)_j = ||L^-1 B e_j||^2`` decomposes over
    ``L^-1 B = L^T - so^2-scaled L^-1`` into three CANCELLATION-FREE
    pieces (k<j, k=j, k>j):

        q_j = sum_{k<j} L[j,k]^2 + (L[j,j] - so2_j/L[j,j])^2
              + so2_j^2 * sum_{k>j} Linv[k,j]^2

    Every sum is a direct sum of squares (the strict row sums come off
    the factor BEFORE inversion; diag(A^-1) is assembled as
    off-diagonal-sum + diag^2 by ADDITION) so both returned diagonals
    are eps-relative-accurate in every noise regime — the caller picks
    the stable posterior form per cell (:func:`_exact_sb_diag`).
    Returns (None, None) if the triangular inversion reports a singular
    diagonal (impossible for a PD factor short of pathological input)."""
    from scipy.linalg import lapack

    n = l_lower.shape[0]
    d_l = np.ascontiguousarray(np.diagonal(l_lower)).copy()
    rowsq = np.zeros(n)  # sum_{k<j} L[j,k]^2, accumulated by column block
    for j0 in range(0, n, blk):
        j1 = min(j0 + blk, n)
        head = np.tril(np.ascontiguousarray(l_lower[j0:j1, j0:j1]), -1)
        rowsq[j0:j1] += np.einsum("ij,ij->i", head, head)
        below = l_lower[j1:, j0:j1]
        if below.size:
            rowsq[j1:] += np.einsum("ij,ij->i", below, below)
    linv, info = lapack.dtrtri(l_lower, lower=1, overwrite_c=1)
    if info != 0:
        return None
    dainv = np.empty(n)
    off = np.empty(n)  # sum_{k>j} Linv[k,j]^2 (no diagonal subtraction)
    for j0 in range(0, n, blk):
        j1 = min(j0 + blk, n)
        head = np.tril(np.ascontiguousarray(linv[j0:j1, j0:j1]), -1)
        s = np.einsum("ij,ij->j", head, head)
        below = linv[j1:, j0:j1]
        if below.size:
            s += np.einsum("ij,ij->j", below, below)
        off[j0:j1] = s
        dainv[j0:j1] = s + 1.0 / d_l[j0:j1] ** 2
    so2 = np.asarray(so2_64, np.float64)
    q = rowsq + (d_l - so2 / d_l) ** 2 + so2 * so2 * off
    return dainv, q


EXACT_TAIL_BUCKET = 2048  # the device exact tail pads its n up to a
# multiple of this (decoupled identity rows: sb = 0, so = 1, d = 0), so
# months of one campaign, which land on a handful of valid-cell counts,
# share at most 8 compiled programs below REFINE_MAX_CELLS.  The
# padded-flops ratio ((npad/n)^3) is worst for tiny months just past a
# bucket edge (n = 2049 -> ~8x), where the absolute cost is smallest.
# Measured on an H100 (400 W), through oi_full: compile ~1.9 s at the
# 2048 bucket and ~4.2 s at 10240 (cold minus warm call), warm 0.026 s
# and 0.155 s — the bucket now bounds the number of programs a campaign
# compiles more than it bounds compile time.


def _exact_tail_device(u3_64, sb_64, so2_64, d64, kappa: float):
    """Run :func:`_exact_tail_prog` on the default device under the
    thread-local x64 context (the production process runs with x64 off;
    the context keeps the f64 operands and trace without flipping the
    global dtype policy).  Inputs are padded to ``EXACT_TAIL_BUCKET``
    multiples with decoupled rows (A acts as the identity there: the
    solve, diag(A^-1) and diag(B A^-1 B) of the real cells are exactly
    unchanged) so campaigns reuse one compiled program across months.
    Returns ``(x64, (diag_ainv, q))`` trimmed to the input length.

    Only an out-of-memory reported by the device, or non-finite outputs
    (a Cholesky breakdown), return ``(None, None)`` — each with a printed
    line — and the caller then solves on the host in f64.  Every other
    error, the divisibility guard of :func:`_exact_tail_prog` included,
    propagates."""
    n = int(u3_64.shape[0])
    npad = -(-n // EXACT_TAIL_BUCKET) * EXACT_TAIL_BUCKET
    if npad != n:
        pad = npad - n
        # pad points at the north pole with sigma_b = 0: their kernel
        # column is multiplied by 0, so A rows reduce to so2 = 1 identity
        u3p = np.concatenate([u3_64, np.tile([[0.0, 0.0, 1.0]], (pad, 1))])
        sbp = np.concatenate([sb_64, np.zeros(pad)])
        so2p = np.concatenate([so2_64, np.ones(pad)])
        dp = np.concatenate([d64, np.zeros(pad)])
    else:
        u3p, sbp, so2p, dp = u3_64, sb_64, so2_64, d64
    try:
        with jax.enable_x64(True):
            x, dainv, q = _exact_tail_prog(
                jnp.asarray(u3p), jnp.asarray(sbp), jnp.asarray(so2p),
                jnp.asarray(dp), jnp.float64(kappa))
            x = np.asarray(x, np.float64)[:n]
            dainv = np.asarray(dainv, np.float64)[:n]
            q = np.asarray(q, np.float64)[:n]
    except jax.errors.JaxRuntimeError as e:
        if "RESOURCE_EXHAUSTED" not in str(e):  # XLA's out-of-memory status
            raise
        print(f"oi_full: device exact tail out of memory at n={npad}; "
              f"using the host f64 direct solve")
        return None, None
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(dainv))
            and np.all(np.isfinite(q))):
        print(f"oi_full: device exact tail returned non-finite values at "
              f"n={npad}; using the host f64 direct solve")
        return None, None
    return x, (dainv, q)


def _exact_sb_diag(so2_np, pack, bd):
    """EXACT posterior-covariance diagonal from the factor diagonals
    ``pack = (diag(A^-1), diag(B A^-1 B))``, via two algebraically
    identical forms picked per cell for numerical stability:

        diag(Sb) = so^2 - so^4 * diag(A^-1)     (tight cells, so <= sb)
        diag(Sb) = diag(B) - diag(B A^-1 B)     (loose cells, so > sb)

    The first form cancels when so >> sb (relative error grows as
    (so/sb)^2 * eps — ruinous on data-poor cells whenever eps is coarse),
    the second cancels in the opposite
    regime; each is eps-stable where it is used because its subtrahend
    is then small relative to the minuend.  Clipped to [0, diag(B)]
    (the mathematical range) against rounding at the extremes."""
    dainv, q = pack
    form1 = so2_np - so2_np * so2_np * dainv
    if q is not None:
        form1 = np.where(so2_np > bd, bd - q, form1)
    return np.clip(form1, 0.0, bd)


DEVICE_EXACT_RESID_GATE = 1e-5  # acceptance bar for the device f64
# exact tail, measured by the host-f64 row-sampled TRUE residual.  It sits
# two orders BELOW the f32 representation wall (~1e-3+), so any f32-class
# failure mode trips the host-f64 re-solve, while the statistical
# significance line (posterior-std norm, ~1e-1 relative) stays 4 orders
# away.  Native f64 on an H100 (400 W) measured 3.7e-10 (2025 cells) and
# 5.4e-10 (10,000 cells) at sigma_b/sigma_o = 150, four orders under the
# gate.


def _exact_device_wanted() -> bool:
    """OISAT_EXACT_DEVICE=0 opts out of the on-device exact tail (the
    host f64 direct solve then serves)."""
    import os

    return os.environ.get("OISAT_EXACT_DEVICE", "1") != "0"


@partial(jax.jit, static_argnames=("diag_block",))
def _exact_tail_prog(u3, sb, so2, d, kappa,
                     diag_block: int = EXACT_TAIL_BUCKET):
    # the default block tracks the bucket so retuning EXACT_TAIL_BUCKET
    # cannot break the k | n precondition below
    """Device exact tail, traced in float64: build the dense correlation kernel from
    unit vectors, scale to A = D_b G D_b + D_o^2, Cholesky-factor, solve
    the innovation, and accumulate per-cell ``diag(A^-1)`` AND
    ``q = diag(B A^-1 B)`` in identity-column blocks (the same
    half-solve trick as :func:`oi_full_dense`'s posterior diagonal —
    peak memory stays at two (n, n) buffers plus (n, diag_block)
    blocks).  The q columns come free of an extra solve:
    ``L^-1 B[:, blk] = L^-1 (A - R)[:, blk] = L^T[:, blk] - so2 * V``
    with ``V = L^-1 I[:, blk]``.  Both diagonals are PURE sums of
    squares, so each is accurate to the arithmetic's eps relative to
    ITSELF — the caller picks the cancellation-free posterior form per
    cell (see :func:`_exact_sb_diag`)."""
    g = jnp.clip(u3 @ u3.T, -1.0, 1.0) - 1.0
    g = jnp.exp(jnp.maximum(g * kappa, -60.0))
    a = g * (sb[None, :] * sb[:, None]) + jnp.diag(so2)
    l = jax.lax.linalg.cholesky(a)
    w = jax.lax.linalg.triangular_solve(l, d[:, None], left_side=True,
                                        lower=True)
    x = jax.lax.linalg.triangular_solve(l, w, left_side=True, lower=True,
                                        transpose_a=True)[:, 0]
    n = a.shape[0]
    k = min(diag_block, n)
    # the trailing-block loop requires k | n (every block is exactly k
    # columns); callers reach here through _exact_tail_device's bucket
    # padding, whose multiple the default diag_block tracks.  A
    # non-divisible combination would silently emit wrong-length
    # diagonals — fail the TRACE instead.
    if n % k != 0:
        raise ValueError(
            f"_exact_tail_prog: n={n} must be a multiple of "
            f"diag_block={k} (pad with decoupled rows like "
            f"_exact_tail_device, or pass a divisor diag_block)")
    # L^-1 e_j is zero above row j, so block j0's identity columns only
    # need the TRAILING (n-j0) sub-triangle — an unrolled loop over
    # shrinking solves costs n^3/3 total instead of the full-solve n^3
    # (the dominant term of the whole tail).  The q columns' L^T part
    # has entries ABOVE j0 too; those contribute a plain row-sum of
    # squares of L[blk, :j0] (no solve).
    dainv_parts = []
    q_parts = []
    seq = jnp.zeros((), a.dtype)  # data-dependency token: the blocks are
    # mutually independent, so without it XLA may co-schedule several
    # (m, k) f64 solve workspaces at once — chaining each block's eye on
    # the previous block's first output element pins them sequential
    # (0.0 * x is NOT constant-foldable in floating point, so the
    # dependency survives optimization)
    for j0 in range(0, n, k):
        m = n - j0
        sub = l[j0:, j0:]
        cols = jnp.eye(m, k, dtype=a.dtype) * (1.0 + 0.0 * seq)
        v = jax.lax.linalg.triangular_solve(
            sub, cols, left_side=True, lower=True)
        so2_blk = so2[j0:j0 + k]
        ltc = l[j0:j0 + k, j0:].T  # L^T[j0:, blk] in sub coordinates
        vb = ltc - v * so2_blk[None, :]
        head = l[j0:j0 + k, :j0]  # rows of L left of the sub-triangle
        q_head = (jnp.sum(head * head, axis=1) if j0
                  else jnp.zeros((k,), a.dtype))
        dainv_parts.append(jnp.sum(v * v, axis=0))
        q_parts.append(q_head + jnp.sum(vb * vb, axis=0))
        seq = dainv_parts[-1][0]
    dainv = jnp.concatenate(dainv_parts)
    q = jnp.concatenate(q_parts)
    return x, dainv, q




def _sampled_resid_f64(u3_64, sb_64, so2_64, x64, d64, kappa: float,
                       m: int = 512, seed: int = 1):
    """Row-sampled TRUE-operator relative residual ||d - A_f64 x|| / ||d||.
    Uniform row sampling gives an unbiased ||r||^2 estimate at O(m n)
    kernel evals (~0.1 s for 512 rows at n ~ 10k) — a full f64 rebuild
    costs seconds and an f32 device sweep reads its own representation
    noise (~1e-1 at tight conditioning), so neither can serve as the
    verification here."""
    n = u3_64.shape[0]
    m = min(m, n)
    rows = np.random.default_rng(seed).choice(n, size=m, replace=False)
    g_rows = _kernel_block_f64(np.ascontiguousarray(u3_64[rows]), 0, m,
                               kappa, full=u3_64)
    r_rows = d64[rows] - (sb_64[rows] * (g_rows @ (sb_64 * x64))
                          + so2_64[rows] * x64[rows])
    dn = float(np.linalg.norm(d64))
    return (float(np.sqrt(n / m) * np.linalg.norm(r_rows)) / dn
            if dn > 0 else 0.0)


def _make_apply_a_f64(u3_64, sb_64, so2_64, kappa: float,
                      row_block: int = 512):
    """Host-f64 ``x -> (B + R) x``: the TRUE operator for mixed-precision
    iterative refinement.  The device solve's f32 kernel elements carry
    ~1 ulp RELATIVE error — an operator perturbation delta_B whose effect
    on the solution scales with cond(A) = O((sigma_b/sigma_o)^2): at the
    monthly-average conditioning (sigma_b/sigma_o ~ 150-300) an
    f32-CONVERGED increment still sits percents-to-tens-of-percents from
    the f64 solution.  Evaluating the residual here in f64 (Gram-form d2
    is safe at f64 eps: the kappa ~ 450 amplification leaves ~1e-13
    relative) and re-solving the correction on device contracts that
    error by the inner solve's relative accuracy per pass.

    The exp'd kernel (the dominant per-pass cost: ~94M f64 exps at
    production month sizes take seconds on one host core) is CACHED
    densely across passes when it fits ``REFINE_CACHE_BYTES``; beyond
    that each apply streams row blocks at O(row_block * n) memory."""
    n = u3_64.shape[0]
    cache = [None]
    use_cache = n * n * 8 <= REFINE_CACHE_BYTES

    def _kernel_rows(s, e, out=None):
        return _kernel_block_f64(u3_64, s, e, kappa, out=out)

    def apply_a(x_64):
        y = so2_64 * x_64
        dx = sb_64 * x_64
        if use_cache:
            if cache[0] is None:
                cache[0] = np.empty((n, n))
                for s in range(0, n, row_block):
                    e = min(s + row_block, n)
                    _kernel_rows(s, e, out=cache[0][s:e])
            y += sb_64 * (cache[0] @ dx)
            return y
        for s in range(0, n, row_block):
            e = min(s + row_block, n)
            y[s:e] += sb_64[s:e] * (_kernel_rows(s, e) @ dx)
        return y

    return apply_a


def _refine_f64(x0_f32, d64, apply_a, solve, max_passes: int,
                target: float = 0.0):
    """Mixed-precision iterative refinement: x held in host f64, residual
    r = d - A x evaluated with the TRUE f64 operator
    (:func:`_make_apply_a_f64`), correction solved on device in f32 via
    ``solve(rhs_f32_unit) -> x``.  Each pass contracts the error by the
    inner solve's relative accuracy (classic IR; the inner
    perturbed-operator solve is the contraction factor, so even a
    ~25%-accurate extreme-conditioning inner solve converges
    geometrically — measured ~10x per pass).  Runs until the f64 relative
    residual reaches ``target`` or ``max_passes`` corrections have been
    applied; a pass that fails to improve the residual 2x stops the loop
    (the inner-solve floor has been reached).  Returns (x64, f64 relative
    residual, extra iteration count, passes applied)."""
    x64 = np.asarray(x0_f32, np.float64)
    dn = float(np.linalg.norm(d64))
    if dn == 0.0:
        return x64, 0.0, 0, 0
    extra = 0
    applied = 0
    rrel_prev = np.inf
    r64 = d64 - apply_a(x64)
    rrel = float(np.linalg.norm(r64)) / dn
    while (applied < max_passes and rrel > max(target, 1e-9)
           and rrel < 0.5 * rrel_prev):
        s = float(np.max(np.abs(r64)))
        dx, it = solve(np.asarray(r64 / s, np.float32))
        extra += int(it)
        x64 += s * np.asarray(dx, np.float64)
        applied += 1
        rrel_prev = rrel
        r64 = d64 - apply_a(x64)
        rrel = float(np.linalg.norm(r64)) / dn
        if rrel >= rrel_prev:  # floor reached; keep the better iterate
            x64 -= s * np.asarray(dx, np.float64)
            rrel = rrel_prev
            applied -= 1  # the reverted correction is not in x (its
            # iterations stay in the cost count)
            break
    return x64, rrel, extra, applied


def oi_full_matfree(xa, y, sigma_b, sigma_o, lat, lon, length_scale_km: float,
                    block: int = 1024, cg_tol: float = 1e-6,
                    cg_maxiter: int = 400, probe_sep_factor: float = 4.0,
                    max_colors: int = 192, cluster_radius_factor: float = 0.25,
                    valid=None, precond: str = "auto", nystrom_k: int = None,
                    refine="auto", mesh=None):
    """Full-covariance OI for domains beyond the dense limit.

    Dense-cell inputs (1-D, finite; padded internally to a ``block``
    multiple); same contract as :func:`oi_full_dense` but O(block * N)
    memory:

      * ``xb``/``increment``: exact up to the CG tolerance — one
        preconditioned CG solve of ``(B + R) w = y - xa`` with the B matvec
        generated tile-by-tile from unit-vector coordinate differences.
      * posterior diagonal ``diag(B - B A^-1 B)``: distance-colored probing
        at cluster representatives, colors solved together as extra CG
        right-hand sides (each CG iteration pays one covariance-tile sweep
        regardless of the column count).  Three error terms, all bounded:
        same-color cross-terms decay with the probe separation
        (``probe_sep_factor`` x L; ~1e-2 kernel-scale at the default 4, use
        6 for ~1e-4); cells within ``cluster_radius_factor * L`` of a
        representative share its diagonal rescaled by the variance ratio
        (relative error O((radius/L)^2) ~ 6e-2 worst-case at the default
        0.25 — clusters only form where the grid is finer than the radius,
        e.g. lat/lon pole crowding, where exact probing would need one
        color per crowded neighbour); and the separation guarantee is
        never relaxed — when more than ``max_colors`` colors are needed
        the probes run in multiple CG chunks instead of merging colors.

    ``precond``: "jacobi" | "nystrom" | "auto" (default — Nystrom
    deflation for npad >= NYSTROM_MIN_CELLS, where production problems
    with monthly-average observation errors reach cond(A) ~ 1e7 and
    Jacobi CG stalls at an f32 floor of ~1e-1 relative residual;
    see :func:`_pcg_solve_nystrom`).  ``nystrom_k``: sketch rank
    (default min(2048, npad // 4), lane-rounded).

    ``refine`` (Nystrom path only — the Jacobi path serves small /
    mildly-conditioned problems where the f32 solve is already at
    tolerance): "auto" (default) takes the DIRECT exact tail when
    npad <= REFINE_MAX_CELLS — on device in f64
    (:func:`_exact_tail_device`, accepted only under
    ``DEVICE_EXACT_RESID_GATE`` against the host-f64 sampled residual;
    ``OISAT_EXACT_DEVICE=0`` opts out), with host f64
    (:func:`_direct_solve_f64`) serving when the device reports
    out-of-memory or fails the gate — and keeps the f32
    deflated PCG beyond that size; an int p forces the f32 PCG
    followed by exactly p mixed-precision iterative-refinement passes
    (f64 host residual with the TRUE kernel + f32 device correction
    solves — removes the f32 kernel REPRESENTATION error, which an
    f32-converged residual cannot see and which scales with cond(A):
    measured 25% RMS increment error at sb/so ~ 300 despite
    cg_resid = 8e-7; each pass contracts by the inner solve's relative
    accuracy, ~10x on well-deflated problems, but STALLS where the
    correction RHS concentrates in modes the f32 matvec noise owns —
    hence the direct default).  ``info["f64_resid"]`` reports the
    true-operator relative residual (it becomes ``cg_resid`` when the
    direct solve or refinement ran); ``info["solver"]`` says which path
    produced x.

    ``mesh``: a `jax.sharding.Mesh` shards every covariance-tile sweep
    (CG matvecs, the Nystrom sketch, SLQ recurrences, probing) over ALL
    mesh devices via a mid-program sharding constraint on the chunk axis
    of the kernel tile — the chunk-partial sum lowers to a psum, inputs
    stay replicated (<~3 MB at 64k cells).  Results match the
    single-device solve to f32 reduction-order noise (~1e-6, tested on
    the virtual 8-device CPU mesh).

    Returns (xb, ak, increment, err, info dict) trimmed to the input length.
    """
    if refine != "auto":
        import operator

        # numpy integers fail isinstance(int) checks and would silently
        # skip requested refinement; index() also rejects floats/strings
        # loudly instead of accepting them as "auto-like"
        refine = operator.index(refine)
    if mesh is not None and mesh.devices.size == 1:
        mesh = None  # the single consumer of the gate: a 1-device mesh
        # would add pointless sharding constraints (and callers would
        # otherwise each duplicate this check)
    n_in = int(np.size(xa))
    npad = int(np.ceil(n_in / block)) * block
    if npad != n_in:
        pad = npad - n_in

        def _pad(a, fill):
            return np.concatenate([np.asarray(a, np.float64).ravel(),
                                   np.full(pad, fill)])

        xa = _pad(xa, 0.0)
        y = _pad(y, 0.0)
        sigma_b = _pad(sigma_b, 0.0)  # zero-sigma rows decouple from B
        sigma_o = _pad(sigma_o, 1.0)
        lat = _pad(lat, 0.0)
        lon = _pad(lon, 0.0)
        if valid is None:
            valid = np.arange(npad) < n_in
        else:
            valid = np.concatenate([np.asarray(valid, bool), np.zeros(pad, bool)])

    u3 = _unit_vectors(lat, lon)
    # full-precision host copies FIRST: the f64 direct solve / refinement /
    # residual verification must see the caller's data, not the
    # f32-round-tripped device copies (a 1-ulp relative perturbation of
    # sigma_b/sigma_o is exactly the operator-error class the f64 paths
    # exist to remove)
    sb_f64 = np.asarray(sigma_b, np.float64).ravel()
    so_f64 = np.asarray(sigma_o, np.float64).ravel()
    sigma_b = jnp.asarray(sb_f64, jnp.float32)
    sigma_o2 = jnp.asarray(so_f64, jnp.float32) ** 2
    innov = jnp.asarray(np.asarray(y, np.float64) - np.asarray(xa, np.float64),
                        jnp.float32)

    n = u3.shape[0]
    if valid is None:
        valid = np.ones(n, bool)
    valid = np.asarray(valid, bool)
    vidx = np.flatnonzero(valid)
    bd = sb_f64 ** 2
    so2_np = so_f64 ** 2

    use_nystrom = (precond == "nystrom"
                   or (precond == "auto" and n >= NYSTROM_MIN_CELLS))
    iters_total = 0
    resid_max = 0.0
    d64 = np.asarray(y, np.float64).ravel() - np.asarray(xa, np.float64).ravel()
    if use_nystrom:
        k = nystrom_k or min(2048, n // 4)
        k = max(LANES, int(np.ceil(k / LANES)) * LANES)
        f64_resid = None
        applied = 0
        solver = "pcg_f32"
        kappa = (EARTH_RADIUS_KM / float(length_scale_km)) ** 2
        direct = None
        diag_pack = None
        if refine == "auto" and n <= REFINE_MAX_CELLS:
            # Production-size months take the EXACT direct solve: at
            # monthly-average conditioning (cond(A) ~ 1e7-1e9) any
            # f32-matvec inner solver — PCG or iterative refinement —
            # stalls orders above the posterior-std significance line
            # (measured: IR froze at 4.6e-3 relative true residual on the
            # bench month).  The tail runs ON DEVICE in f64 with the
            # host-f64 row-sampled residual as the acceptance gate; the
            # host dpotrf path serves when the device reports
            # out-of-memory or the result fails the gate.  Either factor
            # also yields diag(A^-1), making the posterior diagonal and
            # AK EXACT (no Nystrom sketch is built on this path at all).
            u3_64 = _sphere_points(lat, lon)
            if _exact_device_wanted():
                direct, diag_pack = _exact_tail_device(u3_64, sb_f64, so2_np,
                                                   d64, kappa)
                if direct is not None:
                    f64_resid = _sampled_resid_f64(u3_64, sb_f64, so2_np,
                                                   direct, d64, kappa)
                    if f64_resid > DEVICE_EXACT_RESID_GATE:
                        print(f"oi_full: device exact tail failed the "
                              f"residual gate ({f64_resid:.2e} > "
                              f"{DEVICE_EXACT_RESID_GATE:.0e}); re-solving "
                              f"on host")
                        direct = diag_pack = None
                    else:
                        solver = "direct_f64_dev"
            if direct is None:
                direct, diag_pack = _direct_solve_f64(u3_64, sb_f64, so2_np,
                                                  d64, kappa, want_diag=True)
                if direct is not None:
                    f64_resid = _sampled_resid_f64(u3_64, sb_f64, so2_np,
                                                   direct, d64, kappa)
                    solver = "direct_f64"
        if direct is not None:
            x64 = direct
            resid_max = f64_resid
        else:
            nys_u, nys_lam = _nystrom_factor(u3, sigma_b, jax.random.key(0),
                                             k, float(length_scale_km),
                                             block, mesh=mesh)
            so2_min = float(np.min(so2_np[valid]))
            c2 = jnp.maximum(jnp.float32(so2_min),
                             4.0 * jnp.float32(1.2e-7) * nys_lam[-1])
            dcap = np.asarray(
                jnp.sum(nys_u * nys_u * nys_lam[None, :], axis=1),
                np.float64)  # diag of the sketched prior
            dtail = np.maximum(bd - dcap, 0.0)
            dcomp = jnp.asarray(dtail + so2_np, jnp.float32)
            # innovation solve only — the posterior diagonal needs no probe
            # columns here (Woodbury on the same factor, below); pad the
            # single column to the f32 sublane count (8), NOT to LANES:
            # zero columns start converged but still ride every CG matmul,
            # and a 128-wide pad was measured spending 16x the flops of
            # the solve
            rhs = jnp.zeros((n, 8), jnp.float32).at[:, 0].set(innov)
            x, iters, resid = _pcg_solve_nystrom(
                u3, sigma_b, sigma_o2, rhs, nys_u, nys_lam, c2, dcomp,
                float(length_scale_km), block, cg_tol, cg_maxiter,
                mesh=mesh)
            iters_total = int(iters)
            resid_max = float(resid)
            x64 = np.asarray(x[:, 0], np.float64)
            if isinstance(refine, int):
                max_passes, target = refine, 0.0
            else:  # auto beyond REFINE_MAX_CELLS: refinement's O(n^2)
                # host passes outgrow their value; huge coarse domains
                # are mildly conditioned and converge on device (the
                # sampled-residual check below still verifies the result)
                max_passes, target = 0, 0.0
            if max_passes > 0:
                # mixed-precision IR (kept for explicit ``refine=p``): f64
                # host residual against the true kernel + f32 device
                # correction solves with the same deflation preconditioner;
                # contracts by the inner solve's relative accuracy per pass
                u3_64 = _sphere_points(lat, lon)

                def _corr_solve(r32):
                    rhs_c = jnp.zeros((n, 8), jnp.float32).at[:, 0].set(
                        jnp.asarray(r32))
                    xc, itc, _ = _pcg_solve_nystrom(
                        u3, sigma_b, sigma_o2, rhs_c, nys_u, nys_lam, c2,
                        dcomp, float(length_scale_km), block, cg_tol,
                        cg_maxiter, mesh=mesh)
                    return np.asarray(xc[:, 0]), itc

                x64, f64_resid, extra, applied = _refine_f64(
                    x64, d64, _make_apply_a_f64(u3_64, sb_f64, so2_np, kappa),
                    _corr_solve, max_passes, target)
                iters_total += extra
                # the f64 residual is the TRUE-operator measure of the
                # returned x — authoritative over the f32-internal estimate
                resid_max = f64_resid
            else:
                # no f64 refinement ran: the f32-internal CG residual can
                # understate the TRUE residual by orders at tight
                # conditioning (the representation wall) — verify the
                # returned x against the f64 operator by row sampling
                # (O(m n) kernel evals, ~0.5 s at 64k cells) and report
                # THAT as the solve's residual
                f64_resid = _sampled_resid_f64(_sphere_points(lat, lon),
                                               sb_f64, so2_np, x64, d64,
                                               kappa)
                resid_max = max(resid_max, f64_resid)
        # Increment in f64 on host via the R-form  inc = d - R x  (exact
        # algebra: B A^-1 = I - R A^-1).  Both forms' absolute error is
        # bounded by the TRUE residual ||d - A_f64 x|| (R A^-1 and B A^-1
        # are SPD contractions), but the R-form needs no extra covariance
        # sweep and adds no f32 matvec noise of its own.
        increment = d64 - so2_np * x64

        if diag_pack is not None:
            # EXACT posterior diagonal from the direct factor (device or
            # host): diag(Sb) = so^2 - so^4 diag(A^-1) — see
            # :func:`_exact_sb_diag`.  AK downstream is then exact too.
            sb_diag = _exact_sb_diag(so2_np, diag_pack, bd)
        elif direct is not None:
            # pathological corner: the host triangular inversion failed
            # after a successful factorization.  No sketch exists on the
            # direct path; close the diagonal with the per-cell scalar-OI
            # value (a documented estimate, flagged via exact_diag=False).
            sb_diag = np.where(bd + so2_np > 0,
                               bd * so2_np / (bd + so2_np), 0.0)
        else:
            # Posterior diagonal from the Nystrom factor itself, exact for
            # the sketched prior B^ = U diag(lam) U^T in EVERY noise regime
            # (the B - B A^-1 B probing form loses all significance when
            # sigma_o << sigma_b — Sb ~ so^2 emerges as the difference of
            # two O(diag B) quantities; the R - R A^-1 R form cancels in
            # the opposite regime; diag(U S U^T) with
            # S = (lam^-1 + U^T R^-1 U)^-1 cancels in neither, and carries
            # no probe cross-term noise):
            #   S = lam^1/2 (I + lam^1/2 W lam^1/2)^-1 lam^1/2,
            #   W = U^T R^-1 U
            # The k x k Cholesky runs in float64 on the host — the inner
            # matrix conditioning tracks cond(A) ~ 1e7, past f32's reach.
            # Prior variance the k modes miss (dtail = diag B - diag B^)
            # is closed per-cell as an independent scalar-OI remainder:
            # those tail modes are nearly unfiltered by the analysis,
            # contributing dtail * so^2 / (dtail + so^2) each.
            w_small = np.asarray(
                jax.lax.dot_general(nys_u, nys_u / sigma_o2[:, None],
                                    (((0,), (0,)), ((), ())),
                                    precision=jax.lax.Precision.HIGHEST),
                np.float64)
            w_small = 0.5 * (w_small + w_small.T)  # f32 matmul asymmetry
            lam64 = np.asarray(nys_lam, np.float64)
            lam_sqrt = np.sqrt(lam64)
            t_mat = np.eye(k) + lam_sqrt[:, None] * w_small * lam_sqrt[None, :]
            import scipy.linalg as _sla
            try:
                lt = _sla.cholesky(t_mat, lower=True)
                m_right = _sla.solve_triangular(
                    lt, np.diag(lam_sqrt), lower=True).T  # lam^1/2 Lt^-T
            except np.linalg.LinAlgError:
                # t_mat = I + PSD is PD in exact arithmetic; f32 noise in W
                # can in principle tip a near-null direction negative.
                # Eigen-clip fallback: S^1/2 = lam^1/2 Q max(th, 1)^-1/2
                # (eigenvalues of I + PSD are >= 1 exactly, so 1 is the
                # clip floor — NOT 0, which would divide by zero on a
                # clipped direction) keeps the production month alive
                # instead of crashing it.
                th, q = np.linalg.eigh(t_mat)
                m_right = (lam_sqrt[:, None] * q) / np.sqrt(np.maximum(th, 1.0))
            v_cols = jax.lax.dot_general(
                nys_u, jnp.asarray(m_right, jnp.float32),
                (((1,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST)
            sb_diag = np.asarray(jnp.sum(v_cols * v_cols, axis=1), np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                sb_diag = sb_diag + np.where(dtail > 0,
                                             dtail * so2_np / (dtail + so2_np),
                                             0.0)
        ncolors = 0
        nchunks = 0
        nreps = 0
    else:
        # coloring runs on the real cells only — padding rows (sigma_b =
        # 0) share one location and would otherwise force one color each
        rep_v, colors_v = _distance_coloring_cached(
            np.asarray(lat)[valid], np.asarray(lon)[valid],
            probe_sep_factor * float(length_scale_km),
            cluster_radius_factor * float(length_scale_km),
            prefer=np.asarray(sigma_b, np.float64)[valid] > 0)
        rep = np.full(n, -1, np.int64)
        rep[vidx] = vidx[rep_v]
        colors = np.full(n, -1, np.int64)
        colors[vidx] = colors_v  # color at representatives; -1 on members
        ncolors = int(colors.max()) + 1
        is_rep = colors >= 0
        nreps = int(is_rep.sum())

        # batched flow, chunked when the (uncapped) color count exceeds
        # the per-CG column budget: within each chunk the innovation
        # solve (first chunk only) and every probe share each
        # covariance-tile sweep.
        #   [w | Xrp] = A^-1 [innov | R P];  A^-1 B P = P - Xrp  (exact:
        #   B = A - R, and R P scales each unit probe by its cell's
        #   sigma_o^2);  [Bw | B A^-1 B P] = B [w | P - Xrp]
        # Solving R-scaled probes instead of the old Q = B P right-hand
        # sides saves one covariance sweep per chunk.
        quad_rep = np.zeros(n, np.float64)   # diag(B A^-1 B) at reps
        increment = None
        nchunks = max(1, -(-ncolors // max_colors))
        for ci in range(nchunks):
            c0, c1 = ci * max_colors, min((ci + 1) * max_colors, ncolors)
            sel = is_rep & (colors >= c0) & (colors < c1)
            # pad the column count to a lane multiple: fewer compile
            # variants (K changes with the coloring) and aligned matmul
            # tiles; zero columns start converged and cost nothing.
            lead = 1 if ci == 0 else 0
            kpad = int(np.ceil(max(c1 - c0 + lead, 1) / LANES)) * LANES
            cells_sel = np.flatnonzero(sel)
            punit = np.zeros((n, kpad - lead), np.float32)
            punit[cells_sel, colors[sel] - c0] = 1.0
            prp = np.zeros((n, kpad - lead), np.float32)
            prp[cells_sel, colors[sel] - c0] = so2_np[cells_sel]
            pj = jnp.asarray(prp)
            rhs = (jnp.concatenate([innov[:, None], pj], axis=1)
                   if ci == 0 else pj)
            x, iters, resid = _cg_solve_multi(
                u3, sigma_b, sigma_o2, rhs, float(length_scale_km), block,
                cg_tol, cg_maxiter, mesh=mesh)
            tcols = jnp.asarray(punit) - x[:, lead:]       # A^-1 B P
            s_all = _b_matmat(u3, sigma_b,
                              jnp.concatenate([x[:, :lead], tcols], axis=1),
                              float(length_scale_km), block, mesh=mesh)
            iters_total += int(iters)
            resid_max = max(resid_max, float(resid))
            if ci == 0:
                increment = s_all[:, 0]
            s = np.asarray(s_all[:, lead:], np.float64)  # B A^-1 B P
            cells = np.flatnonzero(sel)
            quad_rep[cells] = s[cells, colors[cells] - c0]

        # members inherit their representative's diagonal, rescaled by
        # the local variance ratio (M_ii ~ (sigma_i/sigma_rep)^2
        # M_rep,rep within cluster_radius_factor * L — relative error
        # O((radius/L)^2))
        quad = np.zeros(n, np.float64)
        vr = rep[vidx]
        scale = np.divide(bd[vidx], bd[vr], out=np.ones(vidx.size),
                          where=bd[vr] > 0)
        quad[vidx] = quad_rep[vr] * scale
        sb_diag = bd - quad

    increment = np.asarray(increment, np.float64)
    xb = np.asarray(xa, np.float64).ravel() + increment
    with np.errstate(invalid="ignore", divide="ignore"):
        ak = 1.0 - sb_diag / bd
    err = np.sqrt(np.maximum(sb_diag, 0.0))
    direct_ran = use_nystrom and solver.startswith("direct")
    info = {"cg_iters": iters_total, "cg_resid": resid_max,
            "ncolors": ncolors, "nchunks": nchunks,
            "nreps": nreps,
            "precond": ("direct" if direct_ran
                        else f"nystrom(k={k})" if use_nystrom else "jacobi"),
            "solver": (solver + ("+ir" if applied else "")) if use_nystrom
                      else "pcg_f32",
            # True when the posterior diagonal (and hence err/AK) is the
            # EXACT diag(B - B A^-1 B) from the direct factor, not the
            # Nystrom tail-closure / colored-probing estimate
            "exact_diag": bool(use_nystrom and direct_ran
                               and diag_pack is not None),
            "refine_passes": applied if use_nystrom else 0,
            "f64_resid": f64_resid if use_nystrom else None,
            # absolute error bound on increment/xb: ||inc - inc_true|| =
            # ||R A^-1 r|| <= ||r|| (R A^-1 is an SPD contraction) —
            # reported only when r was verified against the f64 operator
            # (the f32-internal CG residual can understate the true one
            # by orders at tight conditioning); callers compare it to the
            # posterior's statistical std
            "resid_abs": (resid_max * float(np.linalg.norm(d64))
                          if use_nystrom and f64_resid is not None
                          else None)}
    return (np.asarray(xb, np.float64)[:n_in], ak[:n_in],
            np.asarray(increment, np.float64)[:n_in], err[:n_in], info)


def oi_full(xa2d, y2d, sigma_b2d, sigma_o2d, lat2d, lon2d, length_scale_km: float,
            regularization_on: bool = False, mesh=None):
    """Grid-shaped front end: NaN-compaction + padding + scatter-back.

    Inputs are normalized to O(1) magnitude before the f32 device compute:
    real VCDs reach ~1e18-1e19 (total O3), whose squares overflow float32
    (~3.4e38) inside the scan/SLQ formulations.  The update is
    scale-equivariant — xb/increment/err scale linearly, AK and the
    regularization curve are invariant — so dividing the four fields by one
    characteristic scale and re-multiplying the outputs is exact.

    Validity requires finite coordinates (a NaN lat/lon would poison every
    covariance row, not just its own cell) and ``sigma_o > 0`` (the scan /
    SLQ formulations apply ``D^-1``; a zero-error cell would turn the whole
    eigensolve NaN — use the scalar method for exact-observation cells)."""
    xa = np.asarray(xa2d, np.float64)
    y = np.array(y2d, np.float64, copy=True)
    y[y < 0] = 0.0  # reference semantics (optimal_interpolation.py:14)
    sb = np.asarray(sigma_b2d, np.float64)
    so = np.asarray(sigma_o2d, np.float64)
    lat = np.asarray(lat2d, np.float64)
    lon = np.asarray(lon2d, np.float64)
    valid = (np.isfinite(xa) & np.isfinite(y) & np.isfinite(sb)
             & np.isfinite(so) & (so > 0)
             & np.isfinite(lat) & np.isfinite(lon))
    idx = np.nonzero(valid.ravel())[0]
    n = idx.size
    if n == 0:
        nanf = np.full(xa.shape, np.nan)
        return OIFullResult(nanf, nanf.copy(), nanf.copy(), nanf.copy())

    with np.errstate(invalid="ignore"):
        scale = max(float(np.max(np.abs(f.ravel()[idx])))
                    for f in (xa, y, sb, so))
    if not np.isfinite(scale) or scale <= 0:
        scale = 1.0
    xa_n, y_n, sb_n, so_n = xa / scale, y / scale, sb / scale, so / scale

    if n > (DENSE_SCAN_MAX_CELLS if regularization_on else DENSE_MAX_CELLS):
        res = _oi_full_large(xa_n, y_n, sb_n, so_n, lat2d, lon2d, idx,
                             float(length_scale_km), regularization_on,
                             mesh=mesh)
        info = res.info
        if info:
            # the solver saw normalized fields; these two are FIELD-scaled
            # quantities (an absolute error bound and the posterior-std
            # norm) and must leave in the caller's physical units like
            # xb/increment/err — relative quantities (cg_resid) are
            # scale-invariant
            for key in ("resid_abs", "stat_norm"):
                if info.get(key) is not None:
                    info[key] = info[key] * scale
        return OIFullResult(res.xb * scale, res.averaging_kernel,
                            res.increment * scale, res.error * scale,
                            info)

    npad = int(np.ceil(n / LANES)) * LANES

    def take(arr, fill):
        out = np.full(npad, fill)
        out[:n] = np.asarray(arr, np.float64).ravel()[idx]
        return jnp.asarray(out, jnp.float32)

    if regularization_on:
        from oisat.ops.oi import regularization_grid

        xb_v, ak_v, inc_v, err_v, reg_index, _ = oi_full_dense_scan(
            take(xa_n, 0.0), take(y_n, 0.0), take(sb_n, 0.0), take(so_n, 1.0),
            take(lat2d, 0.0), take(lon2d, 0.0), float(length_scale_km),
            regularization_grid().astype(np.float32))
        r_chosen = float(regularization_grid()[int(reg_index)])
    else:
        xb_v, ak_v, inc_v, err_v = oi_full_dense(
            take(xa_n, 0.0), take(y_n, 0.0), take(sb_n, 0.0), take(so_n, 1.0),
            take(lat2d, 0.0), take(lon2d, 0.0), float(length_scale_km))
        r_chosen = 1.0

    # f32 representation wall (same physics as the matfree path, see the
    # module docstring): at tight-obs conditioning the DEVICE dense solve's
    # increment silently drifts 10-25% from f64 even though the algebra is
    # exact — re-solve the innovation system at the chosen factor exactly
    # in f64 (on the device, or on the host) when the conditioning
    # estimate crosses the ~1e-3-error line.  Cost: a Cholesky of n^3/3
    # flops (~3.6e11 at n = 10240) — paid only by tight-conditioned
    # months, where a silently-wrong increment is the alternative.
    sbv = np.asarray(sb_n, np.float64).ravel()[idx] * np.sqrt(r_chosen)
    sov = np.asarray(so_n, np.float64).ravel()[idx]
    info = None
    if sov.size and (np.max(sbv) / np.min(sov)) ** 2 > 1e4:
        xav = np.asarray(xa_n, np.float64).ravel()[idx]
        d64 = np.asarray(y_n, np.float64).ravel()[idx] - xav
        kappa = (EARTH_RADIUS_KM / float(length_scale_km)) ** 2
        u3_64 = _sphere_points(np.asarray(lat2d, np.float64).ravel()[idx],
                               np.asarray(lon2d, np.float64).ravel()[idx])
        x64 = diag_pack = None
        rr = None
        how = "direct_f64"
        if _exact_device_wanted():
            x64, diag_pack = _exact_tail_device(u3_64, sbv, sov ** 2, d64, kappa)
            if x64 is not None:
                rr = _sampled_resid_f64(u3_64, sbv, sov ** 2, x64, d64, kappa)
                if rr > DEVICE_EXACT_RESID_GATE:
                    x64 = diag_pack = rr = None
                else:
                    how = "direct_f64_dev"
        if x64 is None:
            x64, diag_pack = _direct_solve_f64(u3_64, sbv, sov ** 2, d64, kappa,
                                           want_diag=True)
            if x64 is not None:
                rr = _sampled_resid_f64(u3_64, sbv, sov ** 2, x64, d64, kappa)
        if x64 is not None:
            inc64 = d64 - sov ** 2 * x64
            inc_v = np.concatenate([inc64, np.zeros(npad - n)])
            xb_v = np.concatenate([xav + inc64, np.zeros(npad - n)])
            info = {"solver": "dense+" + how, "reg": r_chosen,
                    "f64_resid": rr,
                    "exact_diag": diag_pack is not None}
            if diag_pack is not None:
                # the f32 dense diagonal shares the representation wall
                # with the increment — replace err/AK with the exact
                # values from the same factor (diag(Sb) in the solver's
                # normalized units like err_v; AK is scale-invariant)
                sbd = _exact_sb_diag(sov ** 2, diag_pack, sbv ** 2)
                err_v = np.concatenate([np.sqrt(sbd), np.zeros(npad - n)])
                with np.errstate(invalid="ignore", divide="ignore"):
                    akx = 1.0 - sbd / (sbv ** 2)
                ak_v = np.concatenate([akx, np.full(npad - n, np.nan)])

    def scatter(v, s=1.0):
        out = np.full(xa.size, np.nan)
        out[idx] = np.asarray(v, np.float64)[:n] * s
        return out.reshape(xa.shape)

    return OIFullResult(scatter(xb_v, scale), scatter(ak_v),
                        scatter(inc_v, scale), scatter(err_v, scale), info)


def _oi_full_large(xa, y, sb, so, lat2d, lon2d, idx, length_scale_km: float,
                   regularization_on: bool, block: int = 1024,
                   slq_probes: int = 8, slq_m: int = 60, mesh=None):
    """Beyond-dense branch of :func:`oi_full`: matrix-free CG + colored
    probing.  The regularization knee comes from the *full-domain* mean-AK
    curve computed by stochastic Lanczos quadrature
    (:func:`mean_ak_curve_slq`) — no dense subsampling, which would thin
    B's off-diagonal density and systematically bias the curve (measured:
    curve[0] 0.94 -> 0.65 at 1/16 random-scatter density).  The chosen
    factor then scales sigma_b exactly in the matrix-free solve."""
    n = idx.size
    npad = int(np.ceil(n / block)) * block

    def take(arr, fill):
        out = np.full(npad, fill)
        out[:n] = np.asarray(arr, np.float64).ravel()[idx]
        return out

    xa_v = take(xa, 0.0)
    y_v = take(y, 0.0)
    sb_v = take(sb, 0.0)
    so_v = take(so, 1.0)
    lat_v = take(lat2d, 0.0)
    lon_v = take(lon2d, 0.0)
    valid = np.zeros(npad, bool)
    valid[:n] = True

    if regularization_on:
        from oisat.ops.knee import kneedle_index_np
        from oisat.ops.oi import regularization_grid

        curve = mean_ak_curve_slq((lat_v, lon_v), sb_v, so_v,
                                  regularization_grid(), length_scale_km,
                                  block=block, n_probes=slq_probes, m=slq_m,
                                  valid=valid, mesh=mesh)
        with np.errstate(invalid="ignore"):
            reg_index = kneedle_index_np(regularization_grid(), curve,
                                         fallback=0)
        r = float(regularization_grid()[int(reg_index)])
        sb_v = sb_v * np.sqrt(r)  # r B == (sqrt(r) sigma_b) C (sqrt(r) sigma_b)

    xb_v, ak_v, inc_v, err_v, info = oi_full_matfree(
        xa_v, y_v, sb_v, so_v, lat_v, lon_v, length_scale_km,
        block=block, valid=valid, mesh=mesh)
    # Numerical-vs-statistical significance: the solve's absolute field
    # error is bounded by resid_abs = ||d - A x||_f64 (the R-form increment
    # error is R A^-1 r, an SPD contraction of r), while the analysis
    # itself is only determined to the posterior std.  When the numerical
    # bound sits well under the statistical uncertainty, tighter
    # convergence cannot change any scientifically meaningful digit — the
    # tight-obs regime (monthly-average sigma_o) hits the f32 kernel
    # representation wall at a RELATIVE residual ~1e-3 even after f64
    # iterative refinement, yet that is an order below ||posterior std||.
    stat = float(np.linalg.norm(np.asarray(err_v, np.float64)[:n]))
    num = info.get("resid_abs")
    info["stat_norm"] = stat
    if info["cg_resid"] > 1e-4 and (num is None or num > 0.3 * stat):
        print(f"WARNING: oi_full matrix-free CG did not fully converge "
              f"(residual {info['cg_resid']:.2e} after {info['cg_iters']} "
              f"iterations; field-error bound "
              f"{f'{num:.2e}' if num is not None else 'n/a'} vs "
              f"posterior-std norm {stat:.2e}); posterior fields are "
              f"correspondingly approximate")

    def scatter(v):
        out = np.full(np.asarray(xa).size, np.nan)
        out[idx] = np.asarray(v)[:n]
        return out.reshape(np.shape(xa))

    return OIFullResult(scatter(xb_v), scatter(ak_v), scatter(inc_v),
                        scatter(err_v), info)
