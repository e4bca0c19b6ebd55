"""Host-side regrid weight construction.

Host/device split of the reference's swath→grid regridding
(reference oisatgmi/interpolator.py:10-37, :100-160): unstructured
interpolation (qhull/KD trees) cannot run on device, but every
interpolation mode the reference offers is *linear in the data*, so the
host builds, once per granule geometry, a sparse weight map

    out[t] = sum_k  w[t, k] * Z[idx[t, k]]      (NaN where masked)

and the device applies it to all fields/levels of the granule as one
batched gather + weighted sum (:mod:`oisat.ops.regrid`).

Modes (reference ``interpolator_type``):
  1 — barycentric linear in Delaunay triangles  (= LinearNDInterpolator)
  2 — nearest neighbour                         (= NearestNDInterpolator)
  3 — local thin-plate-spline RBF, 5 neighbours (= RBFInterpolator(neighbors=5))
  4 — nearest neighbour via KD-tree             (= cKDTree.query gather)

Modes 2 and 4 are the same linear map (NearestNDInterpolator is a cKDTree
query); they share one builder.  All modes also get the reference's
"too-far" mask: target points farther than ``far_factor * threshold`` from
the nearest source pixel are NaN (factor 2 in the main interpolator
(interpolator.py:16-33), 1 in the SSMIS/GOSAT variants
(interpolator_ssmis.py:18-28, filler_gosat.py:11-32)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import Delaunay, cKDTree

__all__ = ["SparsePlan", "build_plan", "build_plan_structured", "fine_grid",
           "grid_spacing", "diag_threshold", "compact_plan"]


@dataclasses.dataclass(frozen=True)
class SparsePlan:
    """Sparse interpolation weights from Npix source pixels to T targets.

    Leaves are NumPy; move to device once per granule via the apply fns.
    ``mask``: True -> output NaN (too far / outside convex hull).

    ``sel`` (set by :func:`compact_plan`): int32 list of the source pixels
    the plan actually references; when present, ``idx`` indexes into the
    COMPACTED axis and appliers must gather ``z[..., sel]`` before use.
    A swath typically oversamples the analysis grid several-fold (OMI
    along-track pitch ~0.02° vs a 0.25° grid) and partly misses the
    domain, so only ~15–20% of its pixels ever carry weight — gathering
    on host before the H2D transfer cuts the dominant per-granule traffic
    (the value rows) by that same factor.
    """

    idx: np.ndarray  # (T, K) int32 into flattened source pixels
    w: np.ndarray  # (T, K) float64 weights
    mask: np.ndarray  # (T,) bool
    out_shape: tuple  # target grid shape (Ny, Nx)
    npix: int  # number of (flattened) source pixels (ORIGINAL, pre-compaction)
    sel: np.ndarray | None = None  # compacted source-pixel ids (host int32)

    @property
    def k(self) -> int:
        return self.idx.shape[1]


def compact_plan(plan: "SparsePlan", max_keep_frac: float = 0.85):
    """Remap ``plan`` onto only the source pixels it references.

    Exact: the appliers gather the same values and multiply the same
    weights in the same order, so outputs are bitwise identical (parity
    mode included).  Masked targets emit NaN regardless of their gathered
    values, so their (arbitrary) idx entries are pointed at slot 0.

    Skipped (returns ``plan`` unchanged) when the plan already carries a
    ``sel``, when its leaves are no longer NumPy (already on device), or
    when the referenced fraction exceeds ``max_keep_frac`` (e.g. the
    SSMIS global grid maps nearly 1:1 — a gather would cost host time for
    no transfer win).
    """
    if plan.sel is not None or not isinstance(plan.idx, np.ndarray):
        return plan
    safe_idx = np.where(np.asarray(plan.mask, bool)[:, None], 0, plan.idx)
    # O(npix) flag + remap instead of sort-based np.unique: indices are
    # bounded ints, and flatnonzero returns them ascending like unique did
    flags = np.zeros(plan.npix, bool)
    flags[safe_idx.ravel()] = True
    sel = np.flatnonzero(flags)
    if sel.size > max_keep_frac * plan.npix:
        return plan
    # int16 indices when the compacted source axis fits: halves the
    # per-orbit idx transfer for swath plans (index VALUES are < sel.size
    # regardless of how far the pixel axis is bucket-padded, so 2**15 is
    # the exact gate; XLA gathers take any integer index dtype)
    idt = np.int16 if sel.size <= 2 ** 15 else np.int32
    remap = np.zeros(plan.npix, idt)
    remap[sel] = np.arange(sel.size, dtype=idt)
    return dataclasses.replace(plan, idx=remap[safe_idx],
                               sel=sel.astype(np.int32))


def grid_spacing(lon2d: np.ndarray, lat2d: np.ndarray):
    """(dlon, dlat) of a regular 2-D mesh grid (reference interpolator.py:116-118)."""
    return float(abs(lon2d[0, 0] - lon2d[0, 1])), float(abs(lat2d[0, 0] - lat2d[1, 0]))


def diag_threshold(lon2d: np.ndarray, lat2d: np.ndarray) -> float:
    """Cell-diagonal distance threshold (reference interpolator.py:119)."""
    dlon, dlat = grid_spacing(lon2d, lat2d)
    return float(np.sqrt(dlon**2 + dlat**2))


def fine_grid(ctm_lon2d: np.ndarray, ctm_lat2d: np.ndarray, grid_size: float):
    """Fine analysis mesh spanning the CTM domain (reference interpolator.py:131-139).

    Uses the exact ``np.arange(min, max + grid_size, grid_size)`` semantics
    (float64) so grid point counts match the reference bit-for-bit.
    """
    lat_min = float(np.min(ctm_lat2d))
    lat_max = float(np.max(ctm_lat2d))
    lon_min = float(np.min(ctm_lon2d))
    lon_max = float(np.max(ctm_lon2d))
    lon_grid = np.arange(lon_min, lon_max + grid_size, grid_size)
    lat_grid = np.arange(lat_min, lat_max + grid_size, grid_size)
    return np.meshgrid(lon_grid, lat_grid)


def _tps_kernel(r: np.ndarray) -> np.ndarray:
    # thin-plate spline phi(r) = r^2 log r, with phi(0) = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        out = r * r * np.log(r)
    return np.where(r == 0.0, 0.0, out)


def _rbf_weights(points: np.ndarray, targets: np.ndarray, neighbors: int = 5,
                 tree=None):
    """Local TPS-RBF weights, scipy-RBFInterpolator-style (degree-1 poly).

    For each target: take its ``neighbors`` nearest source points, shift by
    the neighbourhood mean and scale by the max norm (scipy's domain
    normalization), solve the (K+3)x(K+3) KKT system for the evaluation
    weights.  Batched over targets with one vectorized ``np.linalg.solve``.

    Returns (nn, lam, bad) where ``bad`` marks targets whose KKT system
    was (near-)singular — duplicate pixel coordinates make the batched
    solve return ~1e15 weights WITHOUT raising, and the finite garbage
    would sail straight past the NaN missing-data channel (scipy raises
    LinAlgError on the same inputs); such targets are masked instead.
    Returns None when the whole batch is degenerate (collinear swath) —
    build_plan's skip-the-granule contract.
    """
    if tree is None:
        tree = cKDTree(points)
    k = min(neighbors, len(points))
    _, nn = tree.query(targets, k=k)
    nn = nn.reshape(len(targets), k)
    p = points[nn]  # (T, K, 2)
    shift = p.mean(axis=1, keepdims=True)
    ps = p - shift
    ts = targets[:, None, :] - shift  # (T, 1, 2)
    scale = np.maximum(np.abs(ps).max(axis=(1, 2), keepdims=True), 1.0e-30)
    ps = ps / scale
    ts = ts / scale
    # KKT system  [Phi P; P^T 0] [c; d] = [z; 0]; eval = [phi_t, p_t] @ [c; d]
    # weights lambda solve the transposed system.
    npoly = 3  # degree-1 monomials: 1, x, y
    T = len(targets)
    A = np.zeros((T, k + npoly, k + npoly))
    r = np.linalg.norm(ps[:, :, None, :] - ps[:, None, :, :], axis=-1)  # (T,K,K)
    A[:, :k, :k] = _tps_kernel(r)
    P = np.concatenate([np.ones((T, k, 1)), ps], axis=-1)  # (T, K, 3)
    A[:, :k, k:] = P
    A[:, k:, :k] = np.transpose(P, (0, 2, 1))
    rhs = np.zeros((T, k + npoly))
    rhs[:, :k] = _tps_kernel(np.linalg.norm(ps - ts, axis=-1))  # (T, K)
    rhs[:, k] = 1.0
    rhs[:, k + 1 :] = ts[:, 0, :]
    # exactly-singular neighbourhoods (duplicate pixel coordinates —
    # overlapping scan edges, repeated fills) make the BATCHED solve raise
    # for every target; detect them up front and solve only the rest
    dup = ((r <= 0) & ~np.eye(k, dtype=bool)[None]).any(axis=(1, 2))
    good = ~dup
    sol = np.zeros((T, k + npoly))
    if good.any():
        try:
            sol[good] = np.linalg.solve(
                np.transpose(A[good], (0, 2, 1)), rhs[good][..., None])[..., 0]
        except np.linalg.LinAlgError:
            return None  # whole batch degenerate (collinear swath): skip
    # per-target residual check: near-singular neighbourhoods solve
    # "successfully" with enormous weights — mask those targets
    resid = np.abs(np.einsum("tji,tj->ti", A, sol) - rhs).max(axis=1)
    scale = np.maximum(np.abs(rhs).max(axis=1), 1.0)
    bad = dup | ~np.isfinite(resid) | (resid > 1e-6 * scale)
    return nn, sol[:, :k], bad


def build_plan(
    pix_lon: np.ndarray,
    pix_lat: np.ndarray,
    tgt_lon2d: np.ndarray,
    tgt_lat2d: np.ndarray,
    method: int,
    threshold: float,
    far_factor: float = 2.0,
):
    """Build a :class:`SparsePlan` for one granule geometry.

    Returns None when a Delaunay triangulation is required but cannot be
    formed (degenerate swath) — the reference skips such granules
    (interpolator.py:151-155).
    """
    points = np.column_stack([np.asarray(pix_lon, np.float64).ravel(),
                              np.asarray(pix_lat, np.float64).ravel()])
    targets = np.column_stack([np.asarray(tgt_lon2d, np.float64).ravel(),
                               np.asarray(tgt_lat2d, np.float64).ravel()])
    T = len(targets)
    tree = cKDTree(points)
    dists, nn = tree.query(targets)
    far = dists > far_factor * threshold

    if method in (2, 4):
        idx = nn.astype(np.int32)[:, None]
        w = np.ones((T, 1))
    elif method == 1:
        try:
            tri = Delaunay(points)
        except Exception:
            return None
        simplex = tri.find_simplex(targets)
        inside = simplex >= 0
        s = np.where(inside, simplex, 0)
        trans = tri.transform[s]  # (T, 3, 2)
        r = targets - trans[:, 2, :]
        b2 = np.einsum("tij,tj->ti", trans[:, :2, :], r)  # (T, 2)
        w = np.concatenate([b2, 1.0 - b2.sum(axis=1, keepdims=True)], axis=1)
        idx = tri.simplices[s].astype(np.int32)
        far = far | ~inside  # outside hull -> NaN (fill_value=nan)
    elif method == 3:
        res = _rbf_weights(points, targets, tree=tree)
        if res is None:
            return None  # degenerate geometry: skip (same as the qhull path)
        idx, w, bad = res
        idx = idx.astype(np.int32)
        far = far | bad
    else:
        raise ValueError(f"interpolation method {method} not supported")

    return SparsePlan(idx=idx, w=w, mask=far, out_shape=tuple(tgt_lon2d.shape), npix=len(points))


def build_plan_structured(
    pix_lon2d: np.ndarray,
    pix_lat2d: np.ndarray,
    tgt_lon2d: np.ndarray,
    tgt_lat2d: np.ndarray,
    threshold: float,
    far_factor: float = 2.0,
    method: int = 1,
):
    """Fast-path weights via the native structured-swath builder.

    ``method=1``: semantically a linear-in-triangle interpolation like the
    scipy path but on the swath's natural quad triangulation instead of
    qhull's Delaunay triangulation — ~an order of magnitude faster to
    build, identical for constant/linear fields, and differing only in the
    diagonal-split choice within quads for curved fields (a performance
    mode, not a bitwise-parity mode).

    ``method=2/4``: nearest-neighbour via the native spatial-hash ring
    search — same nearest pixel as scipy's cKDTree (lowest-id tie break),
    no tree build.

    Returns None when the native library is missing or the pixels are not
    a 2-D grid (callers fall back to :func:`build_plan`).
    """
    from oisat import native

    if method not in (1, 2, 4):
        return None
    pix_lon2d = np.asarray(pix_lon2d)
    pix_lat2d = np.asarray(pix_lat2d)
    if (pix_lon2d.ndim != 2 or min(pix_lon2d.shape) < 2
            or pix_lat2d.shape != pix_lon2d.shape):
        return None  # documented fallback, not a ValueError from native
    out = native.structured_weights(pix_lon2d, pix_lat2d,
                                    np.asarray(tgt_lon2d, np.float64).ravel(),
                                    np.asarray(tgt_lat2d, np.float64).ravel(),
                                    max_dist=far_factor * threshold,
                                    # NN modes only need dist/nn: skip the
                                    # point-in-triangle pass (~half the build)
                                    need_tri=(method == 1),
                                    # linear mode consumes dist only as the
                                    # far-mask boolean below: the relaxed
                                    # first-hit scan yields the same mask
                                    exact_dist=(method != 1))
    if out is None:
        return None
    idx, w, dist, nn, ok = out
    if method in (2, 4):
        far = dist > far_factor * threshold
        return SparsePlan(idx=nn[:, None], w=np.ones((nn.size, 1)), mask=far,
                          out_shape=tuple(np.shape(tgt_lon2d)),
                          npix=int(pix_lon2d.size))
    far = (dist > far_factor * threshold) | ~ok
    return SparsePlan(idx=idx, w=w, mask=far, out_shape=tuple(np.shape(tgt_lon2d)),
                      npix=int(pix_lon2d.size))
