"""Granule regridding: host weight-building + one fused device apply.

Re-implements the reference's swath→grid pipeline (reference
oisatgmi/interpolator.py:100-291, interpolator_ssmis.py:96-168) device-first:

  host   build SparsePlan (pixels → fine grid) per granule geometry,
         build the static Upscaler (fine grid → CTM grid) once per run,
  device stack every 2-D field and every level of every 3-D field into one
         (F, Npix) batch → single gather+weighted-sum → box filter →
         nearest-map onto the CTM grid.  One jit, no per-field scipy calls.

The reference's separate error path (squared box kernel, interpolate the
*variance*, sqrt at the end — interpolator.py:44-46, :187-193) is preserved
by carrying the uncertainty field as variance through a second kernel.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from oisat.datamodel import satellite_amf, satellite_opt, satellite_ssmis
from oisat.ops.regrid import apply_plan, apply_plan_arrays, boxfilter_same_symm, pad_to_bucket
from oisat.ops.weights import (
    SparsePlan,
    build_plan,
    build_plan_structured,
    compact_plan,
    diag_threshold,
    fine_grid,
    grid_spacing,
)

__all__ = ["Upscaler", "make_upscaler", "regrid_granule", "regrid_ssmis_granule",
           "fast_swath_default", "fits_f16", "F16_SAFE_MAX", "PendingGranule",
           "lazy_collection", "regrid_mesh", "set_regrid_mesh"]


class PendingGranule:
    """A regrid in flight: the device program is dispatched but the host
    collection (D2H ``np.asarray`` + granule assembly) is deferred to
    :meth:`resolve`.  This is the submit/collect pipeline unit — the caller
    dispatches granule k+1 BEFORE resolving granule k, so the device works
    on k while the host builds k+1 (readers.sensors.common.fleet_map does
    this; single-threaded, so it needs no GIL release from the backend)."""

    __slots__ = ("_finish",)

    def __init__(self, finish):
        self._finish = finish

    def resolve(self):
        return self._finish()


_lazy_local = threading.local()


class lazy_collection:
    """Context manager: regrid calls inside return :class:`PendingGranule`
    instead of collecting inline (used by fleet_map's sequential pipeline)."""

    def __enter__(self):
        self._prev = getattr(_lazy_local, "on", False)
        _lazy_local.on = True
        return self

    def __exit__(self, *exc):
        _lazy_local.on = self._prev
        return False


def _lazy_default() -> bool:
    return getattr(_lazy_local, "on", False)

# Conservative float16 range guard (f16 max is 65504).  Fields whose finite
# magnitude can exceed this must NEVER take the narrow transfer path: the
# cast overflows to inf, and one inf abscissa NaNs a whole interpolation
# column (ops/vertical.py non-finite guard).  Known offender: the OMPS
# reader preserves the reference quirk of storing the column amount (~6e15)
# as surface pressure (reference reader.py:1089), so its pressure_mid stack
# is far beyond f16 range.
F16_SAFE_MAX = 6.0e4


def fits_f16(a) -> bool:
    """True when every finite value of ``a`` is within safe float16 range
    (all-NaN / empty arrays fit).  The narrowing guards below call this
    per field, so out-of-range fields ride along at full precision."""
    a = np.asarray(a)
    if a.size == 0:
        return True
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        m = np.nanmax(np.abs(a))
    return not (m >= F16_SAFE_MAX)  # NaN max (all-NaN) -> fits


def f16_transfer_default() -> bool:
    """Production default for the float16 host->device transfer of
    per-level 3-D field stacks: ON (the reference stores exactly these
    fields in float16, reference reader.py:486-506, so f16 transfer + f32
    device compute strictly dominates its fidelity).  ``OISAT_PARITY=1``
    or ``OISAT_F16_TRANSFER=0`` keeps the full compute dtype end-to-end."""
    import os

    if os.environ.get("OISAT_PARITY", "0") == "1":
        return False
    v = os.environ.get("OISAT_F16_TRANSFER")
    if v is not None:
        return v == "1"
    return True


def parity_mode() -> bool:
    """OISAT_PARITY=1: bit-match the reference numerics — scipy weight
    builders, full-precision transfers, and NO affine carrier-level
    shortcut (a + b*regrid(ps) rounds differently than the reference's
    per-level regrid(a + b*ps))."""
    import os

    return os.environ.get("OISAT_PARITY", "0") == "1"


def device_granules_default() -> bool:
    """Gridded granules keep their big field leaves ON DEVICE
    (``OISAT_DEVICE_GRANULES=1``; default off).  The fused month path sets
    this so regrid outputs never round-trip device->host->device — the
    month step stacks the device leaves directly (run/job.py enables it
    when ``fused_month`` applies).  Any numpy consumer still works: the
    leaves convert implicitly via np.asarray (one D2H)."""
    import os

    return os.environ.get("OISAT_DEVICE_GRANULES", "0") == "1"


def fast_swath_default() -> bool:
    """Production default for the native structured-swath weight builder: ON.

    ``OISAT_PARITY=1`` (or legacy ``OISAT_FAST_SWATH=0``) switches to the
    scipy qhull/cKDTree builders that bit-match the reference
    (reference interpolator.py:145-159).
    """
    import os

    if os.environ.get("OISAT_PARITY", "0") == "1":
        return False
    fs = os.environ.get("OISAT_FAST_SWATH")
    if fs is not None:
        return fs == "1"
    return True


@dataclasses.dataclass(frozen=True)
class Upscaler:
    """Fine/source grid → coarse target grid mapping (reference ``_upscaler``).

    ``needed=False`` means the source is finer than (or equal to) the target
    and fields are filtered+mapped; ``needed=True`` means the *model* must be
    upscaled instead (reference returns inputs unchanged with the
    ``upscaled_ctm_needed`` flag — interpolator.py:92-97).
    """

    needed: bool  # True -> pass-through (ctm must be upscaled instead)
    ky: int
    kx: int
    plan: Optional[SparsePlan]
    out_lon: np.ndarray
    out_lat: np.ndarray

    def apply(self, z, error: bool = False):
        """z: (..., H, W) on the source grid -> (..., Ht, Wt) (device op)."""
        if self.needed:
            return z
        zf = boxfilter_same_symm(jnp.asarray(z), self.ky, self.kx, squared=error)
        flat = zf.reshape(zf.shape[:-2] + (-1,))
        return apply_plan(self.plan, flat)


def _geom_key(lon2d, lat2d):
    """Content-derived cache key: shape, corners, AND coordinate sums —
    corners alone would collide for grids with the same bounds but
    different interior spacing (e.g. stretched vs uniform)."""
    lon2d = np.asarray(lon2d, np.float64)
    lat2d = np.asarray(lat2d, np.float64)
    return (lon2d.shape, float(lon2d.flat[0]), float(lon2d.flat[-1]),
            float(lat2d.flat[0]), float(lat2d.flat[-1]),
            float(lon2d.sum()), float(lat2d.sum()),
            float(np.abs(lon2d).sum()), float(np.abs(lat2d).sum()))


from oisat.utils.lru import LockedLRU

_upscaler_cache = LockedLRU(16)
_fine_grid_cache = LockedLRU(8)


def _fine_grid_cached(ctm_lon2d, ctm_lat2d, grid_size):
    """fine_grid memoized on the CTM geometry: the meshgrid spans the CTM
    domain at grid_size pitch and was rebuilt identically for every
    granule of a run on the per-orbit host hot path."""
    key = (_geom_key(ctm_lon2d, ctm_lat2d), float(grid_size))
    hit = _fine_grid_cache.get(key)
    if hit is not None:
        return hit
    out = fine_grid(ctm_lon2d, ctm_lat2d, grid_size)
    _fine_grid_cache.put(key, out)
    return out


def make_upscaler(
    src_lon2d: np.ndarray,
    src_lat2d: np.ndarray,
    tgt_lon2d: np.ndarray,
    tgt_lat2d: np.ndarray,
    grid_size: float,
    threshold: float,
    method: int = 4,
    far_factor: float = 2.0,
    fast: bool | None = None,
) -> Upscaler:
    """Build the reference ``_upscaler`` decision + mapping (interpolator.py:48-97).

    ``grid_size`` is the source-grid pitch, ``threshold`` the distance cutoff.
    The main pipeline maps with KD-nearest + 2x cutoff; the SSMIS/GOSAT
    variants use Delaunay-linear + 1x cutoff (method=1, far_factor=1).

    The fine→coarse mapping depends only on the two grid geometries, which
    repeat across every granule of a run, so results are LRU-cached; the
    structured source grid also takes the native weight builder when
    ``fast`` (default: :func:`fast_swath_default`).
    """
    tgt_dlon, tgt_dlat = grid_spacing(tgt_lon2d, tgt_lat2d)
    if (tgt_dlon >= grid_size) or (tgt_dlat >= grid_size):
        if fast is None:
            fast = fast_swath_default()
        key = (_geom_key(src_lon2d, src_lat2d), _geom_key(tgt_lon2d, tgt_lat2d),
               float(grid_size), float(threshold), method, float(far_factor), fast)
        cached = _upscaler_cache.get(key)
        if cached is not None:
            return cached
        kx = max(int(np.floor(tgt_dlon / grid_size)), 1)
        ky = max(int(np.floor(tgt_dlat / grid_size)), 1)
        plan = None
        if fast and method in (1, 2, 4) and np.ndim(src_lon2d) == 2:
            plan = build_plan_structured(
                src_lon2d, src_lat2d, tgt_lon2d, tgt_lat2d,
                threshold=threshold, far_factor=far_factor, method=method)
        if plan is None:
            plan = build_plan(
                src_lon2d.ravel(), src_lat2d.ravel(), tgt_lon2d, tgt_lat2d,
                method=method, threshold=threshold, far_factor=far_factor,
            )
        if plan is None:
            # both builders honour a skip-the-granule contract, but the
            # upscaler maps REGULAR grids — a failure here is an
            # environment/geometry bug, so fail loudly rather than
            # crashing later in dataclasses.replace(None, ...)
            raise RuntimeError("upscaler weight build failed for a regular "
                               "grid geometry (degenerate fine/CTM grid?)")
        # cache the upscale weights ON DEVICE: the same fine→coarse map is
        # applied every granule of a run, and re-uploading it per granule
        # wastes the transfer budget the granule-plan cache just saved
        plan = dataclasses.replace(plan, idx=jnp.asarray(plan.idx),
                                   w=jnp.asarray(plan.w),
                                   mask=jnp.asarray(plan.mask))
        up = Upscaler(False, ky, kx, plan, tgt_lon2d, tgt_lat2d)
        _upscaler_cache.put(key, up)
        return up
    return Upscaler(True, 1, 1, None, src_lon2d, src_lat2d)


# device-resident (T,K) idx/w can be tens of MB each — keep the LRU small
_plan_cache = LockedLRU(4)

# pixel-bucket escalation state: coarse 4-step bucket -> first exact pixel
# count seen there (process-wide, like the compiled-program cache it guards)
_pixel_bucket_lock = threading.Lock()
_pixel_bucket_first: dict[int, int] = {}


def _pixel_bucket(n: int) -> int:
    """Bucket the flattened pixel axis for transfer + compile.

    The first pixel count seen in a coarse 4-steps/octave region gets its
    tight 8-steps/octave bucket; any LATER distinct count landing in the
    same coarse region escalates to the coarse bucket itself, so at most
    2 regrid programs compile per region — each fresh shape costs a
    compile.  Since plan
    compaction landed, the bucketed count is ``plan.sel.size`` — it
    varies per orbit with domain overlap even for fixed-geometry sensors
    (OMI 1644x60, SSMIS), so in practice most orbits ride the coarse
    bucket (<=19% padded bytes, mean ~9%); the tight path still pays off
    for repeated identical months (tests, the bench) and uncompacted
    plans."""
    coarse = pad_to_bucket(n, steps_per_octave=4, align=128)
    with _pixel_bucket_lock:
        first = _pixel_bucket_first.setdefault(coarse, n)
    if first == n:
        return pad_to_bucket(n, steps_per_octave=8, align=128)
    return coarse


def _granule_plan(sat_lon, sat_lat, lons_fine, lats_fine, grid_size,
                  method: int, far_factor: float, fast: bool):
    """Build (or fetch) the pixel→fine-grid SparsePlan for one granule
    geometry.

    Fixed-geometry sensors repeat the exact same geometry every granule —
    SSMIS files are one global 0.25° grid, MOPITT L3 one fixed grid, the
    GOSAT filler one map — yet the reference rebuilds its triangulation
    per file (reference interpolator.py:145-159).  The LRU caches the
    plan with its index/weight arrays already ON DEVICE, so a repeat
    granule skips both the host weight build (the costliest host step:
    ~1.1 s for an SSMIS global grid) and the per-granule H2D transfer of
    the weights.  Swath sensors (OMI/TEMPO/TROPOMI) have
    per-orbit geometry and simply churn the small LRU."""
    key = (_geom_key(np.atleast_2d(np.asarray(sat_lon)),
                     np.atleast_2d(np.asarray(sat_lat))),
           _geom_key(lons_fine, lats_fine),
           float(grid_size), int(method), float(far_factor), bool(fast))
    hit = _plan_cache.get(key)
    if hit is not None:
        return hit
    plan = None
    if fast and method in (1, 2, 4) and np.ndim(sat_lon) == 2:
        plan = build_plan_structured(sat_lon, sat_lat, lons_fine, lats_fine,
                                     threshold=grid_size,
                                     far_factor=far_factor, method=method)
    if plan is None:
        plan = build_plan(np.asarray(sat_lon).ravel(),
                          np.asarray(sat_lat).ravel(),
                          lons_fine, lats_fine, method=method,
                          threshold=grid_size, far_factor=far_factor)
    if plan is None:
        return None  # untriangulatable granule: not cached
    # compact BEFORE the device move: sel stays host NumPy (the per-granule
    # value gather happens on host, shrinking the H2D transfer), while the
    # remapped idx/w ride the device-side plan cache like before
    plan = compact_plan(plan)
    plan = dataclasses.replace(plan, idx=jnp.asarray(plan.idx),
                               w=jnp.asarray(plan.w),
                               mask=jnp.asarray(plan.mask))
    _plan_cache.put(key, plan)
    return plan


def _affine_stack(stack, rtol: float = 1e-5):
    """Detect per-level affine structure ``stack[l] == a[l] + b[l] *
    stack[carrier]`` (exact NaN-pattern match required).

    Every supported sensor builds its pressure grid this way — hybrid-eta
    tables times one surface-pressure field (OMI HCHO / OMPS / TEMPO /
    TROPOMI; reference reader.py:954-957, :1091-1100) or a fixed 1-D
    pressure table (OMI NO2, MOPITT).  Because the regrid, box filter and
    upscale all use partition-of-unity weights and the levels share one
    NaN pattern, ``regrid(a + b*ps) == a + b*regrid(ps)`` to rounding —
    so only the carrier level needs the host->device->host trip.  On a
    transfer-bound link that removes ~45% of the per-granule traffic.

    Returns (a, b, carrier_index) as float64 arrays, or None when the
    stack is not affine (then every level travels, as before).

    Runs per granule on the host, so it is written allocation-lean and
    fully vectorized in the INPUT dtype (the per-level f64 loop it
    replaces cost ~0.18 s/orbit — half the host-side regrid time)."""
    s = np.asarray(stack)
    if s.dtype not in (np.float32, np.float64):
        s = s.astype(np.float64)
    L = s.shape[0]
    if L < 3:
        return None  # nothing worth compressing
    flat = s.reshape(L, -1)
    nan = np.isnan(flat)
    nan0 = nan[0]
    if nan.any() and not np.array_equiv(nan, nan0[None]):
        return None
    n_finite = flat.shape[1] - int(nan0.sum())
    if n_finite < 2:
        return None
    with np.errstate(invalid="ignore"):
        lo = np.nanmin(flat, axis=1)
        hi = np.nanmax(flat, axis=1)
        # carrier: first level with spread (a constant stack: level 0, b=0)
        carriers = np.flatnonzero(hi > lo)
        ci = int(carriers[0]) if carriers.size else 0
        tab = _affine_tables(flat, flat[ci], rtol, lo=lo, hi=hi,
                             nan_checked=True)
    if tab is None:
        return None
    return tab[0], tab[1], ci


def _affine_from_tables(stack, tabs, rtol: float = 1e-4, sel=None):
    """Derive the (a, b, carrier_index) affine contract of
    :func:`_affine_stack` from READER-PROVIDED construction tables
    (``stack[l] == A[l] + B[l]*ps``, see
    readers.sensors.common.attach_pmid_tables) instead of re-fitting the
    pixel data: with carrier level ``ci = argmax|B|``,
    ``stack[l] == a[l] + b[l]*stack[ci]`` for ``b = B/B[ci]``,
    ``a = A - A[ci]*B/B[ci]`` — exact by construction, no per-level
    re-fit.  A residual + NaN-pattern check over the validated pixels
    (the whole swath, or ``plan.sel`` when given — see below; two cheap
    vectorized passes, still ~10x cheaper than the fit it replaces)
    guards against a stack that was edited after construction — a
    localized scrub that re-masks or rescales a validated sub-swath must
    not slip through, because reconstruction would force the carrier's
    values and NaN pattern onto every level; on any mismatch (or shape
    disagreement) returns None and the caller falls back to the full
    :func:`_affine_stack` fit.  ``B == 0`` everywhere (fixed
    1-D pressure tables: OMI NO2, MOPITT) degenerates to ``b = 0`` with
    level 0 as carrier — NaN masking still propagates because IEEE
    ``0*NaN`` is NaN.

    ``sel`` (a compacted plan's referenced-pixel ids): validate only
    those pixels.  The regrid output is a weighted sum over exactly the
    referenced pixels and the affine reconstruction runs on that output,
    so a mismatch confined to UNREFERENCED pixels cannot alter any
    result — checking 100% of the swath bought no additional safety for
    ~5x the memory traffic."""
    A, B = tabs
    s = np.asarray(stack)
    L = s.shape[0]
    if A.shape != (L,) or B.shape != (L,) or L < 3:
        return None
    if not (np.isfinite(A).all() and np.isfinite(B).all()):
        return None
    ci = int(np.argmax(np.abs(B)))
    if B[ci] == 0.0:
        a, b = A.copy(), np.zeros(L)
        ci = 0
    else:
        b = B / B[ci]
        a = A - A[ci] * b
    flat = s.reshape(L, -1)
    if flat.shape[1] < 2:
        return None  # too small to check; use the full fit
    import warnings

    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
        # level-at-a-time so the working set stays cache-resident: the
        # vectorized form streamed ~4 full-stack f64 passes through RAM
        # (isnan + pred + resid + reductions) and dominated the host-side
        # regrid cost; this loop reads the stack once
        car = flat[ci] if sel is None else flat[ci][sel]
        nan_c = np.isnan(car)
        pred = np.empty_like(car)
        for lev in range(L):
            row = flat[lev] if sel is None else flat[lev][sel]
            if lev != ci and not np.array_equiv(np.isnan(row), nan_c):
                return None
            np.multiply(car, b[lev], out=pred)
            pred += a[lev]
            np.subtract(row, pred, out=pred)
            np.abs(pred, out=pred)
            # NaN nanmax (all-NaN row) compares False -> passes, like the fit
            scale = max(np.nanmax(np.abs(row)), 1e-300)
            if np.nanmax(pred) > rtol * scale:
                return None
    return a, b, ci


def _affine_tables(stack, carrier, rtol: float = 1e-5, lo=None, hi=None,
                   nan_checked: bool = False):
    """Fit every level of ``stack`` as ``a[l] + b[l] * carrier`` against a
    GIVEN carrier field (the core of :func:`_affine_stack`, exposed so a
    second stack sharing the same driver field — e.g. a GMI air-column
    stack against the pressure carrier, both affine in surface pressure —
    can ride one carrier transfer).  Returns (a, b) float64 or None.
    ``stack`` may be (L, ...) of any trailing shape; NaN patterns must
    match the carrier's."""
    flat = np.asarray(stack)
    flat = flat.reshape(flat.shape[0], -1)
    p0 = np.asarray(carrier).ravel()
    if not nan_checked:  # _affine_stack already validated its own stack
        cnan = np.isnan(p0)
        nan = np.isnan(flat)
        if (nan.any() or cnan.any()) and not np.array_equiv(nan, cnan[None]):
            return None
        if flat.shape[1] - int(cnan.sum()) < 2:
            return None
    L = flat.shape[0]
    with np.errstate(invalid="ignore"):
        if lo is None:
            lo = np.nanmin(flat, axis=1)
            hi = np.nanmax(flat, axis=1)
        i = int(np.nanargmin(p0))
        j = int(np.nanargmax(p0))
        dp = float(p0[j]) - float(p0[i])
        if dp > 0:
            b = (flat[:, j].astype(np.float64) - flat[:, i]) / dp
        else:
            b = np.zeros(L)
        a = flat[:, i].astype(np.float64) - b * p0[i]
        # one vectorized residual check over the whole stack, in the input
        # dtype (a few-ulp prediction rounding is far inside rtol; an f64
        # upcast would double the temporary).  NaNs at the shared mask
        # positions drop out of the nanmax.
        ad = a.astype(flat.dtype, copy=False)
        bd = b.astype(flat.dtype, copy=False)
        resid = flat - (ad[:, None] + bd[:, None] * p0[None, :].astype(flat.dtype))
        np.abs(resid, out=resid)
        scale = np.maximum(np.maximum(np.abs(lo), np.abs(hi)), 1e-300)
        if np.any(np.nanmax(resid, axis=1) > rtol * scale):
            return None
    return a, b


def _quality_mask(quality_flag, flag_thresh: float,
                  dtype=np.float64) -> np.ndarray:
    """QA mask as the reference builds it: 1.0 where flag > thresh else NaN
    (interpolator.py:124-127)."""
    m = (np.asarray(quality_flag) > flag_thresh).astype(dtype)
    m[m != 1.0] = np.nan
    return np.squeeze(m)


def _stack(fields, dtype=np.float64):
    """Stack a list of (...,)-shaped pixel arrays into (F, Npix) ``dtype``.

    Production f32 runs stack at float32: the mask values are exactly 1.0
    or NaN, so host prep in f32 is bit-identical to the old
    f64-multiply-then-cast while halving ~65 MB/orbit of host memcpy
    (the host build time is part of the per-orbit wall)."""
    return np.stack([np.asarray(f, dtype).ravel() for f in fields])


def _regrid_device_impl(batch, batch_lv, batch_lv_wide, err, idx, w, mask,
                        up_idx, up_w, up_mask,
                        fine_shape, ky: int, kx: int, passthrough: bool,
                        square_err: bool = False, row_sharding=None):
    """The whole per-granule device pipeline as ONE program: interp to the
    fine grid (value batch + error-variance field), box filter, map onto
    the CTM grid.  One dispatch per granule instead of ~6.

    ``batch_lv`` carries the rows that fit the narrow transfer dtype (the
    per-level 3-D stacks plus any 2-D fields the reference itself stores
    at float16); ``batch_lv_wide`` the rows that exceed f16 range and
    travel at the compute dtype (see ``_regrid_fused``).  Both are upcast
    and concatenated with the wide 2-D field batch; the host side
    restores the original row order after retrieval.

    ``square_err``: the error row arrives as the RAW uncertainty (so it
    can ride the narrow transfer dtype) and is squared here, in-program —
    host-side squaring would force the full-width transfer of a value the
    reference stores at float16 (reference reader.py:487, :691, :753)."""
    batch = jnp.concatenate([batch, batch_lv.astype(batch.dtype),
                             batch_lv_wide.astype(batch.dtype)], axis=0)
    err = err.astype(batch.dtype)
    if square_err:
        err = err * err
    fine = apply_plan_arrays(batch, idx, w, mask).reshape(batch.shape[:-1] + fine_shape)
    fine_err = apply_plan_arrays(err, idx, w, mask).reshape(err.shape[:-1] + fine_shape)
    if row_sharding is not None:
        # SPMD over a mesh: shard the fine grid by rows; GSPMD partitions
        # the producing gather by its output rows, inserts the halo
        # exchange the box filter needs at shard boundaries, and the
        # collectives of the fine->CTM gather below — identical values to
        # the single-device program (see _sharded_regrid_fn)
        fine = jax.lax.with_sharding_constraint(fine, row_sharding)
        fine_err = jax.lax.with_sharding_constraint(fine_err, row_sharding)
    if passthrough:
        return fine, fine_err
    zf = boxfilter_same_symm(fine, ky, kx)
    zef = boxfilter_same_symm(fine_err, ky, kx, squared=True)
    out = apply_plan_arrays(zf.reshape(zf.shape[:-2] + (-1,)), up_idx, up_w, up_mask)
    out_err = apply_plan_arrays(zef.reshape(zef.shape[:-2] + (-1,)), up_idx, up_w, up_mask)
    return out, out_err


_regrid_device = partial(jax.jit, static_argnames=("fine_shape", "ky", "kx",
                                                   "passthrough", "square_err",
                                                   "row_sharding"))(_regrid_device_impl)


# ---- SPMD regrid over a device mesh ----------------------------------------
# One granule's regrid program sharded over every mesh device: the swath
# pixel batch is small and replicated; the FINE-GRID TARGET axis (the big
# one — plan idx/w rows and everything computed from them) is sharded over
# all mesh axes.  Under jit-with-shardings XLA's SPMD partitioner inserts
# the halo exchanges the box filter needs at shard boundaries and the
# gather collectives of the fine->CTM upscale — no hand-written
# collectives, the same program text as the single-device path (this is
# how a multi-card host regrids one huge TEMPO 0.05-deg granule; on a
# single device it is exactly _regrid_device).  Opt in with `regrid_mesh`
# (run/job.py does when `mesh_devices` > 1).

# PROCESS-WIDE, deliberately NOT a threading.local: fleet_map's multi-core
# branch runs readers (and therefore regrids) in ThreadPoolExecutor worker
# threads, which would never see a mesh set thread-locally by the job
# runner's main thread — the SPMD regrid would silently degrade to
# single-device exactly on the hosts that have the cores to fan out.
_REGRID_MESH = {"mesh": None}
_sharded_regrid_cache = LockedLRU(4)


class regrid_mesh:
    """Context manager: regrid device programs inside run SPMD over
    ``mesh`` (None or a 1-device mesh = single-device, the default).
    Process-wide scope — see the note on ``_REGRID_MESH``."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._prev = _REGRID_MESH["mesh"]
        _REGRID_MESH["mesh"] = self.mesh
        return self

    def __exit__(self, *exc):
        _REGRID_MESH["mesh"] = self._prev
        return False


def set_regrid_mesh(mesh) -> None:
    """Entry-point wiring for :class:`regrid_mesh` (run/job.py sets it once
    per month; granule readers then regrid SPMD with no per-call-site
    plumbing — including fleet_map's pool worker threads)."""
    _REGRID_MESH["mesh"] = mesh


def _regrid_mesh_default():
    m = _REGRID_MESH["mesh"]
    return m if (m is not None and m.size > 1) else None


def _sharded_regrid_fn(mesh):
    """The regrid program constrained to shard its fine grid by rows over
    every axis of ``mesh`` (cached per mesh).  The constraint rides the
    shared ``_regrid_device`` jit wrapper as a static argument, so the
    single-device and SPMD paths are one program text; GSPMD handles
    non-divisible row counts (uneven final shard) internally, which is why
    this is a mid-program constraint and not an ``in_shardings`` (argument
    shardings reject non-divisible global shapes)."""
    hit = _sharded_regrid_cache.get(mesh)
    if hit is not None:
        return hit
    from jax.sharding import NamedSharding, PartitionSpec as P

    row = NamedSharding(mesh, P(None, tuple(mesh.axis_names), None))
    fn = partial(_regrid_device, row_sharding=row)
    _sharded_regrid_cache.put(mesh, fn)
    return fn


@partial(jax.jit, static_argnames=("layout", "affine", "hw"))
def _finish_device_fields(gridded, err_gridded, a, b, inv, layout,
                          affine: bool, hw):
    """Device-granule post-processing as ONE program: the f16 row-order
    restore, the flat→(H, W) reshape, the error sqrt, the deferred-validity
    scalar, every named 2-D row pick, the contiguous 3-D stack slices, and
    the affine pmid reconstruction.

    Done eagerly these were ~12-18 tiny dispatches per orbit (each also a
    distinct compiled program: the compile census attributed most of the
    cold month's ~24 eager programs here).  ``layout`` is the batch row order (2-D names +
    "name:z" stack rows + optionally "pressure_mid:carrier"), static per
    sensor/product, so each granule layout compiles exactly once.

    ``inv`` (or None) restores the caller's row order after the f16
    range split (see ``_regrid_fused``); ``hw`` (static, or None when the
    batch is already shaped) is the output (H, W)."""
    if inv is not None:
        gridded = jnp.take(gridded, inv, axis=0)
    if hw is not None:
        gridded = gridded.reshape(gridded.shape[:-1] + hw)
        err_gridded = err_gridded.reshape(err_gridded.shape[:-1] + hw)
    idx = {n: i for i, n in enumerate(layout)}
    out = {n: gridded[i] for n, i in idx.items() if ":" not in n}
    out["uncertainty"] = jnp.sqrt(err_gridded[0])
    out["valid"] = jnp.isfinite(out["vcd"]).any()
    stacks: dict = {}
    for n in layout:
        if ":" in n:
            base, z = n.rsplit(":", 1)
            if z != "carrier":
                stacks[base] = stacks.get(base, 0) + 1
    for base, n_lv in stacks.items():
        i0 = idx[f"{base}:0"]  # z-rows are contiguous in the batch
        out[base] = gridded[i0:i0 + n_lv]
    if affine:
        carrier = gridded[idx["pressure_mid:carrier"]]
        out["pressure_mid:carrier"] = carrier
        # NaN rides along for b==0 too (IEEE: 0*NaN is NaN)
        out["pressure_mid"] = (a[:, None, None]
                               + b[:, None, None] * carrier).astype(carrier.dtype)
    return out


@partial(jax.jit, static_argnames=("hw",))
def _finish_device_ssmis(gridded, err_gridded, hw):
    """SSMIS device-granule post-processing as ONE program: the two row
    picks + the flat→(H, W) reshape (the raw value travelled through the
    squared error kernel and keeps no sqrt — see
    :func:`regrid_ssmis_granule`)."""
    v, e = gridded[0], err_gridded[0]
    if hw is not None:
        v = v.reshape(hw)
        e = e.reshape(hw)
    return v, e


def _f16_row_mask(batch_lv) -> np.ndarray:
    """Per-row f16-range fit for a (F, Npix) level-stack batch: True where
    every finite value in the row is under :data:`F16_SAFE_MAX` (all-NaN
    rows fit).  Rows that don't fit keep the compute dtype."""
    if batch_lv.shape[0] == 0:
        return np.zeros((0,), bool)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rowmax = np.nanmax(np.abs(batch_lv), axis=-1)
    return ~(rowmax >= F16_SAFE_MAX)  # NaN rowmax (all-NaN row) -> True


def _gather_stack(fields, mask_sel, sel, dtype, shape):
    """Masked compacted batch in ONE pass per field: gather the plan's
    referenced pixels, cast on assignment, apply the QA mask in place.
    The full-width mask-multiply + stack + re-gather sequence touched ~5x
    the bytes for swath plans that reference ~18% of the pixels; values
    are bitwise identical (the mask is exactly 1.0 or NaN, so cast-then-
    multiply equals multiply-then-cast).  ``shape`` is the swath shape:
    sub-shaped fields (size-1 placeholders that pass the assembly's
    ``.any()`` guards) broadcast against it exactly like the full-width
    branch's ``field * mask`` does."""
    out = np.empty((len(fields), sel.size), dtype)
    for i, f in enumerate(fields):
        f = np.asarray(f)
        if f.size == 1:
            out[i] = f.reshape(())[()]
        else:
            if f.shape != shape:
                f = np.broadcast_to(f, shape)
            out[i] = f.ravel()[sel]
        out[i] *= mask_sel
    return out


def _regrid_fused(plan, upsc, batch, err_batch, dtype, batch_lv=None,
                  lazy: bool = False, device: bool = False,
                  square_err: bool = False, err_narrow: bool = False,
                  sel_applied: bool = False):
    """Host wrapper: bucket-pad, run the fused program, return numpy.

    ``batch_lv``: the narrow-transfer-eligible rows (per-level 3-D field
    stacks plus the 2-D fields ``regrid_granule`` routes here).  In
    float32 production mode they are transferred as float16 — the
    reference *stores* these very fields (scattering weights, pressures,
    profiles, and the vcd/tropopause/uncertainty 2-D fields) in float16
    (reference reader.py:486-506, SURVEY.md §2 precision note), so an
    f16 transfer + f32 device compute strictly dominates its fidelity
    while halving the dominant host->device traffic.  Rows whose finite
    magnitude exceeds f16 range (e.g. the OMPS column-as-pressure quirk,
    reference reader.py:1089) are split out and travel at the compute
    dtype — an unguarded cast would overflow to inf and NaN the whole
    downstream AMF recalculation.  Full-precision (float64 / parity and
    test) runs transfer everything at the compute dtype.

    ``square_err``: ship the RAW uncertainty and square it in-program
    (see ``_regrid_device_impl``); ``err_narrow`` additionally lets that
    row ride the narrow dtype when it fits f16 range (only for sensors
    whose reference reader stores uncertainty at f16)."""
    if batch_lv is None:
        batch_lv = np.zeros((0, batch.shape[-1]))
    if plan.sel is not None and not sel_applied:
        # compacted plan (weights.compact_plan): ship only the pixels the
        # plan references — a cheap host gather that cuts the dominant
        # H2D rows by the swath's oversampling factor (~5x for OMI).
        # ``sel_applied`` callers gathered during assembly (_gather_stack).
        batch = batch[:, plan.sel]
        batch_lv = batch_lv[:, plan.sel]
        err_batch = err_batch[:, plan.sel]
    n = batch.shape[-1]
    # tight 8-steps/octave bucket for the first (for fixed-geometry
    # sensors: only) pixel count per coarse region, coarse 4-step bucket
    # for later distinct counts — see _pixel_bucket for the compile-count
    # vs padded-transfer-byte trade
    b = _pixel_bucket(n)
    if b != n:
        pad = [(0, 0), (0, b - n)]
        batch = np.pad(batch, pad, constant_values=np.nan)
        batch_lv = np.pad(batch_lv, pad, constant_values=np.nan)
        err_batch = np.pad(err_batch, pad, constant_values=np.nan)
    if upsc.needed:
        up_idx = np.zeros((1, 1), np.int32)
        up_w = np.zeros((1, 1))
        up_mask = np.zeros((1,), bool)
    else:
        up_idx, up_w, up_mask = upsc.plan.idx, upsc.plan.w, upsc.plan.mask
    narrow = dtype == np.float32 and f16_transfer_default()
    if narrow:
        fit = _f16_row_mask(batch_lv)
        lv16, lv_wide = batch_lv[fit], batch_lv[~fit]
        lv_dtype = np.float16
        err_dtype = (np.float16 if err_narrow and _f16_row_mask(err_batch).all()
                     else dtype)
    else:
        fit = np.ones((batch_lv.shape[0],), bool)
        lv16, lv_wide = batch_lv, batch_lv[:0]
        lv_dtype = dtype
        err_dtype = dtype
    mesh = _regrid_mesh_default()
    regrid_fn = _regrid_device if mesh is None else _sharded_regrid_fn(mesh)
    out, out_err = regrid_fn(
        jnp.asarray(batch.astype(dtype, copy=False)),
        jnp.asarray(lv16.astype(lv_dtype, copy=False)),
        jnp.asarray(lv_wide.astype(dtype, copy=False)),
        jnp.asarray(err_batch.astype(err_dtype, copy=False)),
        jnp.asarray(plan.idx), jnp.asarray(plan.w), jnp.asarray(plan.mask),
        jnp.asarray(up_idx), jnp.asarray(up_w), jnp.asarray(up_mask),
        plan.out_shape, upsc.ky, upsc.kx, upsc.needed, square_err)
    f2 = batch.shape[0]

    def _inv_order():
        if fit.all():
            return None
        # device row order is [2-D fields, fitting rows, wide rows];
        # restore the caller's original row order
        order = np.concatenate([np.arange(f2), f2 + np.flatnonzero(fit),
                                np.flatnonzero(~fit) + f2])
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        return inv

    def collect():
        """Collection (row reorder + reshape) — deferred when ``lazy`` so
        the caller can dispatch the next granule first.

        ``device`` keeps the results as device arrays with the reorder +
        reshape DEFERRED (no dispatch here at all): returns
        ``(flat_values, flat_err, inv_or_None)`` for the caller's jitted
        finisher to fold in-program (each eager reshape/gather on a device
        array is a compiled program + a dispatch per granule);
        otherwise numpy results come back fully shaped."""
        if device:
            return out, out_err, _inv_order()
        o = np.asarray(out)
        inv = _inv_order()
        if inv is not None:
            o = o[inv]
        oe = np.asarray(out_err)
        hw = plan.out_shape if upsc.needed else upsc.out_lat.shape
        return (o.reshape(o.shape[:-1] + hw) if not upsc.needed else o,
                oe.reshape(oe.shape[:-1] + hw) if not upsc.needed else oe)

    return collect if lazy else collect()


def regrid_granule(
    interpolator_type: int,
    grid_size: float,
    sat_data,
    ctm_lon2d: np.ndarray,
    ctm_lat2d: np.ndarray,
    flag_thresh: float = 0.75,
    dtype=np.float32,
    fast_swath: bool | None = None,
    lazy: bool | None = None,
    device: bool | None = None,
):
    """Regrid one granule onto the CTM grid (reference ``interpolator``).

    Returns a gridded ``satellite_amf`` / ``satellite_opt`` (NumPy leaves),
    or None when the granule can't be triangulated or misses the domain
    (interpolator.py:151-155, :165-167).

    ``lazy`` (default: the ambient :class:`lazy_collection` context, off
    otherwise) returns a :class:`PendingGranule` whose ``resolve()``
    performs the host collection — the fleet pipeline dispatches granule
    k+1 before resolving granule k so device work and host builds overlap.

    ``device`` (default :func:`device_granules_default`) keeps the big
    granule leaves as device arrays — NO D2H at all; the fused month step
    stacks them in place, and any numpy consumer converts implicitly.
    Deviation in device mode: the off-domain check (all-NaN vcd -> None,
    reference interpolator.py:165-167) is deferred — the granule carries a
    ``_device_valid`` scalar the driver filters with ONE batched pull; an
    all-NaN granule contributes nothing to the month means either way.

    ``fast_swath`` (production default: ON) replaces the scipy weight
    builders for 2-D structured swaths with the native builder: linear
    (method 1) becomes quad-triangulation barycentric weights (~10x faster
    host build; identical for constant/linear fields, differing only in
    the in-quad diagonal choice and in not extrapolating across swath
    concavities), nearest (methods 2/4) becomes the native hash ring
    search (same pixel picks as cKDTree).  Parity mode — bit-matching the
    reference's qhull/cKDTree path — via ``fast_swath=False``, env
    ``OISAT_PARITY=1``, or env ``OISAT_FAST_SWATH=0``.
    """
    if fast_swath is None:
        fast_swath = fast_swath_default()
    threshold_ctm = diag_threshold(ctm_lon2d, ctm_lat2d)
    lons_fine, lats_fine = _fine_grid_cached(ctm_lon2d, ctm_lat2d, grid_size)

    plan = _granule_plan(sat_data.longitude_center, sat_data.latitude_center,
                         lons_fine, lats_fine, grid_size,
                         method=interpolator_type, far_factor=2.0,
                         fast=fast_swath)
    if plan is None:
        return None
    upsc = make_upscaler(lons_fine, lats_fine, ctm_lon2d, ctm_lat2d,
                         grid_size, threshold_ctm, method=4, far_factor=2.0,
                         fast=fast_swath)
    sel = plan.sel if isinstance(plan.sel, np.ndarray) else None

    host_dtype = np.float64 if dtype == np.float64 else np.float32
    is_amf = isinstance(sat_data, satellite_amf)
    is_opt = isinstance(sat_data, satellite_opt)
    if not (is_amf or is_opt):
        # before any attribute access: an SSMIS/foreign object would
        # otherwise die on a bare AttributeError instead of this message
        raise TypeError(f"unsupported granule type {type(sat_data)!r}")
    mask = _quality_mask(sat_data.quality_flag, flag_thresh, host_dtype)

    # ---- gather every field (value-kernel batch + error field); rows the
    # reference readers store at float16 travel through the narrow batch
    # (names_lv), the rest at the compute dtype (see _regrid_fused).
    # 2-D narrow eligibility follows the reference's own storage: vcd,
    # tropopause and uncertainty are f16 for every AMF sensor (reference
    # reader.py:486-519, :751-786, :846-890, :937-1035) and vcd /
    # aprior_column for MOPITT (:1165, :1179); amf keeps the product
    # file's native precision (no astype in the reference) and GOSAT
    # stores everything f32 — those rows stay wide.
    names: list = []
    cols: list = []
    names_lv: list = []
    cols_lv: list = []
    narrow2d = {"vcd", "tropopause"} if is_amf else (
        {"vcd", "aprior_column"} if getattr(sat_data, "sensor", "") == "MOPITT"
        else set())

    # the add helpers store RAW fields; the QA-mask multiply happens once
    # during batch assembly (gather-first for compacted plans)
    def add2d(name, arr):
        if name in narrow2d:
            names_lv.append(name)
            cols_lv.append(np.squeeze(np.asarray(arr)))
        else:
            names.append(name)
            cols.append(np.squeeze(np.asarray(arr)))

    add2d("vcd", sat_data.vcd)
    if is_amf:
        add2d("amf", sat_data.amf)
    has_trop = np.size(sat_data.tropopause) != 1
    if has_trop:
        add2d("tropopause", sat_data.tropopause)

    def add3d(name, arr, narrow=True):
        """3-D stacks: ``narrow`` follows the reference's OWN storage
        dtype per field — AMF scattering weights / pressures and MOPITT
        AKs / pressures are float16 in the reference readers (narrow
        batch), while GOSAT's profiles/AKs/pressure weights/pressures and
        MOPITT's apriori_profile carry NO astype there (reference
        reader.py GOSAT/MOPITT sections) and must ship at full f32: a
        ~1900 ppb CH4 apriori quantized to f16 (spacing 1.0) injects
        ~0.5 ppb errors into ~10 ppb xcol-pair innovations."""
        a = np.asarray(arr)
        tgt_n, tgt_c = (names_lv, cols_lv) if narrow else (names, cols)
        for z in range(a.shape[0]):
            tgt_n.append(f"{name}:{z}")
            tgt_c.append(np.squeeze(a[z]))

    pmid_affine = None

    def add3d_pmid(arr, narrow=True):
        """Pressure stacks are affine in ONE field for every supported
        sensor (see _affine_stack) — regrid only the carrier level and
        reconstruct the rest on the output grid; non-affine stacks take
        the full per-level path.  Affine commutes with the regrid only
        for partition-of-unity weights: linear/nearest (methods 1/2/4),
        not RBF (method 3)."""
        nonlocal pmid_affine
        # parity mode takes the reference's per-level path (a + b*regrid(ps)
        # rounds differently than per-level regrid(a + b*ps))
        ab = None
        if interpolator_type in (1, 2, 4) and not parity_mode():
            # reader-provided construction tables skip the full-stack fit
            tabs = getattr(sat_data, "_pmid_eta", None)
            if tabs is not None:
                ab = _affine_from_tables(arr, tabs, sel=sel)
            if ab is None:
                ab = _affine_stack(arr)
        if ab is None:
            add3d("pressure_mid", arr, narrow=narrow)
            return
        a_, b_, ci = ab
        pmid_affine = (a_, b_)
        tgt_n, tgt_c = (names_lv, cols_lv) if narrow else (names, cols)
        tgt_n.append("pressure_mid:carrier")
        tgt_c.append(np.squeeze(np.asarray(arr)[ci]))

    has_sw = is_amf and np.size(sat_data.scattering_weights) != 1
    if has_sw:
        add3d("scattering_weights", sat_data.scattering_weights)
        add3d_pmid(sat_data.pressure_mid)
    if is_opt:
        gosat = sat_data.sensor == "GOSAT"
        if np.asarray(sat_data.aprior_column).any():
            add2d("aprior_column", sat_data.aprior_column)
        if np.asarray(sat_data.surface_pressure).any():
            add2d("surface_pressure", sat_data.surface_pressure)
        if np.asarray(sat_data.apriori_surface).any():
            add2d("apriori_surface", sat_data.apriori_surface)
        add2d("x_col", sat_data.x_col)
        # GOSAT stores AKs/PW/p_mid/apriori at full precision in the
        # reference (no astype); MOPITT stores AKs/Pressure f16 but the
        # apriori profile full-precision
        add3d("averaging_kernels", sat_data.averaging_kernels,
              narrow=not gosat)
        if gosat:
            add3d("pressure_weight", sat_data.pressure_weight, narrow=False)
        add3d_pmid(sat_data.pressure_mid, narrow=not gosat)
        add3d("apriori_profile", sat_data.apriori_profile, narrow=False)

    # RAW uncertainty; the device program squares it (square_err) so the
    # row can ship at the reference's own f16 storage precision for the
    # AMF sensors (reference reader.py:487 etc.; MOPITT/GOSAT store
    # uncertainty f32 — err_narrow off keeps those wide)
    err_cols = [np.squeeze(np.asarray(sat_data.uncertainty))]
    if sel is not None:
        # compacted plan: gather + cast + mask in one pass per field
        # instead of masking/stacking the full swath then re-gathering
        msel = mask.ravel()[sel]
        batch = _gather_stack(cols, msel, sel, host_dtype, mask.shape)
        batch_lv = (_gather_stack(cols_lv, msel, sel, host_dtype, mask.shape)
                    if cols_lv else None)
        err_batch = _gather_stack(err_cols, msel, sel, host_dtype, mask.shape)
    else:
        # cast first: the multiply then runs at the (narrower) host dtype;
        # bitwise equal either way because mask is exactly 1.0 or NaN
        batch = _stack([np.asarray(c, host_dtype) * mask for c in cols],
                       host_dtype)  # (F2, Npix)
        batch_lv = (_stack([np.asarray(c, host_dtype) * mask
                            for c in cols_lv], host_dtype)
                    if cols_lv else None)
        err_batch = _stack([np.asarray(err_cols[0], host_dtype) * mask],
                           host_dtype)
    if device is None:
        device = device_granules_default()
    collect = _regrid_fused(plan, upsc, batch, err_batch, dtype,
                            batch_lv=batch_lv, lazy=True, device=device,
                            square_err=True, err_narrow=is_amf,
                            sel_applied=sel is not None)

    def finish():
        name_idx = {n: i for i, n in enumerate(names + names_lv)}

        if device:
            # ALL device post-processing (row reorder, reshape, row picks,
            # stack slices, error sqrt, validity scalar, affine pmid) as
            # one program + one dispatch — see _finish_device_fields
            flat, flat_err, inv = collect()
            ab = pmid_affine if pmid_affine is not None else (
                np.zeros(1), np.zeros(1))
            d = _finish_device_fields(
                flat, flat_err, jnp.asarray(ab[0]), jnp.asarray(ab[1]),
                None if inv is None else jnp.asarray(inv),
                layout=tuple(names + names_lv),
                affine=pmid_affine is not None,
                hw=None if upsc.needed else tuple(upsc.out_lat.shape))

            def field(n, default=None):
                return d.get(n, default)

            def collect3d(name, nz):
                return d[name]

            def collect_pmid(nz):
                return d["pressure_mid"]

            uncertainty = d["uncertainty"]
            vcd = d["vcd"]
            # deferred domain check: one scalar per granule, pulled
            # batched by the driver (a per-granule float() would serialize
            # a device round trip per granule)
            valid = d["valid"]
        else:
            gridded, err_gridded = collect()

            def field(n, default=None):
                i = name_idx.get(n)
                return default if i is None else gridded[i]

            # error path: variance in, squared kernel, sqrt at the end
            with np.errstate(invalid="ignore"):  # RBF variance can overshoot < 0 -> NaN
                uncertainty = np.sqrt(err_gridded[0])

            vcd = field("vcd")
            valid = None
            import warnings as _warnings

            with _warnings.catch_warnings():
                _warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN mean
                if np.isnan(np.nanmean(vcd)):
                    return None  # granule misses the analysis domain

            def collect3d(name, nz):
                # the z-rows of one 3-D field are contiguous in the batch:
                # one range slice, not nz per-row slices
                i0 = name_idx[f"{name}:0"]
                return gridded[i0:i0 + nz]

            def collect_pmid(nz):
                if pmid_affine is None:
                    return collect3d("pressure_mid", nz)
                a_, b_ = (np.asarray(t) for t in pmid_affine)
                carrier = field("pressure_mid:carrier")
                # NaN rides along for b==0 too (IEEE: 0*NaN is NaN); keep
                # the compute dtype of the regridded fields
                return (a_[:, None, None]
                        + b_[:, None, None] * carrier).astype(carrier.dtype)

        tropopause = field("tropopause", np.empty((1,)))
        lat_c, lon_c = upsc.out_lat, upsc.out_lon
        hw = vcd.shape

        if is_amf:
            nz = np.asarray(sat_data.pressure_mid).shape[0] if np.size(sat_data.pressure_mid) > 1 else 0
            if has_sw:
                sw = collect3d("scattering_weights", nz)
                pmid = collect_pmid(nz)
            else:
                sw = np.empty((1,))
                pmid = np.zeros((nz,) + tuple(hw))
            g = satellite_amf(
                vcd=vcd, amf=field("amf"), time=sat_data.time, tropopause=tropopause,
                latitude_center=lat_c, longitude_center=lon_c,
                latitude_corner=[], longitude_corner=[],
                uncertainty=uncertainty, quality_flag=[], pressure_mid=pmid,
                scattering_weights=sw, ctm_upscaled_needed=upsc.needed,
                ctm_vcd=[], ctm_time_at_sat=[], old_amf=[], new_amf=[],
            )
        else:
            nz = np.asarray(sat_data.pressure_mid).shape[0]
            nak = np.asarray(sat_data.averaging_kernels).shape[0]
            aks = collect3d("averaging_kernels", nak)
            pw = collect3d("pressure_weight", nz) if sat_data.sensor == "GOSAT" else np.empty((1,))
            g = satellite_opt(
                vcd=vcd, time=sat_data.time, profile=[], tropopause=tropopause,
                latitude_center=lat_c, longitude_center=lon_c,
                latitude_corner=[], longitude_corner=[],
                uncertainty=uncertainty, quality_flag=[],
                pressure_mid=collect_pmid(nz), averaging_kernels=aks,
                ctm_upscaled_needed=upsc.needed, ctm_vcd=[], ctm_xcol=[],
                ctm_time_at_sat=[],
                aprior_column=field("aprior_column", np.zeros((1,))),
                apriori_profile=collect3d("apriori_profile", nz),
                surface_pressure=field("surface_pressure", np.zeros((1,))),
                apriori_surface=field("apriori_surface", np.zeros((1,))),
                x_col=field("x_col"),
                pressure_weight=pw, sensor=sat_data.sensor,
            )
        if device:
            g._device_valid = valid
            if pmid_affine is not None:
                # the fused month's Eta path reuses the carrier + tables
                # without pulling the reconstructed stack back
                g._pmid_carrier = field("pressure_mid:carrier")
                g._pmid_ab = pmid_affine
        return g

    if lazy is None:
        lazy = _lazy_default()
    return PendingGranule(finish) if lazy else finish()


def regrid_ssmis_granule(
    grid_size: float,
    sat_data: satellite_ssmis,
    ctm_lon2d: np.ndarray,
    ctm_lat2d: np.ndarray,
    dtype=np.float32,
    fast_swath: bool | None = None,
    lazy: bool | None = None,
    device: bool | None = None,
):
    """SSMIS variant (reference interpolator_ssmis.py:96-168).

    Differences from the main pipeline, preserved here: no quality mask, the
    raw uncertainty (not its square) goes through the squared error kernel
    with no final sqrt, and both the granule interp and the upscale map use
    Delaunay-linear with a 1x (not 2x) distance cutoff
    (interpolator_ssmis.py:18-28, :67-70, :88-89).

    Deliberate deviation: the reference casts the fine-grid coordinates to
    float16 (interpolator_ssmis.py:141), losing ~0.06 deg of coordinate
    precision at high longitudes; we keep float64 geometry.

    ``fast_swath`` (production default ON; same switches as
    :func:`regrid_granule`): SSMIS files are full 0.25-degree global grids
    (~1M pixels) — the structured builder replaces the costliest qhull
    triangulation in the whole pipeline.
    """
    if fast_swath is None:
        fast_swath = fast_swath_default()
    threshold_ctm = diag_threshold(ctm_lon2d, ctm_lat2d)
    lons_fine, lats_fine = _fine_grid_cached(ctm_lon2d, ctm_lat2d, grid_size)
    plan = _granule_plan(sat_data.longitude_center, sat_data.latitude_center,
                         lons_fine, lats_fine, grid_size, method=1,
                         far_factor=1.0, fast=fast_swath)
    if plan is None:
        return None
    upsc = make_upscaler(lons_fine, lats_fine, ctm_lon2d, ctm_lat2d,
                         grid_size, threshold_ctm, method=1, far_factor=1.0,
                         fast=fast_swath)
    if device is None:
        device = device_granules_default()
    # same host-prep precision policy as regrid_granule (one place to
    # change if the parity switches ever alter it)
    host_dtype = np.float64 if dtype == np.float64 else np.float32
    collect = _regrid_fused(
        plan, upsc,
        _stack([sat_data.vcd], host_dtype),
        _stack([sat_data.uncertainty], host_dtype),
        dtype, lazy=True, device=device)

    def finish():
        if device:
            flat, flat_err, _inv = collect()  # single-row batch: no reorder
            vcd, unc = _finish_device_ssmis(
                flat, flat_err,
                hw=None if upsc.needed else tuple(upsc.out_lat.shape))
        else:
            gridded, err_gridded = collect()
            vcd, unc = gridded[0], err_gridded[0]
        g = satellite_ssmis(
            vcd=vcd,
            # raw value through the squared kernel, no sqrt
            uncertainty=unc, time=sat_data.time,
            latitude_center=upsc.out_lat, longitude_center=upsc.out_lon,
            ctm_upscaled_needed=upsc.needed, ctm_vcd=[], sensor="SSMIS",
        )
        return g

    if lazy is None:
        lazy = _lazy_default()
    return PendingGranule(finish) if lazy else finish()
