"""The sharded end-to-end analysis step (averaging → bias → OI).

One jitted function takes the month's stacked granule fields ``(G, H, W)``
and produces the full OI analysis.  Under a mesh it runs SPMD: the granule
axis is sharded over 'obs', grid rows over 'grid'; XLA turns the temporal
reduction into a psum over 'obs' and the mean-AK curve reduction into a
global psum.  This one step is the device equivalent of the reference's whole
month-job compute (minus file IO): averaging.py + driver.bias_correct +
optimal_interpolation.py in a single compiled program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from oisat.ops.averaging import monthly_stats, monthly_stats_weighted
from oisat.ops.diagnostics import InnovationStats, innovation_stats
from oisat.ops.oi import OIResult, oi
from oisat.utils.lru import LockedLRU

# one jit wrapper per (step, mesh, scalar-kwargs) configuration —
# see _cached_step_jit.  32 entries cover 4 sensors x a handful of
# bias/weighting configurations; eviction only costs a recompile.
_STEP_JIT_CACHE = LockedLRU(32)

__all__ = [
    "AnalysisInputs", "AnalysisOutputs", "DailyGranules",
    "analysis_step", "make_analysis_step",
    "FullMonthInputs", "full_month_step", "make_full_month_step",
    "FullMonthEtaInputs", "full_month_eta_step", "make_full_month_eta_step",
    "MopittMonthInputs", "mopitt_month_step", "make_mopitt_month_step",
    "GosatMonthInputs", "gosat_month_step", "make_gosat_month_step",
    "SsmisMonthInputs", "ssmis_month_step", "make_ssmis_month_step",
]


class AnalysisInputs(NamedTuple):
    """Stacked monthly granule fields, all (G, H, W)."""

    vcd: jax.Array
    uncertainty: jax.Array
    ctm_vcd: jax.Array
    aux1: jax.Array
    aux2: jax.Array


class AnalysisOutputs(NamedTuple):
    sat_vcd: jax.Array  # bias-corrected monthly mean observation
    sat_error: jax.Array
    ctm_vcd: jax.Array  # prior
    aux1: jax.Array
    aux2: jax.Array
    oi: OIResult
    scaling_factor: jax.Array
    # in-program innovation/chi2 diagnostics (f32; computed on the SAME
    # clipped y the OI assimilated) — folding them here removes the last
    # separate per-month program + dispatch of the fused path; NaN
    # placeholders (n=0) when run_oi=False
    innovation: "InnovationStats"


class DailyGranules(NamedTuple):
    """Per-granule operator outputs (G, H, W), returned by the month steps
    when ``return_granules=True`` — the fields ``driver.savedaily`` writes
    per granule (reference driver.py:127-146): the post-operator satellite
    VCD, the matched model VCD, and the (unchanged) retrieval error.  One
    batched D2H pull replaces a per-granule host walk in device-granule
    months."""

    vcd: jax.Array
    ctm_vcd: jax.Array
    uncertainty: jax.Array


def _granule_weights_traced(weighting, uncertainty, aks=None):
    """In-program counterpart of ``ops.averaging._granule_weights`` — the
    same formulas on the already-stacked month inputs, so the fused month
    and the staged host path cannot drift.

    "inverse_variance": w = 1/sigma^2 where sigma > 0, else NaN (excluded).
    "ak": vertical nanmean of |averaging kernels| (opt sensors only — the
    makers validate kind availability host-side)."""
    if weighting is None:
        return None
    if weighting == "inverse_variance":
        err2 = uncertainty.astype(jnp.float32) ** 2
        return jnp.where(err2 > 0, 1.0 / err2, jnp.nan)
    if weighting == "ak":
        if aks is None:
            raise ValueError("weighting='ak' needs averaging-kernel granules "
                             "(MOPITT/GOSAT); use 'inverse_variance' otherwise")
        return jnp.nanmean(jnp.abs(aks.astype(jnp.float32)), axis=1)
    raise ValueError(f"unknown weighting {weighting!r}")


def _jit_cache_key(step_fn, mesh, kwargs):
    """Hashable identity of a month-step jit wrapper, or None to bypass
    the cache.  Functions ARE hashable (by identity), so a caller passing
    a fresh lambda/closure per month would never hit yet would still
    insert — each dead entry evicting a live month-step wrapper from the
    LRU and re-paying its compile.  Bypass for any callable that
    isn't a module-level function (lambdas and local closures get new
    identities per call; module-level functions are stable and cache
    usefully), and for genuinely unhashable values."""
    for v in kwargs.values():
        if callable(v) and ("<locals>" in getattr(v, "__qualname__", "")
                            or getattr(v, "__name__", "") == "<lambda>"):
            return None
    try:
        key = (step_fn, mesh, tuple(sorted(kwargs.items())))
        hash(key)
        return key
    except TypeError:
        return None


def _cached_step_jit(step_fn, mesh, kwargs, build):
    """Memoize the jitted month-step wrapper on its full configuration.

    Every ``analyze_month_fused`` call runs a maker, and a fresh
    ``jax.jit(partial(...))`` wrapper has its own compilation cache — so
    month 2 of a campaign recompiled month 1's exact program (one compile
    per month x sensor, 48/year).  Equal (step, mesh, scalar-kwargs)
    configurations must share ONE wrapper so later months hit the jit
    cache instead of the compiler.  ``jax.sharding.Mesh`` hashes by device
    ids + axis names, so per-call Mesh construction still hits."""
    key = _jit_cache_key(step_fn, mesh, kwargs)
    if key is not None:
        hit = _STEP_JIT_CACHE.get(key)
        if hit is not None:
            return hit
    made = build(kwargs)
    if key is not None:
        _STEP_JIT_CACHE.put(key, made)
    return made


def analysis_step(inputs: AnalysisInputs, bias_offset: float = 0.0,
                  bias_slope: float = 1.0, error_ctm: float = 50.0,
                  gosat_mode: bool = False, ctm_scale: float = 1.0,
                  weights=None, run_oi: bool = True) -> AnalysisOutputs:
    """Monthly average + bias correction + OI update, one fused program.

    ``ctm_scale`` rescales the averaged CTM column between the averaging and
    OI stages — the O3 DU-conversion hook (reference driver.py:62-63 divides
    by 2.69e16*1e-15; pass ``ctm_scale=1/(2.69e16*1e-15)``).

    ``weights`` (G, H, W) selects the weighted temporal statistics
    (``monthly_stats_weighted``) instead of the reference's plain nanmean —
    the ``averaging_weighting`` extension running inside the fused
    program.

    ``run_oi=False`` skips the in-program OI stage (the 99-factor curve
    scan dominates the analysis compute): callers that re-run the OI tail
    host-side (``oi_method: full``, Desroziers re-estimation) would
    discard it anyway; the ``oi`` and ``innovation`` slots carry NaN
    placeholders."""
    if weights is None:
        stats = monthly_stats(inputs.vcd, inputs.uncertainty, inputs.ctm_vcd,
                              inputs.aux1, inputs.aux2)
    else:
        stats = monthly_stats_weighted(inputs.vcd, inputs.uncertainty,
                                       inputs.ctm_vcd, inputs.aux1,
                                       inputs.aux2, weights)
    sat_vcd = (stats.sat_vcd - bias_offset) / bias_slope
    ctm_vcd = stats.ctm_vcd * ctm_scale
    if gosat_mode:
        xa, y = stats.aux2, stats.aux1  # xcol pair (reference driver.py:112-114)
    else:
        xa, y = ctm_vcd, sat_vcd
    sa = (xa * error_ctm / 100.0) ** 2
    so = stats.sat_error**2
    if run_oi:
        res = oi(xa, y, sa, so, regularization_on=True)
        sf = res.xb / xa
        sf = jnp.where(jnp.isnan(sf) | jnp.isinf(sf) | (sf == 0.0), 1.0, sf)
        # diagnostics on the y the OI actually assimilated (the same
        # y<0 -> 0 clamp ops/oi.py applies; the staged driver path
        # clips identically — driver._oi_impl's y_clip)
        y_assim = jnp.where(y < 0, jnp.zeros_like(y), y)
        innov = innovation_stats(xa, y_assim, res.xb, sa, so)
    else:
        from oisat.ops.oi import regularization_grid

        nanf = jnp.full_like(xa, jnp.nan)
        res = OIResult(xb=nanf, averaging_kernel=nanf, increment=nanf,
                       error=nanf, reg_index=jnp.asarray(-1, jnp.int32),
                       reg_factor=jnp.asarray(jnp.nan, xa.dtype),
                       curve=jnp.full(regularization_grid().shape, jnp.nan,
                                      xa.dtype))
        sf = jnp.ones_like(xa)
        z = jnp.asarray(jnp.nan, xa.dtype)
        innov = InnovationStats(n=jnp.asarray(0, jnp.int32), omb_mean=z,
                                omb_rms=z, oma_mean=z, oma_rms=z, chi2=z)
    return AnalysisOutputs(sat_vcd=sat_vcd, sat_error=stats.sat_error,
                           ctm_vcd=ctm_vcd, aux1=stats.aux1, aux2=stats.aux2,
                           oi=res, scaling_factor=sf, innovation=innov)


def make_analysis_step(mesh: Mesh, **kwargs):
    """Jit ``analysis_step`` over a mesh.

    Inputs are sharded (obs, grid, None): granules over 'obs', grid rows
    over 'grid'.  2-D outputs are sharded (grid, None); scalars/curves are
    replicated.  Returns (jitted_fn, shard_inputs) where ``shard_inputs``
    device_puts a host AnalysisInputs with the right layout.  The
    mean-AK curve's per-factor sums over the sharded grid become
    cross-device sums under jit.
    """
    in_spec = P("obs", "grid", None)

    def build(step_kwargs):
        field_spec = P("grid", None)
        in_sh = AnalysisInputs(*([NamedSharding(mesh, in_spec)] * 5))
        out_sh = AnalysisOutputs(
            sat_vcd=NamedSharding(mesh, field_spec),
            sat_error=NamedSharding(mesh, field_spec),
            ctm_vcd=NamedSharding(mesh, field_spec),
            aux1=NamedSharding(mesh, field_spec),
            aux2=NamedSharding(mesh, field_spec),
            oi=OIResult(
                xb=NamedSharding(mesh, field_spec),
                averaging_kernel=NamedSharding(mesh, field_spec),
                increment=NamedSharding(mesh, field_spec),
                error=NamedSharding(mesh, field_spec),
                reg_index=NamedSharding(mesh, P()),
                reg_factor=NamedSharding(mesh, P()),
                curve=NamedSharding(mesh, P()),
            ),
            scaling_factor=NamedSharding(mesh, field_spec),
            innovation=InnovationStats(*([NamedSharding(mesh, P())] * 6)),
        )
        return jax.jit(partial(analysis_step, **step_kwargs),
                       in_shardings=(in_sh,), out_shardings=out_sh), in_sh

    jit_fn, _ = _cached_step_jit(analysis_step, mesh, kwargs, build)
    n_obs = mesh.shape["obs"]
    n_grid = mesh.shape["grid"]

    def shard_inputs(inputs: AnalysisInputs) -> "_ShardedMonth":
        # NaN-pad non-mesh-divisible G/H like every sibling month-step
        # maker: real months have arbitrary granule counts and odd grid
        # heights, and in_shardings requires mesh-divisible shapes
        inputs, h = _pad_to_mesh(inputs, AnalysisInputs, n_obs, n_grid)
        sharded = AnalysisInputs(
            *(jax.device_put(jnp.asarray(x), NamedSharding(mesh, in_spec))
              for x in inputs))
        return _ShardedMonth(sharded, h)

    def fn(inputs):
        if isinstance(inputs, _ShardedMonth):
            h = inputs.true_h
            inputs = inputs.fields
        else:
            h = inputs[0].shape[-2]
        out = jit_fn(inputs)
        if h != out.sat_vcd.shape[-2]:
            out = jax.tree.map(
                lambda a: a[..., :h, :] if getattr(a, "ndim", 0) >= 2 else a,
                out)
        return out

    return fn, shard_inputs


class FullMonthInputs(NamedTuple):
    """A whole month of gridded granules + the matched CTM slices.

    Granule fields carry a leading G axis; per-granule CTM slices carry the
    same G axis (each granule was time-matched to its own CTM snapshot).
    """

    sat_pmid: jax.Array  # (G, Ls, H, W)
    sat_sw: jax.Array  # (G, Ls, H, W)
    vcd: jax.Array  # (G, H, W)
    amf: jax.Array  # (G, H, W)
    uncertainty: jax.Array  # (G, H, W)
    tropopause: jax.Array  # (G, H, W)
    ctm_pmid: jax.Array  # (G, Lc, H, W)
    ctm_pc: jax.Array  # (G, Lc, H, W)


def full_month_step(inputs: FullMonthInputs, bias_offset: float = 0.0,
                    bias_slope: float = 1.0, error_ctm: float = 50.0,
                    ctm_scale: float = 1.0, weighting=None,
                    return_granules: bool = False, run_oi: bool = True):
    """Observation operator + averaging + OI for a whole month, one program.

    This is the complete on-device compute of a reference month-job for a
    two-step sensor: vmapped AMF recalculation per granule, monthly
    statistics, bias correction, and the OI update.

    ``weighting`` enables the weighted temporal mean in-program;
    ``return_granules=True`` additionally returns the per-granule operator
    outputs (:class:`DailyGranules`) for ``save_daily``.
    """
    from oisat.ops.vertical import amf_recal_fields

    new_amf, vcd_corr, model_vcd = jax.vmap(
        lambda sp, sw, cp, pc, tr, v, a: amf_recal_fields(sp, sw, cp, pc, tr, v, a, True)
    )(inputs.sat_pmid, inputs.sat_sw, inputs.ctm_pmid, inputs.ctm_pc,
      inputs.tropopause, inputs.vcd, inputs.amf)
    ai = AnalysisInputs(vcd=vcd_corr, uncertainty=inputs.uncertainty,
                        ctm_vcd=model_vcd, aux1=new_amf, aux2=inputs.amf)
    out = analysis_step(ai, bias_offset=bias_offset, bias_slope=bias_slope,
                        error_ctm=error_ctm, ctm_scale=ctm_scale,
                        run_oi=run_oi,
                        weights=_granule_weights_traced(weighting,
                                                        inputs.uncertainty))
    if return_granules:
        return out, DailyGranules(vcd=vcd_corr, ctm_vcd=model_vcd,
                                  uncertainty=inputs.uncertainty)
    return out


def _pad_to_mesh(inputs, fields_cls, n_obs: int, n_grid: int):
    """NaN-pad the granule axis (G, to a multiple of the 'obs' axis) and the
    grid-row axis (H, to a multiple of the 'grid' axis) so ANY month shards
    — real months have arbitrary granule counts and odd grid heights, and
    ``in_shardings`` requires mesh-divisible global shapes.  NaN is the
    missing-data channel throughout (padded granules/rows contribute nothing
    to the nanmean statistics or the masked mean-AK curve)."""
    g, h = np.shape(inputs[0])[0], np.shape(inputs[0])[-2]
    gp = -(-g // n_obs) * n_obs
    hp = -(-h // n_grid) * n_grid
    if (gp, hp) == (g, h):
        # no conversion either: device-granule months must stay on device
        return inputs, h
    out = []
    for x in inputs:
        pad = [(0, 0)] * np.ndim(x)
        pad[0] = (0, gp - g)
        pad[-2] = (0, hp - h)
        out.append(_pad_array(x, pad, np.nan))
    return fields_cls(*out), h


def _pad_array(x, pads, fill):
    """np.pad for host leaves, jnp.pad for device leaves — padding a
    device-granule month must not pull it back to the host."""
    if isinstance(x, jax.Array):
        return jnp.pad(x, pads, constant_values=fill)
    return np.pad(np.asarray(x), pads, constant_values=fill)


def _make_month_step(step_fn, fields_cls, mesh: Mesh, kwargs):
    """Generic maker: jit a month step over the mesh with granules sharded
    on 'obs', grid rows on 'grid', levels replicated.  Input field rank
    decides the spec: (G, H, W) -> (obs, grid, None); (G, L, H, W) ->
    (obs, None, grid, None) — unless the class carries explicit
    ``_field_specs`` (the transfer-compressed Eta inputs do).

    ``shard_inputs`` NaN-pads non-mesh-divisible G/H shapes (see
    :func:`_pad_to_mesh`, or the class's own ``_pad_fn``); the returned
    step crops its (H, W) outputs back to the unpadded height, so callers
    never see the padding."""
    def build(step_kwargs):
        if hasattr(fields_cls, "_field_specs"):
            sh = fields_cls(*(NamedSharding(mesh, P(*s))
                              for s in fields_cls._field_specs))
        else:
            g3 = NamedSharding(mesh, P("obs", "grid", None))
            g4 = NamedSharding(mesh, P("obs", None, "grid", None))
            sh = fields_cls(*({3: g3, 4: g4}[r] for r in fields_cls._field_ranks))
        return jax.jit(partial(step_fn, **step_kwargs), in_shardings=(sh,)), sh

    fn, in_sh = _cached_step_jit(step_fn, mesh, kwargs, build)
    n_obs = mesh.shape["obs"]
    n_grid = mesh.shape["grid"]
    pad_fn = getattr(fields_cls, "_pad_fn", None)

    def shard_inputs(inputs):
        if pad_fn is not None:
            inputs, h = pad_fn(inputs, n_obs, n_grid)
        else:
            inputs, h = _pad_to_mesh(inputs, fields_cls, n_obs, n_grid)
        sharded = fields_cls(*(jax.device_put(jnp.asarray(x), s)
                               for x, s in zip(inputs, in_sh)))
        # the unpadded height travels WITH the sharded batch (a shared
        # mutable slot would go stale when one maker serves several
        # months — the compile-reuse pattern campaign.py relies on)
        return _ShardedMonth(sharded, h)

    def run(inputs):
        if isinstance(inputs, _ShardedMonth):
            h = inputs.true_h
            inputs = inputs.fields
        else:
            h = inputs[0].shape[-2]  # unsharded call: nothing was padded
        out = fn(inputs)
        # return_granules steps yield (AnalysisOutputs, DailyGranules);
        # the crop applies to every (..., H, W) leaf of either shape
        head = out if isinstance(out, AnalysisOutputs) else out[0]
        if h != head.sat_vcd.shape[-2]:
            out = jax.tree.map(
                lambda a: a[..., :h, :] if getattr(a, "ndim", 0) >= 2 else a, out)
        return out

    return run, shard_inputs


class _ShardedMonth(NamedTuple):
    """shard_inputs output: the device-put month fields plus the unpadded
    grid height the step must crop back to."""

    fields: tuple
    true_h: int


def make_full_month_step(mesh: Mesh, **kwargs):
    """Jit ``full_month_step`` over a mesh: granules sharded on 'obs', grid
    rows on 'grid', levels replicated."""
    return _make_month_step(full_month_step, FullMonthInputs, mesh, kwargs)


FullMonthInputs._field_ranks = (4, 4, 3, 3, 3, 3, 4, 4)


class FullMonthEtaInputs(NamedTuple):
    """Transfer-compressed month for AMF sensors: every real product's
    pressure stack is affine in one field (hybrid-eta tables x surface
    pressure — a structure the regrid preserves), so only the per-granule
    CARRIER level travels plus two (G, Ls) tables; and granules matched
    to the same CTM time slice share ONE copy of it, gathered on device.
    This removes most of the fused month's analysis-leg H2D (the pmid
    stack is ~half the bytes, and the CTM slices repeat ~8x)."""

    sat_pmid_carrier: jax.Array  # (G, H, W)
    sat_pmid_a: jax.Array  # (G, Ls): pmid[g,l] = a[g,l] + b[g,l]*carrier[g]
    sat_pmid_b: jax.Array  # (G, Ls)
    sat_sw: jax.Array  # (G, Ls, H, W)
    vcd: jax.Array  # (G, H, W)
    amf: jax.Array  # (G, H, W)
    uncertainty: jax.Array  # (G, H, W)
    tropopause: jax.Array  # (G, H, W)
    ctm_pmid: jax.Array  # (U+1, Lc, H, W) unique slices + final all-NaN slice;
    # OR (U+1, 1, H, W) carrier levels when the CTM stacks are hybrid-eta
    # affine too (GMI/ECCOH; CMAQ's MCIP 3-D pressures are not) — then
    # ctm_pmid_a/b hold real (U+1, Lc) tables and the step reconstructs
    # pmid on device, cutting the CTM-slice H2D (the dominant analysis-leg
    # transfer of a device-granule month) by ~Lc/2x
    ctm_pc: jax.Array  # (U+1, Lc, H, W)
    ctm_idx: jax.Array  # (G,) int32 into the unique slices
    # compressed-CTM tables; (1, 1) dummies mean "ctm_pmid is full"
    ctm_pmid_a: jax.Array = np.zeros((1, 1), np.float32)
    ctm_pmid_b: jax.Array = np.zeros((1, 1), np.float32)


FullMonthEtaInputs._field_specs = (
    ("obs", "grid", None), ("obs", None), ("obs", None),
    ("obs", None, "grid", None),
    ("obs", "grid", None), ("obs", "grid", None), ("obs", "grid", None),
    ("obs", "grid", None),
    (None, None, "grid", None), (None, None, "grid", None),
    ("obs",),
    (None, None), (None, None),
)


def _pad_eta(inputs, n_obs: int, n_grid: int):
    """NaN-pad (G, H) like :func:`_pad_to_mesh`, with the Eta twists: the
    unique-CTM axis is never G-padded, and padded granules' ctm_idx points
    at the trailing all-NaN slice (a real-slice index would let a padded
    granule's operator output leak finite values into the month means)."""
    g, h = np.shape(inputs[0])[0], np.shape(inputs[0])[-2]
    gp = -(-g // n_obs) * n_obs
    hp = -(-h // n_grid) * n_grid
    if (gp, hp) == (g, h):
        # no conversion either: device-granule months must stay on device
        return inputs, h
    arrs = list(inputs)

    def pad(a, pad_g, h_axis, fill=np.nan):
        pads = [(0, 0)] * np.ndim(a)
        if pad_g:
            pads[0] = (0, gp - g)
        if h_axis is not None:
            pads[h_axis] = (0, hp - h)
        return _pad_array(a, pads, fill)

    nan_slice = np.shape(arrs[8])[0] - 1
    return FullMonthEtaInputs(
        sat_pmid_carrier=pad(arrs[0], True, -2),
        sat_pmid_a=pad(arrs[1], True, None),
        sat_pmid_b=pad(arrs[2], True, None),
        sat_sw=pad(arrs[3], True, -2),
        vcd=pad(arrs[4], True, -2),
        amf=pad(arrs[5], True, -2),
        uncertainty=pad(arrs[6], True, -2),
        tropopause=pad(arrs[7], True, -2),
        ctm_pmid=pad(arrs[8], False, -2),
        ctm_pc=pad(arrs[9], False, -2),
        ctm_idx=pad(arrs[10], True, None, fill=nan_slice).astype(np.int32),
        # the (U+1, Lc) tables (or (1, 1) dummies) are never G- or H-padded
        ctm_pmid_a=arrs[11], ctm_pmid_b=arrs[12],
    ), h


FullMonthEtaInputs._pad_fn = staticmethod(_pad_eta)


def decompress_pmid(carrier, a, b):
    """``pmid[g] = a[g] + b[g] * carrier[g]`` at >= f32 (a narrow f16
    transfer dtype must not clip the tables, and an out-of-f16-range
    carrier arrives as f32 already).  Shared by the fused Eta step and the
    staged compressed amf_recal (obs_operators) so the two paths cannot
    drift."""
    dt = jnp.promote_types(carrier.dtype, jnp.float32)
    return (a[:, :, None, None].astype(dt) + b[:, :, None, None].astype(dt)
            * carrier[:, None, :, :].astype(dt))


def dedup_first_seen(keys):
    """First-occurrence dedup: returns (positions of the unique keys in
    input order, per-input index into those uniques).  Shared by the
    CTM-slice dedup in driver._fused_inputs and obs_operators.amf_recal."""
    seen, order, idxs = {}, [], []
    for i, k in enumerate(keys):
        if k not in seen:
            seen[k] = len(order)
            order.append(i)
        idxs.append(seen[k])
    return order, idxs


def full_month_eta_step(inputs: FullMonthEtaInputs, bias_offset: float = 0.0,
                        bias_slope: float = 1.0, error_ctm: float = 50.0,
                        ctm_scale: float = 1.0, weighting=None,
                        return_granules: bool = False, run_oi: bool = True):
    """Decompress on device (pmid reconstruction + CTM slice gather), then
    run the standard :func:`full_month_step` body."""
    sat_pmid = decompress_pmid(inputs.sat_pmid_carrier, inputs.sat_pmid_a,
                               inputs.sat_pmid_b)
    if inputs.ctm_pmid_a.shape[-1] > 1:
        # carrier-compressed CTM stack: gather the per-granule carrier and
        # tables, reconstruct pmid on device (trace-time shape branch — a
        # month is one layout or the other, so no extra program)
        ctm_pmid = decompress_pmid(
            jnp.take(inputs.ctm_pmid[:, 0], inputs.ctm_idx, axis=0),
            jnp.take(inputs.ctm_pmid_a, inputs.ctm_idx, axis=0),
            jnp.take(inputs.ctm_pmid_b, inputs.ctm_idx, axis=0))
    else:
        ctm_pmid = jnp.take(inputs.ctm_pmid, inputs.ctm_idx, axis=0)
    full = FullMonthInputs(
        sat_pmid=sat_pmid, sat_sw=inputs.sat_sw, vcd=inputs.vcd,
        amf=inputs.amf, uncertainty=inputs.uncertainty,
        tropopause=inputs.tropopause,
        ctm_pmid=ctm_pmid,
        ctm_pc=jnp.take(inputs.ctm_pc, inputs.ctm_idx, axis=0))
    return full_month_step(full, bias_offset=bias_offset,
                           bias_slope=bias_slope, error_ctm=error_ctm,
                           ctm_scale=ctm_scale,
                           weighting=weighting,
                           return_granules=return_granules, run_oi=run_oi)


def make_full_month_eta_step(mesh: Mesh, **kwargs):
    return _make_month_step(full_month_eta_step, FullMonthEtaInputs, mesh, kwargs)


class MopittMonthInputs(NamedTuple):
    """A month of gridded MOPITT granules + matched daily CTM slices
    (reference ak_conv_mopitt.py:8-149 at month scale).

    Transfer-compressed layout (GMI/ECCOH): ``ctm_pmid`` carries only the
    (G, 1, H, W) carrier level and ``ctm_airpc`` is EMPTY (G, 0, H, W);
    the (G, Lc) table fields reconstruct both on device — the pressure
    stack AND the air-column stack are affine in surface pressure, and
    together they were 2/3 of the month's H2D bytes.  (1, 1) dummy tables
    mean both fields are full."""

    ctm_pmid: jax.Array  # (G, Lc, H, W) | (G, 1, H, W) carrier
    ctm_profile: jax.Array  # (G, Lc, H, W)
    ctm_airpc: jax.Array  # (G, Lc, H, W) | (G, 0, H, W) when compressed
    sat_pmid: jax.Array  # (G, Ls, H, W)
    aks: jax.Array  # (G, Ls+1, H, W)  surface row first
    apriori_profile: jax.Array  # (G, Ls, H, W)
    aprior_col: jax.Array  # (G, H, W)
    apriori_surface: jax.Array  # (G, H, W)
    vcd: jax.Array  # (G, H, W)
    x_col: jax.Array  # (G, H, W)
    uncertainty: jax.Array  # (G, H, W)
    ctm_pmid_a: jax.Array = np.zeros((1, 1), np.float32)  # (G, Lc)
    ctm_pmid_b: jax.Array = np.zeros((1, 1), np.float32)
    ctm_airpc_a: jax.Array = np.zeros((1, 1), np.float32)
    ctm_airpc_b: jax.Array = np.zeros((1, 1), np.float32)


MopittMonthInputs._field_specs = (
    ("obs", None, "grid", None), ("obs", None, "grid", None),
    ("obs", None, "grid", None), ("obs", None, "grid", None),
    ("obs", None, "grid", None), ("obs", None, "grid", None),
    ("obs", "grid", None), ("obs", "grid", None), ("obs", "grid", None),
    ("obs", "grid", None), ("obs", "grid", None),
    # tables replicated: (1, 1) dummies can't shard over 'obs', and the
    # real (G, Lc) tables are tiny
    (None, None), (None, None), (None, None), (None, None),
)


def _pad_opt(fields_cls):
    """NaN-pad like :func:`_pad_to_mesh`, table-aware: rank>=3 fields pad
    (G, H); real (G, Lc) tables pad G only; (1, 1) dummy tables pass
    through (they are replicated, never sharded)."""
    def pad_fn(inputs, n_obs, n_grid):
        g, h = np.shape(inputs[0])[0], np.shape(inputs[0])[-2]
        gp = -(-g // n_obs) * n_obs
        hp = -(-h // n_grid) * n_grid
        if (gp, hp) == (g, h):
            return inputs, h
        out = []
        for x in inputs:
            nd = np.ndim(x)
            pad = [(0, 0)] * nd
            if nd >= 3:
                pad[0] = (0, gp - g)
                pad[-2] = (0, hp - h)
            elif np.shape(x)[0] == g:
                pad[0] = (0, gp - g)
            out.append(_pad_array(x, pad, np.nan)
                       if any(p != (0, 0) for p in pad) else x)
        return fields_cls(*out), h
    return pad_fn


def _opt_ctm_pmid(inputs):
    """Resolve the (possibly carrier-compressed) CTM pressure stack of an
    opt-sensor month (trace-time shape branch, like the Eta step)."""
    if inputs.ctm_pmid_a.shape[-1] > 1:
        return decompress_pmid(inputs.ctm_pmid[:, 0],
                               inputs.ctm_pmid_a, inputs.ctm_pmid_b)
    return inputs.ctm_pmid


def mopitt_month_step(inputs: MopittMonthInputs, bias_offset: float = 0.0,
                      bias_slope: float = 1.0, error_ctm: float = 50.0,
                      ctm_scale: float = 1.0, weighting=None,
                      return_granules: bool = False, run_oi: bool = True):
    """AK convolution + averaging + OI for a MOPITT month, one program
    (the opt-sensor counterpart of :func:`full_month_step`; reference
    driver.py:45-51 conv_ak + :108-111 oi)."""
    from oisat.ops.vertical import ak_conv_mopitt_fields

    ctm_pmid = _opt_ctm_pmid(inputs)
    if inputs.ctm_airpc_a.shape[-1] > 1:
        # air columns reconstructed from the SAME pressure carrier (both
        # stacks are affine in surface pressure); the shipped ctm_airpc is
        # the empty (G, 0, H, W) placeholder.  The reconstruction is only
        # meaningful against the (G, 1, H, W) CARRIER layout — a full
        # pressure stack here would silently use level 0 as the surface
        # carrier, and the ~1e6 air-column slopes would amplify that into
        # garbage columns (shapes are static, so this check is free)
        if inputs.ctm_pmid.shape[1] != 1:
            raise ValueError(
                "compressed ctm_airpc tables require the carrier ctm_pmid "
                f"layout (G, 1, H, W); got ctm_pmid.shape={inputs.ctm_pmid.shape}"
                " — ship the pressure stack carrier-compressed too, or the"
                " air columns dense")
        ctm_airpc = decompress_pmid(inputs.ctm_pmid[:, 0],
                                    inputs.ctm_airpc_a, inputs.ctm_airpc_b)
    else:
        ctm_airpc = inputs.ctm_airpc
    model_vcd, model_xcol = jax.vmap(ak_conv_mopitt_fields)(
        ctm_pmid, inputs.ctm_profile, ctm_airpc,
        inputs.sat_pmid, inputs.aks, inputs.aprior_col,
        inputs.apriori_profile, inputs.apriori_surface, inputs.vcd)
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=model_vcd, aux1=inputs.x_col, aux2=model_xcol)
    out = analysis_step(ai, bias_offset=bias_offset, bias_slope=bias_slope,
                        error_ctm=error_ctm, ctm_scale=ctm_scale,
                        run_oi=run_oi,
                        weights=_granule_weights_traced(
                            weighting, inputs.uncertainty, aks=inputs.aks))
    if return_granules:
        return out, DailyGranules(vcd=inputs.vcd, ctm_vcd=model_vcd,
                                  uncertainty=inputs.uncertainty)
    return out


def make_mopitt_month_step(mesh: Mesh, **kwargs):
    return _make_month_step(mopitt_month_step, MopittMonthInputs, mesh, kwargs)


class GosatMonthInputs(NamedTuple):
    """A month of gridded GOSAT granules + matched daily CTM slices.  The
    OI runs on the XCH4 pair (reference driver.py:112-114).

    Same transfer-compressed CTM layout as :class:`MopittMonthInputs`:
    ``ctm_pmid`` may be the (G, 1, H, W) carrier with real (G, Lc) tables
    ((1, 1) dummies = full)."""

    ctm_pmid: jax.Array  # (G, Lc, H, W) | (G, 1, H, W) carrier
    ctm_profile: jax.Array  # (G, Lc, H, W)
    sat_pmid: jax.Array  # (G, Ls, H, W)
    aks: jax.Array  # (G, Ls, H, W)
    apriori_profile: jax.Array  # (G, Ls, H, W)
    pressure_weight: jax.Array  # (G, Ls, H, W)
    vcd: jax.Array  # (G, H, W)
    x_col: jax.Array  # (G, H, W)
    uncertainty: jax.Array  # (G, H, W)
    ctm_pmid_a: jax.Array = np.zeros((1, 1), np.float32)  # (G, Lc)
    ctm_pmid_b: jax.Array = np.zeros((1, 1), np.float32)


GosatMonthInputs._field_specs = (
    ("obs", None, "grid", None), ("obs", None, "grid", None),
    ("obs", None, "grid", None), ("obs", None, "grid", None),
    ("obs", None, "grid", None), ("obs", None, "grid", None),
    ("obs", "grid", None), ("obs", "grid", None), ("obs", "grid", None),
    (None, None), (None, None),
)


def gosat_month_step(inputs: GosatMonthInputs, bias_offset: float = 0.0,
                     bias_slope: float = 1.0, error_ctm: float = 50.0,
                     ctm_scale: float = 1.0, weighting=None,
                     return_granules: bool = False, run_oi: bool = True):
    """AK convolution + averaging + xcol-pair OI for a GOSAT month
    (reference ak_conv_gosat.py:8-146; model VCD stays NaN — :138)."""
    from oisat.ops.vertical import ak_conv_gosat_fields

    model_xcol = jax.vmap(ak_conv_gosat_fields)(
        _opt_ctm_pmid(inputs), inputs.ctm_profile, inputs.sat_pmid,
        inputs.aks, inputs.apriori_profile, inputs.pressure_weight,
        inputs.x_col)
    nanlike = jnp.full_like(inputs.vcd, jnp.nan)
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=nanlike, aux1=inputs.x_col, aux2=model_xcol)
    out = analysis_step(ai, bias_offset=bias_offset, bias_slope=bias_slope,
                        error_ctm=error_ctm, gosat_mode=True,
                        ctm_scale=ctm_scale, run_oi=run_oi,
                        weights=_granule_weights_traced(
                            weighting, inputs.uncertainty, aks=inputs.aks))
    if return_granules:
        # staged ak_conv_gosat leaves the model VCD NaN (reference
        # ak_conv_gosat.py:138): the daily files carry the same
        return out, DailyGranules(vcd=inputs.vcd, ctm_vcd=nanlike,
                                  uncertainty=inputs.uncertainty)
    return out


def make_gosat_month_step(mesh: Mesh, **kwargs):
    return _make_month_step(gosat_month_step, GosatMonthInputs, mesh, kwargs)


MopittMonthInputs._pad_fn = staticmethod(_pad_opt(MopittMonthInputs))
GosatMonthInputs._pad_fn = staticmethod(_pad_opt(GosatMonthInputs))


class SsmisMonthInputs(NamedTuple):
    """A month of gridded SSMIS granules + matched water partial columns
    (reference pwv_cal.py:7-101 at month scale)."""

    water_pc: jax.Array  # (G, Lc, H, W)  dp*q/g/1e4 on the analysis grid
    vcd: jax.Array  # (G, H, W)
    uncertainty: jax.Array  # (G, H, W)


SsmisMonthInputs._field_ranks = (4, 3, 3)


def ssmis_month_step(inputs: SsmisMonthInputs, bias_offset: float = 0.0,
                     bias_slope: float = 1.0, error_ctm: float = 50.0,
                     ctm_scale: float = 1.0, weighting=None,
                     return_granules: bool = False, run_oi: bool = True):
    """PWV + averaging + OI for an SSMIS month, one program."""
    from oisat.ops.vertical import pwv_fields

    pwv = jax.vmap(pwv_fields)(inputs.water_pc, inputs.vcd)
    nanlike = jnp.full_like(inputs.vcd, jnp.nan)
    ai = AnalysisInputs(vcd=inputs.vcd, uncertainty=inputs.uncertainty,
                        ctm_vcd=pwv, aux1=nanlike, aux2=nanlike)
    out = analysis_step(ai, bias_offset=bias_offset, bias_slope=bias_slope,
                        error_ctm=error_ctm, ctm_scale=ctm_scale,
                        run_oi=run_oi,
                        weights=_granule_weights_traced(weighting,
                                                        inputs.uncertainty))
    if return_granules:
        return out, DailyGranules(vcd=inputs.vcd, ctm_vcd=pwv,
                                  uncertainty=inputs.uncertainty)
    return out


def make_ssmis_month_step(mesh: Mesh, **kwargs):
    return _make_month_step(ssmis_month_step, SsmisMonthInputs, mesh, kwargs)
