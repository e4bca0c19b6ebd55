"""Observation operators: CTM↔satellite matching (host) + batched kernels (device).

Drop-in equivalents of the reference's ``amf_recal`` (amf_recal.py:121-185),
``ak_conv_mopitt`` (ak_conv_mopitt.py:8-149), ``ak_conv_gosat``
(ak_conv_gosat.py:8-146) and ``pwv_calculator`` (pwv_cal.py:7-101): same
call signature (list of CTM granules, list of gridded satellite granules,
mutated in place and returned), but the per-pixel scipy loops are replaced
by the batched device kernels in :mod:`oisat.ops.vertical`, and the
CTM→satellite-grid upscaling runs once as a batched (L, H, W) apply through
a cached :class:`~oisat.regridder.Upscaler`.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from oisat.ops.vertical import (
    air_partial_column,
    amf_recal_fields,
    amf_recal_noak_fields,
    ak_conv_gosat_fields,
    ak_conv_mopitt_fields,
    partial_column,
    pwv_fields,
)
from oisat.ops.weights import diag_threshold
from oisat.regridder import make_upscaler

__all__ = ["amf_recal", "ak_conv_mopitt", "ak_conv_gosat", "pwv_calculator"]


# --------------------------------------------------------------------------
# time matching (host; reference amf_recal.py:8-37, ak_conv_mopitt.py:10-52)
# --------------------------------------------------------------------------

def _flatten_time(t):
    return (t.year * 10000 + t.month * 100 + t.day + t.hour / 24.0
            + t.minute / 60.0 / 24.0 + t.second / 3600.0 / 24.0)


def _hour_only(t):
    return t.hour / 24.0 + t.minute / 60.0 / 24.0 + t.second / 3600.0 / 24.0


def _ctm_times(ctm_data):
    time_ctm, time_hour = [], []
    for g in ctm_data:
        for t in g.time:
            time_ctm.append(_flatten_time(t))
            time_hour.append(_hour_only(t))
    return np.array(time_ctm), np.array(time_hour)


def _match_amf(time_sat_dt, ctm_data, time_ctm, time_hour):
    """3-hourly day/hour matching (reference amf_recal.py:26-37)."""
    if not ctm_data[0].averaged:
        closest = int(np.argmin(np.abs(_flatten_time(time_sat_dt) - time_ctm)))
        return closest, int(np.floor(closest / 8.0)), int(closest % 8)
    closest = int(np.argmin(np.abs(_hour_only(time_sat_dt) - time_hour)))
    return closest, 0, int(closest)


def _match_daily(time_sat_dt, ctm_data, time_ctm):
    """Day-resolution matching (reference ak_conv_mopitt.py:41-51)."""
    if not ctm_data[0].averaged:
        t = (time_sat_dt.year * 10000 + time_sat_dt.month * 100 + time_sat_dt.day)
        closest = int(np.argmin(np.abs(t - time_ctm)))
        return closest, closest
    return 0, 0


# --------------------------------------------------------------------------
# CTM slicing / upscaling helpers
# --------------------------------------------------------------------------

def _amf_ctm_slice(ctm_data, day, hour):
    """(pmid, profile, dp) at the matched time (reference amf_recal.py:39-49)."""
    g = ctm_data[day]
    if g.ctmtype == "FREE":
        return (np.squeeze(g.pressure_mid), np.squeeze(g.gas_profile), np.squeeze(g.delta_p))
    return (np.squeeze(g.pressure_mid[hour]), np.squeeze(g.gas_profile[hour]), np.squeeze(g.delta_p[hour]))


def _daily_ctm_slice(ctm_data, day):
    """(pmid, profile, dp), time-collapsed for GMI (reference ak_conv_mopitt.py:59-77)."""
    g = ctm_data[day]
    if g.ctmtype in ("ECCOH", "FREE"):
        return (np.squeeze(g.pressure_mid), np.squeeze(g.gas_profile), np.squeeze(g.delta_p))
    # GMI: average the sub-daily axis
    return (
        np.squeeze(np.nanmean(g.pressure_mid, axis=0)),
        np.squeeze(np.nanmean(g.gas_profile, axis=0)),
        np.squeeze(np.nanmean(g.delta_p, axis=0)),
    )


# content-based geometry key shared with the regrid caches
from oisat.regridder import _geom_key  # noqa: E402
from oisat.utils.lru import LockedLRU  # noqa: E402

# regular-grid sensors key-collapse to ~1 entry; per-granule geometries
# (e.g. a TEMPO L2 campaign) churn through, so bound it.
_upscaler_cache = LockedLRU(32)


def _ctm_to_sat_upscaler(ctm_data, granule):
    """Upscaler mapping CTM-grid (L, H, W) fields onto the satellite grid
    (reference amf_recal.py:58-83; KD-nearest, 2x cutoff).  LRU-cached per
    geometry — the reference rebuilds the KD tree per granule per level."""
    key = (_geom_key(ctm_data[0].longitude, ctm_data[0].latitude),
           _geom_key(granule.longitude_center, granule.latitude_center))
    hit = _upscaler_cache.get(key)
    if hit is not None:
        return hit
    sat_lon, sat_lat = granule.longitude_center, granule.latitude_center
    threshold_sat = diag_threshold(sat_lon, sat_lat)
    gridsize_ctm = diag_threshold(ctm_data[0].longitude, ctm_data[0].latitude)
    up = make_upscaler(
        ctm_data[0].longitude, ctm_data[0].latitude, sat_lon, sat_lat,
        gridsize_ctm, threshold_sat, method=4, far_factor=2.0,
    )
    _upscaler_cache.put(key, up)
    return up


def _maybe_upscale(ctm_data, granule, fields):
    """Upscale (L, H, W) fields onto the sat grid when flagged — all fields
    stacked through one device call.

    Affine fields (hybrid-eta pressure stacks, eta air columns) ship ONE
    carrier level: the upscaler's partition-of-unity weights commute with
    the affine reconstruction (``up(a + b*ps) == a + b*up(ps)``, the
    regridder's carrier trick), so the other levels are rebuilt on the
    host from the upscaled carrier.  An upscaled-CTM granule (the
    OMPS/TEMPO fine-grid path) otherwise moves its full (L, Hs, Ws)
    stacks host<->device per granule.  Parity mode keeps the
    reference's full per-level upscale."""
    if not granule.ctm_upscaled_needed:
        return fields
    from oisat.regridder import _affine_stack, parity_mode

    up = _ctm_to_sat_upscaler(ctm_data, granule)
    rows, plans = [], []
    for f in fields:
        arr = np.asarray(f, np.float64)
        # single-level CTMs arrive 2-D (np.squeeze in the slice helpers):
        # treat as a 1-level stack and squeeze back on the way out
        two_d = arr.ndim == 2
        st = arr[None] if two_d else arr
        af = None if (two_d or parity_mode()) else _affine_stack(st)
        if af is not None:
            plans.append(("affine", len(rows), af, two_d))
            rows.append(st[af[2]])
        else:
            plans.append(("full", len(rows), st.shape[0], two_d))
            rows.extend(st)
    # bucket the stacked row count: per-field affinity makes R vary with
    # the matched slice (mixed-affinity months), and every distinct
    # (R, H, W) shape is a fresh compile of the upscale program —
    # NaN pad rows upscale to NaN and the plans below never index them
    from oisat.ops.regrid import pad_to_bucket

    stacked = np.stack(rows)
    rb = pad_to_bucket(len(rows), min_size=8, steps_per_octave=4)
    if rb > len(rows):
        stacked = np.concatenate(
            [stacked, np.full((rb - len(rows),) + stacked.shape[1:], np.nan)])
    out = np.asarray(up.apply(jnp.asarray(stacked)))
    res = []
    for kind, start, info, two_d in plans:
        if kind == "affine":
            a, b, _ci = info
            r = a[:, None, None] + b[:, None, None] * out[start][None]
        else:
            r = out[start:start + info]
        res.append(r[0] if two_d else r)
    return res


# --------------------------------------------------------------------------
# public operators
# --------------------------------------------------------------------------

def _amf_one(ctm_data, granule, time_ctm, time_hour):
    """Prepare one granule's matched CTM fields; returns a work item."""
    closest, day, hour = _match_amf(granule.time, ctm_data, time_ctm, time_hour)
    pmid, profile, dp = _amf_ctm_slice(ctm_data, day, hour)
    # partial_column is elementwise — run it in host NumPy.  A per-granule
    # device dispatch here would round-trip the whole (L, H, W) slice
    # (~9 MB) host<->device to do one multiply.
    pc = np.asarray(partial_column(np.asarray(dp, np.float64),
                                   np.asarray(profile, np.float64)))
    if granule.ctm_upscaled_needed:
        pmid, pc = _maybe_upscale(ctm_data, granule, [pmid, pc])
    from oisat.regridder import f16_transfer_default

    if f16_transfer_default():
        # compute in f64 above, but TRANSFER at f32 so the _stack16 /
        # stack_lv narrowing applies (a f64 pc would ship at f32 after
        # canonicalization — 2x the bytes of the f16 the guarded
        # narrowing gives these fields on the transfer-bound link).
        # Gated on the f16-transfer switch, not just parity: with
        # OISAT_F16_TRANSFER=0 the contract is full precision end-to-end
        # (the frozen golden month depends on the f64 pc).
        pc = pc.astype(np.float32)
    has_trop = np.size(granule.tropopause) != 1
    # keep the granule's own leaf type AND dtype: device-granule months
    # must not pull the tropopause back to host here, and the zeros
    # placeholder must not promote the stack to f64
    trop = (granule.tropopause if has_trop
            else np.zeros(np.shape(granule.vcd), dtype=granule.vcd.dtype))
    return closest, np.asarray(pmid), pc, trop, has_trop



def _stack16(arrs):
    """Stack level-stack fields for transfer: in narrow mode (the
    production default) BOTH f32 and f64 sources travel as f16 — the
    reference stores exactly these fields in float16 (SURVEY.md §2
    precision note), and an f64 host intermediate is not a precision
    contract, just how NumPy produced it.  Full precision end-to-end is
    the parity switches' job (OISAT_PARITY=1 / OISAT_F16_TRANSFER=0):
    with them set, sources keep their own dtype.  The device kernels
    upcast to f32 for compute (ops/vertical._at_least_f32).

    Range guard: a field whose finite magnitude exceeds f16 range stays at
    full precision — an unguarded cast overflows to inf and poisons the
    interpolation (e.g. MOPITT air columns ~1e9, the OMPS
    column-as-pressure quirk ~1e15; reference reader.py:1089)."""
    from oisat.regridder import f16_transfer_default, fits_f16

    out = np.stack(arrs)
    if f16_transfer_default() and out.dtype == np.float64:
        # f64 HOST intermediates (matched CTM pmid/profile slices) take the
        # production transfer dtype too: without this cast they shipped at
        # f32 (post-canonicalization) while the f32-sourced fields went
        # f16 — 2x the bytes for no fidelity (device compute is f32 either
        # way).  Full-precision contract (parity / OISAT_F16_TRANSFER=0)
        # keeps f64 untouched.
        out = out.astype(np.float32)
    if out.dtype == np.float32 and f16_transfer_default() and fits_f16(out):
        return jnp.asarray(out.astype(np.float16))
    return jnp.asarray(out)


_amf_recal_batched = jax.jit(
    jax.vmap(amf_recal_fields, in_axes=(0, 0, 0, 0, 0, 0, 0, None)),
    static_argnums=(7,),
)


def _ctm_slice_key(granule, closest):
    """Dedup key for a granule's matched CTM slice: the matched time index
    uniquely identifies it, plus the granule grid when the slice was
    upscaled onto it (shared with driver._fused_inputs)."""
    from oisat.regridder import _geom_key

    if granule.ctm_upscaled_needed:
        return (closest,
                _geom_key(np.atleast_2d(np.asarray(granule.longitude_center)),
                          np.atleast_2d(np.asarray(granule.latitude_center))))
    return closest


def _amf_recal_eta(carrier, a_tab, b_tab, sw, ctm_pmid_u, ctm_pc_u, idx,
                   trop, vcd, amf, has_trop, ctm_a=None, ctm_b=None):
    """Transfer-compressed batched AMF recal: the per-granule pressure
    stack travels as one carrier level + (G, Ls) affine tables, and the
    matched CTM slices travel once each, gathered by index on device —
    the same decompression the fused month step uses.

    When the CTM stacks are hybrid-eta affine too (GMI/ECCOH),
    ``ctm_pmid_u`` is the (U, 1, H, W) carrier and ``ctm_a``/``ctm_b``
    carry the (U, Lc) tables (None -> full (U, Lc, H, W) layout; the
    pytree-structure difference keeps the two layouts as separate
    programs, mirroring the fused step's shape branch)."""
    from oisat.parallel.analysis import decompress_pmid

    sat_pmid = decompress_pmid(carrier, a_tab, b_tab)
    if ctm_a is not None:
        ctm_pmid = decompress_pmid(jnp.take(ctm_pmid_u[:, 0], idx, axis=0),
                                   jnp.take(ctm_a, idx, axis=0),
                                   jnp.take(ctm_b, idx, axis=0))
    else:
        ctm_pmid = jnp.take(ctm_pmid_u, idx, axis=0)
    ctm_pc = jnp.take(ctm_pc_u, idx, axis=0)
    return jax.vmap(amf_recal_fields,
                    in_axes=(0, 0, 0, 0, 0, 0, 0, None))(
        sat_pmid, sw, ctm_pmid, ctm_pc, trop, vcd, amf, has_trop)


_amf_recal_batched_eta = jax.jit(_amf_recal_eta, static_argnums=(10,))


def amf_recal(ctm_data: list, sat_data: list):
    """Recalculate AMFs / model VCDs for every granule (reference amf_recal.py:121-185).

    Granules sharing a (shape, tropopause) signature are stacked and run
    through one vmapped device call — a month of orbits is a couple of
    dispatches instead of hundreds.  When every granule's pressure stack is affine in
    one field (all real products) the batch travels compressed: carrier
    level + tables, plus one copy of each distinct CTM slice.
    """
    print("AMF Recal begins...")
    time_ctm, time_hour = _ctm_times(ctm_data)
    groups = {}
    for gi, granule in enumerate(sat_data):
        if granule is None:
            continue
        closest, pmid, pc, trop, has_trop = _amf_one(ctm_data, granule, time_ctm, time_hour)
        if np.size(granule.scattering_weights) == 1:
            print("No scattering weights found, recalculation is not possible..just grabbing VCDs")
            model_vcd = np.asarray(amf_recal_noak_fields(
                jnp.asarray(pmid), jnp.asarray(pc), jnp.asarray(trop),
                jnp.asarray(granule.vcd), has_trop))
            granule.ctm_vcd = model_vcd
            granule.ctm_time_at_sat = time_ctm[closest]
            granule.old_amf = np.empty((1,))
            granule.new_amf = np.empty((1,))
            continue
        key = (np.shape(granule.vcd), np.shape(granule.pressure_mid), pmid.shape, has_trop)
        groups.setdefault(key, []).append((gi, closest, pmid, pc, trop))

    for (vshape, sshape, cshape, has_trop), items in groups.items():
        gis = [it[0] for it in items]
        stack = lambda f: jnp.asarray(np.stack(f))
        # parity mode keeps the reference's full per-level transfer
        grp = _affine_group([np.asarray(sat_data[i].pressure_mid)
                             for i in gis])
        if grp is not None:
            sat_carriers, sat_a, sat_b = grp
            # dedup the matched CTM slices
            from oisat.parallel.analysis import dedup_first_seen

            keys = [_ctm_slice_key(sat_data[it[0]], it[1]) for it in items]
            order, idxs = dedup_first_seen(keys)
            u_items = [items[i] for i in order]
            # carrier-compress the unique CTM slices too when affine
            # (GMI/ECCOH; CMAQ 3-D pressures keep the full layout)
            cgrp = _affine_group([np.asarray(it[2]) for it in u_items])
            if cgrp is not None:
                c_carr, c_a, c_b = cgrp
                ctm_pm_arg = _stack16([c[None] for c in c_carr])
                ctm_a = stack(c_a)
                ctm_b = stack(c_b)
            else:
                ctm_pm_arg = _stack16([np.asarray(it[2]) for it in u_items])
                ctm_a = ctm_b = None
            new_amf, vcd_corr, model_vcd = _amf_recal_batched_eta(
                _stack16(sat_carriers),
                stack(sat_a),
                stack(sat_b),
                _stack16([np.asarray(sat_data[i].scattering_weights) for i in gis]),
                ctm_pm_arg,
                _stack16([it[3] for it in u_items]),
                jnp.asarray(np.asarray(idxs, np.int32)),
                stack([it[4] for it in items]),
                stack([np.asarray(sat_data[i].vcd) for i in gis]),
                stack([np.asarray(sat_data[i].amf) for i in gis]),
                has_trop,
                ctm_a, ctm_b,
            )
        else:
            new_amf, vcd_corr, model_vcd = _amf_recal_batched(
                _stack16([np.asarray(sat_data[i].pressure_mid) for i in gis]),
                _stack16([np.asarray(sat_data[i].scattering_weights) for i in gis]),
                _stack16([it[2] for it in items]),
                _stack16([it[3] for it in items]),
                stack([it[4] for it in items]),
                stack([np.asarray(sat_data[i].vcd) for i in gis]),
                stack([np.asarray(sat_data[i].amf) for i in gis]),
                has_trop,
            )
        new_amf = np.asarray(new_amf)
        vcd_corr = np.asarray(vcd_corr)
        model_vcd = np.asarray(model_vcd)
        for k, (gi, closest, *_rest) in enumerate(items):
            g = sat_data[gi]
            g.old_amf = g.amf
            g.new_amf = new_amf[k]
            g.vcd = vcd_corr[k]
            g.ctm_vcd = model_vcd[k]
            g.ctm_time_at_sat = time_ctm[closest]
    return sat_data


_ak_mopitt_batched = jax.jit(jax.vmap(ak_conv_mopitt_fields))


def _ak_mopitt_eta(carrier, pm_a, pm_b, ai_a, ai_b, airpc_dense, profile,
                   sat_pmid, aks, aprior_col, apriori_profile,
                   apriori_surface, vcd):
    """Transfer-compressed staged MOPITT batch: the CTM pressure stack
    reconstructs on device from one f32 carrier level + (G, Lc) tables;
    the air columns either ride the SAME carrier (``ai_a``/``ai_b``
    tables, ``airpc_dense=None``) or travel dense when their fit failed
    (``ai_a=None``) — the independent branches mirror the fused month's
    layout.  The None-argument pytree difference keeps the variants as
    separate programs."""
    from oisat.parallel.analysis import decompress_pmid

    ctm_pmid = decompress_pmid(carrier, pm_a, pm_b)
    ctm_airpc = (decompress_pmid(carrier, ai_a, ai_b)
                 if ai_a is not None else airpc_dense)
    return jax.vmap(ak_conv_mopitt_fields)(
        ctm_pmid, profile, ctm_airpc, sat_pmid, aks, aprior_col,
        apriori_profile, apriori_surface, vcd)


_ak_mopitt_batched_eta = jax.jit(_ak_mopitt_eta)


def _affine_group(stacks):
    """Fit a group of (L, ...) stacks for carrier+table transfer.  Returns
    ``(carriers, a_tabs, b_tabs)`` lists, or None when parity mode
    is on or ANY stack fails the fit (one layout per batch — mixing
    carrier and dense members in one stacked call is impossible).  Shared
    by the staged AMF/AK batch assemblies AND driver._fused_inputs so the
    affine transfer contract lives in one place."""
    from oisat.regridder import _affine_stack, parity_mode

    if parity_mode() or not stacks:
        return None
    fits = [_affine_stack(s) for s in stacks]
    if any(af is None for af in fits):
        return None
    return ([s[af[2]] for s, af in zip(stacks, fits)],
            [af[0] for af in fits], [af[1] for af in fits])


def _carrier_tables_group(stacks, carriers):
    """Fit a group of (L, ...) stacks against already-chosen carrier
    levels (``stack[l] ~= a[l] + b[l] * carrier``).  Returns
    ``(a_tabs, b_tabs)`` lists or None when any fit fails — all-or-none,
    like :func:`_affine_group`, because the batch ships one layout.  Used
    for MOPITT air columns riding the pressure carrier (staged batch and
    the fused month's inputs)."""
    from oisat.regridder import _affine_tables

    tabs = [_affine_tables(np.asarray(s), c) for s, c in zip(stacks, carriers)]
    if any(t is None for t in tabs):
        return None
    return [t[0] for t in tabs], [t[1] for t in tabs]


def ak_conv_mopitt(ctm_data: list, sat_data: list):
    """MOPITT CO averaging-kernel convolution (reference ak_conv_mopitt.py:8-149).

    Granules with a common shape signature run through one vmapped call."""
    print("Averaging Kernel Conv begins...")
    time_ctm, _ = _ctm_times(ctm_data)
    groups = {}
    for gi, granule in enumerate(sat_data):
        if granule is None:
            continue
        closest, day = _match_daily(granule.time, ctm_data, time_ctm)
        pmid, profile, dp = _daily_ctm_slice(ctm_data, day)
        # elementwise: host NumPy, no per-granule device round trip.
        # The reference also builds + upscales ctm_partial_column here
        # (ak_conv_mopitt.py:67,103) but never reads it in the conv
        # (:118-146 uses profile/pressure/air columns only) — we skip
        # that dead work, including its upscale rows.
        airpc = np.asarray(air_partial_column(np.asarray(dp, np.float64)))
        if granule.ctm_upscaled_needed:
            pmid, profile, airpc = _maybe_upscale(ctm_data, granule, [pmid, profile, airpc])
        key = (np.shape(granule.vcd), np.shape(granule.pressure_mid), np.shape(pmid))
        groups.setdefault(key, []).append((gi, closest, np.asarray(pmid), np.asarray(profile), airpc))
    for items in groups.values():
        gis = [it[0] for it in items]
        stack = lambda f: jnp.asarray(np.stack(f))
        # carrier-compress the matched CTM pressure stack; the air
        # columns ride the SAME carrier when their own fit succeeds and
        # travel dense otherwise (independent branches, like the fused
        # month).  Carrier at f32: air-column slopes are ~1e6.  No
        # slice dedup here: MOPITT/GOSAT matching is day-resolution and
        # those products are one granule per day, so U == G in practice
        # (the hourly-matched AMF batch dedups because its slices repeat)
        # sat-side args are identical between the compressed and dense
        # branches — build them ONCE so a future narrowing/field change
        # cannot desynchronize the two staged layouts
        profile = _stack16([it[3] for it in items])
        sat_args = (
            _stack16([np.asarray(sat_data[i].pressure_mid) for i in gis]),
            _stack16([np.asarray(sat_data[i].averaging_kernels) for i in gis]),
            stack([np.asarray(sat_data[i].aprior_column) for i in gis]),
            # the reference keeps MOPITT's apriori profile full-precision
            # (reference reader.py MOPITT section: no astype, unlike its
            # f16 AKs/pressures) — ship it wide
            stack([np.asarray(sat_data[i].apriori_profile) for i in gis]),
            stack([np.asarray(sat_data[i].apriori_surface) for i in gis]),
            stack([np.asarray(sat_data[i].vcd) for i in gis]))
        grp = _affine_group([it[2] for it in items])
        if grp is not None:
            carriers, pm_a, pm_b = grp
            atabs = _carrier_tables_group([it[4] for it in items], carriers)
            if atabs is None:
                ai_a = ai_b = None
                airpc_dense = stack([it[4] for it in items])
            else:
                ai_a = stack(atabs[0])
                ai_b = stack(atabs[1])
                airpc_dense = None
            model_vcd, model_xcol = _ak_mopitt_batched_eta(
                stack(carriers), stack(pm_a), stack(pm_b),
                ai_a, ai_b, airpc_dense, profile, *sat_args)
        else:
            model_vcd, model_xcol = _ak_mopitt_batched(
                _stack16([it[2] for it in items]),
                profile,
                # air partial columns are ~1e9 per layer — far beyond f16
                # range (unlike the satellite-stored f16 fields); keep
                # full precision
                stack([it[4] for it in items]),
                *sat_args)
        model_vcd = np.asarray(model_vcd)
        model_xcol = np.asarray(model_xcol)
        for k, (gi, closest, *_r) in enumerate(items):
            sat_data[gi].ctm_vcd = model_vcd[k]
            sat_data[gi].ctm_xcol = model_xcol[k]
            sat_data[gi].ctm_time_at_sat = time_ctm[closest]
    return sat_data


_ak_gosat_batched = jax.jit(jax.vmap(ak_conv_gosat_fields))


def _ak_gosat_eta(carrier, pm_a, pm_b, profile, sat_pmid, aks,
                  apriori_profile, pressure_weight, x_col):
    """Transfer-compressed staged GOSAT batch (CTM pmid from carrier +
    tables, like the fused month)."""
    from oisat.parallel.analysis import decompress_pmid

    ctm_pmid = decompress_pmid(carrier, pm_a, pm_b)
    return jax.vmap(ak_conv_gosat_fields)(
        ctm_pmid, profile, sat_pmid, aks, apriori_profile, pressure_weight,
        x_col)


_ak_gosat_batched_eta = jax.jit(_ak_gosat_eta)


def ak_conv_gosat(ctm_data: list, sat_data: list):
    """GOSAT XCH4 averaging-kernel convolution (reference ak_conv_gosat.py:8-146).

    Granules with a common shape signature run through one vmapped call."""
    print("Averaging Kernel Conv begins...")
    time_ctm, _ = _ctm_times(ctm_data)
    groups = {}
    for gi, granule in enumerate(sat_data):
        if granule is None:
            continue
        closest, day = _match_daily(granule.time, ctm_data, time_ctm)
        pmid, profile, dp = _daily_ctm_slice(ctm_data, day)
        if granule.ctm_upscaled_needed:
            pmid, profile = _maybe_upscale(ctm_data, granule, [pmid, profile])
        key = (np.shape(granule.x_col), np.shape(granule.pressure_mid), np.shape(pmid))
        groups.setdefault(key, []).append((gi, closest, np.asarray(pmid), np.asarray(profile)))
    for items in groups.values():
        gis = [it[0] for it in items]
        stack = lambda f: jnp.asarray(np.stack(f))
        # shared sat-side assembly, like ak_conv_mopitt: one tuple feeds
        # both the compressed and dense staged layouts
        # GOSAT ships WIDE (f32): the reference stores its AKs, pressure
        # weights, apriori profiles and pressures at full precision (no
        # astype in reference reader.py's GOSAT section), and the
        # xcol-pair innovations are ~10 ppb anomalies on a ~1900 ppb
        # background — f16's 1.0 ppb spacing would inject percent-level
        # innovation errors the reference never has.
        profile = stack([it[3] for it in items])
        sat_args = (
            stack([np.asarray(sat_data[i].pressure_mid) for i in gis]),
            stack([np.asarray(sat_data[i].averaging_kernels) for i in gis]),
            stack([np.asarray(sat_data[i].apriori_profile) for i in gis]),
            stack([np.asarray(sat_data[i].pressure_weight) for i in gis]),
            stack([np.asarray(sat_data[i].x_col) for i in gis]))
        grp = _affine_group([it[2] for it in items])
        if grp is not None:
            carriers, pm_a, pm_b = grp
            model_xcol = _ak_gosat_batched_eta(
                stack(carriers), stack(pm_a), stack(pm_b), profile, *sat_args)
        else:
            model_xcol = _ak_gosat_batched(
                stack([it[2] for it in items]), profile, *sat_args)
        model_xcol = np.asarray(model_xcol)
        for k, (gi, closest, *_r) in enumerate(items):
            # XCH4-only: model VCD intentionally NaN (reference ak_conv_gosat.py:138)
            sat_data[gi].ctm_vcd = np.full_like(np.asarray(sat_data[gi].vcd), np.nan)
            sat_data[gi].ctm_xcol = model_xcol[k]
            sat_data[gi].ctm_time_at_sat = time_ctm[closest]
    return sat_data


_pwv_batched = jax.jit(jax.vmap(pwv_fields))


def pwv_calculator(ctm_data: list, sat_data: list):
    """Model precipitable water vapor for SSMIS (reference pwv_cal.py:7-101).

    Granules sharing a shape signature run through one vmapped device call,
    like the other staged operators — a month of daily global grids is one
    dispatch instead of ~30.  The water partial columns ship
    at f32, never f16: their ~1e-5 magnitudes sit in f16's subnormal range.
    """
    print("PWV begins...")
    time_ctm, _ = _ctm_times(ctm_data)
    groups = {}
    for gi, granule in enumerate(sat_data):
        if granule is None:
            continue
        _, day = _match_daily(granule.time, ctm_data, time_ctm)
        g = ctm_data[day]
        if g.ctmtype in ("ECCOH", "FREE"):
            dp = np.squeeze(g.delta_p)
            q = np.squeeze(g.gas_profile)
        else:
            dp = np.squeeze(np.nanmean(g.delta_p, axis=0))
            q = np.squeeze(np.nanmean(g.gas_profile, axis=0))
        pcw = dp * q / 9.80665 / 10000.0
        if granule.ctm_upscaled_needed:
            (pcw,) = _maybe_upscale(ctm_data, granule, [pcw])
        key = (np.shape(pcw), np.shape(granule.vcd))
        groups.setdefault(key, []).append((gi, np.asarray(pcw, np.float32)))
    for items in groups.values():
        gis = [it[0] for it in items]
        pwv = np.asarray(_pwv_batched(
            jnp.asarray(np.stack([it[1] for it in items])),
            jnp.asarray(np.stack([np.asarray(sat_data[i].vcd) for i in gis]))))
        for k, gi in enumerate(gis):
            sat_data[gi].ctm_vcd = pwv[k]
    return sat_data
