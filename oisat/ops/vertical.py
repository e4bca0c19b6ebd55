"""Vertical observation-operator kernels, fully batched over grid cells.

The reference computes these with a Python double loop over pixels and one
scipy ``interp1d`` call per pixel (reference oisatgmi/amf_recal.py:93-119,
ak_conv_mopitt.py:118-138, ak_conv_gosat.py:118-135) — its single worst
serial bottleneck.  Here each kernel is one jitted, vmap-free vectorized
computation over the whole (H, W) grid: the per-pixel 1-D interpolation
becomes a broadcasted compare/gather (levels are small, so the O(Ls*Lt)
compare matrix is cheap elementwise work), and the level sums are masked
reductions.

Physical constants match the reference (amf_recal.py:51-56):
Mair = 28.97e-3 kg/mol, g = 9.80665 m/s^2, N_A = 6.02214076e23.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "partial_column",
    "air_partial_column",
    "interp_linear_batched",
    "amf_recal_fields",
    "amf_recal_noak_fields",
    "ak_conv_mopitt_fields",
    "ak_conv_gosat_fields",
    "pwv_fields",
]

MAIR = 28.97e-3
GRAV = 9.80665
N_A = 6.02214076e23


def partial_column(delta_p, profile_ppbv):
    """CTM gas partial column [1e15 molec/cm^2] from delta-p [hPa] and ppbv.

    Reference amf_recal.py:51-56: ``dp * q / g / Mair * N_A * 1e-4 * 1e-15
    * 100 * 1e-9``.
    """
    return delta_p * profile_ppbv / GRAV / MAIR * N_A * 1e-4 * 1e-15 * 100.0 * 1e-9


def air_partial_column(delta_p):
    """Air partial column [1e15 molec/cm^2] (reference ak_conv_mopitt.py:66)."""
    return delta_p / GRAV / MAIR * N_A * 1e-4 * 1e-15 * 100.0


def interp_linear_batched(xp, fp, xq, extrapolate: bool):
    """Column-wise linear interpolation, batched over trailing grid axes.

    ``xp``/``fp``: (Ls, ...) source abscissae/values; ``xq``: (Lt, ...)
    query abscissae.  Matches scipy ``interp1d`` semantics: abscissae in any
    monotonic order (sorted internally), ``extrapolate=True`` extends the
    end segments (fill_value='extrapolate'), ``False`` fills NaN outside the
    data range (bounds_error=False, fill_value=nan).  Columns containing
    non-finite abscissae yield NaN.
    """
    xp = jnp.moveaxis(xp, 0, -1)  # (..., Ls)
    fp = jnp.moveaxis(fp, 0, -1)
    xq = jnp.moveaxis(xq, 0, -1)  # (..., Lt)
    ls = xp.shape[-1]
    # Monotonic columns need neither an argsort nor a data flip: gathers
    # along the minor axis serialize badly, so an argsort + 6x
    # take_along_axis formulation lost to this one-hot contraction form
    # by several times on the fused month's batch.  The bracketing count sum(xp <= xq) is order-independent, and a
    # DESCENDING column's ascending-sorted element i lives at original
    # index ls-1-i — so the one-hot picks read the original arrays with
    # mirrored indices instead of materializing a lane-axis reverse.
    # (A minor-axis reverse inside a big fusion is avoided too: an
    # xp[..., ::-1] flip variant has crashed an XLA fusion emitter at the
    # MOPITT month-step shapes; this form has no reverse op at all.)
    # The documented contract is unchanged: abscissae in any MONOTONIC
    # order — a genuinely unsorted column yields NaN (guard below)
    # instead of scipy's sort, a case no physical pressure grid produces.
    desc = xp[..., :1] > xp[..., -1:]
    # searchsorted(right) on the sorted column: number of xp <= xq
    cnt = jnp.sum(xp[..., None, :] <= xq[..., :, None], axis=-1)  # (..., Lt)
    hi = jnp.clip(cnt, 1, ls - 1)
    lo = hi - 1
    # one-hot masked reductions instead of minor-axis gathers
    ar = jnp.arange(ls)
    oh_lo = jnp.where(desc, ls - 1 - lo, lo)[..., :, None] == ar
    oh_hi = jnp.where(desc, ls - 1 - hi, hi)[..., :, None] == ar
    x0 = jnp.sum(jnp.where(oh_lo, xp[..., None, :], 0), -1)
    x1 = jnp.sum(jnp.where(oh_hi, xp[..., None, :], 0), -1)
    f0 = jnp.sum(jnp.where(oh_lo, fp[..., None, :], 0), -1)
    f1 = jnp.sum(jnp.where(oh_hi, fp[..., None, :], 0), -1)
    t = (xq - x0) / (x1 - x0)
    out = f0 + t * (f1 - f0)
    if not extrapolate:
        # data range = the endpoint pair, whichever order the column runs
        oob = (xq < jnp.minimum(xp[..., :1], xp[..., -1:])) | \
              (xq > jnp.maximum(xp[..., :1], xp[..., -1:]))
        out = jnp.where(oob, jnp.nan, out)
    # Deliberate deviation from scipy: a column with ANY non-finite
    # abscissa is NaN'd entirely.  scipy interp1d would still interpolate
    # the finite segments (a partially-NaN CTM pressure column — e.g. one
    # missing hour in the GMI nanmean — keeps its pixel in the reference).
    # The conservative rule is chosen because a NaN level inside a sorted
    # column makes the segment choice ill-defined on device, and an inf
    # abscissa would otherwise poison neighbouring segments silently.
    # Non-monotonic columns NaN for the same reason; NaN-containing
    # columns trip this guard too (NaN compares False).
    step = jnp.diff(xp, axis=-1)
    colbad = ~(jnp.all(step >= 0, axis=-1, keepdims=True)
               | jnp.all(step <= 0, axis=-1, keepdims=True))
    colbad |= ~jnp.all(jnp.isfinite(xp), axis=-1, keepdims=True)
    out = jnp.where(colbad, jnp.nan, out)
    return jnp.moveaxis(out, -1, 0)


def _nansum0(x):
    """nansum over the leading (level) axis with numpy semantics (all-NaN -> 0)."""
    return jnp.sum(jnp.where(jnp.isnan(x), 0.0, x), axis=0)


def _at_least_f32(*arrays):
    """Upcast f16 transfer-dtype inputs to f32 for compute (level stacks
    may arrive as float16 — the reference's own storage precision for
    them; see regridder._regrid_fused)."""
    return tuple(a.astype(jnp.float32) if a.dtype == jnp.float16 else a
                 for a in arrays)


@partial(jax.jit, static_argnames=("has_trop",))
def amf_recal_fields(sat_pmid, sat_sw, ctm_pmid, ctm_pc, tropopause, vcd, amf_old, has_trop: bool):
    """AMF recalculation over the full grid (reference amf_recal.py:93-119, :173-183).

    sat_pmid/sat_sw: (Ls, H, W); ctm_pmid/ctm_pc: (Lc, H, W);
    tropopause/vcd/amf_old: (H, W).  Returns (new_amf, vcd_corrected,
    model_vcd) with the reference's NaN masking applied.
    """
    sat_pmid, sat_sw, ctm_pmid, ctm_pc = _at_least_f32(
        sat_pmid, sat_sw, ctm_pmid, ctm_pc)
    sw_i = interp_linear_batched(jnp.log(sat_pmid), sat_sw, jnp.log(ctm_pmid), extrapolate=True)
    sw_i = jnp.where(jnp.isinf(sw_i), 0.0, sw_i)
    pc = ctm_pc
    if has_trop:
        above = ctm_pmid < tropopause[None]
        sw_i = jnp.where(above, jnp.nan, sw_i)
        pc = jnp.where(above, jnp.nan, pc)
    scd = _nansum0(sw_i * pc)
    model_vcd = _nansum0(pc)
    new_amf = jnp.where(model_vcd != 0, scd / model_vcd, jnp.nan)
    bad = jnp.isnan(vcd)
    new_amf = jnp.where(bad, jnp.nan, new_amf)
    vcd_corr = amf_old * vcd / new_amf
    # bad (NaN vcd) is subsumed: vcd NaN -> vcd_corr NaN -> masked here
    model_vcd = jnp.where(jnp.isnan(vcd_corr) | jnp.isinf(vcd_corr), jnp.nan, model_vcd)
    return new_amf, vcd_corr, model_vcd


@partial(jax.jit, static_argnames=("has_trop",))
def amf_recal_noak_fields(ctm_pmid, ctm_pc, tropopause, vcd, has_trop: bool):
    """No-scattering-weights branch (reference amf_recal.py:160-171):
    tropopause-mask the partial columns, sum, NaN where the retrieval is NaN."""
    pc = ctm_pc
    if has_trop:
        pc = jnp.where(ctm_pmid < tropopause[None], jnp.nan, pc)
    model_vcd = _nansum0(pc)
    return jnp.where(jnp.isnan(vcd), jnp.nan, model_vcd)


@jax.jit
def ak_conv_mopitt_fields(ctm_pmid, ctm_profile, ctm_airpc, sat_pmid, aks, aprior_col, apriori_profile, apriori_surface, vcd):
    """MOPITT averaging-kernel convolution (reference ak_conv_mopitt.py:118-146).

    aks: (Ls+1, H, W) with the surface row first; sat_pmid/apriori_profile:
    (Ls, H, W).  Returns (model_vcd, model_xcol) NaN-masked like the
    reference.
    """
    (ctm_pmid, ctm_profile, ctm_airpc, sat_pmid, aks,
     apriori_profile) = _at_least_f32(ctm_pmid, ctm_profile, ctm_airpc,
                                      sat_pmid, aks, apriori_profile)
    prof_i = interp_linear_batched(jnp.log(ctm_pmid), ctm_profile, jnp.log(sat_pmid), extrapolate=False)
    dlog = jnp.log10(prof_i) - jnp.log10(apriori_profile)
    profile_component = aprior_col + _nansum0(aks[1:] * dlog)
    surface_component = aks[0] * (jnp.log10(ctm_profile[0]) - jnp.log10(apriori_surface))
    model_vcd = profile_component + surface_component
    model_xcol = 1e6 * model_vcd / _nansum0(ctm_airpc)  # ppmv
    bad = jnp.isnan(vcd) | jnp.isinf(vcd)
    model_vcd = jnp.where(bad, jnp.nan, model_vcd)
    model_xcol = jnp.where(jnp.isnan(vcd), jnp.nan, model_xcol)
    return model_vcd, model_xcol


@jax.jit
def ak_conv_gosat_fields(ctm_pmid, ctm_profile, sat_pmid, aks, apriori_profile, pressure_weight, x_col):
    """GOSAT XCH4 averaging-kernel convolution (reference ak_conv_gosat.py:118-141).

    Returns model_xcol [ppbv], NaN-masked by the retrieval x_col.
    """
    (ctm_pmid, ctm_profile, sat_pmid, aks, apriori_profile,
     pressure_weight) = _at_least_f32(ctm_pmid, ctm_profile, sat_pmid, aks,
                                      apriori_profile, pressure_weight)
    prof_i = interp_linear_batched(jnp.log(ctm_pmid), ctm_profile, jnp.log(sat_pmid), extrapolate=True)
    temp = apriori_profile + (prof_i - apriori_profile) * aks
    temp = temp * pressure_weight
    temp = jnp.where(temp <= 0, jnp.nan, temp)
    model_xcol = _nansum0(temp)
    bad = jnp.isinf(x_col) | jnp.isnan(x_col)
    return jnp.where(bad, jnp.nan, model_xcol)


@jax.jit
def pwv_fields(pc, vcd):
    """Precipitable water vapor [mm] (reference pwv_cal.py:64-98).

    ``pc`` is the water partial column ``dp * q / g / 1e4`` (possibly
    upscaled to the satellite grid); PWV = ``nansum(pc / 1e3)``, NaN-masked
    where the satellite vcd is NaN/inf.
    """
    (pc,) = _at_least_f32(pc)
    pwv = _nansum0(pc / 1000.0)
    return jnp.where(jnp.isnan(vcd) | jnp.isinf(vcd), jnp.nan, pwv)
