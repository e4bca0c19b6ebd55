"""Temporal (monthly) averaging of granule stacks — device reductions.

Replaces the reference's ``averaging`` (reference oisatgmi/averaging.py:26-120)
and its per-cell triple-loop ``error_averager`` (:11-24) with masked
reductions over a stacked ``(G, H, W)`` granule axis:

  * vcd:    inf→NaN scrub then nanmean          (reference :97-99)
  * error:  sqrt( nansum(err²) / N² )           (reference :11-24; N = count
            of finite err² per cell; empty cell -> NaN)
  * ctm/aux fields: plain nanmean               (reference :101-108)

Deliberate deviation (documented): the reference's store-into-output block
sits at the *year* level of its bucket loop (averaging.py:97-108), which
silently drops all but the last month when a multi-month range is requested
— harmless there because production jobs are single-month.  We bucket
per-month correctly; single-month results are identical.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from oisat.datamodel import satellite_amf, satellite_opt

__all__ = ["MonthlyAverage", "monthly_stats", "monthly_stats_weighted",
           "averaging"]


class MonthlyAverage(NamedTuple):
    sat_vcd: jax.Array
    sat_error: jax.Array
    ctm_vcd: jax.Array
    aux1: jax.Array
    aux2: jax.Array


def _nanmean0(x):
    valid = ~jnp.isnan(x)
    c = jnp.sum(valid, axis=0)
    s = jnp.sum(jnp.where(valid, x, 0.0), axis=0)
    return jnp.where(c > 0, s / c, jnp.nan)


@jax.jit
def monthly_stats(vcd, err, ctm, aux1, aux2) -> MonthlyAverage:
    """All inputs (G, H, W); returns per-cell monthly statistics."""
    vcd = jnp.where(jnp.isinf(vcd), jnp.nan, vcd)
    err2 = jnp.where(jnp.isinf(err**2), jnp.nan, err**2)
    valid = ~jnp.isnan(err2)
    n = jnp.sum(valid, axis=0)
    s = jnp.sum(jnp.where(valid, err2, 0.0), axis=0)
    sat_error = jnp.sqrt(jnp.where(n > 0, s / (n * n), jnp.nan))
    return MonthlyAverage(
        sat_vcd=_nanmean0(vcd),
        sat_error=sat_error,
        ctm_vcd=_nanmean0(ctm),
        aux1=_nanmean0(aux1),
        aux2=_nanmean0(aux2),
    )


@jax.jit
def monthly_stats_weighted(vcd, err, ctm, aux1, aux2, w) -> MonthlyAverage:
    """Weighted temporal statistics (capability extension; CLAUDE.md
    round-2 priority 5).  ``w`` (G, H, W) >= 0: per-granule per-cell
    weights.  Means are weighted; the error combines as the standard
    error of a weighted mean of independent errors,
    ``sqrt(sum(w^2 sigma^2)) / sum(w)`` — which reduces to the reference's
    ``sqrt(sum(sigma^2)/N^2)`` at uniform weights and to the optimal
    ``sqrt(1/sum(1/sigma^2))`` at inverse-variance weights."""
    vcd = jnp.where(jnp.isinf(vcd), jnp.nan, vcd)
    err2 = jnp.where(jnp.isinf(err**2), jnp.nan, err**2)
    w = jnp.where(jnp.isfinite(w) & (w > 0), w, jnp.nan)

    def wmean(x):
        m = ~(jnp.isnan(x) | jnp.isnan(w))
        sw = jnp.sum(jnp.where(m, w, 0.0), axis=0)
        sx = jnp.sum(jnp.where(m, w * x, 0.0), axis=0)
        return jnp.where(sw > 0, sx / sw, jnp.nan)

    m = ~(jnp.isnan(err2) | jnp.isnan(w))
    sw = jnp.sum(jnp.where(m, w, 0.0), axis=0)
    sw2e = jnp.sum(jnp.where(m, w * w * err2, 0.0), axis=0)
    sat_error = jnp.where(sw > 0, jnp.sqrt(sw2e) / sw, jnp.nan)
    return MonthlyAverage(sat_vcd=wmean(vcd), sat_error=sat_error,
                          ctm_vcd=wmean(ctm), aux1=wmean(aux1),
                          aux2=wmean(aux2))


def _granule_weights(sel, weighting: str, err=None):
    """Per-granule per-cell weights for the weighted temporal mean.

    "inverse_variance": w = 1/sigma^2 (any granule kind).
    "ak": information-content weights — the vertical mean of |averaging
    kernel| per cell; optimal-estimation granules only (satellite_opt
    carries gridded AKs; reference config.py:27-50).
    """
    if weighting == "inverse_variance":
        stack = (err if err is not None else
                 np.stack([np.asarray(g.uncertainty, np.float64) for g in sel]))
        err2 = stack**2
        # sigma <= 0 means the retrieval error is unavailable (L2 fill
        # values): such cells CANNOT be inverse-variance weighted, so they
        # are deliberately excluded from the weighted mean (NaN weight).
        # The default unweighted mode still includes them, as the
        # reference does.
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(err2 > 0, 1.0 / err2, np.nan)
    if weighting == "ak":
        if not all(isinstance(g, satellite_opt) for g in sel):
            raise ValueError("weighting='ak' needs averaging-kernel granules "
                             "(MOPITT/GOSAT); use 'inverse_variance' otherwise")
        with np.errstate(invalid="ignore"):
            return np.stack([
                np.nanmean(np.abs(np.asarray(g.averaging_kernels, np.float64)),
                           axis=0) for g in sel])
    raise ValueError(f"unknown weighting {weighting!r}")


def averaging(startdate: str, enddate: str, reader_obj, weighting=None):
    """Monthly averaging driver (reference averaging.py:26-120).

    Buckets granules by (year, month) of ``granule.time`` within
    ``[startdate, enddate)``, stacks their fields, and reduces on device.
    Returns ``(sat_vcd, sat_error, ctm_vcd, aux1, aux2, avg_datetime)``
    squeezed exactly like the reference (single-month -> 2-D fields).

    aux1/aux2 are (new_amf, old_amf) for two-step granules and
    (x_col, ctm_xcol) for optimal-estimation granules (reference :82-87);
    otherwise NaN fields.

    ``weighting`` (extension; default None = reference parity):
    "inverse_variance" or "ak" select :func:`monthly_stats_weighted`.
    """
    start = datetime.date(int(startdate[0:4]), int(startdate[5:7]), int(startdate[8:10]))
    end = datetime.date(int(enddate[0:4]), int(enddate[5:7]), int(enddate[8:10]))
    days = [start + datetime.timedelta(n) for n in range((end - start).days)]
    months = np.array([d.month for d in days])
    years = np.array([d.year for d in days])

    granules = [g for g in reader_obj.sat_data if g is not None]
    if not granules:
        raise ValueError("no valid satellite granules to average")
    hw = np.shape(granules[0].latitude_center)

    m0, m1 = months.min(), months.max()
    y0, y1 = years.min(), years.max()
    nm, ny = m1 - m0 + 1, y1 - y0 + 1
    # reference init: vcd zeros, the rest NaN (averaging.py:52-63)
    out_vcd = np.zeros(hw + (nm, ny))
    out_err = np.full(hw + (nm, ny), np.nan)
    out_ctm = np.full(hw + (nm, ny), np.nan)
    out_a1 = np.full(hw + (nm, ny), np.nan)
    out_a2 = np.full(hw + (nm, ny), np.nan)

    time_chosen = []
    for year in range(y0, y1 + 1):
        for month in range(m0, m1 + 1):
            sel = [g for g in granules if g.time.year == year and g.time.month == month]
            if not sel:
                continue
            # accumulate across EVERY bucket: the returned avg_datetime
            # must represent all granules averaged into the fields, not
            # just the last non-empty month
            time_chosen.extend(g.time for g in sel)

            def f(name):
                return np.stack([np.asarray(getattr(g, name), np.float64) for g in sel])

            vcd, err, ctm = f("vcd"), f("uncertainty"), f("ctm_vcd")
            # > 1, not != 1: a granule that never went through recal_amf
            # carries the [] placeholder (size 0), not a real AMF field
            if isinstance(sel[0], satellite_amf) and np.size(sel[0].new_amf) > 1:
                a1, a2 = f("new_amf"), f("old_amf")
            elif isinstance(sel[0], satellite_opt):
                a1, a2 = f("x_col"), f("ctm_xcol")
            else:
                a1 = np.full_like(vcd, np.nan)
                a2 = np.full_like(vcd, np.nan)
            if weighting is not None:
                w = _granule_weights(sel, weighting, err=err)
            # pad the granule axis to a bucket: each distinct G would
            # otherwise compile its own program — NaN granules are
            # invisible to every masked statistic here.  min_size MUST be
            # granule-scale, not the pixel-axis default: the 1024 default
            # padded a 60-granule month to 1024 stacks — ~17x the H2D
            # bytes of the staged averaging leg, all NaN.  Half-octave
            # steps (16, 23, 32, 46, 64, 91, 128 …), not quarter: typical
            # 40-70-granule months then share one or two buckets per
            # campaign, trading ≤40% padding for at most one extra
            # compile — the fixed-1024 bucket's "one compile ever" came at
            # ~17x the month's bytes of pure NaN transfer
            from oisat.ops.regrid import pad_to_bucket

            gp = pad_to_bucket(vcd.shape[0], min_size=16, steps_per_octave=2)
            if gp != vcd.shape[0]:
                npad = gp - vcd.shape[0]

                def p(x):
                    pads = ((0, npad),) + ((0, 0),) * (x.ndim - 1)
                    return np.pad(x, pads, constant_values=np.nan)

                vcd, err, ctm, a1, a2 = p(vcd), p(err), p(ctm), p(a1), p(a2)
                if weighting is not None:
                    w = p(w)
            if weighting is None:
                stats = monthly_stats(*(jnp.asarray(x) for x in (vcd, err, ctm, a1, a2)))
            else:
                stats = monthly_stats_weighted(
                    *(jnp.asarray(x) for x in (vcd, err, ctm, a1, a2, w)))
            mi, yi = month - m0, year - y0
            out_vcd[:, :, mi, yi] = np.asarray(stats.sat_vcd)
            out_err[:, :, mi, yi] = np.asarray(stats.sat_error)
            out_ctm[:, :, mi, yi] = np.asarray(stats.ctm_vcd)
            out_a1[:, :, mi, yi] = np.asarray(stats.aux1)
            out_a2[:, :, mi, yi] = np.asarray(stats.aux2)

    if not time_chosen:
        raise ValueError("no granules fall inside the averaging window")
    avg_ts = sum(t.timestamp() for t in time_chosen) / len(time_chosen)
    avg_datetime = datetime.datetime.fromtimestamp(avg_ts)
    return (out_vcd.squeeze(), out_err.squeeze(), out_ctm.squeeze(),
            out_a1.squeeze(), out_a2.squeeze(), avg_datetime)
