"""Shared helpers for the per-sensor readers."""

from __future__ import annotations

import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["scrub_sws", "fleet_map", "pmid_from_eta_edges", "epoch_time",
           "eta_mid_tables", "attach_pmid_tables",
           "GEOS5_ETA_A48", "GEOS5_ETA_B48"]


def scrub_sws(sws: np.ndarray) -> np.ndarray:
    """Zero out bad scattering weights (reference reader.py:516-518 etc.):
    NaN/inf/<0/>100 -> 0."""
    if np.size(sws) == 1:
        return sws
    bad = np.isnan(sws) | np.isinf(sws) | (sws > 100.0) | (sws < 0.0)
    sws = np.array(sws, copy=True)
    sws[bad] = 0.0
    return sws


def epoch_time(epoch, seconds) -> "datetime.datetime":
    import datetime

    return epoch + datetime.timedelta(seconds=int(seconds))


def pmid_from_eta_edges(eta_a, eta_b, ps):
    """Mid-level pressures from hybrid-eta edge coefficients:
    p_mid[z] = 0.5*((a[z] + b[z]*ps) + (a[z+1] + b[z+1]*ps))."""
    eta_a = np.asarray(eta_a, np.float64)[:, None, None]
    eta_b = np.asarray(eta_b, np.float64)[:, None, None]
    ps = np.asarray(ps, np.float64)[None]
    edges = eta_a + eta_b * ps  # (L+1, H, W)
    return (0.5 * (edges[:-1] + edges[1:])).astype("float32")


def eta_mid_tables(eta_a, eta_b):
    """The mid-level (a, b) coefficient tables matching
    :func:`pmid_from_eta_edges`: ``p_mid[z] == a_mid[z] + b_mid[z]*ps``."""
    a = np.asarray(eta_a, np.float64)
    b = np.asarray(eta_b, np.float64)
    return 0.5 * (a[:-1] + a[1:]), 0.5 * (b[:-1] + b[1:])


def attach_pmid_tables(granule, a_mid, b_mid):
    """Provenance tag: this granule's ``pressure_mid`` was CONSTRUCTED as
    ``a_mid + b_mid * <2-D field>`` (hybrid-eta mids, or a fixed 1-D
    pressure table with ``b_mid == 0``).  The regridder then derives its
    affine carrier tables directly from these coefficients instead of
    re-fitting them from the pixel data every orbit (a host scan of the
    whole pressure stack); a strided residual spot-check still guards
    against post-construction edits (regridder._affine_from_tables).
    Contract for callers: do NOT mutate pressure_mid after attaching."""
    granule._pmid_eta = (np.asarray(a_mid, np.float64).ravel(),
                         np.asarray(b_mid, np.float64).ravel())
    return granule


def fleet_map(reader, files, num_job, label):
    """Per-granule fault-tolerant fan-out (the reference's joblib role,
    reader.py:1327-1463): any failing file becomes None and the month
    continues.

    Pipelining (the transfer-bound case): a single-threaded submit/collect
    double-buffer.  The reader runs under
    :class:`~oisat.regridder.lazy_collection`, so its regrid returns a
    :class:`~oisat.regridder.PendingGranule` with the device program
    already dispatched; granule k is resolved only AFTER granule k+1's
    file read + host weight build + H2D dispatch — the device computes k
    while the host builds k+1.  (On one core a 2-thread pool contends for
    the GIL instead of overlapping — bench.py
    regrid_orbit_fast_pipelined.)  The thread pool is used only when the
    host actually has cores for it (``num_job > 1`` AND
    ``os.cpu_count() > 2``) — production control files ship ``num_job:
    24-36`` for the reference's multi-core nodes, and a 1-core host must
    still take the pipeline, not a GIL-contended pool."""
    import os

    def safe(f):
        try:
            return reader(f)
        except Exception:
            print(f"[{label}] failed on {f}:")
            traceback.print_exc()
            return None

    def resolve(p):
        if not hasattr(p, "resolve"):
            return p
        try:
            return p.resolve()
        except Exception:
            print(f"[{label}] failed resolving a pending granule:")
            traceback.print_exc()
            return None

    if num_job <= 1 or (os.cpu_count() or 1) <= 2 or len(files) <= 1:
        from oisat.regridder import lazy_collection

        results = []
        pending_idx = None
        for f in files:
            with lazy_collection():
                cur = safe(f)
            if pending_idx is not None:
                results[pending_idx] = resolve(results[pending_idx])
                pending_idx = None
            results.append(cur)
            if hasattr(cur, "resolve"):
                pending_idx = len(results) - 1
        if pending_idx is not None:
            results[pending_idx] = resolve(results[pending_idx])
        return results
    with ThreadPoolExecutor(max_workers=num_job) as ex:
        # readers normally collect inline here (no lazy context), but a
        # PendingGranule from a nested context must never escape the map
        return [resolve(r) for r in ex.map(safe, files)]


# GEOS-5 47-layer hybrid-eta edge coefficients (hPa / unitless), the
# hard-coded tables the reference embeds in its OMI-HCHO and OMPS readers
# (reference reader.py:954-957, :1091-1100).  Physical constants, kept as
# data here.
GEOS5_ETA_A48 = np.array([
    0., 0.04804826, 6.593752, 13.1348, 19.61311, 26.09201, 32.57081, 38.98201,
    45.33901, 51.69611, 58.05321, 64.36264, 70.62198, 78.83422, 89.09992,
    99.36521, 109.1817, 118.9586, 128.6959, 142.91, 156.26, 169.609, 181.619,
    193.097, 203.259, 212.15, 218.776, 223.898, 224.363, 216.865, 201.192,
    176.93, 150.393, 127.837, 108.663, 92.36572, 78.51231, 56.38791, 40.17541,
    28.36781, 19.7916, 9.292942, 4.076571, 1.65079, 0.6167791, 0.211349,
    0.06600001, 0.01])
GEOS5_ETA_B48 = np.array([
    1., 0.984952, 0.963406, 0.941865, 0.920387, 0.898908, 0.877429, 0.856018,
    0.8346609, 0.8133039, 0.7919469, 0.7706375, 0.7493782, 0.721166,
    0.6858999, 0.6506349, 0.6158184, 0.5810415, 0.5463042, 0.4945902,
    0.4437402, 0.3928911, 0.3433811, 0.2944031, 0.2467411, 0.2003501,
    0.1562241, 0.1136021, 0.06372006, 0.02801004, 0.006960025, 8.175413e-09,
    0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0., 0.])
