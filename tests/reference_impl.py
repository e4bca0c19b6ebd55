"""Independent NumPy golden implementations of the reference pipeline math.

Written from the algorithm definitions (formulas in SURVEY.md / the paper
trail), using plain float64 NumPy.  These are the truth the device ops are
compared against at tight tolerances; they intentionally mirror the
*semantics* (NaN handling, clamps, division-by-zero patterns) of
OI-SAT-GMI, not its code.
"""

from __future__ import annotations

import warnings

import numpy as np

from oisat.ops.knee import kneedle_index_np


def oi_numpy(xa, y, sa, so, regularization_on=True):
    """Scalar-gain OI update (reference optimal_interpolation.py:6-52)."""
    xa = np.asarray(xa, np.float64)
    y = np.array(y, np.float64, copy=True)
    sa = np.asarray(sa, np.float64)
    so = np.asarray(so, np.float64)
    y[y < 0] = 0.0
    regs = np.arange(0.1, 10.0, 0.1) if regularization_on else np.array([1.0])
    curve = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for r in regs:
            k = sa * r / (sa * r + so)
            sb = (1.0 - k) * sa * r
            ak = 1.0 - sb / (sa * r)
            curve.append(np.nanmean(ak.ravel()))
    curve = np.array(curve)
    idx = kneedle_index_np(regs, curve, fallback=0) if regularization_on else 0
    r = regs[idx]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        k = sa * r / (sa * r + so)
        sb = (1.0 - k) * sa * r
        ak = 1.0 - sb / (sa * r)
    inc = k * (y - xa)
    return xa + inc, ak, inc, np.sqrt(sb), idx, curve


def error_average_numpy(err2_stack):
    """sqrt( nansum(err^2) / N^2 ) per cell (reference averaging.py:11-24)."""
    e = np.array(err2_stack, np.float64, copy=True)
    e[np.isinf(e)] = np.nan
    valid = ~np.isnan(e)
    n = valid.sum(axis=0)
    s = np.where(valid, e, 0.0).sum(axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = np.where(n > 0, s / n.astype(np.float64) ** 2, np.nan)
    return np.sqrt(out)


def _interp1d(xp, fp, xq, extrapolate):
    from scipy import interpolate as _si

    if extrapolate:
        f = _si.interp1d(xp, fp, fill_value="extrapolate")
    else:
        f = _si.interp1d(xp, fp, fill_value=np.nan, bounds_error=False)
    return f(xq)


def amf_recal_pixelwise(sat_pmid, sat_sw, ctm_pmid, ctm_pc, tropopause, vcd, amf_old):
    """Per-pixel AMF recalculation loop (reference amf_recal.py:93-119, :173-183)."""
    H, W = vcd.shape
    new_amf = np.full((H, W), np.nan)
    model_vcd = np.full((H, W), np.nan)
    pc_work = np.array(ctm_pc, copy=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(H):
            for j in range(W):
                if np.isnan(vcd[i, j]):
                    continue
                pc = pc_work[:, i, j]
                pm = ctm_pmid[:, i, j]
                sw = _interp1d(np.log(sat_pmid[:, i, j]), sat_sw[:, i, j], np.log(pm), True)
                sw[np.isinf(sw)] = 0.0
                if tropopause is not None:
                    m = pm < tropopause[i, j]
                    sw[m] = np.nan
                    pc = np.where(m, np.nan, pc)
                scd = np.nansum(sw * pc)
                model_vcd[i, j] = np.nansum(pc)
                new_amf[i, j] = scd / model_vcd[i, j] if model_vcd[i, j] != 0 else np.nan
        new_amf[np.isnan(vcd)] = np.nan
        vcd_corr = amf_old * vcd / new_amf
        model_vcd[np.isnan(vcd_corr)] = np.nan
        model_vcd[np.isinf(vcd_corr)] = np.nan
    return new_amf, vcd_corr, model_vcd


def ak_conv_mopitt_pixelwise(ctm_pmid, ctm_profile, ctm_airpc, sat_pmid, aks,
                             aprior_col, apriori_profile, apriori_surface, vcd):
    """Per-pixel MOPITT AK convolution (reference ak_conv_mopitt.py:118-146)."""
    H, W = vcd.shape
    model_vcd = np.full((H, W), np.nan)
    model_xcol = np.full((H, W), np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(H):
            for j in range(W):
                if np.isnan(vcd[i, j]):
                    continue
                prof_i = _interp1d(np.log(ctm_pmid[:, i, j]), ctm_profile[:, i, j],
                                   np.log(sat_pmid[:, i, j]), False)
                pcomp = aprior_col[i, j] + np.nansum(
                    aks[1:, i, j] * (np.log10(prof_i) - np.log10(apriori_profile[:, i, j])))
                scomp = aks[0, i, j] * (np.log10(ctm_profile[0, i, j]) - np.log10(apriori_surface[i, j]))
                model_vcd[i, j] = pcomp + scomp
                model_xcol[i, j] = 1e6 * model_vcd[i, j] / np.nansum(ctm_airpc[:, i, j])
        model_vcd[np.isnan(vcd)] = np.nan
        model_vcd[np.isinf(vcd)] = np.nan
    return model_vcd, model_xcol


def ak_conv_gosat_pixelwise(ctm_pmid, ctm_profile, sat_pmid, aks, apriori_profile,
                            pressure_weight, x_col):
    """Per-pixel GOSAT AK convolution (reference ak_conv_gosat.py:118-141)."""
    H, W = x_col.shape
    model_xcol = np.full((H, W), np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(H):
            for j in range(W):
                if np.isnan(x_col[i, j]):
                    continue
                prof_i = _interp1d(np.log(ctm_pmid[:, i, j]), ctm_profile[:, i, j],
                                   np.log(sat_pmid[:, i, j]), True)
                tmp = apriori_profile[:, i, j] + (prof_i - apriori_profile[:, i, j]) * aks[:, i, j]
                tmp = tmp * pressure_weight[:, i, j]
                tmp[tmp <= 0] = np.nan
                model_xcol[i, j] = np.nansum(tmp)
        model_xcol[np.isinf(x_col)] = np.nan
        model_xcol[np.isnan(x_col)] = np.nan
    return model_xcol


def upscaler_scipy(X, Y, Z, ctm_lon, ctm_lat, grid_size, threshold, error=False):
    """Reference _upscaler (interpolator.py:48-97) composed from scipy."""
    from scipy.signal import convolve2d
    from scipy.spatial import cKDTree

    dlon = abs(ctm_lon[0, 0] - ctm_lon[0, 1])
    dlat = abs(ctm_lat[0, 0] - ctm_lat[1, 0])
    if not (dlon >= grid_size or dlat >= grid_size):
        return X, Y, Z, True
    kx = max(int(np.floor(dlon / grid_size)), 1)
    ky = max(int(np.floor(dlat / grid_size)), 1)
    denom = (ky * kx) ** 2 if error else ky * kx
    Zf = convolve2d(Z, np.ones((ky, kx)) / denom, boundary="symm", mode="same")
    pts = np.column_stack([X.ravel(), Y.ravel()])
    tree = cKDTree(pts)
    dists, idx = tree.query(np.column_stack([ctm_lon.ravel(), ctm_lat.ravel()]))
    out = Zf.ravel()[idx].reshape(ctm_lon.shape).astype(np.float64).copy()
    out[dists.reshape(ctm_lon.shape) > 2 * threshold] = np.nan
    return ctm_lon, ctm_lat, out, False


def interpolator_amf_scipy(interp_type, grid_size, sat, ctm_lon, ctm_lat, flag_thresh):
    """Reference interpolator() for satellite_amf granules (interpolator.py:100-291),
    composed directly from scipy primitives in float64."""
    from scipy.interpolate import LinearNDInterpolator, NearestNDInterpolator
    from scipy.spatial import Delaunay, cKDTree

    threshold_ctm = np.hypot(abs(ctm_lon[0, 0] - ctm_lon[0, 1]),
                             abs(ctm_lat[0, 0] - ctm_lat[1, 0]))
    mask = (np.asarray(sat.quality_flag) > flag_thresh) * 1.0
    mask[mask != 1.0] = np.nan
    lon_g = np.arange(ctm_lon.min(), ctm_lon.max() + grid_size, grid_size)
    lat_g = np.arange(ctm_lat.min(), ctm_lat.max() + grid_size, grid_size)
    lons, lats = np.meshgrid(lon_g, lat_g)
    pts = np.column_stack([np.asarray(sat.longitude_center, np.float64).ravel(),
                           np.asarray(sat.latitude_center, np.float64).ravel()])
    tree = cKDTree(pts)
    dists, _ = tree.query(np.column_stack([lons.ravel(), lats.ravel()]))
    dists = dists.reshape(lons.shape)
    tri = Delaunay(pts) if interp_type < 3 else None

    def interp(Z):
        Zr = np.asarray(Z, np.float64).ravel()
        if interp_type == 1:
            out = LinearNDInterpolator(tri, Zr, fill_value=np.nan)((lons, lats))
        elif interp_type == 2:
            out = NearestNDInterpolator(pts, Zr)((lons, lats))
        elif interp_type == 4:
            _, idx = tree.query(np.column_stack([lons.ravel(), lats.ravel()]))
            out = Zr[idx].reshape(lons.shape)
        out = np.asarray(out, np.float64)
        out[dists > 2 * grid_size] = np.nan
        return out

    def up(Z, error=False):
        return upscaler_scipy(lons, lats, Z, ctm_lon, ctm_lat, grid_size,
                              threshold_ctm, error=error)

    _, _, vcd, upneeded = up(interp(sat.vcd * mask))
    if np.isnan(np.nanmean(vcd)):
        return None
    _, _, amf, _ = up(interp(sat.amf * mask))
    if np.size(sat.tropopause) != 1:
        _, _, trop, _ = up(interp(sat.tropopause * mask))
    else:
        trop = np.empty((1,))
    _, _, unc, _ = up(interp(np.asarray(sat.uncertainty, np.float64) ** 2 * mask), error=True)
    unc = np.sqrt(unc)
    if np.size(sat.scattering_weights) != 1:
        nz = np.asarray(sat.pressure_mid).shape[0]
        sws = np.stack([up(interp(sat.scattering_weights[z] * mask))[2] for z in range(nz)])
        pmid = np.stack([up(interp(sat.pressure_mid[z] * mask))[2] for z in range(nz)])
    else:
        sws = np.empty((1,))
        pmid = None
    return dict(vcd=vcd, amf=amf, tropopause=trop, uncertainty=unc,
                scattering_weights=sws, pressure_mid=pmid, upneeded=upneeded)
