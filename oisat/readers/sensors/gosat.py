"""GOSAT XCH4 reader + point-to-map filler (reference
oisatgmi/filler_gosat.py:87-201, reader.py:1216-1275, fleet :1434-1448)."""

from __future__ import annotations

import datetime
import glob

import numpy as np

from oisat.datamodel import satellite_opt
from oisat.ops.regrid import apply_plan
from oisat.ops.weights import build_plan
from oisat.readers.ncio import read_nc
from oisat.readers.registry import SENSORS
from oisat.readers.sensors.common import epoch_time, fleet_map
from oisat.regridder import regrid_granule

EPOCH_1970 = datetime.datetime(1970, 1, 1)


def filler_gosatxch4(grid_size: float, sat_data: satellite_opt, flag_thresh=0.75):
    """Grid sparse GOSAT soundings into global maps (reference
    filler_gosat.py:87-201): Delaunay-linear interpolation of every field
    onto an ``arange(-180..180) x arange(-90..90)`` grid with a 1x distance
    cutoff — the filler carries its OWN ``_interpolosis`` masking at
    ``dists > threshold`` (filler_gosat.py:17), unlike the main
    interpolator's 2x (interpolator.py:16); quality flag gridded by
    nearest-neighbour; errors through the variance path.  (The reference's upscale calls there are no-ops because
    its fake 0.1-deg "CTM" is finer than the 1-deg map.)

    Deviation: float64 grid coordinates instead of the reference's float16
    cast (filler_gosat.py:121-127).
    """
    mask = (np.asarray(sat_data.quality_flag) > flag_thresh) * 1.0
    mask[mask != 1.0] = np.nan
    lon_grid = np.arange(-180.0, 180.0 + grid_size, grid_size)
    lat_grid = np.arange(-90.0, 90.0 + grid_size, grid_size)
    lons, lats = np.meshgrid(lon_grid, lat_grid)
    lin = build_plan(sat_data.longitude_center, sat_data.latitude_center,
                     lons, lats, method=1, threshold=grid_size, far_factor=1.0)
    if lin is None:
        return None
    near = build_plan(sat_data.longitude_center, sat_data.latitude_center,
                      lons, lats, method=2, threshold=grid_size, far_factor=1.0)

    def lin_apply(z):
        return np.asarray(apply_plan(lin, np.asarray(z, np.float64)))

    xch4 = lin_apply(np.asarray(sat_data.x_col) * mask)
    quality_flag = np.asarray(apply_plan(near, mask))
    uncertainty = np.sqrt(lin_apply(np.asarray(sat_data.uncertainty) ** 2 * mask))

    def lv(arr):
        # read_ak=False granules carry size-1 placeholders; gridding them
        # would broadcast uninitialized np.empty garbage into full maps —
        # keep the sentinel so downstream size==1 checks still fire
        if np.size(arr) == 1:
            return np.empty((1,))
        return lin_apply(np.asarray(arr) * mask[None])

    aks = lv(sat_data.averaging_kernels)
    pmid = lv(sat_data.pressure_mid)
    apriori = lv(sat_data.apriori_profile)
    pw = lv(sat_data.pressure_weight)
    return satellite_opt(
        vcd=xch4, time=sat_data.time, profile=[], tropopause=np.empty((1,)),
        latitude_center=lats, longitude_center=lons,
        latitude_corner=[], longitude_corner=[], uncertainty=uncertainty,
        quality_flag=quality_flag, pressure_mid=pmid, averaging_kernels=aks,
        aprior_column=np.zeros((1,)), apriori_profile=apriori,
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)),
        x_col=xch4, pressure_weight=pw, sensor="GOSAT")


def gosat_reader_xch4(fname, ctm_lon=None, ctm_lat=None, read_ak=True):
    """GOSAT L2 XCH4 soundings (reference reader.py:1216-1275): point data,
    gridded by the filler, then the standard regrid."""
    print("Currently reading: " + fname.split("/")[-1])
    time = epoch_time(EPOCH_1970, np.nanmean(read_nc(fname, "time")))
    lat = read_nc(fname, "latitude").astype("float32")
    lon = read_nc(fname, "longitude").astype("float32")
    xch4 = np.array(read_nc(fname, "xch4"), np.float64)
    xch4[(xch4 <= 0) | np.isinf(xch4)] = np.nan
    apriori_profile = np.array(read_nc(fname, "ch4_profile_apriori"), np.float64).transpose()
    apriori_profile[apriori_profile <= 0] = np.nan
    quality_flag = read_nc(fname, "xch4_quality_flag")
    uncertainty = read_nc(fname, "xch4_uncertainty")
    p_mid = np.array(read_nc(fname, "pressure_levels"), np.float64)
    p_mid[p_mid <= 0] = np.nan
    if read_ak:
        aks = np.array(read_nc(fname, "xch4_averaging_kernel"), np.float64).transpose()
        pw = np.array(read_nc(fname, "pressure_weight"), np.float64).transpose()
        aks[aks <= 0] = np.nan
        pw[pw <= 0] = np.nan
    else:
        aks = np.empty((1,))
        pw = np.empty((1,))
    g = satellite_opt(
        vcd=xch4, time=time, profile=[], tropopause=np.empty((1,)),
        latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[], uncertainty=uncertainty,
        quality_flag=1 - np.asarray(quality_flag),  # 0 = good -> 1 (reader.py:1266)
        pressure_mid=p_mid.transpose(), averaging_kernels=aks,
        aprior_column=np.zeros((1,)), apriori_profile=apriori_profile,
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)),
        x_col=xch4, pressure_weight=pw, sensor="GOSAT")
    g = filler_gosatxch4(1.0, g, flag_thresh=0.0)
    if g is not None and ctm_lon is not None:
        print("Currently interpolating ...")
        spec = SENSORS["GOSAT_XCH4"]
        g = regrid_granule(spec.interpolator_type, spec.grid_size, g, ctm_lon, ctm_lat,
                           flag_thresh=spec.flag_thresh)
    return g


def gosat_reader(product_dir, ctm_lon, ctm_lat, YYYYMM, read_ak=True, num_job=1):
    """GOSAT fleet reader: year-subdirectory layout (reference reader.py:1434-1448)."""
    files = sorted(glob.glob(product_dir + "/" + YYYYMM[0:4] + "/*"
                             + YYYYMM[0:4] + YYYYMM[4:] + "*.nc"))
    return fleet_map(lambda f: gosat_reader_xch4(f, ctm_lon, ctm_lat, read_ak),
                     files, num_job, "GOSAT_XCH4")
