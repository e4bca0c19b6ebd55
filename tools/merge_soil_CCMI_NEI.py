"""Merge CCMI / NEI-2016 / soil-NOx emissions with diurnal scaling.

Equivalent of reference tools/merge_soil_CCMI_NEI.py:90-256: for each day
and each GMI emission species, combine the global CCMI monthly inventory
(ff/bf/ship channels), the NEI-2016 regional inventory mapped onto the
0.1-deg CCMI grid (NEI wins inside its domain), hourly soil NOx (NO only),
and the CMAQ-derived weekday/weekend diurnal profiles; write one 24-hour
file per species per day.  Site paths are a config dict/args instead of
hard-coded Discover paths.

Usage:
  python merge_soil_CCMI_NEI.py --ccmi DIR --ccmi-os DIR --soil DIR \
      --nei DIR --scales DIR --start 2023-01-01 --end 2023-02-01 [--out DIR]
"""

import argparse
import datetime
import os
import sys
import time as _time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
from scipy.interpolate import NearestNDInterpolator
from scipy.io import loadmat

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from oisat.ncwriter import write_nc  # noqa: E402
from oisat.readers.ncio import read_nc  # noqa: E402

# GMI species and the matching NEI-2016 species (reference :239-243)
EMISSION_NAMES_GMI = ["ALD2", "ALK4", "C2H6", "PRPE", "C3H8", "CH2O", "MEK", "CO", "NO"]
CORRS_NEI_EMIS = ["ALD2", "PAR", "ETHA", "IOLE", "PRPA", "FORM", "KET", "CO", "NO"]


def _nearest_map(src_lon2d, src_lat2d, values, tgt_lon2d, tgt_lat2d):
    pts = np.column_stack([src_lon2d.ravel(), src_lat2d.ravel()])
    interp = NearestNDInterpolator(pts, np.asarray(values).ravel())
    return interp((tgt_lon2d, tgt_lat2d))


def _inside(src_lon2d, src_lat2d, tgt_lon2d, tgt_lat2d):
    return ((tgt_lat2d >= src_lat2d.min()) & (tgt_lat2d <= src_lat2d.max())
            & (tgt_lon2d >= src_lon2d.min()) & (tgt_lon2d <= src_lon2d.max()))


def merger(paths, emis, nei_species, date_i, out_dir="."):
    """One (species, day) merge (reference :91-236)."""
    if emis == "NO":
        ccmi_file = os.path.join(paths["ccmi_os"], f"CCMI_emis01_OS_{emis}_{date_i.year}_t12.nc4")
        ship = read_nc(os.path.join(paths["ccmi"], f"CCMI_emis01_{emis}_shp_{date_i.year}_t12.nc4"),
                       f"{emis}_shp")[date_i.month - 1]
    else:
        ccmi_file = os.path.join(paths["ccmi"], f"CCMI_emis01_{emis}_{date_i.year}_t12.nc4")
        ship = None
    print(f"Reading the {emis} from: " + ccmi_file)
    lat1 = read_nc(ccmi_file, "lat")
    lon1 = read_nc(ccmi_file, "lon")
    lon_org, lat_org = np.meshgrid(lon1, lat1)
    shape = lat_org.shape

    def channel(name):
        try:
            return read_nc(ccmi_file, name)[date_i.month - 1], True
        except KeyError:
            print(f"there is no {name.split('_')[-1]} in this file, zeroing")
            return np.zeros(shape), False

    emis_ff, ff_exists = channel(f"{emis}_ff")
    emis_bf, bf_exists = channel(f"{emis}_bf")
    if ship is None:
        ship = np.zeros(shape)

    # hourly soil NOx mapped 0.25 -> 0.1 deg (NO only; reference :129-147)
    soil01 = np.zeros((24,) + shape)
    if emis == "NO":
        sfile = os.path.join(paths["soil"], f"soilnox_{date_i.year}", f"{date_i.month:02d}",
                             f"soilnox_025.{date_i.year}{date_i.month:02d}{date_i.day:02d}.nc")
        print("Reading the soil file from " + sfile)
        slon, slat = np.meshgrid(read_nc(sfile, "lon"), read_nc(sfile, "lat"))
        soil = read_nc(sfile, "SOIL_NOx")
        for hour in range(24):
            soil01[hour] = _nearest_map(slon, slat, soil[hour], lon_org, lat_org)

    # NEI-2016 regional inventory (reference :149-179)
    nei_file = os.path.join(paths["nei"], f"2016fh_16j_merge_0pt1degree_month_{date_i.month:02d}.ncf")
    print("Reading NEI file from " + nei_file)
    if nei_species == "NO":
        nei = read_nc(nei_file, "NO") * (30.0 / 46.0) + read_nc(nei_file, "NO2")
    else:
        nei = read_nc(nei_file, nei_species)
    nlon, nlat = np.meshgrid(read_nc(nei_file, "lon"), read_nc(nei_file, "lat"))
    nei_mapped = _nearest_map(nlon, nlat, nei, lon_org, lat_org)
    inside_nei = _inside(nlon, nlat, lon_org, lat_org)
    nei_mapped = np.where(inside_nei, nei_mapped, 0.0)
    emis_ff_m = np.where(~inside_nei, emis_ff, 0.0)
    emis_bf_m = np.where(~inside_nei, emis_bf, 0.0)
    ship_m = np.where(~inside_nei, ship, 0.0) if emis == "NO" else np.zeros(shape)

    # diurnal profiles (weekday/weekend .mat on the CMAQ grid; reference :186-213)
    scales = loadmat(os.path.join(paths["scales"], f"Scales_2016{date_i.month:02d}.mat"))
    key = f"{nei_species}_weekend" if date_i.weekday() >= 5 else f"{nei_species}_weekday"
    diurnal = scales[key]
    grd = os.path.join(paths["scales"], "GRIDCRO2D_20190201.nc4")
    glon = read_nc(grd, "LON")
    glat = read_nc(grd, "LAT")
    inside_sc = _inside(glon, glat, lon_org, lat_org)

    out_ff = np.zeros((24,) + shape)
    out_bf = np.zeros((24,) + shape)
    for hour in range(24):
        d = _nearest_map(glon, glat, diurnal[hour], lon_org, lat_org)
        d = np.where(inside_sc, d, 1.0)
        if ff_exists:
            out_ff[hour] = d * nei_mapped + soil01[hour] + emis_ff_m + ship_m
        if bf_exists:
            out_bf[hour] = emis_bf_m if ff_exists else d * nei_mapped + emis_bf_m
    # backfill zeros with the raw global channels (reference :215-221)
    m = out_ff == 0
    out_ff[m] = np.broadcast_to(emis_ff, out_ff.shape)[m]
    m = out_ff == 0
    out_ff[m] = np.broadcast_to(ship, out_ff.shape)[m]
    m = out_bf == 0
    out_bf[m] = np.broadcast_to(emis_bf, out_bf.shape)[m]

    path = os.path.join(out_dir,
                        f"CCMI_SOIL_NEI2016_{emis}_{date_i.year}{date_i.month:02d}{date_i.day:02d}.nc")
    write_nc(
        path,
        dims={"time": np.arange(24.0), "lat": np.asarray(lat1), "lon": np.asarray(lon1)},
        variables={
            "time": (("time",), None, {"units": "hours since "
                                       + datetime.datetime(date_i.year, date_i.month, date_i.day).strftime("%Y-%m-%d %H:%M:%S")}),
            "lat": (("lat",), None, {"units": "degrees_north"}),
            "lon": (("lon",), None, {"units": "degrees_east"}),
            f"{emis}_ff": (("time", "lat", "lon"), out_ff, {"units": "kg m^-2 s^-1"}),
            f"{emis}_bf": (("time", "lat", "lon"), out_bf, {"units": "kg m^-2 s^-1"}),
        },
        global_attrs={"Source": "oisat tool",
                      "creation_time": _time.strftime("%Y-%m-%d %H:%M:%S", _time.localtime())},
    )
    return path


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    for key in ("ccmi", "ccmi_os", "soil", "nei", "scales"):
        ap.add_argument("--" + key.replace("_", "-"), required=True)
    ap.add_argument("--start", required=True)
    ap.add_argument("--end", required=True)
    ap.add_argument("--out", default=".")
    ap.add_argument("--jobs", type=int, default=12)
    args = ap.parse_args()
    paths = {k: getattr(args, k) for k in ("ccmi", "ccmi_os", "soil", "nei", "scales")}
    start = datetime.date.fromisoformat(args.start)
    end = datetime.date.fromisoformat(args.end)
    os.makedirs(args.out, exist_ok=True)
    days = [start + datetime.timedelta(n) for n in range((end - start).days)]
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        for day in days:
            list(ex.map(lambda i: merger(paths, EMISSION_NAMES_GMI[i], CORRS_NEI_EMIS[i], day, args.out),
                        range(len(EMISSION_NAMES_GMI))))
