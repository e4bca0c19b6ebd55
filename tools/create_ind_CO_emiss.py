"""Indirect-CO emissions from HCHO oxidation, scaled by OMI-HCHO OI factors.

Equivalent of reference tools/create_ind_CO_emiss.py:1-130: sums the
HCHO-producing reaction rates from MERRA2-GMI monthlies, applies the
OMI-HCHO scaling-factor climatology to the HCHO+hv / HCHO+OH channels
(QQJ011, QQJ012, QQK046), converts mole/m^3/s -> kg/m^2/s with layer
thicknesses, folds biogenic CO into the surface layer, and writes one
ExtData file per month.  Site paths are arguments.

Usage:
  python create_ind_CO_emiss.py <out_folder> --sf-dir <omi_hcho_sf_dir>
      [--merra2 PATH] [--start-year Y0] [--end-year Y1]
"""

import argparse
import datetime
import os
import sys
import time as _time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from oisat.ncwriter import write_nc  # noqa: E402
from oisat.readers.ncio import read_nc  # noqa: E402

# reaction groups and weights (reference create_ind_CO_emiss.py:37-44)
REACTIONS = {
    "rj2": ["QQJ011", "QQJ012", "QQJ047", "QQJ050"],
    "rk2": ["QQK204", "QQK212", "QQK213", "QQK222", "QQK039"],
    "rk3": ["QQK046", "QQK066"],
    "rk4": ["QQK091", "QQK101", "QQK103", "QQK109"],
    "bio": ["EMBIOCOMETH", "EMBIOCOMONOT"],
}
FACTORS = [1, 1, 1, 1, 0.42, 2.0, 1, 0.05, -1.0, 1, 1, 1, 1, 1, 1]
SF_REACTIONS = ["QQJ011", "QQJ012", "QQK046"]  # HCHO+hv, HCHO+OH channels


def monthly_sf_climatology(sf_dir, mm, years=range(2005, 2020), gas="HCHO"):
    """Mean OMI-HCHO scaling factor for calendar month mm over the years."""
    sfs = []
    for yr in years:
        path = os.path.join(str(sf_dir), f"{gas}_{yr}{mm:02}.nc")
        if os.path.exists(path):
            sfs.append(read_nc(path, "SF"))
    if not sfs:
        return None
    return np.nanmean(np.array(sfs), axis=0)


def build_month(out_folder, merra2_path, sf_dir, year, mm):
    when = datetime.datetime(year, mm, 1)
    mdir = os.path.join(str(merra2_path), f"Y{year}", f"M{mm:02}")
    omi_sf = monthly_sf_climatology(sf_dir, mm)

    var = None
    var_bio = None
    lat = lon = lev = None
    cnt = -1
    for group, reacts in REACTIONS.items():
        for react in reacts:
            cnt += 1
            if group == "bio":
                fname = os.path.join(mdir, f"MERRA2_GMI.tavg24_2d_dad_Nx.monthly.{year}{mm:02}.nc4")
            else:
                fname = os.path.join(mdir, f"MERRA2_GMI.tavg24_3d_{group}_Nv.monthly.{year}{mm:02}.nc4")
            reaction = read_nc(fname, react)
            if var is None and group != "bio":
                var = np.zeros_like(np.asarray(reaction, np.float64))
                lat = read_nc(fname, "lat")
                lon = read_nc(fname, "lon")
                lev = read_nc(fname, "lev")
            if group == "bio":
                if var_bio is None:
                    var_bio = np.zeros_like(np.asarray(reaction, np.float64))
                var_bio = var_bio + reaction
            elif react in SF_REACTIONS and omi_sf is not None:
                var = var + np.asarray(reaction) * FACTORS[cnt] * omi_sf[None]
            else:
                var = var + np.asarray(reaction) * FACTORS[cnt]

    # mole/m^3/s -> kg/m^2/s via layer thickness (create_ind_CO_emiss.py:101-108)
    met_mid = os.path.join(mdir, f"MERRA2_GMI.tavg3_3d_met_Nv.monthly.{year}{mm:02}.nc4")
    met_edge = os.path.join(mdir, f"MERRA2_GMI.tavg3_3d_mst_Ne.monthly.{year}{mm:02}.nc4")
    h_mid = read_nc(met_mid, "H")
    h_edge = read_nc(met_edge, "ZLE")
    dh = -2.0 * (h_edge[1:] - h_mid)
    var = var * dh * 28.01 / 1000.0
    if var_bio is not None:
        var[-1] = var[-1] + var_bio

    path = os.path.join(str(out_folder), f"CO_Indirect_MERRA2GMI_{year}{mm:02}.nc")
    write_nc(
        path,
        dims={"time": np.array([0.0]), "lev": np.asarray(lev),
              "lat": np.asarray(lat), "lon": np.asarray(lon)},
        variables={
            "time": (("time",), None, {"long_name": "time",
                                       "units": "hours since " + when.strftime("%Y-%m-%d %H:%M:%S")}),
            "lat": (("lat",), None, {"units": "degrees_north"}),
            "lon": (("lon",), None, {"units": "degrees_east"}),
            "lev": (("lev",), None, {"units": "layer", "positive": "down"}),
            "CO_Indirect": (("time", "lev", "lat", "lon"), np.asarray(var)[None],
                            {"units": "kg m^-2 s^-1"}),
        },
        global_attrs={"Source": "oisat tool",
                      "creation_time": _time.strftime("%Y-%m-%d %H:%M:%S", _time.localtime())},
    )
    return path


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_folder")
    ap.add_argument("--sf-dir", required=True)
    ap.add_argument("--merra2", default="/css/merra2gmi/pub")
    ap.add_argument("--start-year", type=int, default=1990)
    ap.add_argument("--end-year", type=int, default=2019)
    args = ap.parse_args()
    os.makedirs(args.out_folder, exist_ok=True)
    for yr in range(args.start_year, args.end_year + 1):
        for mm in range(1, 13):
            print(f"Now processing {yr}{mm:02}")
            build_month(args.out_folder, args.merra2, args.sf_dir, yr, mm)
