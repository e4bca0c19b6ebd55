"""Build a survey-grade coastline dataset for the report maps.

The report overlays coastlines on every map panel, like the reference's
Basemap output (reference oisatgmi/report.py:13-59).  This offline build
ships only an approximate hand-placed coastline
(oisat/data/coastlines_builtin.py); run this tool ONCE on a networked
machine to replace it with public-domain data:

    # Natural Earth 110m (or 50m/10m) physical coastline GeoJSON:
    #   https://raw.githubusercontent.com/nvkelso/natural-earth-vector/
    #     master/geojson/ne_110m_coastline.geojson
    python tools/make_coastlines.py ne_110m_coastline.geojson \
        oisat/data/coastlines.npz

Accepted inputs: a GeoJSON FeatureCollection of LineString /
MultiLineString / Polygon / MultiPolygon features (Natural Earth, GSHHG
GeoJSON exports, OGR output — any CRS84 lon/lat file).  Output: an npz
with 1-D float32 ``lon``/``lat`` arrays, NaN-separated between polylines
(the format oisat.data.coastline_segments loads; it also honours the
``OISAT_COASTLINES`` env var for out-of-tree paths).
"""

import json
import sys

import numpy as np


def _rings(geom):
    t = geom["type"]
    c = geom["coordinates"]
    if t == "LineString":
        return [c]
    if t == "MultiLineString":
        return list(c)
    if t == "Polygon":
        return list(c)
    if t == "MultiPolygon":
        return [ring for poly in c for ring in poly]
    if t == "GeometryCollection":
        return [r for g in geom["geometries"] for r in _rings(g)]
    return []


def _split_dateline(pts):
    """Split a polyline wherever consecutive longitudes jump > 180 deg —
    the loader's contract is that no segment crosses the dateline (a
    crossing segment would draw a spurious line across the whole map)."""
    jumps = np.flatnonzero(np.abs(np.diff(pts[:, 0])) > 180.0) + 1
    return np.split(pts, jumps) if jumps.size else [pts]


def convert(geojson_path, npz_path):
    with open(geojson_path) as f:
        doc = json.load(f)
    feats = doc["features"] if doc.get("type") == "FeatureCollection" else [doc]
    lon, lat = [], []
    n = 0
    for feat in feats:
        geom = feat.get("geometry", feat)
        for ring in _rings(geom):
            pts = np.asarray(ring, np.float64)
            if pts.shape[0] < 2:
                continue
            for part in _split_dateline(pts):
                if part.shape[0] < 2:
                    continue
                lon.extend(part[:, 0].tolist())
                lat.extend(part[:, 1].tolist())
                lon.append(np.nan)
                lat.append(np.nan)
                n += 1
    if not n:
        sys.exit(f"no line geometry found in {geojson_path}")
    np.savez_compressed(npz_path,
                        lon=np.asarray(lon, np.float32),
                        lat=np.asarray(lat, np.float32))
    print(f"wrote {npz_path}: {n} polylines, {len(lon)} vertices")
    return n


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    convert(sys.argv[1], sys.argv[2])
