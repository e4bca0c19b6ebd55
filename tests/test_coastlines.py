"""Coastline overlay on the report maps (VERDICT r2 item 5: the reference
drew every panel on a coastline Basemap, reference report.py:13-59)."""

import json

import numpy as np
import pytest


def test_builtin_coastlines_sane():
    from oisat.data import coastline_segments, coastlines_source

    segs = coastline_segments()
    assert coastlines_source() in ("builtin-approximate", "npz", "env")
    assert len(segs) > 30
    total = sum(len(s) for s in segs)
    assert total > 500
    for s in segs:
        assert s.ndim == 2 and s.shape[1] == 2 and len(s) >= 2
        assert (np.abs(s[:, 0]) <= 180.0).all(), "lon out of range"
        assert (np.abs(s[:, 1]) <= 90.0).all(), "lat out of range"
        # no dateline-crossing jumps inside a segment
        assert np.max(np.abs(np.diff(s[:, 0]))) < 180.0


def test_builtin_coastlines_hit_known_domains():
    """Every reference analysis domain must get at least some coastline:
    CONUS (TEMPO), Europe, East Asia, and a global grid."""
    from oisat.data import coastline_segments

    def count_in(lon0, lon1, lat0, lat1):
        n = 0
        for s in coastline_segments():
            m = ((s[:, 0] >= lon0) & (s[:, 0] <= lon1)
                 & (s[:, 1] >= lat0) & (s[:, 1] <= lat1))
            n += int(m.sum())
        return n

    assert count_in(-130, -60, 20, 55) > 30  # CONUS + Mexico
    assert count_in(-10, 30, 35, 60) > 20  # Europe
    assert count_in(100, 145, 20, 45) > 20  # East Asia
    assert count_in(-180, 180, -90, 90) > 500  # global


def test_make_coastlines_roundtrip(tmp_path, monkeypatch):
    """tools/make_coastlines.py converts GeoJSON (LineString/Polygon) to the
    NaN-separated npz; the loader prefers it via OISAT_COASTLINES."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "mkc", os.path.join(os.path.dirname(__file__), "..", "tools",
                            "make_coastlines.py"))
    mkc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mkc)

    gj = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {
            "type": "LineString",
            "coordinates": [[-5.0, 50.0], [-4.0, 51.0], [-3.0, 52.0]]}},
        {"type": "Feature", "geometry": {
            "type": "MultiPolygon",
            "coordinates": [[[[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 0.0]]]]}},
    ]}
    src = tmp_path / "c.geojson"
    src.write_text(json.dumps(gj))
    dst = tmp_path / "coastlines.npz"
    n = mkc.convert(str(src), str(dst))
    assert n == 2

    import oisat.data as data

    monkeypatch.setenv("OISAT_COASTLINES", str(dst))
    monkeypatch.setattr(data, "_cache", {})
    segs = data.coastline_segments()
    assert data.coastlines_source() == "env"
    assert len(segs) == 2
    np.testing.assert_allclose(segs[0][0], [-5.0, 50.0])
    monkeypatch.setattr(data, "_cache", {})  # other tests reload the builtin


def test_report_panels_have_coastlines(tmp_path):
    """Every PDF panel draws coastline line-art (the 'Done' criterion)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from oisat.report import plotter, report

    # unit check: the panel axes gain Line2D coastline artists
    lon, lat = np.meshgrid(np.arange(-130, -60, 0.5), np.arange(20, 55, 0.5))
    fig, ax = plt.subplots()
    plotter(lon, lat, np.hypot(lon + 95, lat - 37), ax, "t", 1, 0, 50)
    lines = [ln for ln in ax.get_lines() if np.isfinite(ln.get_xdata()).sum() > 1]
    assert len(lines) >= 3  # NA mainland + islands clipped to CONUS extent
    plt.close(fig)

    # end-to-end: the PDF is produced with the overlay in place
    H, W = lat.shape
    f = np.abs(np.hypot(lon + 95, lat - 37))
    path = report(lon, lat, f, f * 1.1, f * 0.9, f * 0.1, f * 0.05, f * 0 + 0.5,
                  f * 0.1, f * 0 + 2, f * 0 + 2, "coast", str(tmp_path), "NO2")
    assert path.endswith(".pdf")
    import os

    assert os.path.getsize(path) > 10_000


def test_make_coastlines_splits_dateline(tmp_path):
    """Polylines that jump across the dateline are split so the overlay
    never draws a spurious line across the whole map."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "mkc2", os.path.join(os.path.dirname(__file__), "..", "tools",
                             "make_coastlines.py"))
    mkc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mkc)
    gj = {"type": "Feature", "geometry": {
        "type": "LineString",
        "coordinates": [[170.0, 65.0], [178.0, 66.0], [-178.0, 66.5],
                        [-170.0, 66.0]]}}
    src = tmp_path / "d.geojson"
    src.write_text(json.dumps(gj))
    dst = tmp_path / "d.npz"
    n = mkc.convert(str(src), str(dst))
    assert n == 2  # split at the +178 -> -178 jump
    with np.load(dst) as d:
        lon = d["lon"]
    finite = lon[np.isfinite(lon)]
    assert np.max(np.abs(np.diff(finite[:2]))) < 180.0


def test_survey_grade_coastlines_pending():
    """CI-visible marker (VERDICT r4 #8): the shipped coastline set is the
    ~600-vertex builtin approximation; the survey-grade npz (Natural Earth
    via tools/make_coastlines.py) needs a network window.  When one
    exists: run the tool, ship oisat/data/coastlines.npz, and delete
    this skip."""
    import os

    import pytest

    from oisat import data as _data

    npz = os.path.join(os.path.dirname(_data.__file__), "coastlines.npz")
    if not os.path.exists(npz):
        pytest.skip("network-gated: survey-grade coastlines.npz not built; "
                    "builtin approximate set in use (tools/make_coastlines.py)")
    import numpy as np

    with np.load(npz) as d:
        assert d["lon"].size > 10_000  # survey grade, not the builtin
