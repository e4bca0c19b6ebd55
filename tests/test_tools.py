import importlib.util
import os
import sys

import numpy as np
import h5py

from oisat.ncwriter import read_diag_nc, write_diag_nc, write_nc
from oisat.readers.ncio import read_nc


def _load(name):
    path = os.path.join(os.path.dirname(__file__), "..", "tools", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_diag(path, seed=0):
    rng = np.random.default_rng(seed)
    H, W = 16, 24
    xa = np.abs(rng.normal(3, 1, (H, W)))
    y = xa * rng.uniform(0.8, 1.3, (H, W))
    err = np.abs(rng.normal(0.5, 0.1, (H, W)))
    lon, lat = np.meshgrid(np.linspace(-10, 10, W), np.linspace(30, 45, H))
    fields = {
        "sat_averaged_vcd": y, "ctm_averaged_vcd_prior": xa,
        "ctm_averaged_vcd_posterior": xa, "sat_averaged_error": err,
        "ak_OI": np.zeros((H, W)), "error_OI": np.zeros((H, W)),
        "scaling_factor": np.ones((H, W)), "lon": lon, "lat": lat,
        "aux1": np.ones((H, W)), "aux2": np.ones((H, W)),
    }
    write_diag_nc(path, fields, "2019-07-15 12:00:00")
    return fields


def test_readjust_oi(tmp_path):
    d = tmp_path / "diag"
    d.mkdir()
    make_diag(d / "NO2_201907.nc")
    mod = _load("readjust_OI")
    out = mod.readjust(d, tmp_path / "out", error_ctm=50.0)
    assert len(out) == 1
    fields, tstr = read_diag_nc(out[0])
    assert tstr.startswith("2019-07")
    # posterior now differs from prior (OI actually ran)
    assert not np.allclose(fields["ctm_averaged_vcd_posterior"],
                           fields["ctm_averaged_vcd_prior"])
    assert np.isfinite(fields["scaling_factor"]).all()


def test_convert2ext(tmp_path):
    d = tmp_path / "diag"
    d.mkdir()
    make_diag(d / "HCHO_201907.nc")
    mod = _load("convert2EXT")
    mod.convert(d, tmp_path / "ext", fake_years=range(2003, 2005))
    files = sorted(os.listdir(tmp_path / "ext"))
    assert "HCHO_201907.nc" in files
    assert "HCHO_200301.nc" in files and "HCHO_200412.nc" in files
    assert len(files) == 1 + 24
    sf = read_nc(tmp_path / "ext" / "HCHO_200301.nc", "SF")
    np.testing.assert_array_equal(sf, 1.0)
    with h5py.File(tmp_path / "ext" / "HCHO_201907.nc") as f:
        assert f["SF"].shape == (1, 16, 24)
        assert "hours since 2019-07-01" in f["time"].attrs["units"]


def test_create_oh_fields(tmp_path):
    # synthetic MERRA2 monthlies
    year = 2005
    for mm in range(1, 13):
        mdir = tmp_path / "merra2" / f"Y{year}" / f"M{mm:02}"
        mdir.mkdir(parents=True)
        L, H, W = 4, 6, 8
        write_nc(mdir / f"MERRA2_GMI.tavg24_3d_dac_Nv.monthly.{year}{mm:02}.nc4",
                 dims={"lev": np.arange(1.0, L + 1), "lat": np.linspace(-80, 80, H),
                       "lon": np.linspace(-170, 170, W)},
                 variables={"OH": (("lev", "lat", "lon"), np.full((L, H, W), 1e-12), {})})
        write_nc(mdir / f"MERRA2_GMI.tavg3_3d_met_Nv.monthly.{year}{mm:02}.nc4",
                 dims={"lev": np.arange(1.0, L + 1), "lat": np.linspace(-80, 80, H),
                       "lon": np.linspace(-170, 170, W)},
                 variables={"PL": (("lev", "lat", "lon"), np.full((L, H, W), 50000.0), {}),
                            "T": (("lev", "lat", "lon"), np.full((L, H, W), 250.0), {})})
    mod = _load("createOHfields")
    out = mod.create(tmp_path / "oh", str(tmp_path / "merra2"), year)
    assert len(out) == 12
    oh = read_nc(out[0], "OH")
    expect = 1e-12 * 6.02214076e23 * 500.0 / 8.314e4 / 250.0
    np.testing.assert_allclose(oh, expect, rtol=1e-12)


def test_readjust_oi_desroziers(tmp_path):
    """--desroziers N re-estimates So/Sa during the resume-from-diag OI
    (extension over the reference tool)."""
    d = tmp_path / "diag"
    d.mkdir()
    make_diag(d / "NO2_201907.nc", seed=3)
    mod = _load("readjust_OI")
    out0 = mod.readjust(d, tmp_path / "out0", error_ctm=200.0)
    out1 = mod.readjust(d, tmp_path / "out1", error_ctm=200.0,
                        desroziers_iterations=3)
    f0, _ = read_diag_nc(out0[0])
    f1, _ = read_diag_nc(out1[0])
    assert np.isfinite(f1["ctm_averaged_vcd_posterior"]).any()
    # the rescaled variances change the analysis (error field especially:
    # the wildly inflated 200% prior error is re-estimated down)
    assert not np.allclose(f1["error_OI"], f0["error_OI"], equal_nan=True)
    assert np.nanmean(f1["error_OI"]) < np.nanmean(f0["error_OI"])


def test_create_ind_co_emiss(tmp_path):
    """tools/create_ind_CO_emiss builds one ExtData month from MERRA2-GMI
    reaction rates + the OMI-HCHO SF climatology (reference
    tools/create_ind_CO_emiss.py:1-130); validated against an independent
    recomputation of the weighted-sum/thickness/biogenic formula."""
    mod = _load("create_ind_CO_emiss")
    rng = np.random.default_rng(7)
    L, H, W = 3, 4, 5
    lat = np.linspace(30, 33, H)
    lon = np.linspace(-5, -1, W)
    lev = np.arange(1.0, L + 1)
    year, mm = 2019, 7
    mdir = tmp_path / "merra2" / f"Y{year}" / f"M{mm:02}"
    mdir.mkdir(parents=True)

    def wnc(path, var3d):
        write_nc(str(path),
                 dims={"lev": lev, "lat": lat, "lon": lon},
                 variables={"lat": (("lat",), None, {}),
                            "lon": (("lon",), None, {}),
                            "lev": (("lev",), None, {}),
                            **{k: (("lev", "lat", "lon"), v, {})
                               for k, v in var3d.items()}})

    fields = {}
    for group, reacts in mod.REACTIONS.items():
        if group == "bio":
            continue
        vals = {r: np.abs(rng.normal(1e-9, 2e-10, (L, H, W))) for r in reacts}
        fields.update(vals)
        wnc(mdir / f"MERRA2_GMI.tavg24_3d_{group}_Nv.monthly.{year}{mm:02}.nc4", vals)
    bio = {r: np.abs(rng.normal(1e-10, 2e-11, (H, W)))
           for r in mod.REACTIONS["bio"]}
    fields.update(bio)
    write_nc(str(mdir / f"MERRA2_GMI.tavg24_2d_dad_Nx.monthly.{year}{mm:02}.nc4"),
             dims={"lat": lat, "lon": lon},
             variables={k: (("lat", "lon"), v, {}) for k, v in bio.items()})
    h_mid = np.sort(rng.uniform(100, 5e4, (L, H, W)), axis=0)
    h_edge = np.sort(rng.uniform(100, 6e4, (L + 1, H, W)), axis=0)
    wnc(mdir / f"MERRA2_GMI.tavg3_3d_met_Nv.monthly.{year}{mm:02}.nc4", {"H": h_mid})
    write_nc(str(mdir / f"MERRA2_GMI.tavg3_3d_mst_Ne.monthly.{year}{mm:02}.nc4"),
             dims={"lev": np.arange(1.0, L + 2), "lat": lat, "lon": lon},
             variables={"ZLE": (("lev", "lat", "lon"), h_edge, {})})

    sf_dir = tmp_path / "sf"
    sf_dir.mkdir()
    sf = np.abs(rng.normal(1.2, 0.1, (H, W)))
    write_nc(str(sf_dir / f"HCHO_2010{mm:02}.nc"),
             dims={"lat": lat, "lon": lon},
             variables={"SF": (("lat", "lon"), sf, {})})

    out = tmp_path / "out"
    out.mkdir()
    path = mod.build_month(out, tmp_path / "merra2", sf_dir, year, mm)
    got = np.squeeze(read_nc(path, "CO_Indirect"))  # (1, L, H, W) on disk

    # independent recomputation
    order = [r for g, rs in mod.REACTIONS.items() if g != "bio" for r in rs]
    exp = np.zeros((L, H, W))
    for i, r in enumerate(order):
        term = fields[r] * mod.FACTORS[i]
        if r in mod.SF_REACTIONS:
            term = term * sf[None]
        exp = exp + term
    exp = exp * (-2.0 * (h_edge[1:] - h_mid)) * 28.01 / 1000.0
    exp[-1] += sum(bio.values())
    np.testing.assert_allclose(got, exp, rtol=1e-12)


def test_merge_soil_ccmi_nei(tmp_path):
    """tools/merge_soil_CCMI_NEI merges CCMI + NEI-2016 + hourly soil NOx
    with diurnal scaling (reference tools/merge_soil_CCMI_NEI.py:90-256):
    NEI wins inside its domain (diurnally scaled), the global channels and
    ship survive outside, zeros backfill from the raw inventory."""
    import datetime as _dt

    from scipy.io import savemat

    mod = _load("merge_soil_CCMI_NEI")
    lat1 = np.array([0.0, 1.0, 2.0, 3.0])
    lon1 = np.array([0.0, 1.0, 2.0, 3.0, 4.0])
    shape = (lat1.size, lon1.size)
    FF, BF, SHIP, SOIL, NEI_NO, NEI_NO2, DIURNAL = 3.0, 4.0, 0.5, 0.25, 7.0, 1.0, 2.0
    year = 2019

    def grid_nc(path, variables, lat=lat1, lon=lon1, extra_dims=None):
        dims = {"lat": lat, "lon": lon}
        dims.update(extra_dims or {})
        write_nc(str(path), dims=dims,
                 variables={"lat": (("lat",), None, {}),
                            "lon": (("lon",), None, {}), **variables})

    for key in ("ccmi", "ccmi_os", "soil", "nei", "scales"):
        (tmp_path / key).mkdir()
    month12 = lambda v: np.full((12,) + shape, v)
    grid_nc(tmp_path / "ccmi_os" / f"CCMI_emis01_OS_NO_{year}_t12.nc4",
            {"NO_ff": (("t", "lat", "lon"), month12(FF), {}),
             "NO_bf": (("t", "lat", "lon"), month12(BF), {})},
            extra_dims={"t": 12})
    grid_nc(tmp_path / "ccmi" / f"CCMI_emis01_NO_shp_{year}_t12.nc4",
            {"NO_shp": (("t", "lat", "lon"), month12(SHIP), {})},
            extra_dims={"t": 12})

    sdir = tmp_path / "soil" / f"soilnox_{year}" / "07"
    sdir.mkdir(parents=True)
    grid_nc(sdir / f"soilnox_025.{year}0710.nc",
            {"SOIL_NOx": (("t", "lat", "lon"), np.full((24,) + shape, SOIL), {})},
            extra_dims={"t": 24})

    nlat = np.array([0.0, 0.5, 1.0])
    nlon = np.array([0.0, 0.5, 1.0, 1.5, 2.0])
    grid_nc(tmp_path / "nei" / "2016fh_16j_merge_0pt1degree_month_07.ncf",
            {"NO": (("lat", "lon"), np.full((3, 5), NEI_NO), {}),
             "NO2": (("lat", "lon"), np.full((3, 5), NEI_NO2), {})},
            lat=nlat, lon=nlon)

    glon, glat = np.meshgrid(nlon, nlat)
    savemat(str(tmp_path / "scales" / "Scales_201607.mat"),
            {"NO_weekday": np.full((24, 3, 5), DIURNAL),
             "NO_weekend": np.full((24, 3, 5), 99.0)})
    write_nc(str(tmp_path / "scales" / "GRIDCRO2D_20190201.nc4"),
             dims={"y": np.arange(3.0), "x": np.arange(5.0)},
             variables={"LON": (("y", "x"), glon, {}),
                        "LAT": (("y", "x"), glat, {})})

    paths = {k: str(tmp_path / k) for k in ("ccmi", "ccmi_os", "soil", "nei", "scales")}
    out = tmp_path / "out"
    out.mkdir()
    path = mod.merger(paths, "NO", "NO", _dt.date(year, 7, 10), str(out))

    ff = read_nc(path, "NO_ff")
    bf = read_nc(path, "NO_bf")
    assert ff.shape == (24,) + shape and np.isfinite(ff).all()
    nei_val = NEI_NO * (30.0 / 46.0) + NEI_NO2
    # inside the NEI domain (lat<=1, lon<=2): diurnal * NEI + soil
    np.testing.assert_allclose(ff[:, 0, 0], DIURNAL * nei_val + SOIL)
    np.testing.assert_allclose(ff[:, 1, 2], DIURNAL * nei_val + SOIL)
    # outside: soil + global ff + ship (diurnal defaults to 1 there)
    np.testing.assert_allclose(ff[:, 3, 4], SOIL + FF + SHIP)
    # bf: masked to zero inside NEI then backfilled from the raw global
    # channel; untouched global value outside
    np.testing.assert_allclose(bf, BF)


def test_readjust_oi_scale_maps_not_stale(tmp_path):
    """A source diag carrying per-cell Desroziers scale maps must not leak
    them verbatim into the readjusted file (advisor r4): without
    --desroziers-bins the fields are dropped; with bins>1 they are the
    re-estimated maps of THIS run."""
    d = tmp_path / "diag"
    d.mkdir()
    fields = make_diag(d / "NO2_201907.nc", seed=5)
    H, W = fields["lon"].shape
    stale = dict(fields)
    stale["desroziers_sa_scale"] = np.full((H, W), 7.0)
    stale["desroziers_so_scale"] = np.full((H, W), 9.0)
    from oisat.ncwriter import write_diag_nc

    write_diag_nc(d / "NO2_201907.nc", stale, "2019-07-15 12:00:00")

    mod = _load("readjust_OI")
    out0 = mod.readjust(d, tmp_path / "out0", error_ctm=200.0)
    f0, _ = read_diag_nc(out0[0])
    assert "desroziers_sa_scale" not in f0
    assert "desroziers_so_scale" not in f0

    out1 = mod.readjust(d, tmp_path / "out1", error_ctm=200.0,
                        desroziers_iterations=2, desroziers_bins=4)
    f1, _ = read_diag_nc(out1[0])
    assert f1["desroziers_sa_scale"].shape == (H, W)
    # the maps describe this run's tuning, not the stale 7.0/9.0 fill
    assert not np.allclose(f1["desroziers_sa_scale"], 7.0)
    assert not np.allclose(f1["desroziers_so_scale"], 9.0)
