"""CTM readers on synthetic model files with the real variable layouts."""

import datetime

import numpy as np

import h5py

from oisat.readers.ctm import CMAQ_reader, ECCOH_reader, GMI_reader, Hi_GMI_reader


def write_gmi_pair(met_path, gas_path, day, nt=8, nz=6, nlat=10, nlon=12):
    minutes = np.arange(nt) * 180.0 + 90.0  # 3-hourly tavg midpoints
    with h5py.File(met_path, "w") as f:
        f["lon"] = np.linspace(-10, 10, nlon)
        f["lat"] = np.linspace(30, 45, nlat)
        t = f.create_dataset("time", data=minutes)
        t.attrs["begin_date"] = np.int32(20190700 + day)
        t.attrs["begin_time"] = np.int32(0)
        f["DELP"] = np.full((nt, nz, nlat, nlon), 2000.0)  # Pa
        # level axis 0 = top in raw files; readers flip to bottom-up.
        # PL is hybrid-eta derived like real MERRA2-GMI (A + B*PS, Pa)
        # with spatially varying surface pressure — the fused month's
        # carrier compression must survive the reader's f32/flip/scale
        # pipeline on exactly this structure
        eta_a = np.linspace(10000.0, 0.0, nz)
        eta_b = np.linspace(0.0, 0.9, nz)
        ps = 100000.0 + 3000.0 * np.random.default_rng(day).standard_normal(
            (nt, 1, nlat, nlon))
        f["PL"] = eta_a[None, :, None, None] + eta_b[None, :, None, None] * ps
    with h5py.File(gas_path, "w") as f:
        f["NO2"] = np.full((nt, nz, nlat, nlon), 2e-9)  # mol/mol


def test_gmi_reader(tmp_path):
    for day in (1, 2):
        write_gmi_pair(tmp_path / f"MERRA2_GMI.tavg3_3d_met_Nv.201907{day:02}.nc4",
                       tmp_path / f"MERRA2_GMI.tavg3_3d_tac_Nv.201907{day:02}.nc4", day)
    out = GMI_reader(str(tmp_path), "201907", "NO2", num_job=1)
    assert len(out) == 2
    g = out[0]
    assert g.ctmtype == "GMI" and g.averaged is False
    assert g.time[0] == datetime.datetime(2019, 7, 1, 1, 30)
    assert g.gas_profile.shape == (8, 6, 10, 12)
    np.testing.assert_allclose(g.gas_profile, 2.0, rtol=1e-5)  # 2e-9 -> 2 ppbv
    np.testing.assert_allclose(g.delta_p, 20.0, rtol=1e-6)  # Pa -> hPa
    # bottom-to-top flip: pressure decreasing along level axis
    assert g.pressure_mid[0, 0, 0, 0] > g.pressure_mid[0, -1, 0, 0]
    # HCHO maps to CH2O variable
    for day in (1,):
        with h5py.File(tmp_path / f"MERRA2_GMI.tavg3_3d_tac_Nv.201907{day:02}.nc4", "a") as f:
            f["CH2O"] = np.full((8, 6, 10, 12), 1e-9)
    out = GMI_reader(str(tmp_path), "20190701", "HCHO", num_job=1)  # day-1 file only
    np.testing.assert_allclose(out[0].gas_profile, 1.0, rtol=1e-5)


def test_higmi_reader_always_averages(tmp_path):
    for day in (1, 2):
        write_gmi_pair(tmp_path / f"HiGMI.tavg1_3D_met_CONUS.201907{day:02}.nc4",
                       tmp_path / f"HiGMI.tavg1_3D_gasconc_CONUS.201907{day:02}.nc4", day)
    out = Hi_GMI_reader(str(tmp_path), "201907", "NO2", num_job=1)
    assert len(out) == 1
    assert out[0].averaged is True
    assert out[0].ctmtype == "HiGMI"
    np.testing.assert_allclose(out[0].gas_profile, 2.0, rtol=1e-5)


def test_eccoh_reader_ch4_dry_conversion(tmp_path):
    nz, nlat, nlon = 5, 8, 9
    with h5py.File(tmp_path / "run.eccoh_Nv.201006.nc4", "w") as f:
        f["lon"] = np.linspace(-10, 10, nlon)
        f["lat"] = np.linspace(30, 45, nlat)
        t = f.create_dataset("time", data=np.array([0.0]))
        t.attrs["begin_date"] = np.int32(20100601)
        f["DELP"] = np.full((nz, nlat, nlon), 3000.0)
        f["PL"] = np.linspace(10000, 90000, nz)[:, None, None] * np.ones((nz, nlat, nlon))
        f["CH4"] = np.full((nz, nlat, nlon), 1.8e-6)
        f["QV"] = np.full((nz, nlat, nlon), 0.01)
    out = ECCOH_reader(str(tmp_path), "201006", "CH4", num_job=1)
    assert len(out) == 1
    g = out[0]
    assert g.ctmtype == "ECCOH"
    assert g.time == [datetime.datetime(2010, 6, 1)]
    # moist -> dry: x * (1 + w * 28.96/18.015), w = qv/(1-qv)
    w = 0.01 / 0.99
    np.testing.assert_allclose(g.gas_profile, 1800.0 * (1 + w * 28.96 / 18.015), rtol=1e-5)


def test_cmaq_reader(tmp_path):
    nt, nz, nlat, nlon = 4, 3, 6, 7
    tflag = np.zeros((nt, 2, 2), np.int32)
    for t in range(nt):
        tflag[t, :, 0] = 2019188  # July 7, 2019 (YYYYDDD)
        tflag[t, :, 1] = t * 10000
    with h5py.File(tmp_path / "CCTM_CONC_201907.nc", "w") as f:
        f["TFLAG"] = tflag
        f["FORM"] = np.full((nt, nz, nlat, nlon), 0.002)  # ppmv
    with h5py.File(tmp_path / "METCRO3D_201907", "w") as f:
        f["PRES"] = np.linspace(90000, 50000, nz)[None, :, None, None] * np.ones((nt, nz, nlat, nlon))
    with h5py.File(tmp_path / "METCRO2D_201907", "w") as f:
        f["PRSFC"] = np.full((nt, nlat, nlon), 101325.0)
    with h5py.File(tmp_path / "GRIDCRO2D_201907", "w") as f:
        f["LAT"] = np.linspace(30, 45, nlat)[:, None] * np.ones((nlat, nlon))
        f["LON"] = np.ones((nlat, 1)) * np.linspace(-10, 10, nlon)[None, :]
    out = CMAQ_reader(str(tmp_path), str(tmp_path), "201907", "HCHO")
    assert len(out) == 1
    g = out[0]
    assert g.ctmtype == "CMAQ" and g.averaged is True
    assert g.time[0] == datetime.datetime(2019, 7, 7, 0)
    np.testing.assert_allclose(g.gas_profile, 2.0, rtol=1e-5)  # ppmv*1000 -> ppbv
    # delta-p: first layer = 2*(psfc - p0) = 2*(1013.25-900) hPa
    np.testing.assert_allclose(g.delta_p[:, 0], 2 * (1013.25 - 900.0), rtol=1e-5)


def test_cmaq_reader_rejects_inconsistent_mcip_lists(tmp_path):
    """A missing METCRO2D file must fail loudly — zip() truncation would
    silently average 29/30 granules and divide by 30."""
    import pytest

    from oisat.readers.ctm import CMAQ_reader

    (tmp_path / "CCTM_CONC_201907a.nc").write_bytes(b"x" * 200)
    (tmp_path / "METCRO3D_201907a").write_bytes(b"x" * 200)
    (tmp_path / "GRIDCRO2D_201907a").write_bytes(b"x" * 200)
    # no METCRO2D at all
    with pytest.raises(Exception, match="not consistent"):
        CMAQ_reader(str(tmp_path), str(tmp_path), "201907", "NO2")


def test_ctm_readers_fail_loudly_on_empty_dir(tmp_path):
    import pytest

    from oisat.readers.ctm import CMAQ_reader, GMI_reader, Hi_GMI_reader

    with pytest.raises(FileNotFoundError, match="no GMI met"):
        GMI_reader(str(tmp_path), "201907", "NO2")
    with pytest.raises(FileNotFoundError, match="no HiGMI met"):
        Hi_GMI_reader(str(tmp_path), "201907", "NO2")
    with pytest.raises(FileNotFoundError, match="no CMAQ conc"):
        CMAQ_reader(str(tmp_path), str(tmp_path), "201907", "NO2")
