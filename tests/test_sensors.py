"""End-to-end sensor-reader tests on synthetic product files.

The reference has no test data and no tests; here each product gets a tiny
HDF5 file with the real group/variable layout, written with h5py, and the
fleet reader runs decode -> regrid end-to-end (SURVEY.md §4: generalize the
FREE pattern to fake satellite data)."""

import datetime

import numpy as np
import pytest

import h5py

from oisat.readers.sensors import (
    gosat_reader,
    mopitt_reader,
    omi_reader,
    omps_reader,
    ssmis_reader,
    tempo_reader,
    tropomi_reader,
)

CLON, CLAT = np.meshgrid(np.arange(-10, 11, 1.25), np.arange(30, 46, 1.0))
NY, NX = 60, 40


def swath_geo(ny=NY, nx=NX, lat0=30.5, lat1=45.2, lon0=-9.8, lon1=9.9):
    lat = np.linspace(lat0, lat1, ny)[:, None] * np.ones((ny, nx))
    lon = np.ones((ny, 1)) * np.linspace(lon0, lon1, nx)[None, :]
    return lat.astype("f4"), lon.astype("f4")


def write_omi_no2(path):
    lat, lon = swath_geo()
    with h5py.File(path, "w") as f:
        g = f.create_group("GEOLOCATION_DATA")
        # 2004-10-01-ish in TAI93 seconds
        g["Time"] = np.full(NY, (datetime.datetime(2019, 7, 10) - datetime.datetime(1993, 1, 1)).total_seconds())
        g["Latitude"] = lat
        g["Longitude"] = lon
        g["ScatteringWeightPressure"] = np.linspace(1000, 10, 35).astype("f4")
        s = f.create_group("SCIENCE_DATA")
        s["ColumnAmountNO2Trop"] = np.full((NY, NX), 3.0e15)
        s["AmfTrop"] = np.full((NY, NX), 2.0)
        s["ColumnAmountNO2TropStd"] = np.full((NY, NX), 1.0e15)
        s["VcdQualityFlags"] = np.zeros((NY, NX))
        s["ScatteringWeight"] = np.ones((NY, NX, 35))
        a = f.create_group("ANCILLARY_DATA")
        a["CloudFraction"] = np.full((NY, NX), 0.1)
        a["TerrainReflectivity"] = np.full((NY, NX), 0.05)
        a["TropopausePressure"] = np.full((NY, NX), 150.0)


def test_omi_no2(tmp_path):
    write_omi_no2(tmp_path / "OMI-Aura_L2-OMNO2_2019m0710.nc")
    out = omi_reader(str(tmp_path), "OMI_NO2", CLON, CLAT, "201907", trop=True, num_job=1)
    assert len(out) == 1
    g = out[0]
    assert g is not None
    assert g.time == datetime.datetime(2019, 7, 10)
    assert g.vcd.shape == CLON.shape
    v = g.vcd[np.isfinite(g.vcd)]
    assert v.size > 50
    np.testing.assert_allclose(v, 3.0, rtol=1e-5)  # 3e15 * 1e-15
    # level stacks transfer as f16 in f32 production mode (the reference
    # stores them f16 outright): ~5e-4 quantization on 3-D fields
    np.testing.assert_allclose(g.scattering_weights[0][np.isfinite(g.scattering_weights[0])], 1.0, rtol=1e-3)
    assert g.tropopause[np.isfinite(g.tropopause)].size > 0


def write_tempo_no2(path):
    ny, nx = 150, 120
    lat, lon = swath_geo(ny, nx, 34.0, 38.0, -5.0, -1.0)  # ~0.03-deg pixels
    lat = np.array(lat); lat[0, 0] = 9.96921e36  # edge-pixel garbage
    with h5py.File(path, "w") as f:
        g = f.create_group("geolocation")
        g["time"] = np.full(ny, (datetime.datetime(2023, 9, 5, 18) - datetime.datetime(1980, 1, 6)).total_seconds())
        g["latitude"] = lat
        g["longitude"] = lon
        p = f.create_group("product")
        p["vertical_column_troposphere"] = np.full((ny, nx), 4.0e15)
        p["vertical_column_troposphere_uncertainty"] = np.full((ny, nx), 1.0e15)
        p["main_data_quality_flag"] = np.zeros((ny, nx))
        s = f.create_group("support_data")
        s["amf_troposphere"] = np.full((ny, nx), 1.8)
        s["eff_cloud_fraction"] = np.full((ny, nx), 0.05)
        ps = s.create_dataset("surface_pressure", data=np.full((ny, nx), 1000.0))
        ps.attrs["Eta_A"] = np.linspace(0, 1, 73)
        ps.attrs["Eta_B"] = np.linspace(1, 0, 73)
        s["scattering_weights"] = np.ones((72, ny, nx))
        s["tropopause_pressure"] = np.full((ny, nx), 140.0)


def test_tempo_no2(tmp_path):
    write_tempo_no2(tmp_path / "TEMPO_NO2_L2_20230905T180000.nc")
    out = tempo_reader(str(tmp_path), 18, "TEMPO_NO2", CLON, CLAT, "202309", trop=True, num_job=1)
    assert len(out) == 1 and out[0] is not None
    g = out[0]
    assert g.time.hour == 18
    v = g.vcd[np.isfinite(g.vcd)]
    np.testing.assert_allclose(v, 4.0, rtol=1e-5)
    assert g.pressure_mid.shape[0] == 72


def write_tropomi_no2(path):
    ny, nx = 180, 120
    lat, lon = swath_geo(ny, nx, 31.0, 44.0, -9.0, 9.0)  # ~0.07-0.15-deg pixels
    with h5py.File(path, "w") as f:
        p = f.create_group("PRODUCT")
        p["time"] = np.array([(datetime.datetime(2019, 7, 12) - datetime.datetime(2010, 1, 1)).total_seconds()])
        p["delta_time"] = np.full(ny, 3_600_000.0)  # ms
        p["latitude"] = lat
        p["longitude"] = lon
        p["air_mass_factor_total"] = np.full((ny, nx), 2.2)
        p["nitrogendioxide_tropospheric_column"] = np.full((ny, nx), 8e-5)  # mol/m2
        p["air_mass_factor_troposphere"] = np.full((ny, nx), 1.9)
        p["nitrogendioxide_tropospheric_column_precision"] = np.full((ny, nx), 2e-5)
        p["qa_value"] = np.full((ny, nx), 0.9)
        p["tm5_constant_a"] = np.column_stack([np.linspace(0, 1, 34), np.linspace(1, 2, 34)])
        p["tm5_constant_b"] = np.column_stack([np.linspace(1, 0, 34), np.linspace(0.9, 0, 34)])
        p["averaging_kernel"] = np.ones((ny, nx, 34))
        p["tm5_tropopause_layer_index"] = np.full((ny, nx), 20)
        sd = p.create_group("SUPPORT_DATA")
        sd.create_group("INPUT_DATA")["surface_pressure"] = np.full((ny, nx), 101325.0)
        sd.create_group("DETAILED_RESULTS")


def test_tropomi_no2(tmp_path):
    write_tropomi_no2(tmp_path / "S5P_OFFL_L2__NO2____20190712.nc")
    out = tropomi_reader(str(tmp_path), "TROPOMI_NO2", CLON, CLAT, "201907", trop=True, num_job=1)
    assert len(out) == 1 and out[0] is not None
    g = out[0]
    assert g.time.date() == datetime.date(2019, 7, 12)
    v = g.vcd[np.isfinite(g.vcd)]
    # rtol 1e-3: vcd rides the narrow (f16) transfer in f32 mode — the
    # reference itself stores TROPOMI vcd at float16 (reader.py:660), so
    # the quantized value is the reference-faithful one
    np.testing.assert_allclose(v, 8e-5 * 6.02214e19 * 1e-15, rtol=1e-3)
    # SW = AK * amf_total = 2.2 everywhere (f16-transfer quantization
    # applies to level stacks in f32 mode, hence rtol 1e-3)
    sw = g.scattering_weights[0][np.isfinite(g.scattering_weights[0])]
    np.testing.assert_allclose(sw, 2.2, rtol=1e-3)
    assert np.isfinite(g.tropopause).sum() > 0


def write_omps(path):
    lat, lon = swath_geo()
    with h5py.File(path, "w") as f:
        g = f.create_group("geolocation")
        g["time"] = np.full(NY, (datetime.datetime(2019, 7, 3) - datetime.datetime(1993, 1, 1)).total_seconds())
        g["latitude"] = lat
        g["longitude"] = lon
        k = f.create_group("key_science_data")
        k["column_amount"] = np.full((NY, NX), 6.0e15)
        k["column_uncertainty"] = np.full((NY, NX), 2.0e15)
        k["main_data_quality_flag"] = np.zeros((NY, NX))
        s = f.create_group("support_data")
        s["amf"] = np.full((NY, NX), 1.5)
        s["cloud_fraction"] = np.full((NY, NX), 0.1)
        s["scattering_weights"] = np.ones((47, NY, NX))


def test_omps_hcho(tmp_path):
    write_omps(tmp_path / "OMPS_NPP_HCHO_2019m0703.nc")
    out = omps_reader(str(tmp_path), "OMPS_HCHO", CLON, CLAT, "201907", trop=False, num_job=1)
    assert len(out) == 1 and out[0] is not None
    g = out[0]
    v = g.vcd[np.isfinite(g.vcd)]
    np.testing.assert_allclose(v, 6.0, rtol=1e-5)
    assert g.pressure_mid.shape[0] == 47


def write_mopitt(path):
    nlon, nlat = 40, 30
    with h5py.File(path, "w") as f:
        fa = f.create_group("HDFEOS").create_group("ADDITIONAL").create_group("FILE_ATTRIBUTES")
        t0 = (datetime.datetime(2019, 7, 1) - datetime.datetime(1993, 1, 1)).total_seconds()
        fa.attrs["StartTime"] = t0
        fa.attrs["StopTime"] = t0 + 30 * 86400.0
        d = f["HDFEOS"].create_group("GRIDS").create_group("MOP03").create_group("Data Fields")
        d["Latitude"] = np.linspace(30.5, 45.5, nlat).astype("f4")
        d["Longitude"] = np.linspace(-9.5, 9.5, nlon).astype("f4")
        d["RetrievedCOTotalColumnDay"] = np.full((nlon, nlat), 2.0e18)
        d["DryAirColumnDay"] = np.full((nlon, nlat), 2.0e25)
        d["APrioriCOMixingRatioProfileDay"] = np.full((nlon, nlat, 9), 80.0)
        d["APrioriCOSurfaceMixingRatioDay"] = np.full((nlon, nlat), 90.0)
        d["SurfacePressureDay"] = np.full((nlon, nlat), 1000.0)
        d["APrioriCOTotalColumnDay"] = np.full((nlon, nlat), 1.8e18)
        d["RetrievedCOTotalColumnMeanUncertaintyDay"] = np.full((nlon, nlat), 2.0e17)
        d["Pressure"] = np.array([900., 800., 700., 600., 500., 400., 300., 200., 100.])
        d["TotalColumnAveragingKernelDay"] = np.full((nlon, nlat, 10), 5.0e13)


def test_mopitt_co(tmp_path):
    write_mopitt(tmp_path / "MOP03JM-201907.he5")
    out = mopitt_reader(str(tmp_path), CLON, CLAT, "201907", num_job=1)
    assert len(out) == 1 and out[0] is not None
    g = out[0]
    assert g.sensor == "MOPITT"
    v = g.vcd[np.isfinite(g.vcd)]
    np.testing.assert_allclose(v, 2.0e3, rtol=1e-4)  # 2e18 * 1e-15
    assert g.averaging_kernels.shape[0] == 10
    x = g.x_col[np.isfinite(g.x_col)]
    np.testing.assert_allclose(x, 1e6 * 2.0e3 / (2.0e25 * 1e-15), rtol=1e-4)


def write_gosat(path):
    n = 5000
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f["time"] = np.full(n, (datetime.datetime(2010, 6, 15) - datetime.datetime(1970, 1, 1)).total_seconds())
        f["latitude"] = rng.uniform(10, 60, n).astype("f4")
        f["longitude"] = rng.uniform(-30, 30, n).astype("f4")
        f["xch4"] = np.full(n, 1.8)
        f["xch4_quality_flag"] = np.zeros(n)
        f["xch4_uncertainty"] = np.full(n, 0.01)
        f["pressure_levels"] = np.tile(np.linspace(1000, 50, 20), (n, 1))
        f["ch4_profile_apriori"] = np.full((n, 20), 1700.0)
        f["xch4_averaging_kernel"] = np.full((n, 20), 0.9)
        f["pressure_weight"] = np.full((n, 20), 0.05)


def test_gosat(tmp_path):
    (tmp_path / "2010").mkdir()
    write_gosat(tmp_path / "2010" / "ESACCI-GHG-20100615.nc")
    out = gosat_reader(str(tmp_path), CLON, CLAT, "201006", num_job=1)
    assert len(out) == 1 and out[0] is not None
    g = out[0]
    assert g.sensor == "GOSAT"
    v = g.x_col[np.isfinite(g.x_col)]
    assert v.size > 10
    np.testing.assert_allclose(v, 1.8, rtol=1e-3)
    assert g.pressure_weight.shape[0] == 20


def write_ssmis(path):
    nlat, nlon = 60, 80
    with h5py.File(path, "w") as f:
        f["latitude"] = np.linspace(25, 50, nlat).astype("f4")
        f["longitude"] = np.linspace(335, 370, nlon).astype("f4")  # wraps past 360
        f["atmosphere_water_vapor_content"] = np.full((nlat, nlon), 100.0)  # *0.3 -> 30mm


def test_ssmis(tmp_path):
    write_ssmis(tmp_path / "f16_201001v7.nc")
    out = ssmis_reader(str(tmp_path), CLON, CLAT, "201001", num_job=1)
    assert len(out) == 1 and out[0] is not None
    g = out[0]
    assert g.time == datetime.datetime(2010, 1, 1)
    v = g.vcd[np.isfinite(g.vcd)]
    assert v.size > 10
    np.testing.assert_allclose(v, 30.0, rtol=1e-5)
    e = g.uncertainty[np.isfinite(g.uncertainty)]
    assert e.size > 0


def write_tropomi_hcho(path):
    ny, nx = 180, 120
    lat, lon = swath_geo(ny, nx, 31.0, 44.0, -9.0, 9.0)
    with h5py.File(path, "w") as f:
        p = f.create_group("PRODUCT")
        p["time"] = np.array([(datetime.datetime(2019, 7, 14) - datetime.datetime(2010, 1, 1)).total_seconds()])
        p["delta_time"] = np.full((ny, nx), 1_800_000.0)  # (scanline, pixel) ms
        p["latitude"] = lat
        p["longitude"] = lon
        p["formaldehyde_tropospheric_vertical_column"] = np.full((ny, nx), 1.2e-4)
        p["formaldehyde_tropospheric_vertical_column_precision"] = np.full((ny, nx), 4e-5)
        p["qa_value"] = np.full((ny, nx), 0.9)
        sd = p.create_group("SUPPORT_DATA")
        det = sd.create_group("DETAILED_RESULTS")
        det["formaldehyde_tropospheric_air_mass_factor"] = np.full((ny, nx), 1.3)
        det["averaging_kernel"] = np.ones((ny, nx, 34))
        inp = sd.create_group("INPUT_DATA")
        inp["surface_pressure"] = np.full((ny, nx), 101325.0)
        inp["tm5_constant_a"] = np.linspace(100000, 100, 34)  # Pa, mid-levels
        inp["tm5_constant_b"] = np.zeros(34)


def test_tropomi_hcho(tmp_path):
    write_tropomi_hcho(tmp_path / "S5P_OFFL_L2__HCHO___20190714.nc")
    out = tropomi_reader(str(tmp_path), "TROPOMI_HCHO", CLON, CLAT, "201907",
                         trop=False, num_job=1)
    assert len(out) == 1 and out[0] is not None
    g = out[0]
    assert g.time.date() == datetime.date(2019, 7, 14)
    v = g.vcd[np.isfinite(g.vcd)]
    np.testing.assert_allclose(v, 1.2e-4 * 6.02214e19 * 1e-15, rtol=1e-5)
    sw = g.scattering_weights[0][np.isfinite(g.scattering_weights[0])]
    np.testing.assert_allclose(sw, 1.3, rtol=1e-3)  # AK * amf_total (f16 level-stack transfer)


def test_tempo_hcho(tmp_path):
    ny, nx = 150, 120
    # reuse the NO2 writer layout, add the HCHO variable names
    import h5py as _h5

    path = tmp_path / "TEMPO_HCHO_L2_20230905T180000.nc"
    write_tempo_no2(path)
    with _h5.File(path, "a") as f:
        f["product"]["vertical_column"] = np.full((ny, nx), 7.0e15)
        f["product"]["vertical_column_uncertainty"] = np.full((ny, nx), 2.0e15)
        f["support_data"]["amf"] = np.full((ny, nx), 1.6)
    out = tempo_reader(str(tmp_path), 18, "TEMPO_HCHO", CLON, CLAT, "202309",
                       trop=False, num_job=1)
    assert len(out) == 1 and out[0] is not None
    v = out[0].vcd[np.isfinite(out[0].vcd)]
    np.testing.assert_allclose(v, 7.0, rtol=1e-5)


def test_ssmis_raw_read_ignores_cf_scaling(tmp_path):
    """The reference reads SSMIS counts RAW (_read_ssmi, reader.py:28-34):
    flags 250-254 and the manual x0.3 are defined on raw counts, so CF
    scale_factor/add_offset attrs on a real RSS file must NOT be applied."""
    fname = tmp_path / "RSS_smoothed_201907v7.nc"
    ny, nx = 20, 30
    counts = np.full((ny, nx), 50.0)  # raw counts -> 15 mm after x0.3
    counts[0, 0] = 251.0  # land flag
    with h5py.File(fname, "w") as f:
        f["latitude"] = np.linspace(30.0, 49.0, ny)
        f["longitude"] = np.linspace(340.0, 369.0, nx) % 360.0
        d = f.create_dataset("atmosphere_water_vapor_content", data=counts)
        d.attrs["scale_factor"] = 0.3  # a CF-packed file: must be ignored
        d.attrs["add_offset"] = 0.0
    g = ssmis_reader(str(tmp_path), None, None, "201907", num_job=1)[0]
    assert np.isnan(g.vcd[0, 0])  # the flag survived to be masked
    finite = g.vcd[np.isfinite(g.vcd)]
    np.testing.assert_allclose(finite, 15.0, rtol=1e-6)  # x0.3 applied ONCE


def test_gosat_filler_keeps_placeholders_without_ak():
    """read_ak=False GOSAT granules carry size-1 AK placeholders; the filler
    must keep the sentinel instead of gridding uninitialized arrays."""
    import datetime

    from oisat.datamodel import satellite_opt
    from oisat.readers.sensors.gosat import filler_gosatxch4

    rng = np.random.default_rng(0)
    n = 200
    g = satellite_opt(
        vcd=np.abs(rng.normal(1800, 30, n)), time=datetime.datetime(2019, 7, 4),
        profile=[], tropopause=np.empty((1,)),
        latitude_center=rng.uniform(-60, 60, n),
        longitude_center=rng.uniform(-150, 150, n),
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.abs(rng.normal(10, 2, n)), quality_flag=np.ones(n),
        pressure_mid=np.empty((1,)), averaging_kernels=np.empty((1,)),
        aprior_column=np.zeros((1,)), apriori_profile=np.empty((1,)),
        surface_pressure=np.zeros((1,)), apriori_surface=np.zeros((1,)),
        x_col=np.abs(rng.normal(1800, 30, n)), pressure_weight=np.empty((1,)),
        sensor="GOSAT")
    out = filler_gosatxch4(1.0, g, flag_thresh=0.5)
    assert out is not None
    assert np.size(out.averaging_kernels) == 1  # sentinel preserved
    assert np.size(out.pressure_weight) == 1
    assert np.isfinite(out.x_col).sum() > 50


def test_tempo_reader_requires_hour():
    import pytest

    from oisat.readers.sensors.tempo import tempo_reader as tr

    with pytest.raises(ValueError, match="tempo_hour"):
        tr("/nonexistent", None, "TEMPO_NO2", None, None, "202309", True)
