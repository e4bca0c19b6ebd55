"""Failure-path behavior: corrupt files, empty months, all-bad QA."""

import numpy as np
import pytest

from oisat.ops.averaging import averaging
from oisat.readers.sensors import omi_reader
from tests.test_sensors import CLAT, CLON, write_omi_no2


def test_empty_month_raises_cleanly(tmp_path):
    out = omi_reader(str(tmp_path), "OMI_NO2", CLON, CLAT, "201907", trop=True)
    assert out == []
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="no valid satellite granules"):
        averaging("2019-07-01", "2019-08-01", SimpleNamespace(sat_data=out))


def test_corrupt_file_becomes_none(tmp_path):
    # one good file, one garbage file (>100 bytes so it passes the size prune)
    write_omi_no2(tmp_path / "OMI-Aura_L2-OMNO2_2019m0710.nc")
    (tmp_path / "OMI-Aura_L2-OMNO2_2019m0711.nc").write_bytes(b"x" * 500)
    out = omi_reader(str(tmp_path), "OMI_NO2", CLON, CLAT, "201907", trop=True)
    assert len(out) == 2
    assert sum(g is not None for g in out) == 1


def test_tiny_file_pruned(tmp_path):
    (tmp_path / "OMI-Aura_L2-OMNO2_2019m0712.nc").write_bytes(b"x" * 10)
    out = omi_reader(str(tmp_path), "OMI_NO2", CLON, CLAT, "201907", trop=True)
    assert out == []


def test_all_bad_qa_granule_skipped(tmp_path):
    import h5py

    write_omi_no2(tmp_path / "OMI-Aura_L2-OMNO2_2019m0710.nc")
    with h5py.File(tmp_path / "OMI-Aura_L2-OMNO2_2019m0710.nc", "a") as f:
        f["ANCILLARY_DATA"]["CloudFraction"][...] = 0.9  # everything cloudy
    out = omi_reader(str(tmp_path), "OMI_NO2", CLON, CLAT, "201907", trop=True)
    # all-NaN vcd -> granule rejected (reference interpolator.py:165-167)
    assert out == [None]


def test_upscaler_cache_bounded():
    """A campaign of per-granule geometries (e.g. TEMPO L2) must not grow the
    CTM->sat upscaler cache without bound."""
    from types import SimpleNamespace

    from oisat import obs_operators as oo

    ctm_lon, ctm_lat = np.meshgrid(np.arange(-10.0, 10.0, 2.0),
                                   np.arange(30.0, 50.0, 2.0))
    ctm = [SimpleNamespace(longitude=ctm_lon, latitude=ctm_lat)]
    oo._upscaler_cache.clear()
    for k in range(oo._upscaler_cache.maxsize + 20):
        # distinct geometry per granule: shifted fine sat grids
        s = 0.01 * k
        slon, slat = np.meshgrid(np.arange(-5.0 + s, 5.0 + s, 0.5),
                                 np.arange(35.0 + s, 45.0 + s, 0.5))
        g = SimpleNamespace(longitude_center=slon, latitude_center=slat)
        up = oo._ctm_to_sat_upscaler(ctm, g)
        assert up is not None
        assert len(oo._upscaler_cache) <= oo._upscaler_cache.maxsize
    # LRU: re-requesting the most recent geometry hits the cache
    before = len(oo._upscaler_cache)
    assert oo._ctm_to_sat_upscaler(ctm, g) is up
    assert len(oo._upscaler_cache) == before
