"""Frozen end-to-end regression: the synthetic golden month must reproduce.

Guards future refactors against silent numeric drift.  The golden was
generated on the CPU backend in float64 (tests/golden/month_no2.npz); any
intentional numerics change must regenerate it (see the script in the file
history / run the body of this test with SAVE=1).
"""

import os
from types import SimpleNamespace

import numpy as np

from oisat.driver import oisatgmi
from oisat.regridder import regrid_granule
from tests.test_pipeline import ctm_grid, synthetic_ctm, synthetic_granule

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "month_no2.npz")


def compute():
    clon, clat = ctm_grid()
    ctm = synthetic_ctm()
    # parity mode: the golden froze the reference-parity (qhull) numerics
    granules = [regrid_granule(1, 0.25, synthetic_granule(s, 4 + s), clon, clat,
                               flag_thresh=0.5, dtype=np.float64, fast_swath=False)
                for s in range(4)]
    obj = oisatgmi()
    obj.reader_obj = SimpleNamespace(ctm_data=[ctm], sat_data=granules)
    obj.recal_amf()
    obj.average("2019-07-01", "2019-08-01")
    obj.bias_correct("OMI", "NO2")
    obj.oi("OMI")
    return obj


def test_golden_month_reproduces(monkeypatch):
    monkeypatch.setenv("OISAT_F16_TRANSFER", "0")  # golden froze full-precision numerics
    obj = compute()
    g = np.load(GOLDEN)
    np.testing.assert_allclose(obj.sat_averaged_vcd, g["sat_vcd"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(obj.ctm_averaged_vcd_corrected, g["posterior"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(obj.ak_OI, g["ak"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(obj.error_OI, g["error"], rtol=1e-9, atol=1e-12)
