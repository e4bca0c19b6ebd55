"""The shipped example must stay runnable (it is the first thing a
switching user tries)."""

import runpy
import sys
from pathlib import Path

import numpy as np


def test_synthetic_month_example(tmp_path, monkeypatch):
    repo = Path(__file__).resolve().parent.parent
    # nested path: the example must create missing parents, not crash
    out = tmp_path / "nested" / "demo"
    monkeypatch.setattr(sys, "argv",
                        ["synthetic_month.py", "--granules", "2",
                         "--out", str(out)])
    runpy.run_path(str(repo / "examples" / "synthetic_month.py"),
                   run_name="__main__")
    assert (out / "demo_201907.nc").exists()
    assert (out / "OI_report_NO2_201907_demo.pdf").exists()
    mats = list((out / "daily").glob("sat_data_NO2_*.mat"))
    assert len(mats) == 2
    from oisat.ncwriter import read_diag_nc

    fields, tstr = read_diag_nc(out / "demo_201907.nc")
    assert tstr.startswith("2019-07")
    assert np.isfinite(fields["scaling_factor"]).all()


def test_synthetic_month_example_fused_daily(tmp_path, monkeypatch):
    """--fused must write the SAME daily .mat content shape as the staged
    path: post-operator vcd and a populated vcd_ctm (a raw device granule
    has ctm_vcd=[] — dumping those was a shipped bug)."""
    import scipy.io as sio

    repo = Path(__file__).resolve().parent.parent
    out = tmp_path / "demo_fused"
    monkeypatch.setattr(sys, "argv",
                        ["synthetic_month.py", "--granules", "2",
                         "--fused", "--out", str(out)])
    runpy.run_path(str(repo / "examples" / "synthetic_month.py"),
                   run_name="__main__")
    mats = sorted((out / "daily").glob("sat_data_NO2_*.mat"))
    assert len(mats) == 2
    for m in mats:
        d = sio.loadmat(str(m))
        assert d["vcd_ctm"].size > 0, "fused daily dump lost the CTM column"
        assert np.isfinite(d["vcd_ctm"]).any()
        assert d["vcd_sat"].shape == d["vcd_ctm"].shape
