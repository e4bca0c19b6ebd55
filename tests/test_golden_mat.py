"""Validation against the reference's only numeric artifact:
``run/out_omps_upscale.mat`` — an (81, 161) ``vcd``/``upscaled_X``/
``upscaled_Y`` dump of the OMPS upscale path (reference
interpolator.py:48-97; SURVEY.md §7 build-order step 3).

The fixture's ``vcd`` is entirely NaN (the OMPS granule that produced it
missed the saved domain), so the checkable content is the *geometry*: the
exact fine→coarse grid the reference produced for the OMPS recipe
(grid_size = 0.5°) over a [-135, -55] × [20, 60] CTM domain.  Both the
``fine_grid`` construction (reference interpolator.py:136-143 arange
semantics) and the ``_upscaler`` grid choice (reference
interpolator.py:48-97) must reproduce it bit-for-bit.
"""

import os

import numpy as np
import pytest

from oisat.ops.weights import diag_threshold, fine_grid
from oisat.regridder import make_upscaler, regrid_granule

MAT = "/root/reference/run/out_omps_upscale.mat"

pytestmark = pytest.mark.skipif(not os.path.exists(MAT),
                                reason="reference golden fixture not present")


def _fixture():
    from scipy.io import loadmat

    m = loadmat(MAT)
    return m["upscaled_X"], m["upscaled_Y"], m["vcd"]


def _domain_ctm(step):
    """A CTM grid spanning the fixture's exact domain bounds."""
    lon = np.arange(-135.0, -55.0 + step / 2, step)
    lat = np.arange(20.0, 60.0 + step / 2, step)
    return np.meshgrid(lon, lat)


def test_fine_grid_reproduces_golden_geometry():
    gx, gy, _ = _fixture()
    assert gx.shape == (81, 161)
    clon, clat = _domain_ctm(1.0)  # any CTM spacing with these bounds
    lons, lats = fine_grid(clon, clat, grid_size=0.5)  # OMPS recipe: 0.5°
    np.testing.assert_array_equal(lons, gx)
    np.testing.assert_array_equal(lats, gy)


def test_upscaler_grid_choice_matches_golden():
    gx, gy, _ = _fixture()
    # CTM coarser than the 0.5° sat grid -> upscale onto the CTM grid,
    # which for a 0.5° CTM is exactly the fixture grid
    clon, clat = _domain_ctm(0.5)
    lons, lats = fine_grid(clon, clat, grid_size=0.5)
    up = make_upscaler(lons, lats, clon, clat, grid_size=0.5,
                       threshold=diag_threshold(clon, clat))
    assert up.needed is False and (up.ky, up.kx) == (1, 1)
    np.testing.assert_array_equal(up.out_lon, gx)
    np.testing.assert_array_equal(up.out_lat, gy)
    # CTM finer than the sat grid -> pass-through of the fine grid
    # (reference interpolator.py:94-97), still the fixture geometry
    clon2, clat2 = _domain_ctm(0.25)
    lons2, lats2 = fine_grid(clon2, clat2, grid_size=0.5)
    up2 = make_upscaler(lons2, lats2, clon2, clat2, grid_size=0.5,
                        threshold=diag_threshold(clon2, clat2))
    assert up2.needed is True
    np.testing.assert_array_equal(up2.out_lon, gx)
    np.testing.assert_array_equal(up2.out_lat, gy)


def _omps_orbit(seed=0, ny=160, nx=36):
    """A synthetic OMPS-shaped orbit crossing the fixture domain."""
    from oisat.datamodel import satellite_amf

    rng = np.random.default_rng(seed)
    along = np.linspace(22.0, 58.0, ny)[:, None]
    across = np.linspace(-112.0, -94.0, nx)[None, :]
    lat = along + 0.05 * rng.standard_normal((ny, nx))
    lon = across + 4.0 * np.sin(np.linspace(0, 2.2, ny))[:, None] + 0.05 * rng.standard_normal((ny, nx))
    vcd = 2.0 + np.sin(lon / 7.0) * np.cos(lat / 9.0)
    return satellite_amf(
        vcd=vcd, amf=np.full((ny, nx), 1.3), time=None,
        tropopause=np.empty(1), latitude_center=lat, longitude_center=lon,
        latitude_corner=[], longitude_corner=[],
        uncertainty=np.full((ny, nx), 0.5),
        quality_flag=np.ones((ny, nx)), pressure_mid=np.empty(1),
        scattering_weights=np.empty(1), ctm_upscaled_needed=False,
        ctm_vcd=[], ctm_time_at_sat=[], old_amf=[], new_amf=[],
    )


def test_fast_vs_parity_on_omps_orbit():
    """The default-on native fast path agrees with the qhull parity path on
    the fixture's own geometry: identical NaN-coverage up to the
    triangulation-dependent hull fringe, small value differences only (the
    two triangulations split quads along different diagonals)."""
    clon, clat = _domain_ctm(1.0)
    g = _omps_orbit()
    parity = regrid_granule(1, 0.5, _omps_orbit(), clon, clat,
                            flag_thresh=0.0, dtype=np.float64, fast_swath=False)
    fast = regrid_granule(1, 0.5, g, clon, clat,
                          flag_thresh=0.0, dtype=np.float64, fast_swath=True)
    assert parity is not None and fast is not None
    a, b = np.asarray(fast.vcd), np.asarray(parity.vcd)
    both = np.isfinite(a) & np.isfinite(b)
    assert both.sum() > 300
    np.testing.assert_allclose(a[both], b[both], atol=2e-3, rtol=2e-3)
    # coverage differs only on the hull fringe
    assert (np.isfinite(a) ^ np.isfinite(b)).mean() < 0.02
