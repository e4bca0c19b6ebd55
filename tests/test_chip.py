"""Card-only checks: the device numerics on an NVIDIA GPU against float64
references.  Every test takes the ``gpu`` fixture and skips without a card;
run them there with ``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``.

The dense full-covariance check is the one the CPU cannot make: at the
default precision a GPU may run f32 matrix products in TF32 (10-bit
mantissa), which this conditioning turns into increment errors far beyond
the tolerances below.
"""

import numpy as np
import pytest

import chip_smoke

pytestmark = pytest.mark.chip


def test_dense_oi_full_on_card_matches_f64(gpu):
    import jax.numpy as jnp

    from oisat.ops.oi_full import oi_full_dense

    pts = chip_smoke._regional_points(2048, seed=5)
    got = oi_full_dense(*(jnp.asarray(a, jnp.float32) for a in pts), 300.0)
    ref = chip_smoke._f64_dense_reference(*pts, 300.0)
    np.testing.assert_allclose(np.asarray(got[0], np.float64), ref[0],
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got[1], np.float64), ref[1],
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got[2], np.float64), ref[2],
                               rtol=0, atol=5e-4)


def test_covariance_on_card_matches_reference(gpu):
    from oisat.ops.covariance import build_covariance, build_covariance_reference

    pts = chip_smoke._regional_points(3000, seed=6)
    lat, lon, sig = pts[4], pts[5], pts[2]
    got = np.asarray(build_covariance(lat, lon, sig, 300.0))
    ref = build_covariance_reference(lat, lon, sig, 300.0)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(got, got.T)


def test_exact_tail_on_card_runs_in_device_f64(gpu):
    from oisat.ops import oi_full as mod

    res = mod.oi_full(*chip_smoke._tight_domain(30, seed=7), 300.0)
    assert res.info["solver"] == "dense+direct_f64_dev"
    assert res.info["f64_resid"] < mod.DEVICE_EXACT_RESID_GATE
    assert np.isfinite(res.xb).all()


def test_scalar_oi_on_card_matches_reference(gpu):
    import jax.numpy as jnp

    import bench
    from oisat.ops.oi import oi

    f32 = bench.make_fields(256, 512, dtype=np.float32)
    ref = bench.numpy_reference_oi(*(f.astype(np.float64) for f in f32))
    out = oi(*(jnp.asarray(f) for f in f32))
    assert int(out.reg_index) == int(ref[4])
    assert chip_smoke.rel_err(out.xb, ref[0]) <= 1e-4
    assert chip_smoke.field_rel_err(out.increment, ref[2]) <= 1e-4
