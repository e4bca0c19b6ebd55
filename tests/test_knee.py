import numpy as np
import jax.numpy as jnp
import pytest

from oisat.ops.knee import kneedle_index, kneedle_index_np


def curves():
    x = np.arange(0.1, 10.0, 0.1)
    out = []
    # Kalman-gain-like concave increasing curves (the real OI shape)
    for a in [0.05, 0.3, 1.0, 5.0, 20.0]:
        out.append((x, x / (x + a)))
    # noisy concave curve
    rng = np.random.default_rng(0)
    out.append((x, x / (x + 1.0) + 0.01 * rng.standard_normal(x.size)))
    # straight line (no knee: difference curve ~ 0)
    out.append((x, 2.0 * x + 1.0))
    # convex increasing (wrong curvature for 'concave' detection)
    out.append((x, x**2))
    # plateaus
    out.append((x, np.minimum(x, 3.0)))
    return out


@pytest.mark.parametrize("i", range(len(curves())))
def test_jax_matches_numpy(i):
    x, y = curves()[i]
    np_idx = kneedle_index_np(x, y)
    jx_idx = int(kneedle_index(jnp.asarray(x), jnp.asarray(y)))
    assert np_idx == jx_idx


def test_knee_location_sane():
    # for y = x/(x+a) the knee must sit in the bend region: curvature max at
    # small x for small a
    x = np.arange(0.1, 10.0, 0.1)
    idx_small = kneedle_index_np(x, x / (x + 0.3))
    idx_large = kneedle_index_np(x, x / (x + 5.0))
    assert 0 < idx_small < idx_large < x.size - 1


def test_fallback_on_nan_curve():
    x = np.arange(0.1, 10.0, 0.1)
    y = np.full_like(x, np.nan)
    assert kneedle_index_np(x, y) == 0
    assert int(kneedle_index(jnp.asarray(x), jnp.asarray(y))) == 0


def test_fallback_constant_curve():
    x = np.arange(0.1, 10.0, 0.1)
    y = np.ones_like(x)
    with np.errstate(invalid="ignore"):
        np_idx = kneedle_index_np(x, y)
    assert np_idx == 0
    assert int(kneedle_index(jnp.asarray(x), jnp.asarray(y))) == 0


def test_fuzz_jax_matches_numpy():
    """50 random monotone-ish curves: the lax.scan state machine must track
    the NumPy implementation exactly (knee index or shared fallback)."""
    rng = np.random.default_rng(42)
    x = np.arange(0.1, 10.0, 0.1)
    for i in range(50):
        kind = i % 5
        if kind == 0:  # concave increasing, random curvature
            a = rng.uniform(0.01, 30.0)
            y = x / (x + a)
        elif kind == 1:  # noisy concave
            y = x / (x + rng.uniform(0.1, 5.0)) + rng.normal(0, 0.02, x.size)
        elif kind == 2:  # piecewise with plateaus
            y = np.minimum(x * rng.uniform(0.5, 2.0), rng.uniform(1, 8))
        elif kind == 3:  # random walk, sorted (monotone, irregular)
            y = np.sort(np.cumsum(rng.normal(0.1, 1.0, x.size)))
        else:  # oscillating difference curve
            y = x / (x + 1.0) + 0.05 * np.sin(x * rng.uniform(1, 6))
        np_idx = kneedle_index_np(x, y)
        jx_idx = int(kneedle_index(jnp.asarray(x), jnp.asarray(y)))
        assert np_idx == jx_idx, (i, kind, np_idx, jx_idx)


def _corpus():
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "golden", "knee_corpus.json")
    with open(path) as f:
        data = json.load(f)
    return data["entries"]


@pytest.mark.parametrize("entry", _corpus(), ids=lambda e: e["name"])
def test_kneed_corpus(entry):
    """Both production Kneedle implementations must reproduce the frozen
    kneed-semantics corpus (tests/golden/knee_corpus.json, generated by
    tests/make_knee_corpus.py from the kneed spec transcription with
    analytic cross-checks; VERDICT r1 item 4)."""
    x = np.asarray(entry["x"], np.float64)
    y = np.asarray([np.nan if v is None else v for v in entry["y"]], np.float64)
    want = entry["expected_index"]
    with np.errstate(invalid="ignore"):
        got_np = kneedle_index_np(x, y)
    assert got_np == want, f"numpy impl: {got_np} != {want} ({entry['derivation']})"
    got_jx = int(kneedle_index(jnp.asarray(x), jnp.asarray(y)))
    assert got_jx == want, f"jax impl: {got_jx} != {want} ({entry['derivation']})"


def test_corpus_regenerates_identically():
    """The corpus generator (spec transcription + analytic assertions) must
    still produce exactly the frozen data — guards silent drift in either."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from make_knee_corpus import build_corpus

    frozen = _corpus()
    fresh = build_corpus()
    assert len(fresh) == len(frozen)
    for a, b in zip(fresh, frozen):
        assert a["name"] == b["name"]
        assert a["expected_index"] == b["expected_index"], a["name"]


def test_kneedle_np_guards_unsorted_and_flat_curves():
    """Unsorted x must not read past the array (the x_n==1 stop can be
    skipped); a flat curve returns the fallback without a 0/0 warning."""
    import warnings

    from oisat.ops.knee import kneedle_index_np

    assert kneedle_index_np(np.array([10.0, 1, 2, 3, 4]),
                            np.array([0.0, 1, 2, 3, 4]), fallback=0) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert kneedle_index_np(np.arange(5.0), np.ones(5), fallback=0) == 0


def test_external_kneed_corpus_validation_pending():
    """CI-visible marker (VERDICT r4 #8): tests/golden/knee_corpus.json has
    never been validated against a real `kneed.KneeLocator` (the package
    is not installed and the environment has no network).  When a network
    window exists: `pip install kneed`, re-run tests/make_knee_corpus.py
    with --validate-kneed, update PARITY.md's pending row, then delete
    this skip."""
    import importlib.util
    import sys

    # the differential tests stub `kneed` into sys.modules (backed by our
    # own Kneedle) — only a REAL installed package counts here
    mod = sys.modules.get("kneed")
    real = getattr(mod, "__file__", None) is not None if mod is not None \
        else importlib.util.find_spec("kneed") is not None
    if not real:
        import pytest

        pytest.skip("network-gated: real kneed not installed; corpus "
                    "validated only against the kneed-spec reimplementation")
    import json
    import pathlib

    from kneed import KneeLocator

    corpus = json.loads((pathlib.Path(__file__).parent / "golden" /
                         "knee_corpus.json").read_text())
    for case in corpus["entries"]:
        x = np.asarray(case["x"], np.float64)
        y = np.asarray(case["y"], np.float64)
        kl = KneeLocator(x, y, S=corpus["S"], curve=corpus["curve"],
                         direction=corpus["direction"],
                         online=corpus["online"])
        expected = case["expected_index"]
        got = -1 if kl.knee is None else int(np.argwhere(x == kl.knee)[0][0])
        assert got == expected, case["name"]
