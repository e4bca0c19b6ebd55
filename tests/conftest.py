"""Test configuration: run JAX on a virtual 8-device CPU mesh.

``xla_force_host_platform_device_count`` gives the CPU backend 8 devices,
so every sharded code path executes (collectives included) without a
multi-card host.  Numerics tests enable x64 so goldens agree with float64
NumPy references; dedicated f32 tests cover the device dtype policy.

The platform is ``JAX_PLATFORMS`` when set, else the CPU.  Tests marked
``chip`` need an NVIDIA GPU and skip elsewhere (the ``gpu`` fixture decides
at run time); run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_oisat_env(monkeypatch):
    """run_month pins OISAT_* process-wide (deliberate in production so a
    parity month can't leak into later months); tests must not inherit a
    previous test's pins."""
    for k in ("OISAT_PARITY", "OISAT_F16_TRANSFER", "OISAT_FAST_SWATH",
              "OISAT_DEVICE_GRANULES"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def gpu():
    """The GPU devices, or a skip: decided when the test runs, never while
    modules are collected, so every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "JAX_PLATFORMS=cuda python -m pytest -m chip tests/")
    return jax.devices()
