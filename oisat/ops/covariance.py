"""Distance-decay background-error covariance.

``B[i, j] = sigma_i * sigma_j * exp(-d_ij^2 / (2 L^2))`` with ``d`` the
*chordal* distance ``2 R sqrt(hav)`` (km).  Chordal rather than great-circle
for two reasons: the Gaussian kernel of the chordal (Euclidean) distance is
provably positive definite on the sphere (the arc-length Gaussian is not),
and it needs no inverse trig.  The two agree to <1% for separations within
~2000 km, where the decay lives.

This is the upgrade of the reference's diagonal-B assumption (BASELINE.json
north star).  The builder is one broadcasted elementwise expression: XLA
fuses it into a single loop that reads the three coordinate vectors and
writes the N x N matrix once (N^2 * 4 bytes, its whole cost).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["build_covariance", "build_covariance_reference", "EARTH_RADIUS_KM"]

EARTH_RADIUS_KM = 6371.0


@partial(jax.jit, static_argnames=("length_scale_km",))
def build_covariance(lat_deg, lon_deg, sigma, length_scale_km: float):
    """B (N, N) in float32 from degree coordinates and per-cell background
    std.  Any N; padding cells carry ``sigma = 0`` and produce zero
    covariance rows/columns."""
    lat = jnp.asarray(lat_deg, jnp.float32)
    lon = jnp.asarray(lon_deg, jnp.float32)
    sig = jnp.asarray(sigma, jnp.float32)
    # half-angle differences taken in degrees and scaled after the abs:
    # |x_i - x_j| is exactly symmetric in IEEE arithmetic and no multiply
    # precedes the subtraction, so no fused multiply-add can round (i, j)
    # and (j, i) differently — B comes out bitwise symmetric
    half = 0.5 * np.pi / 180.0
    sdlat = jnp.sin(half * jnp.abs(lat[:, None] - lat[None, :]))
    sdlon = jnp.sin(half * jnp.abs(lon[:, None] - lon[None, :]))
    coslat = jnp.cos(jnp.deg2rad(lat))
    a = sdlat * sdlat + (coslat[:, None] * coslat[None, :]) * (sdlon * sdlon)
    # chordal distance: d^2 = (2R)^2 * hav  (no sqrt/asin needed for d^2)
    d2 = (4.0 * EARTH_RADIUS_KM * EARTH_RADIUS_KM) * jnp.clip(a, 0.0, 1.0)
    decay = jnp.exp(-d2 / (2.0 * length_scale_km * length_scale_km))
    return sig[:, None] * sig[None, :] * decay


def build_covariance_reference(lat_deg, lon_deg, sigma, length_scale_km):
    """NumPy float64 reference for tests."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    sdlat = np.sin(0.5 * (lat[:, None] - lat[None, :]))
    sdlon = np.sin(0.5 * (lon[:, None] - lon[None, :]))
    a = sdlat**2 + np.cos(lat[:, None]) * np.cos(lat[None, :]) * sdlon**2
    d2 = (2.0 * EARTH_RADIUS_KM) ** 2 * np.clip(a, 0, 1)
    sig = np.asarray(sigma, np.float64)
    return sig[:, None] * sig[None, :] * np.exp(-d2 / (2 * length_scale_km**2))
