"""Optimal-interpolation (OI) analysis update — the core kernel.

Re-implements the reference's per-grid-cell scalar Kalman update
(reference oisatgmi/optimal_interpolation.py:6-52) as a fully-jitted,
shardable JAX computation:

    for each regularization factor r in 0.1..9.9 (99 values):
        K_r  = Sa*r / (Sa*r + So)                    (Kalman gain)
        Sb_r = (1 - K_r) * Sa * r                    (posterior variance)
        AK_r = 1 - Sb_r / (Sa*r)                     (averaging kernel)
        curve[r] = nanmean(AK_r)
    r* = Kneedle knee of (r, curve)   (fallback: first r)
    increment = K_{r*} * (Y - Xa);  Xb = Xa + increment
    returns (Xb, AK_{r*}, increment, sqrt(Sb_{r*}))

Semantics preserved exactly (NaN propagation included):
  * negative observations are clamped to 0 (NaN stays NaN) — reference :14,
  * AK is computed *literally* as ``1 - Sb/(Sa*r)`` so that cells with
    ``Sa == 0`` yield NaN (0/0) rather than the algebraically-equal K — the
    NaN pattern feeds the nanmean curve and therefore the knee choice,
  * the regularization grid is ``np.arange(0.1, 10, 0.1)`` evaluated in
    float64 once (99 points) and cast — reference :16-17,
  * no-knee fallback is the first factor — reference :39-43.

Shape: the division by ``Sa`` and the cell validity are hoisted out of
the factor loop (``AK_r = r/(r + So/Sa)``, :func:`curve_inputs` — both
are factor-independent), then the curve is built by a ``lax.scan`` over
the 99 factors (no (99, H, W) materialization; XLA fuses the whole loop
over one read of ``u``) and the chosen factor's fields are computed in
one fused elementwise pass.  The cell dimension is embarrassingly
parallel: under ``jit`` with a sharded mesh the per-factor reductions
become cross-device sums automatically.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from oisat.ops.knee import kneedle_index

__all__ = ["OIResult", "regularization_grid", "oi", "ak_curve"]


def regularization_grid() -> np.ndarray:
    """The reference's 99-point regularization scan grid (float64)."""
    return np.arange(0.1, 10.0, 0.1)


class OIResult(NamedTuple):
    """Outputs of the OI update (field shapes match the inputs)."""

    xb: jax.Array  # posterior state
    averaging_kernel: jax.Array  # AK at the chosen factor
    increment: jax.Array  # K * (Y - Xa)
    error: jax.Array  # sqrt(posterior variance)
    reg_index: jax.Array  # int32 index into the regularization grid
    reg_factor: jax.Array  # the chosen factor value
    curve: jax.Array  # mean-AK curve over the grid (for diagnostics)


def _kalman_terms(sa: jax.Array, so: jax.Array, reg: jax.Array):
    """K, Sb, AK for one regularization factor.

    ``Sb`` uses the numerically-stable product form
    ``Sa*r*So / (Sa*r + So)`` — algebraically identical to the reference's
    ``(1-K)*Sa*r`` but immune to the ``K -> 1`` cancellation that destroys
    float32 accuracy when ``So << Sa*r``.  NaN semantics match: ``Sa == 0``
    still yields ``Sb = 0`` and ``AK = 1 - 0/0 = NaN``; ``So == inf``
    (an unusable observation) needs an explicit guard — the product form's
    ``inf/inf`` would NaN the cell, but the reference computes ``K = 0``,
    ``Sb = Sa*r``, ``AK = 0`` and keeps it in the mean-AK curve (as does
    :func:`ak_curve`; the curve and the chosen fields must agree).
    """
    sar = sa * reg
    denom = sar + so
    k = sar / denom
    ratio = jnp.where(jnp.isinf(so), jnp.ones_like(so), so / denom)
    sb = sar * ratio
    ak = 1.0 - sb / sar
    return k, sb, ak


def curve_inputs(sa: jax.Array, so: jax.Array):
    """``(u, valid)`` for the mean-AK curve, hoisted out of the factor loop.

    For ``r > 0`` and variances ``>= 0`` the averaging kernel reduces to
    ``AK_r = Sa·r/(Sa·r + So) = r/(r + u)`` with ``u = So/Sa`` — so both
    the per-cell division-by-``Sa`` and the validity of a cell are
    *factor-independent* and can be computed once for all 99 factors:

    * invalid cells — NaN ``Sa``/``So``, ``Sa == 0`` (whose literal
      ``1 - 0/0`` the reference NaNs, reference
      optimal_interpolation.py:26-33) and ``Sa == inf`` — get ``u = +inf``
      so they contribute ``r/inf = 0`` to the factor sums and are excluded
      by the count;
    * ``So == inf`` (an unusable observation) stays VALID with
      ``AK = r/(r+inf) = 0``, kept in the curve mean exactly like the
      reference (see :func:`_kalman_terms`).

    Contract: variances must be ``>= 0`` (or NaN/inf).  A *negative*
    finite ``Sa``/``So`` — physically impossible — could make ``r + u``
    vanish for one factor, which the per-factor ``isfinite`` of the old
    formulation excluded and this hoisted form does not."""
    valid = jnp.isfinite(sa) & (sa != 0) & ~jnp.isnan(so)
    u = jnp.where(valid, so / sa, jnp.inf)
    return u, valid


def ak_curve(sa: jax.Array, so: jax.Array, regs: jax.Array) -> jax.Array:
    """Mean-AK-vs-regularization curve via a scan (no (R, ...) blowup).

    Uses the hoisted ``r/(r + So/Sa)`` form (:func:`curve_inputs`): one
    division by ``Sa`` and one validity count total, then one add + one
    division per (cell, factor)."""
    u, valid = curve_inputs(sa, so)
    c = jnp.sum(valid)

    def body(carry, reg):
        return carry, jnp.sum(reg / (reg + u))

    _, s = jax.lax.scan(body, None, regs)
    return jnp.where(c > 0, s / c, jnp.nan)


def oi(
    xa: jax.Array,
    y: jax.Array,
    sa: jax.Array,
    so: jax.Array,
    regularization_on: bool = True,
) -> OIResult:
    """OI update. ``xa``: prior, ``y``: obs, ``sa``/``so``: error variances.

    All inputs share one shape; NaN marks missing cells and propagates.
    ``regularization_on`` is static (two trace variants); the curve comes
    from :func:`ak_curve`.
    """
    dtype = jnp.result_type(xa, y, sa, so)
    xa = xa.astype(dtype)
    y = y.astype(dtype)
    sa = sa.astype(dtype)
    so = so.astype(dtype)

    # CTM-meaningless negative observations -> 0 (NaN preserved).
    y = jnp.where(y < 0, jnp.zeros_like(y), y)

    if regularization_on:
        regs_np = regularization_grid()
    else:
        regs_np = np.array([1.0])
    regs = jnp.asarray(regs_np, dtype=dtype)

    curve = ak_curve(sa, so, regs)
    if regularization_on:
        reg_index = kneedle_index(jnp.asarray(regs_np, jnp.float64 if jax.config.jax_enable_x64 else jnp.float32), curve, fallback=0)
    else:
        reg_index = jnp.asarray(0, dtype=jnp.int32)
    reg = regs[reg_index]

    k, sb, ak = _kalman_terms(sa, so, reg)
    increment = k * (y - xa)
    xb = xa + increment
    return OIResult(
        xb=xb,
        averaging_kernel=ak,
        increment=increment,
        error=jnp.sqrt(sb),
        reg_index=reg_index,
        reg_factor=reg,
        curve=curve,
    )
