"""Device-side regrid application: gather + weighted sum, box filters.

The hot half of the reference's regridding (reference
oisatgmi/interpolator.py:100-291): once the host has built a
:class:`~oisat.ops.weights.SparsePlan`, every 2-D/3-D field of a granule
is moved onto the target grid by one batched gather + weighted reduction —
a single fused XLA op instead of a scipy call per field per level.

Also implements the reference's box-filter upscaling
(`_upscaler`, interpolator.py:48-97): smooth the fine grid with a
``(ky, kx)`` mean filter (scipy ``convolve2d(mode='same',
boundary='symm')`` semantics, even kernels included), then map onto the CTM
grid through a (static, precomputed) nearest-neighbour plan.  Error fields
use the squared kernel ``1/(ky*kx)^2`` (`_boxfilter2`, interpolator.py:44-46).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["apply_plan", "boxfilter_same_symm", "apply_plan_arrays", "pad_to_bucket"]


def pad_to_bucket(n: int, min_size: int = 1024, steps_per_octave: int = 1,
                  align: int = 1) -> int:
    """Geometric bucket for a ragged axis length.

    Axis lengths vary per file; padding to a fixed geometric grid of
    buckets bounds XLA recompiles to O(log) distinct shapes (SURVEY.md §7
    "hard parts" #2).  ``steps_per_octave=1`` is the power-of-two grid
    (worst-case 2x padding); transfer-bound paths use finer grids, since
    every padded byte is a host->device byte.
    The granule axis runs 4 steps per octave (2^(1/4) ~ 1.19 growth:
    worst-case 19%, typical ~9% padding); the pixel axis runs 8 steps
    (<=9% worst-case waste) but ONLY for the first pixel count seen per
    coarse region — later distinct counts escalate to the 4-step bucket
    (regridder._pixel_bucket) so variable-scan sensors (TEMPO truncated
    hours) compile at most 2 programs per region instead of 8 per
    octave.  ``align`` rounds every bucket up to a multiple (aligned
    vector widths for the pixel axis)."""
    import math

    if n <= min_size:
        return min_size
    k = math.ceil(steps_per_octave * math.log2(n / min_size) - 1e-9)
    b = math.ceil(min_size * 2 ** (k / steps_per_octave) - 1e-6)
    if align > 1:
        b = -(-b // align) * align
    if b < n:  # float-rounding safety: never bucket below the data
        b = -(-n // align) * align
    return b


@jax.jit
def apply_plan_arrays(z, idx, w, mask):
    """Apply sparse weights: ``out[..., t] = sum_k w[t,k] * z[..., idx[t,k]]``.

    ``z``: (..., Npix) source pixel values (NaN = bad — propagates exactly as
    the scipy interpolators do).  ``mask``: True -> NaN (too far / out of
    hull).  Returns (..., T).  Jitted: one dispatch per call instead of
    eager op-by-op dispatch.
    """
    vals = jnp.take(z, idx, axis=-1)  # (..., T, K)
    out = jnp.sum(vals * w.astype(z.dtype), axis=-1)
    return jnp.where(mask, jnp.nan, out)


def apply_plan(plan, z, bucket: bool = True):
    """Apply a host-built SparsePlan to ``z`` (..., Npix) -> (..., Ny, Nx).

    ``bucket=True`` NaN-pads the pixel axis to a power-of-two bucket so
    varying granule sizes reuse compiled programs.  Padding happens on host
    (NumPy): an eager device pad would itself compile one program per
    distinct shape — exactly what bucketing is here to avoid.  NOTE: a z
    that is ALREADY a device array is passed through unbucketed (padding
    it would be that same eager device pad); callers feeding ragged
    device-resident shapes must bucket upstream or accept per-shape
    compiles.

    A compacted plan (``plan.sel`` set, see ``weights.compact_plan``)
    gathers the referenced pixels first — on host for NumPy inputs
    (shrinking the transfer); a device-resident ``z`` takes a single
    fused gather+apply program (``sel`` rides in with the other plan
    arrays — no extra eager dispatch).
    """
    import numpy as _np

    if plan.sel is not None:
        if isinstance(z, jax.Array):
            out = _apply_plan_compact(z, jnp.asarray(plan.sel),
                                      jnp.asarray(plan.idx),
                                      jnp.asarray(plan.w),
                                      jnp.asarray(plan.mask))
            return out.reshape(z.shape[:-1] + plan.out_shape)
        z = _np.asarray(z)[..., plan.sel]
    if bucket and not isinstance(z, jax.Array):
        z = _np.asarray(z)
        n = z.shape[-1]
        b = pad_to_bucket(n, steps_per_octave=4, align=128)
        if b != n:
            pads = [(0, 0)] * (z.ndim - 1) + [(0, b - n)]
            z = _np.pad(z, pads, constant_values=_np.nan)
    z = jnp.asarray(z)
    out = apply_plan_arrays(
        z, jnp.asarray(plan.idx), jnp.asarray(plan.w), jnp.asarray(plan.mask)
    )
    return out.reshape(z.shape[:-1] + plan.out_shape)


@jax.jit
def _apply_plan_compact(z, sel, idx, w, mask):
    """Compacted-plan applier for device inputs: gather + apply, ONE program."""
    return apply_plan_arrays(jnp.take(z, sel, axis=-1), idx, w, mask)


@partial(jax.jit, static_argnames=("ky", "kx", "squared"))
def boxfilter_same_symm(z, ky: int, kx: int, squared: bool = False):
    """Box filter with scipy ``convolve2d(mode='same', boundary='symm')`` semantics.

    ``z``: (..., H, W).  ``squared=True`` uses the error-variance kernel
    ``ones/(ky*kx)**2`` (reference ``_boxfilter2``).  NaNs spread over the
    window exactly like the reference's convolution.
    """
    z = jnp.asarray(z)
    # 'same' centering of a full convolution: pad_lo = k//2, pad_hi = (k-1)//2
    pads = [(0, 0)] * (z.ndim - 2) + [(ky // 2, (ky - 1) // 2), (kx // 2, (kx - 1) // 2)]
    zp = jnp.pad(z, pads, mode="symmetric")
    window = (1,) * (z.ndim - 2) + (ky, kx)
    s = lax.reduce_window(zp, jnp.zeros((), z.dtype), lax.add, window, (1,) * z.ndim, "valid")
    denom = (ky * kx) ** 2 if squared else (ky * kx)
    return s / jnp.asarray(denom, z.dtype)
