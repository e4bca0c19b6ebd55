"""Spec-faithful transcription of ``kneed.KneeLocator`` (v0.8.x) for the
configuration the reference uses (reference
oisatgmi/optimal_interpolation.py:37-43):

    KneeLocator(x, y, direction='increasing')
    # i.e. S=1.0, curve='concave', interp_method='interp1d', online=False

``kneed`` is not installable in this environment, so this module is a
line-by-line re-derivation of its published algorithm (Satopaa et al. 2011
+ the kneed source structure), kept deliberately separate from the
production implementations in :mod:`oisat.ops.knee`.  It exists only to
*generate* the frozen corpus in ``tests/golden/knee_corpus.json`` (see
``tests/make_knee_corpus.py``); the production code is then tested against
the frozen data, giving three independent implementations that must agree.

Transcription notes (kneed source, KneeLocator.__init__/find_knee):
  * ``Ds_y = interp1d(x, y)(x)`` is the identity for interp_method
    'interp1d' evaluated on its own knots, so it is omitted.
  * normalization: ``(a - a.min()) / (a.max() - a.min())``.
  * ``transform_y`` is the identity for (concave, increasing).
  * extrema: ``scipy.signal.argrelextrema(y_d, np.greater_equal)`` /
    ``np.less_equal`` — the very calls kneed makes (order=1, mode='clip',
    so boundary points self-compare and can be extrema).
  * thresholds: ``Tmx = y_d[maxima] - S * |diff(x_n).mean()|``.
  * the offline walk: start at the first maximum, reset the threshold at
    each maximum (Tmx) and each minimum (0), trigger when the *next*
    difference value drops below the current threshold, knee = the x value
    at the most recent maximum; stop at x_n == 1.0.
  * no maxima or no trigger -> knee is None.

The reference then maps the knee x-value back to an index with
``np.argwhere(x == kneedle.knee)`` and falls back to index 0 when empty
(optimal_interpolation.py:39-43); :func:`knee_index_reference` reproduces
that mapping.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import argrelextrema


def kneed_knee_value(x: np.ndarray, y: np.ndarray, S: float = 1.0):
    """The knee x-value kneed would report, or None (concave/increasing,
    offline, interp_method='interp1d')."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.size
    if n < 2:
        return None
    with np.errstate(invalid="ignore", divide="ignore"):
        x_n = (x - x.min()) / (x.max() - x.min())
        y_n = (y - y.min()) / (y.max() - y.min())
    y_d = y_n - x_n
    x_d = x_n

    maxima_indices = argrelextrema(y_d, np.greater_equal)[0]
    minima_indices = argrelextrema(y_d, np.less_equal)[0]
    if maxima_indices.size == 0:
        return None
    Tmx = y_d[maxima_indices] - (S * np.abs(np.diff(x_n).mean()))

    knee = None
    maxima_threshold_index = 0
    threshold = 0.0
    threshold_index = 0
    for i, xv in enumerate(x_d):
        if i < maxima_indices[0]:
            continue
        j = i + 1
        if xv == 1.0:
            break
        if (maxima_indices == i).any():
            threshold = Tmx[maxima_threshold_index]
            threshold_index = i
            maxima_threshold_index += 1
        if (minima_indices == i).any():
            threshold = 0.0
        if y_d[j] < threshold:
            # curve='concave', direction='increasing'
            knee = x[threshold_index]
            break  # online=False
    return knee


def knee_index_reference(x: np.ndarray, y: np.ndarray, S: float = 1.0) -> int:
    """Index the reference's OI would use: kneed knee x-value mapped back by
    ``argwhere(x == knee)``, empty -> 0 (optimal_interpolation.py:39-43)."""
    x = np.asarray(x, dtype=np.float64)
    knee = kneed_knee_value(x, y, S=S)
    hits = np.argwhere(x == knee)
    if hits.size == 0:
        return 0
    return int(hits[0, 0])
