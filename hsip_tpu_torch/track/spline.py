"""Smoothing-spline position predictor with FITPACK-exact semantics.

The reference predicts flame positions (for plots and search-window hints)
with ``scipy.interpolate.UnivariateSpline(frames, positions,
s=spline_smoothing*len, k=min(3, m-1))`` and silently falls back to "no
spline" on any fit failure (``scripts/process_videos.py:287-315``). The
runtime here is numpy+jax (scipy is a test-only dependency), so the fit is
provided by :mod:`hsip_tpu.track.fitpack` — a numpy port of FITPACK's
``curfit`` whose knot vectors and coefficients match scipy's to
floating-point accuracy (validated against ``UnivariateSpline`` across a
randomized corpus in ``tests/test_tracker.py``).

``final_position`` never consumes the spline (reference behavior), so this
module is plot/prediction-only and always runs lazily on host — an
every-frame refit would make the tracking scan O(N²).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .fitpack import FitpackError, curfit, splev

__all__ = ["SmoothingSpline", "fit_smoothing_spline"]


class SmoothingSpline:
    """Fitted b-spline ``(t, c, k)``, callable like ``UnivariateSpline``.

    Evaluation outside the data interval extrapolates with the boundary
    polynomial pieces (scipy's ``ext=0``).
    """

    def __init__(self, t: np.ndarray, c: np.ndarray, k: int, residual: float):
        self.t = t
        self.c = c
        self.k = k
        self._residual = float(residual)

    def __call__(self, xq):
        return splev(xq, self.t, self.c, self.k)

    @property
    def residual(self) -> float:
        """Weighted sum of squared residuals of the fit (FITPACK ``fp``)."""
        return self._residual

    def get_knots(self) -> np.ndarray:
        """Interior + boundary knot positions (scipy-compatible view)."""
        return self.t[self.k:len(self.t) - self.k]


def fit_smoothing_spline(
    x: np.ndarray,
    y: np.ndarray,
    s: float,
    k: Optional[int] = None,
) -> Optional[SmoothingSpline]:
    """Fit a smoothing spline exactly as the reference's UnivariateSpline.

    ``k`` defaults to ``min(3, len(x) - 1)`` (the reference's choice).
    Returns None on any invalid input (too few points, non-increasing x,
    negative s) — mirroring the reference's silent-fail contract.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if k is None:
        k = min(3, x.size - 1)
    try:
        t, c, fp, _ier = curfit(x, y, k=k, s=max(float(s), 0.0))
    except (FitpackError, ValueError, ZeroDivisionError):
        return None
    return SmoothingSpline(t, c, k, fp)
