"""Prevalence design-matrix helpers: splines and interactions.

A numpy copy of ``strutopy_tpu/ops/design.py``: host-side construction
of spline bases and interaction blocks that feed the prevalence
regression as ``X``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def bspline_basis(
    x: np.ndarray,
    df: int = 10,
    degree: int = 3,
    lower: Optional[float] = None,
    upper: Optional[float] = None,
) -> np.ndarray:
    """B-spline basis expansion of a 1-D covariate, (N, df).

    Mirrors R's ``splines::bs(x, df)`` (the engine behind stm's
    ``s()``): ``df - degree`` interior knots at quantiles of ``x``,
    clamped boundary knots.
    """
    from scipy.interpolate import BSpline

    x = np.asarray(x, np.float64).ravel()
    if df <= degree:
        raise ValueError(f"df={df} must exceed the spline degree={degree}")
    lo = np.min(x) if lower is None else lower
    hi = np.max(x) if upper is None else upper
    n_interior = df - degree
    probs = np.linspace(0, 1, n_interior + 2)[1:-1]
    interior = np.quantile(x, probs) if n_interior > 0 else np.empty(0)
    knots = np.concatenate(
        [np.repeat(lo, degree + 1), interior, np.repeat(hi, degree + 1)]
    )
    xc = np.clip(x, lo, hi)
    dm = BSpline.design_matrix(xc, knots, degree).toarray()  # (N, df+1)
    return dm[:, 1:]  # drop the first column (absorbed by the intercept)


def interact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """All pairwise products of two design blocks: (N, Pa*Pb)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 1:
        a = a[:, None]
    if b.ndim == 1:
        b = b[:, None]
    return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)


def prevalence_matrix(*blocks: np.ndarray) -> np.ndarray:
    """Column-stack heterogeneous design blocks (1-D or 2-D)."""
    cols = []
    for blk in blocks:
        blk = np.asarray(blk, np.float64)
        cols.append(blk[:, None] if blk.ndim == 1 else blk)
    return np.concatenate(cols, axis=1)
