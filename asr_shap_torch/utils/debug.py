"""Numerical guards."""

from __future__ import annotations

import numpy as np


def check_finite(arr, name: str = "value"):
    """Raise FloatingPointError with counts and the finite range when a
    float array holds NaN or Inf; return it unchanged otherwise."""
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, np.floating):
        n_nan, n_inf = int(np.isnan(a).sum()), int(np.isinf(a).sum())
        if n_nan or n_inf:
            raise FloatingPointError(
                f"non-finite values: {name}: {n_nan} NaN, {n_inf} Inf of "
                f"{a.size} (finite range [{np.nanmin(a):.3g}, {np.nanmax(a):.3g}])")
    return arr
