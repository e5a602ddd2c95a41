"""Optimal number of active workers (§4, Proposition 4.1)."""

from __future__ import annotations

import math

import numpy as np

__all__ = ["g_of_m", "optimal_m"]


def g_of_m(taus: np.ndarray, sigma2: float, eps: float) -> np.ndarray:
    """Eq. (8): ``g(m) = tau_m max(1, sigma^2/(m eps))`` for m = 1..n
    (sorted tau)."""
    taus = np.sort(np.asarray(taus, dtype=float))
    ms = np.arange(1, len(taus) + 1, dtype=float)
    return taus * np.maximum(1.0, sigma2 / (ms * eps))


def optimal_m(taus: np.ndarray, sigma2: float, eps: float) -> int:
    """Proposition 4.1 minimizer of ``g(m)`` (1-indexed), searched over
    ``m <= min(ceil(sigma^2/eps), n)``; ``m = 1`` if ``sigma^2/eps <= 1``."""
    n = len(taus)
    if sigma2 / eps <= 1.0:
        return 1
    cap = min(int(math.ceil(sigma2 / eps)), n)
    g = g_of_m(taus, sigma2, eps)[:cap]
    return int(np.argmin(g)) + 1
