"""Computation-time models of the paper, for the port's simulator.

* Assumption 2.2, fixed times: :class:`FixedTimes`.
* Assumption 3.1, random times: :class:`SubExponentialTimes` with the
  :func:`exponential_times`, :func:`shifted_exponential_times` and
  :func:`uniform_times` factories. The device sampler is an inverse CDF
  applied to uniforms from :mod:`repro_torch.core.rng`.
* Assumption 5.1, universal powers: :class:`UniversalModel`, whose
  :meth:`~UniversalModel.finish_times` inverts the cumulative-power grid
  on tensors (per-worker ``searchsorted`` plus the closed-form solve of
  the quadratic segment).
* Assumption 5.4, partial participation: :class:`PartialParticipationModel`.

Each model holds its parameters as NumPy arrays, as the reference does,
and builds device tensors once per run, before the round loop.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["FixedTimes", "SubExponentialTimes", "exponential_times",
           "shifted_exponential_times", "uniform_times", "UniversalModel",
           "PartialParticipationModel", "powers_figure3", "powers_figure4"]


@dataclasses.dataclass
class FixedTimes:
    """Assumption 2.2: worker ``i`` always takes ``taus[i]`` seconds."""

    taus: np.ndarray

    def __post_init__(self) -> None:
        self.taus = np.asarray(self.taus, dtype=float)
        if np.any(self.taus <= 0):
            raise ValueError("tau_i must be positive")
        self.n = len(self.taus)

    @staticmethod
    def sqrt_law(n: int, tau1: float = 1.0) -> "FixedTimes":
        """``tau_i = tau1 * sqrt(i)``: the paper's Figure 5 setup."""
        return FixedTimes(tau1 * np.sqrt(np.arange(1, n + 1)))

    @staticmethod
    def power_law(n: int, alpha: float, tau1: float = 1.0,
                  delta: Optional[np.ndarray] = None) -> "FixedTimes":
        """``tau_m = tau1 * m**alpha + delta_m``: eq. (10)."""
        taus = tau1 * np.arange(1, n + 1, dtype=float) ** alpha
        if delta is not None:
            taus = taus + np.asarray(delta, dtype=float)
        return FixedTimes(taus)

    @staticmethod
    def linear(n: int, tau1: float = 1.0) -> "FixedTimes":
        """``tau_i = tau1 * i``: the log-factor-tight case of Theorem 2.3."""
        return FixedTimes(tau1 * np.arange(1, n + 1, dtype=float))


def _shifted_exponential_icdf(u, shift, scale):
    return shift + scale * -torch.log(u)


def _uniform_icdf(u, low, width):
    # the reference clamps every draw to a nonnegative time
    return torch.clamp_min(low + width * u, 0.0)


_INVERSE_CDF: Dict[str, Callable] = {
    "shifted_exponential": _shifted_exponential_icdf,
    "uniform": _uniform_icdf,
}


@dataclasses.dataclass
class SubExponentialTimes:
    """Assumption 3.1: random per-gradient times, independent draws.

    ``taus`` are the per-worker means and ``R`` the sub-exponential
    parameter. ``law`` names the inverse CDF that turns a uniform into a
    duration, and ``params`` holds its per-worker parameters.
    """

    taus: np.ndarray
    R: float
    name: str
    law: str
    params: Dict[str, np.ndarray]

    def __post_init__(self) -> None:
        self.taus = np.asarray(self.taus, dtype=float)
        self.n = len(self.taus)
        if self.law not in _INVERSE_CDF:
            raise ValueError(f"unknown law {self.law!r}; "
                             f"known: {sorted(_INVERSE_CDF)}")

    def device_sampler(self, device, dtype) -> Callable:
        """``u (S, n) -> durations (S, n)``, parameters already on
        ``device`` so the round loop copies nothing from the host."""
        params = {k: torch.tensor(np.broadcast_to(v, (self.n,)),
                                  dtype=dtype, device=device)
                  for k, v in self.params.items()}
        return functools.partial(_INVERSE_CDF[self.law], **params)


def exponential_times(lam: float, n: int) -> SubExponentialTimes:
    """``tau_i ~ Exp(lam)`` for all workers: ``tau_i = R = 1/lam`` (§3)."""
    return SubExponentialTimes(
        np.full(n, 1.0 / lam), R=1.0 / lam, name=f"exp(lam={lam})",
        law="shifted_exponential",
        params={"shift": np.zeros(n), "scale": np.full(n, 1.0 / lam)})


def shifted_exponential_times(mus, lams) -> SubExponentialTimes:
    """``tau_i = mu_i + Exp(lam_i)`` (§D.1): ``R = max_i 1/lam_i``."""
    mus = np.asarray(mus, dtype=float)
    lams = np.asarray(lams, dtype=float)
    return SubExponentialTimes(
        mus + 1.0 / lams, R=float(np.max(1.0 / lams)), name="shifted-exp",
        law="shifted_exponential",
        params={"shift": mus, "scale": 1.0 / lams})


def uniform_times(means, half_width: float) -> SubExponentialTimes:
    """``tau_i ~ Unif(tau_i - w, tau_i + w)`` (§K.3/K.4): ``R = w``."""
    means = np.asarray(means, dtype=float)
    return SubExponentialTimes(
        means, R=float(half_width), name=f"uniform(w={half_width})",
        law="uniform",
        params={"low": means - half_width,
                "width": np.full(len(means), 2.0 * half_width)})


class UniversalModel:
    """Computation powers ``v_i(t)`` on a grid with linear interpolation.

    ``N_i(t0, t1) = floor(int_{t0}^{t1} v_i(s) ds)``: eq. (11). The
    trapezoid cumulative integral on the grid is exact for these
    piecewise-linear powers.
    """

    def __init__(self, grid: np.ndarray, powers: np.ndarray) -> None:
        self.grid = np.asarray(grid, dtype=float)
        self.powers = np.maximum(np.asarray(powers, dtype=float), 0.0)
        self.n = self.powers.shape[0]
        dt = np.diff(self.grid)
        mids = 0.5 * (self.powers[:, 1:] + self.powers[:, :-1])
        self.cum = np.concatenate(
            [np.zeros((self.n, 1)), np.cumsum(mids * dt, axis=1)], axis=1)
        self._tensor_cache: Dict[tuple, tuple] = {}

    def tensors(self, device, dtype) -> tuple:
        """``(grid, cum, powers)`` on ``device`` in ``dtype``, built once."""
        key = (str(torch.device(device)), dtype)
        if key not in self._tensor_cache:
            self._tensor_cache[key] = tuple(
                torch.as_tensor(a, dtype=dtype, device=device)
                for a in (self.grid, self.cum, self.powers))
        return self._tensor_cache[key]

    def _cum_at(self, t: torch.Tensor) -> torch.Tensor:
        """Cumulative integral of ``v_i`` at times ``t`` of shape ``(n, B)``
        (worker-major)."""
        g, cum, powers = self.tensors(t.device, t.dtype)
        tf = torch.where(torch.isfinite(t), t, g[-1])
        j = torch.clamp(torch.searchsorted(g, tf, side="left") - 1, 0,
                        len(self.grid) - 2)
        dt = tf - g[j]
        h = g[j + 1] - g[j]
        v0 = torch.gather(powers, 1, j)
        v1 = torch.gather(powers, 1, j + 1)
        vt = v0 + (v1 - v0) * dt / h
        mid = torch.gather(cum, 1, j) + 0.5 * (v0 + vt) * dt
        tail = cum[:, -1:] + powers[:, -1:] * (tf - g[-1])
        out = torch.where(tf <= g[0], 0.0,
                          torch.where(tf >= g[-1], tail, mid))
        # t = inf: the tail integral is inf if the tail power is positive,
        # else the finite grid total
        return torch.where(torch.isfinite(t), out,
                           torch.where(powers[:, -1:] > 0, math.inf,
                                       cum[:, -1:]))

    def finish_times(self, t0: torch.Tensor) -> torch.Tensor:
        """Smallest ``t >= t0`` with ``int_{t0}^{t} v_i >= 1``: the finish
        time of one gradient started at ``t0``.

        ``t0`` has shape ``(..., n)``, its last axis indexing workers
        ``0..n-1``. A worker whose power stays 0 never finishes (``inf``),
        and a computation started at ``t0 = inf`` never finishes.
        """
        shape = t0.shape
        t0 = t0.reshape(-1, self.n).T.contiguous()          # (n, B)
        g, cum, powers = self.tensors(t0.device, t0.dtype)
        base = self._cum_at(t0)
        want = base + 1.0
        tail_v = powers[:, -1:]
        cum_end = cum[:, -1:]
        overflow = cum_end < want                 # crossing past the grid
        t_tail = torch.where(
            tail_v > 0,
            g[-1] + (want - cum_end) / torch.where(tail_v > 0, tail_v, 1.0),
            math.inf)
        want_in = torch.where(overflow, cum_end, want).contiguous()
        # first grid index with cum >= want, per worker row
        jj = torch.searchsorted(cum, want_in, side="left")
        jj = torch.clamp(jj, 1, len(self.grid) - 1)   # crossing in [jj-1, jj]
        c0 = torch.gather(cum, 1, jj - 1)
        rem = torch.where(overflow, 0.0, want - c0)
        v0 = torch.gather(powers, 1, jj - 1)
        v1 = torch.gather(powers, 1, jj)
        h = g[jj] - g[jj - 1]
        slope = (v1 - v0) / h
        # 0.5*slope*dt^2 + v0*dt = rem, stable root (exact in the linear
        # slope -> 0 limit): dt = 2*rem / (v0 + sqrt(v0^2 + 2*slope*rem))
        disc = torch.clamp_min(v0 * v0 + 2.0 * slope * rem, 0.0)
        den = v0 + torch.sqrt(disc)
        dt = torch.where(den > 0,
                         2.0 * rem / torch.where(den > 0, den, 1.0), 0.0)
        t_in = g[jj - 1] + torch.where(rem > 0, dt, 0.0)
        out = torch.where(overflow, t_tail, torch.maximum(t_in, t0))
        out = torch.where(torch.isfinite(t0), out, math.inf)
        return out.T.reshape(shape)


def powers_figure3(n: int = 50, seed: int = 0, t_max: float = 400.0
                   ) -> UniversalModel:
    """Figure 3: ``v_i(t_k) = max(sin(a_i t_k + s_i) + eps, 0)``."""
    rng = np.random.default_rng(seed)
    grid = np.arange(0.0, t_max, 0.1)
    a = rng.uniform(0.5, 1.0, size=n)
    s = rng.uniform(0.0, 2 * np.pi, size=n)
    eps = rng.normal(0.0, 0.1, size=(n, len(grid)))
    powers = np.maximum(np.sin(a[:, None] * grid[None, :] + s[:, None]) + eps,
                        0.0)
    return UniversalModel(grid, powers)


def powers_figure4(n: int = 50, seed: int = 0, t_max: float = 400.0
                   ) -> UniversalModel:
    """Figure 4: ``v_i(t_k) = max(s_i + 3 sin(t_k + phi_i) + eps, 0.1)``."""
    rng = np.random.default_rng(seed)
    grid = np.arange(0.0, t_max, 0.1)
    s = rng.uniform(10.5, 11.0, size=n)
    phi = rng.uniform(0.0, 2 * np.pi, size=n)
    eps = rng.normal(0.0, 0.1, size=(n, len(grid)))
    powers = np.maximum(s[:, None] + 3 * np.sin(grid[None, :] + phi[:, None])
                        + eps, 0.1)
    return UniversalModel(grid, powers)


class PartialParticipationModel(UniversalModel):
    """Assumption 5.4: equal power ``v`` except at most ``p*n`` stragglers
    at any time, by default a rotating window of dead workers."""

    def __init__(self, n: int, v: float = 1.0, p: float = 0.1,
                 period: float = 1.0, t_max: float = 400.0,
                 straggler_fn: Optional[Callable[[float], set]] = None,
                 dt: float = 0.05) -> None:
        k = int(math.floor(p * n))
        grid = np.arange(0.0, t_max, dt)
        powers = np.full((n, len(grid)), float(v))
        if straggler_fn is None:
            def straggler_fn(t: float) -> set:
                start = int(t / period) * k % max(n, 1)
                return {(start + j) % n for j in range(k)}
        for ti, t in enumerate(grid):
            for i in straggler_fn(float(t)):
                powers[i, ti] = 0.0
        super().__init__(grid, powers)
