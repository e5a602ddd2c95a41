"""String-keyed registry of the paper's compute regimes, for the port.

The counterpart of the reference's ``SCENARIOS`` for every regime whose
time model the port has. A factory takes ``n`` plus regime-specific
keyword overrides and returns the time model.

===================== ======================================= ============
name                  model                                   assumption
===================== ======================================= ============
fixed_sqrt            tau_i = tau1·sqrt(i)                    2.2 (Fig 5)
fixed_linear          tau_i = tau1·i                          2.2 (Thm 2.3)
fixed_power           tau_i = tau1·i^alpha                    2.2 (eq. 10)
fixed_powerlaw        tau_i = tau1·i^alpha (= fixed_power)    2.2 (atlas)
fixed_bimodal         tau_i = tau1, one straggler tau1·R      2.2 (atlas)
exponential           Exp(lam), i.i.d. workers                3.1 (§3)
exp_het               Exp(mean tau1·sqrt(i)) per worker       3.1 (§D.1)
exp_powerlaw          Exp(mean tau1·i^alpha) per worker       3.1 (atlas)
shifted_exp           mu_i + Exp(lam_i)                       3.1 (§D.1)
uniform               Unif(tau_i − w, tau_i + w)              3.1 (§K.3/4)
universal_fig3        sin-powers grid (Figure 3)              5.1
universal_fig4        offset sin-powers grid (Figure 4)       5.1
partial_participation rotating ≤ p·n dead workers             5.4
===================== ======================================= ============
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from ..core.time_models import (FixedTimes, PartialParticipationModel,
                                exponential_times, powers_figure3,
                                powers_figure4, shifted_exponential_times,
                                uniform_times)

__all__ = ["SCENARIOS", "make_scenario"]

SCENARIOS: Dict[str, Callable] = {}


def _register(name: str):
    def deco(factory):
        SCENARIOS[name] = factory
        return factory
    return deco


def make_scenario(name: str, n: int, **kwargs):
    """``SCENARIOS[name](n, **kwargs)`` with a helpful error."""
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(SCENARIOS)}") from None
    return factory(n, **kwargs)


@_register("fixed_sqrt")
def fixed_sqrt(n: int, tau1: float = 1.0):
    return FixedTimes.sqrt_law(n, tau1)


@_register("fixed_linear")
def fixed_linear(n: int, tau1: float = 1.0):
    return FixedTimes.linear(n, tau1)


@_register("fixed_power")
def fixed_power(n: int, alpha: float = 1.2, tau1: float = 1.0):
    return FixedTimes.power_law(n, alpha, tau1)


@_register("fixed_powerlaw")
def fixed_powerlaw(n: int, alpha: float = 1.2, tau1: float = 1.0):
    return FixedTimes.power_law(n, alpha, tau1)


@_register("fixed_bimodal")
def fixed_bimodal(n: int, tau1: float = 1.0, straggler: float = 25.0):
    """``n - 1`` identical workers plus one straggler ``straggler`` times
    slower."""
    taus = np.full(n, tau1)
    taus[-1] = tau1 * straggler
    return FixedTimes(taus)


@_register("exponential")
def exponential(n: int, lam: float = 1.0):
    return exponential_times(lam, n)


@_register("exp_het")
def exp_het(n: int, tau1: float = 1.0):
    """Worker ``i`` is Exp with mean ``tau1 * sqrt(i)``."""
    means = tau1 * np.sqrt(np.arange(1, n + 1))
    return shifted_exponential_times(np.zeros(n), 1.0 / means)


@_register("exp_powerlaw")
def exp_powerlaw(n: int, alpha: float = 1.2, tau1: float = 1.0):
    """Worker ``i`` is Exp with mean ``tau1 * i^alpha``."""
    means = tau1 * np.arange(1, n + 1, dtype=float) ** alpha
    return shifted_exponential_times(np.zeros(n), 1.0 / means)


@_register("shifted_exp")
def shifted_exp(n: int, lam: float = 1.0):
    return shifted_exponential_times(np.sqrt(np.arange(1, n + 1)),
                                     np.full(n, lam))


@_register("uniform")
def uniform(n: int, half_width: float = 0.5):
    return uniform_times(np.ones(n), half_width)


@_register("universal_fig3")
def universal_fig3(n: int, seed: int = 0, t_max: float = 400.0):
    return powers_figure3(n=n, seed=seed, t_max=t_max)


@_register("universal_fig4")
def universal_fig4(n: int, seed: int = 0, t_max: float = 400.0):
    return powers_figure4(n=n, seed=seed, t_max=t_max)


@_register("partial_participation")
def partial_participation(n: int, v: float = 1.0, p: float = 0.2,
                          period: float = 40.0, t_max: float = 4000.0):
    return PartialParticipationModel(n=n, v=v, p=p, period=period,
                                     t_max=t_max)
