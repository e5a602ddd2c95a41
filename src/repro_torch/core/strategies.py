"""Run record and the strategies of the slice: m-Sync and full Sync.

:class:`Trace` is a copy of the reference's record of one run. The
registry :data:`STRATEGIES` holds the strategies the port's simulator
runs, under the reference's names.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["Trace", "MSync", "FullSync", "STRATEGIES", "make_strategy"]


@dataclasses.dataclass
class Trace:
    """Wall-clock trace of one optimization run."""

    times: np.ndarray          # wall-clock seconds at each recorded step
    values: np.ndarray         # f(x) at those times
    grad_norms: np.ndarray     # ||grad f(x)||^2 at those times
    iterations: int            # server updates performed
    total_time: float          # wall-clock at termination
    gradients_used: int        # stochastic gradients aggregated into updates
    gradients_computed: int    # total computed (incl. discarded)
    x_final: Optional[np.ndarray] = None   # last iterate (math runs only)

    @property
    def discard_fraction(self) -> float:
        if self.gradients_computed == 0:
            return 0.0
        return 1.0 - self.gradients_used / self.gradients_computed


class MSync:
    """Algorithm 3: aggregate the first ``m`` fresh gradients of a round;
    late results are discarded and their workers restart."""

    name = "msync"

    def __init__(self, m: Optional[int] = None) -> None:
        self.m = m

    def bind(self, n: int) -> int:
        """The ``m`` this strategy runs with on ``n`` workers."""
        m = n if self.m is None else int(self.m)
        if not 1 <= m <= n:
            raise ValueError(f"m={m} out of range [1, {n}]")
        return m


class FullSync(MSync):
    """Algorithm 1: m-Synchronous SGD with ``m = n``."""

    name = "sync"

    def __init__(self) -> None:
        super().__init__(m=None)


STRATEGIES: Dict[str, Callable[..., MSync]] = {"msync": MSync,
                                               "sync": FullSync}


def make_strategy(name: str, **kwargs) -> MSync:
    """``STRATEGIES[name](**kwargs)`` with a helpful error."""
    try:
        factory = STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"known: {sorted(STRATEGIES)}") from None
    return factory(**kwargs)
