"""Batched multi-seed simulation: :func:`simulate_batch` and
:class:`TraceBatch`, the port's front door to the simulator.

``simulate_batch`` runs one strategy under one time model across ``S``
seeds and an optional parameter grid, each grid point as one batched run
of :func:`repro_torch.core.batch_torch.simulate_batch_torch` on
``device``, and returns a :class:`TraceBatch` with cross-seed summaries.

Grid semantics as in the reference: ``grid`` maps parameter names to
value sequences and the cartesian product is swept. Keys in
:data:`SIM_GRID_KEYS` override the corresponding argument; every other
key goes to the strategy factory (``{"m": [1, 4, 16]}`` sweeps
``MSync(m=...)``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, ClassVar, Dict, List, Mapping, Optional, Sequence,
                    Union)

import numpy as np
import torch

from .batch_torch import simulate_batch_torch
from .strategies import STRATEGIES, MSync, Trace, make_strategy

__all__ = ["TraceBatch", "simulate_batch", "SIM_GRID_KEYS"]

# grid keys routed to the simulator itself; everything else goes to the
# strategy factory
SIM_GRID_KEYS = ("K", "gamma", "record_every")


@dataclasses.dataclass
class TraceBatch:
    """Traces of ``G`` grid points x ``S`` seeds plus cross-seed reducers.

    ``traces[g][s]`` is the per-run :class:`Trace`; scalar per-run fields
    are exposed as ``(G, S)`` arrays through :meth:`stat`, and
    :meth:`summary` produces the mean ± std rows.
    """

    strategy: str                      # display name of the swept strategy
    grid: List[Dict[str, Any]]         # one kwargs dict per grid point
    seeds: np.ndarray                  # (S,) seeds, in run order
    traces: List[List[Trace]]          # [G][S]
    device: str                        # device the runs ran on
    backend: ClassVar[str] = "torch"
    rng_scheme: ClassVar[str] = "counter"   # draws from core/rng.py

    def stat(self, field: str) -> np.ndarray:
        """``(G, S)`` array of a scalar Trace field or property."""
        return np.array([[getattr(tr, field) for tr in row]
                         for row in self.traces], dtype=float)

    @property
    def total_time(self) -> np.ndarray:
        return self.stat("total_time")

    def time_to_target(self, frac: float = 0.25) -> np.ndarray:
        """``(G, S)`` wall-clock time at which ``||grad f||^2`` first drops
        to ``frac`` x its initial recorded value (``inf`` if never;
        ``nan`` for timing-only traces)."""
        out = np.full((len(self.traces), len(self.seeds)), np.nan)
        for g, row in enumerate(self.traces):
            for s, tr in enumerate(row):
                if len(tr.grad_norms) == 0:
                    continue
                tgt = frac * tr.grad_norms[0]
                hit = np.flatnonzero(tr.grad_norms <= tgt)
                out[g, s] = tr.times[hit[0]] if hit.size else np.inf
        return out

    def summary(self, target_frac: Optional[float] = None,
                quantiles: Sequence[float] = (0.1, 0.5, 0.9)) -> List[dict]:
        """One dict per grid point: mean ± std across seeds of total time,
        seconds per useful gradient and discard fraction, plus
        time-to-target quantiles when ``target_frac`` is given."""
        tt = self.total_time
        used = np.maximum(self.stat("gradients_used"), 1.0)
        per_grad = tt / used
        disc = self.stat("discard_fraction")
        rows = []
        for g, params in enumerate(self.grid):
            row = {
                "strategy": self.strategy,
                "params": dict(params),
                "seeds": len(self.seeds),
                "backend": self.backend,
                "device": self.device,
                "rng_scheme": self.rng_scheme,
                "total_time_mean": float(tt[g].mean()),
                "total_time_std": float(tt[g].std()),
                "s_per_useful_grad_mean": float(per_grad[g].mean()),
                "s_per_useful_grad_std": float(per_grad[g].std()),
                "discard_fraction_mean": float(disc[g].mean()),
                "iterations_mean": float(self.stat("iterations")[g].mean()),
            }
            if target_frac is not None:
                t2t = self.time_to_target(target_frac)[g]
                finite = t2t[np.isfinite(t2t)]
                row["time_to_target_frac"] = target_frac
                row["time_to_target_hit_rate"] = (
                    float(np.mean(np.isfinite(t2t))) if len(t2t) else 0.0)
                for q in quantiles:
                    row[f"time_to_target_q{int(round(q * 100))}"] = (
                        float(np.quantile(finite, q)) if finite.size
                        else float("inf"))
            rows.append(row)
        return rows


StrategySpec = Union[str, MSync, "tuple[str, Dict[str, Any]]"]


def _as_spec(strategy: StrategySpec):
    """Normalize to ``(display_name, factory(**kw), base_kwargs)``."""
    if isinstance(strategy, str):
        make_strategy(strategy)        # raises KeyError with known names
        return strategy, STRATEGIES[strategy], {}
    if isinstance(strategy, tuple):
        name, kw = strategy
        make_strategy(name, **kw)      # validate early, with a clear error
        return name, STRATEGIES[name], dict(kw)
    if isinstance(strategy, MSync):
        inst = strategy

        def factory(**kw):
            if kw:
                raise ValueError(
                    "grid sweeps over strategy parameters need a re-"
                    "instantiable spec: pass a name or (name, kwargs), "
                    f"not the instance {inst.name!r}")
            return inst
        return inst.name, factory, {}
    raise TypeError(f"bad strategy spec: {strategy!r}")


def _grid_points(grid: Optional[Mapping[str, Sequence]]) -> List[Dict]:
    if not grid:
        return [{}]
    keys = list(grid)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(grid[k] for k in keys))]


def simulate_batch(strategy: StrategySpec, model, K: int, problem=None,
                   gamma: float = 0.0,
                   seeds: Union[int, Sequence[int]] = 8,
                   grid: Optional[Mapping[str, Sequence]] = None,
                   record_every: int = 1, device="cuda",
                   dtype: torch.dtype = torch.float32) -> TraceBatch:
    """Run ``strategy`` under ``model`` across ``seeds`` x ``grid`` on
    ``device`` in ``dtype``.

    ``seeds`` is an int (-> ``range(seeds)``) or an explicit sequence.
    ``problem`` is ``None`` for timing-only runs or a
    :class:`~repro_torch.core.oracle.TorchProblem`. The default device is
    the GPU; pass ``device="cpu"`` to run on the CPU.
    """
    seed_list = list(range(seeds)) if isinstance(seeds, (int, np.integer)) \
        else [int(s) for s in seeds]
    if not seed_list:
        raise ValueError("need at least one seed")
    name, factory, base_kw = _as_spec(strategy)
    points = _grid_points(grid)
    traces: List[List[Trace]] = []
    for pt in points:
        sim_kw = {k: pt[k] for k in pt if k in SIM_GRID_KEYS}
        strat_kw = {**base_kw, **{k: v for k, v in pt.items()
                                  if k not in SIM_GRID_KEYS}}
        m = factory(**strat_kw).bind(model.n)
        traces.append(simulate_batch_torch(
            m, model, int(sim_kw.get("K", K)), problem=problem,
            gamma=float(sim_kw.get("gamma", gamma)), seeds=seed_list,
            record_every=int(sim_kw.get("record_every", record_every)),
            device=device, dtype=dtype))
    return TraceBatch(strategy=name, grid=points,
                      seeds=np.asarray(seed_list), traces=traces,
                      device=str(torch.device(device)))
