"""``run_experiment``: a strategy under a named scenario across a seed
sweep and an optional grid, in one :func:`repro_torch.core.simulate_batch`
call, reduced to summary rows with an optional JSON artifact."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..core.batch import TraceBatch, simulate_batch
from .scenarios import make_scenario

__all__ = ["ExperimentResult", "run_experiment", "atomic_write_json"]


def atomic_write_json(path: str, obj: Any, *, indent: int = 2,
                      default=None) -> None:
    """Write ``obj`` as JSON through a tmp file and :func:`os.replace`, so
    a reader sees either the previous complete file or the new one."""
    path = os.fspath(path)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=indent, default=default)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _jsonable(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def sanitize_json(obj):
    """Replace non-finite floats with strings (``"inf"``): bare
    ``Infinity`` tokens are not valid JSON."""
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    if isinstance(obj, (float, np.floating)) and not np.isfinite(obj):
        return str(obj)
    return obj


@dataclasses.dataclass
class ExperimentResult:
    """A named experiment: its meta, the raw TraceBatch and summary rows."""

    name: str
    meta: Dict[str, Any]
    batch: TraceBatch
    rows: List[Dict[str, Any]]

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "meta": self.meta, "rows": self.rows}

    def to_json(self, path: str) -> None:
        atomic_write_json(path, sanitize_json(self.as_dict()),
                          default=_jsonable)


def run_experiment(strategy, scenario: Union[str, object], n: int, K: int,
                   *, seeds: Union[int, Sequence[int]] = 8,
                   grid: Optional[Mapping[str, Sequence]] = None,
                   problem=None, gamma: float = 0.0, record_every: int = 1,
                   scenario_kwargs: Optional[Dict[str, Any]] = None,
                   target_frac: Optional[float] = None,
                   json_path: Optional[str] = None,
                   name: Optional[str] = None, device="cuda",
                   dtype: torch.dtype = torch.float32) -> ExperimentResult:
    """Run ``strategy`` under ``scenario`` across ``seeds`` x ``grid``.

    ``scenario`` is a name from :data:`~repro_torch.exp.scenarios.SCENARIOS`
    (built with ``n`` and ``scenario_kwargs``) or a time model whose
    ``n`` equals ``n``. ``target_frac`` adds time-to-target quantiles
    (wall-clock until ``||grad f||^2`` falls to that fraction of its
    initial value). ``json_path`` writes the summary as a JSON artifact.
    """
    if isinstance(scenario, str):
        model = make_scenario(scenario, n, **(scenario_kwargs or {}))
        scen_name = scenario
    else:
        model = scenario
        scen_name = getattr(model, "name", type(model).__name__)
    if model.n != n:
        raise ValueError(f"scenario has n={model.n}, asked for n={n}")
    batch = simulate_batch(strategy, model, K, problem=problem, gamma=gamma,
                           seeds=seeds, grid=grid, record_every=record_every,
                           device=device, dtype=dtype)
    rows = batch.summary(target_frac=target_frac)
    for row in rows:
        row["scenario"] = scen_name
        row["n"] = n
        row["K"] = K
    meta = {"strategy": batch.strategy, "scenario": scen_name, "n": n,
            "K": K, "seeds": [int(s) for s in batch.seeds],
            "backend": batch.backend, "device": batch.device,
            "dtype": str(dtype), "grid": batch.grid if grid else None}
    result = ExperimentResult(name=name or f"{batch.strategy}@{scen_name}",
                              meta=meta, batch=batch, rows=rows)
    if json_path:
        result.to_json(json_path)
    return result
