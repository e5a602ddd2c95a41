"""PyTorch port of the batched m-Sync simulator.

The counterpart of the JAX package ``repro`` for the slice it covers:
``simulate_batch(("msync", {"m": m}), model, K, seeds=...)`` runs the
m-Synchronous SGD simulator as one ``(seeds, workers)`` batch on the GPU
(``device="cuda"``, the default) or on the CPU (``device="cpu"``), with
the per-round m-th order statistic as a hand-written CUDA kernel.
"""

from .core import (STRATEGIES, FixedTimes, TorchProblem, TraceBatch,
                   quadratic_worst_case_torch, simulate_batch)
from .exp import SCENARIOS, make_scenario, run_experiment

__all__ = ["STRATEGIES", "FixedTimes", "TorchProblem", "TraceBatch",
           "quadratic_worst_case_torch", "simulate_batch", "SCENARIOS",
           "make_scenario", "run_experiment"]
