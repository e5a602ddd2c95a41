"""PyTorch port of the JAX package ``repro``, for the slices it covers.

* The batched m-Sync simulator:
  ``simulate_batch(("msync", {"m": m}), model, K, seeds=...)`` runs the
  m-Synchronous SGD simulator as one ``(seeds, workers)`` batch, with the
  per-round m-th order statistic as a hand-written CUDA kernel;
  ``run_experiment`` runs it over the scenario registry.
* The RWKV-6 model and its serving path: ``build_model(get_config(
  "rwkv6-3b"))`` gives a ``Model`` whose ``prefill`` runs the chunked
  RWKV scan as a hand-written CUDA kernel, once per layer, and
  ``ServeEngine(model, params).generate([Request(...)])`` answers
  requests through ``Model.decode_step``.
* The dense-attention model ``llama3.2-3b`` on the same entry points: its
  ``prefill`` runs flash attention as a hand-written CUDA kernel, once
  per layer; its decode attends over a KV cache.

Everything runs on the GPU (``device="cuda"``, the default of the
simulator; the model runs where its parameters lie), or on the CPU,
where each kernel's plain PyTorch version stands in.
"""

from .configs import get_config, reduced
from .core import (STRATEGIES, FixedTimes, TorchProblem, TraceBatch,
                   quadratic_worst_case_torch, simulate_batch)
from .exp import SCENARIOS, make_scenario, run_experiment
from .models import Model, build_model
from .serve import Request, ServeEngine

__all__ = ["STRATEGIES", "FixedTimes", "TorchProblem", "TraceBatch",
           "quadratic_worst_case_torch", "simulate_batch", "SCENARIOS",
           "make_scenario", "run_experiment", "get_config", "reduced",
           "Model", "build_model", "Request", "ServeEngine"]
