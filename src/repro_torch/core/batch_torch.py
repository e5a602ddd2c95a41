"""The batched m-Sync simulator on tensors: the port of the reference's
m-sync round scan (``src/repro/core/batch_jax.py``).

State is a ``(seeds, workers)`` batch: each worker's pending finish time
``ft``, the server version ``ver`` its computation started at, and the
per-seed count ``comp`` of gradients computed. One round of m-Sync:

1. stale workers (``ver < k``) whose old result arrives restart, so their
   fresh result is a candidate finish time;
2. the round ends at ``T``, the m-th smallest candidate
   (:func:`repro_torch.kernels.order_stats.mth_smallest`);
3. the first ``m`` candidates by time, ties broken by worker index, are
   accepted, and their workers restart at ``T``.

The K-round loop is a Python loop of tensor operations that never reads
a value back to the host: the round times are written into a
preallocated ``(K, S)`` tensor and copied out once at the end.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels.order_stats import mth_smallest
from . import rng
from .oracle import TorchProblem
from .strategies import Trace
from .time_models import FixedTimes, SubExponentialTimes, UniversalModel

__all__ = ["simulate_batch_torch", "assemble_traces"]


def _timing_round(ft, ver, comp, k: int, cand, m: int):
    """Shared m-sync round update on ``(S, n)`` state.

    The reference accepts the ``cand <= T`` mask when every row has
    exactly ``m`` such candidates and otherwise (ties straddling the
    m-boundary) ranks tied candidates by worker index under a per-row
    quota. The quota mask equals the ``<=`` mask whenever the counts are
    ``m``, so computing it every round gives the same output without the
    host sync a data-dependent branch would need.
    """
    stale = ver < k
    T = mth_smallest(cand, m)
    Tc = T[:, None]
    lt = cand < Tc
    tie = cand == Tc
    c_lt = lt.sum(dim=1, dtype=torch.int32)
    tie_rank = torch.cumsum(tie, dim=1, dtype=torch.int32) - 1
    acc = lt | (tie & (tie_rank < (m - c_lt)[:, None]))
    popped = stale & (ft < Tc)
    # counters stay int32, as in the reference
    comp = comp + m + popped.sum(dim=1, dtype=torch.int32)
    ft = torch.where(popped, cand, ft)
    ver = torch.where(popped, k, ver)
    return ft, ver, comp, T, acc


def _fixed_timing_run(taus: torch.Tensor, S: int, m: int, K: int):
    """Timing-only m-sync under FixedTimes: no draws at all."""
    n = taus.shape[0]
    ft = taus.expand(S, n).clone()
    ver = torch.zeros((S, n), dtype=torch.int32, device=taus.device)
    comp = torch.zeros(S, dtype=torch.int32, device=taus.device)
    T_all = torch.empty((K, S), dtype=taus.dtype, device=taus.device)
    for k in range(K):
        stale = ver < k
        cand = torch.where(stale, ft + taus, ft)
        ft, ver, comp, T, acc = _timing_round(ft, ver, comp, k, cand, m)
        ft = torch.where(acc, T[:, None] + taus, ft)
        ver = torch.where(acc, k + 1, ver)
        T_all[k] = T
    return comp, T_all


def _keys_and_x(problem: Optional[TorchProblem], S: int, seeds, device,
                dtype):
    """Per-seed counter-RNG keys and the broadcast initial iterate
    (``None`` for timing-only runs)."""
    keys = rng.seed_keys(seeds, device)
    x = None
    if problem is not None:
        x0 = torch.as_tensor(problem.x0, dtype=dtype, device=device)
        x = x0.expand(S, x0.shape[0]).clone()
    return keys, x


def _finish_factory(model, S: int, n: int, device, dtype):
    """``finish_all(durations, t0) -> (S, n)`` absolute finish times of
    computations started at ``t0``: the drawn durations plus the start
    for sampled models, ``t0 + tau`` for FixedTimes, the finish-time
    inversion for universal models (which take no durations)."""
    if isinstance(model, FixedTimes):
        taus = torch.as_tensor(model.taus, dtype=dtype, device=device)

        def finish_all(durations, t0):
            return (t0 + taus).expand(S, n)
    elif isinstance(model, UniversalModel):
        model.tensors(device, dtype)              # built before the loop

        def finish_all(durations, t0):
            return model.finish_times(t0.expand(S, n))
    else:
        def finish_all(durations, t0):
            return t0 + durations
    return finish_all


def _grad_mean_fn(problem: TorchProblem):
    """Mean over the round's ``B`` stochastic gradients at ``x``:
    ``u`` is ``(S, B)``, one oracle uniform per gradient."""
    def grad_mean(x, u):
        return problem.stoch_grad(x[:, None, :], u).mean(dim=1)
    return grad_mean


def _general_run(model, problem: Optional[TorchProblem], m: int, n: int,
                 S: int, K: int, gamma: float, seeds: Sequence[int], *,
                 device, dtype, durations: Optional[torch.Tensor] = None,
                 oracle_uniforms: Optional[torch.Tensor] = None):
    """m-sync scan for sampled and universal time models and/or an
    oracle.

    A sampled model consumes three duration rows per seed: row 0 starts
    every worker, and round ``k`` draws row ``2k+1`` for the restart of
    stale workers and row ``2k+2`` for the restart of the accepted ones.
    By default these come from the counter RNG keyed by (seed, round,
    purpose); ``durations`` of shape ``(2K+1, S, n)`` injects them
    instead. The oracle takes ``(S, m)`` uniforms per round, from the
    counter RNG or from ``oracle_uniforms`` of shape ``(K, S, m)``.
    """
    math_run = problem is not None
    keys, x = _keys_and_x(problem, S, seeds, device, dtype)
    finish_all = _finish_factory(model, S, n, device, dtype)
    sampler = (model.device_sampler(device, dtype)
               if isinstance(model, SubExponentialTimes) else None)

    def draw(row: int, round_: int, purpose: int):
        if sampler is None:
            return None
        if durations is not None:
            return durations[row]
        return sampler(rng.uniforms(keys, round_, purpose, n, dtype))

    if math_run:
        grad_mean = _grad_mean_fn(problem)
        val = torch.empty((K, S), dtype=dtype, device=device)
        gn = torch.empty((K, S), dtype=dtype, device=device)
    else:
        val = gn = None
    zeros = torch.zeros((S, n), dtype=dtype, device=device)
    ft = finish_all(draw(0, 0, rng.INIT), zeros)
    ver = torch.zeros((S, n), dtype=torch.int32, device=device)
    comp = torch.zeros(S, dtype=torch.int32, device=device)
    T_all = torch.empty((K, S), dtype=dtype, device=device)
    for k in range(K):
        stale = ver < k
        cand = torch.where(stale, finish_all(draw(2 * k + 1, k, rng.STALE),
                                             ft), ft)
        ft, ver, comp, T, acc = _timing_round(ft, ver, comp, k, cand, m)
        ft = torch.where(acc, finish_all(draw(2 * k + 2, k, rng.ACCEPT),
                                         T[:, None]), ft)
        ver = torch.where(acc, k + 1, ver)
        T_all[k] = T
        if math_run:
            u = (oracle_uniforms[k] if oracle_uniforms is not None
                 else rng.uniforms(keys, k, rng.ORACLE, m, dtype))
            x = x - gamma * grad_mean(x, u)
            val[k] = problem.f(x)
            gn[k] = (problem.grad(x) ** 2).sum(dim=-1)
    return comp, x, T_all, val, gn


def _check_supported(model, problem) -> None:
    if not isinstance(model, (FixedTimes, SubExponentialTimes,
                              UniversalModel)):
        raise NotImplementedError(
            f"the torch simulator takes FixedTimes, SubExponentialTimes or "
            f"a UniversalModel, not {type(model).__name__}")
    if problem is not None and not isinstance(problem, TorchProblem):
        raise NotImplementedError(
            f"the torch simulator takes a TorchProblem, not "
            f"{type(problem).__name__}")


def simulate_batch_torch(m: int, model, K: int, problem=None,
                         gamma: float = 0.0, seeds: Sequence[int] = (0,),
                         record_every: int = 1, *, device="cuda",
                         dtype: torch.dtype = torch.float32) -> List[Trace]:
    """Run m-sync with ``m`` active workers for ``K`` rounds on every seed
    of ``seeds`` as one ``(seeds, workers)`` batch; returns the per-seed
    :class:`Trace` list (timing-only traces have empty arrays).

    Every draw comes from the counter RNG keyed by the seed value, so a
    seed's trace does not depend on the other seeds of the batch.
    """
    _check_supported(model, problem)
    n = model.n
    if not 1 <= m <= n:
        raise ValueError(f"m={m} out of range [1, {n}]")
    K = int(K)
    if K <= 0:
        raise ValueError(f"K={K} must be positive")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, not {dtype}")
    device = torch.device(device)
    S = len(seeds)
    if isinstance(model, FixedTimes) and problem is None:
        taus = torch.as_tensor(model.taus, dtype=dtype, device=device)
        comp, T = _fixed_timing_run(taus, S, m, K)
        x = val = gn = None
    else:
        comp, x, T, val, gn = _general_run(model, problem, m, n, S, K,
                                           gamma, seeds, device=device,
                                           dtype=dtype)
    return assemble_traces(comp, x, T, val, gn, m * K, S, K, record_every,
                           problem)


def assemble_traces(comp, x, T, val, gn, used: int, S: int, K: int,
                    record_every: int, problem) -> List[Trace]:
    """Package the engine's outputs (``comp (S,)``, ``T/val/gn (K, S)``,
    ``x (S, d)``) into the per-seed :class:`Trace` list. This is the one
    place the results are copied to the host."""
    comp = comp.cpu().numpy()
    T = T.cpu().numpy()
    total = T[-1]
    traces: List[Trace] = []
    if problem is not None:
        val = val.cpu().numpy()
        gn = gn.cpu().numpy()
        x_np = x.cpu().numpy()
        rec = np.arange(record_every, K + 1, record_every)     # steps k
        x0 = torch.as_tensor(problem.x0, dtype=x.dtype, device=x.device)
        f0 = float(problem.f(x0))
        gn0 = float((problem.grad(x0) ** 2).sum())
        for s in range(S):
            times = np.concatenate([[0.0], T[rec - 1, s]])
            vals = np.concatenate([[f0], val[rec - 1, s]])
            gns = np.concatenate([[gn0], gn[rec - 1, s]])
            traces.append(Trace(times, vals, gns, iterations=K,
                                total_time=float(total[s]),
                                gradients_used=used,
                                gradients_computed=int(comp[s]),
                                x_final=x_np[s]))
    else:
        e = np.array([])
        for s in range(S):
            traces.append(Trace(e, e, e, iterations=K,
                                total_time=float(total[s]),
                                gradients_used=used,
                                gradients_computed=int(comp[s])))
    return traces
