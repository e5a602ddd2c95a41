"""The port on the GPU: the CUDA kernel against its plain version, and the
simulator on the card against the same run on the CPU.

Every test here needs a card and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine with PyTorch
alone: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import simulate_batch
from repro_torch.core import rng
from repro_torch.core.oracle import quadratic_worst_case_torch
from repro_torch.core.time_models import (FixedTimes, exponential_times,
                                          powers_figure3)
from repro_torch.kernels import order_stats

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _rows(S, n, dtype, seed):
    """Tie-heavy, +inf, negative, subnormal and ordinary rows."""
    g = np.random.default_rng(seed)
    x = g.integers(-5, 6, size=(S, n)).astype(np.float64)
    x[0] = np.inf
    x[1, : n // 2] = np.inf
    if S > 2:
        x[2] = g.normal(size=n)
    if S > 3:
        tiny = np.finfo(np.float32 if dtype == torch.float32
                        else np.float64).smallest_subnormal
        x[3] = tiny * g.integers(0, 4, size=n)
    return torch.tensor(x, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,n", [(128, 1000), (7, 9000), (5, 257), (4, 1)])
def test_kernel_equals_plain_bitwise(cuda, S, n, dtype):
    x = _rows(S, n, dtype, seed=S * n).to(cuda)
    for m in sorted({1, min(2, n), max(1, n // 3), n}):
        got = order_stats.mth_smallest(x, m)
        want = order_stats.mth_smallest_plain(x, m)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, got, want)


def test_kernel_counts_its_launches(cuda):
    x = torch.rand(3, 50, device=cuda)
    before = order_stats.launch_counts["mth_smallest"]
    order_stats.mth_smallest(x, 7)
    order_stats.mth_smallest_plain(x, 7)
    assert order_stats.launch_counts["mth_smallest"] == before + 1


@pytest.mark.parametrize("bad", ["int", "strided", "half"])
def test_kernel_wrapper_refuses(cuda, bad):
    x = torch.rand(4, 64, device=cuda)
    x = {"int": x.to(torch.int32), "strided": x[:, ::2],
         "half": x.half()}[bad]
    with pytest.raises((TypeError, ValueError)):
        order_stats.mth_smallest(x, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_counter_rng_same_bits_on_card_and_cpu(cuda, dtype):
    seeds = [0, 1, 2 ** 33, 77]
    on_card = rng.uniforms(rng.seed_keys(seeds, cuda), 5, rng.ORACLE, 1000,
                           dtype)
    on_cpu = rng.uniforms(rng.seed_keys(seeds, "cpu"), 5, rng.ORACLE, 1000,
                          dtype)
    assert torch.equal(on_card.cpu(), on_cpu)


def test_fixed_run_on_card_equals_cpu_and_launches_once_per_round(cuda):
    model = FixedTimes.sqrt_law(200)
    before = order_stats.launch_counts["mth_smallest"]
    card = simulate_batch(("msync", {"m": 17}), model, 300, seeds=16,
                          device=cuda)
    assert order_stats.launch_counts["mth_smallest"] == before + 300
    cpu = simulate_batch(("msync", {"m": 17}), model, 300, seeds=16,
                         device="cpu")
    assert np.array_equal(card.total_time, cpu.total_time)
    assert np.array_equal(card.stat("gradients_computed"),
                          cpu.stat("gradients_computed"))


@pytest.mark.parametrize("model", ["exponential", "fig3"])
def test_sampled_math_run_on_card_matches_cpu(cuda, model):
    model = (exponential_times(1.0, 64) if model == "exponential"
             else powers_figure3(n=64, seed=1, t_max=100.0))
    problem = quadratic_worst_case_torch(d=32, p=0.2)
    kw = dict(K=80, problem=problem, gamma=1.0, seeds=8)
    card = simulate_batch(("msync", {"m": 9}), model, device=cuda, **kw)
    cpu = simulate_batch(("msync", {"m": 9}), model, device="cpu", **kw)
    for a, b in zip(card.traces[0], cpu.traces[0]):
        np.testing.assert_allclose(a.times, b.times, rtol=1e-5)
        np.testing.assert_allclose(a.values, b.values, rtol=1e-4,
                                   atol=1e-6)
        assert a.gradients_computed == b.gradients_computed
