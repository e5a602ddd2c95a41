"""The port on the GPU: the CUDA kernels against their plain versions,
the simulator on the card against the same run on the CPU, and the RWKV
model's prefill through its scan kernel.

Every test here needs a card and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine with PyTorch
alone: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import (Request, ServeEngine, build_model, get_config,
                         reduced, simulate_batch)
from repro_torch.core import rng
from repro_torch.core.oracle import quadratic_worst_case_torch
from repro_torch.core.time_models import (FixedTimes, exponential_times,
                                          powers_figure3)
from repro_torch.kernels import order_stats
from repro_torch.kernels import rwkv_scan as rs

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,n", [(6, 9), (5, 257), (7, 9000)])
def test_kernel_orders_signed_zeros_and_nan_as_sort(cuda, S, n, dtype):
    """By value against ``torch.sort`` on the CPU, NaN in the same rows:
    -0.0 equals +0.0 and NaN of either sign sorts last. (On the card,
    ``torch.sort`` of rows of 1000 or more puts a sign-set NaN first.)"""
    g = np.random.default_rng(S * n)
    x = g.integers(-3, 4, size=(S, n)).astype(np.float64)
    pick = g.random((S, n))
    x[pick < 0.2] = -0.0
    x[pick > 0.9] = np.copysign(np.nan, g.random((S, n)) - 0.5)[pick > 0.9]
    x[0] = np.where(pick[0] < 0.5, -0.0, -np.nan)
    x = torch.tensor(x, dtype=dtype)
    for m in sorted({1, 2, n // 2, n - 1, n}):
        got = order_stats.mth_smallest(x.to(cuda), m).cpu()
        want = torch.sort(x, dim=1).values[:, m - 1]
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), m
        assert torch.equal(got[~nan], want[~nan]), m


def _scan_inputs(B, T, H, K, dtype, seed):
    """Decays across the model's range [exp(-e), exp(-e^-8)], one head at
    exactly exp(-e)."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, K), generator=g).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand((B, T, H, K), generator=g) * 9 - 8))
    w[:, :, 0] = float(np.exp(-np.e))
    u = 0.1 * torch.randn((H, K), generator=g)
    return r, k, v, w, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("B,T,H", [(1, 1, 1), (2, 17, 3), (1, 65, 40),
                                   (2, 130, 4)])
def test_rwkv_kernel_matches_f64_recurrence(cuda, B, T, H, K, dtype):
    r, k, v, w, u = _scan_inputs(B, T, H, K, dtype, seed=T * K + H)
    y, s = rs.rwkv_scan(*(a.to(cuda) for a in (r, k, v, w, u)))
    torch.cuda.synchronize()
    y64, s64 = rs.rwkv_scan_plain(*(a.double() for a in (r, k, v, w, u)))
    assert y.dtype == s.dtype == torch.float32
    for got, want in ((y, y64), (s, s64)):
        err = (got.cpu().double() - want).abs().max() / want.abs().max()
        assert err <= 2e-4, float(err)


def test_rwkv_kernel_counts_its_launches(cuda):
    args = [a.to(cuda) for a in _scan_inputs(1, 5, 2, 32, torch.float32,
                                             seed=0)]
    before = rs.launch_counts["rwkv_scan"]
    rs.rwkv_scan(*args)
    rs.rwkv_scan_plain(*args)
    assert rs.launch_counts["rwkv_scan"] == before + 1


@pytest.mark.parametrize("bad", ["head16", "half", "mixed", "w64"])
def test_rwkv_wrapper_refuses(cuda, bad):
    K = 16 if bad == "head16" else 32
    r, k, v, w, u = (a.to(cuda) for a in _scan_inputs(
        1, 5, 2, K, torch.float32, seed=1))
    if bad == "half":
        r, k, v = r.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "w64":
        w = w.double()
    with pytest.raises((TypeError, ValueError)):
        rs.rwkv_scan(r, k, v, w, u)


def _card_model(cuda):
    cfg = reduced(get_config("rwkv6-3b"), d_model=128, layers_per_stage=2,
                  vocab=256)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
    return model, params


def test_model_prefill_on_card_launches_the_kernel(cuda):
    model, params = _card_model(cuda)
    tokens = torch.randint(0, 256, (2, 70), device=cuda)
    before = rs.launch_counts["rwkv_scan"]
    with torch.inference_mode():
        got = model.prefill(params, tokens)
        assert rs.launch_counts["rwkv_scan"] == before + model.cfg.num_layers
        forced = model.prefill(params, tokens, impl="kernel")
        plain = model.prefill(params, tokens, impl="ref")
    assert rs.launch_counts["rwkv_scan"] == before + 2 * model.cfg.num_layers
    assert torch.equal(got, forced)
    assert float((got - plain).norm() / plain.norm()) <= 1e-4


def test_engine_on_card_matches_the_kernel_prefill(cuda):
    model, params = _card_model(cuda)
    g = np.random.default_rng(0)
    reqs = [Request(prompt=g.integers(0, 256, size=n), max_new_tokens=3)
            for n in (5, 20, 66)]
    ServeEngine(model, params, batch_size=2).generate(reqs)
    with torch.inference_mode():
        for req in reqs:
            want = model.prefill(params, torch.tensor(
                req.prompt[None], device=cuda))[0].cpu()
            err = (req.first_logits - want).norm() / want.norm()
            assert float(err) <= 1e-4

