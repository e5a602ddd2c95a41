"""The port on the GPU: the CUDA kernels against their plain versions,
the simulator on the card against the same run on the CPU, and the
prefills of the RWKV and attention models through their kernels.

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
from repro_torch.kernels import flash_attention as fa
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


# (B, Sq, Sk, H, KV, dh, causal, window): small shapes of the kinds the
# attn_kernel phase of chip_smoke.py checks, at every head size the
# kernel is built for
FLASH_CASES = [
    (1, 1, 1, 24, 8, 128, True, None),
    (2, 63, 63, 24, 8, 128, True, None),
    (1, 65, 65, 3, 1, 64, True, None),
    (1, 129, 129, 4, 4, 32, True, None),
    (2, 100, 100, 6, 2, 64, False, None),
    (1, 130, 130, 6, 2, 128, True, 1),
    (1, 130, 130, 3, 1, 32, True, 64),
    (2, 70, 70, 6, 2, 64, False, 1000),
    (1, 150, 40, 6, 2, 128, True, 16),     # rows with no valid key
    (1, 40, 150, 6, 2, 64, True, None),
]
# max |o - o64| <= tol * max |o64| once each element's rounding to the
# output type (unit roundoff u times |o64|) is taken off: no kernel with a
# bfloat16 output can do better than u = 2**-8 of an element; past that,
# float32 arithmetic is all that is left for either input type
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-5}
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}


def _flash_inputs(B, Sq, Sk, H, KV, dh, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, H, dh), generator=g).to(dtype)
    k, v = (torch.randn((B, Sk, KV, dh), generator=g).to(dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh,causal,window", FLASH_CASES)
def test_flash_kernel_matches_f64_plain(cuda, B, Sq, Sk, H, KV, dh, causal,
                                        window, dtype):
    q, k, v = _flash_inputs(B, Sq, Sk, H, KV, dh, dtype, seed=Sq * H + dh)
    o = fa.flash_attention(*(a.to(cuda) for a in (q, k, v)), causal=causal,
                           window=window, impl="kernel")
    torch.cuda.synchronize()
    o64 = fa.flash_attention_plain(*(a.double() for a in (q, k, v)),
                                   causal=causal, window=window)
    assert o.dtype == dtype and o.shape == q.shape
    excess = ((o.cpu().double() - o64).abs()
              - UNIT_ROUNDOFF[dtype] * o64.abs()).max()
    assert float(excess / o64.abs().max()) <= FLASH_TOL[dtype]
    empty = o64.abs().amax(dim=(0, 2, 3)) == 0
    assert not o.cpu()[:, empty].any()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_head_split_views(cuda, dtype, aligned):
    """q, k, v cut out of one packed projection, as strided views; with
    the buffer one element off 16-byte alignment the kernel reads its
    tiles one element a load."""
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (2, 77, 6 + 2 + 2, 64)
    flat = torch.randn(2 * 77 * 10 * 64 + 1, generator=g,
                       device=cuda).to(dtype)
    qkv = (flat[:-1] if aligned else flat[1:]).view(shape)
    assert (qkv.data_ptr() % 16 == 0) == aligned
    q, k, v = qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_flash_kernel_counts_its_launches(cuda):
    q, k, v = (a.to(cuda) for a in _flash_inputs(1, 5, 5, 2, 1, 32,
                                                 torch.float32, seed=0))
    before = fa.launch_counts["flash_attention"]
    fa.flash_attention(q, k, v)
    fa.flash_attention(q, k, v, impl="ref")
    fa.flash_attention_plain(q, k, v)
    assert fa.launch_counts["flash_attention"] == before + 1


@pytest.mark.parametrize("bad", ["head96", "half", "mixed", "strided_d"])
def test_flash_wrapper_refuses(cuda, bad):
    dh = 96 if bad == "head96" else 64
    q, k, v = (a.to(cuda) for a in _flash_inputs(1, 9, 9, 4, 2, dh,
                                                 torch.float32, seed=1))
    if bad == "half":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "strided_d":
        q = q[..., ::2]
        k, v = k[..., ::2], v[..., ::2]
    with pytest.raises((TypeError, ValueError), match="96|32, 64|float|"
                       "contiguous"):
        fa.flash_attention(q, k, v)


# the kernel each architecture's prefill launches once a layer; llama at
# full depth (28 layers), reduced width (4 heads of 32)
CARD_MODELS = {"rwkv6-3b": (rs, "rwkv_scan", 2),
               "llama3.2-3b": (fa, "flash_attention", 28)}


def _card_model(cuda, arch):
    cfg = reduced(get_config(arch), d_model=128,
                  layers_per_stage=CARD_MODELS[arch][2], vocab=256)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
    return model, params


@pytest.mark.parametrize("arch", sorted(CARD_MODELS))
def test_model_prefill_on_card_launches_the_kernel(cuda, arch):
    module, name, _ = CARD_MODELS[arch]
    model, params = _card_model(cuda, arch)
    tokens = torch.randint(0, 256, (2, 70), device=cuda)
    layers = model.cfg.num_layers
    before = module.launch_counts[name]
    with torch.inference_mode():
        got = model.prefill(params, tokens)
        assert module.launch_counts[name] == before + layers
        forced = model.prefill(params, tokens, impl="kernel")
        plain = model.prefill(params, tokens, impl="ref")
    assert module.launch_counts[name] == before + 2 * layers
    assert torch.equal(got, forced)
    assert float((got - plain).norm() / plain.norm()) <= 1e-4


@pytest.mark.parametrize("arch", sorted(CARD_MODELS))
def test_engine_on_card_matches_the_kernel_prefill(cuda, arch):
    model, params = _card_model(cuda, arch)
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

