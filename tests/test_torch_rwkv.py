"""The port's RWKV-6 scan and time-mix against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides. The
reference's Pallas scan does not trace on this jax (ROADMAP R2), so the
scan is held to ``ssm.reference_scan`` (which is ``kernels/ref.py::
rwkv_scan_ref``), and the time-mix to ``rwkv_apply(impl="ref")`` and
``rwkv_decode``.

Tolerances: the scan 2e-5 relative to max |y| in float32 (the same
recurrence, sums in another order); 1e-5 for the port's float64 scan
against the reference, which computes in float32 whatever its inputs.
The time-mix rtol = atol = 2e-5: the reference's prefill runs its chunked
form (``chunked_scan``), which agrees with the step recurrence to about
1e-6 at the decays of a freshly initialised layer (w >= 0.5).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import ssm as ref_ssm
from repro.sharding.specs import ShardCtx
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import rwkv_scan as rs
from repro_torch.models import ssm

LEAST_DECAY = math.exp(-math.e)      # the model's least decay, exp(-e)


def _scan_inputs(seed, B, T, H, K, V, w_low=LEAST_DECAY, state=False):
    """r, k, v normal; decays uniform on [w_low, 0.9997], one head held at
    exactly w_low; u as the model draws it; optionally a state0."""
    g = np.random.default_rng(seed)
    r, k = (g.normal(size=(B, T, H, K)).astype(np.float32) for _ in range(2))
    v = g.normal(size=(B, T, H, V)).astype(np.float32)
    w = g.uniform(w_low, 0.9997, size=(B, T, H, K)).astype(np.float32)
    w[:, :, 0] = np.float32(w_low)
    u = (0.1 * g.normal(size=(H, K))).astype(np.float32)
    s0 = g.normal(size=(B, H, K, V)).astype(np.float32) if state else None
    return r, k, v, w, u, s0


def _rel_max(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 .max() / np.abs(np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("T", [1, 37, 70, 129])
@pytest.mark.parametrize("state", [False, True])
def test_plain_scan_matches_reference_f32(T, state):
    r, k, v, w, u, s0 = _scan_inputs(T, 2, T, 3, 8, 5, state=state)
    y_ref, s_ref = ref_ssm.reference_scan(
        *map(jnp.asarray, (r, k, v, w)), u=jnp.asarray(u),
        state0=None if s0 is None else jnp.asarray(s0))
    y, s = rs.rwkv_scan_plain(*map(torch.tensor, (r, k, v, w, u)),
                              None if s0 is None else torch.tensor(s0))
    assert y.dtype == s.dtype == torch.float32
    assert _rel_max(y, y_ref) <= 2e-5
    assert _rel_max(s, s_ref) <= 2e-5


@pytest.mark.parametrize("state", [False, True])
def test_plain_scan_f64_matches_reference(state):
    r, k, v, w, u, s0 = _scan_inputs(3, 1, 70, 2, 8, 8, state=state)
    y_ref, s_ref = ref_ssm.reference_scan(
        *map(jnp.asarray, (r, k, v, w)), u=jnp.asarray(u),
        state0=None if s0 is None else jnp.asarray(s0))
    as64 = (lambda a: torch.tensor(a, dtype=torch.float64))
    y, s = rs.rwkv_scan_plain(*map(as64, (r, k, v, w, u)),
                              None if s0 is None else as64(s0))
    assert y.dtype == s.dtype == torch.float64
    assert _rel_max(y, y_ref) <= 1e-5
    assert _rel_max(s, s_ref) <= 1e-5


def test_wrapper_on_cpu_is_the_plain_scan_and_launches_nothing():
    args = list(map(torch.tensor, _scan_inputs(4, 1, 40, 2, 8, 8)[:5]))
    bf16 = [a.to(torch.bfloat16) for a in args[:3]] + args[3:]
    before = dict(rs.launch_counts)
    for a in (args, bf16):
        y, s = rs.rwkv_scan(*a)
        y_p, s_p = rs.rwkv_scan_plain(*a)
        assert y.dtype == s.dtype == torch.float32
        assert torch.equal(y, y_p) and torch.equal(s, s_p)
    assert rs.launch_counts == before


@pytest.mark.parametrize("bad", ["u", "k", "v", "rank"])
def test_wrapper_refuses_bad_shapes(bad):
    r, k, v, w, u = map(torch.tensor, _scan_inputs(5, 1, 9, 2, 8, 8)[:5])
    if bad == "u":
        u = u[:1]
    elif bad == "k":
        k = k[:, :5]
    elif bad == "v":
        v = v[:, :, :1]
    else:
        r = r[0]
    with pytest.raises(ValueError):
        rs.rwkv_scan(r, k, v, w, u)


def test_wrapper_refuses_other_devices():
    r = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rs.rwkv_scan(r, r, r, r, torch.empty((2, 8), device="meta"))


def test_plain_scan_holds_where_the_chunked_form_underflows():
    """At the model's least decay the step recurrence stays exact while
    the reference's 64-token chunked form, which divides by the chunk's
    running decay product (0.066^33 < 1e-38), is off by the size of y
    itself: ROADMAP R4. So the port's oracle is the step recurrence."""
    B, T, H, K = 1, 128, 2, 64
    g = np.random.default_rng(7)
    r, k, v = (g.normal(size=(B, T, H, K)).astype(np.float32)
               for _ in range(3))
    w = np.full((B, T, H, K), LEAST_DECAY, np.float32)
    u = (0.01 * g.normal(size=(H, K))).astype(np.float32)
    as64 = (lambda a: torch.tensor(a, dtype=torch.float64))
    y64, _ = rs.rwkv_scan_plain(*map(as64, (r, k, v, w, u)))
    y32, _ = rs.rwkv_scan_plain(*map(torch.tensor, (r, k, v, w, u)))
    y_chunked, _ = ref_ssm.chunked_scan(*map(jnp.asarray, (r, k, v, w)),
                                        u=jnp.asarray(u), chunk=64)
    assert _rel_max(y32, y64) <= 1e-6
    assert _rel_max(y_chunked, y64) > 0.1


# ---------------------------------------------------------------------------
# the time-mix layer on the reduced model
# ---------------------------------------------------------------------------

def _cfgs():
    kw = dict(d_model=64, layers_per_stage=2, vocab=128)
    return (ref_reduced(ref_get_config("rwkv6-3b"), **kw),
            reduced(get_config("rwkv6-3b"), **kw))


def _layer(seed=0):
    ref_cfg, cfg = _cfgs()
    p_ref = ref_ssm.init_rwkv(jax.random.key(seed), ref_cfg.d_model,
                              ref_cfg.ssm.head_dim)
    p = {name: torch.tensor(np.asarray(a)) for name, a in p_ref.items()}
    return ref_cfg, cfg, p_ref, p


@pytest.mark.parametrize("S", [1, 20, 70])
def test_rwkv_apply_matches_reference(S):
    ref_cfg, cfg, p_ref, p = _layer()
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)
                                         ).astype(np.float32)
    want = ref_ssm.rwkv_apply(p_ref, jnp.asarray(x), ShardCtx.null(),
                              ref_cfg, impl="ref")
    for impl in (None, "ref"):
        got = ssm.rwkv_apply(p, torch.tensor(x), cfg, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_rwkv_apply_impl_choices():
    _, cfg, _, p = _layer()
    x = torch.zeros((1, 3, cfg.d_model))
    with pytest.raises(ValueError, match="CUDA"):
        ssm.rwkv_apply(p, x, cfg, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ssm.rwkv_apply(p, x, cfg, impl="pallas")


def test_rwkv_decode_matches_reference_and_prefill():
    """Token by token from a zero state: the same outputs and state as the
    reference's decode, and the same outputs as the prefill (whose token
    shift pads token 0 with zeros, as decode starts from x_prev = 0)."""
    ref_cfg, cfg, p_ref, p = _layer(1)
    B, S = 2, 9
    x = np.random.default_rng(2).normal(size=(B, S, cfg.d_model)
                                         ).astype(np.float32)
    st_ref = ref_ssm.init_rwkv_state(B, ref_cfg.d_model, ref_cfg.ssm.head_dim)
    st = ssm.init_rwkv_state(B, cfg.d_model, cfg.ssm.head_dim, device="cpu")
    outs = []
    for t in range(S):
        o_ref, st_ref = ref_ssm.rwkv_decode(p_ref, jnp.asarray(x[:, t:t + 1]),
                                            st_ref, ShardCtx.null(), ref_cfg)
        o, st = ssm.rwkv_decode(p, torch.tensor(x[:, t:t + 1]), st, cfg)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-5,
                                   atol=2e-5)
        outs.append(o)
    np.testing.assert_allclose(st["s"].numpy(), np.asarray(st_ref["s"]),
                               rtol=2e-5, atol=2e-5)
    assert st["s"].dtype == torch.float32
    prefill = ssm.rwkv_apply(p, torch.tensor(x), cfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), prefill.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_init_rwkv_follows_the_reference_formulas():
    """Same leaves, shapes and dtypes as the reference's init; the
    deterministic leaves are equal after rounding to bfloat16, and the
    random ones have the reference's scale."""
    d, hd = 256, 64
    ref = ref_ssm.init_rwkv(jax.random.key(0), d, hd, dtype=jnp.bfloat16)
    got = ssm.init_rwkv(torch.Generator().manual_seed(0), d, hd,
                        dtype=torch.bfloat16)
    assert sorted(ref) == sorted(got)
    for name, a in ref.items():
        assert tuple(a.shape) == tuple(got[name].shape), name
        assert got[name].dtype == torch.bfloat16
    for name in ("rwkv_mix", "rwkv_decay_mix"):
        assert np.array_equal(np.asarray(ref[name].astype(jnp.float32)),
                              got[name].float().numpy()), name
    for name in ("rwkv_r", "rwkv_w", "rwkv_u"):
        want = float(jnp.std(ref[name].astype(jnp.float32)))
        assert abs(float(got[name].float().std()) / want - 1) < 0.1, name

