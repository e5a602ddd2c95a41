"""The port's attention against the JAX package, on the CPU: RoPE, the
flash-attention kernel's plain version, prefill attention and the
one-token decode over a KV cache.

Inputs are drawn with numpy from a seed and handed to both sides; the
attention weights come from the reference's ``Model.init_params``,
carried across by ``model_params_from``. The reference's Pallas kernel
``flash_attention_pallas`` does not trace on this jax (``jax.experimental
.pallas`` has no ``load`` on jax 0.9.0, ROADMAP R2), so the port's plain
version is held to the reference's oracle ``kernels/ref.py::
attention_ref``, and the kernel itself to its plain version on the card
(``tests/test_torch_cuda.py``).

Tolerances, max |got - want| against max |want|:
* RoPE: 1e-6 in float32 (the frequencies ``theta ** (-i / half)`` may
  round one ulp apart between the two frameworks); in bfloat16 one ulp
  of bfloat16 (2**-7), for a float32 product that rounds the other way.
* attention, float32: 2e-5 (the same math, sums in another order).
* attention, bfloat16: the ref branches (``impl="ref"`` and the decode)
  round q.k, the softmax weights and the output to bfloat16 at the same
  places, so one ulp of bfloat16 (2**-7) covers a product that rounds
  the other way; the port's plain version of the kernel and the port's
  default path on the CPU, which runs it, keep scores and weights in
  float32, as the TPU kernel does, and differ from a bfloat16 ref branch
  by design: 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels.ref import attention_ref
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models.layers import rope as ref_rope
from repro.sharding.specs import ShardCtx
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params_from
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention
from repro_torch.models.layers import rope

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
BF16_REF_TOL = 2.0 ** -7


def _rel_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(a, dtype):
    """A numpy array as a torch tensor and a jax array of ``dtype``."""
    tdt, jdt, _ = DTYPES[dtype]
    return torch.tensor(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_reference(dtype, batched):
    g = np.random.default_rng(7)
    x = g.normal(size=(2, 37, 3, 64)).astype(np.float32)
    pos = (g.integers(0, 8192, size=(2, 37)) if batched else np.arange(37))
    xt, xj = _both(x, dtype)
    got = rope(xt, torch.tensor(pos), 500000.0)
    want = ref_rope(xj, jnp.asarray(pos), 500000.0)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert _rel_max(_np(got), _np(want)) <= tol


def _qkv(seed, B, Sq, Sk, H, KV, dh):
    g = np.random.default_rng(seed)
    q = g.normal(size=(B, Sq, H, dh)).astype(np.float32)
    k = g.normal(size=(B, Sk, KV, dh)).astype(np.float32)
    v = g.normal(size=(B, Sk, KV, dh)).astype(np.float32)
    return q, k, v


def _has_key(Sq, Sk, causal, window):
    """(Sq,) bool: rows with at least one valid key."""
    qi = np.arange(Sq)[:, None]
    ki = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return ok.any(axis=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk", [(37, 37), (65, 10), (9, 40)])
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("window", [None, 1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_attention_ref(causal, window, group, Sq, Sk, dtype):
    q, k, v = _qkv(Sq * Sk + group, 2, Sq, Sk, 2 * group, 2, 16)
    (qt, qj), (kt, kj), (vt, vj) = (_both(a, dtype) for a in (q, k, v))
    got = fa.flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    want = attention_ref(qj, kj, vj, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    rows = _has_key(Sq, Sk, causal, window)
    got, want = _np(got), _np(want)
    assert _rel_max(got[:, rows], want[:, rows]) <= DTYPES[dtype][2]
    # rows with no valid key: zeros, as the TPU kernel gives
    assert not np.any(got[:, ~rows])
    if causal and window is not None and Sq > Sk + window:
        assert not rows.all()


def test_wrapper_uses_the_plain_version_on_the_cpu():
    q, k, v = map(torch.tensor, _qkv(1, 1, 20, 20, 6, 2, 32))
    want = fa.flash_attention_plain(q, k, v, window=3)
    before = fa.launch_counts["flash_attention"]
    for impl in (None, "ref"):
        assert torch.equal(fa.flash_attention(q, k, v, window=3, impl=impl),
                           want)
    assert fa.launch_counts["flash_attention"] == before


def test_plain_float64_is_float64():
    q, k, v = (torch.tensor(a, dtype=torch.float64)
               for a in _qkv(2, 1, 9, 9, 2, 1, 8))
    got = fa.flash_attention_plain(q, k, v)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == torch.float64
    assert _rel_max(got.numpy(), want.numpy()) <= 1e-6


@pytest.mark.parametrize("bad", ["kernel_on_cpu", "impl", "heads", "v_shape",
                                 "window", "dims"])
def test_wrapper_refuses(bad):
    q, k, v = map(torch.tensor, _qkv(3, 1, 8, 8, 4, 2, 32))
    kw = {}
    if bad == "kernel_on_cpu":
        kw["impl"] = "kernel"
    elif bad == "impl":
        kw["impl"] = "pallas"
    elif bad == "heads":
        k, v = (torch.cat([a, a[:, :, :1]], dim=2) for a in (k, v))
    elif bad == "v_shape":
        v = v[:, :7]
    elif bad == "window":
        kw["window"] = 0
    else:
        q = q[0]
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, **kw)


# ------------------------------------------------------------ the mixer

# the reduced llama at d_model 48 (4 heads of 12, 2 KV heads) and a variant with GQA
# group 3 and a sliding window
VARIANTS = {"gqa2": {},
            "gqa3_window": dict(num_heads=6, num_kv_heads=2, head_dim=8,
                                sliding_window=5)}


def _mixer_pair(variant, dtype, seed=0):
    """The reference config and one layer's attention weights, and the
    port's config with the same weights carried across."""
    kw = dict(d_model=48, layers_per_stage=1, vocab=64)
    ref_cfg = ref_reduced(ref_get_config("llama3.2-3b"), **kw)
    cfg = reduced(get_config("llama3.2-3b"), **kw)
    over = VARIANTS[variant]
    ref_cfg = dataclasses.replace(
        ref_cfg, dtype=dtype, attn=dataclasses.replace(ref_cfg.attn, **over))
    cfg = dataclasses.replace(
        cfg, dtype=dtype, attn=dataclasses.replace(cfg.attn, **over))
    ref_params = ref_build_model(ref_cfg).init_params(jax.random.key(seed))
    params = model_params_from(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    ref_p = jax.tree.map(lambda a: a[0], ref_params["stages"][0])["b0"]
    return ref_cfg, ref_p["mixer"], cfg, params["stages"][0][0]["b0"]["mixer"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("impl", [None, "ref"])
def test_attn_apply_matches_reference(impl, variant, dtype):
    ref_cfg, ref_p, cfg, p = _mixer_pair(variant, dtype)
    x = np.random.default_rng(5).normal(size=(2, 23, 48)).astype(np.float32)
    xt, xj = _both(x, dtype)
    want = ref_attention.attn_apply(ref_p, xj, ShardCtx.null(), ref_cfg,
                                    causal=True, impl="ref")
    got = attention.attn_apply(p, xt, cfg, causal=True, impl=impl)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = (BF16_REF_TOL if impl == "ref" and dtype == "bfloat16"
           else DTYPES[dtype][2])
    assert _rel_max(_np(got), _np(want)) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_attn_matches_reference(variant, dtype):
    ref_cfg, ref_p, cfg, p = _mixer_pair(variant, dtype, seed=1)
    a = cfg.attn
    tol = BF16_REF_TOL if dtype == "bfloat16" else DTYPES[dtype][2]
    B, steps, Smax = 2, 9, 16
    xs = np.random.default_rng(6).normal(size=(steps, B, 1, 48)).astype(
        np.float32)
    ref_cache = ref_attention.init_kv_cache(B, Smax, a.num_kv_heads,
                                            a.head_dim, DTYPES[dtype][1])
    cache = attention.init_kv_cache(B, Smax, a.num_kv_heads, a.head_dim,
                                    DTYPES[dtype][0], device="cpu")
    for t in range(steps):
        xt, xj = _both(xs[t], dtype)
        want, ref_cache = ref_attention.decode_attn_apply(
            ref_p, xj, ref_cache, jnp.asarray(t, jnp.int32),
            ShardCtx.null(), ref_cfg)
        got, cache = attention.decode_attn_apply(p, xt, cache, t, cfg)
        assert got.shape == (B, 1, 48) and got.dtype == xt.dtype
        assert _rel_max(_np(got), _np(want)) <= tol
    for name in ("k", "v"):
        assert cache[name].dtype == DTYPES[dtype][0]
        assert _rel_max(_np(cache[name]), _np(ref_cache[name])) <= tol
        assert not cache[name][:, steps:].any()


def test_attn_apply_refuses_bad_impl():
    _, _, cfg, p = _mixer_pair("gqa2", "float32")
    x = torch.zeros((1, 4, 48))
    for impl, exc in (("kernel", ValueError), ("pallas", ValueError)):
        with pytest.raises(exc):
            attention.attn_apply(p, x, cfg, impl=impl)
