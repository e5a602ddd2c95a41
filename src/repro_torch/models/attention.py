"""Grouped-query attention with a KV cache: the port of
``src/repro/models/attention.py``.

Prefill (:func:`attn_apply`) runs the whole sequence through the
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`) on
the card; decode (:func:`decode_attn_apply`) is plain masked attention of
one new token over the cache, as in the reference, whose decode never
reaches its Pallas kernel. The q/k/v/o projections are matrix products
outside the kernel, as in JAX.

The reference's sharding modes (``ShardCtx``/``AttnMode``) serve its TPU
mesh; the port runs on one device and drops them. Cross-attention waits
for the encoder (ROADMAP Queue A10) and the read-only ``static_cache``
decode for the dry-run launcher (ROADMAP Queue A11).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels.flash_attention import IMPLS, _valid, flash_attention
from .layers import dense_init, rope

__all__ = ["init_attn", "attn_apply", "init_kv_cache", "decode_attn_apply",
           "IMPLS"]


def init_attn(gen: torch.Generator, d: int, num_heads: int,
              num_kv_heads: int, head_dim: int, dtype=torch.float32) -> dict:
    return {
        "wq": dense_init(gen, (d, num_heads * head_dim), dtype=dtype),
        "wk": dense_init(gen, (d, num_kv_heads * head_dim), dtype=dtype),
        "wv": dense_init(gen, (d, num_kv_heads * head_dim), dtype=dtype),
        "wo": dense_init(gen, (num_heads * head_dim, d), dtype=dtype),
    }


def _scaled_scores(q, k, dh):
    """``q . k / sqrt(dh)`` in the activation dtype, the scale rounded to
    that dtype first as JAX does with a weakly typed scalar; then
    float32. q: (B, Sq, H, dh), k: (B, Sk, H, dh) -> (B, H, Sq, Sk)."""
    scale = torch.tensor(math.sqrt(dh), dtype=q.dtype, device=q.device)
    return (torch.einsum("bqhd,bkhd->bhqk", q, k) / scale).float()


def attn_apply(p: dict, x: torch.Tensor, cfg, *, causal: bool = True,
               positions: Optional[torch.Tensor] = None,
               impl: Optional[str] = None) -> torch.Tensor:
    """Full (prefill) self-attention. x: (B, S, D) -> (B, S, D).

    ``impl`` picks the attention core (:data:`IMPLS`): the default runs
    the CUDA kernel for a CUDA tensor and the kernel's plain version for
    a CPU tensor; ``"kernel"`` forces the kernel; ``"ref"`` runs the
    reference's own ref branch (scores in the activation dtype, float32
    softmax, weights cast back before the product with v), which the
    reference runs by default.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    a = cfg.attn
    B, S, _ = x.shape
    H, KV, dh = a.num_heads, a.num_kv_heads, a.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    if a.rope_theta is not None:
        pos = (torch.arange(S, device=x.device) if positions is None
               else positions)
        q = rope(q, pos, a.rope_theta)
        k = rope(k, pos, a.rope_theta)
    if impl == "ref":
        group = H // KV
        kq = k.repeat_interleave(group, dim=2)
        vq = v.repeat_interleave(group, dim=2)
        scores = _scaled_scores(q, kq, dh)
        if causal:
            mask = _valid(S, S, True, a.sliding_window, x.device)
            scores = torch.where(mask, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, vq)
    else:
        o = flash_attention(q, k, v, causal=causal, window=a.sliding_window,
                            impl=impl)
    return o.reshape(B, S, H * dh) @ p["wo"]


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """Zeroed k and v of shape (batch, max_len, KV, dh) on ``device`` (the
    GPU unless the caller passes ``device="cpu"``)."""
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attn_apply(p: dict, x: torch.Tensor, cache: dict,
                      cache_len: int, cfg) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); cache k/v: (B, Smax, KV, dh).

    The new token's k and v are written into the cache at ``cache_len``
    in place (the reference returns an updated copy), then the token
    attends over positions ``< cache_len + 1`` (and inside the window).
    Returns (out (B, 1, D), cache)."""
    a = cfg.attn
    B = x.shape[0]
    H, KV, dh = a.num_heads, a.num_kv_heads, a.head_dim
    group = H // KV
    Smax = cache["k"].shape[1]
    q = (x @ p["wq"]).reshape(B, 1, H, dh)
    k_new = (x @ p["wk"]).reshape(B, 1, KV, dh)
    v_new = (x @ p["wv"]).reshape(B, 1, KV, dh)
    if a.rope_theta is not None:
        pos = torch.full((B, 1), cache_len, dtype=torch.int32,
                         device=x.device)
        q = rope(q, pos, a.rope_theta)
        k_new = rope(k_new, pos, a.rope_theta)
    cache["k"][:, cache_len] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, cache_len] = v_new[:, 0].to(cache["v"].dtype)
    kq = cache["k"].repeat_interleave(group, dim=2).to(x.dtype)
    vq = cache["v"].repeat_interleave(group, dim=2).to(x.dtype)
    scores = _scaled_scores(q, kq, dh)                  # (B, H, 1, Smax)
    positions = torch.arange(Smax, device=x.device)
    valid = positions < cache_len + 1
    if a.sliding_window is not None:
        valid &= positions > cache_len - a.sliding_window
    scores = torch.where(valid, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w, vq)
    return o.reshape(B, 1, H * dh) @ p["wo"], cache
