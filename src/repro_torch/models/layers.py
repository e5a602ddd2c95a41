"""Basic layers: norms, embeddings, MLP, rotary embedding. The port of
``src/repro/models/layers.py``: parameters are nested dicts of tensors
with the reference's leaf names, and every draw comes from an explicit
``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "init_norm", "norm_apply", "init_embedding",
           "init_mlp", "mlp_apply", "rope"]


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init on ``gen``'s device: a standard normal
    cut at +-2, times ``scale`` (``shape[0] ** -0.5`` by default), drawn
    in float32 and rounded to ``dtype``."""
    if scale is None:
        scale = shape[0] ** -0.5
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


def init_norm(d: int, kind: str, dtype=torch.float32, device="cuda") -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm or LayerNorm depending on whether a bias is present.
    Statistics in float32 whatever the activation dtype."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int, tie: bool,
                   max_pos: int = 0, learned_pos: bool = False,
                   dtype=torch.float32) -> dict:
    p = {"embed": dense_init(gen, (vocab, d), scale=d ** -0.5, dtype=dtype)}
    if not tie:
        p["unembed"] = dense_init(gen, (d, vocab), dtype=dtype)
    if learned_pos:
        p["pos_embed"] = dense_init(gen, (max_pos, d), scale=0.02,
                                    dtype=dtype)
    return p


def init_mlp(gen: torch.Generator, d: int, d_ff: int, act: str,
             dtype=torch.float32) -> dict:
    p = {"w_up": dense_init(gen, (d, d_ff), dtype=dtype),
         "w_down": dense_init(gen, (d_ff, d), dtype=dtype)}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, (d, d_ff), dtype=dtype)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """(B, S, D) -> (B, S, D). ``gelu`` is the tanh approximation, which
    is ``jax.nn.gelu``'s default."""
    h = x @ p["w_up"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_down"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, half-split as in the reference: the first and
    second halves of the head dimension are the two coordinates rotated.
    x: (B, S, H, Dh); positions: (B, S) or (S,). Frequencies and angles in
    float32; the product with x promotes to float32 before the cast back
    to x's dtype, as in JAX."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs   # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
