"""Blocks and stages: the port of ``src/repro/models/transformer.py``.

The reference stacks each stage's repeated pattern on a leading
``(repeats,)`` axis and runs it under ``lax.scan``; the port keeps a
stage's parameters as a list with one entry per repeat and runs it as a
loop over layers. Only the blocks whose mixer and feed-forward the port
has are built; the others raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..configs.base import Block, ModelConfig, Stage
from .attention import (attn_apply, decode_attn_apply, init_attn,
                        init_kv_cache)
from .layers import init_mlp, init_norm, mlp_apply, norm_apply
from .ssm import init_rwkv, init_rwkv_state, rwkv_apply, rwkv_decode

__all__ = ["init_block", "init_stage", "stage_apply", "init_block_cache",
           "init_stage_cache", "stage_decode", "model_dtype"]

_NOT_PORTED = {
    "cross": "cross-attention waits for the encoder (ROADMAP Queue A10)",
    "mamba": "the Mamba mixer is not ported yet (ROADMAP Queue A10)",
    "moe": "the MoE feed-forward waits for the grouped-matmul kernel "
           "(ROADMAP Queue B2)",
}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    """Activation and parameter dtype of ``cfg``."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_block(block: Block) -> None:
    for kind in (block.mixer, block.ff):
        if kind in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[kind])
    if block.mixer not in ("attn", "rwkv"):
        raise ValueError(f"unknown mixer {block.mixer!r}")
    if block.ff not in ("mlp", "none"):
        raise ValueError(f"unknown feed-forward {block.ff!r}")


def init_block(gen: torch.Generator, cfg: ModelConfig, block: Block) -> dict:
    _check_block(block)
    dt = model_dtype(cfg)
    d = cfg.d_model
    p = {"norm1": init_norm(d, cfg.norm, dt, gen.device)}
    if block.mixer == "attn":
        a = cfg.attn
        p["mixer"] = init_attn(gen, d, a.num_heads, a.num_kv_heads,
                               a.head_dim, dtype=dt)
    else:
        p["mixer"] = init_rwkv(gen, d, cfg.ssm.head_dim, dtype=dt)
    if block.ff != "none":
        p["norm2"] = init_norm(d, cfg.norm, dt, gen.device)
        p["ff"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_act, dtype=dt)
    return p


def init_stage(gen: torch.Generator, cfg: ModelConfig, stage: Stage
               ) -> List[dict]:
    """One ``{"b<i>": block params}`` dict per repeat of the pattern."""
    return [{f"b{i}": init_block(gen, cfg, b)
             for i, b in enumerate(stage.pattern)}
            for _ in range(stage.repeats)]


def _block_apply(p: dict, x, block: Block, cfg, impl: Optional[str]):
    """One block forward (prefill)."""
    _check_block(block)
    h = norm_apply(p["norm1"], x, cfg.norm_eps)
    if block.mixer == "attn":
        h = attn_apply(p["mixer"], h, cfg, causal=cfg.attn.causal, impl=impl)
    else:
        h = rwkv_apply(p["mixer"], h, cfg, impl=impl)
    x = x + h
    if block.ff != "none":
        h = norm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(p["ff"], h, cfg.mlp_act)
    return x


def stage_apply(params: List[dict], x, stage: Stage, cfg,
                impl: Optional[str] = None):
    """Forward through a stage, layer by layer."""
    for unit in params:
        for i, b in enumerate(stage.pattern):
            x = _block_apply(unit[f"b{i}"], x, b, cfg, impl)
    return x


def init_block_cache(cfg: ModelConfig, block: Block, batch: int,
                     max_len: int, device="cuda") -> dict:
    """A KV cache of ``max_len`` positions for an attention block, the
    recurrent state (which ignores ``max_len``) for an RWKV block."""
    _check_block(block)
    if block.mixer == "attn":
        a = cfg.attn
        return init_kv_cache(batch, max_len, a.num_kv_heads, a.head_dim,
                             model_dtype(cfg), device)
    return init_rwkv_state(batch, cfg.d_model, cfg.ssm.head_dim,
                           model_dtype(cfg), device)


def init_stage_cache(cfg: ModelConfig, stage: Stage, batch: int,
                     max_len: int, device="cuda") -> List[dict]:
    """Per-repeat caches matching :func:`init_stage`'s layout."""
    return [{f"b{i}": init_block_cache(cfg, b, batch, max_len, device)
             for i, b in enumerate(stage.pattern)}
            for _ in range(stage.repeats)]


def _block_decode(p: dict, x, cache, block: Block, cache_len: int, cfg):
    _check_block(block)
    h = norm_apply(p["norm1"], x, cfg.norm_eps)
    if block.mixer == "attn":
        h, cache = decode_attn_apply(p["mixer"], h, cache, cache_len, cfg)
    else:
        h, cache = rwkv_decode(p["mixer"], h, cache, cfg)
    x = x + h
    if block.ff != "none":
        h = norm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(p["ff"], h, cfg.mlp_act)
    return x, cache


def stage_decode(params: List[dict], x, caches: List[dict], stage: Stage,
                 cache_len: int, cfg):
    """One-token decode through a stage -> (x, new caches). KV caches are
    written in place; RWKV states are replaced."""
    new_caches = []
    for unit, unit_cache in zip(params, caches):
        new = {}
        for i, b in enumerate(stage.pattern):
            x, new[f"b{i}"] = _block_decode(unit[f"b{i}"], x,
                                            unit_cache[f"b{i}"], b,
                                            cache_len, cfg)
        new_caches.append(new)
    return x, new_caches
