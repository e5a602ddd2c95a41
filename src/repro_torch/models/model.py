"""Top-level model: the port of ``src/repro/models/model.py``.

``build_model(cfg) -> Model`` with ``init_params`` / ``apply`` /
``prefill`` / ``init_cache`` / ``decode_step``, on one device. Training
(``loss``), the audio encoder and VLM patch embeddings are not ported
yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import init_embedding, init_norm, norm_apply
from .transformer import (init_stage, init_stage_cache, model_dtype,
                          stage_apply, stage_decode)

__all__ = ["Model", "build_model"]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    # ---------------- params ----------------
    def init_params(self, gen: torch.Generator) -> dict:
        """Parameters from the reference's init formulas, drawn from
        ``gen`` on its device (the bits differ from JAX's)."""
        cfg = self.cfg
        if cfg.encoder is not None:
            raise NotImplementedError("the encoder is not ported yet "
                                      "(ROADMAP Queue A10)")
        dt = model_dtype(cfg)
        params: Dict[str, Any] = {
            "embed": init_embedding(
                gen, cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                max_pos=cfg.max_seq_len if cfg.pos_embed == "learned" else 0,
                learned_pos=cfg.pos_embed == "learned", dtype=dt),
            "final_norm": init_norm(cfg.d_model, cfg.norm, dt, gen.device),
            "stages": [init_stage(gen, cfg, s) for s in cfg.stages],
        }
        return params

    # ---------------- embedding helpers ----------------
    def _embed(self, params, tokens, offset: int = 0):
        cfg = self.cfg
        x = params["embed"]["embed"][tokens]            # (B, S, D)
        # the scale is rounded to the activation dtype first, as in JAX
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        if cfg.pos_embed == "learned":
            S = tokens.shape[1]
            x = x + params["embed"]["pos_embed"][offset:offset + S][None]
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = norm_apply(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            return x @ params["embed"]["embed"].T
        return x @ params["embed"]["unembed"]

    def _hidden(self, params, tokens, impl: Optional[str]):
        x = self._embed(params, tokens)
        for sp, s in zip(params["stages"], self.cfg.stages):
            x = stage_apply(sp, x, s, self.cfg, impl=impl)
        return x

    # ---------------- forward ----------------
    def apply(self, params, tokens, *, impl: Optional[str] = None,
              extra_embeds=None, frames=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward pass -> (logits (B, S, vocab), aux_loss).

        ``impl`` picks the RWKV scan and the attention core
        (:data:`repro_torch.models.ssm.IMPLS`,
        :data:`repro_torch.models.attention.IMPLS`): by default the CUDA
        kernels on the card. ``aux_loss`` is the MoE router loss, zero
        for the blocks the port has.
        """
        if extra_embeds is not None or frames is not None:
            raise NotImplementedError("VLM patch embeddings and audio frames "
                                      "are not ported yet (ROADMAP Queue A10)")
        x = self._hidden(params, tokens, impl)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(params, x), aux

    def loss(self, *args, **kwargs):
        raise NotImplementedError("training is not ported yet "
                                  "(ROADMAP Queue A11)")

    # ---------------- serving ----------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        """Decode state for ``batch`` sequences of up to ``max_len`` tokens
        on ``device`` (the GPU unless the caller passes ``device="cpu"``).
        Attention blocks get a KV cache of ``max_len`` positions; RWKV
        blocks keep a fixed-size state and ignore it."""
        cfg = self.cfg
        return {"stages": [init_stage_cache(cfg, s, batch, max_len, device)
                           for s in cfg.stages],
                "len": 0}

    def prefill(self, params, tokens, *, impl: Optional[str] = None):
        """Full forward over the prompt -> last-position logits (B, vocab).

        Only the last position goes through the output projection, which
        gives the reference's ``apply(...)[0][:, -1]`` without the
        ``(B, S, vocab)`` logits."""
        x = self._hidden(params, tokens, impl)
        return self._logits(params, x[:, -1:])[:, 0]

    def decode_step(self, params, token, cache):
        """One decode step. token: (B, 1) int -> (logits (B, V), cache).
        KV caches are written in place at position ``cache["len"]``."""
        cfg = self.cfg
        cache_len = cache["len"]
        x = self._embed(params, token, offset=cache_len)
        new_stages = []
        for sp, sc, s in zip(params["stages"], cache["stages"], cfg.stages):
            x, nc = stage_decode(sp, x, sc, s, cache_len, cfg)
            new_stages.append(nc)
        logits = self._logits(params, x)[:, 0]
        return logits, {"stages": new_stages, "len": cache_len + 1}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
