"""Batched serving engine: the port of ``src/repro/serve/engine.py``.

A small but real engine: a fixed number of decode slots, each with its
own batch-1 cache; a finished request's slot is refilled by the next
queued request. A prompt is prefilled token by token through
``Model.decode_step``, as in the reference; sampling is greedy or by
temperature, from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..models import Model

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (P,) int
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: the logits the first new token was sampled from, (vocab,) float32
    #: on the host: the model's prediction after the whole prompt
    first_logits: Optional[torch.Tensor] = None


class ServeEngine:
    def __init__(self, model: Model, params, *, batch_size: int = 8,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 seed: int = 0) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size={batch_size} must be positive")
        self.model = model
        self.params = params
        self.B = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"]["embed"].device
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _decode(self, token: int, cache):
        tok = torch.tensor([[token]], dtype=torch.long, device=self.device)
        return self.model.decode_step(self.params, tok, cache)

    # --------------------------------------------------------- serving
    @torch.inference_mode()
    def generate(self, requests: List[Request]) -> List[Request]:
        """Run all requests to completion with slot-based batching."""
        for req in requests:
            if len(req.prompt) < 1:
                raise ValueError("every request needs a prompt token")
            if len(req.prompt) + req.max_new_tokens > self.max_len:
                raise ValueError(
                    f"prompt {len(req.prompt)} + {req.max_new_tokens} new "
                    f"tokens exceed max_len={self.max_len}")
        queue = deque(requests)
        slots: List[Optional[Request]] = [None] * self.B
        caches: List[Optional[dict]] = [None] * self.B
        budgets = [0] * self.B
        nexts = [0] * self.B               # each slot's next input token

        def refill():
            for i in range(self.B):
                if slots[i] is None and queue:
                    req = queue.popleft()
                    slots[i] = req
                    caches[i] = self.model.init_cache(1, self.max_len,
                                                      self.device)
                    # prefill token by token, as the reference does
                    for t in req.prompt[:-1]:
                        _, caches[i] = self._decode(int(t), caches[i])
                    nexts[i] = int(req.prompt[-1])
                    budgets[i] = req.max_new_tokens

        refill()
        while any(s is not None for s in slots):
            for i in range(self.B):
                req = slots[i]
                if req is None:
                    continue
                logits, caches[i] = self._decode(nexts[i], caches[i])
                if not req.out_tokens:
                    req.first_logits = logits[0].float().cpu()
                nxt = self._sample(logits[0], req.temperature)
                req.out_tokens.append(nxt)
                nexts[i] = nxt
                budgets[i] -= 1
                if budgets[i] <= 0 or (self.eos_id is not None
                                       and nxt == self.eos_id):
                    req.done = True
                    slots[i] = None
                    caches[i] = None
            refill()
        return requests

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        if temperature <= 0.0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))
