"""RWKV-6 ("Finch") time-mix: the port of the RWKV part of
``src/repro/models/ssm.py``.

Per head, a diagonal-decay outer-product recurrence over the state
``S_t`` of shape ``(K, V)``, with a data-dependent decay
``w_t = exp(-exp(ww_t))`` from a token-shift mix and a bonus ``u`` for
the current token (see :mod:`repro_torch.kernels.rwkv_scan`).
[arXiv:2404.05892]

Prefill (:func:`rwkv_apply`) runs the whole sequence through the scan;
decode (:func:`rwkv_decode`) is the single-step update on a carried state.
The reference's padded-head branch serves its device mesh only; the port
runs on one device and has no such branch. The Mamba mixer is not ported
yet (ROADMAP Queue A10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rwkv_scan import rwkv_scan, rwkv_scan_plain
from .layers import dense_init

__all__ = ["init_rwkv", "init_rwkv_state", "rwkv_apply", "rwkv_decode",
           "IMPLS"]

#: ``impl`` values of :func:`rwkv_apply`: None runs the CUDA kernel for a
#: CUDA tensor and the plain scan for a CPU tensor; "kernel" forces the
#: kernel and raises off the card; "ref" forces the plain scan.
IMPLS = (None, "kernel", "ref")


def init_rwkv(gen: torch.Generator, d: int, head_dim: int,
              dtype=torch.float32) -> dict:
    """The reference's init formulas, drawn from ``gen`` on its device.
    ``rwkv_decay_mix`` and ``rwkv_u`` are rounded to ``dtype`` as the
    reference stores them."""
    H = d // head_dim
    dev = gen.device
    return {
        "rwkv_r": dense_init(gen, (d, d), dtype=dtype),
        "rwkv_k": dense_init(gen, (d, d), dtype=dtype),
        "rwkv_v": dense_init(gen, (d, d), dtype=dtype),
        "rwkv_g": dense_init(gen, (d, d), dtype=dtype),
        "rwkv_w": dense_init(gen, (d, d), scale=0.1 * d ** -0.5,
                             dtype=dtype),
        "rwkv_o": dense_init(gen, (d, d), dtype=dtype),
        # static token-shift mix coefficients for (r, k, v, g, w)
        "rwkv_mix": torch.full((5 * d,), 0.5, dtype=dtype, device=dev),
        # decay base: w = exp(-exp(ww + base)); base ~ log-spaced decays
        "rwkv_decay_mix": torch.linspace(
            -6.0, -0.5, head_dim, dtype=torch.float32, device=dev
        ).repeat(H, 1).to(dtype),
        "rwkv_u": (0.1 * torch.randn((H, head_dim), generator=gen,
                                     dtype=torch.float32, device=dev)
                   ).to(dtype),
    }


def init_rwkv_state(batch: int, d: int, head_dim: int, dtype=torch.float32,
                    device="cuda") -> dict:
    """The decode state: ``s`` always float32, ``x_prev`` in the
    activation dtype."""
    H = d // head_dim
    return {"s": torch.zeros((batch, H, head_dim, head_dim),
                             dtype=torch.float32, device=device),
            "x_prev": torch.zeros((batch, d), dtype=dtype, device=device)}


def _rwkv_projections(p, x, x_shift, d, head_dim):
    """Shared by prefill and decode: token-shift mix and projections.
    x, x_shift: (..., D). Returns r, k, v (..., H, K) in x's dtype, the
    decay w (..., H, K) in float32, and the gate silu(g) (..., D)."""
    H = d // head_dim
    mix = p["rwkv_mix"].float().reshape(5, d)
    xf, sf = x.float(), x_shift.float()

    def lerp(i):
        m = mix[i]
        return (xf * (1 - m) + sf * m).to(x.dtype)

    r = lerp(0) @ p["rwkv_r"]
    k = lerp(1) @ p["rwkv_k"]
    v = lerp(2) @ p["rwkv_v"]
    g = lerp(3) @ p["rwkv_g"]
    ww = (lerp(4) @ p["rwkv_w"]).float()
    shape = x.shape[:-1] + (H, head_dim)
    ww = ww.reshape(shape) + p["rwkv_decay_mix"].float()
    w = torch.exp(-torch.exp(ww.clamp(-8.0, 1.0)))    # data-dependent decay
    return (r.reshape(shape), k.reshape(shape), v.reshape(shape), w,
            F.silu(g))


def _head_groupnorm(y, eps=1e-5):
    """Per-head normalization (RWKV's GroupNorm, scale-free variant)."""
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, unbiased=False)
    return ((yf - mu) * torch.rsqrt(var + eps)).to(y.dtype)


def rwkv_apply(p: dict, x: torch.Tensor, cfg,
               impl: Optional[str] = None) -> torch.Tensor:
    """Prefill RWKV-6 time-mix over a whole sequence. x: (B, S, D).

    ``impl`` picks the scan (:data:`IMPLS`). The default runs the CUDA
    kernel on the card, so nothing on the card's main path runs the
    plain scan; the reference defaults to its plain chunked form.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    if impl == "kernel" and x.device.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA tensor, not {x.device}")
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    B, S, D = x.shape
    # token shift: the token before the first is zero
    x_shift = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, g = _rwkv_projections(p, x, x_shift, d, hd)
    u = p["rwkv_u"].float()
    scan = rwkv_scan_plain if impl == "ref" else rwkv_scan
    y, _ = scan(r, k, v, w, u)
    y = _head_groupnorm(y).reshape(B, S, D).to(x.dtype) * g
    return y @ p["rwkv_o"]


def rwkv_decode(p: dict, x: torch.Tensor, state: dict, cfg
                ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B, 1, D) -> (out (B, 1, D), new state)."""
    d, hd = cfg.d_model, cfg.ssm.head_dim
    B = x.shape[0]
    xt = x[:, 0]
    r, k, v, w, g = _rwkv_projections(p, xt, state["x_prev"].to(x.dtype),
                                      d, hd)
    s = state["s"]                                     # (B, H, K, V) f32
    kv = k.float()[..., :, None] * v.float()[..., None, :]
    cur = s + p["rwkv_u"].float()[None, :, :, None] * kv
    y = torch.einsum("bhk,bhkv->bhv", r.float(), cur)
    s = s * w[..., :, None] + kv
    y = _head_groupnorm(y).reshape(B, d).to(x.dtype) * g
    return (y @ p["rwkv_o"])[:, None], {"s": s, "x_prev": xt}
