"""RWKV-6 scan: the port of
``src/repro/kernels/rwkv_scan.py::rwkv_scan_pallas``.

The recurrence, per (batch, head), with the ``(K, V)`` state ``S``
starting at zero (or at ``state0`` in the plain version), in the u-form
of ``src/repro/models/ssm.py::reference_scan``::

    y_t = r_t . (S + diag(u) k_t v_t^T)        S <- diag(w_t) S + k_t v_t^T

:func:`rwkv_scan` launches the hand-written CUDA kernel in
``csrc/rwkv_scan.cu`` for CUDA tensors and uses :func:`rwkv_scan_plain`
only for tensors that lie on the CPU. The kernel walks each sequence in
16-token chunks with every decay factor taken as a difference of
cumulative log-decays, so it stays in float32 range over the model's
whole decay range, down to ``exp(-e)``; the reference's chunked form and
its Pallas kernel divide by a 64-token decay product, which underflows
there (ROADMAP R4). Its oracle is the step recurrence.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import extension

__all__ = ["rwkv_scan", "rwkv_scan_plain", "launch_counts",
           "reset_launch_counts", "KERNEL_HEAD_SIZES"]

#: kernel launches per wrapper, counted where the kernel is launched
launch_counts = {"rwkv_scan": 0}

#: the head sizes (K = V) the CUDA kernel is built for
KERNEL_HEAD_SIZES = (32, 64)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def rwkv_scan_plain(r, k, v, w, u, state0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the step recurrence, one token at a time.

    r, k, w: ``(B, T, H, K)``; v: ``(B, T, H, V)``; u: ``(H, K)``;
    state0: ``(B, H, K, V)`` or None. Returns ``(y (B, T, H, V),
    state (B, H, K, V))``. The math runs in float64 when ``w`` is
    float64, else in float32, as the reference's ``reference_scan`` does.
    """
    acc = torch.float64 if w.dtype == torch.float64 else torch.float32
    B, T, H, K = r.shape
    V = v.shape[-1]
    r, k, v, w = (a.to(acc) for a in (r, k, v, w))
    u = u.to(acc)[None, :, :, None]
    s = (torch.zeros((B, H, K, V), dtype=acc, device=r.device)
         if state0 is None else state0.to(acc).clone())
    y = torch.empty((B, T, H, V), dtype=acc, device=r.device)
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        y[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * kv)
        s = s * w[:, t, :, :, None] + kv
    return y, s


def _check(r, k, v, w, u) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, K), got {tuple(r.shape)}")
    B, T, H, K = r.shape
    if k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r, k, w shapes differ: {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(w.shape)}")
    if v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"v must be (B, T, H, V), got {tuple(v.shape)}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be (H, K) = {(H, K)}, got {tuple(u.shape)}")
    if min(B, T, H) < 1:
        raise ValueError(f"empty input {tuple(r.shape)}")


def rwkv_scan(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 scan from a zero state -> ``(y (B, T, H, V), state (B, H, K,
    V))``, float32, as ``rwkv_scan_pallas`` computes it.

    CUDA tensors go to the CUDA kernel, which takes r, k, v in bfloat16 or
    float32 (one dtype), w and u in float32 (decays in ``(0, 1]``) and a
    head size ``K = V`` in :data:`KERNEL_HEAD_SIZES`; anything else
    raises. CPU tensors go to :func:`rwkv_scan_plain`.
    """
    _check(r, k, v, w, u)
    if r.device.type == "cpu":
        y, s = rwkv_scan_plain(r, k, v, w, u)
        return y.float(), s.float()
    if r.device.type != "cuda":
        raise ValueError(f"rwkv_scan runs on cuda or cpu, not {r.device}")
    B, T, H, K = r.shape
    if v.shape[-1] != K or K not in KERNEL_HEAD_SIZES:
        raise ValueError(f"the kernel takes K = V in {KERNEL_HEAD_SIZES}, "
                         f"not K={K}, V={v.shape[-1]}")
    if r.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share bfloat16 or float32, not "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, a in (("w", w), ("u", u)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {a.dtype}")
    r, k, v, w, u = (a.contiguous() for a in (r, k, v, w, u))
    y = torch.empty((B, T, H, K), dtype=torch.float32, device=r.device)
    s = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    extension().rwkv_scan(r, k, v, w, u, y, s)
    launch_counts["rwkv_scan"] += 1
    return y, s
