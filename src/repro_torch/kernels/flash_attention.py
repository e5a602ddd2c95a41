"""Flash attention: the port of
``src/repro/kernels/flash_attention.py::flash_attention_pallas``.

Forward attention with an online softmax over key tiles, causal and
sliding-window masks, and grouped-query heads (query head ``h`` reads
key/value head ``h // group``), on q ``(B, Sq, H, dh)`` and k, v
``(B, Sk, KV, dh)``; the output is ``(B, Sq, H, dh)`` in q's dtype.
Causality is top-left aligned: query ``i`` sees key ``j`` when
``j <= i``; a window keeps ``j > i - window``.

:func:`flash_attention` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu`` for CUDA tensors and uses
:func:`flash_attention_plain` only for tensors that lie on the CPU (or
when asked to with ``impl="ref"``).

A query row with no valid key (it arises only when Sq > Sk with a
window) comes out as zeros, as in the TPU kernel, which clamps the
softmax denominator at 1e-30. The reference's oracle
``kernels/ref.py::attention_ref`` returns the mean of v there instead:
its softmax runs over a row that is all -1e30.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ._build import extension

__all__ = ["flash_attention", "flash_attention_plain", "launch_counts",
           "reset_launch_counts", "IMPLS", "KERNEL_HEAD_SIZES"]

#: kernel launches per wrapper, counted where the kernel is launched
launch_counts = {"flash_attention": 0}

#: ``impl`` values of :func:`flash_attention`: None runs the CUDA kernel
#: for a CUDA tensor and the plain version for a CPU tensor; "kernel"
#: forces the kernel and raises off the card; "ref" forces the plain
#: version.
IMPLS = (None, "kernel", "ref")

#: the head sizes the CUDA kernel is built for
KERNEL_HEAD_SIZES = (32, 64, 128)

_NEG = -1e30


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _valid(sq: int, sk: int, causal: bool, window: Optional[int], device
           ) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query row may see."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return ok


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: masked softmax attention in float32 (float64
    for float64 inputs), output in q's dtype, zeros on rows with no valid
    key. GQA by a view of q's heads as ``(KV, group)``."""
    _check(q, k, v, window)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(acc).reshape(B, Sq, KV, H // KV, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(acc)) / math.sqrt(dh)
    ok = _valid(Sq, Sk, causal, window, q.device)
    s = torch.where(ok, s, _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * ok
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.to(acc))
    return o.reshape(B, Sq, H, dh).to(q.dtype)


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, dh) and k (B, Sk, KV, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(f"q, k, v shapes disagree: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(B, Sq, H, dh, k.shape[1], k.shape[2]) < 1:
        raise ValueError(f"empty input {tuple(q.shape)}, {tuple(k.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} key/value heads")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be positive or None")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Attention as ``flash_attention_pallas`` computes it -> ``(B, Sq, H,
    dh)`` in q's dtype.

    ``impl`` picks the path (:data:`IMPLS`). The CUDA kernel takes q, k, v
    in bfloat16 or float32 (one dtype), with the head dimension contiguous
    (other strides are read as they are, so a head-split view needs no
    copy) and ``dh`` in :data:`KERNEL_HEAD_SIZES`; anything else raises.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    dev = q.device.type
    if impl == "ref" or (impl is None and dev == "cpu"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    if dev != "cuda":
        raise ValueError(f"the flash-attention kernel needs CUDA tensors, "
                         f"not {q.device}")
    dh = q.shape[3]
    if dh not in KERNEL_HEAD_SIZES:
        raise ValueError(f"the kernel takes head sizes {KERNEL_HEAD_SIZES}, "
                         f"not {dh}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share bfloat16 or float32, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if any(a.stride(3) != 1 for a in (q, k, v)):
        raise ValueError("q, k, v need a contiguous head dimension")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one device")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    extension().flash_attention(q, k, v, o, bool(causal),
                                0 if window is None else int(window))
    launch_counts["flash_attention"] += 1
    return o
