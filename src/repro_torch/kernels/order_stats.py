"""Per-row m-th order statistic: the port of
``src/repro/kernels/order_stats.py::mth_smallest_pallas``.

The m-sync round needs, per seed row, the m-th smallest candidate
finish time. :func:`mth_smallest` launches the hand-written CUDA kernel
in ``csrc/order_stats.cu`` (one CTA per row, radix select on the
order-preserving integer key of each float) for a CUDA tensor, and uses
:func:`mth_smallest_plain` only for a tensor that lies on the CPU.

Tie semantics as in the reference: the statistic counts multiplicity,
``mth_smallest(x, m) == sort(x)[..., m-1]``, and it is always an element
of ``x``.

The order is ``torch.sort``'s on the CPU: -0.0 and +0.0 are equal, and
NaN, of either sign, sorts after +inf. On the card the result equals
that ``sort(x)[..., m-1]`` by value, with NaN in the same rows; a
selected zero comes back as +0.0, and a selected NaN as the canonical
quiet NaN. (``torch.sort`` on the card puts a sign-set NaN first in rows
of 1000 or more, so it is not the yardstick for such rows.)
On rows with no -0.0 and no NaN it is bitwise the element
``sort`` picks.
"""

from __future__ import annotations

import torch

from ._build import extension

__all__ = ["mth_smallest", "mth_smallest_plain", "launch_counts",
           "reset_launch_counts"]

#: kernel launches per wrapper, counted where the kernel is launched
launch_counts = {"mth_smallest": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def mth_smallest_plain(x: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch version: ``sort(x)[..., m-1]``."""
    return torch.sort(x, dim=-1).values[..., m - 1]


def mth_smallest(x: torch.Tensor, m: int) -> torch.Tensor:
    """m-th smallest of each row of a ``(rows, n)`` block -> ``(rows,)``.

    A CUDA tensor goes to the CUDA kernel, which takes float32 or
    float64, contiguous, with ``1 <= m <= n``; anything else raises. A
    CPU tensor goes to :func:`mth_smallest_plain`.
    """
    if x.dim() != 2:
        raise ValueError(f"expected (rows, n), got shape {tuple(x.shape)}")
    rows, n = x.shape
    if not 1 <= m <= n:
        raise ValueError(f"m={m} out of range [1, {n}]")
    if x.device.type == "cpu":
        return mth_smallest_plain(x, m)
    if x.device.type != "cuda":
        raise ValueError(f"mth_smallest runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mth_smallest takes float32 or float64, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("mth_smallest needs a contiguous tensor")
    if rows == 0:
        raise ValueError("mth_smallest needs at least one row")
    out = torch.empty(rows, dtype=x.dtype, device=x.device)
    extension().mth_smallest(x, int(m), out)
    launch_counts["mth_smallest"] += 1
    return out
