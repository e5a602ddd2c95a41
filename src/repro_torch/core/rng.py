"""Counter-based random numbers for the batched simulator.

Every draw is a pure function of ``(seed, round, purpose, column)``: a
splitmix64 hash written in plain torch ``int64`` operations, so it runs
on any device as a handful of elementwise kernels and gives the same bits
on the CPU and on the GPU. A seed's stream depends on its value only,
never on the other seeds of a batch, so seed ``s`` run alone equals seed
``s`` inside any batch (the reference's per-``PRNGKey(seed)`` contract).
The numbers are not ``jax.random``'s: the port is equal to the reference
in distribution, and its tests inject the reference's own draws where
they need the same numbers.

Keys and hash states are ``int64`` tensors that hold 64-bit patterns.
Multiplication wraps modulo ``2**64`` and a logical right shift is an
arithmetic shift followed by a mask.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["INIT", "STALE", "ACCEPT", "ORACLE", "seed_keys", "uniforms"]

# purposes: which draw of a round a stream feeds
INIT = 0      # the initial duration row (round 0)
STALE = 1     # restart of a worker whose stale result arrived this round
ACCEPT = 2    # restart of the workers accepted into this round's step
ORACLE = 3    # the gradient oracle's Bernoulli uniforms

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_C1 = 0xBF58476D1CE4E5B9
_C2 = 0x94D049BB133111EB


def _signed(c: int) -> int:
    """A 64-bit pattern as the ``int64`` value torch stores for it."""
    c &= _MASK64
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(z: torch.Tensor, s: int) -> torch.Tensor:
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on an ``int64`` tensor."""
    z = (z ^ _lsr(z, 30)) * _signed(_C1)
    z = (z ^ _lsr(z, 27)) * _signed(_C2)
    return z ^ _lsr(z, 31)


def seed_keys(seeds: Sequence[int], device) -> torch.Tensor:
    """``(S,)`` root keys, one per seed value."""
    s = torch.tensor([int(v) for v in seeds], dtype=torch.int64)
    return _mix((s + 1) * _signed(_GOLDEN)).to(device)


def uniforms(keys: torch.Tensor, round_: int, purpose: int, ncols: int,
             dtype: torch.dtype) -> torch.Tensor:
    """``(S, ncols)`` uniforms in the open interval (0, 1).

    Row ``s`` is stream ``(keys[s], round_, purpose)`` and column ``i``
    its ``i``-th element. float32 takes 23 bits of the hash and float64
    52, so ``u`` is exact, never 0 and never 1.
    """
    # a 0-d CPU tensor enters the device ops as a scalar: no copy, no sync
    tag = _mix(torch.tensor((int(round_) << 8) + int(purpose) + 1,
                            dtype=torch.int64))
    stream = _mix(keys ^ tag)
    ctr = torch.arange(1, ncols + 1, dtype=torch.int64,
                       device=keys.device) * _signed(_GOLDEN)
    z = _mix(stream[:, None] + ctr)
    bits = 23 if dtype == torch.float32 else 52
    k = _lsr(z, 64 - bits).to(dtype)
    return (k + 0.5) * (2.0 ** -bits)
