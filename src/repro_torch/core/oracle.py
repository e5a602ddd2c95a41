"""The paper's worst-case quadratic with the eq. (27) oracle, on tensors.

:func:`quadratic_worst_case_torch` is the counterpart of the reference's
``quadratic_worst_case_jax``: ``f(x) = 1/2 x^T A x - b^T x - f*`` with
``A = scale * tridiag(-1, 2, -1)`` and ``b = (-scale, 0, ..., 0)``, and a
progress-gated Bernoulli oracle. Every callable takes a batch ``x`` of
shape ``(..., d)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["TorchProblem", "quadratic_worst_case_torch"]


@dataclasses.dataclass
class TorchProblem:
    """A problem with a stochastic first-order oracle on tensors.

    ``f(x)`` and ``grad(x)`` evaluate the objective (minus its optimum)
    and its gradient on ``(..., d)`` batches. ``stoch_grad(x, u)`` draws
    one stochastic gradient per uniform in ``u``, whose shape broadcasts
    against ``x``'s batch dimensions: the oracle's randomness arrives as
    uniforms, so a caller decides where they come from.
    """

    x0: np.ndarray
    f: Callable[[torch.Tensor], torch.Tensor]
    grad: Callable[[torch.Tensor], torch.Tensor]
    stoch_grad: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    d: int
    p: float
    scale: float


def quadratic_worst_case_torch(d: int = 1000, p: float = 0.1,
                               scale: float = 0.25) -> TorchProblem:
    """§K quadratic with the eq. (27) oracle: coordinates past the
    progress ``prog(x) = max{i : x_i != 0}`` carry the multiplicative
    noise ``xi / p`` with ``xi ~ Bernoulli(p)``, and ``xi = (u < p)``."""
    main = 2.0 * scale * np.ones(d)
    off = -scale * np.ones(d - 1)
    b_np = np.zeros(d)
    b_np[0] = -scale
    A = np.diag(main) + np.diag(off, 1) + np.diag(off, -1)
    x_star = np.linalg.solve(A, b_np)
    f_star = float(0.5 * x_star @ (A @ x_star) - b_np @ x_star)
    sc = scale

    def matvec(x):
        y = 2.0 * sc * x
        y[..., :-1] += -sc * x[..., 1:]
        y[..., 1:] += -sc * x[..., :-1]
        return y

    def f(x):
        # b @ x == -sc * x[..., 0]
        return ((0.5 * x) * matvec(x)).sum(-1) - (-sc * x[..., 0]) - f_star

    def grad(x):
        g = matvec(x)
        g[..., 0] -= -sc
        return g

    def stoch_grad(x, u):
        g = grad(x)
        idx = torch.arange(d, device=x.device)
        # prog(x) = max{i >= 1 : x_i != 0} (1-indexed), 0 if x == 0
        pr = torch.where(x != 0, idx + 1, 0).amax(-1, keepdim=True)
        xi = (u < p).to(x.dtype)[..., None]
        gate = torch.where(idx < pr, 1.0, xi / p)
        return g * gate

    x0 = np.zeros(d)
    x0[0] = np.sqrt(d)
    return TorchProblem(x0=x0, f=f, grad=grad, stoch_grad=stoch_grad, d=d,
                        p=float(p), scale=float(scale))
