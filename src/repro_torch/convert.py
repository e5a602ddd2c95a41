"""Carry the reference's time models and model parameters across into
the port's.

A reference time model is read through its public attributes only: the
``taus`` of a fixed-time model, the ``grid`` and ``powers`` of a
universal or partial-participation model. A reference parameter tree
comes in as nested dicts and lists of numpy arrays. This module never
imports the JAX package. A sub-exponential model keeps its law's parameters inside
its samplers, not in attributes, so the port builds it with its own
factory (:func:`~repro_torch.core.time_models.exponential_times` and its
siblings) from the same arguments; the quadratic is built the same way
with :func:`~repro_torch.core.oracle.quadratic_worst_case_torch`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.time_models import FixedTimes, UniversalModel

__all__ = ["time_model_from", "model_params_from"]


def time_model_from(ref):
    """The port's counterpart of a reference ``FixedTimes`` (``taus``) or
    universal model (``grid``, ``powers``)."""
    if hasattr(ref, "sampler"):
        raise TypeError(
            f"the sub-exponential model {ref.name!r} has no parameters to "
            "read; build it with the port's factory from the same arguments")
    if hasattr(ref, "powers") and hasattr(ref, "grid"):
        return UniversalModel(np.asarray(ref.grid), np.asarray(ref.powers))
    if hasattr(ref, "taus"):
        return FixedTimes(np.asarray(ref.taus))
    raise TypeError(f"not a time model: {type(ref).__name__}")


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 arrays (the
    ``ml_dtypes`` type JAX hands to numpy) keep their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(node, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return _tensor(node, device)


def model_params_from(ref_params: dict, device="cuda") -> dict:
    """The port's parameters from the reference ``Model.init_params``
    tree, given as numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``), on ``device``: the GPU unless
    the caller passes ``device="cpu"``.

    The reference stacks each stage's repeats on a leading axis of every
    leaf; the port keeps one dict per repeat, so each stage is unstacked
    into a list.
    """
    if "encoder" in ref_params:
        raise NotImplementedError("the encoder is not ported yet")
    stages = []
    for stage in ref_params["stages"]:
        leaves = [np.asarray(a) for a in _leaves(stage)]
        repeats = leaves[0].shape[0]
        if any(a.shape[0] != repeats for a in leaves):
            raise ValueError("a stage's leaves disagree on the repeats axis")
        stages.append([_tree(_index(stage, i), device)
                       for i in range(repeats)])
    return {"embed": _tree(ref_params["embed"], device),
            "final_norm": _tree(ref_params["final_norm"], device),
            "stages": stages}


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def _index(node, i):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return np.asarray(node)[i]
