"""Carry the reference's time models across into the port's.

A reference model is read through its public attributes only: the
``taus`` of a fixed-time model, the ``grid`` and ``powers`` of a
universal or partial-participation model. This module never imports the
JAX package. A sub-exponential model keeps its law's parameters inside
its samplers, not in attributes, so the port builds it with its own
factory (:func:`~repro_torch.core.time_models.exponential_times` and its
siblings) from the same arguments; the quadratic is built the same way
with :func:`~repro_torch.core.oracle.quadratic_worst_case_torch`.
"""

from __future__ import annotations

import numpy as np

from .core.time_models import FixedTimes, UniversalModel

__all__ = ["time_model_from"]


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
