"""The simulator of the port: time models, oracle, strategies and the
batched m-Sync engine on tensors."""

from .batch import TraceBatch, simulate_batch
from .oracle import TorchProblem, quadratic_worst_case_torch
from .selection import optimal_m
from .strategies import STRATEGIES, FullSync, MSync, Trace, make_strategy
from .time_models import (FixedTimes, PartialParticipationModel,
                          SubExponentialTimes, UniversalModel,
                          exponential_times, powers_figure3, powers_figure4,
                          shifted_exponential_times, uniform_times)

__all__ = ["TraceBatch", "simulate_batch", "TorchProblem",
           "quadratic_worst_case_torch", "optimal_m", "STRATEGIES",
           "FullSync", "MSync", "Trace", "make_strategy", "FixedTimes",
           "PartialParticipationModel", "SubExponentialTimes",
           "UniversalModel", "exponential_times", "powers_figure3",
           "powers_figure4", "shifted_exponential_times", "uniform_times"]
