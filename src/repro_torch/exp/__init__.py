"""Experiment layer of the port: named scenarios x strategies x seeds."""

from .runner import ExperimentResult, run_experiment
from .scenarios import SCENARIOS, make_scenario

__all__ = ["SCENARIOS", "make_scenario", "run_experiment",
           "ExperimentResult"]
