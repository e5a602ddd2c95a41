"""Serving: the port of ``src/repro/serve``."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
