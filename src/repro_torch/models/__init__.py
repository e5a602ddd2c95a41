"""The port's model stack: layers, mixers, blocks and ``Model``."""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
