"""Model configurations of the port: the port's own copy of the JAX
package's config data (``src/repro/configs``), for the models it runs."""

from .base import (AttnConfig, Block, EncoderConfig, ModelConfig, MoEConfig,
                   SSMConfig, Stage, reduced)
from .registry import ALIASES, ARCH_IDS, get_config

__all__ = ["AttnConfig", "Block", "EncoderConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "Stage", "reduced", "ALIASES",
           "ARCH_IDS", "get_config"]
