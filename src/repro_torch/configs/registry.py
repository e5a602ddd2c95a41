"""Architecture registry of the port: ``get_config(arch_id)``.

It holds the architectures whose every block the port runs. The JAX
package's registry (``src/repro/configs/registry.py``) holds more; their
blocks wait for later slices of the port (ROADMAP Queues A and B).
"""

from __future__ import annotations

import importlib

from .base import ModelConfig

__all__ = ["ARCH_IDS", "ALIASES", "get_config"]

ARCH_IDS = ["llama3p2_3b", "rwkv6_3b"]

# canonical dashed names -> module name
ALIASES = {"llama3.2-3b": "llama3p2_3b", "rwkv6-3b": "rwkv6_3b"}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; the port has: "
                       f"{sorted(ALIASES)}")
    return importlib.import_module(f"{__package__}.{mod_name}").CONFIG
