"""Build of the port's CUDA kernels from the sources in ``csrc/``.

The kernels are compiled at first use with
:func:`torch.utils.cpp_extension.load` for ``sm_90a`` (Hopper) into
``kernels/build/`` beside this file, which ``.gitignore`` lists. Only
the small binding file ``csrc/binding.cpp`` includes PyTorch's headers;
the ``.cu`` sources expose plain C++ launchers, which keeps the build
short. Every kernel lives in the one extension module.
"""

from __future__ import annotations

import functools
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "extension"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "build"
SOURCES = (_HERE / "csrc" / "order_stats.cu",
           _HERE / "csrc" / "rwkv_scan.cu",
           _HERE / "csrc" / "flash_attention.cu",
           _HERE / "csrc" / "binding.cpp")
_CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


@functools.lru_cache(maxsize=None)
def extension():
    """The compiled extension module (built once per process)."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(name="repro_torch_kernels",
                sources=[str(s) for s in SOURCES],
                extra_cflags=["-O2"],
                extra_cuda_cflags=list(_CUDA_FLAGS),
                build_directory=str(BUILD_DIR),
                verbose=False)
