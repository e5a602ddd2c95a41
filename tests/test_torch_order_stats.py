"""The port's m-th order statistic against the reference's, on the CPU.

The reference runs as its own tests run it here: ``mth_smallest`` through
XLA and ``mth_smallest_pallas`` in interpret mode. float64 reference
values come from a subprocess with ``JAX_ENABLE_X64=1``. Inputs are made
with numpy from a seed; every comparison is bitwise (the statistic is an
element of the row, so there is no rounding to tolerate).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.order_stats import mth_smallest as ref_mth
from repro.kernels.order_stats import mth_smallest_pallas
from repro_torch.kernels import order_stats

ROOT = Path(__file__).resolve().parents[1]
N = 100
MS = (1, 5, 37, 64, 65, N)


def _blocks():
    """Tie-heavy integer-valued rows, a row of +inf and a half-inf row
    (workers that never finish), and a row of distinct values."""
    rng = np.random.default_rng(1234)
    ties = rng.integers(0, 12, size=(8, N)).astype(np.float64)
    ties[0] = np.inf
    ties[1, : N // 2] = np.inf
    ties[2] = rng.permutation(N) * 0.5
    ties[3, ::7] = np.inf
    return {"ties": ties, "normal": rng.normal(size=(4, N))}


def _assert_bitwise(got, want):
    got = np.ascontiguousarray(got)
    want = np.ascontiguousarray(want)
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (got, want)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("block", ["ties", "normal"])
def test_plain_matches_reference_f32(block, m):
    x = _blocks()[block].astype(np.float32)
    got = order_stats.mth_smallest_plain(torch.from_numpy(x), m).numpy()
    _assert_bitwise(got, ref_mth(jnp.asarray(x), m))
    _assert_bitwise(got, mth_smallest_pallas(jnp.asarray(x), m))


@pytest.mark.parametrize("m", MS)
def test_wrapper_on_cpu_is_the_plain_version(m):
    x = torch.from_numpy(_blocks()["ties"].astype(np.float32))
    before = dict(order_stats.launch_counts)
    _assert_bitwise(order_stats.mth_smallest(x, m).numpy(),
                    order_stats.mth_smallest_plain(x, m).numpy())
    assert order_stats.launch_counts == before     # no kernel launched


@pytest.fixture(scope="module")
def x64_reference(tmp_path_factory):
    """float64 reference values of both reference selections, computed in
    a subprocess with JAX_ENABLE_X64=1."""
    out = tmp_path_factory.mktemp("x64") / "ref.npz"
    code = textwrap.dedent(f"""
        import numpy as np, jax, jax.numpy as jnp
        assert jax.config.jax_enable_x64
        from repro.kernels.order_stats import mth_smallest, mth_smallest_pallas
        blocks = dict(np.load({str(out) + '.in.npz'!r}))
        res = {{}}
        for name, x in blocks.items():
            for m in {MS!r}:
                a = np.asarray(mth_smallest(jnp.asarray(x), m))
                b = np.asarray(mth_smallest_pallas(jnp.asarray(x), m))
                assert a.dtype == np.float64 and b.dtype == np.float64
                res[f"{{name}}/{{m}}/xla"] = a
                res[f"{{name}}/{{m}}/pallas"] = b
        np.savez({str(out)!r}, **res)
    """)
    np.savez(str(out) + ".in.npz", **_blocks())
    env = {**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("block", ["ties", "normal"])
def test_plain_matches_reference_f64(x64_reference, block, m):
    x = _blocks()[block]
    got = order_stats.mth_smallest_plain(torch.from_numpy(x), m).numpy()
    _assert_bitwise(got, x64_reference[f"{block}/{m}/xla"])
    _assert_bitwise(got, x64_reference[f"{block}/{m}/pallas"])


@pytest.mark.parametrize("m", [0, N + 1])
def test_m_out_of_range_raises(m):
    with pytest.raises(ValueError, match="out of range"):
        order_stats.mth_smallest(torch.zeros(2, N), m)


def test_wrong_rank_raises():
    with pytest.raises(ValueError, match="rows, n"):
        order_stats.mth_smallest(torch.zeros(N), 1)


def test_other_device_raises():
    """Only a CPU tensor takes the plain version; a tensor elsewhere that
    is not on CUDA is refused, not copied."""
    with pytest.raises(ValueError, match="cuda or cpu"):
        order_stats.mth_smallest(torch.zeros(2, N, device="meta"), 1)
