"""The port's time models and counter RNG against the reference's, on the
CPU.

Deterministic models must agree to float tolerance: ``FixedTimes``
exactly; ``UniversalModel.finish_times`` to 1e-6 relative in float32
against the reference's ``finish_times_jax`` and to 1e-9 in float64
against its NumPy ``finish_times`` (the reference's own float64 jax
check needs ``enable_x64``, which this jax lacks). Sampled models must
agree in distribution: per-worker mean and variance within 4 standard
errors of the reference sampler's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import time_models as ref_tm
from repro_torch.convert import time_model_from
from repro_torch.core import rng
from repro_torch.core import time_models as tm


@pytest.mark.parametrize("law,args", [
    ("sqrt_law", (37,)), ("linear", (37, 0.5)), ("power_law", (37, 1.2)),
])
def test_fixed_laws_equal_reference(law, args):
    want = getattr(ref_tm.FixedTimes, law)(*args).taus
    got = getattr(tm.FixedTimes, law)(*args).taus
    assert np.array_equal(got, want)


def test_fixed_power_law_delta_and_validation():
    delta = np.linspace(0, 1, 9)
    assert np.array_equal(tm.FixedTimes.power_law(9, 0.7, 2.0, delta).taus,
                          ref_tm.FixedTimes.power_law(9, 0.7, 2.0, delta).taus)
    with pytest.raises(ValueError, match="positive"):
        tm.FixedTimes(np.array([1.0, 0.0]))


def _universal_pair(kind):
    if kind == "fig3":
        return (ref_tm.powers_figure3(n=12, seed=3, t_max=40.0),
                tm.powers_figure3(n=12, seed=3, t_max=40.0))
    if kind == "fig4":
        return (ref_tm.powers_figure4(n=12, seed=3, t_max=40.0),
                tm.powers_figure4(n=12, seed=3, t_max=40.0))
    if kind == "partial":
        return (ref_tm.PartialParticipationModel(n=12, p=0.25, period=3.0,
                                                 t_max=40.0),
                tm.PartialParticipationModel(n=12, p=0.25, period=3.0,
                                             t_max=40.0))
    # constant tail with a dead worker: v = 0 past the grid never finishes
    powers = np.ones((12, 40))
    powers[0, 20:] = 0.0
    powers[1, :] = 0.0
    powers[2, 30:] = 3.0
    grid = np.arange(40) * 0.5
    return (ref_tm.UniversalModel(grid, powers),
            tm.UniversalModel(grid, powers))


def _start_times(t_end):
    """Start times inside the grid, past its end (constant tail) and
    ``inf`` (a computation that never started)."""
    rng_ = np.random.default_rng(7)
    t0 = rng_.uniform(0.0, 1.3 * t_end, size=(6, 12))
    t0[0, 2] = np.inf
    t0[1, :] = t_end + 0.25
    t0[2, :] = 0.0
    return t0


@pytest.mark.parametrize("kind", ["fig3", "fig4", "partial", "tail"])
def test_universal_finish_times_f64_matches_numpy(kind):
    ref, port = _universal_pair(kind)
    t0 = _start_times(ref.grid[-1])
    want = np.stack([ref.finish_times(np.arange(12), row) for row in t0])
    got = port.finish_times(torch.from_numpy(t0)).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9, atol=0)
    if kind == "tail":
        assert np.isinf(got[:, 1]).all()       # dead worker
        assert np.isinf(got[1, 0])             # v = 0 in the tail


@pytest.mark.parametrize("kind", ["fig3", "fig4", "partial", "tail"])
def test_universal_finish_times_f32_matches_jax(kind):
    ref, port = _universal_pair(kind)
    t0 = _start_times(ref.grid[-1]).astype(np.float32)
    want = np.asarray(ref.finish_times_jax(jnp.asarray(t0)))
    got = port.finish_times(torch.from_numpy(t0)).numpy()
    assert want.dtype == got.dtype == np.float32
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)


def test_universal_finish_times_keeps_batch_shape():
    _, port = _universal_pair("fig3")
    t0 = torch.zeros(2, 3, 12)
    assert port.finish_times(t0).shape == (2, 3, 12)


def _moments(x):
    """Per-column mean and variance with their standard errors."""
    n = x.shape[0]
    mean = x.mean(0)
    var = x.var(0)
    m4 = ((x - mean) ** 4).mean(0)
    return mean, np.sqrt(var / n), var, np.sqrt(np.maximum(m4 - var ** 2,
                                                           0.0) / n)


# each sampled law's factory and the arguments both packages build it from
SAMPLED = {
    "exponential": ("exponential_times", (2.0, 5)),
    "shifted_exp": ("shifted_exponential_times",
                    (np.sqrt(np.arange(1, 6)),
                     np.array([1.0, 2.0, 0.5, 1.0, 3.0]))),
    "uniform": ("uniform_times", (np.array([1.0, 0.3, 2.0, 0.5, 1.0]), 0.5)),
}


@pytest.mark.parametrize("name", sorted(SAMPLED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sampler_matches_reference_in_distribution(name, dtype):
    factory, args = SAMPLED[name]
    ref = getattr(ref_tm, factory)(*args)
    port = getattr(tm, factory)(*args)
    assert np.array_equal(port.taus, ref.taus) and port.R == ref.R
    assert port.name == ref.name
    draws = 20000
    keys = rng.seed_keys(range(draws), "cpu")
    sampler = port.device_sampler("cpu", dtype)
    got = sampler(rng.uniforms(keys, 0, rng.INIT, port.n, dtype))
    got = got.double().numpy()
    want = np.asarray(jax.vmap(ref.jax_sampler)(
        jax.random.split(jax.random.PRNGKey(11), draws)), dtype=np.float64)
    assert (got >= 0).all()
    gm, gse, gv, gvse = _moments(got)
    wm, wse, wv, wvse = _moments(want)
    assert (np.abs(gm - wm) <= 4 * np.hypot(gse, wse)).all(), (gm, wm)
    assert (np.abs(gv - wv) <= 4 * np.hypot(gvse, wvse)).all(), (gv, wv)
    if name != "uniform":      # the uniform law clamps draws at 0
        assert (np.abs(gm - ref.taus) <= 4 * gse).all()


def test_convert_keeps_universal_and_fixed_models():
    ref, _ = _universal_pair("fig4")
    port = time_model_from(ref)
    assert np.array_equal(port.cum, ref.cum)
    fixed = ref_tm.FixedTimes.sqrt_law(7)
    assert np.array_equal(time_model_from(fixed).taus, fixed.taus)
    # sampled models carry no readable parameters: the port's factories
    # build them
    with pytest.raises(TypeError, match="factory"):
        time_model_from(ref_tm.exponential_times(2.0, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_counter_rng_is_batch_independent(dtype):
    seeds = [3, 0, 17, 2 ** 40, 5, 6, 7, 8]
    batch = rng.uniforms(rng.seed_keys(seeds, "cpu"), 9, rng.STALE, 50,
                         dtype)
    for i, s in enumerate(seeds):
        alone = rng.uniforms(rng.seed_keys([s], "cpu"), 9, rng.STALE, 50,
                             dtype)
        assert torch.equal(alone[0], batch[i])
    assert batch.dtype == dtype
    assert ((batch > 0) & (batch < 1)).all()


def test_counter_rng_streams_differ_and_match_splitmix64():
    """Streams for other rounds and purposes differ, and the bits are
    splitmix64's, computed here with Python integers."""
    mask = (1 << 64) - 1

    def mix(z):
        z &= mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        return z ^ (z >> 31)

    keys = rng.seed_keys([0, 12345], "cpu")
    u = rng.uniforms(keys, 7, rng.ACCEPT, 300, torch.float64)
    tag = mix((7 << 8) + rng.ACCEPT + 1)
    for s in range(2):
        stream = mix((int(keys[s]) & mask) ^ tag)
        for i in (0, 1, 299):
            z = mix(stream + (i + 1) * 0x9E3779B97F4A7C15)
            assert u[s, i].item() == ((z >> 12) + 0.5) * 2.0 ** -52
    other = [rng.uniforms(keys, r, p, 300, torch.float64)
             for r, p in ((8, rng.ACCEPT), (7, rng.STALE))]
    assert all(not torch.equal(u, o) for o in other)
