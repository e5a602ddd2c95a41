"""The port's batched m-Sync simulator against the reference's jax engine,
on the CPU at small sizes.

Every reference run goes through ``simulate_batch(..., backend="jax")``
and asserts that the jax engine ran with no downgrade on the reference's
engine ladder, which would otherwise run another engine silently. The
float64 reference runs in a subprocess with ``JAX_ENABLE_X64=1``.
Sampled models and the noisy oracle are fed the reference's own
``jax.random`` draws, replayed from its key chain.

Tolerances: fixed-time timing is bitwise (elementwise float adds and an
order statistic that returns an element); sampled timing 1e-6 relative;
the iterates and recorded values 1e-5 relative in float32 (reductions
run in another order).
"""

import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FixedTimes as RefFixed
from repro.core import exponential_times as ref_exponential
from repro.core import powers_figure3 as ref_fig3
from repro.core import simulate_batch as ref_simulate_batch
from repro.core import batch_jax
from repro.core.batch_jax import quadratic_worst_case_jax
from repro_torch import simulate_batch
from repro_torch.convert import time_model_from
from repro_torch.core import batch_torch, time_models
from repro_torch.core.oracle import quadratic_worst_case_torch
from repro_torch.core.time_models import FixedTimes, exponential_times

ROOT = Path(__file__).resolve().parents[1]


def _ref_batch(*args, **kw):
    tb = ref_simulate_batch(*args, backend="jax", **kw)
    assert tb.backend == "jax"
    assert not any("downgrades" in r for r in tb.routing), tb.routing
    return tb


def _tie_taus(n):
    """Integer-valued times with many equal workers: round ends tie across
    the m-boundary, which exercises the worker-index quota."""
    return 1.0 + (np.arange(n) % 4)


FIXED_CASES = {
    "sqrt-m5": (lambda n: np.sqrt(np.arange(1, n + 1)), ("msync", {"m": 5})),
    "sqrt-m1": (lambda n: np.sqrt(np.arange(1, n + 1)), ("msync", {"m": 1})),
    "sqrt-sync": (lambda n: np.sqrt(np.arange(1, n + 1)), ("sync", {})),
    "ties-m5": (_tie_taus, ("msync", {"m": 5})),
    "ties-m23": (_tie_taus, ("msync", {"m": 23})),
    "linear-m40": (lambda n: np.arange(1, n + 1, dtype=float),
                   ("msync", {"m": 40})),
}


@pytest.mark.parametrize("case", sorted(FIXED_CASES))
def test_fixed_timing_matches_reference(case):
    taus_fn, spec = FIXED_CASES[case]
    n, S, K = 64, 4, 200
    taus = taus_fn(n)
    ref = _ref_batch(spec, RefFixed(taus), K, seeds=S)
    got = simulate_batch(spec, FixedTimes(taus), K, seeds=S, device="cpu")
    for a, b in zip(ref.traces[0], got.traces[0]):
        assert a.total_time == b.total_time
        assert a.gradients_computed == b.gradients_computed
        assert a.gradients_used == b.gradients_used
    # every round's T, from the function the reference run above calls
    m = spec[1].get("m", n)
    comp_r, T_r = jax.jit(batch_jax._fixed_timing_run,
                          static_argnames=("S", "m", "K", "use_pallas"))(
        jnp.asarray(taus), S=S, m=m, K=K, use_pallas=False)
    comp_p, T_p = batch_torch._fixed_timing_run(
        torch.tensor(taus, dtype=torch.float32), S, m, K)
    assert np.array_equal(np.asarray(T_r), T_p.numpy())
    assert np.array_equal(np.asarray(comp_r), comp_p.numpy())
    assert comp_p.dtype == torch.int32


def test_fixed_timing_f64_matches_x64_reference(tmp_path):
    """float64: the reference runs with JAX_ENABLE_X64=1 in a subprocess."""
    n, S, K, m = 64, 4, 200, 5
    taus = _tie_taus(n) + np.sqrt(np.arange(n)) * 1e-3
    np.save(tmp_path / "taus.npy", taus)
    code = textwrap.dedent(f"""
        import json, numpy as np, jax
        assert jax.config.jax_enable_x64
        from repro.core import FixedTimes, simulate_batch
        taus = np.load({str(tmp_path / 'taus.npy')!r})
        tb = simulate_batch(("msync", {{"m": {m}}}), FixedTimes(taus), {K},
                            seeds={S}, backend="jax")
        assert tb.backend == "jax"
        assert not any("downgrades" in r for r in tb.routing)
        print(json.dumps([[t.total_time, t.gradients_computed]
                          for t in tb.traces[0]]))
    """)
    want = _x64_reference(code)
    got = simulate_batch(("msync", {"m": m}), FixedTimes(taus), K, seeds=S,
                         device="cpu", dtype=torch.float64)
    assert [[t.total_time, t.gradients_computed]
            for t in got.traces[0]] == want


def _x64_reference(code):
    """Run ``code`` in a subprocess with ``JAX_ENABLE_X64=1`` and return
    the JSON on the last line of its output."""
    env = {**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


UNIVERSAL_X64 = {
    "fig4": ("powers_figure4", dict(n=24, seed=5, t_max=60.0)),
    "partial": ("PartialParticipationModel",
                dict(n=24, p=0.25, period=2.0, t_max=60.0)),
}


@pytest.mark.parametrize("case", sorted(UNIVERSAL_X64))
def test_universal_timing_per_round_f64_matches_x64_reference(case):
    """Every round's T and every seed's gradient count of Fig 4 and of
    partial participation, in float64, against the reference run with
    JAX_ENABLE_X64=1: its round scan (``_general_run``, the function
    ``simulate_batch`` runs) per round, and ``simulate_batch`` itself,
    on the jax engine with no downgrade, at the end."""
    factory, kw = UNIVERSAL_X64[case]
    n, S, K, m = kw["n"], 3, 120, 7
    code = textwrap.dedent(f"""
        import json, numpy as np, jax
        assert jax.config.jax_enable_x64
        from repro.core import simulate_batch, time_models
        from repro.core.batch_jax import _general_run
        model = time_models.{factory}(**{kw!r})
        tb = simulate_batch(("msync", {{"m": {m}}}), model, {K},
                            seeds={S}, backend="jax")
        assert tb.backend == "jax"
        assert not any("downgrades" in r for r in tb.routing)
        comp, _, T, _, _ = _general_run(model, None, {m}, {n}, {S}, {K},
                                        0.0, False, list(range({S})))
        assert np.asarray(T).dtype == np.float64
        print(json.dumps({{
            "T": np.asarray(T).tolist(), "comp": np.asarray(comp).tolist(),
            "end": [[t.total_time, t.gradients_computed]
                    for t in tb.traces[0]]}}))
    """)
    want = _x64_reference(code)
    model = getattr(time_models, factory)(**kw)
    comp, _, T, _, _ = batch_torch._general_run(
        model, None, m, n, S, K, 0.0, list(range(S)), device="cpu",
        dtype=torch.float64)
    np.testing.assert_allclose(T.numpy(), np.array(want["T"]), rtol=1e-12)
    assert comp.tolist() == want["comp"]
    got = simulate_batch(("msync", {"m": m}), model, K, seeds=S,
                         device="cpu", dtype=torch.float64)
    for (total, count), tr in zip(want["end"], got.traces[0]):
        np.testing.assert_allclose(tr.total_time, total, rtol=1e-12)
        assert tr.gradients_computed == count


def _replay_reference_draws(sampler, seeds, K, B=None):
    """The reference ``_general_run``'s key chain, replayed: the initial
    duration row, then per round the stale-restart and accept-restart
    rows and, with ``B``, the ``(S, B)`` Bernoulli uniforms."""
    @jax.jit
    def replay(keys0):
        sub = jax.vmap(lambda k: jax.random.split(k, 2))(keys0)
        rows = [jax.vmap(sampler)(sub[:, 1])]
        keys = sub[:, 0]
        us = []
        for _ in range(K):
            sub = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
            keys = sub[:, 0]
            rows.append(jax.vmap(sampler)(sub[:, 1]))
            rows.append(jax.vmap(sampler)(sub[:, 2]))
            if B is not None:
                gk = jax.vmap(lambda k: jax.random.split(k, B))(sub[:, 3])
                us.append(jax.vmap(jax.vmap(jax.random.uniform))(gk))
        return jnp.stack(rows), (jnp.stack(us) if us else None)

    keys0 = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    d, u = replay(keys0)
    return (torch.tensor(np.asarray(d)),
            None if u is None else torch.tensor(np.asarray(u)))


def test_sampled_timing_with_injected_draws_matches_reference():
    n, S, K, m = 32, 4, 60, 5
    seeds = [0, 1, 2, 7]
    ref_model = ref_exponential(1.5, n)
    # a noiseless problem makes the reference record every round's time
    ref = _ref_batch(("msync", {"m": m}), ref_model, K, seeds=seeds,
                     problem=quadratic_worst_case_jax(d=4, p=1.0),
                     gamma=0.0)
    durations, _ = _replay_reference_draws(ref_model.jax_sampler, seeds, K)
    assert durations.shape == (2 * K + 1, S, n)
    comp, _, T, _, _ = batch_torch._general_run(
        exponential_times(1.5, n), None, m, n, S, K, 0.0, seeds,
        device="cpu", dtype=torch.float32, durations=durations)
    for s, tr in enumerate(ref.traces[0]):
        np.testing.assert_allclose(T[:, s].numpy(), tr.times[1:], rtol=1e-6)
        assert int(comp[s]) == tr.gradients_computed


def test_universal_timing_matches_reference():
    n, S, K, m = 24, 3, 80, 6
    ref_model = ref_fig3(n=n, seed=2, t_max=200.0)
    ref = _ref_batch(("msync", {"m": m}), ref_model, K, seeds=S)
    got = simulate_batch(("msync", {"m": m}), time_model_from(ref_model), K,
                         seeds=S, device="cpu")
    for a, b in zip(ref.traces[0], got.traces[0]):
        np.testing.assert_allclose(b.total_time, a.total_time, rtol=1e-6)
        assert a.gradients_computed == b.gradients_computed


def _quadratic_pair(d, p):
    """The reference's quadratic and the port's, made from the same
    arguments; they start from the same point."""
    ref_problem = quadratic_worst_case_jax(d=d, p=p)
    problem = quadratic_worst_case_torch(d=d, p=p)
    assert np.array_equal(problem.x0, np.asarray(ref_problem.x0))
    return ref_problem, problem


def _math_case(p, K=40, m=3, d=16, gamma=0.9):
    seeds = [0, 3, 5]
    ref_model = RefFixed(np.sqrt(np.arange(1, 9)))
    ref_problem, problem = _quadratic_pair(d, p)
    ref = _ref_batch(("msync", {"m": m}), ref_model, K, seeds=seeds,
                     problem=ref_problem, gamma=gamma)
    return seeds, ref_model, problem, ref, K, m, gamma


def _assert_math_close(ref_traces, comp, x, T, val, gn, f0=None):
    for s, tr in enumerate(ref_traces):
        np.testing.assert_allclose(x[s].numpy(), tr.x_final, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(val[:, s].numpy(), tr.values[1:],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(gn[:, s].numpy(), tr.grad_norms[1:],
                                   rtol=1e-5, atol=1e-7)
        assert np.array_equal(T[:, s].numpy(),
                              tr.times[1:].astype(np.float32))
        assert int(comp[s]) == tr.gradients_computed


def test_noiseless_oracle_matches_reference():
    """p = 1: the gate is 1 everywhere, so no draw is needed for parity."""
    seeds, ref_model, problem, ref, K, m, gamma = _math_case(p=1.0)
    out = batch_torch._general_run(time_model_from(ref_model), problem, m,
                                   8, len(seeds), K, gamma, seeds,
                                   device="cpu", dtype=torch.float32)
    _assert_math_close(ref.traces[0], *out)
    # and through the front door, with the recorded initial point
    tb = simulate_batch(("msync", {"m": m}), time_model_from(ref_model), K,
                        problem=problem, gamma=gamma, seeds=seeds,
                        device="cpu")
    for a, b in zip(ref.traces[0], tb.traces[0]):
        np.testing.assert_allclose(b.values, a.values, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(b.grad_norms, a.grad_norms, rtol=1e-5,
                                   atol=1e-7)
        assert np.array_equal(b.times, a.times)


def test_noisy_oracle_with_injected_uniforms_matches_reference():
    seeds, ref_model, problem, ref, K, m, gamma = _math_case(p=0.1)
    # FixedTimes draws nothing; only the oracle's uniforms are replayed
    _, u = _replay_reference_draws(lambda k: jnp.zeros(8), seeds, K, B=m)
    assert u.shape == (K, len(seeds), m)
    out = batch_torch._general_run(time_model_from(ref_model), problem, m,
                                   8, len(seeds), K, gamma, seeds,
                                   device="cpu", dtype=torch.float32,
                                   oracle_uniforms=u)
    _assert_math_close(ref.traces[0], *out)
    # the noise mattered: the run left the noiseless trajectory
    noiseless = batch_torch._general_run(
        time_model_from(ref_model), quadratic_worst_case_torch(16, 1.0), m,
        8, len(seeds), K, gamma, seeds, device="cpu", dtype=torch.float32)
    assert not torch.allclose(out[1], noiseless[1])


@pytest.mark.parametrize("scenario_model", [
    lambda n: exponential_times(1.0, n),
    lambda n: FixedTimes.sqrt_law(n),
])
def test_seed_alone_equals_seed_in_batch(scenario_model):
    model = scenario_model(16)
    problem = quadratic_worst_case_torch(d=12, p=0.3)
    seeds = [4, 0, 9, 1, 2, 3, 5, 6]
    batch = simulate_batch(("msync", {"m": 4}), model, 30, problem=problem,
                           gamma=0.5, seeds=seeds, device="cpu")
    alone = simulate_batch(("msync", {"m": 4}), model, 30, problem=problem,
                           gamma=0.5, seeds=[9], device="cpu")
    a, b = alone.traces[0][0], batch.traces[0][2]
    assert a.total_time == b.total_time
    assert np.array_equal(a.values, b.values)
    assert np.array_equal(a.x_final, b.x_final)


def test_sampled_math_run_makes_progress_in_float64():
    tb = simulate_batch(("msync", {"m": 4}), exponential_times(1.0, 16), 200,
                        problem=quadratic_worst_case_torch(d=20, p=0.2),
                        gamma=1.0, seeds=3, device="cpu",
                        dtype=torch.float64)
    for tr in tb.traces[0]:
        assert tr.x_final.dtype == np.float64
        assert np.all(np.diff(tr.times) > 0)
        assert tr.values[-1] < 0.5 * tr.values[0]


def test_round_loop_never_reads_back_to_host(monkeypatch):
    """The K-round loops make no .item(), .cpu(), .tolist() or .numpy()
    call (each would be a host sync per round on the GPU)."""
    def refuse(*a, **k):
        raise AssertionError("host read-back inside the round loop")

    model = exponential_times(1.0, 16)
    problem = quadratic_worst_case_torch(d=8, p=0.5)
    taus = torch.tensor(np.sqrt(np.arange(1, 17)), dtype=torch.float32)
    for name in ("item", "cpu", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    batch_torch._fixed_timing_run(taus, 3, 4, 20)
    batch_torch._general_run(model, problem, 4, 16, 3, 20, 0.5, [0, 1, 2],
                             device="cpu", dtype=torch.float32)


def test_grid_and_specs():
    model = FixedTimes.sqrt_law(16)
    tb = simulate_batch("msync", model, 20, seeds=2,
                        grid={"m": [1, 4, 16], "K": [10, 20]}, device="cpu")
    assert [p for p in tb.grid][:2] == [{"m": 1, "K": 10}, {"m": 1, "K": 20}]
    assert tb.stat("iterations").tolist() == [[10, 10], [20, 20]] * 3
    sync = simulate_batch("sync", model, 20, seeds=2, device="cpu")
    full = simulate_batch(("msync", {"m": 16}), model, 20, seeds=2,
                          device="cpu")
    assert np.array_equal(sync.total_time, full.total_time)
    rows = sync.summary()
    assert rows[0]["backend"] == "torch" and rows[0]["device"] == "cpu"
    assert rows[0]["discard_fraction_mean"] == 0.0


@pytest.mark.parametrize("bad,exc", [
    (dict(strategy="nope"), KeyError),
    (dict(strategy=("msync", {"m": 17})), ValueError),
    (dict(K=0), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(problem=object()), NotImplementedError),
    (dict(model=types.SimpleNamespace(n=16)), NotImplementedError),
])
def test_bad_arguments_raise(bad, exc):
    kw = dict(strategy=("msync", {"m": 2}), model=FixedTimes.sqrt_law(16),
              K=5, device="cpu")
    kw.update(bad)
    with pytest.raises(exc):
        simulate_batch(kw.pop("strategy"), kw.pop("model"), kw.pop("K"),
                       **kw)


def test_default_device_is_the_gpu():
    """No CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the GPU tests cover this path")
    with pytest.raises((AssertionError, RuntimeError)):
        simulate_batch("sync", FixedTimes.sqrt_law(4), 3, seeds=1)


def test_record_every_matches_reference():
    seeds = [1, 2]
    ref_model = RefFixed(np.sqrt(np.arange(1, 9)))
    ref_problem, problem = _quadratic_pair(10, 1.0)
    ref = _ref_batch(("msync", {"m": 2}), ref_model, 30, seeds=seeds,
                     problem=ref_problem, gamma=0.8, record_every=4)
    tb = simulate_batch(("msync", {"m": 2}), time_model_from(ref_model), 30,
                        problem=problem, gamma=0.8,
                        seeds=seeds, record_every=4, device="cpu")
    for a, b in zip(ref.traces[0], tb.traces[0]):
        assert len(b.times) == len(a.times) == 1 + 30 // 4
        assert np.array_equal(b.times, a.times)
        np.testing.assert_allclose(b.values, a.values, rtol=1e-5, atol=1e-7)
