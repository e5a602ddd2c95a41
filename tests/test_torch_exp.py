"""The port's experiment layer: scenarios equal to the reference's, the
committed fig8 baseline reproduced, and atomic JSON artifacts."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.exp import scenarios as ref_scenarios
from repro_torch.core import optimal_m, quadratic_worst_case_torch, rng
from repro_torch.exp import SCENARIOS, make_scenario, run_experiment

ROOT = Path(__file__).resolve().parents[1]
BASELINE = json.loads(
    (ROOT / "benchmarks/baselines/BENCH_fig8.json").read_text())

# benchmarks/fig8_grid.py: the fixed-time laws, n = 100, K = 60, 8 seeds,
# m* = optimal_m(taus, sigma^2/eps = 100)
FIG8_LAWS = {"sqrt": ("fixed_sqrt", {}), "linear": ("fixed_linear", {}),
             "pow1.2": ("fixed_power", {"alpha": 1.2})}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["sync", "msync"])
@pytest.mark.parametrize("law", sorted(FIG8_LAWS))
def test_fig8_sync_cells_reproduce_baseline(law, method, dtype):
    scen, kw = FIG8_LAWS[law]
    model = make_scenario(scen, 100, **kw)
    m_star = optimal_m(model.taus, 100.0, 1.0)
    spec, key = (("sync", {}), "sync") if method == "sync" else \
        (("msync", {"m": m_star}), f"msync_m{m_star}")
    res = run_experiment(spec, model, n=100, K=60, seeds=8, device="cpu",
                         dtype=dtype)
    want = BASELINE["s_per_useful_grad_mean"][f"{law}/n=100/{key}"]
    got = res.rows[0]["s_per_useful_grad_mean"]
    assert got == pytest.approx(want, rel=1e-6, abs=0)


def _small(name):
    return {"partial_participation": {"t_max": 60.0},
            "universal_fig3": {"t_max": 30.0},
            "universal_fig4": {"t_max": 30.0}}.get(name, {})


def _mean(x):
    """Per-column mean and its standard error."""
    return x.mean(0), np.sqrt(x.var(0) / x.shape[0])


def _var(x):
    """Per-column variance and its standard error."""
    return _mean((x - x.mean(0)) ** 2)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(name):
    n = 10
    ref = ref_scenarios.make_scenario(name, n, **_small(name))
    port = make_scenario(name, n, **_small(name))
    assert port.n == ref.n == n
    if hasattr(ref, "powers"):
        assert np.array_equal(port.powers, ref.powers)
        assert np.array_equal(port.cum, ref.cum)
        return
    assert np.array_equal(port.taus, ref.taus)
    if hasattr(ref, "sampler"):
        assert port.R == ref.R and port.name == ref.name
        # the same law: per-worker mean and variance of 20000 draws each
        # within 4 standard errors of the reference's jax.random draws
        draws = 20000
        keys = rng.seed_keys(range(draws), "cpu")
        got = port.device_sampler("cpu", torch.float64)(
            rng.uniforms(keys, 0, rng.INIT, n, torch.float64)).numpy()
        want = np.asarray(jax.vmap(ref.jax_sampler)(
            jax.random.split(jax.random.PRNGKey(3), draws)), np.float64)
        for moment in (_mean, _var):
            (a, sa), (b, sb) = moment(got), moment(want)
            assert (np.abs(a - b) <= 4 * np.hypot(sa, sb)).all(), (a, b)


def test_make_scenario_errors():
    with pytest.raises(KeyError, match="unknown scenario"):
        make_scenario("gamma", 4)          # not ported yet
    with pytest.raises(ValueError, match="n=4"):
        run_experiment("sync", make_scenario("fixed_sqrt", 4), n=5, K=3,
                       device="cpu")


def test_run_experiment_json_is_atomic_and_valid(tmp_path):
    path = tmp_path / "exp.json"
    res = run_experiment(("msync", {"m": 3}), "exponential", n=12, K=40,
                         seeds=3, problem=quadratic_worst_case_torch(10, 0.5),
                         gamma=1.0, target_frac=1e-12, json_path=str(path),
                         device="cpu")
    doc = json.loads(path.read_text())
    assert not list(tmp_path.glob("*.tmp"))
    assert doc["name"] == "msync@exponential"
    assert doc["meta"]["backend"] == "torch"
    assert doc["meta"]["device"] == "cpu"
    assert doc["meta"]["seeds"] == [0, 1, 2]
    row = doc["rows"][0]
    # an unreachable target: inf quantiles are written as strings
    assert row["time_to_target_q50"] == "inf"
    assert row["time_to_target_hit_rate"] == 0.0
    assert res.rows[0]["scenario"] == "exponential"
    assert res.rows[0]["K"] == 40


def test_run_experiment_grid_and_time_to_target():
    res = run_experiment("msync", "fixed_sqrt", n=16, K=60, seeds=2,
                         grid={"m": [2, 8]},
                         problem=quadratic_worst_case_torch(8, 1.0),
                         gamma=1.0, target_frac=0.5, device="cpu")
    assert [r["params"] for r in res.rows] == [{"m": 2}, {"m": 8}]
    for r in res.rows:
        assert r["time_to_target_hit_rate"] == 1.0
        assert np.isfinite(r["time_to_target_q50"])
    # more workers per step wait longer for each step
    assert res.rows[0]["time_to_target_q50"] < res.rows[1][
        "time_to_target_q50"]
