#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Usage, from the root of a checkout on a machine with an H100::

    python3 chip_smoke.py

Each phase prints one JSON line and raises on failure, so any failing
phase ends the run with a nonzero exit code and no result line:

1. device   torch and CUDA versions, the card's name and capability (9, 0);
2. build    the CUDA kernels, compiled from ``src/repro_torch/kernels/csrc``,
            with each kernel's registers, stack, shared and local memory;
3. kernel   ``mth_smallest`` held bitwise to its plain version at every
            shape and ``m`` the phases below hand it and at wider rows,
            float32 and float64, on uniform, tie-heavy and ``+inf`` rows
            and on the first round's finish times, and timed beside ``torch.sort`` (its plain
            version), ``torch.kthvalue`` (one library call) and its bound;
4. main     the m-Sync simulator at paper scale (``fixed_sqrt``, n=1000,
            128 seeds, 2000 rounds, m=32) through ``run_experiment``,
            checked against the same run on the CPU and, at n=100, against
            the committed fig8 baseline;
5. sampled  exponential times with the worst-case quadratic (d=1000);
6. scale    n=10000 workers, 1024 seeds, with peak device memory; the
            sampled and scale phases also hold the kernel to its plain
            version on their own first round's finish times;
7. profile  device-busy share and top device kernels of a short main run.

Then the card's name and power limit as ``nvidia-smi`` prints them, one
JSON line describing every kernel of the path, and the result line.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM: memory rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MAIN = dict(scenario="fixed_sqrt", n=1000, seeds=128, K=2000, m=32)
SAMPLED = dict(scenario="exponential", n=1000, seeds=128, K=500, m=32,
               d=1000)
SCALE = dict(scenario="exponential", n=10000, seeds=1024, K=200, m=100)
# every (seeds, workers) shape and every m that a phase hands the kernel,
# and wider rows than the simulator's
SHAPES = ((128, 1000), (1024, 10000), (32, 10000), (4, 100000))
PATH_MS = {MAIN["m"], SAMPLED["m"], SCALE["m"]}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    """Mean device time of one call of ``fn`` over ``iters`` calls, from
    CUDA events after a warm-up. A sleep kernel holds the card first
    while the host enqueues every call, so the events time the calls
    back to back on the card and not the host's launch rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # twice the host's time for the calls, in cycles at up to 2 GHz
    torch.cuda._sleep(int(2 * host_s * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(S, n, itemsize):
    """Least time for one selection: each input read once and each output
    written once at the memory rate, or one comparison per element at
    the float32 rate, whichever is larger."""
    bytes_ms = (S * n + S) * itemsize / HBM_BYTES_PER_S * 1e3
    ops_ms = S * n / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": name, "capability": cap,
          "count": torch.cuda.device_count()})
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a, not {cap}")
    return name


def phase_build():
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    ext = _build.extension()
    seconds = time.perf_counter() - t0
    dump = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-res-usage",
         ext.__file__], capture_output=True, text=True, check=True).stdout
    usage = []
    for fn, res in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", dump):
        fields = dict(kv.split(":") for kv in res.split())
        usage.append({"function": fn, "registers": int(fields["REG"]),
                      "stack": int(fields["STACK"]),
                      "shared": int(fields["SHARED"]),
                      "local": int(fields["LOCAL"])})
    if not usage:
        raise RuntimeError("no kernel in the built library:\n" + dump)
    emit({"phase": "build", "seconds": seconds,
          "sources": [str(s.relative_to(ROOT)) for s in _build.SOURCES],
          "kernels": usage})


def _first_round(scenario, S, n, dtype):
    """The candidate finish times that the simulator's first round hands
    the kernel under a sampled ``scenario`` with seeds ``0..S-1``: every
    worker's first duration, drawn as the simulator draws it."""
    from repro_torch.core import rng
    from repro_torch.exp import make_scenario
    model = make_scenario(scenario, n)
    keys = rng.seed_keys(range(S), "cuda")
    return model.device_sampler("cuda", dtype)(
        rng.uniforms(keys, 0, rng.INIT, n, dtype))


def _assert_equal_to_plain(x, m, what):
    """``mth_smallest`` bitwise equal to ``mth_smallest_plain`` on ``x``."""
    import torch

    from repro_torch.kernels import order_stats as ost
    got = ost.mth_smallest(x, m)
    want = ost.mth_smallest_plain(x, m).contiguous()
    int_type = torch.int32 if x.dtype == torch.float32 else torch.int64
    if not torch.equal(got.view(int_type), want.view(int_type)):
        raise AssertionError(f"mth_smallest differs from sort at {what} "
                             f"{tuple(x.shape)} {x.dtype} m={m}")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _cases(S, n, dtype, gen):
    """Uniform finish times, tie-heavy integer rows, rows of workers that
    never finish (+inf), and the first round of exponential times, on
    the card."""
    import torch
    dev = "cuda"
    uniform = torch.rand((S, n), generator=gen, device=dev,
                         dtype=torch.float64).to(dtype) * 100.0
    ties = torch.randint(0, 50, (S, n), generator=gen, device=dev).to(dtype)
    inf = ties.clone()
    inf[0::2, : n // 2] = float("inf")
    inf[1::4] = float("inf")
    return {"uniform": uniform, "ties": ties, "inf": inf,
            "exponential": _first_round("exponential", S, n, dtype)}


def phase_kernel():
    import torch

    from repro_torch.kernels import order_stats as ost
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for S, n in SHAPES:
        for dtype in (torch.float32, torch.float64):
            cases = _cases(S, n, dtype, gen)
            ms = sorted(m for m in {1, 37, n // 2, n} | PATH_MS if m <= n)
            max_err = 0.0
            for name, x in cases.items():
                for m in ms:
                    max_err = max(max_err, _assert_equal_to_plain(x, m, name))
            x = cases["uniform"]
            m = SCALE["m"] if (S, n) == (SCALE["seeds"], SCALE["n"]) \
                else MAIN["m"]
            iters = 200 if S * n <= 400_000 else 50
            runs = {"plain": [], "kernel": [], "library": []}
            for which in ("plain", "kernel", "library", "kernel", "plain",
                          "library"):
                fn = {"plain": lambda: ost.mth_smallest_plain(x, m),
                      "kernel": lambda: ost.mth_smallest(x, m),
                      "library": lambda: torch.kthvalue(x, m, dim=1)}[which]
                runs[which].append(cuda_ms(fn, iters))
            bnd, by = bound_ms(S, n, x.element_size())
            rec = {"phase": "kernel", "shape": [S, n],
                   "dtype": str(dtype).replace("torch.", ""), "m": m,
                   "cases": sorted(cases), "ms_checked": ms,
                   "bitwise_equal": True,
                   "max_abs_err": max_err,
                   "kernel_ms": sum(runs["kernel"]) / 2,
                   "plain_ms": sum(runs["plain"]) / 2,
                   "library_ms": sum(runs["library"]) / 2,
                   "runs_ms": runs, "bound_ms": bnd, "bound_by": by,
                   "timing": "CUDA events, host ahead of the card, "
                             f"L2-warm, mean of 2 x {iters} calls"}
            emit(rec)
            results[(S, n, rec["dtype"])] = rec
    return results


def _fig8_max_rel_err(device):
    """The committed fig8 baseline's fixed-time sync and m-sync cells
    (n=100, K=60, 8 seeds), run on ``device``."""
    from repro_torch.core import optimal_m
    from repro_torch.exp import make_scenario, run_experiment
    base = json.loads((ROOT / "benchmarks/baselines/BENCH_fig8.json")
                      .read_text())["s_per_useful_grad_mean"]
    worst = 0.0
    for law, scen, kw in (("sqrt", "fixed_sqrt", {}),
                          ("linear", "fixed_linear", {}),
                          ("pow1.2", "fixed_power", {"alpha": 1.2})):
        model = make_scenario(scen, 100, **kw)
        m_star = optimal_m(model.taus, 100.0, 1.0)
        for key, spec in (("sync", ("sync", {})),
                          (f"msync_m{m_star}", ("msync", {"m": m_star}))):
            got = run_experiment(spec, model, n=100, K=60, seeds=8,
                                 device=device).rows[0]
            want = base[f"{law}/n=100/{key}"]
            worst = max(worst, abs(got["s_per_useful_grad_mean"] / want - 1))
    return worst


def phase_main():
    import torch

    from repro_torch.core.batch_torch import _fixed_timing_run
    from repro_torch.exp import make_scenario, run_experiment
    from repro_torch.kernels import order_stats as ost
    spec = ("msync", {"m": MAIN["m"]})
    kw = dict(n=MAIN["n"], K=MAIN["K"], seeds=MAIN["seeds"])
    torch.cuda.synchronize()
    ost.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(spec, MAIN["scenario"], device="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = dict(ost.launch_counts)
    if launches["mth_smallest"] != MAIN["K"]:
        raise AssertionError(f"expected one launch per round, {launches}")
    # every round's T and the counts against the same rounds on the CPU
    taus = make_scenario(MAIN["scenario"], MAIN["n"]).taus
    t0 = time.perf_counter()
    comp_cpu, T_cpu = _fixed_timing_run(
        torch.tensor(taus, dtype=torch.float32), MAIN["seeds"], MAIN["m"],
        MAIN["K"])
    cpu_wall = time.perf_counter() - t0
    comp_card, T_card = _fixed_timing_run(
        torch.tensor(taus, dtype=torch.float32, device="cuda"),
        MAIN["seeds"], MAIN["m"], MAIN["K"])
    b = res.batch
    if not (torch.equal(T_card.cpu(), T_cpu)
            and torch.equal(comp_card.cpu(), comp_cpu)
            and np.array_equal(b.total_time[0], T_cpu[-1].double().numpy())
            and np.array_equal(b.stat("gradients_computed")[0],
                               comp_cpu.double().numpy())):
        raise AssertionError("the card's rounds differ from the CPU's")
    fig8 = _fig8_max_rel_err("cuda")
    if not fig8 <= 1e-6:
        raise AssertionError(f"fig8 cells off the baseline by {fig8}")
    row = res.rows[0]
    emit({"phase": "main", **MAIN, "dtype": "float32", "launches": launches,
          "wall_s": wall, "rounds_per_s": MAIN["K"] / wall,
          "cpu_wall_s": cpu_wall, "equal_to_cpu": True,
          "fig8_max_rel_err": fig8,
          "s_per_useful_grad_mean": row["s_per_useful_grad_mean"],
          "discard_fraction_mean": row["discard_fraction_mean"]})
    return launches["mth_smallest"], wall


def phase_sampled():
    import torch

    from repro_torch.core import quadratic_worst_case_torch
    from repro_torch.exp import run_experiment
    from repro_torch.kernels import order_stats as ost
    scen, n, S, K, m, d = (SAMPLED[k] for k in
                           ("scenario", "n", "seeds", "K", "m", "d"))
    _assert_equal_to_plain(_first_round(scen, S, n, torch.float32), m,
                           "the sampled phase's first round")
    problem = quadratic_worst_case_torch(d=d, p=0.1)
    torch.cuda.synchronize()
    ost.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(("msync", {"m": m}), scen, n=n, K=K,
                         seeds=S, problem=problem, gamma=1.0,
                         target_frac=0.5, device="cuda")
    wall = time.perf_counter() - t0
    traces = res.batch.traces[0]
    f0 = traces[0].values[0]
    f_end = np.array([tr.values[-1] for tr in traces])
    for tr in traces:
        if not (np.all(np.isfinite(tr.values)) and np.all(np.diff(tr.times)
                                                          > 0)):
            raise AssertionError("non-finite values or non-increasing times")
    if not np.all(f_end < 0.1 * f0):
        raise AssertionError(f"f did not fall: {f0} -> {f_end.max()}")
    if ost.launch_counts["mth_smallest"] != K:
        raise AssertionError(f"launches {ost.launch_counts}")
    row = res.rows[0]
    emit({"phase": "sampled", **SAMPLED, "p": 0.1, "gamma": 1.0,
          "launches": dict(ost.launch_counts), "wall_s": wall,
          "rounds_per_s": K / wall, "f_start": f0,
          "f_end_mean": float(f_end.mean()), "f_end_max": float(f_end.max()),
          "time_to_half_grad_q50": row["time_to_target_q50"]})


def phase_scale():
    import torch

    from repro_torch.exp import run_experiment
    from repro_torch.kernels import order_stats as ost
    scen, n, S, K, m = (SCALE[k] for k in
                        ("scenario", "n", "seeds", "K", "m"))
    _assert_equal_to_plain(_first_round(scen, S, n, torch.float32), m,
                           "the scale phase's first round")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ost.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_experiment(("msync", {"m": m}), scen, n=n, K=K,
                         seeds=S, device="cuda")
    wall = time.perf_counter() - t0
    tt = res.batch.total_time
    comp = res.batch.stat("gradients_computed")
    if not (np.all(np.isfinite(tt)) and np.all(tt > 0)
            and np.all(comp >= m * K)):
        raise AssertionError("bad totals at scale")
    if ost.launch_counts["mth_smallest"] != K:
        raise AssertionError(f"launches {ost.launch_counts}")
    emit({"phase": "scale", **SCALE, "launches": dict(ost.launch_counts),
          "wall_s": wall, "rounds_per_s": K / wall,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "total_time_mean": float(tt.mean())})


def phase_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.exp import run_experiment
    K = 200
    kw = dict(n=MAIN["n"], K=K, seeds=MAIN["seeds"], device="cuda")
    run_experiment(("msync", {"m": MAIN["m"]}), MAIN["scenario"], **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_experiment(("msync", {"m": MAIN["m"]}), MAIN["scenario"], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "profile", "scenario": MAIN["scenario"], "K": K,
          "wall_s": wall, "device_busy_s": busy_us * 1e-6,
          "device_busy_share": busy_us * 1e-6 / wall if busy_us else None,
          "top_kernels_us": [[e.key[:90], e.self_device_time_total,
                              e.count] for e in top]})


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    kernel = phase_kernel()
    launches, _ = phase_main()
    phase_sampled()
    phase_scale()
    phase_profile()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    at = kernel[(MAIN["seeds"], MAIN["n"], "float32")]
    max_err = max(rec["max_abs_err"] for rec in kernel.values())
    emit({"kernels": [{
        "name": "mth_smallest", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/order_stats.cu",
        "replaces": "src/repro/kernels/order_stats.py:238",
        "launches": launches, "max_abs_err": max_err,
        "ms": at["kernel_ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": at["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
