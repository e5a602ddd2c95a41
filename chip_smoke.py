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
            and on the first round's finish times, held to ``torch.sort``
            on the CPU by value on rows of signed zeros and NaN of either
            sign, and
            timed beside ``torch.sort`` (its plain
            version), ``torch.kthvalue`` (one library call) and its bound;
4. main     the m-Sync simulator at paper scale (``fixed_sqrt``, n=1000,
            128 seeds, 2000 rounds, m=32) through ``run_experiment``,
            checked against the same run on the CPU and, at n=100, against
            the committed fig8 baseline;
5. sampled  exponential times with the worst-case quadratic (d=1000);
6. scale    n=10000 workers, 1024 seeds, with peak device memory; the
            sampled and scale phases also hold the kernel to its plain
            version on their own first round's finish times;
7. rwkv_kernel  the ``rwkv_scan`` kernel held to the float64 step
            recurrence (its plain version) at every shape the two phases
            below hand it and at T=1, 63, 65, 4096, B*H=1 and 80, bfloat16
            and float32 inputs, decays across the model's range
            [exp(-e), exp(-e^-8)] with a head held at exactly exp(-e);
            max |y - y64| <= 2e-4 max |y64|, and the same for the state;
            timed beside the plain version and its bound;
8. rwkv_prefill  ``Model.prefill`` of ``rwkv6-3b`` at full width (random
            weights from a seed), B=2, S=4096, bfloat16 and float32: wall
            time, tokens/s, peak memory, 32 kernel launches, the kernel
            held to the float64 recurrence on the first and last layers'
            own scan inputs, and the logits against the same prefill with
            the plain scan (``impl="ref"``);
9. rwkv_serve  ``ServeEngine.generate`` (float32, 4 slots, greedy, 16 new
            tokens) on 6 prompts of 16-130 tokens: the logits each first
            token was sampled from against ``Model.prefill`` of the prompt
            on the kernel path;
10. profile  device-busy share and top device kernels of a short main run
            and of one bfloat16 prefill;
11. attn_kernel  the ``flash_attention`` kernel held to its plain version
            in float64 at every shape the llama phases below hand it and at
            S=1, 63, 65, 129, head sizes 32 and 64, without the causal
            mask, windows of 1, 64 and 1000, Sq != Sk with rows that see no
            key (zeros), GQA groups 1 and 3; bfloat16 and float32; timed
            beside its plain version, ``scaled_dot_product_attention`` (one
            library call, timed only) and its bounds;
12. llama_prefill  ``Model.prefill`` of ``llama3.2-3b`` at full width
            (random weights from a seed), B=2, S=4096, bfloat16 and
            float32: wall time, tokens/s, peak memory, 28 kernel launches,
            the kernel held to the float64 plain version on the first and
            last layers' own q, k, v, and the logits against the same
            prefill with the reference's ref branch (``impl="ref"``);
13. llama_serve  ``ServeEngine.generate`` (float32, 4 slots, greedy, 16 new
            tokens, max_len 256) on 6 prompts of 16-130 tokens, against
            ``Model.prefill`` of each prompt on the kernel path;
14. profile  the same for one bfloat16 llama prefill.

The RWKV model is freed before the llama phases. Then the card's name and
power limit as ``nvidia-smi`` prints them, one JSON line describing every
kernel of the paths, and the result line.
"""

import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM: memory rate, float32 rate outside the tensor cores and the
# dense bfloat16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

MAIN = dict(scenario="fixed_sqrt", n=1000, seeds=128, K=2000, m=32)
SAMPLED = dict(scenario="exponential", n=1000, seeds=128, K=500, m=32,
               d=1000)
SCALE = dict(scenario="exponential", n=10000, seeds=1024, K=200, m=100)
# every (seeds, workers) shape and every m that a phase hands the kernel,
# and wider rows than the simulator's
SHAPES = ((128, 1000), (1024, 10000), (32, 10000), (4, 100000))
PATH_MS = {MAIN["m"], SAMPLED["m"], SCALE["m"]}

ARCH = "rwkv6-3b"
PREFILL = dict(batch=2, seq=4096, seed=0)
SERVE = dict(prompts=(16, 40, 64, 65, 96, 130), batch_size=4, new_tokens=16,
             max_len=512, seed=1)
# the scan's heads and head size at full width
RWKV_H, RWKV_K = 40, 64
RWKV_TOL = 2e-4          # max |y - y64| / max |y64|, and for the state
LOGITS_TOL = 1e-4        # rel L2 of float32 logits, kernel against plain
BF16_FACTOR = 1.5        # bf16: kernel error vs f32 <= 1.5 x plain's own
# a first token must equal the prefill's argmax where the top-2 gap of
# the prefill logits exceeds this share of their largest magnitude
TOP2_MARGIN = 1e-3

LLAMA = "llama3.2-3b"
LLAMA_SERVE = dict(SERVE, max_len=256)
# query heads, key/value heads and head size at full width
ATTN_H, ATTN_KV, ATTN_D = 24, 8, 128
# max |o - o64| <= tol * max |o64| once each element's rounding to the
# output type (unit roundoff times |o64|) is taken off: a bfloat16 output
# alone is up to 2**-8 of an element off. bfloat16 inputs are exact in
# float32, so what is left past that rounding is the kernel's float32
# arithmetic, held as tightly as for float32 inputs; a kernel that rounds
# its scores or weights to bfloat16 has to argue for its own limit
ATTN_TOL = {"bfloat16": 1e-5, "float32": 2e-5}
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float32": 2.0 ** -24}


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


def _assert_equal_by_value(x, m, what):
    """``mth_smallest`` equal to ``sort(x)[:, m-1]`` by value, with NaN in
    the same rows: the order contract on signed zeros and NaN. The sort
    runs on the CPU: on the card, ``torch.sort`` of rows of 1000 or more
    puts a sign-set NaN first, not last."""
    import torch

    from repro_torch.kernels import order_stats as ost
    got = ost.mth_smallest(x, m).cpu()
    want = torch.sort(x.cpu(), dim=1).values[:, m - 1]
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan])):
        raise AssertionError(f"mth_smallest differs from sort by value at "
                             f"{what} {tuple(x.shape)} {x.dtype} m={m}")


def _signed_zero_nan_rows(S, n, dtype, gen):
    """Small integers with about a fifth of the entries -0.0 and a tenth
    NaN of either sign, and a row of nothing but -0.0 and NaN."""
    import torch
    dev = "cuda"
    x = torch.randint(-3, 4, (S, n), generator=gen, device=dev).to(dtype)
    pick = torch.rand((S, n), generator=gen, device=dev)
    sign = torch.where(torch.rand((S, n), generator=gen, device=dev) < 0.5,
                       -1.0, 1.0).to(dtype)
    x = torch.where(pick < 0.2, torch.tensor(-0.0, dtype=dtype, device=dev),
                    x)
    x = torch.where(pick > 0.9, torch.copysign(
        torch.tensor(float("nan"), dtype=dtype, device=dev), sign), x)
    x[0] = torch.where(pick[0] < 0.5, -0.0, float("nan")).to(dtype)
    return x


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
            signed = _signed_zero_nan_rows(S, n, dtype, gen)
            for m in ms:
                _assert_equal_by_value(signed, m, "signed zeros and NaN")
            # recorded, not required: whether the card's own sort orders
            # these rows as the CPU's does
            on_card = torch.sort(signed, dim=1).values.cpu()
            on_cpu = torch.sort(signed.cpu(), dim=1).values
            card_sort_as_cpu = bool(
                torch.equal(torch.isnan(on_card), torch.isnan(on_cpu))
                and torch.equal(on_card.nan_to_num(), on_cpu.nan_to_num()))
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
                   "equal_by_value_on": "signed zeros and NaN",
                   "card_sort_as_cpu_on_them": card_sort_as_cpu,
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


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _rwkv_inputs(B, T, dtype, gen):
    """Scan inputs at full head width: r, k, v normal in ``dtype``; decays
    ``w = exp(-exp(x))`` with x uniform on [-8, 1], the model's clip, so w
    spans [exp(-e), exp(-e^-8)], and head 0 held at exactly exp(-e);
    ``u`` as the model draws it."""
    import torch
    shape = (B, T, RWKV_H, RWKV_K)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    x = torch.rand(shape, generator=gen, device="cuda") * 9.0 - 8.0
    w = torch.exp(-torch.exp(x))
    w[:, :, 0] = math.exp(-math.e)
    u = 0.1 * torch.randn((RWKV_H, RWKV_K), generator=gen, device="cuda")
    return r, k, v, w, u


def _hold_rwkv_to_f64(r, k, v, w, u, what):
    """The kernel against the float64 step recurrence on the same
    (rounded) inputs; returns the relative errors of y and of the state,
    and y's largest absolute error."""
    import torch

    from repro_torch.kernels import rwkv_scan as rs
    y, s = rs.rwkv_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    y64, s64 = rs.rwkv_scan_plain(*(a.double() for a in (r, k, v, w, u)))
    err_y = float((y.double() - y64).abs().max() / y64.abs().max())
    err_s = float((s.double() - s64).abs().max() / s64.abs().max())
    if not (err_y <= RWKV_TOL and err_s <= RWKV_TOL):
        raise AssertionError(f"rwkv_scan off the float64 recurrence at {what}"
                             f" {tuple(r.shape)} {r.dtype}: y {err_y}, "
                             f"state {err_s}")
    return err_y, err_s, float((y.double() - y64).abs().max())


def rwkv_bound_ms(B, T, H, K, in_bytes):
    """Least time for one scan: r, k, v (``in_bytes`` each) and w, u read
    once and y, state written once at the memory rate, or the float32
    operations of the kernel's chunked form (16-token chunks, FMA = 2)
    at the float32 rate, whichever is larger. Exponentials and logs,
    which run on the special-function units, are not counted."""
    C = 16
    chunks = -(-T // C)
    per_chunk = (2 * C * K                              # decayed r and k
                 + C * (C - 1) // 2 * K * 4 + C * K * 3  # intra weights
                 + C * K * (2 * K + 2 * C)               # outputs
                 + K * K * (1 + 2 * C))                  # state
    ops = B * H * chunks * per_chunk
    nbytes = (B * T * H * K * (3 * in_bytes + 4 + 4) + H * K * 4
              + B * H * K * K * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def phase_rwkv_kernel():
    import torch

    from repro_torch.kernels import rwkv_scan as rs
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S = PREFILL["batch"], PREFILL["seq"]
    # (B, T, input dtypes): the prefill phase's shape, every serve prompt
    # (the serve phase runs in float32) and the edge lengths
    shapes = [(B, S, (torch.bfloat16, torch.float32))]
    shapes += [(1, P, (torch.float32,)) for P in SERVE["prompts"]]
    shapes += [(1, T, (torch.bfloat16, torch.float32))
               for T in (1, 63, 65, 4096)]
    checked, max_abs = [], 0.0
    for Bx, T, dtypes in shapes:
        for dtype in dtypes:
            r, k, v, w, u = _rwkv_inputs(Bx, T, dtype, gen)
            ey, es, ab = _hold_rwkv_to_f64(r, k, v, w, u, "the kernel phase")
            max_abs = max(max_abs, ab)
            checked.append([Bx, T, str(dtype).replace("torch.", ""), ey, es])
    # B*H = 1: one head of one sequence
    r, k, v, w, u = _rwkv_inputs(1, 65, torch.float32, gen)
    one = [a[:, :, :1].contiguous() for a in (r, k, v, w)] + [u[:1]]
    ey, es, ab = _hold_rwkv_to_f64(*one, "one head")
    checked.append([1, 65, "float32, H=1", ey, es])
    max_abs = max(max_abs, ab)
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v, w, u = _rwkv_inputs(B, S, dtype, gen)
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = {"plain": lambda: rs.rwkv_scan_plain(r, k, v, w, u),
                  "kernel": lambda: rs.rwkv_scan(r, k, v, w, u)}[which]
            runs[which].append(cuda_ms(fn, 20 if which == "kernel" else 2))
        bnd, by = rwkv_bound_ms(B, S, RWKV_H, RWKV_K, r.element_size())
        name = str(dtype).replace("torch.", "")
        timing[name] = {"kernel_ms": sum(runs["kernel"]) / 2,
                        "plain_ms": sum(runs["plain"]) / 2,
                        "runs_ms": runs, "bound_ms": bnd, "bound_by": by}
    rec = {"phase": "rwkv_kernel", "tolerance": RWKV_TOL,
           "checked_B_T_dtype_erry_errs": checked, "max_abs_err": max_abs,
           "shape": [B, S, RWKV_H, RWKV_K], "timing": timing,
           "timing_method": "CUDA events, host ahead of the card, mean of "
                            "2 x 20 kernel calls and 2 x 2 plain calls"}
    emit(rec)
    return rec


def attn_bound_ms(B, Sq, Sk, H, KV, dh, causal, itemsize, ops_per_s):
    """Least time for one attention: q, k, v read once and o written once
    at the memory rate, or the products q.k and p.v over the visible
    (query, key) pairs (4 dh flops a pair) at ``ops_per_s``, whichever is
    larger."""
    pairs = (Sq * (Sq + 1) // 2 if causal and Sq == Sk else Sq * Sk)
    ops = pairs * 4 * dh * B * H
    nbytes = (2 * B * Sq * H + 2 * B * Sk * KV) * dh * itemsize
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def _attn_inputs(B, Sq, Sk, H, KV, dh, dtype, gen):
    import torch
    q = torch.randn((B, Sq, H, dh), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Sk, KV, dh), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    return q, k, v


def _hold_attn_to_f64(q, k, v, causal, window, what):
    """The kernel against its plain version in float64 on the same
    (rounded) inputs; rows with no valid key must be zeros. Returns the
    largest error relative to max |o64| before and after each element's
    rounding to the output type is taken off, and the largest absolute
    error."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    o = fa.flash_attention(q, k, v, causal=causal, window=window,
                           impl="kernel")
    torch.cuda.synchronize()
    o64 = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                   causal=causal, window=window)
    name = str(q.dtype).replace("torch.", "")
    diff = (o.double() - o64).abs()
    top = float(o64.abs().max())
    raw = float(diff.max()) / top
    excess = float((diff - UNIT_ROUNDOFF[name] * o64.abs()).max()) / top
    empty = o64.abs().amax(dim=(0, 2, 3)) == 0
    if not (excess <= ATTN_TOL[name] and not o[:, empty].any()):
        raise AssertionError(f"flash_attention off its float64 plain version "
                             f"at {what} q {tuple(q.shape)} k "
                             f"{tuple(k.shape)} {name} causal={causal} "
                             f"window={window}: {raw} ({excess} past the "
                             f"output's rounding)")
    return raw, excess, float(diff.max()), int(empty.sum())


def phase_attn_kernel():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = PREFILL["batch"], PREFILL["seq"]
    H, KV, D = ATTN_H, ATTN_KV, ATTN_D
    # (B, Sq, Sk, H, KV, dh, causal, window, dtypes): the prefill phase's
    # shape, every serve prompt's prefill (float32), then the edges
    cases = [(B, S, S, H, KV, D, True, None, (bf16, f32))]
    cases += [(1, P, P, H, KV, D, True, None, (f32,))
              for P in LLAMA_SERVE["prompts"]]
    cases += [(1, T, T, H, KV, D, True, None, (bf16, f32))
              for T in (1, 63, 65, 129)]
    cases += [(2, 129, 129, 4, 2, 32, True, None, (bf16, f32)),
              (2, 129, 129, 4, 2, 64, True, None, (bf16, f32)),
              (1, 300, 300, H, KV, D, False, None, (bf16, f32)),
              (1, 300, 300, H, KV, D, True, 1, (bf16, f32)),
              (1, 300, 300, H, KV, D, True, 64, (bf16, f32)),
              (1, 1100, 1100, 4, 2, 64, False, 1000, (bf16, f32)),
              (1, 200, 70, 6, 2, D, True, 16, (bf16, f32)),   # empty rows
              (1, 70, 200, 6, 2, D, True, None, (bf16, f32)),
              (1, 129, 129, 8, 8, D, True, None, (bf16, f32))]  # group 1
    checked, max_abs, empty_rows = [], 0.0, 0
    for Bx, Sq, Sk, Hx, KVx, dh, causal, window, dtypes in cases:
        for dtype in dtypes:
            q, k, v = _attn_inputs(Bx, Sq, Sk, Hx, KVx, dh, dtype, gen)
            raw, excess, ab, empty = _hold_attn_to_f64(
                q, k, v, causal, window, "the kernel phase")
            max_abs, empty_rows = max(max_abs, ab), empty_rows + empty
            checked.append([Bx, Sq, Sk, Hx, KVx, dh, causal, window,
                            str(dtype).replace("torch.", ""), raw, excess])
    if not empty_rows:
        raise AssertionError("no case had a row without a valid key")
    timing = {}
    for dtype in (bf16, f32):
        q, k, v = _attn_inputs(B, S, S, H, KV, D, dtype, gen)
        # the library call takes (B, H, S, dh); the copies are not timed
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        runs = {"plain": [], "kernel": [], "library": []}
        for which in ("plain", "kernel", "library", "kernel", "plain",
                      "library"):
            fn = {"plain": lambda: fa.flash_attention_plain(q, k, v),
                  "kernel": lambda: fa.flash_attention(q, k, v),
                  "library": lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True, enable_gqa=True)}[which]
            runs[which].append(cuda_ms(fn, 2 if which == "plain" else 10))
        del qt, kt, vt
        name = str(dtype).replace("torch.", "")
        tc, tc_by = attn_bound_ms(B, S, S, H, KV, D, True, q.element_size(),
                                  BF16_TC_OPS_PER_S)
        fp, fp_by = attn_bound_ms(B, S, S, H, KV, D, True, q.element_size(),
                                  FP32_OPS_PER_S)
        timing[name] = {"kernel_ms": sum(runs["kernel"]) / 2,
                        "plain_ms": sum(runs["plain"]) / 2,
                        "library_ms": sum(runs["library"]) / 2,
                        "runs_ms": runs,
                        "bound_ms_bf16_tensor_cores": tc, "bound_by": tc_by,
                        "bound_ms_float32_fma": fp,
                        "bound_by_float32_fma": fp_by}
    rec = {"phase": "attn_kernel", "tolerance": ATTN_TOL,
           "unit_roundoff_taken_off": UNIT_ROUNDOFF,
           "checked_B_Sq_Sk_H_KV_dh_causal_window_dtype_err_excess": checked,
           "rows_without_a_key_checked_zero": empty_rows,
           "max_abs_err": max_abs, "shape": [B, S, H, KV, D],
           "timing": timing,
           "library": "F.scaled_dot_product_attention(is_causal=True, "
                      "enable_gqa=True) on (B, H, S, dh) copies",
           "timing_method": "CUDA events, host ahead of the card, mean of "
                            "2 x 10 kernel and library calls and 2 x 2 "
                            "plain calls"}
    emit(rec)
    return rec


def _count_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import order_stats as ost
    from repro_torch.kernels import rwkv_scan as rs
    return {**ost.launch_counts, **rs.launch_counts, **fa.launch_counts}


def _reset_launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import order_stats as ost
    from repro_torch.kernels import rwkv_scan as rs
    ost.reset_launch_counts()
    rs.reset_launch_counts()
    fa.reset_launch_counts()


class _RecordCalls:
    """Within the block, the calls a model module makes to one of its
    kernel wrappers (``module.name``) also keep their arguments for the
    layers in ``layers``; the kernel runs as usual."""

    def __init__(self, module, name, layers):
        self.module, self.name = module, name
        self.layers, self.calls, self.kept = set(layers), 0, {}

    def __enter__(self):
        self._fn = getattr(self.module, self.name)

        def record(*args, **kwargs):
            if self.calls in self.layers:
                self.kept[self.calls] = (args, kwargs)
            self.calls += 1
            return self._fn(*args, **kwargs)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._fn)


def _full_width_params(arch):
    """``arch`` in bfloat16 with the port's init from a seed, and the
    same weights in float32."""
    import dataclasses

    import torch

    from repro_torch import build_model, get_config
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(PREFILL["seed"])
    bf16 = build_model(cfg)
    params = bf16.init_params(gen)
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = _map_tree(params, lambda t: t.float())
    return bf16, params, f32, params32


def _map_tree(node, fn):
    if isinstance(node, dict):
        return {k: _map_tree(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_tree(v, fn) for v in node]
    return fn(node)


def _prefill_phase(phase, arch, models, module, kernel, hold):
    """``Model.prefill`` of ``arch`` at full width, B=2, S=4096, in
    bfloat16 and float32: wall time, tokens/s, peak memory, one launch of
    ``kernel`` (called from ``module``) per layer, the kernel held on the
    first and last layers' own inputs by ``hold``, and the logits against
    the same prefill on the plain path (``impl="ref"``)."""
    import torch
    bf16, params, f32, params32 = models
    B, S = PREFILL["batch"], PREFILL["seq"]
    gen = torch.Generator(device="cuda").manual_seed(PREFILL["seed"] + 1)
    tokens = torch.randint(0, bf16.cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    out, launches = {}, None
    with torch.inference_mode():
        for name, model, p in (("bfloat16", bf16, params),
                               ("float32", f32, params32)):
            # warm-up, keeping the first and last layers' kernel inputs
            last = model.cfg.num_layers - 1
            with _RecordCalls(module, kernel, (0, last)) as rec:
                model.prefill(p, tokens)
            errs = [hold(rec.kept[i], f"the {name} prefill's layer {i}")
                    for i in (0, last)]
            del rec
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            logits = model.prefill(p, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _count_launches()
            if counts[kernel] != model.cfg.num_layers:
                raise AssertionError(f"expected one {kernel} launch per "
                                     f"layer, {counts}")
            if name == "bfloat16":
                launches = counts[kernel]
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            plain = model.prefill(p, tokens, impl="ref")
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
            if not (logits.shape == (B, model.cfg.vocab_size)
                    and torch.isfinite(logits).all()):
                raise AssertionError(f"bad {name} prefill logits")
            out[name] = {"logits": logits.float(), "plain": plain.float(),
                         "rec": {"wall_s": wall, "tokens_per_s": B * S / wall,
                                 "plain_wall_s": plain_wall,
                                 "peak_mem_bytes": peak, "launches": counts,
                                 "layers_0_and_last_err": errs}}
    ref = out["float32"]["plain"]
    err32 = _rel_l2(out["float32"]["logits"], ref)
    same_argmax = bool(torch.equal(out["float32"]["logits"].argmax(-1),
                                   ref.argmax(-1)))
    if not (err32 <= LOGITS_TOL and same_argmax):
        raise AssertionError(f"float32 prefill: kernel vs plain rel L2 "
                             f"{err32}, argmax equal {same_argmax}")
    err_k = _rel_l2(out["bfloat16"]["logits"], ref)
    err_p = _rel_l2(out["bfloat16"]["plain"], ref)
    if not err_k <= BF16_FACTOR * err_p:
        raise AssertionError(f"bfloat16 prefill: kernel off float32 by "
                             f"{err_k}, plain by {err_p}")
    emit({"phase": phase, "arch": arch, **PREFILL,
          "params": bf16.cfg.param_count(),
          "bfloat16": out["bfloat16"]["rec"],
          "float32": out["float32"]["rec"],
          "f32_kernel_vs_plain_rel_l2": err32, "f32_argmax_equal": same_argmax,
          "bf16_kernel_vs_f32_rel_l2": err_k,
          "bf16_plain_vs_f32_rel_l2": err_p})
    return launches


def phase_rwkv_prefill(models):
    from repro_torch.models import ssm
    return _prefill_phase(
        "rwkv_prefill", ARCH, models, ssm, "rwkv_scan",
        lambda kept, what: _hold_rwkv_to_f64(*kept[0], what)[:2])


def phase_llama_prefill(models):
    from repro_torch.models import attention

    def hold(kept, what):
        (q, k, v), kw = kept
        return _hold_attn_to_f64(q, k, v, kw["causal"], kw["window"],
                                 what)[:2]

    return _prefill_phase("llama_prefill", LLAMA, models, attention,
                          "flash_attention", hold)


def _serve_phase(phase, arch, models, kernel, short, serve, engine_zero=None):
    """``ServeEngine.generate`` in float32: the logits each first token
    was sampled from against ``Model.prefill`` of the prompt on the kernel
    path. ``engine_zero``, where given, is why the engine itself launches
    ``kernel`` no time, which is then checked."""
    import numpy as np
    import torch

    from repro_torch import Request, ServeEngine
    _, _, f32, params32 = models
    rng = np.random.default_rng(serve["seed"])
    reqs = [Request(prompt=rng.integers(0, f32.cfg.vocab_size, size=P),
                    max_new_tokens=serve["new_tokens"])
            for P in serve["prompts"]]
    engine = ServeEngine(f32, params32, batch_size=serve["batch_size"],
                         max_len=serve["max_len"])
    _reset_launches()
    t0 = time.perf_counter()
    engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine_launches = _count_launches()[kernel]
    if engine_zero is not None and engine_launches:
        raise AssertionError(f"the engine launched {kernel} "
                             f"{engine_launches} times; expected none: "
                             f"{engine_zero}")
    worst, compared = 0.0, 0
    with torch.inference_mode():
        for req in reqs:
            if not (req.done and len(req.out_tokens) == serve["new_tokens"]):
                raise AssertionError("a request did not finish")
            want = f32.prefill(params32, torch.tensor(
                req.prompt[None], device="cuda"))[0].float().cpu()
            err = _rel_l2(req.first_logits, want)
            worst = max(worst, err)
            if not err <= LOGITS_TOL:
                raise AssertionError(f"engine logits off the kernel prefill "
                                     f"by {err} at prompt {len(req.prompt)}")
            top2 = torch.topk(want, 2).values
            if top2[0] - top2[1] > TOP2_MARGIN * want.abs().max():
                compared += 1
                if req.out_tokens[0] != int(want.argmax()):
                    raise AssertionError("first token differs from the "
                                         "prefill's argmax")
    new = sum(len(r.out_tokens) for r in reqs)
    rec = {"phase": phase, "arch": arch, "dtype": "float32", **serve,
           "wall_s": wall, "new_tokens_per_s": new / wall,
           "decode_steps": sum(len(r.prompt) - 1 for r in reqs) + new,
           f"engine_{short}_launches": engine_launches}
    if engine_zero is not None:
        rec[f"engine_{short}_launches_expected_0_because"] = engine_zero
    rec.update({f"prefill_{short}_launches": _count_launches()[kernel],
                "max_rel_l2_vs_prefill": worst,
                "first_tokens_checked": compared, "top2_margin": TOP2_MARGIN})
    emit(rec)


def phase_rwkv_serve(models):
    _serve_phase("rwkv_serve", ARCH, models, "rwkv_scan", "scan", SERVE)


def phase_llama_serve(models):
    _serve_phase(
        "llama_serve", LLAMA, models, "flash_attention", "flash", LLAMA_SERVE,
        engine_zero="the engine prefills token by token through "
                    "Model.decode_step, whose attention is plain masked "
                    "attention over the KV cache, as in the reference "
                    "(src/repro/models/attention.py:164-178)")


def _profiled(fn):
    """Wall time, device-busy time and top device kernels of one call of
    ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall, "device_busy_s": busy_us * 1e-6,
            "device_busy_share": busy_us * 1e-6 / wall if busy_us else None,
            "top_kernels_us": [[e.key[:90], e.self_device_time_total,
                                e.count] for e in top]}


def _profile_prefill(path, arch, models):
    """Device-busy share and top device kernels of one bfloat16 prefill."""
    import torch
    bf16, params = models[:2]
    gen = torch.Generator(device="cuda").manual_seed(PREFILL["seed"] + 2)
    tokens = torch.randint(0, bf16.cfg.vocab_size,
                           (PREFILL["batch"], PREFILL["seq"]),
                           generator=gen, device="cuda")

    def prefill():
        with torch.inference_mode():
            bf16.prefill(params, tokens)

    prefill()
    emit({"phase": "profile", "path": path, "arch": arch,
          "dtype": "bfloat16", **PREFILL, **_profiled(prefill)})


def phase_profile(models):
    from repro_torch.exp import run_experiment
    K = 200
    kw = dict(n=MAIN["n"], K=K, seeds=MAIN["seeds"], device="cuda")

    def main_run():
        run_experiment(("msync", {"m": MAIN["m"]}), MAIN["scenario"], **kw)

    main_run()
    emit({"phase": "profile", "path": "main", "scenario": MAIN["scenario"],
          "K": K, **_profiled(main_run)})
    _profile_prefill("rwkv_prefill", ARCH, models)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    kernel = phase_kernel()
    rwkv = phase_rwkv_kernel()
    attn = phase_attn_kernel()
    launches, _ = phase_main()
    phase_sampled()
    phase_scale()
    models = _full_width_params(ARCH)
    rwkv_launches = phase_rwkv_prefill(models)
    phase_rwkv_serve(models)
    phase_profile(models)
    # one model's weights on the card at a time
    del models
    gc.collect()
    torch.cuda.empty_cache()
    models = _full_width_params(LLAMA)
    attn_launches = phase_llama_prefill(models)
    phase_llama_serve(models)
    _profile_prefill("llama_prefill", LLAMA, models)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    at = kernel[(MAIN["seeds"], MAIN["n"], "float32")]
    max_err = max(rec["max_abs_err"] for rec in kernel.values())
    bf = rwkv["timing"]["bfloat16"]
    at_bf = attn["timing"]["bfloat16"]
    emit({"kernels": [{
        "name": "mth_smallest", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/order_stats.cu",
        "replaces": "src/repro/kernels/order_stats.py:238",
        "launches": launches, "max_abs_err": max_err,
        "ms": at["kernel_ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        "path": "main: run_experiment, one launch per round"}, {
        "name": "rwkv_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_scan.cu",
        "replaces": "src/repro/kernels/rwkv_scan.py:73",
        "launches": rwkv_launches, "max_abs_err": rwkv["max_abs_err"],
        "ms": bf["kernel_ms"], "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this scan",
        "shape": rwkv["shape"], "dtype": "bfloat16",
        "path": "rwkv_prefill: Model.prefill of rwkv6-3b, B=2, S=4096, "
                "bfloat16, one launch per layer"}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "launches": attn_launches, "max_abs_err": attn["max_abs_err"],
        "ms": at_bf["kernel_ms"], "plain_ms": at_bf["plain_ms"],
        "bound_ms": at_bf["bound_ms_bf16_tensor_cores"],
        "bound_by": at_bf["bound_by"],
        "bound_ms_float32_fma": at_bf["bound_ms_float32_fma"],
        "library_ms": at_bf["library_ms"],
        "library_note": "F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), timed only",
        "shape": attn["shape"], "dtype": "bfloat16",
        "path": "llama_prefill: Model.prefill of llama3.2-3b, B=2, S=4096, "
                "bfloat16, one launch per layer"}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
