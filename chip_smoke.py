#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``deeprl_network_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python chip_smoke.py            # add --profile for a torch.profiler pass

Phases (any failure raises, exits non-zero and prints no result line):
  1. device: require a CUDA card; print its name and power limit;
  2. build: compile every CUDA kernel from ``deeprl_network_tpu_torch/ops/csrc``
     with nvcc (one process per source, all started together);
  3. kernels: hold each kernel against its plain PyTorch twin on the card at
     the main path's shape (B=768, N=25, F=H=64) in f32 and bf16, at ragged
     shapes and at a width that takes the general kernel, forward and
     backward; time them at the main path's shape from replays of a CUDA
     graph of 20 launches (``ms``: inputs warm in L2; ``cold_ms``: L2
     flushed before every launch; ``call_ms``: the host's time per call),
     the earlier general kernel in bf16 beside the tensor-core one;
  4. reference: a small f32 train step on the card against the same step on
     the CPU (plain twins, held against the JAX package by the CPU tests);
  5. main path: the flagship MA2C_NC train step on the 5x5 grid at full
     width (B=768 envs, T=120, bf16 with f32 masters, sparse_comm, remat)
     through ``make_a2c``: a warm-up step and 5 timed steps, with the kernel
     launch counts read around them;
  6. (--profile) device busy share and kernel time by name over one step.

Output: a kernels JSON line and the card's name and power limit on lines
before the last; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FLAGSHIP = dict(B=768, N=25, F=64, H=64)
RAGGED = dict(B=12, N=3, F=16, H=16)
RAGGED_WIDE = dict(B=37, N=5, F=32, H=48)
RAGGED_FULL = dict(B=100, N=25, F=64, H=64)
ODD_WIDTH = dict(B=37, N=5, F=24, H=40)     # takes the general kernel
FLUSH_BYTES = 128 * 2 ** 20                 # more than twice the 50 MB L2
TOL = {("float32", "fwd"): 1e-5, ("float32", "bwd"): 1e-4,
       ("bfloat16", "fwd"): 0.05, ("bfloat16", "bwd"): 0.05}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


_SIDE_STREAM = None    # the one stream all graphs are captured on


def graph_ms(fn, n: int = 20, reps: int = 15, flush=None) -> float:
    """Device time of one ``fn()`` in ms: ``n`` calls captured in a CUDA
    graph, each replay timed with one pair of events over the count, median
    over ``reps`` replays. The graph keeps the queue full, so the host's time
    between launches does not show. With ``flush`` (a buffer larger than the
    L2 cache), every call is preceded by a write of the whole buffer, so that
    ``fn`` finds its inputs in device memory, and the time of a graph of the
    writes alone is taken off."""
    import torch
    global _SIDE_STREAM
    if _SIDE_STREAM is None:
        _SIDE_STREAM = torch.cuda.Stream()
    side = _SIDE_STREAM

    def capture(body):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):                  # warm-up, scratch allocation
                body()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(n):
                body()
        return g

    def replay_ms(g):
        g.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2] / n

    if flush is None:
        return replay_ms(capture(fn))

    def both():
        flush.zero_()
        fn()
    return replay_ms(capture(both)) - replay_ms(capture(flush.zero_))


def host_call_ms(fn, n: int = 200) -> float:
    """Host wall time of one ``fn()`` call (enqueue only: the queue is
    drained before and synchronised after, not between)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e3


def cell_inputs(B, N, F, H, dtype, seed=0):
    """Numpy-seeded inputs of the cell on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.tensor(
        (rng.standard_normal(s) * scale).astype(np.float32),
        device="cuda").to(dtype)
    G = 4 * H
    inp = dict(wx=t(N, F, G, scale=F ** -0.5), wh=t(N, H, G, scale=H ** -0.5),
               b=t(N, G, scale=0.1), c=t(B, N, H), h=t(B, N, H), x=t(B, N, F),
               done=torch.tensor((rng.random(B) < 0.3).astype(np.float32),
                                 device="cuda").to(dtype))
    cot = dict(dc_new=t(B, N, H), dh_new=t(B, N, H))
    return inp, cot


def max_err(got, want, tol: float, what: str) -> float:
    """Max abs difference; raise where |got - want| > tol + tol * |want|."""
    import torch
    worst = 0.0
    for name, a, b in zip(what.split(","), got, want):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        d = (a - b).abs()
        bad = d > tol + tol * b.abs()
        if bad.any():
            raise AssertionError(
                f"{name}: {int(bad.sum())} elements off by up to "
                f"{float(d.max()):.3e} (tol {tol})")
        worst = max(worst, float(d.max()))
    return worst


def cell_bytes_flops(B, N, F, H, dtype):
    """Bytes each kernel function must move (inputs read once, outputs
    written once) and its matrix-product operations."""
    import torch
    es = torch.tensor([], dtype=dtype).element_size()
    G = 4 * H
    act_h, act_x = B * N * H * es, B * N * F * es
    weights = (N * F * G + N * H * G + N * G) * es
    done = B * es
    # forward on the train path: x, h, c, done, weights in; h', c', h_in,
    # c_in out
    fwd_bytes = act_x + 2 * act_h + done + weights + 4 * act_h
    fwd_flops = 2 * B * N * (F + H) * G
    # backward: x, h_in, c_in, c_new, dc', dh', done, weights in; dx, dh,
    # dc_prev out, and f32 dwx, dwh, db
    bwd_bytes = (act_x + 5 * act_h + done + weights
                 + act_x + 2 * act_h + (N * F * G + N * H * G + N * G) * 4)
    bwd_flops = 3 * fwd_flops  # gate recompute, [dx|dh], [dwx|dwh]
    return (fwd_bytes, fwd_flops), (bwd_bytes, bwd_flops)


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cell_args(shape, dtype):
    """(forward args, backward args) of the wrappers and twins at a shape;
    the backward's residuals come from the forward twin."""
    from deeprl_network_tpu_torch.ops import lstm_cell as lc
    inp, cot = cell_inputs(**shape, dtype=dtype)
    fwd_args = (inp["wx"], inp["wh"], inp["b"], inp["c"], inp["h"],
                inp["x"], inp["done"])
    c_new, _, h_in, c_in = lc.lstm_cell_fwd_ref(*fwd_args)
    bwd_args = (inp["wx"], inp["wh"], inp["b"], inp["x"], h_in, c_in,
                c_new, inp["done"], cot["dc_new"], cot["dh_new"])
    return fwd_args, bwd_args


def check_kernels():
    """Kernels vs twins at the flagship, ragged and edge shapes, every
    variant the dispatch rule can take; timing at the flagship shape (the
    main path's is bf16). Returns the kernels' entries."""
    import torch
    from deeprl_network_tpu_torch.ops import lstm_cell as lc
    entries = {}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cases = [("flagship", FLAGSHIP, "float32", None),
             ("flagship", FLAGSHIP, "bfloat16", None),
             ("flagship", FLAGSHIP, "bfloat16", "general"),
             ("ragged", RAGGED, "float32", None),
             ("ragged", RAGGED, "bfloat16", None),
             ("ragged_wide", RAGGED_WIDE, "bfloat16", None),
             ("ragged_full", RAGGED_FULL, "bfloat16", None),
             ("odd_width", ODD_WIDTH, "bfloat16", None)]
    for shape_name, shape, dt_name, forced in cases:
        dt = getattr(torch, dt_name)
        variant = forced or lc.kernel_variant(dt, shape["F"], shape["H"])
        kw = dict(_variant=forced) if forced else {}
        fwd_args, bwd_args = cell_args(shape, dt)
        before = dict(lc.LAUNCHES)
        got_f = lc.lstm_cell_fwd(*fwd_args, **kw)
        want_f = lc.lstm_cell_fwd_ref(*fwd_args)
        torch.cuda.synchronize()
        err_f = max_err(got_f, want_f, TOL[(dt_name, "fwd")],
                        "c_new,h_new,h_in,c_in")
        got_n = lc.lstm_cell_fwd(*fwd_args, residuals=False, **kw)
        torch.cuda.synchronize()
        if got_n[2] is not None or not all(
                torch.equal(a, b) for a, b in zip(got_n[:2], got_f[:2])):
            raise AssertionError("forward without residuals differs")
        got_b = lc.lstm_cell_bwd(*bwd_args, **kw)
        want_b = lc.lstm_cell_bwd_ref(*bwd_args)
        torch.cuda.synchronize()
        err_b = max_err(got_b, want_b, TOL[(dt_name, "bwd")],
                        "dx,dh,dc_prev,dwx,dwh,db")
        # bitwise determinism of the backward (no atomics)
        again = lc.lstm_cell_bwd(*bwd_args, **kw)
        for a, b in zip(got_b, again):
            if not torch.equal(a, b):
                raise AssertionError("lstm_cell_bwd is not deterministic")
        moved = {k: v - before[k] for k, v in lc.LAUNCHES.items()
                 if v != before[k]}
        if moved != {"lstm_cell_fwd": 2, f"lstm_cell_fwd_{variant}": 2,
                     "lstm_cell_bwd": 2, f"lstm_cell_bwd_{variant}": 2}:
            raise AssertionError(f"launch counts moved by {moved}, "
                                 f"expected the {variant} variant")
        row = {"shape": shape_name, "dtype": dt_name, "variant": variant,
               **shape, "fwd_max_abs_err": err_f, "bwd_max_abs_err": err_b}
        if shape_name == "flagship":
            fwd = lambda: lc.lstm_cell_fwd(*fwd_args, **kw)
            bwd = lambda: lc.lstm_cell_bwd(*bwd_args, **kw)
            row.update(
                fwd_ms=graph_ms(fwd), fwd_cold_ms=graph_ms(fwd, flush=flush),
                fwd_call_ms=host_call_ms(fwd),
                bwd_ms=graph_ms(bwd), bwd_cold_ms=graph_ms(bwd, flush=flush),
                bwd_call_ms=host_call_ms(bwd))
            if not forced:
                row.update(
                    fwd_plain_ms=graph_ms(
                        lambda: lc.lstm_cell_fwd_ref(*fwd_args), n=5),
                    bwd_plain_ms=graph_ms(
                        lambda: lc.lstm_cell_bwd_ref(*bwd_args), n=5))
            (fb, ff), (bb, bf) = cell_bytes_flops(**shape, dtype=dt)
            row["fwd_bound_ms"], row["fwd_bound_by"] = bound(fb, ff, dt_name)
            row["bwd_bound_ms"], row["bwd_bound_by"] = bound(bb, bf, dt_name)
        log("kernel_check " + json.dumps(row))
        if shape_name == "flagship" and dt_name == "bfloat16":
            if forced:   # the earlier kernel, for the record only
                continue
            for name, d, err in (("lstm_cell_fwd", "fwd", err_f),
                                 ("lstm_cell_bwd", "bwd", err_b)):
                entries[name] = dict(
                    max_abs_err=err, ms=row[f"{d}_ms"],
                    plain_ms=row[f"{d}_plain_ms"],
                    bound_ms=row[f"{d}_bound_ms"],
                    bound_by=row[f"{d}_bound_by"])
    return entries


def tune_kernels():
    """Times of the tensor-core kernels at the flagship bf16 shape for other
    grids (blocks per agent) than the wrapper's default."""
    import torch
    from deeprl_network_tpu_torch.ops import lstm_cell as lc
    fwd_args, bwd_args = cell_args(FLAGSHIP, torch.bfloat16)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for splits in (4, 5, 6, 8, 10):
        fwd = lambda: lc.lstm_cell_fwd(*fwd_args, _splits=splits)
        log("tune " + json.dumps(dict(
            kernel="lstm_cell_fwd", splits=splits,
            ms=graph_ms(fwd), cold_ms=graph_ms(fwd, flush=flush))))
        bwd = lambda: lc.lstm_cell_bwd(*bwd_args, _splits=splits)
        log("tune " + json.dumps(dict(
            kernel="lstm_cell_bwd", splits=splits,
            ms=graph_ms(bwd), cold_ms=graph_ms(bwd, flush=flush))))
    # the backward's two passes apart, at the wrapper's default grid
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            lc.lstm_cell_fwd(*fwd_args)
            lc.lstm_cell_bwd(*bwd_args)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "lstm" in ev.key:
            log(f"tune profile: {ev.self_device_time_total / ev.count / 1e3:.5f}"
                f" ms/launch over {ev.count} launches of {ev.key[:60]}")


def make_flagship(device, env_kw=None, **overrides):
    """The flagship configuration through make_a2c; ``overrides`` replace
    ModelConfig fields, ``env_kw`` adds EnvConfig fields."""
    from deeprl_network_tpu_torch.config import (
        EnvConfig, ModelConfig, TrainConfig,
    )
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.utils.rollout import make_a2c
    model = dict(batch_size=120, num_envs=768, compute_dtype="bfloat16",
                 sparse_comm=True, remat=True)
    model.update(overrides)
    env = LargeGridEnv(EnvConfig(scenario="large_grid", coop_gamma=0.9,
                                 **(env_kw or {})), device=device)
    return make_a2c(env, ModelConfig(**model),
                    TrainConfig(total_step=1_000_000), agent="ma2c_nc",
                    device=device)


def check_reference():
    """A small f32 train step on the card against the CPU port (twins),
    same params and noise, two updates across an episode end."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    small = dict(env_kw=dict(episode_length_sec=60), batch_size=8,
                 num_envs=4, num_fc=16, num_lstm=16, compute_dtype="float32")
    cpu = make_flagship("cpu", **small)
    gpu = make_flagship("cuda", **small)
    ts_c = cpu.init_state(0)
    ts_g = gpu.init_state(0, params=ts_c.params)
    rng = np.random.default_rng(1)
    worst = 0.0
    for _ in range(2):
        u = rng.random((8, 4, 25, 5)).astype(np.float32)
        g = torch.tensor(-np.log(-np.log(np.maximum(u, 1e-30))))
        ts_c, m_c = cpu.train_step(ts_c, gumbel=g)
        ts_g, m_g = gpu.train_step(ts_g, gumbel=g)
        for k in ("loss", "grad_norm", "value_loss", "entropy"):
            a, b = float(m_g[k]), float(m_c[k])
            if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
                raise AssertionError(f"reference: {k} {a} on the card vs "
                                     f"{b} on the CPU")
        for a, b in zip(tree_leaves(ts_g.params), tree_leaves(ts_c.params)):
            d = float((a.cpu() - b).abs().max())
            if d > 1e-5:
                raise AssertionError(f"reference: params differ by {d}")
            worst = max(worst, d)
    log(f"reference: 2 f32 updates on the card match the CPU port "
        f"(max param diff {worst:.2e}, loss {float(m_g['loss']):.6f})")


def run_main_path(card: str, n_timed: int = 5):
    """Flagship train steps through make_a2c; returns (launch counts,
    env-steps/s)."""
    import torch
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    from deeprl_network_tpu_torch.ops import lstm_cell as lc
    fns = make_flagship("cuda")
    T, B = 120, 768
    ts = fns.init_state(0)
    torch.cuda.reset_peak_memory_stats()
    p0 = [p.clone() for p in tree_leaves(ts.params)]
    for k in lc.LAUNCHES:
        lc.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    ts, m = fns.train_step(ts)          # warm-up
    torch.cuda.synchronize()
    log(f"main path: warm-up train_step {time.perf_counter() - t0:.2f} s, "
        f"loss {float(m['loss']):.6f}")
    step_times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        ts, m = fns.train_step(ts)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
    dt = sum(step_times)
    launches = dict(lc.LAUNCHES)
    n_steps = n_timed + 1
    # every launch of the flagship step takes the tensor-core variant
    want = {k: 0 for k in lc.LAUNCHES}
    for k in ("lstm_cell_fwd", "lstm_cell_fwd_tc"):
        want[k] = (2 * T + 1) * n_steps
    for k in ("lstm_cell_bwd", "lstm_cell_bwd_tc"):
        want[k] = T * n_steps
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    for k in ("loss", "grad_norm"):
        if not torch.isfinite(torch.as_tensor(m[k])).all():
            raise AssertionError(f"main path: {k} is not finite")
    leaves = tree_leaves(ts.params)
    if any(p.dtype != torch.float32 for p in leaves):
        raise AssertionError("main path: master params are not f32")
    if all(torch.equal(a, b) for a, b in zip(leaves, p0)):
        raise AssertionError("main path: params did not change")
    sps = n_timed * T * B / dt
    log("main path: " + json.dumps({
        k: (float(v) if torch.is_tensor(v) else v) for k, v in m.items()}))
    log(f"main path: {n_timed} timed train_steps in {dt:.3f} s = "
        f"{sps:.1f} env-steps/s (B={B}, T={T}, bf16, sparse_comm, remat) "
        f"on {card}; per step {json.dumps([round(t, 4) for t in step_times])} s; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, sps, fns, ts


def profile_step(fns, ts, step_s: float):
    """Device busy share and kernel time by name over one train_step under
    torch.profiler; ``step_s`` is the unprofiled step time for the share
    without the profiler's own host cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fns.train_step(ts)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.key_averages():
        # kernel events only: op events also carry their kernels' time
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            dev.append((ev.self_device_time_total, ev.count, ev.key))
        elif ev.self_cpu_time_total > 0:
            host.append((ev.self_cpu_time_total, ev.count, ev.key))
    dev.sort(reverse=True)
    host.sort(reverse=True)
    total = sum(d for d, _, _ in dev) / 1e6
    n_kernels = sum(c for _, c, _ in dev)
    log(f"profile: one train_step, {n_kernels} kernels, kernel time "
        f"{total:.4f} s; wall under the profiler {wall:.3f} s (busy share "
        f"{total / wall:.4f}); unprofiled step {step_s:.3f} s (busy share "
        f"{total / step_s:.4f})")
    for d, c, k in dev[:20]:
        log(f"profile device: {d / 1e3:10.3f} ms {d / 1e6 / total:7.2%} "
            f"{c:7d} x {k[:100]}")
    # cross-check of the kernels phase's graph-replay times: the cell's
    # kernels as the step ran them (inputs fresh from the embed ops)
    for d, c, k in dev:
        if "lstm" in k:
            log(f"profile cell kernel: {d / c / 1e3:.5f} ms/launch over "
                f"{c} launches of {k[:60]}")
    for d, c, k in host[:12]:
        log(f"profile host:   {d / 1e3:10.3f} ms {c:7d} x {k[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one flagship train_step")
    ap.add_argument("--tune", action="store_true",
                    help="also time the tensor-core kernels on other grids")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernels phase, with exit code 2 "
                         "and no result line (a short first run of a new "
                         "kernel)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeprl_network_tpu_torch.ops import _build, lstm_cell as lc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    times = _build.build(verbose=True)
    log(f"build: {json.dumps(times)} ({time.perf_counter() - t0:.1f} s "
        f"wall, nvcc per source in parallel)")

    entries = check_kernels()
    if args.tune:
        tune_kernels()
    if args.kernels_only:
        return 2
    check_reference()
    launches, sps, fns, ts = run_main_path(card)
    step_s = 120 * 768 / sps
    if args.profile:
        profile_step(fns, ts, step_s)

    src = "deeprl_network_tpu_torch/ops/csrc/lstm_cell_tc.cu"
    replaces = {"lstm_cell_fwd": "deeprl_network_tpu/ops/pallas_lstm.py:108",
                "lstm_cell_bwd": "deeprl_network_tpu/ops/pallas_lstm.py:233"}
    kernels = [dict(name=name, route="cuda", source=src,
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=e["max_abs_err"], ms=e["ms"],
                    plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                    bound_by=e["bound_by"], library_ms=None)
               for name, e in entries.items()]
    log(f"total: {time.perf_counter() - t_start:.1f} s; "
        f"throughput {sps:.1f} env-steps/s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
