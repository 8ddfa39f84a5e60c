#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``deeprl_network_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python chip_smoke.py

Phases (any failure raises, exits non-zero and prints no result line):
  1. device: require a CUDA card; print its name and power limit;
  2. build: compile every CUDA kernel from ``deeprl_network_tpu_torch/ops/csrc``
     with nvcc (one process per source, all started together);
  3. kernels: hold each kernel against its plain PyTorch twin on the card at
     the main path's shape (B=768, N=25, F=H=64) in f32 and bf16, at the
     CACC platoon's shape (B=32, N=8), at B=1 (eval and record), at the
     Monaco shapes (N=28: B=32 and B=1 in f32, B=768 in bf16), at the
     acceptance bars' train shapes (B=64 with N=8 and N=9, f32), at ragged
     shapes, at widths that take the general kernels (odd widths; cells
     wider than 256: F=64 H=256 in f32 and bf16, F=128 H=1024 in f32),
     forward and backward, the backward bitwise equal across two calls;
     time them at the main path's, the platoon's, the B=1, the Monaco, the
     acceptance and the wide f32 shapes from replays of a CUDA graph of 20
     launches (``ms``: inputs warm in L2; ``cold_ms``: L2 flushed before every
     launch; ``call_ms``: the host's time per call), the general kernels in
     bf16 beside the tensor-core ones, and at each f32 shape the per-agent
     products alone through ``torch.bmm`` (``*_product_ms``);
  4. env kernel: the ATSC env step (``ops/csrc/network_env.cu``) against its
     plain twin on the card in lockstep (every step from the kernel's state,
     the same actions and reset draws) at 1e-5: the 5x5 grid at B=768 over
     one episode and a reset, the 3x3 grid at B=64, Monaco-28 at B=32 (an
     episode and a reset) and B=768, B=1 unwrapped, the queue and phase obs
     channels with the hybrid reward, ``init_density > 0``, a rank's 384
     rows of 768, and the 10x10 grid at B=128; the twin's free run printed
     beside it; times of the grid and Monaco at B=768, 32 and 1 and of the
     10x10 grid at B=128 from graph replays (warm and cold), the host's time
     a call and the twin's, and the bound, each with its launch shape,
     registers a thread and blocks an SM; then the CACC platoon's step with
     auto-reset (``ops/csrc/cacc_env.cu``) against its plain twin in
     lockstep over 1,500 steps (the horizon and collisions crossed), every
     output bit for bit but info's two means (within 2 ulp): catch-up at
     the platoon cell's B=64, slow-down at the files' B=32 and at B=512; its
     times at B=64 and 32 beside the twin's, the generic ``AutoResetEnv``
     path's it replaced and ``step_autoreset``'s (both with the draws), the
     kernels each of those two runs a step, and the bound;
  5. comm embed: the NeurComm embedding over packed neighbour lists
     (``ops/csrc/comm_embed.cu``) against its plain twin, forward and
     backward, the backward bitwise equal across two calls, launch counts
     asserted: the flagship (B=768, bf16, ``tc``), Monaco-28 at B=768, a
     ragged B=100, B=1 and widths 8 in f32 (``general``) and the flagship in
     f32; DIAL's call (no fingerprint term, its messages unmasked) at the
     flagship and at B=1 in f32, under DIAL's launch keys; times at the
     flagship, Monaco-28, B=1 and DIAL's two (warm, cold, the host's call,
     the twin, the PyTorch ops it replaced, the bound and its share); DIAL's
     message head (``ops/csrc/dial_head.cu``) against its twin the same way
     at DIAL's flagship (B=768, bf16, ``tc``) and at B=1 in f32
     (``general``), timed beside the ops it replaced (the mask, the einsum,
     the bias add and the messages' copy), with its source's nvcc time; from
     here on every phase that runs MA2C_NC or MA2C_DIAL over packed lists
     asserts its launches beside the cell's: one forward and one backward
     each, and as many of the head's for MA2C_DIAL;
  6. reference: a small f32 train step on the card against the same step on
     the CPU (plain twins, held against the JAX package by the CPU tests),
     and the same at num_fc=64, num_lstm=256 (a cell wider than 256);
  7. main path: the flagship MA2C_NC train step on the 5x5 grid at full
     width (B=768 envs, T=120, bf16 with f32 masters, sparse_comm, remat)
     through ``make_a2c``: a warm-up step (the capture of the update's CUDA
     graph) and 3 timed steps (its replays) under the profiler's kernel
     trace, with the counts set to 0 before and read after: the wrappers'
     counts (launches issued or captured: the capture's warm-up and the
     capture, two updates' worth) and the kernels that ran on the card, by
     name (the warm-up and four replays, five updates' worth), each
     asserted (from here on every phase asserts the env kernels' launches
     beside the cell's: one a control step of an ATSC env, T an update, and
     one a step of the platoon's update);
  8. graph: ``make_a2c``'s ``jit`` (the default), each update one replay of a
     CUDA graph: from one ``init_state(0)`` cloned both ways, 3 updates
     through the graph against 3 eager ones (``jit=False``), every state
     leaf, the generator and every metric bit for bit; the wrappers count
     two updates' worth under the graph and the card runs one update's
     worth more than eagerly (the warm-up): the flagship, the f32 3x3 grid
     with kickstart, switch penalty and moving schedules (``ladder_atsc``'s
     ``pq_kick_sp2``), the replay path (f32, B=64), and each of the six
     families at a small f32 width on both gradient paths. Every other
     phase runs the graph: the wrappers count its warm-up and capture, and
     the phases that time updates (main path, families, cacc, monaco) also
     count the kernels on the card;
  9. bench: the throughput tools' twin ``deeprl_network_tpu_torch/bench.py``
     (the baseline host loop, and the flagship over a 15 s window after one
     warm-up update: the JSON line with the prefix ``bench:``; the window
     runs untraced, and the wrappers' counts are asserted, 2 x (241 + 120)
     ``tc`` and 2 x 120 env steps: the warm-up's capture);
 10. families: the same step for each of the six agents (a warm-up and 2
     timed steps each), the wrappers' counts and the kernels on the card
     asserted; for IA2C_CU also that the weight consensus ran;
 11. replay: a small f32 MA2C_NC update with ``fused_grad=False`` against
     the fused update from the same state and noise, launch counts asserted;
 12. cacc: the CACC platoon from ``configs/config_ma2c_nc_cacc_catchup.ini``
     and ``configs/config_ia2c_cu_cacc_slowdown.ini`` at the files' own
     sizes (3 train steps each, launch counts asserted), and two small f32
     updates on the card against the CPU port;
 13. eval/record: ``eval_episode`` (sampled, greedy) and ``record_episode``
     (greedy, controller) on the grid and on the platoon with the params
     trained above, on the card against the same calls on the CPU with the
     same noise, and one whole sampled episode each on the card;
 14. monaco: Monaco-28 MA2C_NC from ``configs/config_ma2c_nc_net.ini``: two
     small f32 updates on the card against the CPU port; the file's own step
     (N=28, B=32, T=120, 64/64, f32: a warm-up and 3 timed steps, launch
     counts asserted, every sampled action inside its node's action count);
     the same env at the flagship's settings (B=768, bf16, sparse_comm,
     remat: a warm-up and 2 timed steps);
 15. cli: in a temporary directory, the port's CLI on a copy of that file
     with ``total_step`` cut to 5 updates: ``train`` with ``in_train_test``
     (log rows with each span's mean, a test row, the config snapshot,
     checkpoints), ``train
     --restore`` with a doubled budget, ``evaluate`` from the checkpoint and
     ``evaluate --naive``, launch counts asserted around each; then a
     ``Trainer`` run with the time inside and outside ``train_step`` read
     apart, the restored params held bit-equal to the trainer's final ones,
     and the checkpoint's size, save and restore times;
 16. scripts: the learning and evaluation harnesses
     (``deeprl_network_tpu_torch/scripts/``): ``train_atsc.greedy_returns``
     on the 5x5 grid, every form of the hand-controller sweep on seeds
     10000-10002 at 720 steps, each form within 1e-5 of the CPU port over
     120 steps and ``hyst_queue_d3`` within 1e-4 of the JAX row
     (-140,360.48); ``train_cacc_families`` (MA2C_DIAL, slow-down) and
     ``train_atsc`` (3x3 grid, ``--ckpt``) for 2 updates at B=8 with their
     final evals, launch counts asserted, every row's keys those of the JAX
     repo's ``scripts/``, the checkpoint restored;
 17. agents: the reference-style host loop with the compat ``MA2C_NC`` class
     on the platoon for two ``n_step = 10`` batches, launch counts asserted
     per call;
 18. surface: the JAX package's re-exported names from the port's
     packages; the single-env ``policy_step`` at the flagship width
     (grid-25, 64/64, f32) on the card, one launch, bit-equal to
     ``policy_step_batched`` at B=1 and within 1e-5 of the CPU port;
     ``graft_entry.entry()`` once;
 19. parallel: data-parallel training through ``make_parallel_a2c`` in
     worker processes (``parallel/smoke_worker.py``): the NCCL path at world
     size 1 on the flagship (B=768); two gloo ranks sharing the card, (a) a
     small f32 MA2C_NC platoon update against one process on the combined
     batch (actions and obs exact, params within 1e-4) and (b) the flagship
     at a global B=768, 384 a rank (launch counts, step, finite loss and
     params bit-identical across ranks asserted); env-steps/s of 1 and 2
     ranks, the gradient all-reduce's bytes and time; ``dryrun_multichip(2)``.

Output: a kernels JSON line and the card's name and power limit on lines
before the last; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import configparser
import contextlib
import csv
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from benchmark.trace import events, traced

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FLAGSHIP = dict(B=768, N=25, F=64, H=64)
CACC = dict(B=32, N=8, F=64, H=64)          # the platoon configs' own size
EVAL_B1 = dict(B=1, N=25, F=64, H=64)       # eval and record on the grid
# Monaco-28: the .ini's own train step, eval/record, the flagship settings
MONACO = dict(B=32, N=28, F=64, H=64)
MONACO_B1 = dict(B=1, N=28, F=64, H=64)
MONACO_768 = dict(B=768, N=28, F=64, H=64)
# cells wider than the general kernels' old cap of F + H <= 256
WIDE = dict(B=37, N=3, F=64, H=256)
WIDE_1024 = dict(B=5, N=2, F=128, H=1024)
# the acceptance bars' train steps (tests/test_torch_acceptance.py): the
# platoon and the 3x3 grid at B=64, f32
ACCEPT_CACC = dict(B=64, N=8, F=64, H=64)
ACCEPT_GRID3 = dict(B=64, N=9, F=64, H=64)
TIMED_SHAPES = ("flagship", "cacc", "eval_b1", "monaco", "monaco_b1",
                "monaco_768", "wide", "accept_cacc", "accept_grid3")
MONACO_INI = "configs/config_ma2c_nc_net.ini"
AGENTS = ("ia2c", "ia2c_fp", "ia2c_cu", "ma2c_nc", "ma2c_cnet", "ma2c_dial")
CACC_CONFIGS = ("configs/config_ma2c_nc_cacc_catchup.ini",
                "configs/config_ia2c_cu_cacc_slowdown.ini")
RAGGED = dict(B=12, N=3, F=16, H=16)
RAGGED_WIDE = dict(B=37, N=5, F=32, H=48)
RAGGED_FULL = dict(B=100, N=25, F=64, H=64)
ODD_WIDTH = dict(B=37, N=5, F=24, H=40)     # takes the general kernel
ODD_PIECES = dict(B=9, N=2, F=5, H=7)       # rows of no whole 16-byte pieces
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


def product_ms(shape, fwd_args, bwd_args):
    """A reference reading beside the f32 cell kernels: the per-agent
    products alone through ``torch.bmm`` in f32 (TF32 off), the forward's
    two (x wx, h_in wh) and the backward's four (gz wx^T, gz wh^T, x^T gz,
    h_in^T gz), on operands laid out for bmm beforehand. Not a library call
    of the cell (no single call computes it)."""
    import torch
    wx, wh = fwd_args[0], fwd_args[1]
    x, h_in = (t.transpose(0, 1).contiguous() for t in (bwd_args[3],
                                                         bwd_args[4]))
    gz = torch.randn(shape["N"], shape["B"], 4 * shape["H"],
                     device="cuda", dtype=x.dtype)
    xT, hT, wxT, whT = (t.transpose(1, 2).contiguous()
                        for t in (x, h_in, wx, wh))
    fwd = lambda: (torch.bmm(x, wx), torch.bmm(h_in, wh))
    bwd = lambda: (torch.bmm(gz, wxT), torch.bmm(gz, whT), torch.bmm(xT, gz),
                   torch.bmm(hT, gz))
    return dict(fwd_product_ms=graph_ms(fwd), bwd_product_ms=graph_ms(bwd))


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
             ("cacc", CACC, "float32", None),
             ("cacc", CACC, "bfloat16", None),
             ("eval_b1", EVAL_B1, "float32", None),
             ("eval_b1", EVAL_B1, "bfloat16", None),
             ("monaco", MONACO, "float32", None),
             ("monaco_b1", MONACO_B1, "float32", None),
             ("monaco_768", MONACO_768, "bfloat16", None),
             ("accept_cacc", ACCEPT_CACC, "float32", None),
             ("accept_grid3", ACCEPT_GRID3, "float32", None),
             ("ragged", RAGGED, "float32", None),
             ("ragged", RAGGED, "bfloat16", None),
             ("ragged_wide", RAGGED_WIDE, "bfloat16", None),
             ("ragged_full", RAGGED_FULL, "bfloat16", None),
             ("odd_width", ODD_WIDTH, "bfloat16", None),
             ("odd_pieces", ODD_PIECES, "float32", None),
             ("wide", WIDE, "float32", None),
             ("wide", WIDE, "bfloat16", None),
             ("wide_1024", WIDE_1024, "float32", None)]
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
        if shape_name in TIMED_SHAPES:
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
            if dt_name == "float32":
                row.update(product_ms(shape, fwd_args, bwd_args))
            (fb, ff), (bb, bf) = cell_bytes_flops(**shape, dtype=dt)
            row["fwd_bound_ms"], row["fwd_bound_by"] = bound(fb, ff, dt_name)
            row["bwd_bound_ms"], row["bwd_bound_by"] = bound(bb, bf, dt_name)
        log("kernel_check " + json.dumps(row))
        # the result line's entries: the tensor-core kernels at the flagship
        # shape, the general kernels at the platoon's shape (both as their
        # main paths run them); a forced variant is for the record only
        suffix = {("flagship", "bfloat16"): "",
                  ("cacc", "float32"): "_general"}.get((shape_name, dt_name))
        if suffix is not None and not forced:
            for name, d, err in (("lstm_cell_fwd", "fwd", err_f),
                                 ("lstm_cell_bwd", "bwd", err_b)):
                entries[name + suffix] = dict(
                    max_abs_err=err, ms=row[f"{d}_ms"],
                    plain_ms=row[f"{d}_plain_ms"],
                    bound_ms=row[f"{d}_bound_ms"],
                    bound_by=row[f"{d}_bound_by"])
    return entries


def tune_kernels():
    """Times of the tensor-core kernels at the flagship bf16 shape for other
    grids (blocks per agent) than the wrapper's default; every cell kernel's
    time by name under torch.profiler."""
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
    # the backward's passes apart, at the wrapper's default grid: the
    # tensor-core kernels at the flagship shape, the general ones at the f32
    # shapes of their paths
    from torch.profiler import ProfilerActivity, profile
    for name, shape, dt in (("flagship", FLAGSHIP, torch.bfloat16),
                            ("flagship", FLAGSHIP, torch.float32),
                            ("monaco", MONACO, torch.float32),
                            ("cacc", CACC, torch.float32),
                            ("eval_b1", EVAL_B1, torch.float32),
                            ("wide", WIDE, torch.float32)):
        fwd_args, bwd_args = cell_args(shape, dt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                lc.lstm_cell_fwd(*fwd_args)
                lc.lstm_cell_bwd(*bwd_args)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "lstm" in ev.key:
                log(f"tune profile {name} {dt}: "
                    f"{ev.self_device_time_total / ev.count / 1e3:.5f} "
                    f"ms/launch over {ev.count} launches of {ev.key[:70]}")


ENV_SOURCE = "deeprl_network_tpu_torch/ops/csrc/network_env.cu"
ENV_REPLACES = "deeprl_network_tpu/envs/network.py:216"
CACC_ENV_SOURCE = "deeprl_network_tpu_torch/ops/csrc/cacc_env.cu"
CACC_ENV_REPLACES = ("none: XLA fuses deeprl_network_tpu/envs/cacc.py "
                     "CACCEnv.step and the auto-reset's select")
# the platoon env kernel's lockstep cases (scenario, v_target, B): the
# platoon cell's catch-up at B = 64, the files' slow-down at B = 32, and
# B = 512; its timed B: the cell's and the files'
CACC_ENV_CASES = (("catchup", "profile", 64), ("slowdown", "profile", 32),
                  ("slowdown", "fixed", 512))
CACC_ENV_TIMED = (64, 32)
# the env kernel phase's lockstep cases: (name, topology, EnvConfig fields,
# B, control steps, auto-reset, a rank's rows (offset, total) or None)
ENV_CASES = (
    ("grid25 b768", "grid5", {}, 768, 725, True, None),
    ("grid9 b64", "grid3", {}, 64, 150, True, None),
    ("monaco b32", "monaco", {}, 32, 725, True, None),
    ("monaco b768", "monaco", {}, 768, 60, True, None),
    ("grid25 b1 unwrapped", "grid5", {}, 1, 200, False, None),
    ("grid25 obs channels hybrid", "grid5", dict(
        queue_in_obs=True, phase_in_obs=True, objective="hybrid",
        episode_length_sec=200), 64, 90, True, None),
    ("grid25 init_density", "grid5", dict(
        init_density=0.5, episode_length_sec=200), 64, 90, True, None),
    ("grid25 rank rows 384 of 768", "grid5", dict(
        init_density=0.5, episode_length_sec=200), 384, 90, True, (384, 768)),
    ("grid100 b128", "grid10", {}, 128, 725, True, None),
)
# the env kernel's timed shapes: the grid and Monaco at B = 768 (the
# flagship's rollout), 32 (the .ini files) and 1 (eval and record,
# unwrapped); the 10x10 grid (two lanes a thread, 608 threads, more than
# 48 KB of shared memory) at B = 128
ENV_TIMED = (("grid25", "grid5", (768, 32, 1)),
             ("monaco", "monaco", (768, 32, 1)),
             ("grid100", "grid10", (128,)))


def make_env(topology, env_kw, device="cuda"):
    """The ATSC env of an env-kernel case: the 3x3 or 5x5 grid, or
    Monaco-28 with the ``.ini`` file's env settings; ``env_kw`` replaces
    EnvConfig fields."""
    import dataclasses
    from deeprl_network_tpu_torch.config import EnvConfig, load_config
    from deeprl_network_tpu_torch.envs.grid import build_grid_topology
    from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
    from deeprl_network_tpu_torch.envs.network import TrafficNetworkEnv
    if topology == "monaco":
        root = os.path.dirname(os.path.abspath(__file__))
        cfg = load_config(os.path.join(root, MONACO_INI)).env
        return RealNetEnv(dataclasses.replace(cfg, **env_kw), device=device)
    cfg = EnvConfig(scenario="large_grid", coop_gamma=0.9, **env_kw)
    return TrafficNetworkEnv(cfg, build_grid_topology(cfg, int(topology[4:])),
                             device=device)


def env_outputs(out):
    """The tensors of one env step, in ``ENV_NAMES`` order."""
    from deeprl_network_tpu_torch.ops.network_env import INFO_KEYS
    state, obs, reward, done, info = out
    return list(state) + [obs, reward, done] + [info[k] for k in INFO_KEYS]


ENV_NAMES = ",".join(("queue", "transit", "wait", "prev_phase", "t",
                      "done_state", "dropped", "obs", "reward", "done",
                      "avg_queue", "avg_wait", "throughput", "arrived",
                      "entered", "info_dropped"))


def env_bytes_flops(env, B, auto_reset, q0, t):
    """Bytes the env step must move for B rows at clocks ``t`` (each input
    read once: the state but ``done``, the actions, the demand rows of the
    distinct clocks, the static tables, ``q0``; each output written once:
    the state, obs, reward, done and info) and its operations (per lane a
    substep: two transit sums of D adds, about 25 more, and a multiply-add
    per route nonzero twice)."""
    T = env.tables
    L, M, D, W = T.L, T.M, T.D, T.W
    state = B * (4 * L * (D + 2) + 8 * M + 8 + 1 + 4)
    rows = len(set(t.tolist()))
    tables = 4 * (T.ints.numel() + T.floats.numel() - T.demand.numel())
    nbytes = (state - B + 8 * B * M + 4 * rows * L + tables
              + (4 * B * L if q0 is not None else 0)
              + state + B + 4 * B * (M * W + M + 6))
    flops = B * (env.scalars.control_interval_sec
                 * (L * (2 * D + 25) + 4 * int((T.pair_row_val != 0).sum()))
                 + 2 * M * W)
    return nbytes, flops


def check_env_kernel(card):
    """The env kernel against its plain twin on the card, in lockstep (each
    step from the kernel's state, the same actions and reset draws) at 1e-5
    in every ``ENV_CASES`` case, with the twin's free run beside it; then
    its times at ``ENV_TIMED``. Returns the kernels line's entry."""
    import torch
    from deeprl_network_tpu_torch.ops import network_env as ne
    t_phase = time.perf_counter()
    worst = 0.0
    for name, topology, env_kw, B, steps, auto, rows in ENV_CASES:
        env = make_env(topology, env_kw)
        T, c, M = env.tables, env.scalars, env.topo.n_node
        off, total = rows or (0, None)
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, _ = env.reset(B, gen, off, total)
        free = state
        # every phase index the policy can emit, and one past it (clamped)
        n_a = env.spec.n_a_max + 1
        case_worst = free_worst = 0.0
        n_done = 0
        for t in range(steps):
            a = torch.randint(0, n_a, (B, M), device="cuda", generator=gen)
            q0 = env._reset_queue(B, gen, off, total) if auto else None
            got = ne.network_env_step(T, c, state, a, q0, auto)
            want = ne.network_env_step_ref(T, c, state, a, q0, auto)
            case_worst = max(case_worst, max_err(
                env_outputs(got), env_outputs(want), 1e-5, ENV_NAMES))
            free_out = ne.network_env_step_ref(T, c, free, a, q0, auto)
            free_worst = max(free_worst, max(
                float((x.float() - y.float()).abs().max())
                for x, y in zip(env_outputs(got), env_outputs(free_out))))
            n_done += int(got[3].sum())
            state, free = got[0], free_out[0]
        if steps > env.episode_steps and n_done < B:
            raise AssertionError(f"env kernel {name}: {n_done} rows done "
                                 f"in {steps} steps")
        worst = max(worst, case_worst)
        log("env_kernel_check " + json.dumps({
            "case": name, "B": B, "steps": steps, "auto_reset": auto,
            "rows": rows, "env": env_kw, "rows_done": n_done,
            "lockstep_max_abs_err": case_worst,
            "free_run_max_abs_diff": free_worst}))
        del env, state, free, got, want, free_out
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    entry = None
    for name, topology, batches in ENV_TIMED:
        env = make_env(topology, {})
        T, c, M = env.tables, env.scalars, env.topo.n_node
        shape = ne.occupancy(T, c)
        for B in batches:
            auto = B > 1
            gen = torch.Generator(device="cuda").manual_seed(1)
            state, _ = env.reset(B, gen)
            acts = torch.randint(0, env.spec.n_a_max, (31, B, M),
                                 device="cuda", generator=gen)
            for t in range(30):       # a state with traffic in it
                state = ne.network_env_step(T, c, state, acts[t], None,
                                            auto)[0]
            a = acts[30]
            fn = lambda: ne.network_env_step(T, c, state, a, None, auto)
            plain = lambda: ne.network_env_step_ref(T, c, state, a, None,
                                                    auto)
            nbytes, flops = env_bytes_flops(env, B, auto, None, state.t)
            bound_ms, bound_by = bound(nbytes, flops, "float32")
            row = {"shape": f"{name} b{B}", "auto_reset": auto,
                   "ms": graph_ms(fn), "cold_ms": graph_ms(fn, flush=flush),
                   "call_ms": host_call_ms(fn),
                   "plain_ms": graph_ms(plain, n=5),
                   "plain_call_ms": host_call_ms(plain, n=20),
                   "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
                   "bound_by": bound_by, **shape, "card": card}
            log("env_kernel_time " + json.dumps(row))
            if (name, B) == ("grid25", 768):
                entry = dict(max_abs_err=worst, ms=row["ms"],
                             plain_ms=row["plain_ms"], bound_ms=bound_ms,
                             bound_by=bound_by)
        del env
    log(f"env kernel: phase {time.perf_counter() - t_phase:.1f} s")
    return entry


def cacc_env_bytes(B, n, draws):
    """Bytes one auto-reset platoon step must move for B platoons of n
    vehicles with ``draws`` uniforms a vehicle: h, v, the actions, t,
    v_lead and the uniforms read once; the state (h, v, u, v_lead, t, done),
    obs, reward, done, collision and info's two means written once."""
    read = B * (n * (4 + 4 + 8 + 4 * draws) + 8 + 4)
    write = B * (n * (3 * 4 + 4 * 4 + 4) + 4 + 8 + 3 * 1 + 2 * 4)
    return read + write


def same_bits(got, want, what, ulp_keys=()):
    """Raise unless the tensors of two steps agree bit for bit (``ulp_keys``
    within 2 ulp); ``got`` and ``want`` are lists of (name, tensor). Returns
    the largest absolute difference over every tensor (0 where the bits
    agree, NaN included)."""
    import torch
    worst = 0.0
    for (name, a), (_, b) in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{what} {name}: {a.dtype} {tuple(a.shape)}"
                                 f" against {b.dtype} {tuple(b.shape)}")
        if not a.numel():
            continue
        ia, ib = a, b
        if a.dtype == torch.float32:
            ia, ib = a.view(torch.int32), b.view(torch.int32)
        ulp = int((ia.long() - ib.long()).abs().max())
        if ulp > (2 if name in ulp_keys else 0):
            raise AssertionError(f"{what} {name}: {ulp} apart")
        if ulp:
            diff = (a.double() - b.double()).abs()
            worst = max(worst, float(torch.where(ia == ib, 0.0, diff).max()))
    return worst


def cacc_outputs(out):
    """(name, tensor) of one platoon step with auto-reset."""
    from deeprl_network_tpu_torch.ops.cacc_env import INFO_KEYS
    state, obs, reward, done, info = out
    return (list(zip(state._fields, state))
            + [("obs", obs), ("reward", reward), ("done", done)]
            + [(k, info[k]) for k in INFO_KEYS])


def check_cacc_env_kernel(card):
    """The platoon's env kernel against its plain twin on the card, in
    lockstep (each step from the kernel's state, the same actions and
    uniforms; every third platoon takes no control, which runs it into its
    predecessor on the slow-down ramp) over 1,500 steps at a horizon of 200
    in every ``CACC_ENV_CASES`` case: every output bit for bit, info's two
    means (logged, in no loss) within 2 ulp; the entry's ``max_abs_err`` is
    the largest difference of the platoon cell's case (catch-up, B=64),
    means included. Then its times at
    ``CACC_ENV_TIMED`` on the cell's configuration: the kernel (warm, cold,
    the host's call), the twin, ``step_autoreset`` (the draws and the
    launch) and the generic ``AutoResetEnv`` path it replaced (draws, step,
    reset, selects), each with the kernels it runs a step. Returns the
    kernels line's entry."""
    import torch
    from deeprl_network_tpu_torch.config import EnvConfig
    from deeprl_network_tpu_torch.envs.cacc import CACCEnv
    from deeprl_network_tpu_torch.envs.wrappers import AutoResetEnv
    from deeprl_network_tpu_torch.ops import cacc_env as ce
    t_phase = time.perf_counter()
    means = ("headway_err", "velocity_err")
    errs = {}
    for scenario, v_target, B in CACC_ENV_CASES:
        env = CACCEnv(EnvConfig(scenario=f"cacc_{scenario}",
                                v_target=v_target, episode_length=200),
                      device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(B)
        state, _ = env.reset(B, gen)
        reckless = (torch.arange(B, device="cuda") % 3 == 0)[:, None]
        n_done = n_collided = 0
        err = 0.0
        for t in range(1500):
            a = torch.randint(0, 4, (B, 8), device="cuda", generator=gen)
            a = torch.where(reckless, torch.zeros_like(a), a)
            u_h, u_v = (torch.rand((B, 8), device="cuda", generator=gen)
                        for _ in range(2))
            got = ce.cacc_env_step(env.kernel_args, state, a, u_h, u_v)
            want = env.step_autoreset_ref(state, a, u_h, u_v)
            err = max(err, same_bits(
                cacc_outputs(got), cacc_outputs(want),
                f"cacc env kernel {scenario} {v_target} b{B} step {t}",
                means))
            n_done += int(got[3].sum())
            n_collided += int(got[4]["collision"].sum())
            state = got[0]
        if n_collided == 0 or n_done <= n_collided:
            raise AssertionError(f"cacc env kernel {scenario} b{B}: "
                                 f"{n_collided} collisions, {n_done} done")
        log("cacc_env_kernel_check " + json.dumps({
            "scenario": scenario, "v_target": v_target, "B": B,
            "steps": 1500, "rows_done": n_done, "collisions": n_collided,
            "bitwise_but_means": True, "max_abs_err": err}))
        errs[scenario, B] = err
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    entry = None
    env = CACCEnv(EnvConfig(scenario="cacc_catchup"), device="cuda")
    ops_env = CACCEnv(EnvConfig(scenario="cacc_catchup"), device="cuda")
    ops_env.step = CACCEnv.step.__get__(ops_env)      # the generic path
    fused, generic = AutoResetEnv(env), AutoResetEnv(ops_env)
    for B in CACC_ENV_TIMED:
        gen = torch.Generator(device="cuda").manual_seed(1)
        state, _ = env.reset(B, gen)
        for _ in range(30):       # platoons under way
            a = torch.randint(0, 4, (B, 8), device="cuda", generator=gen)
            state = fused.step(state, a, gen)[0]
        u_h, u_v = (torch.rand((B, 8), device="cuda", generator=gen)
                    for _ in range(2))
        kernel = lambda: ce.cacc_env_step(env.kernel_args, state, a, u_h,
                                          u_v)
        plain = lambda: env.step_autoreset_ref(state, a, u_h, u_v)
        new = lambda: fused.step(state, a)
        ops = lambda: generic.step(state, a)
        nbytes = cacc_env_bytes(B, 8, 2)
        bound_ms, bound_by = bound(nbytes, 0, "float32")
        row = {"shape": f"cacc b{B}", "ms": graph_ms(kernel),
               "cold_ms": graph_ms(kernel, flush=flush),
               "call_ms": host_call_ms(kernel),
               "plain_ms": graph_ms(plain, n=5),
               "plain_call_ms": host_call_ms(plain, n=20),
               "step_autoreset_ms": graph_ms(new),
               "step_autoreset_call_ms": host_call_ms(new),
               "ops_ms": graph_ms(ops, n=5),
               "ops_call_ms": host_call_ms(ops, n=20), "bytes": nbytes,
               "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
        log("cacc_env_kernel_time " + json.dumps(row))
        if B == 64:
            entry = dict(max_abs_err=errs["catchup", 64], ms=row["ms"],
                         plain_ms=row["plain_ms"], bound_ms=bound_ms,
                         bound_by=bound_by)
    # counted after the times: a trace slows later CUDA calls of the process
    nodes = {}
    for name, fn in (("step_autoreset", new), ("ops", ops)):
        fn()
        with traced() as prof:
            fn()
        nodes[name] = sum(e.device for e in events(prof))
    log("cacc_env_kernel_nodes " + json.dumps(
        {"kernels_copies_sets_a_step": nodes}))
    log(f"cacc env kernel: phase {time.perf_counter() - t_phase:.1f} s")
    return entry


EMBED_SOURCE = "deeprl_network_tpu_torch/ops/csrc/comm_embed.cu"
EMBED_REPLACES = ("none: XLA fuses deeprl_network_tpu/models/policies.py "
                  "_embed's einsums over the gathered neighbours")
# (name, network, B, dtype, n_fc = n_lstm = n_msg, agent): the flagship and
# the other paths that run MA2C_NC over packed neighbour lists, and DIAL's
# call at the flagship and at B=1
EMBED_CASES = (("flagship", "grid25", 768, "bfloat16", 64, "ma2c_nc"),
               ("monaco_768", "monaco28", 768, "bfloat16", 64, "ma2c_nc"),
               ("ragged", "grid25", 100, "bfloat16", 64, "ma2c_nc"),
               ("eval_b1", "grid25", 1, "float32", 64, "ma2c_nc"),
               ("graft_w8", "grid25", 1, "float32", 8, "ma2c_nc"),
               ("flagship_f32", "grid25", 768, "float32", 64, "ma2c_nc"),
               ("dial_flagship", "grid25", 768, "bfloat16", 64, "ma2c_dial"),
               ("dial_eval_b1", "grid25", 1, "float32", 64, "ma2c_dial"))
EMBED_TIMED = ("flagship", "monaco_768", "eval_b1", "dial_flagship",
               "dial_eval_b1")


def embed_args(network, B, dtype_name, width, seed=0, agent="ma2c_nc"):
    """(spec, forward args, backward args) of the comm embedding on the
    card: the network's packed params of ``agent`` at the init's scale,
    numpy-seeded inputs, a third of the rows done; the backward's e is the
    twin's and its cotangent a normal draw. DIAL's call takes its messages
    (the masked carry through the message head) and no fingerprints, done
    or W_fp."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
    from deeprl_network_tpu_torch.models.policies import (
        init_policy_params, mask_comm_params, policy_consts,
    )
    from deeprl_network_tpu_torch.ops import comm_embed as ce
    from deeprl_network_tpu_torch.utils.rollout import make_policy_spec
    env = (LargeGridEnv(EnvConfig(scenario="large_grid"), device="cpu")
           if network == "grid25" else RealNetEnv(EnvConfig(), device="cpu"))
    spec = make_policy_spec(env.spec, ModelConfig(
        num_fc=width, num_lstm=width, sparse_comm=True), agent)
    dt = getattr(torch, dtype_name)
    p = mask_comm_params(spec, init_policy_params(
        torch.Generator().manual_seed(seed), spec))
    consts = policy_consts(spec, "cuda")
    rng = np.random.default_rng(seed)
    n = spec.n_agent
    t = lambda *shape, scale=1.0: torch.tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32),
        device="cuda").to(dt)
    fp = torch.softmax(t(B, n, spec.n_a_max).float(), -1).to(dt)
    done = torch.tensor((rng.random(B) < 0.3).astype(np.float32),
                        device="cuda").to(dt)
    if agent == "ma2c_dial":
        obs, h = t(B, n, spec.n_s_max), t(B, n, spec.n_lstm, scale=0.5)
        w_dial = [x.to("cuda", dt) for x in p.w_dial]
        # contiguous, so that the times are the kernels' alone (the policy's
        # einsum leaves the message [agent, row] major: the wrapper copies)
        msg = (torch.einsum("bmh,mhd->bmd", h * (1.0 - done)[:, None, None],
                            w_dial[0]) + w_dial[1]).contiguous()
        fwd = (obs, None, msg, None, p.w_obs.w.to("cuda", dt),
               p.w_obs.b.to("cuda", dt), None, p.w_msg.to("cuda", dt),
               consts.nbr, consts.rev)
    else:
        w = [x.to("cuda", dt) for x in (p.w_obs.w, p.w_obs.b, p.w_fp,
                                        p.w_msg)]
        fwd = (t(B, n, spec.n_s_max), fp, t(B, n, spec.n_lstm, scale=0.5),
               done, *w, consts.nbr, consts.rev)
    e = ce.comm_embed_fwd_ref(*fwd[:9])
    bwd = (*fwd[:4], fwd[7], consts.nbr, consts.rev, e,
           t(B, n, spec.n_fc, scale=0.1))
    return spec, fwd, bwd


def embed_bytes_flops(spec, B, dtype):
    """Bytes each comm-embedding kernel must move (inputs read once, outputs
    written once) and its products' operations. The products read the
    weights of the valid slots alone; the backward writes the gradients of
    every slot (an empty slot's as zeros). DIAL's call (``spec`` of
    ``CommType.DIAL``): no fingerprints (A = 0) and no done flags, and its
    messages (``n_msg`` wide) in the place of h."""
    import torch
    from deeprl_network_tpu_torch.models.policies import CommType
    es = torch.tensor([], dtype=dtype).element_size()
    dial = spec.comm_type is CommType.DIAL
    N, S, F = spec.n_agent, spec.n_s_max, spec.n_fc
    A, H = (0, spec.n_msg) if dial else (spec.n_a_max, spec.n_lstm)
    _, valid = spec.neighbor_lists()
    K, edges = valid.shape[1], float(valid.sum())
    terms = N * (S + 1) + edges * (A + H)
    grads = N * (S + 1 + K * A + K * H) * F * es
    inputs = (B * N * (S + A + H) + (0 if dial else B)) * es
    act_f = B * N * F * es
    fwd = (inputs + terms * F * es + act_f, 2 * B * F * terms)
    # obs, fp, h, done, the valid W_msg, e, de in; dh and the weight
    # gradients out
    bwd = (inputs + edges * H * F * es + 2 * act_f + B * N * H * es + grads,
           2 * B * F * terms + 2 * B * edges * H * F)
    return fwd, bwd


def check_comm_embed(card):
    """The comm embedding's kernels against their plain twins on the card
    at every ``EMBED_CASES`` case, forward and backward, the backward
    bitwise equal across two calls and the launch counts asserted; at
    ``EMBED_TIMED`` their times from graph replays (warm and cold), the
    host's time a call, the twin's, the PyTorch ops they replace (the
    gather, einsums, adds and relu, forward and with their backward), and
    the bound. Returns the kernels line's entries."""
    import torch
    from deeprl_network_tpu_torch.ops import comm_embed as ce
    t_phase = time.perf_counter()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    entries = {}
    for name, network, B, dt_name, width, agent in EMBED_CASES:
        spec, fwd_args, bwd_args = embed_args(network, B, dt_name, width,
                                              agent=agent)
        dt = getattr(torch, dt_name)
        n_a = 0 if fwd_args[1] is None else spec.n_a_max
        variant = "tc" if ce.takes_tc(
            dt, spec.n_s_max, n_a, fwd_args[8].shape[1], width, width,
            fwd_args[9].shape[1]) else "general"
        before = dict(ce.LAUNCHES)
        e = ce.comm_embed_fwd(*fwd_args)
        got_b = ce.comm_embed_bwd(*bwd_args)
        again = ce.comm_embed_bwd(*bwd_args)
        torch.cuda.synchronize()
        err_f = max_err([e], [ce.comm_embed_fwd_ref(*fwd_args[:9])],
                        TOL[(dt_name, "fwd")], "e")
        # DIAL's call has no fingerprint gradient
        names = [k for k, g in zip(("dh", "dw_obs", "db_obs", "dw_fp",
                                    "dw_msg"), got_b) if g is not None]
        got_b, again = ([g for g in x if g is not None]
                        for x in (got_b, again))
        err_b = max_err(got_b, [g for g in ce.comm_embed_bwd_ref(*bwd_args)
                                if g is not None],
                        TOL[(dt_name, "bwd")], ",".join(names))
        if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
            raise AssertionError(f"comm embed {name}: the backward is not "
                                 "deterministic")
        moved = {k: v - before[k] for k, v in ce.LAUNCHES.items()
                 if v != before[k]}
        base = "comm_embed_dial" if agent == "ma2c_dial" else "comm_embed"
        if moved != {f"{base}_fwd": 1, f"{base}_bwd": 2}:
            raise AssertionError(f"comm embed {name}: launch counts moved "
                                 f"by {moved}")
        row = {"shape": name, "network": network, "B": B, "dtype": dt_name,
               "width": width, "agent": agent, "variant": variant,
               "fwd_max_abs_err": err_f, "bwd_max_abs_err": err_b}
        if name in EMBED_TIMED:
            row.update(embed_times(spec, fwd_args, bwd_args, flush))
            (fb, ff), (bb, bf) = embed_bytes_flops(spec, B, dt)
            row["fwd_bound_ms"], row["fwd_bound_by"] = bound(fb, ff, dt_name)
            row["bwd_bound_ms"], row["bwd_bound_by"] = bound(bb, bf, dt_name)
            row.update(fwd_bytes=fb, fwd_flops=ff, bwd_bytes=bb,
                       bwd_flops=bf, card=card)
            for d in ("fwd", "bwd"):
                row[f"{d}_share"] = row[f"{d}_bound_ms"] / row[f"{d}_ms"]
        log("comm_embed_check " + json.dumps(row))
        if name in ("flagship", "eval_b1"):
            suffix = "" if name == "flagship" else "_general"
            for d, err in (("fwd", err_f), ("bwd", err_b)):
                entries[f"comm_embed_{d}{suffix}"] = dict(
                    max_abs_err=err, ms=row[f"{d}_ms"],
                    plain_ms=row[f"{d}_plain_ms"],
                    bound_ms=row[f"{d}_bound_ms"],
                    bound_by=row[f"{d}_bound_by"],
                    library_ms=None, ops_ms=row[f"{d}_ops_ms"])
    log(f"comm embed: phase {time.perf_counter() - t_phase:.1f} s")
    return entries


def embed_times(spec, fwd_args, bwd_args, flush):
    """Times of the comm embedding at one case: the kernels (warm, cold,
    the host's call), the twins, and the PyTorch ops that ``_embed`` ran
    before them (``ops_ms``: the forward alone; the backward's entry: the
    forward with its autograd backward, less the forward). DIAL's call
    (``fp`` None) from its messages: the ops without the masking and the
    fingerprint term."""
    import torch
    from deeprl_network_tpu_torch.ops import comm_embed as ce
    obs, fp, h, done, w_obs, b_obs, w_fp, w_msg, nbr, rev = fwd_args
    de = bwd_args[-1]
    idx = nbr.clamp(min=0).long()
    leaves = [x.clone().requires_grad_() for x in (h, w_obs, b_obs, w_fp,
                                                     w_msg) if x is not None]

    def ops_fwd():
        if fp is None:
            hh, wo, bo, wm = leaves
            x = torch.einsum("bns,nsf->bnf", obs, wo) + bo
            x = x + torch.einsum("bnkx,nkxf->bnf", hh[:, idx], wm)
            return torch.relu(x)
        hh, wo, bo, wf, wm = leaves
        h_prev = hh * (1.0 - done)[:, None, None]
        x = torch.einsum("bns,nsf->bnf", obs, wo) + bo
        x = x + torch.einsum("bnkx,nkxf->bnf", fp[:, idx], wf)
        x = x + torch.einsum("bnkx,nkxf->bnf", h_prev[:, idx], wm)
        return torch.relu(x)

    def ops_fwd_bwd():
        return torch.autograd.grad(ops_fwd(), leaves, de)

    fwd = lambda: ce.comm_embed_fwd(*fwd_args)
    bwd = lambda: ce.comm_embed_bwd(*bwd_args)
    out = dict(fwd_ms=graph_ms(fwd), fwd_cold_ms=graph_ms(fwd, flush=flush),
               fwd_call_ms=host_call_ms(fwd),
               fwd_plain_ms=graph_ms(lambda: ce.comm_embed_fwd_ref(
                   *fwd_args[:9]), n=5),
               bwd_ms=graph_ms(bwd), bwd_cold_ms=graph_ms(bwd, flush=flush),
               bwd_call_ms=host_call_ms(bwd),
               bwd_plain_ms=graph_ms(lambda: ce.comm_embed_bwd_ref(
                   *bwd_args), n=5))
    with torch.no_grad():
        out["fwd_ops_ms"] = graph_ms(ops_fwd, n=5)
    out["bwd_ops_ms"] = graph_ms(ops_fwd_bwd, n=5) - out["fwd_ops_ms"]
    return out


HEAD_SOURCE = "deeprl_network_tpu_torch/ops/csrc/dial_head.cu"
HEAD_REPLACES = ("none: XLA fuses deeprl_network_tpu/models/policies.py "
                 "_embed's message-head einsum and bias add")
# (name, B, dtype): DIAL's flagship and its eval or record step at B=1 on the
# 5x5 grid (N=25, n_lstm = n_msg = 64)
HEAD_CASES = (("dial_flagship", 768, "bfloat16"),
              ("dial_eval_b1", 1, "float32"))


def head_args(B, dtype_name, seed=0):
    """(h, done, w, b, dm) of DIAL's message head on the card: the grid's
    DIAL head weights at the init's scale with a bias drawn beside them,
    numpy-seeded carry rows, a third of the rows done, a normal draw for
    the messages' gradient."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.models.policies import init_policy_params
    from deeprl_network_tpu_torch.utils.rollout import make_policy_spec
    env = LargeGridEnv(EnvConfig(scenario="large_grid"), device="cpu")
    spec = make_policy_spec(env.spec, ModelConfig(sparse_comm=True),
                            "ma2c_dial")
    dt = getattr(torch, dtype_name)
    p = init_policy_params(torch.Generator().manual_seed(seed), spec)
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32),
        device="cuda").to(dt)
    n, H, D = spec.n_agent, spec.n_lstm, spec.n_msg
    done = torch.tensor((rng.random(B) < 0.3).astype(np.float32),
                        device="cuda").to(dt)
    # W contiguous, as the update's graph holds it (the orthogonal init
    # leaves it column-major, which the wrapper would copy each call)
    return (t(B, n, H, scale=0.5), done,
            p.w_dial.w.to("cuda", dt).contiguous(), t(n, D, scale=0.1),
            t(B, n, D, scale=0.1))


def head_bytes_flops(h, w, dtype):
    """Bytes each head kernel must move (inputs read once, outputs written
    once) and its products' operations: the forward reads h, done, W and
    the bias and writes m; the backward reads h, done, W and dm and writes
    dh, dW and the bias gradient."""
    import torch
    es = torch.tensor([], dtype=dtype).element_size()
    (B, N, H), D = h.shape, w.shape[-1]
    rows, weights = B * N * (H + D) * es, (N * H * D + N * D) * es
    fwd = (rows + B * es + weights, 2 * B * N * H * D)
    bwd = (rows + B * N * H * es + B * es + 2 * N * H * D * es + N * D * es,
           4 * B * N * H * D)
    return fwd, bwd


def check_dial_head(card, build_s):
    """DIAL's message head against its twins on the card at ``HEAD_CASES``,
    forward and backward, the backward bitwise equal across two calls and
    the launch counts asserted; times from graph replays (warm and cold),
    the host's time a call, the twins', the PyTorch ops it replaced (the
    mask, the einsum, the bias add and the copy of the messages into
    [B, N, D] rows; the backward's entry: the forward with its autograd
    backward, less the forward), and the bound. Returns the kernels line's
    entries."""
    import torch
    from deeprl_network_tpu_torch.ops import dial_head as dh
    t_phase = time.perf_counter()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    entries = {}
    for name, B, dt_name in HEAD_CASES:
        h, done, w, b, dm = head_args(B, dt_name)
        dt = h.dtype
        variant = "tc" if dh.takes_tc(dt, h.shape[-1], w.shape[-1]) \
            else "general"
        before = dict(dh.LAUNCHES)
        m = dh.dial_head_fwd(h, done, w, b)
        got = dh.dial_head_bwd(h, done, w, dm)
        again = dh.dial_head_bwd(h, done, w, dm)
        torch.cuda.synchronize()
        err_f = max_err([m], [dh.dial_head_fwd_ref(h, done, w, b)],
                        TOL[(dt_name, "fwd")], "m")
        err_b = max_err(got, dh.dial_head_bwd_ref(h, done, w, dm),
                        TOL[(dt_name, "bwd")], "dh,dw,db")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"dial head {name}: the backward is not "
                                 "deterministic")
        moved = {k: v - before[k] for k, v in dh.LAUNCHES.items()
                 if v != before[k]}
        if moved != {"dial_head_fwd": 1, "dial_head_bwd": 2}:
            raise AssertionError(f"dial head {name}: launch counts moved by "
                                 f"{moved}")
        leaves = [x.clone().requires_grad_() for x in (h, w, b)]

        def ops_fwd():
            x = leaves[0] * (1.0 - done)[:, None, None]
            return (torch.einsum("bmh,mhd->bmd", x, leaves[1])
                    + leaves[2]).contiguous()

        fwd = lambda: dh.dial_head_fwd(h, done, w, b)
        bwd = lambda: dh.dial_head_bwd(h, done, w, dm)
        row = {"shape": name, "B": B, "dtype": dt_name, "variant": variant,
               "fwd_max_abs_err": err_f, "bwd_max_abs_err": err_b,
               "build_s": build_s,
               "fwd_ms": graph_ms(fwd), "fwd_cold_ms": graph_ms(fwd,
                                                               flush=flush),
               "fwd_call_ms": host_call_ms(fwd),
               "fwd_plain_ms": graph_ms(lambda: dh.dial_head_fwd_ref(
                   h, done, w, b), n=5),
               "bwd_ms": graph_ms(bwd), "bwd_cold_ms": graph_ms(bwd,
                                                               flush=flush),
               "bwd_call_ms": host_call_ms(bwd),
               "bwd_plain_ms": graph_ms(lambda: dh.dial_head_bwd_ref(
                   h, done, w, dm), n=5)}
        with torch.no_grad():
            row["fwd_ops_ms"] = graph_ms(ops_fwd, n=5)
        row["bwd_ops_ms"] = graph_ms(lambda: torch.autograd.grad(
            ops_fwd(), leaves, dm), n=5) - row["fwd_ops_ms"]
        (fb, ff), (bb, bf) = head_bytes_flops(h, w, dt)
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(fb, ff, dt_name)
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound(bb, bf, dt_name)
        row.update(fwd_bytes=fb, fwd_flops=ff, bwd_bytes=bb, bwd_flops=bf,
                   card=card)
        for d in ("fwd", "bwd"):
            row[f"{d}_share"] = row[f"{d}_bound_ms"] / row[f"{d}_ms"]
        log("dial_head_check " + json.dumps(row))
        suffix = "" if variant == "tc" else "_general"
        for d, err in (("fwd", err_f), ("bwd", err_b)):
            entries[f"dial_head_{d}{suffix}"] = dict(
                max_abs_err=err, ms=row[f"{d}_ms"],
                plain_ms=row[f"{d}_plain_ms"],
                bound_ms=row[f"{d}_bound_ms"], bound_by=row[f"{d}_bound_by"],
                library_ms=None, ops_ms=row[f"{d}_ops_ms"])
    log(f"dial head: phase {time.perf_counter() - t_phase:.1f} s")
    return entries


def make_flagship(device, env_kw=None, agent="ma2c_nc", jit=True,
                  **overrides):
    """The flagship configuration through make_a2c for ``agent``;
    ``overrides`` replace ModelConfig fields, ``env_kw`` adds EnvConfig
    fields."""
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
                    TrainConfig(total_step=1_000_000), agent=agent, jit=jit,
                    device=device)


def make_from_ini(path, device, env_kw=None, **overrides):
    """(env, A2C functions) of a ``configs/*.ini`` file through the port's
    ``load_config`` and the CLI's ``init_env`` / ``init_agent``; ``env_kw`` /
    ``overrides`` replace EnvConfig / ModelConfig fields."""
    import dataclasses
    from deeprl_network_tpu_torch.config import load_config
    from deeprl_network_tpu_torch.main import init_agent, init_env
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, path))
    cfg = dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, **(env_kw or {})),
        model=dataclasses.replace(cfg.model, **overrides))
    env = init_env(cfg, device=device)
    return env, init_agent(env, cfg, device=device)


def make_cacc(path, device, env_kw=None, **overrides):
    """The CACC platoon of a ``configs/*.ini`` file."""
    return make_from_ini(path, device, env_kw, **overrides)[1]


def wrapper_counts():
    """Every wrapper's launch counts: the LSTM cell, the env steps (ATSC
    and platoon), the comm embedding and DIAL's message head."""
    from deeprl_network_tpu_torch.ops import cacc_env
    from deeprl_network_tpu_torch.ops import comm_embed as ce
    from deeprl_network_tpu_torch.ops import dial_head as dh
    from deeprl_network_tpu_torch.ops import lstm_cell as lc
    from deeprl_network_tpu_torch.ops import network_env as ne
    return (lc.LAUNCHES, ne.LAUNCHES, cacc_env.LAUNCHES, ce.LAUNCHES,
            dh.LAUNCHES)


def zero_counts():
    for counts in wrapper_counts():
        for k in counts:
            counts[k] = 0


def card_view(counts):
    """Wrapper counts as the card's kernel names count them (``on_card``):
    DIAL's comm-embedding calls run NeurComm's kernels, so their counts
    join NeurComm's keys."""
    out = {k: v for k, v in counts.items()
           if not k.startswith("comm_embed_dial_")}
    for k, v in counts.items():
        if k.startswith("comm_embed_dial_"):
            key = k.replace("comm_embed_dial_", "comm_embed_")
            out[key] = out.get(key, 0) + v
    return out


def expect_counts(what, fwd, bwd, variant, env, got=None, embed=False,
                  cacc=0):
    """Raise unless ``got`` holds ``fwd`` forward and ``bwd`` backward cell
    launches, all of ``variant``, ``env`` ATSC env-step launches and
    ``cacc`` platoon env-step launches; with
    ``embed`` (True: MA2C_NC over packed neighbour lists; "dial": MA2C_DIAL,
    under DIAL's keys, and as many of its message head's) as many
    comm-embedding launches as cell launches, else none; returns the
    counts. ``got`` defaults to
    the wrappers' counts since ``zero_counts()``: launches issued from
    Python or captured into a CUDA graph, whose replays they do not see;
    ``on_card`` gives what ran, counted by kernel name (``card_view``)."""
    want = {k: 0 for c in wrapper_counts() for k in c}
    want.update({"lstm_cell_fwd": fwd, f"lstm_cell_fwd_{variant}": fwd,
                 "lstm_cell_bwd": bwd, f"lstm_cell_bwd_{variant}": bwd,
                 "network_env_step": env, "cacc_env_step": cacc})
    if embed:
        base = "comm_embed_dial" if embed == "dial" else "comm_embed"
        for b in (base, "dial_head") if embed == "dial" else (base,):
            want.update({f"{b}_fwd": fwd, f"{b}_bwd": bwd})
    if got is None:
        got = {k: v for c in wrapper_counts() for k, v in c.items()}
    else:
        want = card_view(want)
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")
    return dict(got)


# the kernel that each wrapper call launches once (a pattern: the comm
# embedding and the head count either pair under one key), by the count the
# wrapper adds to (the backward wrappers launch more kernels after it)
KERNEL_OF = {"lstm_cell_fwd_tc": "lstm_tc_fwd_kernel",
             "lstm_cell_bwd_tc": "lstm_tc_bwd_act_kernel",
             "lstm_cell_fwd_general": "lstm_fwd_kernel",
             "lstm_cell_bwd_general": "lstm_bwd_act_kernel",
             "network_env_step": "network_env_kernel",
             "cacc_env_step": "cacc_env_kernel",
             "comm_embed_fwd": "comm_embed_(?:tc_)?fwd_kernel",
             "comm_embed_bwd": "comm_embed_(?:tc_)?bwd_kernel",
             "dial_head_fwd": "dial_head_(?:tc_)?fwd_kernel",
             "dial_head_bwd": "dial_head_(?:tc_)?bwd_kernel"}


def kernel_counts(by_name):
    """The wrappers' count names from kernel counts by (demangled) name."""
    got = {}
    for key, kernel in KERNEL_OF.items():
        pat = re.compile(rf"(?<!\w)(?:{kernel})(?!\w)")
        got[key] = sum(n for name, n in by_name.items() if pat.search(name))
    for d in ("fwd", "bwd"):
        got[f"lstm_cell_{d}"] = (got[f"lstm_cell_{d}_tc"]
                                 + got[f"lstm_cell_{d}_general"])
    return got


@contextlib.contextmanager
def on_card():
    """The kernels that run on the card inside the block, counted by name
    under ``benchmark.trace.traced`` into the yielded dict, filled at the
    block's end under the wrappers' count names: unlike the wrappers'
    counts, these include what replays of a CUDA graph run."""
    ran = {}
    with traced() as prof:
        yield ran
    by_name = {}
    for card, name, _, _ in events(prof):
        if card:
            by_name[name] = by_name.get(name, 0) + 1
    ran.update(kernel_counts(by_name))


def check_wide_reference():
    """F1 closed end to end: a small f32 MA2C_NC step at num_fc=64,
    num_lstm=256 (F + H = 320, past the general kernels' old cap) on the
    card against the CPU port; every cell launch is general (remat: 2T+1
    forward and T backward an update, two updates), one env-step launch a
    control step. The updates are given their noise and run one graph: its
    warm-up and capture are the two updates the wrappers count."""
    zero_counts()
    check_reference("reference wide",
                    lambda device: small_grid(device, num_fc=64,
                                              num_lstm=256), 5)
    expect_counts("reference wide", 2 * 17, 2 * 8, "general", 2 * 8,
                  embed=True)


def check_finite_and_moved(what, m, params, p0):
    import torch
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    for k in ("loss", "grad_norm"):
        if not torch.isfinite(torch.as_tensor(m[k])).all():
            raise AssertionError(f"{what}: {k} is not finite")
    leaves = tree_leaves(params)
    if any(p.dtype != torch.float32 for p in leaves):
        raise AssertionError(f"{what}: master params are not f32")
    if all(torch.equal(a, b) for a, b in zip(leaves, p0)):
        raise AssertionError(f"{what}: params did not change")


def check_reference(what, make, n_act):
    """A small f32 train step on the card against the CPU port (twins),
    same params and noise, two updates across an episode end. ``make``
    builds the small configuration (T=8, B=4) on a device."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    cpu, gpu = make("cpu"), make("cuda")
    ts_c = cpu.init_state(0)
    ts_g = gpu.init_state(0, params=ts_c.params)
    rng = np.random.default_rng(1)
    worst = 0.0
    for _ in range(2):
        u = rng.random((8, 4, cpu.spec.n_agent, n_act)).astype(np.float32)
        g = torch.tensor(-np.log(-np.log(np.maximum(u, 1e-30))))
        ts_c, m_c = cpu.train_step(ts_c, gumbel=g)
        ts_g, m_g = gpu.train_step(ts_g, gumbel=g)
        for k in ("loss", "grad_norm", "value_loss", "entropy"):
            a, b = float(m_g[k]), float(m_c[k])
            if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
                raise AssertionError(f"{what}: {k} {a} on the card vs "
                                     f"{b} on the CPU")
        for a, b in zip(tree_leaves(ts_g.params), tree_leaves(ts_c.params)):
            d = float((a.cpu() - b).abs().max())
            if d > 1e-5:
                raise AssertionError(f"{what}: params differ by {d}")
            worst = max(worst, d)
    if float(m_g["episode_len"]) != 12.0:
        raise AssertionError(f"{what}: no episode end was crossed")
    log(f"{what}: 2 f32 updates on the card match the CPU port "
        f"(max param diff {worst:.2e}, loss {float(m_g['loss']):.6f})")


SMALL = dict(batch_size=8, num_envs=4, num_fc=16, num_lstm=16,
             compute_dtype="float32")


def small_grid(device, **overrides):
    return make_flagship(device, env_kw=dict(episode_length_sec=60),
                         **dict(SMALL, **overrides))


def timed_steps(what, fns, ts, n_timed, fwd_per_step, bwd_per_step, variant,
                env_per_step, embed=False, cacc_per_step=0):
    """A warm-up ``train_step`` and ``n_timed`` timed ones from ``ts`` (the
    first captures the update's CUDA graph, the others replay it) under
    ``on_card``, with the counts set to 0 before and asserted after
    (``env_per_step`` env-step launches an update: T on the ATSC envs;
    ``cacc_per_step``: T on the platoon): the
    wrappers count two updates' worth (the capture's warm-up and the
    capture), and the card runs one update's worth more than the calls (the
    warm-up; ``embed``: the comm embedding's launches beside the cell's, as
    ``expect_counts`` takes them). Checks that the result is finite, the
    masters f32 and the
    params changed. Returns (state, last metrics, {"issued": the wrappers'
    counts, "ran": the card's, "runs": the updates the card ran}, per-step
    seconds, under the kernel trace)."""
    import torch
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    p0 = [p.clone() for p in tree_leaves(ts.params)]
    zero_counts()
    with on_card() as ran:
        t0 = time.perf_counter()
        ts, m = fns.train_step(ts)          # warm-up
        torch.cuda.synchronize()
        log(f"{what}: warm-up train_step {time.perf_counter() - t0:.2f} s, "
            f"loss {float(m['loss']):.6f}")
        step_times = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            ts, m = fns.train_step(ts)
            torch.cuda.synchronize()
            step_times.append(time.perf_counter() - t0)
    n_steps = n_timed + 1
    issued, runs = (2, n_steps + 1) if fns.graphed else (n_steps, n_steps)
    counts = {"issued": expect_counts(
        what, fwd_per_step * issued, bwd_per_step * issued, variant,
        env_per_step * issued, embed=embed, cacc=cacc_per_step * issued),
        "ran": expect_counts(
            f"{what} on the card", fwd_per_step * runs, bwd_per_step * runs,
            variant, env_per_step * runs, got=ran, embed=embed,
            cacc=cacc_per_step * runs),
        "runs": runs}
    check_finite_and_moved(what, m, ts.params, p0)
    return ts, m, counts, step_times


def per_update(counts):
    """The kernels on the card an update, from ``timed_steps``' counts."""
    return {k: v // counts["runs"] for k, v in counts["ran"].items() if v}


def run_main_path(card: str, n_timed: int = 3):
    """Flagship train steps through make_a2c; returns (``timed_steps``'
    counts, env-steps/s under the kernel trace, fns, state)."""
    import torch
    fns = make_flagship("cuda")
    T, B = 120, 768
    ts = fns.init_state(0)
    torch.cuda.reset_peak_memory_stats()
    # every launch of the flagship step takes the tensor-core variant:
    # rollout, bootstrap and the remat recompute forward, T backward, the
    # cell's and the comm embedding's alike; the env step is one launch a
    # control step
    ts, m, counts, step_times = timed_steps(
        "main path", fns, ts, n_timed, 2 * T + 1, T, "tc", T, embed=True)
    dt = sum(step_times)
    sps = n_timed * T * B / dt
    log("main path: " + json.dumps({
        k: (float(v) if torch.is_tensor(v) else v) for k, v in m.items()}))
    log(f"main path: {n_timed} timed train_steps in {dt:.3f} s = "
        f"{sps:.1f} env-steps/s (B={B}, T={T}, bf16, sparse_comm, remat; "
        f"under the kernel trace) on {card}; per step "
        f"{json.dumps([round(t, 4) for t in step_times])} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"launches issued or captured {json.dumps(counts['issued'])}, run "
        f"on the card {json.dumps(counts['ran'])}")
    return counts, sps, fns, ts


def clone_state(ts):
    """A TrainState with copies of ``ts``'s tensors and generator."""
    import torch
    from deeprl_network_tpu_torch.utils.rollout import (
        state_from_leaves, state_leaves,
    )
    gen = torch.Generator(device=ts.generator.device)
    gen.set_state(ts.generator.get_state())
    return state_from_leaves(ts, [t.clone() for t in state_leaves(ts)],
                             ts.step, ts.opt_state.count, gen)


def graph_against_eager(what, make, n=3):
    """``make(jit)`` builds the functions; ``n`` updates through the graph
    and eagerly from one ``init_state(0)`` cloned both ways, under
    ``on_card``: every TrainState leaf, the generator and every metric bit
    for bit. Eagerly the wrappers count ``n`` updates' worth of launches and
    the card runs them; under the graph the wrappers count two (the
    capture's warm-up and the capture) and the card runs ``n + 1`` (the
    warm-up and ``n`` replays). Returns ({"issued": the graph's wrapper
    counts, "ran": its counts on the card}, the graph's capture times)."""
    import torch
    from deeprl_network_tpu_torch.utils.rollout import state_leaves
    runs, counts = {}, {}
    ts0 = None
    for jit in (True, False):
        fns = make(jit)
        if ts0 is None:
            ts = fns.init_state(0)
            ts0 = clone_state(ts)
        else:
            ts = clone_state(ts0)
        zero_counts()
        runs[jit] = []
        with on_card() as ran:
            for _ in range(n):
                ts, m = fns.train_step(ts)
                runs[jit].append((ts, m))
        counts[jit] = {"issued": {k: v for c in wrapper_counts()
                                  for k, v in c.items()},
                       "ran": dict(ran)}
        if jit:
            times = next(iter(fns.graphed.graphs.values())).times
        del fns
    eager, graph = counts[False], counts[True]
    per = {k: v // n for k, v in eager["issued"].items()}
    want = {"issued": {k: 2 * v for k, v in per.items()},
            "ran": card_view({k: (n + 1) * v for k, v in per.items()})}
    if (eager["ran"] != card_view(eager["issued"])
            or any(v % n for v in eager["issued"].values())
            or graph != want):
        raise AssertionError(f"graph {what}: launches {graph} under the "
                             f"graph, {eager} eager over {n} updates")
    for i, ((ts_g, m_g), (ts_e, m_e)) in enumerate(zip(runs[True],
                                                       runs[False])):
        for j, (a, b) in enumerate(zip(state_leaves(ts_g),
                                       state_leaves(ts_e))):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(
                    f"graph {what}: update {i + 1}, state leaf {j} differs "
                    f"from eager by {float((a.float() - b.float()).abs().max())}")
        if not torch.equal(ts_g.generator.get_state(),
                           ts_e.generator.get_state()):
            raise AssertionError(f"graph {what}: update {i + 1}: the "
                                 "generators differ")
        if m_g.keys() != m_e.keys() or any(
                float(m_g[k]) != float(m_e[k]) for k in m_g):
            raise AssertionError(f"graph {what}: update {i + 1}: metrics "
                                 f"{m_g} under the graph, {m_e} eager")
    log(f"graph {what}: {n} updates through the graph equal the eager "
        f"updates bit for bit (every state leaf, the generator, metrics "
        f"{sorted(runs[True][-1][1])}); launches an update "
        f"{json.dumps({k: v for k, v in per.items() if v})}: eager issued "
        f"and ran {n} updates' worth, the graph issued 2 and ran {n + 1}; "
        f"capture {json.dumps(times)}")
    return graph, times


def run_graph(card: str):
    """The graph phase: the graph's update against the eager update (the
    flagship; each family at a small f32 width on both gradient paths; the
    f32 3x3 grid with kickstart, switch penalty and moving schedules, a
    ``ladder_atsc`` variant; the replay path at the harness shape: f32,
    B=64, no ``remat``, the general kernels). Returns the flagship's graph
    counts, issued and run."""
    from deeprl_network_tpu_torch.config import (
        EnvConfig, ModelConfig, TrainConfig,
    )
    from deeprl_network_tpu_torch.envs.grid import build_grid_topology
    from deeprl_network_tpu_torch.envs.network import TrafficNetworkEnv
    from deeprl_network_tpu_torch.scripts.ladder_atsc import LADDER
    from deeprl_network_tpu_torch.utils.rollout import make_a2c
    t_phase = time.perf_counter()
    T = 120
    flag = lambda jit, **kw: make_flagship("cuda", jit=jit, **kw)
    launches, _ = graph_against_eager("flagship", flag)
    for agent in AGENTS:
        for fused in (True, False):
            graph_against_eager(
                f"{agent} {'fused' if fused else 'replay'} small f32",
                lambda jit, agent=agent, fused=fused: small_grid(
                    "cuda", agent=agent, jit=jit, fused_grad=fused))
    env_kw, model_kw = LADDER["pq_kick_sp2"]

    def ladder(jit):
        # 3 updates of 7,680 steps over a 30,000-step run: the learning
        # rate, the entropy coefficient and the kickstart weight all move
        cfg = EnvConfig(scenario="large_grid", coop_gamma=0.9, **env_kw)
        env = TrafficNetworkEnv(cfg, build_grid_topology(cfg, 3),
                                device="cuda")
        return make_a2c(env, ModelConfig(
            batch_size=T, num_envs=64, lr_decay="linear",
            entropy_decay="linear", **model_kw),
            TrainConfig(total_step=30_000), agent="ma2c_nc", jit=jit,
            device="cuda")
    graph_against_eager("ladder pq_kick_sp2 3x3 f32", ladder)
    graph_against_eager("replay f32 B=64", lambda jit: flag(
        jit, fused_grad=False, num_envs=64, compute_dtype="float32",
        sparse_comm=False, remat=False))
    log(f"graph: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_bench(card: str):
    """The throughput tools' twin: ``bench.py``'s measure at the flagship
    over a 15 s window, its launch counts asserted; returns the window's
    launch counts."""
    import math
    from deeprl_network_tpu_torch import bench
    t_phase = time.perf_counter()
    baseline = bench.measure_baseline()
    log(f"bench: baseline (reference-style host loop) {baseline:.1f} "
        f"env-steps/s")
    zero_counts()
    r = bench.measure(seconds_budget=15, **bench.FLAGSHIP)
    # the excluded warm-up captures the update's graph, and the window only
    # replays it: the wrappers count the capture's warm-up and the capture,
    # each 2T+1 forward and T backward tensor-core launches and T env
    # steps (the window runs untraced, as bench.py does: the main path and
    # the families count what replays run)
    launches = expect_counts("bench", 2 * 241, 2 * 120, "tc", 2 * 120,
                             embed=True)
    if not (r.env_steps_per_s > baseline and math.isfinite(r.loss)):
        raise AssertionError(f"bench: rate {r.env_steps_per_s} against the "
                             f"baseline's {baseline}, loss {r.loss}")
    log(f"bench: {r.updates} updates in {r.window_s:.3f} s after a "
        f"{r.warmup_s:.3f} s warm-up (init_state {r.init_s:.3f} s); chunks "
        f"of {bench.CHUNK} {json.dumps([round(t, 3) for t in r.chunk_s])} s "
        f"on {card}")
    log("bench: " + bench.result_line(r.env_steps_per_s, baseline))
    log(f"bench: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def agent_spread(params) -> float:
    """Mean variance across agents of the LSTM input weights."""
    return float(params.lstm.wx.var(dim=0).mean())


def run_families(card: str, n_timed: int = 2):
    """The flagship step for each of the six agents; returns MA2C_DIAL's
    ``timed_steps`` counts."""
    import torch
    T, B = 120, 768
    dial_counts = None
    for agent in AGENTS:
        what = f"families {agent}"
        fns = make_flagship("cuda", agent=agent)
        ts = fns.init_state(0)
        spread0 = agent_spread(ts.params)
        ts, m, counts, step_times = timed_steps(
            what, fns, ts, n_timed, 2 * T + 1, T, "tc", T,
            embed={"ma2c_nc": True, "ma2c_dial": "dial"}.get(agent, False))
        if agent == "ma2c_dial":
            dial_counts = counts
        line = {"agent": agent, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "env_steps_per_s": n_timed * T * B / sum(step_times),
                "step_s": [round(t, 4) for t in step_times],
                "launches_per_step": per_update(counts), "card": card}
        spread = agent_spread(ts.params)
        if agent == "ia2c_cu":
            # averaging over closed neighbourhoods of 3 to 5 agents cuts
            # the spread between agents; an RMSProp step barely moves it
            if not spread < 0.5 * spread0:
                raise AssertionError(
                    f"{what}: spread between agents {spread0} -> {spread}: "
                    "the weight consensus did not run")
            line["agent_spread"] = [spread0, spread]
        elif not spread > 0.9 * spread0:
            raise AssertionError(f"{what}: spread between agents "
                                 f"{spread0} -> {spread} without consensus")
        log("families " + json.dumps(line))
        del fns, ts
        torch.cuda.empty_cache()
    return dial_counts


def check_replay():
    """A small f32 MA2C_NC update on the card through the replay path
    against the fused path, from the same state and noise (both with
    remat); asserts each path's launch counts: the wrappers count the
    graph's warm-up and capture, two updates' worth."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    T = 8
    g = torch.tensor(np.random.default_rng(2).gumbel(
        size=(T, 4, 25, 5)).astype(np.float32))
    out, launches = {}, {}
    # fused: T rollout + 1 bootstrap + T recomputed forwards, T backwards;
    # replay: T rollout + 1 bootstrap, then T replayed + T recomputed
    for fused, n_fwd in ((True, 2 * T + 1), (False, 3 * T + 1)):
        fns = small_grid("cuda", fused_grad=fused, remat=True)
        ts = fns.init_state(0)
        zero_counts()
        ts, m = fns.train_step(ts, gumbel=g)
        torch.cuda.synchronize()
        launches[f"replay fused_grad={fused}"] = expect_counts(
            f"replay (fused_grad={fused})", 2 * n_fwd, 2 * T, "general", 2 * T,
            embed=True)
        out[fused] = (ts, m)
    (ts_f, m_f), (ts_r, m_r) = out[True], out[False]
    for k in ("loss", "grad_norm", "value_loss", "entropy", "step_reward"):
        a, b = float(m_r[k]), float(m_f[k])
        if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
            raise AssertionError(f"replay: {k} {a} against fused {b}")
    worst = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(ts_r.params), tree_leaves(ts_f.params)))
    if worst > 1e-5:
        raise AssertionError(f"replay: params differ from fused by {worst}")
    log(f"replay: the f32 replay update on the card equals the fused update "
        f"(loss {float(m_r['loss']):.6f} vs {float(m_f['loss']):.6f}, max "
        f"param diff {worst:.2e}); launches per step {3 * T + 1} forward + "
        f"{T} backward (replay) vs {2 * T + 1} + {T} (fused), general "
        f"variant, T={T}")
    return launches


def run_cacc(card: str, n_timed: int = 2):
    """The two CACC configurations at the files' own sizes, then small f32
    updates against the CPU port. Returns {config: (fns, state)} and the
    ``timed_steps`` counts of the first configuration's run."""
    import torch
    trained, first_launches = {}, None
    for path in CACC_CONFIGS:
        what = f"cacc {os.path.basename(path)}"
        fns = make_cacc(path, "cuda")
        ts = fns.init_state(0)
        T, B = 120, 32
        if fns.steps_per_update != T * B or fns.spec.n_agent != 8 \
                or fns.spec.n_lstm != 64 or fns.spec.n_fc != 64:
            raise AssertionError(f"{what}: not the size the file states")
        # no remat in these files: T rollout + 1 bootstrap forwards; the
        # platoon's env kernel once a step
        ts, m, counts, step_times = timed_steps(
            what, fns, ts, n_timed, T + 1, T, "general", 0, cacc_per_step=T)
        first_launches = first_launches or counts
        log("cacc " + json.dumps({
            "config": path, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "env_steps_per_s": n_timed * T * B / sum(step_times),
            "step_s": [round(t, 4) for t in step_times],
            "launches_per_step": per_update(counts), "card": card}))
        trained[path] = (fns, ts)
        # initial noise off: the CPU's and the card's generators differ
        check_reference(
            f"cacc reference {os.path.basename(path)}",
            lambda device: make_cacc(
                path, device, env_kw=dict(episode_length=12,
                                          init_noise_h=0.0, init_noise_v=0.0),
                **SMALL), 4)
    return trained, first_launches


def check_eval_record(what, gpu_fns, cpu_fns, params, horizon, episode,
                      card, env_kernel, embed=False):
    """``eval_episode`` and ``record_episode`` on the card against the same
    calls on the CPU port with the same params and noise over ``horizon``
    steps: action sequences equal, everything else within 1e-4 relative;
    the cell's launches counted (one forward per step, none for the
    controller), and with ``env_kernel`` (the ATSC envs) one env-step
    launch a step, with ``embed`` one comm-embedding launch a policy step;
    then one whole sampled episode (``episode`` steps, the env's default
    horizon) on the card."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.models.policies import tree_map
    cpu_params = tree_map(lambda t: t.cpu(), params)
    spec = gpu_fns.spec
    g = torch.tensor(np.random.default_rng(3).gumbel(
        size=(horizon, spec.n_agent, spec.n_a_max)).astype(np.float32))
    calls = [
        ("eval sampled", "eval_episode", dict(greedy=False, gumbel=g), True),
        ("eval greedy", "eval_episode", dict(greedy=True), True),
        ("record greedy", "record_episode", dict(policy="greedy"), True),
        ("record controller", "record_episode", dict(policy="controller"),
         False),
    ]
    for name, fn, kw, uses_policy in calls:
        zero_counts()
        t0 = time.perf_counter()
        got = getattr(gpu_fns, fn)(params if uses_policy else None, 0,
                                   horizon, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts(f"{what} {name}", horizon if uses_policy else 0, 0,
                      "general", horizon if env_kernel else 0,
                      embed=embed and uses_policy)
        want = getattr(cpu_fns, fn)(cpu_params if uses_policy else None, 0,
                                    horizon, **kw)
        if got.keys() != want.keys():
            raise AssertionError(f"{what} {name}: keys differ")
        for k, b in want.items():
            a = got[k].cpu()
            if a.shape != b.shape:
                raise AssertionError(f"{what} {name}: {k} shape {a.shape}")
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{what} {name}: {k} differs from the CPU port's")
                continue
            tol = 1e-4 * max(1.0, float(b.abs().max()))
            if not (torch.isfinite(a).all()
                    and float((a - b).abs().max()) <= tol):
                raise AssertionError(
                    f"{what} {name}: {k} off by "
                    f"{float((a - b).abs().max())} (tol {tol})")
        ret = float(got["episode_return"] if fn == "eval_episode"
                    else (got["reward"].sum(-1) * got["alive"]).sum())
        log(f"{what} {name}: {horizon} steps on the card match the CPU "
            f"port; return {ret:.4f}, wall {wall:.3f} s on {card}")
    zero_counts()
    t0 = time.perf_counter()
    out = gpu_fns.eval_episode(params, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = episode
    counts = expect_counts(f"{what} whole episode", n, 0, "general",
                           n if env_kernel else 0, embed=embed)
    if not torch.isfinite(out["episode_return"]):
        raise AssertionError(f"{what}: whole episode failed")
    log(f"{what} whole sampled episode: {n} steps, executed "
        f"{float(out['episode_len']):.0f}, return "
        f"{float(out['episode_return']):.4f}, wall {wall:.3f} s "
        f"({wall / n * 1e3:.3f} ms a step) on {card}")
    return counts


def run_monaco(card: str):
    """Monaco-28 MA2C_NC: a small step against the CPU port, the ``.ini``
    file's own step and the same env at the flagship's settings. Returns the
    ``timed_steps`` counts of the two full-width runs."""
    import torch
    T = 120
    check_reference(
        "monaco reference",
        lambda device: make_from_ini(
            MONACO_INI, device, env_kw=dict(episode_length_sec=60),
            **SMALL)[1], 6)
    out = {}
    runs = (("monaco ini", {}, 3, T + 1, "general"),
            ("monaco b768", dict(num_envs=768, compute_dtype="bfloat16",
                                 sparse_comm=True, remat=True), 2, 2 * T + 1,
             "tc"))
    for what, overrides, n_timed, fwd, variant in runs:
        embed = bool(overrides.get("sparse_comm"))
        env, fns = make_from_ini(MONACO_INI, "cuda", **overrides)
        B = overrides.get("num_envs", 32)
        spec, topo = fns.spec, env.topo
        if (spec.n_agent, spec.n_fc, spec.n_lstm, spec.n_a_max,
                topo.n_lane, env.max_delay, env.episode_steps,
                fns.steps_per_update) != (28, 64, 64, 6, 148, 18, 720, T * B):
            raise AssertionError(f"{what}: not the size the file states")
        # every sampled action must lie inside its node's action count; the
        # flag is written in place, so that every replay of the update's
        # graph writes it too
        n_a = torch.as_tensor(env.spec.n_a_ls, device="cuda")
        bad = torch.zeros((), dtype=torch.bool, device="cuda")
        step = env.step_autoreset

        def checked_step(state, action, *rest):
            bad.logical_or_((action >= n_a).any() | (action < 0).any())
            return step(state, action, *rest)
        env.step_autoreset = checked_step
        ts, m, counts, step_times = timed_steps(
            what, fns, fns.init_state(0), n_timed, fwd, T, variant, T,
            embed=embed)
        if bool(bad):
            raise AssertionError(f"{what}: a padded phase was sampled")
        out[what] = counts
        log(what + " " + json.dumps({
            "config": MONACO_INI, "overrides": overrides,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "env_steps_per_s": n_timed * T * B / sum(step_times),
            "step_s": [round(t, 4) for t in step_times],
            "launches_per_step": per_update(counts), "card": card}))
        del env, fns, ts
        torch.cuda.empty_cache()
    return out


def csv_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def require_files(what, directory, names):
    missing = [n for n in names
               if not os.path.getsize(os.path.join(directory, n)) > 0]
    if missing:
        raise AssertionError(f"{what}: missing or empty {missing}")


def run_cli(card: str):
    """The port's CLI on Monaco-28 MA2C_NC, ``total_step`` cut to 5 updates:
    train with in-train tests, train --restore, evaluate, evaluate --naive;
    then the Trainer's own cost and the checkpoint's."""
    import torch
    from deeprl_network_tpu_torch.config import load_config
    from deeprl_network_tpu_torch.main import (
        init_agent, init_env, main as cli,
    )
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    from deeprl_network_tpu_torch.utils.trainer import Trainer
    root = os.path.dirname(os.path.abspath(__file__))
    T, B, n_upd, horizon = 120, 32, 5, 720
    spu = T * B
    cp = configparser.ConfigParser()
    cp.read(os.path.join(root, MONACO_INI))
    n_test_seeds = len(cp["ENV_CONFIG"]["test_seeds"].split(","))

    def write_ini(directory, total):
        # log rows at 2 and 4 updates, one test at 4 updates
        cp["TRAIN_CONFIG"].update(
            total_step=str(total), log_interval=str(2 * spu),
            test_interval=str(4 * spu))
        os.makedirs(directory)
        path = os.path.join(directory, os.path.basename(MONACO_INI))
        with open(path, "w") as f:
            cp.write(f)
        return path

    def timed_cli(what, argv, fwd, bwd, env):
        zero_counts()
        t0 = time.perf_counter()
        cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts(what, fwd, bwd, "general", env)
        return wall

    with tempfile.TemporaryDirectory() as d:
        base = os.path.join(d, "run")
        data, eva = os.path.join(base, "data"), os.path.join(base, "eva_data")
        ini = write_ini(os.path.join(d, "first"), n_upd * spu)
        # the updates run one graph: the wrappers count its warm-up and
        # capture, two updates' worth; the test episodes run eagerly
        wall = timed_cli(
            "cli train",
            ["--base-dir", base, "train", "--config-dir", ini,
             "--test-mode", "in_train_test"],
            2 * (T + 1) + n_test_seeds * horizon, 2 * T,
            2 * T + n_test_seeds * horizon)
        require_files("cli train", data, [
            "train_log.csv", "train_log.jsonl", "test_log.csv",
            os.path.basename(MONACO_INI)])
        rows = csv_rows(os.path.join(data, "train_log.csv"))
        steps = [float(r["step"]) for r in rows]
        tests = csv_rows(os.path.join(data, "test_log.csv"))
        if steps != [2.0 * spu, 4.0 * spu] or len(tests) != 1 \
                or float(tests[0]["step"]) != 4.0 * spu:
            raise AssertionError(f"cli train: log rows at {steps}, "
                                 f"{len(tests)} test rows")
        if sorted(os.listdir(os.path.join(base, "model"))) != sorted(
                f"checkpoint_{k * spu}.pt" for k in (2, 4, 5)):
            raise AssertionError("cli train: checkpoints "
                                 f"{os.listdir(os.path.join(base, 'model'))}")
        for r in rows + tests:
            if not all(torch.isfinite(torch.tensor(float(v)))
                       for v in r.values()):
                raise AssertionError(f"cli train: non-finite log row {r}")
        # on a card each row carries every span's mean (utils/spans.py)
        spans = {k: float(v) for k, v in rows[-1].items()
                 if k.startswith("span/")}
        if not {"span/update_ms", "span/env_ms", "span/launch_ms"} <= set(
                spans) or not spans["span/update_ms"] > 0:
            raise AssertionError(f"cli train: span columns {spans}")
        log(f"cli train: the last row's spans (ms) {json.dumps(spans)}")
        log(f"cli train: {n_upd} updates with one test of {n_test_seeds} "
            f"episodes in {wall:.2f} s; logged env-steps/s "
            f"{[float(r['env_steps_per_s']) for r in rows]}; test "
            f"episode_return {float(tests[0]['episode_return']):.2f} on {card}")

        bigger = write_ini(os.path.join(d, "second"), 2 * n_upd * spu)
        wall = timed_cli(
            "cli train --restore",
            ["--base-dir", base, "train", "--config-dir", bigger,
             "--restore"], 2 * (T + 1), 2 * T, 2 * T)
        after = [float(r["step"])
                 for r in csv_rows(os.path.join(data, "train_log.csv"))]
        new = after[len(steps):]
        if not new or min(new) <= n_upd * spu or max(new) != 2 * n_upd * spu:
            raise AssertionError(f"cli train --restore: rows {after}: not "
                                 "resumed past the checkpointed step")
        log(f"cli train --restore: resumed at step {n_upd * spu}, new log "
            f"rows at {new}, {wall:.2f} s on {card}")

        wall = timed_cli(
            "cli evaluate",
            ["--base-dir", base, "evaluate", "--evaluation-seeds", "2000"],
            horizon, 0, horizon)
        require_files("cli evaluate", eva, [
            "eval_log.csv", "episode_seed2000.csv",
            "real_net_ma2c_nc_traffic.csv", "real_net_ma2c_nc_control.csv",
            "real_net_ma2c_nc_trip.csv"])
        row = csv_rows(os.path.join(eva, "eval_log.csv"))[0]
        n_ctrl = len(csv_rows(os.path.join(
            eva, "real_net_ma2c_nc_control.csv")))
        if float(row["episode_len"]) != horizon or n_ctrl != horizon * 28 \
                or not abs(float(row["episode_return"])) < float("inf"):
            raise AssertionError(f"cli evaluate: {row}, {n_ctrl} control "
                                 "rows")
        log(f"cli evaluate: one sampled episode of {horizon} steps from the "
            f"checkpoint, return {float(row['episode_return']):.2f}, "
            f"{wall:.2f} s with its csv files on {card}")

        wall = timed_cli(
            "cli evaluate --naive",
            ["--base-dir", base, "evaluate", "--naive"], 0, 0,
            3 * horizon)     # the default seeds 2000, 2500, 3000
        require_files("cli evaluate --naive", eva, [
            f"real_net_greedy_{k}.csv" for k in ("traffic", "control",
                                                 "trip")])
        naive = csv_rows(os.path.join(eva, "eval_log.csv"))[1:]
        log(f"cli evaluate --naive: {len(naive)} controller episodes, "
            f"returns {[round(float(r['episode_return']), 2) for r in naive]}"
            f", {wall:.2f} s on {card}")

        # the Trainer's own cost: the same 5 updates with the time inside
        # init_state (once a run), train_step (synchronised) and checkpoint
        # saves read apart
        cfg = load_config(ini)
        env = init_env(cfg)
        fns = init_agent(env, cfg)
        spent = {"init_state": 0.0, "train_step": 0.0, "save": 0.0}

        def timed(name, fn):
            def wrapper(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                return out
            return wrapper
        trainer = Trainer(fns._replace(
            init_state=timed("init_state", fns.init_state),
            train_step=timed("train_step", fns.train_step)), cfg,
            os.path.join(d, "run2"), seed=cfg.env.seed, in_train_test=False)
        trainer.ckpt.save = timed("save", trainer.ckpt.save)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outside = wall - sum(spent.values())
        log("trainer " + json.dumps({
            "updates": n_upd, "wall_s": wall,
            "init_state_s": spent["init_state"],
            "train_step_s": spent["train_step"],
            "checkpoint_save_s": spent["save"], "outside_s": outside,
            "outside_per_update_ms": outside / n_upd * 1e3,
            "outside_share": outside / (wall - spent["init_state"]),
            "card": card}))

        ckpt = trainer.ckpt
        path = os.path.join(ckpt.path, f"checkpoint_{ts.step}.pt")
        t0 = time.perf_counter()
        ckpt.save(ts.step, ts)          # the wrapper synchronises
        save_s = time.perf_counter() - t0
        like = fns.init_state(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = ckpt.restore(like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = ckpt.restore_params(like.params)
        torch.cuda.synchronize()
        restore_params_s = time.perf_counter() - t0
        same = lambda xs, ys: all(
            a.device == b.device and a.dtype == b.dtype
            and torch.equal(a, b) for a, b in zip(xs, ys))
        if not (same(tree_leaves(params), tree_leaves(ts.params))
                and same(tree_leaves(back.params), tree_leaves(ts.params))
                and same(back.opt_state.ms, ts.opt_state.ms)
                and same(list(back.env_state) + [back.obs, back.carry.h],
                         list(ts.env_state) + [ts.obs, ts.carry.h])
                and torch.equal(back.generator.get_state(),
                                ts.generator.get_state())
                and back.step == ts.step == n_upd * spu):
            raise AssertionError("checkpoint: the restored state differs "
                                 "from the trainer's final state")
        log("checkpoint " + json.dumps({
            "bytes": os.path.getsize(path), "save_s": save_s,
            "restore_s": restore_s, "restore_params_s": restore_params_s,
            "restored_equals_final_state": True, "card": card}))


GRID_BAR = ("hyst_queue_d3", -140360.484375)  # results/grid_families_r3.jsonl


def run_scripts(card: str):
    """The learning and evaluation harnesses (``deeprl_network_tpu_torch/
    scripts/``): the hand-controller sweep on the 5x5 grid at 720 steps
    (each form held to the CPU port over 120 steps, the grid's bar to the
    JAX row), then ``train_cacc_families`` (MA2C_DIAL) and ``train_atsc``
    (3x3 grid, with ``--ckpt``) for 2 updates at B=8, their rows' keys held
    to the JAX scripts' and their launches counted; returns those
    counts."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.config import ModelConfig, TrainConfig
    from deeprl_network_tpu_torch.scripts import (
        train_atsc, train_cacc_families,
    )
    from deeprl_network_tpu_torch.scripts._harness import check_rows
    from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
    from deeprl_network_tpu_torch.utils.rollout import make_a2c
    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    seeds = train_atsc.EVAL_SEEDS

    def grid(device):
        return train_atsc.build_env("grid", "ma2c_nc", 8.0, 10,
                                    device=device)[0]

    zero_counts()
    t0 = time.perf_counter()
    sweep = train_atsc.greedy_returns(grid("cuda"), seeds, 720)
    sweep_s = time.perf_counter() - t0
    # one env step a control step for the whole sweep's rows
    expect_counts("scripts greedy_returns", 0, 0, "general", 720)
    head_gpu = train_atsc.greedy_returns(grid("cuda"), seeds, 120)
    head_cpu = train_atsc.greedy_returns(grid("cpu"), seeds, 120)
    for form, rets in head_cpu.items():
        for a, b in zip(head_gpu[form], rets):
            if not abs(a - b) <= 1e-5 * abs(b):
                raise AssertionError(f"scripts greedy_returns {form}: "
                                     f"{a} on the card vs {b} on the CPU "
                                     "over 120 steps")
    form, want = GRID_BAR
    got = float(np.mean(sweep[form]))
    if not abs(got - want) <= 1e-4 * abs(want):
        raise AssertionError(f"scripts greedy_returns {form}: {got} vs the "
                             f"JAX row {want}")
    log("scripts greedy_returns 5x5 " + json.dumps({
        "means": {k: float(np.mean(v)) for k, v in sweep.items()},
        "seconds": sweep_s, "card": card}))

    def jsonl(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    B, T = 8, 120
    steps = 2 * T * B
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "cacc.jsonl")
        zero_counts()
        t0 = time.perf_counter()
        train_cacc_families.main(
            ["--agents", "ma2c_dial", "--seeds", "0", "--steps", str(steps),
             "--num-envs", str(B), "--out", out])
        torch.cuda.synchronize()
        cacc_s = time.perf_counter() - t0
        # 2 updates (one graph: the wrappers count its warm-up and capture,
        # two updates' worth), then 3 sampled eval episodes of 600 steps
        # (which step the env without auto-reset, so without its kernel)
        launches = {"scripts train_cacc_families": expect_counts(
            "scripts train_cacc_families", 2 * (T + 1) + 3 * 600, 2 * T,
            "general", 0, cacc=2 * T)}
        rows = jsonl(out)
        check_rows("train_cacc_families", rows,
                   os.path.join(root, "scripts", "train_cacc_families.py"))
        final = rows[-1]
        if not (final.get("final") and all(np.isfinite(
                [final["eval_return"], final["eval_episode_len"]]))):
            raise AssertionError(f"scripts train_cacc_families: {final}")

        out, ckpt = os.path.join(d, "atsc.jsonl"), os.path.join(d, "ckpt")
        zero_counts()
        t0 = time.perf_counter()
        train_atsc.main(["--grid-size", "3", "--steps", str(steps),
                         "--num-envs", str(B), "--out", out, "--ckpt", ckpt])
        torch.cuda.synchronize()
        atsc_s = time.perf_counter() - t0
        # 2 updates (one graph's warm-up and capture), then 3 sampled and 3
        # argmax eval episodes of 720 steps and the hand-controller sweep
        # (720 env steps)
        launches["scripts train_atsc"] = expect_counts(
            "scripts train_atsc", 2 * (T + 1) + 6 * 720, 2 * T, "general",
            2 * T + 7 * 720)
        rows = jsonl(out)
        check_rows("train_atsc", rows,
                   os.path.join(root, "scripts", "train_atsc.py"))
        env3, _ = train_atsc.build_env("grid", "ma2c_nc", 8.0, 10,
                                       grid_size=3, device="cuda")
        fns = make_a2c(env3, ModelConfig(batch_size=T, num_envs=B),
                       TrainConfig(total_step=steps), agent="ma2c_nc")
        like = fns.init_state(1)
        back = CheckpointManager(os.path.join(ckpt, "seed0")).restore(like)
        if back.step != steps or back.params.w_obs.w.device.type != "cuda" \
                or torch.equal(back.params.w_obs.w, like.params.w_obs.w):
            raise AssertionError("scripts train_atsc: --ckpt did not "
                                 "restore the trained state")
        final = rows[-1]
    log("scripts harnesses " + json.dumps({
        "train_cacc_families_s": cacc_s, "train_atsc_s": atsc_s,
        "train_atsc_final": {k: final[k] for k in (
            "mean", "mean_argmax", "baseline_best", "beats_greedy")},
        "phase_s": time.perf_counter() - t_phase, "card": card}))
    return launches


def run_agents(card: str):
    """The reference-style host loop (``tests/test_agents_compat.py``) with
    the compat ``MA2C_NC`` class on the platoon, on the card: one forward
    launch per ``forward``, ``n_step`` + ``n_step`` per ``backward``."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig
    from deeprl_network_tpu_torch.envs.cacc import CACCEnv
    from deeprl_network_tpu_torch.models.agents import MA2C_NC
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    env = CACCEnv(EnvConfig(scenario="cacc_catchup", coop_gamma=0.9,
                            episode_length=30))
    n_step = 10
    model = MA2C_NC(env.n_s_ls, env.n_a_ls, env.neighbor_mask,
                    env.distance_mask, env.coop_gamma, total_step=1000,
                    model_config=ModelConfig(batch_size=n_step,
                                             reward_norm=1000.0), seed=0)
    if model.device.type != "cuda" or model.spec.n_lstm != 64:
        raise AssertionError("agents: not on the card at full width")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, ob = env.reset(1, gen)
    done = True
    p0 = [p.clone() for p in tree_leaves(model.params)]
    t0 = time.perf_counter()
    for batch in range(2):
        for _ in range(n_step):
            zero_counts()
            action = model.forward(ob[0].cpu().numpy(), done)
            expect_counts("agents forward", 1, 0, "general", 0)
            state, ob, reward, d, _ = env.step(
                state, torch.as_tensor(action, device="cuda")[None])
            done = bool(d[0])
            model.add_transition(ob[0].cpu().numpy(), action,
                                 reward[0].cpu().numpy(), None, float(done))
            if done:
                state, ob = env.reset(1, gen)
        zero_counts()
        R = model.forward(ob[0].cpu().numpy(), done, out_type="v")
        expect_counts("agents forward v", 1, 0, "general", 0)
        if done:
            R = np.zeros_like(R)
        zero_counts()
        stats = model.backward(R)
        expect_counts("agents backward", n_step, n_step, "general", 0)
        if not all(np.isfinite(v) for v in stats.values()):
            raise AssertionError(f"agents: stats {stats}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if all(torch.equal(a, b) for a, b in zip(tree_leaves(model.params), p0)):
        raise AssertionError("agents: params did not change")
    log(f"agents: MA2C_NC compat loop, 2 batches of {n_step} steps on the "
        f"platoon (B=1, N=8, 64/64, f32): 1 launch per forward, {n_step} + "
        f"{n_step} per backward, general variant; stats {stats}; "
        f"{wall:.3f} s on {card}")


def run_surface(card: str):
    """The port's import surface (the JAX package's ``__init__`` names) and
    the single-env ``policy_step`` at the flagship width (grid-25, 64/64,
    f32): one general forward launch, bit-equal to ``policy_step_batched``
    at B=1 on the card and within 1e-5 of the CPU port's ``policy_step``;
    then ``graft_entry.entry()`` once. Returns the policy_step's counts."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig
    from deeprl_network_tpu_torch.envs import CACCEnv, Env, EnvSpec  # noqa: F401
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.graft_entry import entry
    from deeprl_network_tpu_torch.models import (  # noqa: F401
        Carry, TF1RMSProp, a2c_loss, fc_apply, init_policy_params,
        mask_comm_params, one_hot, policy_step, tf1_rmsprop,
    )
    from deeprl_network_tpu_torch.models.policies import (
        policy_consts, policy_step_batched, tree_map,
    )
    from deeprl_network_tpu_torch.ops import fused_agent_lstm  # noqa: F401
    from deeprl_network_tpu_torch.parallel import (  # noqa: F401
        ParallelA2C, make_parallel_a2c, maybe_initialize,
    )
    from deeprl_network_tpu_torch.utils import Scheduler, make_schedule
    from deeprl_network_tpu_torch.utils.rollout import make_policy_spec
    if Scheduler("linear", 1.0, 10).get(5) != make_schedule(
            "linear", 1.0, 10)(5):
        raise AssertionError("surface: Scheduler.get differs")
    env = LargeGridEnv(EnvConfig(scenario="large_grid", coop_gamma=0.9),
                       device="cpu")
    spec = make_policy_spec(env.spec, ModelConfig(num_fc=64, num_lstm=64),
                            "ma2c_nc")
    params = {"cpu": mask_comm_params(spec, init_policy_params(
        torch.Generator().manual_seed(0), spec))}
    params["cuda"] = tree_map(lambda t: t.cuda(), params["cpu"])
    rng = np.random.default_rng(0)
    n, H = spec.n_agent, spec.n_lstm
    arr = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    fp = rng.random((n, spec.n_a_max)).astype(np.float32)
    host = dict(c=arr(n, H) * 0.5, h=arr(n, H) * 0.5,
                obs=arr(n, spec.n_s_max), fp=fp / fp.sum(-1, keepdims=True))
    worst, counts = 0.0, None
    for done in (0.0, 1.0):
        outs = {}
        for dev in ("cpu", "cuda"):
            t = {k: torch.tensor(v, device=dev) for k, v in host.items()}
            consts = policy_consts(spec, dev)
            args = (Carry(t["c"], t["h"]), t["obs"], t["fp"],
                    torch.tensor(done, device=dev))
            if dev == "cuda":
                zero_counts()
            outs[dev] = policy_step(spec, params[dev], *args, consts)
            if dev == "cpu":
                continue
            torch.cuda.synchronize()
            counts = expect_counts("surface policy_step", 1, 0, "general",
                                   0)
            bc, blo, bv = policy_step_batched(
                spec, params[dev], Carry(t["c"][None], t["h"][None]),
                t["obs"][None], t["fp"][None], args[3].reshape(1), consts)
            sc, slo, sv = outs[dev]
            for a, b in ((sc.c, bc.c[0]), (sc.h, bc.h[0]), (slo, blo[0]),
                         (sv, bv[0])):
                if not torch.equal(a, b):
                    raise AssertionError("surface: policy_step differs from "
                                         "policy_step_batched at B=1")
        got = [outs["cuda"][0].c, outs["cuda"][0].h, outs["cuda"][1],
               outs["cuda"][2]]
        want = [outs["cpu"][0].c, outs["cpu"][0].h, outs["cpu"][1],
                outs["cpu"][2]]
        worst = max(worst, max_err([g.cpu() for g in got], want, 1e-5,
                                   "c,h,logits,values"))
    fn, fargs = entry()
    zero_counts()
    carry, logits, values = fn(*fargs)
    torch.cuda.synchronize()
    expect_counts("surface entry", 1, 0, "general", 0)
    if (tuple(carry.h.shape) != (n, H) or tuple(logits.shape) != (
            n, spec.n_a_max) or tuple(values.shape) != (n,)
            or not torch.isfinite(logits).all()):
        raise AssertionError("surface: entry() gave "
                             f"{tuple(carry.h.shape)}, {tuple(logits.shape)}, "
                             f"{tuple(values.shape)}")
    log(f"surface: the JAX package's re-exported names import from the "
        f"port; policy_step (grid-25, 64/64, f32, done 0 and 1) on the card: "
        f"1 general forward launch, bit-equal to policy_step_batched at B=1, "
        f"max abs diff {worst:.2e} against the CPU port; entry() gave "
        f"{tuple(carry.h.shape)} / {tuple(logits.shape)} / "
        f"{tuple(values.shape)} on {card}")
    return counts


def parallel_rate(results, T: int) -> float:
    """Global env-steps/s of a worker run over its updates after the first
    (a warm-up): the ranks wait for each other every update, so the slowest
    rank's time is the run's."""
    B = results[0]["envs"] * len(results)
    slowest = max(sum(r["update_s"][1:]) for r in results)
    return (len(results[0]["update_s"]) - 1) * T * B / slowest


def check_rank_results(what, results, n_updates, fwd, bwd, variant, T, env,
                       embed=False, cacc=0):
    """Each rank's launch counts (``fwd`` + ``bwd`` an update, all of
    ``variant``, the comm embedding's as many with ``embed``, ``env`` ATSC
    and ``cacc`` platoon env steps) and gradient all-reduces, as the
    wrappers count them: every update's eagerly, the graph's warm-up and
    capture (two updates' worth) under ``jit``; finite loss, global step,
    and params equal across ranks."""
    import math
    B = results[0]["envs"] * len(results)
    for r in results:
        n = 2 if r["jit"] else n_updates
        want = {"lstm_cell_fwd": fwd * n, f"lstm_cell_fwd_{variant}": fwd * n,
                "lstm_cell_bwd": bwd * n, f"lstm_cell_bwd_{variant}": bwd * n}
        if env:
            want["network_env_step"] = env * n
        if cacc:
            want["cacc_env_step"] = cacc * n
        if embed:
            want.update(comm_embed_fwd=fwd * n, comm_embed_bwd=bwd * n)
        if r["launches"] != want:
            raise AssertionError(f"{what} rank {r['rank']}: kernel launches "
                                 f"{r['launches']}, expected {want}")
        if not all(math.isfinite(m["loss"]) for m in r["metrics"]):
            raise AssertionError(f"{what} rank {r['rank']}: non-finite loss")
        if r["step"] != n_updates * T * B or r["allreduce"]["calls"] != n:
            raise AssertionError(f"{what} rank {r['rank']}: step "
                                 f"{r['step']}, {r['allreduce']['calls']} "
                                 f"all-reduces issued or captured in "
                                 f"{n_updates} updates (jit {r['jit']})")
    if len({r["params_sha256"] for r in results}) != 1:
        raise AssertionError(f"{what}: params differ across ranks")
    return results[0]["launches"]


def run_other(card: str):
    """Data-parallel training in worker processes on the one card: the NCCL
    path at world size 1, two gloo ranks against one process on the combined
    batch, the flagship at 2 ranks, and the dry run. Returns the launch
    counts of rank 0 by run."""
    import numpy as np
    import torch
    from deeprl_network_tpu_torch.config import (
        EnvConfig, ModelConfig, TrainConfig,
    )
    from deeprl_network_tpu_torch.envs.cacc import CACCEnv
    from deeprl_network_tpu_torch.graft_entry import dryrun_multichip
    from deeprl_network_tpu_torch.models.policies import tree_leaves
    from deeprl_network_tpu_torch.parallel.smoke_worker import run_ranks
    from deeprl_network_tpu_torch.utils.rollout import make_a2c
    T = 120
    flagship = dict(agent="ma2c_nc",
                    env=dict(scenario="large_grid", coop_gamma=0.9),
                    model=dict(batch_size=T, num_envs=768,
                               compute_dtype="bfloat16", sparse_comm=True,
                               remat=True),
                    train=dict(total_step=1_000_000), updates=3)
    launches, rates = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for what, n, backend in (("parallel nccl 1 rank", 1, "nccl"),
                                 ("parallel gloo 2 ranks", 2, "gloo")):
            t0 = time.perf_counter()
            res = run_ranks(n, flagship, os.path.join(d, backend),
                            device="cuda", backend=backend, timeout=600)
            wall = time.perf_counter() - t0
            # a warm-up and 2 timed updates; every launch takes the tc
            # variant: rollout, bootstrap and remat recompute, T backward
            launches[what] = check_rank_results(what, res, 3, 2 * T + 1, T,
                                                "tc", T, T, embed=True)
            if {r["backend"] for r in res} != {backend}:
                raise AssertionError(f"{what}: backend {res[0]['backend']}")
            rates[what] = parallel_rate(res, T)
            log(what + " " + json.dumps({
                "ranks": n, "envs_a_rank": res[0]["envs"],
                "env_steps_per_s": rates[what],
                "update_s": {r["rank"]: r["update_s"] for r in res},
                "loss": res[0]["metrics"][-1]["loss"],
                "jit": res[0]["jit"],
                "launches_issued_or_captured_a_rank": res[0]["launches"],
                "grad_allreduce": res[0]["allreduce"],
                "wall_s_with_process_start": wall, "card": card}))

        # (a) 2 gloo ranks against one process on the combined batch
        env_kw = dict(scenario="cacc_catchup", coop_gamma=0.9,
                      episode_length=40)
        model = dict(batch_size=8, num_envs=4, num_fc=16, num_lstm=16,
                     compute_dtype="float32")
        small = dict(agent="ma2c_nc", env=env_kw, model=model, updates=2,
                     seed=7)
        res = run_ranks(2, small, os.path.join(d, "small"), device="cuda",
                        backend="gloo", timeout=600)
        what = "parallel cacc 2 ranks"
        launches[what] = check_rank_results(what, res, 2, 9, 8, "general", 8,
                                            0, cacc=8)
        env = CACCEnv(EnvConfig(**env_kw), device="cuda")
        # eager: the wrapped step must see every update's actions, and
        # under a graph it runs only while the update is captured
        fns = make_a2c(env, ModelConfig(**model),
                       TrainConfig(total_step=10_000), agent="ma2c_nc",
                       jit=False, device="cuda")
        actions, step = [], env.step

        def recording_step(state, action):
            actions.append(action.to(torch.uint8))
            return step(state, action)
        env.step = recording_step
        ts = fns.init_state(7)
        for _ in range(2):
            ts, m = fns.train_step(ts)
        rows = [np.load(r["npz"]) for r in res]
        if not (np.array_equal(np.concatenate([z["actions"] for z in rows],
                                              axis=1),
                               torch.stack(actions).cpu().numpy())
                and np.array_equal(np.concatenate([z["obs0"] for z in rows]),
                                   ts.obs.cpu().numpy())):
            raise AssertionError(f"{what}: actions or obs differ from one "
                                 "process on the combined batch")
        worst = max(float(np.abs(z[f"p{i}"] - p.cpu().numpy()).max())
                    for z in rows for i, p in enumerate(tree_leaves(ts.params)))
        if worst > 1e-4:
            raise AssertionError(f"{what}: params differ from one process "
                                 f"by {worst}")
        log(f"{what}: 2 f32 updates of 2 gloo ranks x 2 envs sharing the "
            f"card equal one process on 4 envs (actions and obs exact, max "
            f"param diff {worst:.2e}, loss {res[0]['metrics'][-1]['loss']:.6f}"
            f" vs {float(m['loss']):.6f})")

    t0 = time.perf_counter()
    dryrun_multichip(2)
    log(f"parallel: dryrun_multichip(2) {time.perf_counter() - t0:.1f} s; "
        f"flagship env-steps/s 1 rank (NCCL) "
        f"{rates['parallel nccl 1 rank']:.1f}, 2 gloo ranks sharing the card "
        f"{rates['parallel gloo 2 ranks']:.1f} on {card}: the cross-process "
        f"path on one card, not scaling")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    # the message head's nvcc alone (the parallel build's times all run
    # from one start)
    os.remove(_build.lib_path("dial_head"))
    head_build_s = _build.build(["dial_head"])["dial_head"]
    log(f"build: dial_head alone {head_build_s:.1f} s")

    entries = check_kernels()
    env_entry = check_env_kernel(card)
    cacc_env_entry = check_cacc_env_kernel(card)
    embed_entries = check_comm_embed(card)
    head_entries = check_dial_head(card, head_build_s)
    if args.tune:
        tune_kernels()
    if args.kernels_only:
        return 2
    check_reference("reference", small_grid, 5)
    check_wide_reference()
    launches, sps, fns, ts = run_main_path(card)
    graph_launches = run_graph(card)
    bench_launches = run_bench(card)
    grid_params = ts.params
    del ts
    dial_counts = run_families(card)
    replay_launches = check_replay()
    cacc, cacc_launches = run_cacc(card)
    eval_launches = check_eval_record(
        "eval/record grid", fns, make_flagship("cpu"), grid_params, 120, 720,
        card, True, embed=True)
    cacc_fns, cacc_ts = cacc[CACC_CONFIGS[0]]
    # initial noise off: the CPU's and the card's generators differ
    quiet = dict(init_noise_h=0.0, init_noise_v=0.0)
    check_eval_record(
        "eval/record cacc", make_cacc(CACC_CONFIGS[0], "cuda", env_kw=quiet),
        make_cacc(CACC_CONFIGS[0], "cpu", env_kw=quiet), cacc_ts.params, 200,
        600, card, False)
    zero_counts()
    out = cacc_fns.eval_episode(cacc_ts.params, 0)
    expect_counts("eval cacc with initial noise", 600, 0, "general", 0)
    log(f"eval cacc with initial noise: return "
        f"{float(out['episode_return']):.4f} over "
        f"{float(out['episode_len']):.0f} steps")
    del fns, grid_params, cacc, cacc_fns, cacc_ts
    torch.cuda.empty_cache()
    monaco_launches = run_monaco(card)
    run_cli(card)
    scripts_launches = run_scripts(card)
    run_agents(card)
    surface_launches = run_surface(card)
    parallel_launches = run_other(card)

    sources = {"": "deeprl_network_tpu_torch/ops/csrc/lstm_cell_tc.cu",
               "_general": "deeprl_network_tpu_torch/ops/csrc/lstm_cell.cu"}
    replaces = {"lstm_cell_fwd": "deeprl_network_tpu/ops/pallas_lstm.py:108",
                "lstm_cell_bwd": "deeprl_network_tpu/ops/pallas_lstm.py:233"}
    # ``launches`` and ``launches_by_path``: the wrappers' counts, launches
    # issued or captured into a CUDA graph; ``device_launches`` and
    # ``device_launches_by_path``: the kernels that ran on the card, counted
    # by name under the profiler (``on_card``), where a path was traced
    kernels = []
    for name, e in entries.items():
        base = name.replace("_general", "")
        # the flagship run's counts for the tensor-core kernels, the first
        # platoon run's for the general ones
        general = name.endswith("_general")
        main_run = cacc_launches if general else launches
        monaco_run = monaco_launches[
            "monaco ini" if general else "monaco b768"]
        n_other = {k: v[base] for k, v in parallel_launches.items()
                   if v.get(f"{base}_{'general' if general else 'tc'}")}
        ran = {"cacc ini" if general else "flagship": main_run["ran"][name],
               "monaco ini" if general else "monaco b768":
                   monaco_run["ran"][base]}
        if not general:
            n_other["bench"] = bench_launches[base]
            n_other["graph flagship"] = graph_launches["issued"][base]
            ran["graph flagship"] = graph_launches["ran"][base]
        if general and surface_launches[base]:
            n_other["surface policy_step"] = surface_launches[base]
        if general:
            n_other.update({k: v[base] for k, v in scripts_launches.items()})
        issued = {"cacc ini" if general else "flagship":
                      main_run["issued"][name],
                  "monaco ini" if general else "monaco b768":
                      monaco_run["issued"][base], **n_other}
        if min(issued.values()) <= 0 or min(ran.values()) <= 0 \
                or not n_other:
            raise AssertionError(f"{name} was not launched on its paths")
        kernels.append(dict(
            name=name, route="cuda", source=sources[name[len(base):]],
            replaces=replaces[base], launches=main_run["issued"][name],
            device_launches=main_run["ran"][name],
            max_abs_err=e["max_abs_err"], ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=None,
            launches_by_path=issued, device_launches_by_path=ran))
    # the env kernel: the flagship run's count, and every other path's
    env = "network_env_step"
    env_paths = {"flagship": launches["issued"][env],
                 "bench": bench_launches[env],
                 "graph flagship": graph_launches["issued"][env],
                 **{k: v["issued"][env] for k, v in monaco_launches.items()},
                 "scripts train_atsc":
                     scripts_launches["scripts train_atsc"][env],
                 **{k: v[env] for k, v in parallel_launches.items()
                    if env in v}}
    env_ran = {"flagship": launches["ran"][env],
               "graph flagship": graph_launches["ran"][env],
               **{k: v["ran"][env] for k, v in monaco_launches.items()}}
    if min(env_paths.values()) <= 0 or len(env_paths) < 7 \
            or min(env_ran.values()) <= 0:
        raise AssertionError(f"{env} was not launched on its paths: "
                             f"{env_paths}, on the card {env_ran}")
    kernels.append(dict(
        name=env, route="cuda", source=ENV_SOURCE, replaces=ENV_REPLACES,
        launches=env_paths["flagship"], device_launches=env_ran["flagship"],
        library_ms=None, launches_by_path=env_paths,
        device_launches_by_path=env_ran, **env_entry))
    # the platoon's env kernel: the platoon files' counts and the other
    # paths that train the platoon
    cacc_env = "cacc_env_step"
    cacc_paths = {"cacc ini": cacc_launches["issued"][cacc_env],
                  "scripts train_cacc_families": scripts_launches[
                      "scripts train_cacc_families"][cacc_env],
                  **{k: v[cacc_env] for k, v in parallel_launches.items()
                     if cacc_env in v}}
    cacc_ran = {"cacc ini": cacc_launches["ran"][cacc_env]}
    if min(cacc_paths.values()) <= 0 or len(cacc_paths) < 3 \
            or min(cacc_ran.values()) <= 0:
        raise AssertionError(f"{cacc_env} was not launched on its paths: "
                             f"{cacc_paths}, on the card {cacc_ran}")
    kernels.append(dict(
        name=cacc_env, route="cuda", source=CACC_ENV_SOURCE,
        replaces=CACC_ENV_REPLACES, launches=cacc_paths["cacc ini"],
        device_launches=cacc_ran["cacc ini"], library_ms=None,
        launches_by_path=cacc_paths, device_launches_by_path=cacc_ran,
        **cacc_env_entry))
    # the comm embedding: the flagship's counts and every other packed
    # MA2C_NC path's (the general kernels, counted under the same keys: a
    # grid eval episode at B=1 and the small f32 updates of the replay check)
    for name, e in embed_entries.items():
        if name.endswith("_general"):
            key = name[:-len("_general")]
            general = {"eval grid episode": eval_launches, **replay_launches}
            paths = {k: v[key] for k, v in general.items() if v[key]}
            ran = {}
        else:
            b768 = monaco_launches["monaco b768"]
            paths = {"flagship": launches["issued"][name],
                     "bench": bench_launches[name],
                     "graph flagship": graph_launches["issued"][name],
                     "monaco b768": b768["issued"][name],
                     **{k: v[name] for k, v in parallel_launches.items()
                        if v.get(name)}}
            ran = {"flagship": launches["ran"][name],
                   "graph flagship": graph_launches["ran"][name],
                   "monaco b768": b768["ran"][name]}
        if not paths or min(paths.values()) <= 0 \
                or min(ran.values(), default=1) <= 0:
            raise AssertionError(f"{name} was not launched on its paths: "
                                 f"{paths}, on the card {ran}")
        kernels.append(dict(
            name=name, route="cuda", source=EMBED_SOURCE,
            replaces=EMBED_REPLACES, launches=next(iter(paths.values())),
            device_launches=ran.get("flagship"), launches_by_path=paths,
            device_launches_by_path=ran, **e))
    # DIAL's message head: the DIAL flagship's counts (the families phase)
    for name, e in head_entries.items():
        if name.endswith("_general"):
            continue
        paths = {"families ma2c_dial": dial_counts["issued"][name]}
        ran = {"families ma2c_dial": dial_counts["ran"][name]}
        if min(paths.values()) <= 0 or min(ran.values()) <= 0:
            raise AssertionError(f"{name} was not launched on its paths: "
                                 f"{paths}, on the card {ran}")
        kernels.append(dict(
            name=name, route="cuda", source=HEAD_SOURCE,
            replaces=HEAD_REPLACES, launches=paths["families ma2c_dial"],
            device_launches=ran["families ma2c_dial"],
            launches_by_path=paths, device_launches_by_path=ran, **e))
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
