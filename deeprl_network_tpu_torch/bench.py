"""Benchmark: training throughput (env-steps/s/gpu) on the flagship
config, MA2C_NC (NeurComm) on the 25-agent 5x5 grid ATSC env, on one CUDA
card. The counterpart of the JAX package's root ``bench.py``.

    python -m deeprl_network_tpu_torch.bench

Prints ONE JSON line last:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

``vs_baseline`` compares against the same reference-style baseline as the
JAX tool: the policy forward + env dynamics executed the way the reference
executes them, a host Python loop over one env, one step at a time, numpy
math (a stand-in for the TF1 ``sess.run`` + TraCI hot loop).
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, NamedTuple

import numpy as np
import torch

from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.envs.grid import (
    LargeGridEnv, build_grid_topology,
)
from deeprl_network_tpu_torch.envs.network import TrafficNetworkEnv
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.rollout import make_a2c

METRIC = "env_steps_per_s_per_gpu_grid25_ma2c_nc"
# the config of record the JAX tool chose on a TPU (its round-4 lever
# sweep, results/bench_variants_r4.jsonl), kept as is
FLAGSHIP = dict(compute_dtype="bfloat16", sparse_comm=True, remat=True)
CHUNK = 5       # updates between synchronisations


class Measurement(NamedTuple):
    env_steps_per_s: float
    loss: float
    updates: int            # timed updates (the warm-up not counted)
    window_s: float         # host seconds of the timed updates
    warmup_s: float         # the one excluded update
    init_s: float           # init_state
    chunk_s: List[float]    # host seconds of each chunk of CHUNK updates


def make_env(scenario: str = "grid", grid_size: int = 5, device="cuda"):
    """The env ``bench.py`` picks: the CACC platoon for ``cacc*``, an
    N = grid_size^2 grid through ``build_grid_topology`` when grid_size
    is not 5, else ``LargeGridEnv``."""
    if scenario.startswith("cacc"):
        return CACCEnv(EnvConfig(scenario=scenario, coop_gamma=0.9),
                       device=device)
    ecfg = EnvConfig(scenario="large_grid", coop_gamma=0.9)
    if grid_size != 5:
        return TrafficNetworkEnv(ecfg, build_grid_topology(ecfg, grid_size),
                                 device=device)
    return LargeGridEnv(ecfg, device=device)


def block_until_ready(x: torch.Tensor) -> torch.Tensor:
    """Wait until the device that holds ``x`` has finished its queued work
    (nothing to wait for on the CPU)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def measure(seconds_budget: float = 45.0, num_envs: int = 768,
            grid_size: int = 5, scenario: str = "grid", device="cuda",
            **mcfg_overrides) -> Measurement:
    """``measure_gpu`` with the counts and times that went into the rate."""
    dev = resolve_device(device)
    mcfg = ModelConfig(batch_size=120, num_envs=num_envs, **mcfg_overrides)
    tcfg = TrainConfig(total_step=1_000_000)
    env = make_env(scenario, grid_size, dev)
    fns = make_a2c(env, mcfg, tcfg, agent="ma2c_nc", device=dev)
    t0 = time.perf_counter()
    ts = fns.init_state(0)
    block_until_ready(ts.obs)
    init_s = time.perf_counter() - t0
    print(f"init: {init_s:.2f}s", file=sys.stderr, flush=True)
    # warm-up, excluded from the rate: the first use of the kernels builds
    # them if they are not built yet, and the first train_step captures the
    # update's CUDA graph (make_a2c's jit, the default)
    t0 = time.perf_counter()
    ts, m = fns.train_step(ts)
    block_until_ready(m["loss"])
    warmup_s = time.perf_counter() - t0
    print(f"train_step warm-up: {warmup_s:.2f}s", file=sys.stderr,
          flush=True)
    # sync every chunk and nowhere else: no metric is read inside the loop,
    # and the host may run at most CHUNK updates ahead of the card
    chunk_s = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds_budget:
        tc = time.perf_counter()
        for _ in range(CHUNK):
            ts, m = fns.train_step(ts)
        block_until_ready(m["loss"])
        chunk_s.append(time.perf_counter() - tc)
    dt = time.perf_counter() - t0
    n_updates = CHUNK * len(chunk_s)
    print(f"window: {n_updates} updates in {dt:.2f}s; chunks of {CHUNK}: "
          f"first {chunk_s[0]:.3f}s, median "
          f"{float(np.median(chunk_s)):.3f}s, max {max(chunk_s):.3f}s",
          file=sys.stderr, flush=True)
    env_steps = n_updates * mcfg.batch_size * mcfg.num_envs
    return Measurement(env_steps / dt, float(m["loss"]), n_updates, dt,
                       warmup_s, init_s, chunk_s)


def measure_gpu(seconds_budget: float = 45.0, num_envs: int = 768,
                grid_size: int = 5, scenario: str = "grid", device="cuda",
                **mcfg_overrides):
    """(env-steps/s over a ``seconds_budget`` window after one warm-up
    update, the last update's loss) of MA2C_NC at T=120 and ``num_envs``
    envs; ``mcfg_overrides`` replace ModelConfig fields."""
    r = measure(seconds_budget, num_envs, grid_size, scenario, device,
                **mcfg_overrides)
    return r.env_steps_per_s, r.loss


def baseline_inputs():
    """(gather, phase_gate, demand, route) of the 5x5 grid that the
    baseline loop reads, as numpy arrays."""
    topo = build_grid_topology(EnvConfig(scenario="large_grid"))
    gather = np.stack([np.array(ls) for ls in topo.node_lanes])
    return gather, topo.phase_gate, topo.demand, topo.route


def measure_baseline(n_steps: int = 300):
    """Reference-style host loop: single env, per-step numpy policy
    forward (25 agents x (fc 12->64, LSTM 64, heads)) + env dynamics."""
    cfg = EnvConfig(scenario="large_grid")
    gather, phase_gate, demand_tab, route = baseline_inputs()
    L = route.shape[0]
    rng = np.random.RandomState(0)
    N, S, H, A = 25, 12, 64, 5
    w_in = rng.randn(N, S, H).astype(np.float32) * 0.1
    wx = rng.randn(N, H, 4 * H).astype(np.float32) * 0.1
    wh = rng.randn(N, H, 4 * H).astype(np.float32) * 0.1
    wa = rng.randn(N, H, A).astype(np.float32) * 0.1
    c = np.zeros((N, H), np.float32)
    h = np.zeros((N, H), np.float32)
    queue = np.zeros(L, np.float32)
    wait = np.zeros(L, np.float32)
    obs = np.zeros((N, S), np.float32)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    t0 = time.perf_counter()
    for t in range(n_steps):
        # policy forward, agent-by-agent like the reference graph feeds
        e = np.maximum(np.einsum("ns,nsh->nh", obs, w_in), 0.0)
        z = (np.einsum("nh,nhk->nk", e, wx)
             + np.einsum("nh,nhk->nk", h, wh))
        i, f, o, u = np.split(z, 4, axis=-1)
        c = sig(f) * c + sig(i) * np.tanh(u)
        h = sig(o) * np.tanh(c)
        logits = np.einsum("nh,nha->na", h, wa)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        actions = np.array([rng.choice(A, p=p[n]) for n in range(N)])
        # env dynamics: 5 x 1s substeps
        gate = phase_gate[np.arange(N), actions].max(0)
        demand = demand_tab[min(t, len(demand_tab) - 1)]
        for k in range(cfg.control_interval_sec):
            dq = np.minimum(queue, gate * cfg.sat_flow)
            queue = np.minimum(queue + route.T @ dq + demand - dq,
                               cfg.lane_capacity)
            wait = (wait + 1.0) * (queue > 0.1) * (dq <= 1e-4)
        obs = np.clip(queue[gather] / cfg.norm_wave, 0, cfg.clip_wave)
    return n_steps / (time.perf_counter() - t0)


def result_line(sps: float, baseline_sps: float) -> str:
    return json.dumps({
        "metric": METRIC,
        "value": round(sps, 1),
        "unit": "env-steps/s/gpu",
        "vs_baseline": round(sps / baseline_sps, 2),
    })


def main():
    baseline_sps = measure_baseline()
    print(f"baseline (reference-style host loop): {baseline_sps:.1f} "
          f"env-steps/s", file=sys.stderr)
    sps, loss = measure_gpu(num_envs=768, **FLAGSHIP)
    print(f"fused GPU train step: {sps:.1f} env-steps/s/gpu "
          f"(loss {loss:.3f})", file=sys.stderr)
    print(result_line(sps, baseline_sps))


if __name__ == "__main__":
    main()
