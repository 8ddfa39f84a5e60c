"""Apportion the fused train-step cost on the card (the counterpart of the
JAX repo's ``scripts/profile_step.py``).

Times, at the flagship grid shape, program variants whose deltas isolate
where an update's time goes:

  full_ma2c_nc : fused MA2C_NC train step (rollout + BPTT + update)
  ia2c         : the same without the comm einsums (isolates the NeurComm
                 message cost)
  env_span     : on a CUDA device, the ``env`` span of ``full_ma2c_nc``'s
                 timed updates (``fns.spans``: the env's step with
                 auto-reset inside the graphed update, from its sampled
                 steps scaled to the window), the mean over the updates

On a CUDA device each train step also reports the kernels one update
launches, counted under torch.profiler. The train steps take
``make_a2c``'s default ``jit``, so an update is one replay of its CUDA
graph; the profiler reports the graph's kernels one by one.

    python -m deeprl_network_tpu_torch.scripts.profile_step --num-envs 512
    python -m deeprl_network_tpu_torch.scripts.profile_step --num-envs 768 \\
        --dtype bfloat16 --sparse-comm --remat

The last line is one JSON object of milliseconds per call by variant.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from deeprl_network_tpu_torch.bench import block_until_ready
from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.rollout import make_a2c
from deeprl_network_tpu_torch.utils.spans import mean_ms


def time_it(fn, arg, n=20, sync=lambda out: out, thread=False):
    """Seconds per call of ``fn(arg)`` over ``n`` calls after one excluded
    call; ``sync(out)`` picks the output tensor to wait for, once after the
    excluded call and once at the end. thread=True: fn's first output
    replaces arg for the next call (a TrainState in, the next one out)."""
    out = fn(arg)  # warm-up
    block_until_ready(sync(out))
    cur = out[0] if thread else arg
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(cur)
        if thread:
            cur = out[0]
    block_until_ready(sync(out))
    return (time.perf_counter() - t0) / n


def count_kernels(fn, arg):
    """(CUDA kernels launched by one ``fn(arg)``, their summed device
    seconds) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(arg)
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and ev.self_device_time_total]
    return (sum(ev.count for ev in evs),
            sum(ev.self_device_time_total for ev in evs) / 1e6)


def run(num_envs=512, t=120, dtype="float32", sparse_comm=False,
        remat=False, n=20, device="cuda"):
    """({variant: seconds per call}, {variant: (kernels, their device
    seconds) of one call}); ``env_span`` and the kernels only on a CUDA
    device."""
    dev = resolve_device(device)
    B, T = num_envs, t
    ecfg = EnvConfig(scenario="large_grid", coop_gamma=0.9)
    tcfg = TrainConfig(total_step=10**9)
    res, kernels = {}, {}

    def report(name, what, dt, fn, arg):
        line = f"{name}: {dt*1e3:.1f} {what} ({B*T/dt/1e6:.3f}M steps/s)"
        if fn is not None:
            kernels[name] = count_kernels(fn, arg)
            line += (f", {kernels[name][0]} kernels a call, "
                     f"{kernels[name][1]*1e3:.1f} ms of kernel time")
        print(line, file=sys.stderr, flush=True)

    for name, agent in (("full_ma2c_nc", "ma2c_nc"), ("ia2c", "ia2c")):
        mcfg = ModelConfig(batch_size=T, num_envs=B, compute_dtype=dtype,
                           sparse_comm=sparse_comm, remat=remat)
        env = LargeGridEnv(ecfg, device=dev)
        fns = make_a2c(env, mcfg, tcfg, agent=agent, device=dev)
        ts = fns.init_state(0)
        res[name] = time_it(fns.train_step, ts, n=n,
                            sync=lambda out: out[1]["loss"], thread=True)
        # read before the profiler counts the kernels: a trace slows every
        # later CUDA call of its process
        env = mean_ms(fns.spans.read(n)).get("env")
        cuda = dev.type == "cuda"
        report(name, "ms/update", res[name], fns.train_step if cuda else None,
               ts)
        if name == "full_ma2c_nc" and env is not None:
            res["env_span"] = env / 1e3
            report("env_span", "ms an update", res["env_span"], None, None)
        del fns, ts
    return res, kernels


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--t", type=int, default=120)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--sparse-comm", action="store_true")
    p.add_argument("--remat", action="store_true")
    args = p.parse_args(argv)
    res, _ = run(args.num_envs, args.t, args.dtype, args.sparse_comm,
                 args.remat, device=device)
    print(json.dumps({k: round(v * 1e3, 2) for k, v in res.items()}))


if __name__ == "__main__":
    main()
