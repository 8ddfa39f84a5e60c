"""Grid ATSC end-to-end demo (the counterpart of the JAX repo's
``scripts/grid_demo.py``): train MA2C_NC (or any family) on the 25-agent
5x5 grid (or Monaco), then compare the learned policy against the hand
controller on held-out seeds, in one process.

    python -m deeprl_network_tpu_torch.scripts.grid_demo --agent ma2c_nc \\
        --steps 3000000

The flags, their defaults and the rows' keys are the JAX script's; rows go
to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from deeprl_network_tpu_torch.bench import block_until_ready
from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.rollout import make_a2c


def ep_stats(seq, horizon):
    """Return, mean queue and mean wait over the executed steps of one
    ``record_episode`` series."""
    alive = np.asarray(seq["alive"].cpu())
    steps = int(alive.sum())
    ret = float((np.asarray(seq["reward"].cpu()).sum(-1) * alive).sum())
    q = float(np.asarray(seq["avg_queue"].cpu())[:steps].mean())
    w = float(np.asarray(seq["avg_wait"].cpu())[:steps].mean())
    return dict(episode_return=ret, avg_queue=q, avg_wait=w)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--agent", default="ma2c_nc")
    p.add_argument("--scenario", default="large_grid",
                   choices=["large_grid", "real_net"])
    # a B-env update consumes T x B env steps: thousands of updates need
    # hundreds of millions of env steps
    p.add_argument("--steps", type=int, default=300_000_000)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    # a B-env update sees B x more data than the reference's 120-step one
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr-decay", default="constant")
    p.add_argument("--entropy-coef", type=float, default=0.01)
    # obs saturate at norm_wave * clip_wave vehicles; a wider clip lets the
    # policy rank the long queues
    p.add_argument("--clip-wave", type=float, default=2.0)
    return p.parse_args(argv)


def main(argv=None, device="cuda"):
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
    args = parse_args(argv)
    dev = resolve_device(device)
    coop = 0.9 if args.agent.startswith("ma2c") else -1.0
    ecfg = EnvConfig(scenario=args.scenario, coop_gamma=coop,
                     clip_wave=args.clip_wave)
    mcfg = ModelConfig(batch_size=120, num_envs=args.num_envs,
                       lr_init=args.lr, lr_decay=args.lr_decay,
                       entropy_coef=args.entropy_coef)
    tcfg = TrainConfig(total_step=args.steps)
    env_cls = {"large_grid": LargeGridEnv, "real_net": RealNetEnv}
    env = env_cls[args.scenario](ecfg, device=dev)
    fns = make_a2c(env, mcfg, tcfg, agent=args.agent, device=dev)

    t0 = time.time()
    ts = fns.init_state(args.seed)
    print(f"# init {time.time()-t0:.0f}s", file=sys.stderr, flush=True)
    t0 = time.time()
    ts, m = fns.train_step(ts)
    block_until_ready(m["loss"])
    print(f"# compile {time.time()-t0:.0f}s", file=sys.stderr, flush=True)

    spu = mcfg.batch_size * args.num_envs
    log_every = max(args.steps // (15 * spu), 1)
    # avoid phase-aliasing with the episode period (an ATSC episode is an
    # exact number of updates; a multiple would sample the same episode
    # phase every log)
    ep_updates = max(env.episode_steps // mcfg.batch_size, 1)
    while ep_updates > 1 and log_every > 1 and log_every % ep_updates == 0:
        log_every += 1
    i = 0
    t0 = time.time()
    while int(ts.step) < args.steps:
        ts, m = fns.train_step(ts)
        i += 1
        if i % log_every == 0:
            print(json.dumps({
                "step": int(ts.step),
                "episode_return": round(float(m["episode_return"]), 1),
                "step_reward": round(float(m["step_reward"]), 2),
                "avg_queue": round(float(m["env/avg_queue"]), 2),
                "avg_wait": round(float(m["env/avg_wait"]), 2),
                "entropy": round(float(m["entropy"]), 3),
                "sps": round(int(ts.step) / (time.time() - t0), 1),
            }), flush=True)

    # head-to-head on held-out seeds: learned (sampled) vs hand controller
    for policy, params in (("sample", ts.params), ("controller", None)):
        rows = []
        for s in (10000, 10001, 10002):
            seq = fns.record_episode(params, s, None, policy)
            rows.append(ep_stats(seq, env.episode_steps))
        avg = {k: round(float(np.mean([r[k] for r in rows])), 1)
               for k in rows[0]}
        print(json.dumps({"eval_policy": policy, **avg}), flush=True)


if __name__ == "__main__":
    main()
