"""ATSC training harness (the counterpart of the JAX repo's
``scripts/train_atsc.py``): train one (agent, scenario), log jsonl, then
evaluate sampled-policy episodes on held-out seeds against every hand
controller of the greedy/hysteresis x queue/wave sweep, all in one process.

    python -m deeprl_network_tpu_torch.scripts.train_atsc --agent ma2c_nc \\
        --scenario grid --steps 300000000 --out grid_ma2c_nc.jsonl

The flags, their defaults and the rows' keys are the JAX script's; a seed
``s`` is the int seed of ``init_state`` and of the eval episodes (the JAX
``jax.random.key(s)``). ``build_env`` and ``greedy_returns`` are shared with
``train_atsc_families`` and ``ladder_atsc``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from deeprl_network_tpu_torch.bench import block_until_ready
from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from deeprl_network_tpu_torch.scripts._harness import jsonl_sink
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.logging import resolved_recipe
from deeprl_network_tpu_torch.utils.rollout import make_a2c

EVAL_SEEDS = (10000, 10001, 10002)

# the hand-controller sweep: (name, scored on, hysteresis delta)
GREEDY_FORMS = (("queue", "queue", 0.0), ("wave", "wave", 0.0)) + tuple(
    (f"hyst_{on}_d{d:g}", on, d)
    for d in (1.0, 2.0, 3.0, 4.0) for on in ("queue", "wave"))


def build_env(scenario: str, agent: str, clip_wave: float,
              link_delay: int, phase_in_obs: bool = False,
              queue_in_obs: bool = False, grid_size: int = 5,
              hysteresis_delta: float = None, device="cuda"):
    """(env, EnvConfig) of an ATSC scenario ("grid" or "monaco"), as the JAX
    script builds them: MA2C families discount spatially
    (``coop_gamma=0.9``), IA2C and IA2C_FP take the global reward; the
    hysteresis controller of record is queue-d3 on the grid, wave-d4 on
    Monaco; a grid of ``grid_size != 5`` is ``build_grid_topology``'s."""
    from deeprl_network_tpu_torch.envs.grid import (
        LargeGridEnv, build_grid_topology,
    )
    from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
    from deeprl_network_tpu_torch.envs.network import TrafficNetworkEnv
    coop = -1.0 if agent in ("ia2c", "ia2c_fp") else 0.9
    if hysteresis_delta is None:
        hysteresis_delta = 3.0 if scenario == "grid" else 4.0
    hysteresis_on = "queue" if scenario == "grid" else "wave"
    kw = dict(coop_gamma=coop, clip_wave=clip_wave,
              link_delay_sec=link_delay, phase_in_obs=phase_in_obs,
              queue_in_obs=queue_in_obs, hysteresis_delta=hysteresis_delta,
              hysteresis_on=hysteresis_on)
    if scenario == "grid":
        ecfg = EnvConfig(scenario="large_grid", **kw)
        if grid_size != 5:
            return (TrafficNetworkEnv(ecfg, build_grid_topology(ecfg,
                                                                grid_size),
                                      device=device), ecfg)
        return LargeGridEnv(ecfg, device=device), ecfg
    ecfg = EnvConfig(scenario="real_net", **kw)
    return RealNetEnv(ecfg, device=device), ecfg


def reset_seeds(env, seeds):
    """One env row per seed, each reset from a generator seeded with it
    (the rows of a batch are then those of per-seed resets)."""
    states = [env.reset(1, torch.Generator(device=env.device)
                        .manual_seed(int(s)))[0] for s in seeds]
    return type(states[0])(*[torch.cat(xs) for xs in zip(*states)])


@torch.no_grad()
def greedy_returns(env, seeds, horizon):
    """Hand-controller baselines on the held-out seeds: greedy argmax and a
    hysteresis delta sweep, both scoring forms; {form: [return per seed]}.
    The bar a learned policy must beat is the max over every form.

    Every (form, seed) pair is one row of a single batch (rows are
    independent), so each step is one env step for the whole sweep: every
    form's controller acts on all rows, and each row takes its own form's
    action."""
    S, F = len(seeds), len(GREEDY_FORMS)
    state0 = reset_seeds(env, seeds)
    state = type(state0)(*[x.repeat((F,) + (1,) * (x.dim() - 1))
                           for x in state0])
    rows = torch.arange(F * S, device=env.device)
    form_of_row = rows // S
    rs = []
    for _ in range(horizon):
        acts = torch.stack([env.greedy_action(state, on=on, delta=d)
                            for _, on, d in GREEDY_FORMS])   # [F, F*S, N]
        state, _, r, _, _ = env.step(state, acts[form_of_row, rows])
        rs.append(r.sum(-1))
    ret = torch.stack(rs).sum(0).reshape(F, S).tolist()
    return {name: [float(x) for x in ret[f]]
            for f, (name, _, _) in enumerate(GREEDY_FORMS)}


def best_mean(greedy) -> float:
    return max(float(np.mean(v)) for v in greedy.values())


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--agent", default="ma2c_nc")
    p.add_argument("--scenario", default="grid", choices=["grid", "monaco"])
    p.add_argument("--steps", type=int, default=300_000_000)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--seeds", default="0",
                   help="comma list: all seeds run in one process")
    p.add_argument("--lr", type=float, default=2.5e-3)
    p.add_argument("--lr-decay", default="linear")
    p.add_argument("--entropy", type=float, default=3e-3)
    p.add_argument("--entropy-decay", default="constant")
    p.add_argument("--clip-wave", type=float, default=8.0)
    p.add_argument("--reward-norm", type=float, default=2000.0)
    p.add_argument("--link-delay", type=int, default=10)
    p.add_argument("--neighbor-obs", action="store_true")
    p.add_argument("--phase-in-obs", action="store_true")
    p.add_argument("--queue-in-obs", action="store_true")
    p.add_argument("--grid-size", type=int, default=5,
                   help="lattice size for scenario=grid (3 = the fast "
                        "iteration grid of the acceptance test)")
    p.add_argument("--switch-penalty", type=float, default=0.0)
    p.add_argument("--kickstart", type=float, default=0.0)
    p.add_argument("--kickstart-ratio", type=float, default=0.5)
    p.add_argument("--entropy-ratio", type=float, default=0.5)
    p.add_argument("--ckpt", default=None,
                   help="directory to save final params per seed")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    dev = resolve_device(device)
    env, ecfg = build_env(args.scenario, args.agent, args.clip_wave,
                          args.link_delay, args.phase_in_obs,
                          args.queue_in_obs, args.grid_size, device=dev)
    horizon = env.episode_steps
    mcfg = ModelConfig(batch_size=120, num_envs=args.num_envs,
                       lr_init=args.lr, lr_decay=args.lr_decay,
                       entropy_coef=args.entropy,
                       entropy_decay=args.entropy_decay,
                       entropy_ratio=args.entropy_ratio,
                       reward_norm=args.reward_norm,
                       neighbor_obs=args.neighbor_obs,
                       switch_penalty=args.switch_penalty,
                       kickstart_coef=args.kickstart,
                       kickstart_ratio=args.kickstart_ratio)
    tcfg = TrainConfig(total_step=args.steps)
    fns = make_a2c(env, mcfg, tcfg, agent=args.agent, device=dev)

    with jsonl_sink(args.out, "w") as emit:
        emit({"run": vars(args)})
        emit(resolved_recipe(args.agent, ecfg, mcfg, tcfg))
        seeds = [int(s) for s in args.seeds.split(",")]
        greedy = None
        spu = fns.steps_per_update
        total_updates = args.steps // spu
        log_every = max(total_updates // 25, 1)

        for seed in seeds:
            t0 = time.time()
            ts = fns.init_state(seed)
            ts, m = fns.train_step(ts)
            block_until_ready(m["loss"])
            print(f"seed {seed}: first step ready {time.time()-t0:.0f}s",
                  file=sys.stderr, flush=True)

            t0 = time.time()
            for i in range(1, total_updates):
                ts, m = fns.train_step(ts)
                if i % 5 == 0:
                    block_until_ready(m["loss"])
                if i % log_every == 0:
                    emit({"seed": seed, "step": (i + 1) * spu,
                          "episode_return": round(
                              float(m["episode_return"]), 1),
                          "avg_queue": round(float(m["env/avg_queue"]), 2),
                          "avg_wait": round(float(m["env/avg_wait"]), 2),
                          "entropy": round(float(m["entropy"]), 4),
                          "sps": round((i + 1) * spu / (time.time() - t0),
                                       1)})

            # final eval on held-out seeds: the headline flag uses the
            # sampled mean (the reference protocol) against the strongest
            # hand controller; argmax is a diagnostic with its own flag
            rets = [float(fns.eval_episode(ts.params, s, None,
                                           False)["episode_return"])
                    for s in EVAL_SEEDS]
            rets_g = [float(fns.eval_episode(ts.params, s, None,
                                             True)["episode_return"])
                      for s in EVAL_SEEDS]
            if greedy is None:
                greedy = greedy_returns(env, EVAL_SEEDS, horizon)
            baseline_best = best_mean(greedy)
            emit({"seed": seed, "final_eval_sampled": rets,
                  "final_eval_argmax": rets_g,
                  "mean": float(np.mean(rets)),
                  "mean_argmax": float(np.mean(rets_g)),
                  **{"greedy_" + k: v for k, v in greedy.items()},
                  "baseline_best": baseline_best,
                  "beats_greedy": bool(float(np.mean(rets)) > baseline_best),
                  "beats_greedy_argmax": bool(float(np.mean(rets_g))
                                              > baseline_best)})
            if args.ckpt:
                from deeprl_network_tpu_torch.utils.checkpoint import (
                    CheckpointManager,
                )
                CheckpointManager(f"{args.ckpt}/seed{seed}").save(
                    int(ts.step), ts)


if __name__ == "__main__":
    main()
