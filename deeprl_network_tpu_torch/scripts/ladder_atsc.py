"""Experiment ladder (the counterpart of the JAX repo's
``scripts/ladder_atsc.py``): find a training recipe whose learned policy
beats the strongest hand controller, iterating on the fast 3x3 grid first.
All variants run one after the other in one process; rows append to
``--out`` as they come.

    python -m deeprl_network_tpu_torch.scripts.ladder_atsc --grid-size 3 \\
        --steps 100000000 --out ladder3.jsonl

``LADDER``, the flags, their defaults and the rows' keys are the JAX
script's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from deeprl_network_tpu_torch.bench import block_until_ready
from deeprl_network_tpu_torch.config import ModelConfig, TrainConfig
from deeprl_network_tpu_torch.scripts._harness import jsonl_sink
from deeprl_network_tpu_torch.scripts.train_atsc import (
    EVAL_SEEDS, best_mean, build_env, greedy_returns,
)
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.logging import resolved_recipe
from deeprl_network_tpu_torch.utils.rollout import make_a2c

# name -> (env overrides, model overrides)
LADDER = {
    # phase observability alone
    "phase": (dict(phase_in_obs=True), dict()),
    # + the halting-count channel the hand controllers score on
    "pq": (dict(phase_in_obs=True, queue_in_obs=True), dict()),
    # + immediate local switch cost (training-only shaping)
    "pq_sp2": (dict(phase_in_obs=True, queue_in_obs=True),
               dict(switch_penalty=2.0)),
    # + kickstart toward the hysteresis teacher, annealed by 50%
    "pq_kick": (dict(phase_in_obs=True, queue_in_obs=True),
                dict(kickstart_coef=1.0, kickstart_ratio=0.5)),
    # kickstart + switch penalty
    "pq_kick_sp2": (dict(phase_in_obs=True, queue_in_obs=True),
                    dict(kickstart_coef=1.0, kickstart_ratio=0.5,
                         switch_penalty=2.0)),
}


def run_variant(name, env_kw, model_kw, args, emit, baselines, device):
    """Train one ladder variant, then emit its final row against the hand
    controllers (computed once per (scenario, grid size) in
    ``baselines``)."""
    agent = model_kw.pop("agent", args.agent)
    env, ecfg = build_env(args.scenario, agent, args.clip_wave,
                          args.link_delay, grid_size=args.grid_size,
                          device=device, **env_kw)
    horizon = env.episode_steps
    mcfg = ModelConfig(batch_size=120, num_envs=args.num_envs,
                       lr_init=args.lr, lr_decay="linear",
                       entropy_coef=args.entropy,
                       entropy_decay=args.entropy_decay,
                       reward_norm=args.reward_norm, **model_kw)
    tcfg = TrainConfig(total_step=args.steps)
    emit({"variant": name, **resolved_recipe(agent, ecfg, mcfg, tcfg)})
    fns = make_a2c(env, mcfg, tcfg, agent=agent, device=device)
    spu = fns.steps_per_update
    total_updates = args.steps // spu
    log_every = max(total_updates // 10, 1)

    t0 = time.time()
    ts = fns.init_state(args.seed)
    ts, m = fns.train_step(ts)
    block_until_ready(m["loss"])
    emit({"variant": name, "compile_s": round(time.time() - t0, 1)})
    t0 = time.time()
    for i in range(1, total_updates):
        ts, m = fns.train_step(ts)
        if i % 5 == 0:
            block_until_ready(m["loss"])
        if i % log_every == 0:
            row = {"variant": name, "step": (i + 1) * spu,
                   "episode_return": round(float(m["episode_return"]), 1),
                   "entropy": round(float(m["entropy"]), 4),
                   "sps": round((i + 1) * spu / (time.time() - t0), 1)}
            if "kick_ce" in m:
                row["kick_ce"] = round(float(m["kick_ce"]), 4)
            emit(row)

    rets = [float(fns.eval_episode(ts.params, s, None,
                                   False)["episode_return"])
            for s in EVAL_SEEDS]
    rets_g = [float(fns.eval_episode(ts.params, s, None,
                                     True)["episode_return"])
              for s in EVAL_SEEDS]
    key = (args.scenario, args.grid_size)
    if key not in baselines:
        baselines[key] = greedy_returns(env, EVAL_SEEDS, horizon)
    greedy = baselines[key]
    baseline_best = best_mean(greedy)
    emit({"variant": name, "mean": float(np.mean(rets)),
          "mean_argmax": float(np.mean(rets_g)),
          "final_eval_sampled": rets, "final_eval_argmax": rets_g,
          **{"greedy_" + k: float(np.mean(v)) for k, v in greedy.items()},
          "baseline_best": baseline_best,
          "beats_greedy": bool(float(np.mean(rets)) > baseline_best),
          "beats_greedy_argmax": bool(float(np.mean(rets_g))
                                      > baseline_best)})


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--agent", default="ma2c_nc")
    p.add_argument("--scenario", default="grid")
    p.add_argument("--grid-size", type=int, default=3)
    p.add_argument("--steps", type=int, default=100_000_000)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=2.5e-3)
    p.add_argument("--entropy", type=float, default=3e-3)
    p.add_argument("--entropy-decay", default="linear")
    p.add_argument("--clip-wave", type=float, default=8.0)
    p.add_argument("--reward-norm", type=float, default=2000.0)
    p.add_argument("--link-delay", type=int, default=10)
    p.add_argument("--only", default=None,
                   help="comma list of ladder variant names to run")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    dev = resolve_device(device)
    with jsonl_sink(args.out, "a") as emit:
        emit({"ladder_run": vars(args)})
        names = (args.only.split(",") if args.only else list(LADDER))
        baselines = {}
        for name in names:
            env_kw, model_kw = LADDER[name]
            run_variant(name, dict(env_kw), dict(model_kw), args, emit,
                        baselines, dev)


if __name__ == "__main__":
    main()
