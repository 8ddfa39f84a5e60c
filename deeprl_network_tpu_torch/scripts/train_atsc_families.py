"""Six-family ATSC comparison (the counterpart of the JAX repo's
``scripts/train_atsc_families.py``): every algorithm family trains with the
same tuned recipe (phase + queue obs, kickstart toward the hysteresis
teacher) across seeds, then evaluates sampled episodes against the full
hand-controller bar. All (family x seed) runs go one after the other in one
process.

    python -m deeprl_network_tpu_torch.scripts.train_atsc_families \\
        --scenario grid --steps 300000000 --seeds 0,1 --out grid_families.jsonl

The flags, their defaults and the rows' keys are the JAX script's.
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


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", default="grid")
    p.add_argument("--grid-size", type=int, default=5)
    p.add_argument("--agents",
                   default="ia2c,ia2c_fp,ia2c_cu,ma2c_nc,ma2c_cnet,ma2c_dial")
    p.add_argument("--steps", type=int, default=300_000_000)
    p.add_argument("--seeds", default="0,1")
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--lr", type=float, default=2.5e-3)
    p.add_argument("--entropy", type=float, default=3e-3)
    p.add_argument("--clip-wave", type=float, default=8.0)
    p.add_argument("--reward-norm", type=float, default=2000.0)
    p.add_argument("--link-delay", type=int, default=10)
    p.add_argument("--kickstart", type=float, default=1.0)
    p.add_argument("--kickstart-ratio", type=float, default=0.5)
    p.add_argument("--consensus-masked", type=int, default=1,
                   help="1 = shape-aware IA2C_CU consensus (default), "
                        "0 = blind padded-head averaging, for A/B")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    dev = resolve_device(device)
    seeds = [int(s) for s in args.seeds.split(",")]
    greedy = None
    with jsonl_sink(args.out, "a") as emit:
        emit({"run": vars(args)})
        for agent in args.agents.split(","):
            agent = agent.strip()
            env, ecfg = build_env(args.scenario, agent, args.clip_wave,
                                  args.link_delay, phase_in_obs=True,
                                  queue_in_obs=True,
                                  grid_size=args.grid_size, device=dev)
            horizon = env.episode_steps
            mcfg = ModelConfig(batch_size=120, num_envs=args.num_envs,
                               lr_init=args.lr, lr_decay="linear",
                               entropy_coef=args.entropy,
                               entropy_decay="linear",
                               reward_norm=args.reward_norm,
                               kickstart_coef=args.kickstart,
                               kickstart_ratio=args.kickstart_ratio,
                               consensus_masked=bool(args.consensus_masked))
            tcfg = TrainConfig(total_step=args.steps)
            emit(resolved_recipe(agent, ecfg, mcfg, tcfg))
            fns = make_a2c(env, mcfg, tcfg, agent=agent, device=dev)
            spu = fns.steps_per_update
            total_updates = args.steps // spu
            log_every = max(total_updates // 8, 1)

            if greedy is None:
                greedy = greedy_returns(env, EVAL_SEEDS, horizon)
                emit({"baselines": {k: float(np.mean(v))
                                    for k, v in greedy.items()},
                      "baseline_best": best_mean(greedy)})
            baseline_best = best_mean(greedy)

            for seed in seeds:
                t0 = time.time()
                ts = fns.init_state(seed)
                ts, m = fns.train_step(ts)
                block_until_ready(m["loss"])
                emit({"agent": agent, "seed": seed,
                      "compile_s": round(time.time() - t0, 1)})
                t0 = time.time()
                for i in range(1, total_updates):
                    ts, m = fns.train_step(ts)
                    if i % 5 == 0:
                        block_until_ready(m["loss"])
                    if i % log_every == 0:
                        emit({"agent": agent, "seed": seed,
                              "step": (i + 1) * spu,
                              "episode_return":
                                  round(float(m["episode_return"]), 1),
                              "entropy": round(float(m["entropy"]), 4),
                              "kick_ce": round(float(m.get("kick_ce",
                                                           np.nan)), 4),
                              "sps": round((i + 1) * spu
                                           / (time.time() - t0), 1)})
                rets = [float(fns.eval_episode(ts.params, s, None,
                                               False)["episode_return"])
                        for s in EVAL_SEEDS]
                emit({"agent": agent, "seed": seed, "final": True,
                      "final_eval_sampled": rets,
                      "mean": float(np.mean(rets)),
                      "baseline_best": baseline_best,
                      "beats_greedy": bool(float(np.mean(rets))
                                           > baseline_best)})


if __name__ == "__main__":
    main()
