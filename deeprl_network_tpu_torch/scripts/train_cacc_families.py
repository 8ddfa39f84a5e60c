"""CACC family comparison harness (the counterpart of the JAX repo's
``scripts/train_cacc_families.py``): train every algorithm family on a CACC
scenario across seeds, logging the discriminative metrics (collision rate
per step and mean episode length) plus a final sampled-policy eval.

    python -m deeprl_network_tpu_torch.scripts.train_cacc_families \\
        --scenario cacc_slowdown --agents ia2c_fp --seeds 0 \\
        --steps 10000000 --out slowdown_ia2c_fp.jsonl

The flags, their defaults and the rows' keys are the JAX script's. A seed
``s`` is the int seed of ``init_state`` and of the eval episodes (the JAX
``jax.random.key(s)``). Seeds run in one process, families one after the
other.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from deeprl_network_tpu_torch.bench import block_until_ready
from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.scripts._harness import jsonl_sink
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.logging import resolved_recipe
from deeprl_network_tpu_torch.utils.rollout import make_a2c


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", default="cacc_slowdown")
    p.add_argument("--agents",
                   default="ia2c,ia2c_fp,ia2c_cu,ma2c_nc,ma2c_cnet,ma2c_dial")
    p.add_argument("--steps", type=int, default=10_000_000)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--entropy", type=float, default=0.01)
    p.add_argument("--entropy-decay", default="constant",
                   choices=("constant", "linear"),
                   help="annealing the entropy bonus matters for final "
                        "tracking quality under the profile reward")
    p.add_argument("--collision-penalty", type=float, default=1000.0,
                   help="raw crash penalty (EnvConfig.collision_penalty)")
    p.add_argument("--reward-clip", type=float, default=None,
                   help="post-norm reward clip. Default: auto = "
                        "max(2, collision_penalty/reward_norm), so a raised "
                        "crash penalty is never clipped back to the default "
                        "clip ceiling")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--kickstart", type=float, default=0.0,
                   help="CE weight toward CACCEnv.controller_action, "
                        "annealed to 0 by kickstart-ratio * steps")
    p.add_argument("--kickstart-ratio", type=float, default=0.5)
    p.add_argument("--v-target", default="profile",
                   choices=("fixed", "profile"),
                   help="EnvConfig.v_target: what the w_v velocity cost is "
                        "charged against ('profile': the leader's ramp)")
    p.add_argument("--reward-norm", type=float, default=1000.0)
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    dev = resolve_device(device)
    seeds = [int(s) for s in args.seeds.split(",")]
    with jsonl_sink(args.out, "w") as emit:
        emit({"run": vars(args)})
        for agent in args.agents.split(","):
            agent = agent.strip()
            coop = -1.0 if agent in ("ia2c", "ia2c_fp") else 0.9
            env = CACCEnv(EnvConfig(scenario=args.scenario, coop_gamma=coop,
                                    collision_penalty=args.collision_penalty,
                                    v_target=args.v_target), device=dev)
            rclip = (args.reward_clip if args.reward_clip is not None
                     else max(2.0, args.collision_penalty / args.reward_norm))
            mcfg = ModelConfig(batch_size=120, num_envs=args.num_envs,
                               reward_norm=args.reward_norm,
                               reward_clip=rclip, gamma=args.gamma,
                               lr_init=args.lr, entropy_coef=args.entropy,
                               entropy_decay=args.entropy_decay,
                               kickstart_coef=args.kickstart,
                               kickstart_ratio=args.kickstart_ratio,
                               lr_decay="linear")
            tcfg = TrainConfig(total_step=args.steps)
            emit(resolved_recipe(agent, env.cfg, mcfg, tcfg))
            fns = make_a2c(env, mcfg, tcfg, agent=agent, device=dev)
            spu = fns.steps_per_update
            total_updates = args.steps // spu
            log_every = max(total_updates // 10, 1)

            for seed in seeds:
                t0 = time.time()
                ts = fns.init_state(seed)
                window = []
                for i in range(total_updates):
                    ts, m = fns.train_step(ts)
                    window = (window + [m])[-10:]
                    if i % 5 == 0:
                        block_until_ready(m["loss"])
                    if (i + 1) % log_every == 0:
                        emit({"agent": agent, "seed": seed,
                              "step": (i + 1) * spu,
                              "episode_len": round(
                                  float(m["episode_len"]), 1),
                              "collision_rate": round(
                                  float(m["env/collision"]), 5),
                              "headway_err": round(
                                  float(m["env/headway_err"]), 2),
                              "sps": round((i + 1) * spu
                                           / (time.time() - t0), 1)})
                # final training-window metrics + sampled eval
                coll = float(np.mean([float(w["env/collision"])
                                      for w in window]))
                eplen = float(np.mean([float(w["episode_len"])
                                       for w in window]))
                evals = []
                for s in range(3):
                    out = fns.eval_episode(ts.params, 2000 + s, None, False)
                    evals.append({k: float(v) for k, v in out.items()})
                emit({"agent": agent, "seed": seed, "final": True,
                      "collision_rate": coll, "episode_len": eplen,
                      "eval_episode_len": float(np.mean(
                          [e["episode_len"] for e in evals])),
                      "eval_return": float(np.mean(
                          [e["episode_return"] for e in evals])),
                      "eval_collision": float(np.mean(
                          [e.get("env/collision", 0.0) for e in evals]))})


if __name__ == "__main__":
    main()
