"""Learning validation (the counterpart of the JAX repo's
``scripts/validate_learning.py``): train IA2C / MA2C variants on CACC
catch-up and check the reference's qualitative behaviour: episode return
rises, collisions stop, headway converges toward h*.

    python -m deeprl_network_tpu_torch.scripts.validate_learning \\
        --agent ma2c_nc --steps 200000

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
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.logging import resolved_recipe
from deeprl_network_tpu_torch.utils.rollout import make_a2c


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--agent", default="ia2c")
    p.add_argument("--scenario", default="cacc_catchup")
    p.add_argument("--steps", type=int, default=200_000)
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=5e-4)
    return p.parse_args(argv)


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    dev = resolve_device(device)
    coop = 0.9 if args.agent.startswith("ma2c") else -1.0
    ecfg = EnvConfig(scenario=args.scenario, coop_gamma=coop)
    # T=120, the reference n_step
    mcfg = ModelConfig(batch_size=120, num_envs=args.num_envs,
                       reward_norm=1000.0, lr_init=args.lr)
    tcfg = TrainConfig(total_step=args.steps)
    env = CACCEnv(ecfg, device=dev)
    print(json.dumps(resolved_recipe(args.agent, ecfg, mcfg, tcfg)),
          flush=True)
    fns = make_a2c(env, mcfg, tcfg, agent=args.agent, device=dev)
    t0 = time.time()
    ts = fns.init_state(args.seed)
    print(f"init {time.time()-t0:.0f}s", file=sys.stderr, flush=True)
    t0 = time.time()
    ts, m = fns.train_step(ts)
    block_until_ready(m["loss"])
    print(f"compile {time.time()-t0:.0f}s", file=sys.stderr, flush=True)

    t0 = time.time()
    log_every = max(args.steps // (20 * mcfg.batch_size * args.num_envs), 1)
    i = 0
    first_ret = None
    while int(ts.step) < args.steps:
        ts, m = fns.train_step(ts)
        i += 1
        if i % log_every == 0:
            ret = float(m["episode_return"])
            if first_ret is None:
                first_ret = ret
            print(json.dumps({
                "step": int(ts.step),
                "episode_return": round(ret, 1),
                "episode_len": round(float(m["episode_len"]), 1),
                "collision_rate": round(float(m["env/collision"]), 4),
                "headway_err": round(float(m["env/headway_err"]), 2),
                "velocity_err": round(float(m["env/velocity_err"]), 2),
                "entropy": round(float(m["entropy"]), 3),
                "sps": round(int(ts.step) / (time.time() - t0), 1),
            }), flush=True)
    # final eval: sampled (reference semantics) and greedy
    for name, greedy in (("sampled", False), ("greedy", True)):
        rets = [float(fns.eval_episode(ts.params, 1000 + s, None,
                                       greedy)["episode_return"])
                for s in range(5)]
        print(json.dumps({f"final_eval_{name}": rets,
                          "mean": float(np.mean(rets)),
                          "first_logged_return": first_ret}), flush=True)


if __name__ == "__main__":
    main()
