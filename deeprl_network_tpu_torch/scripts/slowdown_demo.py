"""Slow-down trajectories: learned policy vs the hand controller (the
counterpart of the JAX repo's ``scripts/slowdown_demo.py``).

Trains MA2C_NC teacher-free at the defaults on the profile-reward
slow-down, then records one episode each for (a) the learned policy
(sampled, the reference eval protocol) and (b) the spacing-corrected greedy
hand controller (``CACCEnv.controller_action``), from one eval seed.

    python -m deeprl_network_tpu_torch.scripts.slowdown_demo \\
        --steps 50000000 --jsonl slowdown_demo.jsonl [--out traj.png]

The rows of the JAX script keep their keys; each recorded episode's
per-step series (velocity and headway per vehicle, the leader's velocity,
alive) follow as one ``{"series": policy, ...}`` row. The figure (velocity
tracking of the leader ramp and headway per vehicle) needs matplotlib and is
drawn only when ``--out`` is given: unlike the JAX script, no figure path is
written by default.
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

SERIES = ("velocity", "headway", "v_lead", "alive")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=50_000_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-seed", type=int, default=2000)
    p.add_argument("--out", default=None,
                   help="figure path (png); no figure without it")
    p.add_argument("--jsonl", default=None)
    return p.parse_args(argv)


def plot(series, ecfg, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 7), sharex=True)
    for col, (name, s) in enumerate(series.items()):
        tt = np.arange(len(s["velocity"])) * ecfg.dt
        vax, hax = axes[0, col], axes[1, col]
        for i in range(s["velocity"].shape[1]):
            vax.plot(tt, s["velocity"][:, i], lw=0.9, alpha=0.8)
            hax.plot(tt, s["headway"][:, i], lw=0.9, alpha=0.8)
        vax.plot(tt, s["v_lead"], "k--", lw=1.6, label="leader profile")
        hax.axhline(ecfg.h_star, color="#444444", ls="--", lw=1.2)
        hax.axhline(ecfg.h_min, color="#aa2222", ls=":", lw=1.2)
        vax.set_title(name, fontsize=11)
        vax.set_ylabel("velocity (m/s)" if col == 0 else "")
        hax.set_ylabel("headway (m)" if col == 0 else "")
        hax.set_xlabel("time (s)")
        vax.legend(fontsize=8)
        for ax in (vax, hax):
            ax.grid(alpha=0.25)
            ax.spines[["top", "right"]].set_visible(False)
    fig.suptitle("CACC slow-down, profile reward: 8 vehicles track the "
                 "30->15 m/s ramp", fontsize=12)
    fig.tight_layout()
    fig.savefig(path, dpi=120)


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    dev = resolve_device(device)
    with jsonl_sink(args.jsonl, "w") as emit:
        ecfg = EnvConfig(scenario="cacc_slowdown", coop_gamma=0.9)
        mcfg = ModelConfig(batch_size=120, num_envs=64, reward_norm=1000.0,
                           lr_decay="linear", entropy_decay="linear")
        tcfg = TrainConfig(total_step=args.steps)
        emit(resolved_recipe("ma2c_nc", ecfg, mcfg, tcfg))
        env = CACCEnv(ecfg, device=dev)
        fns = make_a2c(env, mcfg, tcfg, agent="ma2c_nc", device=dev)

        t0 = time.time()
        ts = fns.init_state(args.seed)
        spu = fns.steps_per_update
        for i in range(args.steps // spu):
            ts, m = fns.train_step(ts)
            if i % 5 == 0:
                block_until_ready(m["loss"])
        emit({"trained_steps": int(ts.step),
              "train_s": round(time.time() - t0, 1),
              "final_episode_len": float(m["episode_len"])})

        series = {
            name: {k: v.cpu().numpy() for k, v in fns.record_episode(
                params, args.eval_seed, None, policy).items()}
            for name, params, policy in (
                ("learned (MA2C_NC, sampled)", ts.params, "sample"),
                ("spacing controller", None, "controller"))}
        for name, s in series.items():
            alive = s["alive"]
            ret = float((s["reward"].sum(-1) * alive).sum())
            emit({"policy": name, "episode_len": float(alive.sum()),
                  "return_raw": round(ret, 1),
                  "min_headway": float((s["headway"].min(-1)
                                        * alive + 1e9 * (1 - alive)).min())})
        for name, s in series.items():
            emit({"series": name, **{k: s[k].tolist() for k in SERIES}})
        if args.out:
            plot(series, ecfg, args.out)
            emit({"wrote": args.out})


if __name__ == "__main__":
    main()
