"""Decompose the CACC slow-down return (the counterpart of the JAX repo's
``scripts/cacc_reward_decompose.py``): why crashing beats surviving under the
fixed-v* reward, and whether the profile-target variant fixes it.

1. run the fixed-gain OVM teacher on one noise-free episode of the port's
   ``CACCEnv`` and decompose its cost into w_h / w_v / w_u components,
   splitting w_v into "vs fixed v*" and "vs the leader ramp profile";
2. compute the unavoidable lower bound: a platoon tracking the ramp
   perfectly still pays sum_t n * w_v * (v_profile(t) - v*)^2;
3. compare surviving vs crash-at-step-k returns under both reward modes
   (EnvConfig.v_target in {"fixed", "profile"}) at penalty 1000 and 5000,
   and the surviving cost a spacing-corrected one-step greedy reaches.

Deterministic (zero init noise); prints the JAX script's lines. Usage:

    python -m deeprl_network_tpu_torch.scripts.cacc_reward_decompose \\
        [--out decompose.txt]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def rollout_teacher(cfg: EnvConfig, device="cuda"):
    """Full-gain OVM law on one noise-free episode; returns per-step
    arrays (h, v, u, reward [n], collision) as numpy.

    Uses greedy_action (always the OVM law) explicitly, not
    controller_action: the latter dispatches to the spacing-corrected
    greedy for profile-mode slow-down, and this decomposition's subject is
    the OVM teacher trajectory."""
    env = CACCEnv(cfg, device=device)
    n = cfg.n_vehicle
    zeros = torch.zeros((1, n))
    s, _ = env.reset_with_noise(zeros, zeros)
    seq = {k: [] for k in ("h", "v", "u", "r", "v_lead", "collision")}
    for _ in range(cfg.episode_length):
        s, _, r, _, info = env.step(s, env.greedy_action(s))
        for k, x in (("h", s.h), ("v", s.v), ("u", s.u), ("r", r),
                     ("v_lead", s.v_lead), ("collision", info["collision"])):
            seq[k].append(x[0])
    return {k: torch.stack(v).cpu().numpy() for k, v in seq.items()}


def profile(cfg: EnvConfig, t_steps: np.ndarray) -> np.ndarray:
    frac = np.clip(t_steps * cfg.dt / cfg.slowdown_t, 0.0, 1.0)
    return cfg.slowdown_v0 + (cfg.v_star - cfg.slowdown_v0) * frac


def rollout_onestep_greedy(cfg: EnvConfig, mode: str, k_h: float = 0.5):
    """One-step-lookahead greedy over the 4-gain action table (numpy
    mirror of CACCEnv.step): per step, front-to-back, each vehicle picks
    the action minimizing a SCORE; the TRUE reward of the resulting
    trajectory is what gets reported. Exact lookahead — h'_i depends only
    on the predecessor's already-chosen v' and own v'.

    The score is the next-step cost with the velocity target corrected by
    the headway error, v_des = v_tgt + k_h (h - h*): a purely myopic
    score cannot see accumulated headway attrition (a vehicle tracking
    the ramp with beta-only control lags ~1 m/s and crashes by ~t=200),
    so the spacing term folds the h error back into the speed choice —
    standard constant-spacing cruise control. This measures the cost a
    simple surviving controller actually reaches, which is the right
    comparator for 'is crashing return-preferred' (the OVM teacher is
    nowhere near it)."""
    gains = np.array([[0.0, 0.0], [0.5, 0.0], [0.0, 0.5], [0.5, 0.5]])
    n, T = cfg.n_vehicle, cfg.episode_length
    h = np.full(n, cfg.h_star)
    v = np.full(n, cfg.slowdown_v0)
    v_lead = cfg.slowdown_v0
    span = cfg.h_go - cfg.h_st
    cost_rows, min_h = [], np.inf

    def vo(hi):
        if hi < cfg.h_st:
            return 0.0
        if hi > cfg.h_go:
            return cfg.v_max
        return 0.5 * cfg.v_max * (1 - np.cos(np.pi * (hi - cfg.h_st) / span))

    t_arr = np.arange(1, T + 1)
    v_prof = profile(cfg, t_arr)
    for t in range(T):
        v_tgt = v_prof[t] if mode == "profile" else cfg.v_star
        v_lead_new = v_prof[t]
        v_new = np.empty(n)
        prev_v_new = v_lead_new
        prev_v = v_lead
        step_cost = 0.0
        for i in range(n):
            best = None
            for a in range(4):
                al, be = gains[a]
                u = al * (vo(h[i]) - v[i]) + be * (prev_v - v[i])
                u = np.clip(u, -cfg.u_max, cfg.u_max)
                vn = np.clip(v[i] + cfg.dt * u, 0.0, cfg.v_max)
                hn = h[i] + cfg.dt * (prev_v_new - vn)
                v_des = v_tgt + k_h * (hn - cfg.h_star)
                score = (cfg.w_h * (hn - cfg.h_star) ** 2
                         + cfg.w_v * (vn - v_des) ** 2 + cfg.w_u * u ** 2)
                true_c = (cfg.w_h * (hn - cfg.h_star) ** 2
                          + cfg.w_v * (vn - v_tgt) ** 2 + cfg.w_u * u ** 2)
                # never pick an action that collides next step
                if hn < cfg.h_min:
                    score = np.inf
                if best is None or score < best[0]:
                    best = (score, true_c, u, vn, hn)
            _, true_c, u, vn, hn = best
            step_cost += true_c
            v_new[i] = vn
            prev_v, prev_v_new = v[i], vn
            h[i] = hn
        v = v_new
        v_lead = v_lead_new
        min_h = min(min_h, h.min())
        cost_rows.append(step_cost)
    return np.array(cost_rows), min_h


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None, device="cuda"):
    args = parse_args(argv)
    dev = resolve_device(device)
    sink = open(args.out, "w") if args.out else sys.stdout

    def say(msg=""):
        print(msg, file=sink, flush=True)
        if sink is not sys.stdout:
            print(msg, file=sys.stderr, flush=True)

    try:
        report(say, dev)
    finally:
        if sink is not sys.stdout:
            sink.close()


def report(say, device):
    """The decomposition, line by line through ``say``."""
    base = dict(scenario="cacc_slowdown", init_noise_h=0.0,
                init_noise_v=0.0)
    # the env's v_target does not matter here: the teacher rollout uses
    # greedy_action (OVM, reward-independent) and every cost component
    # is recomputed from the trajectory below
    cfg = EnvConfig(**base)
    n, T = cfg.n_vehicle, cfg.episode_length
    seq = rollout_teacher(cfg, device)
    assert not seq["collision"].any(), "teacher crashed (unexpected)"
    t_steps = np.arange(1, T + 1)
    v_prof = profile(cfg, t_steps)                # leader profile at each step

    h, v, u = seq["h"], seq["v"], seq["u"]        # [T, n]
    c_h = cfg.w_h * (h - cfg.h_star) ** 2
    c_v_fixed = cfg.w_v * (v - cfg.v_star) ** 2
    c_v_prof = cfg.w_v * (v - v_prof[:, None]) ** 2
    c_u = cfg.w_u * u ** 2

    say("=== OVM teacher on slow-down (noise-free), raw cost decomposition ===")
    say(f"episode: T={T} steps x n={n} vehicles; "
        f"ramp {cfg.slowdown_v0}->{cfg.v_star} m/s over {cfg.slowdown_t}s "
        f"({int(cfg.slowdown_t / cfg.dt)} steps)")
    ramp = t_steps <= int(cfg.slowdown_t / cfg.dt)
    rows = [
        ("w_h (h-h*)^2", c_h), ("w_v (v-v*fixed)^2", c_v_fixed),
        ("w_v (v-v_profile)^2", c_v_prof), ("w_u u^2", c_u),
    ]
    say(f"{'component':<24}{'total':>12}{'ramp':>12}{'post-ramp':>12}")
    for name, c in rows:
        say(f"{name:<24}{-c.sum():>12.0f}{-c[ramp].sum():>12.0f}"
            f"{-c[~ramp].sum():>12.0f}")
    surv_fixed = -(c_h + c_v_fixed + c_u).sum()
    surv_prof = -(c_h + c_v_prof + c_u).sum()
    say(f"{'TOTAL (fixed mode)':<24}{surv_fixed:>12.0f}")
    say(f"{'TOTAL (profile mode)':<24}{surv_prof:>12.0f}")

    # the unavoidable floor: perfect ramp tracking still pays this vs fixed v*
    unavoidable = -(n * cfg.w_v * (v_prof - cfg.v_star) ** 2).sum()
    say(f"\nunavoidable fixed-v* ramp cost (perfect tracking): "
        f"{unavoidable:.0f}")
    say(f"  -> share of the teacher's fixed-mode return: "
        f"{unavoidable / surv_fixed * 100:.1f}%")

    say("\n=== survive vs crash-at-step-k (raw return, sum over agents) ===")
    say("crash return = cost paid until k + n * collision_penalty")
    for pen in (1000.0, 5000.0):
        say(f"\ncollision_penalty = {pen:.0f}")
        say(f"{'mode':<10}{'survive':>12}{'crash@40':>12}{'crash@300':>12}"
            f"{'best':>10}")
        for mode, cost in (("fixed", c_h + c_v_fixed + c_u),
                           ("profile", c_h + c_v_prof + c_u)):
            per_step = cost.sum(1)                 # [T] total over agents
            crash = {k: -(per_step[: k - 1].sum() + n * pen)
                     for k in (40, 300)}
            surv = -per_step.sum()
            best = ("survive" if surv >= max(crash.values()) else
                    f"crash")
            say(f"{mode:<10}{surv:>12.0f}{crash[40]:>12.0f}"
                f"{crash[300]:>12.0f}{best:>10}")

    say("\n=== achievable surviving cost (spacing-corrected greedy) ===")
    say("(the OVM teacher tracks headway, not the ramp, so its cost is far")
    say(" from what the action set can reach; a perfect ramp tracker would")
    say(f" pay only ~w_u 0.5^2 * 300 * n = "
        f"{cfg.w_u * 0.25 * int(cfg.slowdown_t / cfg.dt) * n:.0f} raw."
        f" One-step lookahead scored on v_des = v_tgt + k_h (h - h*);")
    say(" true reward reported. k_h sweep:)")
    floors = {}
    for mode in ("fixed", "profile"):
        best = None
        for k_h in (0.5, 1.0, 2.0, 5.0, 8.0):
            c_seq, min_h = rollout_onestep_greedy(cfg, mode, k_h=k_h)
            r = -c_seq.sum()
            say(f"  greedy[{mode:>7}, k_h={k_h:>3}]: return {r:>10.0f}   "
                f"min headway {min_h:5.2f} m  "
                f"(survives: {min_h >= cfg.h_min})")
            if min_h >= cfg.h_min and (best is None or r > best):
                best = r
        floors[mode] = best

    say("\n=== crash-optimal comparator (profile mode) ===")
    say("cheapest crash = everyone coasts (u=0, zero control cost) while")
    say("the leader ramps away under vehicle 0; every vehicle then runs")
    say("v_err(t) = 0.5 t vs the profile until h_0 hits h_min:")
    t_c = np.sqrt((cfg.h_star - cfg.h_min) / 0.25)     # 0.25 t^2 closing
    steps_c = int(t_c / cfg.dt)
    prefix = n * cfg.w_v * np.sum((0.5 * np.arange(steps_c) * cfg.dt) ** 2)
    say(f"crash at t ~ {t_c:.1f}s (step {steps_c}); coast prefix cost "
        f"~ {-prefix:.0f}")
    for pen in (1000.0, 5000.0):
        say(f"  penalty {pen:>5.0f}: crash return ~ "
            f"{-(prefix + n * pen):.0f}   vs surviving greedy "
            f"{floors['profile']:.0f}  -> "
            f"{'SURVIVE wins' if floors['profile'] > -(prefix + n * pen) else 'crash wins'}")
    say("(any faster crash needs a larger integrated velocity deviation —")
    say(" by Cauchy-Schwarz a crash in T seconds costs at least")
    say(" 10 w_v (h*-h_min)^2 / T raw in the v-term alone — so the coast")
    say(" crash is within a small factor of crash-optimal.)")

    say("\n=== interpretation ===")
    say("v_target='fixed' (the r1-r4 engine): the w_v-vs-fixed term is")
    say("97.9% of the teacher's surviving return and is UNAVOIDABLE —")
    say("perfect ramp tracking still pays -895k, while any crash ends the")
    say("episode at a fraction of that at every sane penalty. Crashing is")
    say("provably return-optimal; no teacher-free learner should prefer")
    say("survival, so that engine was NOT the paper's task (whose")
    say("learners solve slow-down with no teacher, SURVEY section 6).")
    say("v_target='profile' (spec of record since r5): the unavoidable")
    say(f"term vanishes; a simple spacing-corrected controller survives at")
    say(f"{floors['profile']:.0f} raw, strictly better than the")
    say("crash-optimal return at penalty 1000 (no raised penalty, no")
    say("teacher needed). Survival is return-preferred, consistent with")
    say("the paper — the reference must charge velocity error against the")
    say("ramp profile (or an equivalent moving target).")


if __name__ == "__main__":
    main()
