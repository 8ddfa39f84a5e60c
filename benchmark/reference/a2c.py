"""Plain PyTorch reference of the A2C update (Chu et al., ICLR 2020; the
TF1 RMSProp of the published code), float32, imports nothing of the
program.

An update from state (params, env, obs, fingerprints, carry) runs T control
steps of B envs: policy step, Gumbel-max sampling (argmax(logits + g), g =
-log(-log U)), env step with auto-reset, fingerprints set to the new policy
(uniform where an episode ended). Then, with V(s_T) as bootstrap, rewards
are scaled by 1 / reward_norm and clipped to +-reward_clip, mixed over
agents by D_ij = coop_gamma^hops(i, j), turned into n-step returns R_t =
r_t + gamma (1 - done_t) R_{t+1}, and the loss

    sum_i mean_{t,b} [ -log pi(a|s) (R - V) + value_coef / 2 (R - V)^2
                       - beta H(pi) ]

is differentiated through the whole window (truncated BPTT). Gradients are
clipped by their global norm, g / |g| * max_grad_norm where |g| >=
max_grad_norm, and RMSProp updates ms = d ms + (1 - d) g^2 (from ms = 0),
p += -lr g / sqrt(ms + eps).

The noise comes from a generator seeded as the program's is and drawn in the
same order and shapes: the reset's draws, then each step's Gumbel noise at
the global batch shape and the auto-reset's draws. So the reference samples
from the same uniforms as the program; where rounding makes the two pick
different actions, their trajectories part.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.policy import Policy, identity


def gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def schedule(kind: str, init: float, total_step: int, min_value: float = 0.0,
             ratio: float = 1.0) -> Callable[[int], float]:
    """The schedules of the published code, in float32: constant, or linear
    from ``init`` to ``min_value`` over ``ratio`` x ``total_step`` steps."""
    if (kind or "constant").lower() == "constant":
        return lambda step: float(np.float32(init))
    horizon = max(int(total_step * ratio), 1)

    def linear(step):
        frac = np.clip(np.float32(step) / np.float32(horizon),
                       np.float32(0.0), np.float32(1.0))
        return float(np.maximum(np.float32(init) * (np.float32(1.0) - frac),
                                np.float32(min_value)))
    return linear


def _returns(rew, done, v_boot, D, m):
    r = rew / m["reward_norm"] if m["reward_norm"] > 0 else rew
    if m["reward_clip"] > 0:
        r = torch.clamp(r, -m["reward_clip"], m["reward_clip"])
    r = torch.einsum("ij,...j->...i", D, r)
    out, R = [None] * r.shape[0], v_boot
    for t in reversed(range(r.shape[0])):
        R = r[t] + m["gamma"] * (1.0 - done[t])[..., None] * R
        out[t] = R
    return torch.stack(out)


def follow_train(env, policy: Policy, params: Dict[str, torch.Tensor],
                 model: Dict, total_step: int, seed: int, batch: int,
                 updates: int, q=identity, block: Optional[int] = None
                 ) -> List[Dict]:
    """``updates`` updates of ``batch`` envs from a fresh start with
    ``params`` (f32, copied) and the noise of ``seed``. Returns, for each
    update, its loss (a float), the clipped gradients as the optimizer takes
    them and the params after it (dicts of tensors on the CPU).

    ``block``: rows run at a time (the whole batch by default). Rows are
    independent but for the mean, so a block's loss is weighted by its share
    and the gradients summed; each block replays the update's draws."""
    dev = env.device
    T, A, N = int(model["batch_size"]), env.n_a, env.n_agent
    block = block or batch
    D = torch.as_tensor(env.spatial_discount(), device=dev)
    beta_of = schedule(model["entropy_decay"], model["entropy_coef"],
                       total_step, ratio=model["entropy_ratio"])
    lr_of = schedule(model["lr_decay"], model["lr_init"], total_step,
                     model["lr_min"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    env_state, obs = env.reset(batch, gen)
    fp = policy.uniform_fp.expand(batch, -1, -1).clone()
    c = torch.zeros((batch, N, int(model["num_lstm"])), device=dev)
    h = torch.zeros_like(c)
    done = torch.ones((batch,), device=dev)
    p = {k: v.detach().to(dev, torch.float32).clone() for k, v in params.items()}
    ms = {k: torch.zeros_like(v) for k, v in p.items()}
    names = list(p)
    out = []
    for u in range(updates):
        step = u * T * batch
        beta, lr = beta_of(step), lr_of(step)
        start = gen.get_state()
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        loss_sum = 0.0
        carry_out = []
        for r0 in range(0, batch, block):
            gen.set_state(start)
            rows = slice(r0, min(r0 + block, batch))
            res = _block_update(env, policy, leaves, model, D, gen, beta,
                                r0, rows.stop - r0, batch, T, A, q,
                                type(env_state)(*(x[rows] for x in env_state)),
                                obs[rows], fp[rows], c[rows], h[rows],
                                done[rows])
            share = (rows.stop - r0) / batch
            g = torch.autograd.grad(res["loss"] * share,
                                    [leaves[k] for k in names],
                                    allow_unused=True)
            for k, gk in zip(names, g):
                if gk is not None:
                    grads[k] += gk
            loss_sum += float(res["loss"].detach()) * share
            carry_out.append(res["carry"])
        env_state = type(env_state)(*(torch.cat(x) for x in zip(
            *(co[0] for co in carry_out))))
        obs, fp, c, h, done = (torch.cat(x) for x in zip(
            *(co[1:] for co in carry_out)))
        # clip by the global norm, then RMSProp
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        clip = norm >= model["max_grad_norm"]
        grads = {k: torch.where(clip, g / norm * model["max_grad_norm"], g)
                 for k, g in grads.items()}
        d = model["rmsp_alpha"]
        ms = {k: (1.0 - d) * grads[k] * grads[k] + d * ms[k] for k in p}
        p = {k: p[k] + grads[k] * torch.rsqrt(ms[k] + model["rmsp_epsilon"])
             * (-lr) for k in p}
        out.append({"loss": loss_sum,
                    "grads": {k: g.cpu() for k, g in grads.items()},
                    "params": {k: v.cpu() for k, v in p.items()}})
    return out


def _block_update(env, policy, leaves, model, D, gen, beta, r0, b, total,
                  T, A, q, env_state, obs, fp, c, h, done):
    """The rollout and loss of rows [r0, r0 + b) of ``total``."""
    dev = env.device
    N = env.n_agent
    mp = policy.masked(leaves)
    logp, ent, vals, rews, dones = [], [], [], [], []
    for _ in range(T):
        c, h, logits, values = policy.step(mp, c, h, obs, fp, done, q)
        g = gumbel(gen, (total, N, A), dev)[r0:r0 + b]
        with torch.no_grad():
            act = torch.argmax(logits + g, dim=-1)
            new_fp = torch.softmax(logits, dim=-1)
            env_state, obs, reward, d_new, _ = env.step_autoreset(
                env_state, act, gen, r0, total, q)
            done = d_new.float()
            fp = torch.where(done[:, None, None] > 0, policy.uniform_fp,
                             new_fp)
        lp = torch.log_softmax(logits, dim=-1)
        logp.append(torch.gather(lp, -1, act[..., None])[..., 0])
        pr = torch.exp(lp)
        ent.append(-torch.sum(torch.where(pr > 1e-8, pr * lp,
                                          torch.zeros_like(lp)), -1))
        vals.append(values)
        rews.append(reward)
        dones.append(done)
    with torch.no_grad():
        _, _, _, v_boot = policy.step(mp, c, h, obs, fp, done, q)
    ret = _returns(torch.stack(rews), torch.stack(dones), v_boot, D, model)
    vals = torch.stack(vals)
    adv = (ret - vals).detach()
    policy_loss = -torch.sum(torch.mean(torch.stack(logp) * adv, dim=(0, 1)))
    value_loss = torch.sum(torch.mean(0.5 * (ret - vals) ** 2, dim=(0, 1))) \
        * model["value_coef"]
    ent_loss = -torch.sum(torch.mean(torch.stack(ent), dim=(0, 1))) * beta
    loss = policy_loss + value_loss + ent_loss
    carry = (env_state, obs, fp, c.detach(), h.detach(), done)
    return {"loss": loss, "carry": carry}
