"""A2C math: n-step returns, spatial reward discounting, joint loss
(counterpart of ``deeprl_network_tpu/models/a2c.py``).

- returns: R_t = r_t + gamma (1 - done_t) R_{t+1}, bootstrap R_T = V(s_T);
  a reverse loop over the time axis;
- reward normalization/clip, applied BEFORE spatial mixing;
- spatial discounting: r_tilde = D @ r;
- loss per agent: -sum_t log pi(a_t|s_t) Adv_t + 0.5 value_coef
  sum_t (R_t - V_t)^2 - beta sum_t H(pi_t), summed over agents and
  averaged over time and env batch. The replay loss ``a2c_loss`` runs the
  policy again over a stored T-step window from its initial LSTM carry
  (truncated BPTT with recompute).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from deeprl_network_tpu_torch.models.policies import (
    Carry, PolicyConsts, PolicyParams, PolicySpec, policy_step_batched,
)


class Rollout(NamedTuple):
    """One T-step window of B env instances, time-major. ``a2c_loss`` reads
    obs, fps, prev_dones and actions; the rest is the record of the rollout."""

    obs: torch.Tensor         # [T, B, N, n_s_max]
    fps: torch.Tensor         # [T, B, N, n_a_max] fingerprints fed each step
    prev_dones: torch.Tensor  # [T, B] done flag preceding each step
    actions: torch.Tensor     # [T, B, N] int64
    rewards: torch.Tensor     # [T, B, N] raw env rewards
    values: torch.Tensor      # [T, B, N] V(s_t) from the rollout policy
    dones: torch.Tensor       # [T, B] done AFTER each step


def normalize_rewards(r: torch.Tensor, reward_norm: float,
                      reward_clip: float) -> torch.Tensor:
    if reward_norm and reward_norm > 0:
        r = r / reward_norm
    if reward_clip and reward_clip > 0:
        r = torch.clamp(r, -reward_clip, reward_clip)
    return r


def spatial_mix(r: torch.Tensor, discount_matrix: torch.Tensor
                ) -> torch.Tensor:
    """r_tilde[..., i] = sum_j D[i, j] r[..., j]."""
    return torch.einsum("ij,...j->...i", discount_matrix, r)


def nstep_returns(rewards: torch.Tensor, dones: torch.Tensor,
                  bootstrap: torch.Tensor, gamma: float) -> torch.Tensor:
    """rewards [T, ..., N], dones [T, ...], bootstrap V [..., N] ->
    returns [T, ..., N]."""
    dones = dones.to(rewards.dtype)
    R = bootstrap
    out = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        R = rewards[t] + gamma * (1.0 - dones[t])[..., None] * R
        out[t] = R
    return torch.stack(out)


class LossStats(NamedTuple):
    total: torch.Tensor
    policy: torch.Tensor
    value: torch.Tensor
    entropy: torch.Tensor


def action_stats(logits: torch.Tensor, actions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log pi(a|s) of the taken action and nan-safe entropy.

    logits [..., A] (padded actions at ~-1e9), actions [...] int ->
    (logp_a [...], entropy [...]).
    """
    logp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    logp_a = torch.gather(logp, -1, actions[..., None].long())[..., 0]
    # entropy over valid actions only: padded logits ~ -1e9 => p ~ 0,
    # p*logp -> 0 * -1e9, kept nan-safe by the where
    ent_terms = torch.where(probs > 1e-8, probs * logp,
                            torch.zeros_like(logp))
    return logp_a, -torch.sum(ent_terms, dim=-1)


def a2c_loss_terms(logp_a: torch.Tensor, entropy: torch.Tensor,
                   values: torch.Tensor, returns: torch.Tensor,
                   advs: torch.Tensor,
                   entropy_coef: Union[float, torch.Tensor],
                   value_coef: float) -> Tuple[torch.Tensor, LossStats]:
    """Joint A2C loss from per-step policy statistics.

    All arrays [..., N]: mean over every leading axis (time, env batch),
    sum over the trailing agent axis. advs/returns enter detached; values
    carry the critic gradient. ``entropy_coef`` may be a 0-dim f32 tensor
    (the train step's schedule tensor), which gives what its float gives.
    """
    lead = tuple(range(logp_a.ndim - 1))
    policy_loss = -torch.sum(torch.mean(logp_a * advs.detach(), dim=lead))
    value_loss = torch.sum(torch.mean(
        0.5 * (returns.detach() - values) ** 2, dim=lead)) * value_coef
    # RAW per-agent policy entropy (not coef * H)
    mean_entropy = torch.mean(entropy)
    entropy_loss = -torch.sum(torch.mean(entropy, dim=lead)) * entropy_coef
    total = policy_loss + value_loss + entropy_loss
    return total, LossStats(total, policy_loss, value_loss, mean_entropy)


def a2c_loss(spec: PolicySpec, params: PolicyParams, init_carry: Carry,
             roll: Rollout, returns: torch.Tensor, advs: torch.Tensor,
             entropy_coef: Union[float, torch.Tensor], value_coef: float,
             remat: bool = False,
             consts: Optional[PolicyConsts] = None
             ) -> Tuple[torch.Tensor, LossStats]:
    """Joint A2C loss over a [T, B, ...] window: replays the policy over the
    T steps from the stored initial carry (truncated BPTT). ``params`` must
    have passed ``mask_comm_params``.

    The JAX version takes one env's window, is vmapped over envs, and the
    caller means the per-env losses (each a mean over T, summed over N).
    Batched, that is one mean over (T, B) and a sum over N, which
    ``a2c_loss_terms`` computes on the [T, B, N] arrays directly.

    ``remat``: each step's forward runs under ``torch.utils.checkpoint`` and
    is recomputed in the backward pass, so only the per-step carry is kept.
    """

    def step(carry, ob, fp, pd):
        return policy_step_batched(spec, params, carry, ob, fp, pd, consts)

    carry, logits, values = init_carry, [], []
    prev_dones = roll.prev_dones.to(roll.obs.dtype)
    for t in range(roll.obs.shape[0]):
        args = (carry, roll.obs[t], roll.fps[t], prev_dones[t])
        if remat:
            # the step draws no noise: no RNG state to keep (and a CUDA
            # graph's capture may not read it)
            carry, lo, v = checkpoint(step, *args, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            carry, lo, v = step(*args)
        logits.append(lo)
        values.append(v)
    logp_a, entropy = action_stats(torch.stack(logits), roll.actions)
    return a2c_loss_terms(logp_a, entropy, torch.stack(values), returns,
                          advs, entropy_coef, value_coef)
