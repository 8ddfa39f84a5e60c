"""Fused A2C actor-learner step (counterpart of
``deeprl_network_tpu/utils/rollout.py``, fused-gradient path).

    train_step(ts) -> (ts', metrics)

runs T = n_step control steps of B batched env instances (policy forward,
Gumbel-max action sampling, env dynamics with auto-reset, fingerprint
update, episode bookkeeping), computes normalized, spatially discounted
n-step returns from a bootstrap V(s_T), and differentiates the A2C loss
through the rollout itself (truncated BPTT over the T-step window), then
applies the TF1 RMSProp update to the f32 master params.

What the JAX step treats as recorded constants is detached here: obs,
rewards, new fingerprints, the bootstrap value; the env runs outside
autograd. With ``remat`` each step's policy forward runs under
``torch.utils.checkpoint`` and is recomputed in the backward pass. The
Gumbel noise is drawn outside that checkpoint, and the action is taken from
the forward's logits, so the recompute never samples.

Not ported yet (they raise ``NotImplementedError``): the replay update
(``fused_grad=False``), IA2C_CU consensus, ``switch_penalty`` and
``kickstart_coef`` shaping, ``eval_episode`` / ``record_episode`` and
data-parallel ``axis_name``; see ROADMAP.md queue 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deeprl_network_tpu_torch.config import ModelConfig, TrainConfig
from deeprl_network_tpu_torch.envs.wrappers import AutoResetEnv
from deeprl_network_tpu_torch.models.a2c import (
    a2c_loss_terms, action_stats, normalize_rewards, nstep_returns,
    spatial_mix,
)
from deeprl_network_tpu_torch.models.layers import (
    RMSPropState, TF1RMSProp, global_norm, tf1_rmsprop,
)
from deeprl_network_tpu_torch.models.policies import (
    AGENT_TO_COMM, Carry, PolicyParams, PolicySpec, check_ported,
    init_carry, init_fingerprint, init_policy_params, mask_comm_params,
    policy_consts, policy_step_batched, tree_leaves, tree_map,
    tree_unflatten,
)
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.scheduler import make_schedule


@dataclass
class TrainState:
    params: PolicyParams          # f32 master params
    opt_state: RMSPropState
    env_state: Any                # batched env state [B, ...]
    obs: torch.Tensor             # [B, N, n_s_max]
    fp: torch.Tensor              # [B, N, n_a_max]
    carry: Carry                  # [B, N, n_lstm] x2, compute dtype
    prev_done: torch.Tensor       # [B] f32
    generator: torch.Generator    # sampling noise and env resets
    step: int                     # global env-step counter
    # episode-return bookkeeping (global reward = sum over agents)
    ep_ret: torch.Tensor          # [B] running episode return
    ep_len: torch.Tensor          # [B]
    last_ep_ret: torch.Tensor     # [B] most recent completed episode return
    last_ep_len: torch.Tensor     # [B]


def make_policy_spec(env_spec, mcfg: ModelConfig, agent: str) -> PolicySpec:
    return PolicySpec(
        n_agent=env_spec.n_agent,
        n_s_max=env_spec.n_s_max,
        n_a_max=env_spec.n_a_max,
        n_fc=mcfg.num_fc,
        n_lstm=mcfg.num_lstm,
        comm_type=AGENT_TO_COMM[agent],
        n_msg=mcfg.num_fc,
        sparse_comm=mcfg.sparse_comm,
        neighbor_obs=mcfg.neighbor_obs,
        obs_alpha=(env_spec.coop_gamma if env_spec.coop_gamma >= 0 else 1.0),
        neighbor_mask=env_spec.neighbor_mask,
        action_mask=env_spec.action_mask,
    )


class A2CFns(NamedTuple):
    init_state: Callable[..., TrainState]
    train_step: Callable[..., Tuple[TrainState, Dict[str, Any]]]
    eval_episode: Callable[..., Dict[str, Any]]
    record_episode: Callable[..., Dict[str, Any]]
    spec: PolicySpec
    optimizer: TF1RMSProp
    steps_per_update: int = 0  # global env steps one train_step consumes


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item {item})")


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """g = -log(-log U), U uniform in [tiny, 1): argmax(logits + g) samples
    the categorical, the law of ``jax.random.categorical``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def make_a2c(env, mcfg: ModelConfig, tcfg: TrainConfig, agent: str = "ia2c",
             num_envs: Optional[int] = None, axis_name: Optional[str] = None,
             device="cuda") -> A2CFns:
    """Build the fused A2C functions for one env + algorithm on ``device``
    (the env must live on the same device)."""
    dev = resolve_device(device)
    if env.device.type != dev.type:
        raise ValueError(f"env lives on {env.device}, make_a2c asked for "
                         f"{dev}")
    dev = env.device
    if not mcfg.fused_grad:
        raise _not_ported("the replay update (fused_grad=False)", 12)
    if agent == "ia2c_cu":
        raise _not_ported("IA2C_CU weight consensus", 9)
    if mcfg.switch_penalty > 0 or mcfg.kickstart_coef > 0:
        raise _not_ported("switch_penalty / kickstart_coef shaping", 9)
    if axis_name is not None:
        raise _not_ported("data-parallel training (axis_name)", 15)
    wenv = AutoResetEnv(env)
    spec = make_policy_spec(env.spec, mcfg, agent)
    check_ported(spec)
    consts = policy_consts(spec, dev)
    n_env = num_envs or mcfg.num_envs
    T = mcfg.n_step
    D = torch.as_tensor(env.spec.spatial_discount(), device=dev)
    gamma = mcfg.gamma
    steps_per_update = T * n_env
    lr_env_sched = make_schedule(mcfg.lr_decay, mcfg.lr_init,
                                 tcfg.total_step, mcfg.lr_min)
    ent_sched = make_schedule(mcfg.entropy_decay, mcfg.entropy_coef,
                              tcfg.total_step, ratio=mcfg.entropy_ratio)
    optimizer = tf1_rmsprop(
        lambda count: lr_env_sched(count * steps_per_update),
        decay=mcfg.rmsp_alpha, eps=mcfg.rmsp_epsilon,
        max_grad_norm=mcfg.max_grad_norm)
    cdt = torch.bfloat16 if mcfg.compute_dtype == "bfloat16" \
        else torch.float32
    uniform_fp = init_fingerprint(spec, device=dev)
    n_agent, n_act = spec.n_agent, spec.n_a_max

    def _prep_params(params: PolicyParams) -> PolicyParams:
        """Masked (+ cast) params for the hot path: mask ONCE per update,
        then cast to the compute dtype; grads of the cast flow back to the
        f32 masters."""
        p = mask_comm_params(spec, params, consts)
        if cdt != torch.float32:
            p = tree_map(lambda t: t.to(cdt), p)
        return p

    def vpstep(params, carry, obs, fp, done):
        # inputs and carry follow the PARAMS' dtype; logits/values go back
        # to f32 for sampling and the loss
        pdt = params.w_obs.w.dtype
        carry = Carry(carry.c.to(pdt), carry.h.to(pdt))
        carry2, logits, values = policy_step_batched(
            spec, params, carry, obs.to(pdt), fp.to(pdt), done, consts)
        return carry2, logits.float(), values.float()

    def init_state(seed: int = 0, params: Optional[PolicyParams] = None
                   ) -> TrainState:
        """Fresh TrainState: params from ``seed`` unless given, env reset,
        zero carry, uniform fingerprints, and a device Generator seeded
        with ``seed`` for sampling and env resets."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if params is None:
            params = init_policy_params(
                torch.Generator().manual_seed(seed), spec, device=dev)
        params = tree_map(lambda t: t.detach().to(dev, torch.float32),
                          params)
        env_state, obs = wenv.reset(n_env, gen)
        zeros = lambda: torch.zeros((n_env,), device=dev)
        return TrainState(
            params=params, opt_state=optimizer.init(tree_leaves(params)),
            env_state=env_state, obs=obs,
            fp=uniform_fp.expand(n_env, -1, -1).clone(),
            carry=init_carry(spec, n_env, cdt, dev),
            prev_done=torch.ones((n_env,), device=dev), generator=gen,
            step=0, ep_ret=zeros(), ep_len=zeros(), last_ep_ret=zeros(),
            last_ep_len=zeros())

    def _returns_pipeline(rew_seq, done_seq, v_boot):
        """normalize -> spatial mix -> n-step returns ([T, B, N])."""
        r = normalize_rewards(rew_seq, mcfg.reward_norm, mcfg.reward_clip)
        r = spatial_mix(r, D)
        return nstep_returns(r, done_seq, v_boot, gamma)

    def train_step(ts: TrainState, gumbel: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        """One update. ``gumbel`` [T, B, N, A] replaces the sampling noise
        drawn from ``ts.generator`` (tests feed the JAX run's noise)."""
        beta = ent_sched(ts.step)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(ts.params)]
        params = tree_unflatten(ts.params, leaves)
        mparams = _prep_params(params)

        env_state, obs, fp, carry = ts.env_state, ts.obs, ts.fp, ts.carry
        prev_done = ts.prev_done
        ep_ret, ep_len = ts.ep_ret, ts.ep_len
        last_ret, last_len = ts.last_ep_ret, ts.last_ep_len
        logps, ents, vals, rews, dones = [], [], [], [], []
        infos: Dict[str, list] = {}
        for t in range(T):
            g = (gumbel[t].to(dev) if gumbel is not None else
                 gumbel_noise(ts.generator, (n_env, n_agent, n_act), dev))
            if mcfg.remat:
                carry, logits, values = checkpoint(
                    vpstep, mparams, carry, obs, fp, prev_done,
                    use_reentrant=False)
            else:
                carry, logits, values = vpstep(mparams, carry, obs, fp,
                                               prev_done)
            with torch.no_grad():
                actions = torch.argmax(logits + g, dim=-1)
                new_fp = torch.softmax(logits, dim=-1)
                env_state, obs, reward, done, info = wenv.step(
                    env_state, actions, ts.generator)
            logp_a, entropy = action_stats(logits, actions)
            done_f = done.float()
            # fingerprints reset to uniform on episode start
            new_fp = torch.where(done_f[:, None, None] > 0, uniform_fp,
                                 new_fp)
            ep_ret = ep_ret + reward.sum(-1)
            ep_len = ep_len + 1.0
            last_ret = torch.where(done_f > 0, ep_ret, last_ret)
            last_len = torch.where(done_f > 0, ep_len, last_len)
            ep_ret = ep_ret * (1.0 - done_f)
            ep_len = ep_len * (1.0 - done_f)
            fp, prev_done = new_fp, done_f
            logps.append(logp_a)
            ents.append(entropy)
            vals.append(values)
            rews.append(reward)
            dones.append(done_f)
            for k, v in info.items():
                infos.setdefault(k, []).append(v)

        val_seq = torch.stack(vals)
        rew_seq, done_seq = torch.stack(rews), torch.stack(dones)
        with torch.no_grad():
            _, _, v_boot = vpstep(mparams, carry, obs, fp, prev_done)
        returns = _returns_pipeline(rew_seq, done_seq, v_boot)
        advs = returns - val_seq.detach()
        loss, stats = a2c_loss_terms(torch.stack(logps), torch.stack(ents),
                                     val_seq, returns, advs, beta,
                                     mcfg.value_coef)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        grad_norm = global_norm(grads)
        updates, opt_state = optimizer.update(grads, ts.opt_state)
        new_leaves = [(p.detach() + u).to(p.dtype)
                      for p, u in zip(leaves, updates)]

        new_ts = TrainState(
            params=tree_unflatten(ts.params, new_leaves),
            opt_state=opt_state, env_state=env_state, obs=obs, fp=fp,
            # truncated BPTT: the next window starts from a constant carry
            carry=Carry(carry.c.detach(), carry.h.detach()),
            prev_done=prev_done, generator=ts.generator,
            step=ts.step + steps_per_update, ep_ret=ep_ret, ep_len=ep_len,
            last_ep_ret=last_ret, last_ep_len=last_len)
        metrics = {
            "loss": loss.detach(),
            "policy_loss": stats.policy.detach(),
            "value_loss": stats.value.detach(),
            "entropy": stats.entropy.detach(),
            "grad_norm": grad_norm,
            "episode_return": torch.mean(last_ret),
            "episode_len": torch.mean(last_len),
            "lr": lr_env_sched(ts.step),
            "beta": beta,
            "step_reward": torch.mean(rew_seq.sum(-1)),
        }
        for k, v in infos.items():
            metrics["env/" + k] = torch.mean(torch.stack(v).float())
        return new_ts, metrics

    def eval_episode(*args, **kwargs):
        raise _not_ported("eval_episode", 12)

    def record_episode(*args, **kwargs):
        raise _not_ported("record_episode", 12)

    return A2CFns(init_state=init_state, train_step=train_step,
                  eval_episode=eval_episode, record_episode=record_episode,
                  spec=spec, optimizer=optimizer,
                  steps_per_update=steps_per_update)
