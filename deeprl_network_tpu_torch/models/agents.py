"""Reference-style stateful agent API (compat layer; counterpart of
``deeprl_network_tpu/models/agents.py``).

The reference L3 surface (agents/models.py; SURVEY.md section 1 L4->L3):

    model = MA2C_NC(n_s_ls, n_a_ls, neighbor_mask, distance_mask,
                    coop_gamma, total_step, model_config, seed)
    actions = model.forward(obs, done)            # or out_type='v'/'p'
    model.add_transition(ob, action, reward, value, done)
    model.backward(R, dt)
    model.reset(); model.save(path, step); model.load(path)

This module reproduces that object API on top of the functional core, so
code written against the reference ports mechanically. It exists for
interop and for host-driven external envs; the fused path
(utils/rollout.make_a2c) is the fast path and the one the Trainer uses.
One env instance is a batch of one: ``forward`` is one
``policy_step_batched`` call at B=1 (one LSTM cell forward launch on a
card), ``backward`` replays the buffer through ``a2c_loss`` (``n_step``
forward and ``n_step`` backward launches). Arrays in and out are numpy.

Each class name matches the reference exactly: IA2C, IA2C_FP, IA2C_CU,
MA2C_NC, MA2C_CNET, MA2C_DIAL.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeprl_network_tpu_torch.config import ModelConfig
from deeprl_network_tpu_torch.models.a2c import (
    Rollout, a2c_loss, normalize_rewards, nstep_returns, spatial_mix,
)
from deeprl_network_tpu_torch.models.layers import tf1_rmsprop
from deeprl_network_tpu_torch.models.policies import (
    AGENT_TO_COMM, PolicySpec, consensus_update, init_carry,
    init_fingerprint, init_policy_params, mask_comm_params, policy_consts,
    policy_step_batched, tree_leaves, tree_unflatten,
)
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.rollout import gumbel_noise
from deeprl_network_tpu_torch.utils.scheduler import make_schedule


class _BaseAgent:
    agent_name = "ia2c"

    def __init__(self, n_s_ls: Sequence[int], n_a_ls: Sequence[int],
                 neighbor_mask: np.ndarray, distance_mask: np.ndarray,
                 coop_gamma: float, total_step: int,
                 model_config: Optional[ModelConfig] = None, seed: int = 0,
                 device="cuda"):
        mcfg = model_config or ModelConfig()
        self.mcfg = mcfg
        self.device = dev = resolve_device(device)
        n = len(n_s_ls)
        self.n_agent = n
        self.n_s_ls = tuple(n_s_ls)
        self.n_a_ls = tuple(n_a_ls)
        self.n_step = mcfg.n_step
        amask = np.zeros((n, max(n_a_ls)), np.float32)
        for i, na in enumerate(n_a_ls):
            amask[i, :na] = 1.0
        self.obs_mask = np.zeros((n, max(n_s_ls)), np.float32)
        for i, ns in enumerate(n_s_ls):
            self.obs_mask[i, :ns] = 1.0
        self.spec = PolicySpec(
            n_agent=n, n_s_max=max(n_s_ls), n_a_max=max(n_a_ls),
            n_fc=mcfg.num_fc, n_lstm=mcfg.num_lstm,
            comm_type=AGENT_TO_COMM[self.agent_name], n_msg=mcfg.num_fc,
            neighbor_mask=neighbor_mask.astype(np.float32),
            action_mask=amask)
        self._consts = policy_consts(self.spec, dev)
        self.neighbor_mask = neighbor_mask
        if coop_gamma < 0:
            D = np.ones((n, n), np.float32)
        else:
            D = np.power(coop_gamma, distance_mask.astype(np.float32))
        self._D = torch.as_tensor(D.astype(np.float32), device=dev)
        # sampling noise for forward(); the params come from their own
        # generator on the same seed, as make_a2c's init_state draws them
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.params = init_policy_params(
            torch.Generator().manual_seed(seed), self.spec, device=dev)
        # the optimizer calls the schedule with the UPDATE count; one
        # backward() consumes n_step env steps, so convert (as
        # rollout.make_a2c does)
        _lr_env = make_schedule(mcfg.lr_decay, mcfg.lr_init, total_step,
                                mcfg.lr_min)
        self.optimizer = tf1_rmsprop(
            lambda count: _lr_env(count * mcfg.n_step),
            decay=mcfg.rmsp_alpha, eps=mcfg.rmsp_epsilon,
            max_grad_norm=mcfg.max_grad_norm)
        self.opt_state = self.optimizer.init(tree_leaves(self.params))
        self._ent_sched = make_schedule(
            mcfg.entropy_decay, mcfg.entropy_coef, total_step,
            ratio=mcfg.entropy_ratio)
        self.cur_step = 0
        self.reset()
        self._buffer: List[dict] = []

    # ---- reference API ----

    def reset(self) -> None:
        self.carry = init_carry(self.spec, 1, torch.float32, self.device)
        self.fp = init_fingerprint(self.spec, device=self.device)
        self._init_carry = self.carry
        self._buffer = []

    @torch.no_grad()
    def _step(self, ob: torch.Tensor, done: float):
        """(new carry, logits [N, A], values [N]) of one env at B=1."""
        params = mask_comm_params(self.spec, self.params, self._consts)
        d = torch.full((1,), float(done), device=self.device)
        carry, logits, value = policy_step_batched(
            self.spec, params, self.carry, ob[None], self.fp[None], d,
            self._consts)
        return carry, logits[0], value[0]

    def forward(self, obs, done, out_type: str = "p",
                gumbel: Optional[np.ndarray] = None):
        """obs: list of per-agent arrays (ragged) or [N, n_s_max]; done:
        scalar bool for the synchronized multi-agent episode.

        out_type 'p': sample actions (returns [N] ints and caches value);
        'v': return values only (bootstrap); 'pv': (actions, values).
        ``gumbel`` [N, A] replaces the sampling noise drawn from the
        agent's generator.
        """
        ob = self._pack_obs(obs)
        new_carry, logits, value = self._step(ob, done)
        if out_type == "v":
            return value.cpu().numpy()
        value = value.cpu().numpy()
        self._pending = dict(ob=ob, fp=self.fp, prev_done=float(done),
                             value=value)
        self.carry = new_carry
        self.fp = torch.softmax(logits, -1)
        if gumbel is None:
            g = gumbel_noise(self.generator, tuple(logits.shape),
                             self.device)
        else:
            g = torch.as_tensor(np.asarray(gumbel, np.float32),
                                device=self.device)
        action = torch.argmax(logits + g, dim=-1).cpu().numpy()
        self._pending["action"] = action
        if out_type == "pv":
            return action, value
        return action

    def get_policy(self) -> np.ndarray:
        """Latest per-agent softmax (for env.update_fingerprint parity)."""
        return self.fp.cpu().numpy()

    def add_transition(self, ob, action, reward, value, done) -> None:
        p = dict(self._pending)
        p["reward"] = np.asarray(reward, np.float32)
        p["done"] = float(done)
        self._buffer.append(p)
        if done:
            self.fp = init_fingerprint(self.spec, device=self.device)

    def backward(self, R, dt=None, summary_writer=None) -> dict:
        """R: bootstrap values [N] (0 if terminal). Consumes the buffer."""
        b, dev, m = self._buffer, self.device, self.mcfg
        f32 = lambda key: torch.as_tensor(
            np.stack([np.asarray(t[key], np.float32) for t in b]),
            device=dev)
        # time-major windows of one env: [T, B=1, ...]
        roll = Rollout(
            obs=torch.stack([t["ob"] for t in b])[:, None],
            fps=torch.stack([t["fp"] for t in b])[:, None],
            prev_dones=f32("prev_done")[:, None],
            actions=torch.as_tensor(np.stack([t["action"] for t in b]),
                                    device=dev)[:, None],
            rewards=f32("reward")[:, None], values=f32("value")[:, None],
            dones=f32("done")[:, None])
        r = normalize_rewards(roll.rewards, m.reward_norm, m.reward_clip)
        r = spatial_mix(r, self._D)
        R_boot = torch.as_tensor(np.asarray(R, np.float32), device=dev)[None]
        returns = nstep_returns(r, roll.dones, R_boot, m.gamma)
        advs = returns - roll.values
        beta = self._ent_sched(self.cur_step)

        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(self.params)]
        params = tree_unflatten(self.params, leaves)
        loss, stats = a2c_loss(
            self.spec, mask_comm_params(self.spec, params, self._consts),
            self._init_carry, roll, returns, advs, beta, m.value_coef,
            consts=self._consts)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        updates, self.opt_state = self.optimizer.update(grads,
                                                        self.opt_state)
        params = tree_unflatten(
            self.params, [p.detach() + u for p, u in zip(leaves, updates)])
        if self.agent_name == "ia2c_cu":
            if m.consensus_masked:
                params = consensus_update(params, self.neighbor_mask,
                                          self.spec.action_mask,
                                          self.obs_mask)
            else:
                params = consensus_update(params, self.neighbor_mask)
        self.params = params
        self.cur_step += len(b)
        self._buffer = []
        self._init_carry = self.carry
        host = torch.stack([v.detach() for v in stats]).cpu()
        return {k: float(v) for k, v in zip(stats._fields, host)}

    def save(self, model_dir: str, step: Optional[int] = None) -> None:
        CheckpointManager(model_dir).save(step or self.cur_step,
                                          {"params": self.params,
                                           "opt_state": self.opt_state})

    def load(self, model_dir: str, checkpoint: Optional[int] = None) -> bool:
        out = CheckpointManager(model_dir).restore(
            {"params": self.params, "opt_state": self.opt_state}, checkpoint)
        if out is None:
            return False
        self.params = out["params"]
        self.opt_state = out["opt_state"]
        return True

    def _pack_obs(self, obs) -> torch.Tensor:
        if isinstance(obs, (list, tuple)):
            out = np.zeros((self.n_agent, self.spec.n_s_max), np.float32)
            for i, o in enumerate(obs):
                o = np.asarray(o, np.float32).ravel()
                out[i, :len(o)] = o
            obs = out
        # a copy: the caller's array may be read-only (a JAX array's view)
        return torch.as_tensor(np.array(obs, dtype=np.float32),
                               device=self.device)


class IA2C(_BaseAgent):
    agent_name = "ia2c"


class IA2C_FP(_BaseAgent):
    agent_name = "ia2c_fp"


class IA2C_CU(_BaseAgent):
    agent_name = "ia2c_cu"


class MA2C_NC(_BaseAgent):
    agent_name = "ma2c_nc"


class MA2C_CNET(_BaseAgent):
    agent_name = "ma2c_cnet"


class MA2C_DIAL(_BaseAgent):
    agent_name = "ma2c_dial"
