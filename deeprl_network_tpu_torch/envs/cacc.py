"""CACC vehicle-platoon environment: Optimal Velocity Model dynamics, batched
in PyTorch (counterpart of ``deeprl_network_tpu/envs/cacc.py``).

Every state leaf carries a leading ``[B]`` axis: B platoons integrate in
lockstep. Behavioural spec (reference cacc_env.py):

- vehicles i = 0..n-1 trail a virtual leader; headway h_i is the gap to the
  predecessor (the leader for i = 0).
- OVM headway law:  V(h) = 0 for h < h_st;
  v_max/2 * (1 - cos(pi (h - h_st)/(h_go - h_st))) for h_st <= h <= h_go;
  v_max above.
- discrete action a_i in {0..3} selects OVM gains
  (alpha, beta) in {(0,0), (0.5,0), (0,0.5), (0.5,0.5)};
  control u_i = alpha*(V(h_i) - v_i) + beta*(v_{i-1} - v_i), clipped to
  +-u_max; Euler integration of v then h at dt = 0.1 s.
- obs per agent: [(v - v*)/v*, (v_lead - v)/5, (h - h*)/h*, u/u_max].
- reward_i = -(w_h (h_i-h*)^2 + w_v (v_i-v*)^2 + w_u u_i^2); a collision
  (min h < h_min, judged per platoon) gives every agent of that platoon
  -collision_penalty and ends its episode.
- scenarios: ``catchup`` (lead vehicle starts at catchup_ratio*h_star gap,
  leader cruises at v*), ``slowdown`` (everything starts at slowdown_v0 and
  the leader ramps linearly down to v* over slowdown_t seconds).

Initial h/v noise is drawn from a ``torch.Generator``; ``reset_with_noise``
takes explicit noise so a given sequence can be injected for
trajectory-exact tests.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs.base import Env, EnvSpec, uniform_rows
from deeprl_network_tpu_torch.envs.wrappers import _tree_where, _where
from deeprl_network_tpu_torch.ops.cacc_env import c_args, cacc_env_step
from deeprl_network_tpu_torch.utils.device import resolve_device

# (alpha, beta) OVM-gain table; action = index
OVM_GAINS = np.array(
    [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5], [0.5, 0.5]], np.float32
)


class CACCState(NamedTuple):
    """Batched platoon state; every leaf has a leading [B] axis."""

    h: torch.Tensor       # [B, n] headway to predecessor (m)
    v: torch.Tensor       # [B, n] velocity (m/s)
    u: torch.Tensor       # [B, n] previous control (m/s^2)
    v_lead: torch.Tensor  # [B] leader velocity
    t: torch.Tensor       # [B] step count int64
    done: torch.Tensor    # [B] bool


def _line_graph(n: int) -> np.ndarray:
    adj = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        adj[i, i + 1] = 1.0
        adj[i + 1, i] = 1.0
    return adj


class CACCEnv(Env):
    """8-vehicle platoon; scenario in {"catchup", "slowdown"}."""

    N_OBS = 4
    N_ACTION = 4

    def __init__(self, cfg: EnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scenario = cfg.scenario.replace("cacc_", "")
        if self.scenario not in ("catchup", "slowdown"):
            raise ValueError(f"unknown CACC scenario {cfg.scenario}")
        n = cfg.n_vehicle
        adj = _line_graph(n)
        dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
        self.spec = EnvSpec(
            n_agent=n,
            n_s_ls=(self.N_OBS,) * n,
            n_a_ls=(self.N_ACTION,) * n,
            neighbor_mask=adj,
            distance_mask=dist.astype(np.int32),
            coop_gamma=cfg.coop_gamma,
        )
        # rewards stay raw here; the rollout normalizes them
        self._t_gains = torch.as_tensor(OVM_GAINS, device=self.device)
        # the env kernel's scalars (ops/cacc_env.py), folded once
        self.kernel_args = c_args(cfg, self.scenario, OVM_GAINS)

    # ---- batched functions ----

    def _ovm_velocity(self, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        span = c.h_go - c.h_st
        mid = 0.5 * c.v_max * (1.0 - torch.cos(math.pi * (h - c.h_st) / span))
        return torch.where(
            h < c.h_st, torch.zeros_like(h),
            torch.where(h > c.h_go, torch.full_like(h, c.v_max), mid))

    def reset_with_noise(self, noise_h: torch.Tensor, noise_v: torch.Tensor
                         ) -> Tuple[CACCState, torch.Tensor]:
        """Deterministic reset given explicit noise [B, n]."""
        c = self.cfg
        dev = self.device
        noise_h = torch.as_tensor(noise_h, dtype=torch.float32, device=dev)
        noise_v = torch.as_tensor(noise_v, dtype=torch.float32, device=dev)
        batch = noise_h.shape[0]
        h0 = c.h_star + noise_h
        if self.scenario == "catchup":
            h0 = torch.cat([c.catchup_ratio * c.h_star + noise_h[:, :1],
                            h0[:, 1:]], dim=1)
            v0 = c.v_star + noise_v
            v_lead = c.v_star
        else:  # slowdown
            v0 = c.slowdown_v0 + noise_v
            v_lead = c.slowdown_v0
        state = CACCState(
            h=h0,
            v=torch.clamp(v0, 0.0, c.v_max),
            u=torch.zeros_like(h0),
            v_lead=torch.full((batch,), v_lead, device=dev),
            t=torch.zeros((batch,), dtype=torch.int64, device=dev),
            done=torch.zeros((batch,), dtype=torch.bool, device=dev),
        )
        return state, self._obs(state)

    def reset(self, batch: int, generator: torch.Generator = None,
              offset: int = 0, total: Optional[int] = None
              ) -> Tuple[CACCState, torch.Tensor]:
        """Fresh state for ``batch`` platoons (rows ``[offset, offset +
        batch)`` of ``total``, see ``base.uniform_rows``); the initial noise
        is uniform in +-init_noise_h / +-init_noise_v, drawn from
        ``generator`` (no draw where a noise amplitude is 0)."""
        c = self.cfg
        shape = (batch, c.n_vehicle)

        def noise(amp):
            if amp == 0:
                return torch.zeros(shape, device=self.device)
            u = uniform_rows(shape, generator, self.device, offset, total)
            return (u * 2.0 - 1.0) * amp

        return self.reset_with_noise(noise(c.init_noise_h),
                                     noise(c.init_noise_v))

    def _leader_velocity(self, t: torch.Tensor) -> torch.Tensor:
        """Leader speed [B] at step t [B]."""
        c = self.cfg
        if self.scenario == "catchup":
            return torch.full(t.shape, c.v_star, device=t.device)
        # slowdown: linear ramp slowdown_v0 -> v_star over slowdown_t secs
        frac = torch.clamp(t.float() * c.dt / c.slowdown_t, 0.0, 1.0)
        return c.slowdown_v0 + (c.v_star - c.slowdown_v0) * frac

    def _v_target(self, t: torch.Tensor) -> torch.Tensor:
        """Velocity target [B] that the w_v cost (and the obs v-error) is
        charged against at step t. ``cfg.v_target="fixed"``: constant
        v_star. ``"profile"``: the leader's scenario profile, which for
        slow-down removes the unavoidable ramp-tracking cost that otherwise
        makes crashing return-optimal. Identical for catchup."""
        if self.cfg.v_target == "fixed":
            return torch.full(t.shape, self.cfg.v_star, device=t.device)
        return self._leader_velocity(t)

    @staticmethod
    def _predecessor_velocity(v_lead: torch.Tensor, v: torch.Tensor
                              ) -> torch.Tensor:
        return torch.cat([v_lead[:, None], v[:, :-1]], dim=1)

    def _obs(self, s: CACCState) -> torch.Tensor:
        c = self.cfg
        v_prev = self._predecessor_velocity(s.v_lead, s.v)
        return torch.stack([
            (s.v - self._v_target(s.t)[:, None]) / c.v_star,
            (v_prev - s.v) / 5.0,
            (s.h - c.h_star) / c.h_star,
            s.u / c.u_max,
        ], dim=-1)

    def record(self, s: CACCState) -> Dict[str, torch.Tensor]:
        """Per-step platoon series (headway / velocity / accel), each with
        the leading [B] axis."""
        return {"headway": s.h, "velocity": s.v, "accel": s.u,
                "v_lead": s.v_lead}

    def greedy_action(self, s: CACCState) -> torch.Tensor:
        """Naive baseline controller: every vehicle runs the full-gain OVM
        law (alpha, beta) = (0.5, 0.5)."""
        return torch.full(s.h.shape, 3, dtype=torch.int64, device=s.h.device)

    def controller_action(self, s: CACCState) -> torch.Tensor:
        """Strongest known hand controller (naive baseline of record and
        kickstart teacher): the full-gain OVM law for catchup and for any
        scenario under ``v_target="fixed"``; for slow-down under
        ``v_target="profile"`` the spacing-corrected one-step greedy."""
        if self.scenario == "slowdown" and self.cfg.v_target == "profile":
            return self._spacing_greedy_action(s)
        return self.greedy_action(s)

    _SPACING_KH = 5.0   # headway->velocity correction gain

    def _spacing_greedy_action(self, s: CACCState) -> torch.Tensor:
        """One-step-lookahead greedy over the 4-gain table, scored on the
        next-step cost with the velocity target corrected by the headway
        error (v_des = v_profile + k_h (h - h*)). The headway prediction
        uses the predecessor's current velocity (one joint vectorized
        pass). A vehicle whose four candidates all collide scores all-inf
        and takes action 0."""
        c = self.cfg
        v_prev = self._predecessor_velocity(s.v_lead, s.v)[:, None]  # [B,1,n]
        v, h = s.v[:, None], s.h[:, None]
        gains = self._t_gains                                  # [4, 2]
        u = (gains[:, :1] * (self._ovm_velocity(h) - v)
             + gains[:, 1:] * (v_prev - v))                    # [B, 4, n]
        u = torch.clamp(u, -c.u_max, c.u_max)
        vn = torch.clamp(v + c.dt * u, 0.0, c.v_max)
        hn = h + c.dt * (v_prev - vn)
        v_tgt = self._v_target(s.t + 1)[:, None, None]
        v_des = v_tgt + self._SPACING_KH * (hn - c.h_star)
        score = (c.w_h * (hn - c.h_star) ** 2
                 + c.w_v * (vn - v_des) ** 2 + c.w_u * u ** 2)
        score = torch.where(hn < c.h_min,
                            torch.full_like(score, torch.inf), score)
        return torch.argmin(score, dim=1)

    def step(self, s: CACCState, action: torch.Tensor
             ) -> Tuple[CACCState, torch.Tensor, torch.Tensor, torch.Tensor,
                        Dict[str, torch.Tensor]]:
        """One 0.1 s control step. action: [B, n] int in [0, 4)."""
        c = self.cfg
        gains = self._t_gains[action.long()]                   # [B, n, 2]
        alpha, beta = gains[..., 0], gains[..., 1]
        v_prev = self._predecessor_velocity(s.v_lead, s.v)
        u = alpha * (self._ovm_velocity(s.h) - s.v) + beta * (v_prev - s.v)
        u = torch.clamp(u, -c.u_max, c.u_max)
        v_new = torch.clamp(s.v + c.dt * u, 0.0, c.v_max)
        t_new = s.t + 1
        v_lead_new = self._leader_velocity(t_new)
        v_prev_new = self._predecessor_velocity(v_lead_new, v_new)
        # headway integrates the new relative speed (semi-implicit Euler)
        h_new = s.h + c.dt * (v_prev_new - v_new)
        collision = h_new.min(dim=-1).values < c.h_min         # [B]
        done = collision | (t_new >= c.episode_length)

        v_tgt = self._v_target(t_new)[:, None]
        cost = (c.w_h * (h_new - c.h_star) ** 2
                + c.w_v * (v_new - v_tgt) ** 2
                + c.w_u * u ** 2)
        reward = torch.where(collision[:, None],
                             torch.full_like(cost, -c.collision_penalty),
                             -cost)

        s_new = CACCState(h=h_new, v=v_new, u=u, v_lead=v_lead_new,
                          t=t_new, done=done)
        info = {"collision": collision,
                "headway_err": (h_new - c.h_star).abs().mean(-1),
                "velocity_err": (v_new - v_tgt).abs().mean(-1)}
        return s_new, self._obs(s_new), reward, done, info

    def step_autoreset(self, s: CACCState, action: torch.Tensor,
                       generator: torch.Generator = None, offset: int = 0,
                       total: Optional[int] = None):
        """``step`` and, for platoons that are done, a fresh reset: what
        ``AutoResetEnv.step`` returns (state and obs of the reset where
        done; reward, done and info of the transition). One launch of the
        env kernel on the card (``ops/cacc_env.py``), its plain twin
        ``step_autoreset_ref`` on the CPU. The reset's uniforms are drawn
        every step from ``generator`` before the launch, as ``reset(batch,
        generator, offset, total)`` draws them: h's, then v's, none where
        its amplitude is 0."""
        c = self.cfg
        shape = (action.shape[0], c.n_vehicle)
        u_h = None if c.init_noise_h == 0 else uniform_rows(
            shape, generator, self.device, offset, total)
        u_v = None if c.init_noise_v == 0 else uniform_rows(
            shape, generator, self.device, offset, total)
        action = action.long().contiguous()
        if action.device.type == "cpu":
            return self.step_autoreset_ref(s, action, u_h, u_v)
        return cacc_env_step(self.kernel_args, s, action, u_h, u_v)

    def step_autoreset_ref(self, s: CACCState, action: torch.Tensor,
                           u_h: Optional[torch.Tensor],
                           u_v: Optional[torch.Tensor]):
        """Plain twin of the env kernel, as PyTorch ops on any device:
        ``step``, the reset from the uniforms ``u_h``, ``u_v`` [B, n] made
        into noise as ``reset`` makes it (zeros where None), and
        ``AutoResetEnv``'s selects."""
        c = self.cfg

        def noise(u, amp):
            if u is None:
                return torch.zeros(action.shape, device=self.device)
            return (u * 2.0 - 1.0) * amp

        s2, obs2, reward, done, info = self.step(s, action)
        rs, robs = self.reset_with_noise(noise(u_h, c.init_noise_h),
                                         noise(u_v, c.init_noise_v))
        return (_tree_where(done, rs, s2), _where(done, robs, obs2), reward,
                done, info)
