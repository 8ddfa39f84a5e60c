"""Plain PyTorch reference of the CACC vehicle platoon (catch-up and
slow-down), a frozen copy of the port's plain engine that imports nothing
of the program.

n vehicles trail a virtual leader; headway h_i is the gap to the
predecessor. Action a_i in {0..3} picks the OVM gains (alpha, beta) of
u_i = alpha (V(h_i) - v_i) + beta (v_{i-1} - v_i), clipped to +-u_max, with
the optimal-velocity law V(h) = 0 below h_st, v_max/2 (1 - cos(pi (h - h_st)
/ (h_go - h_st))) up to h_go, v_max above; then v and h integrate at dt
(semi-implicit Euler). Reward_i = -(w_h (h_i - h*)^2 + w_v (v_i - v_tgt)^2
+ w_u u_i^2); a platoon whose smallest headway falls under h_min collides:
every agent gets -collision_penalty and its episode ends. There is no matrix
product, so ``q`` is never applied.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

GAINS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5))
# the engine's values of keys a configuration may leave out
DEFAULTS = dict(n_vehicle=8, catchup_ratio=2.0, slowdown_v0=30.0,
                slowdown_t=30.0, init_noise_h=1.0, init_noise_v=1.0,
                v_target="profile")


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class State(NamedTuple):
    h: torch.Tensor       # [B, n]
    v: torch.Tensor       # [B, n]
    u: torch.Tensor       # [B, n]
    v_lead: torch.Tensor  # [B]
    t: torch.Tensor       # [B] int64


class CaccEnv:
    """B platoons, configured by the config file's ``env`` group."""

    def __init__(self, cfg: Dict, device):
        self.device = torch.device(device)
        self.c = {**DEFAULTS, **cfg}
        self.scenario = cfg["scenario"].replace("cacc_", "")
        if self.scenario not in ("catchup", "slowdown"):
            raise ValueError(f"unknown CACC scenario {cfg['scenario']}")
        n = int(self.c["n_vehicle"])
        adj = np.zeros((n, n), np.float32)
        for i in range(n - 1):
            adj[i, i + 1] = adj[i + 1, i] = 1.0
        self.n_agent, self.n_s, self.n_a = n, 4, 4
        self.adj = adj
        self.dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
        self.action_mask = np.ones((n, 4), np.float32)
        self.coop_gamma = float(cfg["coop_gamma"])
        self.gains = torch.tensor(GAINS, device=self.device)

    def __getattr__(self, key):
        """The configuration's values as attributes (``self.h_star``)."""
        try:
            return self.__dict__["c"][key]
        except KeyError:
            raise AttributeError(key) from None

    def spatial_discount(self) -> np.ndarray:
        if self.coop_gamma < 0:
            return np.ones((self.n_agent, self.n_agent), np.float32)
        return np.power(self.coop_gamma,
                        self.dist.astype(np.float32)).astype(np.float32)

    def _noise(self, amp, gen, batch, offset, total):
        if amp == 0:
            return torch.zeros((batch, self.n_agent), device=self.device)
        u = torch.rand((total or batch, self.n_agent), generator=gen,
                       device=self.device)[offset:offset + batch]
        return (u * 2.0 - 1.0) * amp

    def _fresh(self, gen, batch, offset, total) -> State:
        nh = self._noise(self.init_noise_h, gen, batch, offset, total)
        nv = self._noise(self.init_noise_v, gen, batch, offset, total)
        h0 = self.h_star + nh
        if self.scenario == "catchup":
            h0 = torch.cat([self.catchup_ratio * self.h_star + nh[:, :1],
                            h0[:, 1:]], dim=1)
            v0, v_lead = self.v_star + nv, self.v_star
        else:
            v0, v_lead = self.slowdown_v0 + nv, self.slowdown_v0
        dev = self.device
        return State(h0, torch.clamp(v0, 0.0, self.v_max),
                     torch.zeros_like(h0),
                     torch.full((batch,), float(v_lead), device=dev),
                     torch.zeros((batch,), dtype=torch.int64, device=dev))

    def _leader(self, t):
        if self.scenario == "catchup":
            return torch.full(t.shape, float(self.v_star), device=t.device)
        frac = torch.clamp(t.float() * self.dt / self.slowdown_t, 0.0, 1.0)
        return self.slowdown_v0 + (self.v_star - self.slowdown_v0) * frac

    def _v_target(self, t):
        if self.v_target == "fixed":
            return torch.full(t.shape, float(self.v_star), device=t.device)
        return self._leader(t)

    def obs(self, s: State) -> torch.Tensor:
        v_prev = torch.cat([s.v_lead[:, None], s.v[:, :-1]], dim=1)
        return torch.stack([
            (s.v - self._v_target(s.t)[:, None]) / self.v_star,
            (v_prev - s.v) / 5.0,
            (s.h - self.h_star) / self.h_star,
            s.u / self.u_max], dim=-1)

    def reset(self, batch: int, gen=None, offset: int = 0,
              total: Optional[int] = None):
        s = self._fresh(gen, batch, offset, total)
        return s, self.obs(s)

    def _ovm(self, h):
        span = self.h_go - self.h_st
        mid = 0.5 * self.v_max * (1.0 - torch.cos(math.pi * (h - self.h_st)
                                                  / span))
        return torch.where(h < self.h_st, torch.zeros_like(h),
                           torch.where(h > self.h_go,
                                       torch.full_like(h, self.v_max), mid))

    def step(self, s: State, action: torch.Tensor, q=identity):
        g = self.gains[action.long()]
        v_prev = torch.cat([s.v_lead[:, None], s.v[:, :-1]], dim=1)
        u = g[..., 0] * (self._ovm(s.h) - s.v) + g[..., 1] * (v_prev - s.v)
        u = torch.clamp(u, -self.u_max, self.u_max)
        v = torch.clamp(s.v + self.dt * u, 0.0, self.v_max)
        t = s.t + 1
        v_lead = self._leader(t)
        h = s.h + self.dt * (torch.cat([v_lead[:, None], v[:, :-1]], 1) - v)
        collision = h.min(dim=-1).values < self.h_min
        done = collision | (t >= self.episode_length)
        v_tgt = self._v_target(t)[:, None]
        cost = (self.w_h * (h - self.h_star) ** 2
                + self.w_v * (v - v_tgt) ** 2 + self.w_u * u ** 2)
        reward = torch.where(collision[:, None],
                             torch.full_like(cost, -self.collision_penalty),
                             -cost)
        s2 = State(h, v, u, v_lead, t)
        return s2, self.obs(s2), reward, done, {
            "collision": collision.float()}

    def step_autoreset(self, s: State, action, gen, offset=0, total=None,
                       q=identity):
        """``step``, then a fresh platoon for the rows that are done; the
        fresh platoons' noise is drawn after the step, as the program's
        generic auto-reset draws it."""
        s2, obs, reward, done, info = self.step(s, action, q)
        fresh = self._fresh(gen, action.shape[0], offset, total)
        pick = lambda a, b: torch.where(
            done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b)
        s2 = State(*(pick(a, b) for a, b in zip(fresh, s2)))
        return s2, pick(self.obs(fresh), obs), reward, done, info
