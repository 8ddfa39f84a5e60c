"""Plain PyTorch reference of the ATSC traffic-signal engine on the 5x5 grid.

A frozen copy of the port's plain twin (its grid's construction and its
store-and-forward step), kept here so that a change to the program cannot
move the yardstick. It imports nothing of the program. Every matrix product
takes its operands through ``q`` (the identity for the reference, a rounding
to a lower precision for the control); everything else runs in float32.

Dynamics of one control step (``control_interval_sec`` 1-second substeps):
vehicles finishing a link join the stop-line queue (overflow past the lane
capacity is dropped), the chosen phase gates the lanes (no green during the
yellow window after a switch), each lane discharges min(queue, sat_flow,
downstream space) into its routes, routed and entering vehicles ride a
transit ring for the link delay, head vehicles accumulate waiting time. The
reward of a node is minus its queued vehicles (``objective = queue``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

DIRS = ["N", "E", "S", "W"]
DR = {"N": (-1, 0), "E": (0, 1), "S": (1, 0), "W": (0, -1)}
HEADING = {"N": "S", "E": "W", "S": "N", "W": "E"}
LEFT_OF = {"S": "E", "W": "S", "N": "W", "E": "N"}
RIGHT_OF = {"S": "W", "W": "N", "N": "E", "E": "S"}
OPP = {"N": "S", "S": "N", "E": "W", "W": "E"}
# phase -> (approach, movement) pairs with green; movements 0 left,
# 1 through, 2 right
PHASES = [
    [("N", 1), ("N", 2), ("S", 1), ("S", 2)],
    [("N", 0), ("S", 0)],
    [("E", 1), ("E", 2), ("W", 1), ("W", 2)],
    [("E", 0), ("W", 0)],
    [("N", 2), ("E", 2), ("S", 2), ("W", 2)],
]
TURN = np.array([0.25, 0.5, 0.25])


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class State(NamedTuple):
    queue: torch.Tensor       # [B, L]
    transit: torch.Tensor     # [B, D, L]
    wait: torch.Tensor        # [B, L]
    prev_phase: torch.Tensor  # [B, M] int64
    t: torch.Tensor           # [B] int64


def hop_distances(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    dist = np.full((n, n), n + 1, np.int64)
    np.fill_diagonal(dist, 0)
    dist[adj > 0] = 1
    for _ in range(n):
        new = np.minimum(dist, (dist[:, :, None] + dist[None, :, :]).min(1))
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def _trapezoid(tau, t0, t1, t2, t3):
    ramp = (tau - t0) / max(t1 - t0, 1e-6)
    down = 1.0 - (tau - t2) / max(t3 - t2, 1e-6)
    return np.where(tau < t0, 0.0, np.where(tau < t1, ramp, np.where(
        tau < t2, 1.0, np.where(tau < t3, down, 0.0))))


class GridEnv:
    """B instances of the size x size grid, configured by the config file's
    ``env`` group (a dict of the .ini's [ENV_CONFIG] keys)."""

    def __init__(self, cfg: Dict, device, size: int = 5):
        for key, want in (("objective", "queue"), ("phase_in_obs", False),
                          ("queue_in_obs", False)):
            if cfg.get(key, want) != want:
                raise ValueError(f"the reference grid takes {key}={want!r}")
        self.device = torch.device(device)
        self.cap = float(cfg.get("lane_capacity", 40.0))
        self.sat = float(cfg.get("sat_flow", 0.5))
        self.norm_wave = float(cfg["norm_wave"])
        self.clip_wave = float(cfg["clip_wave"])
        self.k_sub = int(cfg["control_interval_sec"])
        self.yellow = int(cfg["yellow_interval_sec"])
        self.steps = int(cfg["episode_length_sec"]) // self.k_sub
        self.init_density = float(cfg.get("init_density", 0.0))
        self.coop_gamma = float(cfg["coop_gamma"])
        M = size * size
        lanes = [(n, d, mv) for n in range(M) for d in DIRS
                 for mv in range(3)]
        lid = {ln: i for i, ln in enumerate(lanes)}
        L = len(lanes)

        def inside(r, c):
            return 0 <= r < size and 0 <= c < size

        adj = np.zeros((M, M), np.float32)
        route = np.zeros((L, L), np.float32)
        entry = np.zeros(L, np.float32)
        side = {}
        for i, (n, d, mv) in enumerate(lanes):
            r, c = divmod(n, size)
            dr, dc = DR[d]
            if inside(r + dr, c + dc):
                adj[n, (r + dr) * size + c + dc] = 1.0
            else:
                entry[i] = 1.0
                side[i] = d
            h = HEADING[d]
            out = h if mv == 1 else LEFT_OF[h] if mv == 0 else RIGHT_OF[h]
            dr, dc = DR[out]
            if inside(r + dr, c + dc):
                n2 = (r + dr) * size + c + dc
                for mv2 in range(3):
                    route[i, lid[(n2, OPP[out], mv2)]] = TURN[mv2]
        P = len(PHASES)
        gate = np.zeros((M, P, L), np.float32)
        for n in range(M):
            for p, moves in enumerate(PHASES):
                for d, mv in moves:
                    gate[n, p, lid[(n, d, mv)]] = 1.0
        tau = np.arange(self.steps) / max(self.steps - 1, 1)
        g1 = _trapezoid(tau, 0.0, 0.15, 0.40, 0.60) * cfg["peak_flow1"] / 3600
        g2 = _trapezoid(tau, 0.30, 0.45, 0.70, 0.90) * cfg["peak_flow2"] / 3600
        scale = float(cfg.get("demand_scale", 1.0))
        demand = np.zeros((self.steps, L), np.float32)
        for i, d in side.items():
            demand[:, i] = (g1 if d in ("E", "W") else g2) \
                * TURN[lanes[i][2]] * scale
        node_lanes = np.zeros((M, L), np.float32)
        for i, (n, _, _) in enumerate(lanes):
            node_lanes[n, i] = 1.0
        D = max(int(cfg.get("link_delay_sec", 10)), 1)
        self.M, self.L, self.P, self.D = M, L, P, D
        self.n_agent, self.n_s, self.n_a = M, 12, P
        self.adj = adj
        self.dist = hop_distances(adj)
        self.action_mask = np.ones((M, P), np.float32)
        self.route_nnz = int((route != 0).sum())
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device)
        self.gate = f32(gate.reshape(M * P, L))
        self.route = f32(route)
        self.route_out = self.route.sum(1)
        self.entry = f32(entry)
        self.demand = f32(demand)
        self.node_lanes = f32(node_lanes)
        # each node observes its 12 lanes (4 approaches x 3 movements),
        # which are lanes 12 m .. 12 m + 11
        self.gather = torch.arange(L, device=self.device).reshape(M, 12)

    def spatial_discount(self) -> np.ndarray:
        if self.coop_gamma < 0:
            return np.ones((self.M, self.M), np.float32)
        return np.power(self.coop_gamma,
                        self.dist.astype(np.float32)).astype(np.float32)

    def _queues(self, gen, batch, offset, total):
        if self.init_density <= 0:
            return torch.zeros((batch, self.L), device=self.device)
        u = torch.rand((total or batch, self.L), generator=gen,
                       device=self.device)
        return u[offset:offset + batch] * self.init_density * self.cap

    def _fresh(self, q0):
        B = q0.shape[0]
        dev = self.device
        return State(q0, torch.zeros((B, self.D, self.L), device=dev),
                     torch.zeros((B, self.L), device=dev),
                     torch.zeros((B, self.M), dtype=torch.int64, device=dev),
                     torch.zeros((B,), dtype=torch.int64, device=dev))

    def obs(self, s: State) -> torch.Tensor:
        wave = s.queue + s.transit.sum(1)
        return torch.clamp(wave / self.norm_wave, 0.0, self.clip_wave)[
            :, self.gather]

    def reset(self, batch: int, gen=None, offset: int = 0,
              total: Optional[int] = None):
        s = self._fresh(self._queues(gen, batch, offset, total))
        return s, self.obs(s)

    def step(self, s: State, action: torch.Tensor, q=identity):
        """(state', obs, reward [B, M], done [B], info) of one control
        step; ``action`` [B, M] phase indices."""
        B, cap = action.shape[0], self.cap
        act = action.long()
        onehot = (act[..., None] == torch.arange(self.P, device=act.device)
                  ).float()
        lane_gate = q(onehot.reshape(B, -1)) @ q(self.gate)
        switched = (act != s.prev_phase).float()
        lane_switch = q(switched) @ q(self.node_lanes)
        demand = self.demand[torch.clamp(s.t, max=self.steps - 1)]
        inflow = demand * self.entry
        qu, transit, w = s.queue, s.transit, s.wait
        for k in range(self.k_sub):
            qu = qu + transit[:, 0]
            transit = torch.cat([transit[:, 1:],
                                 torch.zeros_like(transit[:, :1])], 1)
            qu = qu - torch.clamp(qu - cap, min=0.0)
            g = lane_gate * (1.0 - (1.0 if k < self.yellow else 0.0)
                             * lane_switch)
            space = q(torch.clamp(cap - (qu + transit.sum(1)), min=0.0)) \
                @ q(self.route.T)
            space = torch.where(
                self.route_out > 1e-6,
                space / torch.clamp(self.route_out, min=1e-6),
                torch.full_like(space, cap))
            dq = torch.minimum(torch.minimum(qu, g * self.sat), space)
            q2 = qu - dq
            routed = q(dq) @ q(self.route)
            transit = transit.clone()
            transit[:, self.D - 1] += routed
            free = torch.clamp(cap - (q2 + transit.sum(1)), min=0.0)
            transit[:, self.D - 1] += torch.minimum(inflow, free)
            served = (dq > 1e-4).float()
            w = (w + 1.0) * (q2 > 0.1).float() * (1.0 - served)
            qu = q2
        t = s.t + 1
        done = t >= self.steps
        s2 = State(qu, transit, w, act, t)
        node_queue = q(qu) @ q(self.node_lanes.T)
        return s2, self.obs(s2), -node_queue, done, {
            "avg_queue": node_queue.mean(-1)}

    def step_autoreset(self, s: State, action, gen, offset=0, total=None,
                       q=identity):
        """``step``, then a fresh state for the rows that are done; the
        reset's queues are drawn (where ``init_density`` > 0) before the
        step, as the program's auto-reset draws them."""
        q0 = self._queues(gen, action.shape[0], offset, total)
        s2, obs, reward, done, info = self.step(s, action, q)
        fresh = self._fresh(q0)
        pick = lambda a, b: torch.where(
            done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b)
        s2 = State(*(pick(a, b) for a, b in zip(fresh, s2)))
        return s2, pick(self.obs(fresh), obs), reward, done, info
