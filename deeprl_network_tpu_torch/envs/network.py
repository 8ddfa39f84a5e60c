"""SUMO-free traffic-signal network engine, batched in PyTorch.

Counterpart of ``deeprl_network_tpu/envs/network.py``: the same
store-and-forward queue/flow dynamics (stop-line queues, an in-transit ring
buffer per lane with a static link delay, expected-space spillback, yellow
windows after a phase switch, entry demand dropped when a link is full),
written for B env instances at once. Every state leaf carries a leading
``[B]`` axis; the JAX engine's ``vmap`` becomes that axis, and its ``lax.scan``
over the 1-second substeps becomes a Python loop. The static tables are
built in numpy exactly as in the JAX engine, then moved to ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs.base import (
    Env, EnvSpec, hop_distances, uniform_rows,
)
from deeprl_network_tpu_torch.utils.device import resolve_device


@dataclass
class NetworkTopology:
    """Static description assembled by a scenario builder (grid).

    All arrays are numpy; lanes are movement queues with global indices.
    """

    n_node: int
    lane_node: np.ndarray         # [L] owning node
    phase_gate: np.ndarray        # [M, P_max, L] {0,1} discharge gates
    phase_valid: np.ndarray       # [M, P_max] {0,1}
    route: np.ndarray             # [L, L] turn fractions (rows sum <= 1)
    entry_lane: np.ndarray        # [L] {0,1}
    demand: np.ndarray            # [T_episode, L] veh/s external arrivals
    node_adj: np.ndarray          # [M, M] {0,1}
    node_lanes: List[List[int]]   # per node, ordered incoming lane ids
    lane_delay: np.ndarray = None  # [L] int link travel seconds (>= 1)

    @property
    def n_lane(self) -> int:
        return len(self.lane_node)


class NetworkState(NamedTuple):
    """Batched engine state; every leaf has a leading [B] axis."""

    queue: torch.Tensor       # [B, L] stop-line (halted) vehicles
    transit: torch.Tensor     # [B, D, L] in-transit ring buffer; row d
                              # joins the queue after d+1 more substeps
    wait: torch.Tensor        # [B, L] head-vehicle waiting seconds
    prev_phase: torch.Tensor  # [B, M] int64
    t: torch.Tensor           # [B] control-step count int64
    done: torch.Tensor        # [B] bool
    dropped: torch.Tensor     # [B] veh lost to full entry lanes


class TrafficNetworkEnv(Env):
    """Generic signalized network over a :class:`NetworkTopology`."""

    def __init__(self, cfg: EnvConfig, topo: NetworkTopology,
                 device="cuda"):
        self.cfg = cfg
        self.topo = topo
        self.device = resolve_device(device)
        M = topo.n_node
        n_a_ls = tuple(int(v.sum()) for v in topo.phase_valid)
        max_lanes = max(len(ls) for ls in topo.node_lanes)
        self.max_lanes = max_lanes
        self._use_wait = cfg.objective in ("wait", "hybrid")
        self._use_phase = bool(cfg.phase_in_obs)
        self._use_queue = bool(cfg.queue_in_obs)
        P_max = topo.phase_gate.shape[1]
        n_chan = 1 + int(self._use_queue) + int(self._use_wait)
        base_ls = [len(ls) * n_chan for ls in topo.node_lanes]
        n_s_ls = tuple(b + (n_a_ls[m] if self._use_phase else 0)
                       for m, b in enumerate(base_ls))
        dist = hop_distances(topo.node_adj)
        self.spec = EnvSpec(
            n_agent=M, n_s_ls=n_s_ls, n_a_ls=n_a_ls,
            neighbor_mask=topo.node_adj.astype(np.float32),
            distance_mask=dist, coop_gamma=cfg.coop_gamma)
        # obs gather [M, n_s_max] into the concatenated feature vector
        # (channels [wave(L); queue(L)?; wait(L)?]): each node's features
        # are PACKED left-aligned, so the first n_s_ls[i] dims are exactly
        # node i's valid features. Padded slots gather index 0 and are
        # zero-masked.
        width = max_lanes * n_chan + (P_max if self._use_phase else 0)
        gather = np.zeros((M, width), np.int64)
        gmask = np.zeros((M, width), np.float32)
        L = topo.n_lane
        for m, ls in enumerate(topo.node_lanes):
            k = len(ls)
            chan = 0
            gather[m, :k] = ls
            gmask[m, :k] = 1.0
            if self._use_queue:
                chan += 1
                gather[m, chan * k:(chan + 1) * k] = [L + l for l in ls]
                gmask[m, chan * k:(chan + 1) * k] = 1.0
            if self._use_wait:
                chan += 1
                off = int(self._use_queue) * L
                gather[m, chan * k:(chan + 1) * k] = [L + off + l
                                                      for l in ls]
                gmask[m, chan * k:(chan + 1) * k] = 1.0
        self._gather = gather
        self._gmask = gmask
        if self._use_phase:
            # static placement of the current-phase one-hot right after
            # each node's packed lane features (phase_in_obs)
            pmat = np.zeros((M, P_max, width), np.float32)
            for m in range(M):
                for p in range(n_a_ls[m]):
                    pmat[m, p, base_ls[m] + p] = 1.0
            self._phase_place = pmat
        self._node_lane_mask = np.zeros((M, topo.n_lane), np.float32)
        for m, ls in enumerate(topo.node_lanes):
            self._node_lane_mask[m, ls] = 1.0
        self.episode_steps = cfg.episode_steps_atsc
        assert topo.demand.shape[0] >= self.episode_steps
        # link travel time: static per-lane delay -> a one-hot [D, L]
        # scatter map; pushing routed vehicles onto the transit buffer is
        # then a broadcast multiply-add
        delay = (topo.lane_delay if topo.lane_delay is not None
                 else np.ones(topo.n_lane))
        delay = np.clip(np.asarray(delay, np.int64), 1, None)
        self.max_delay = int(delay.max())
        onehot = np.zeros((self.max_delay, topo.n_lane), np.float32)
        onehot[delay - 1, np.arange(topo.n_lane)] = 1.0
        self._delay_onehot = onehot

        # device copies of the static tables
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device)
        self._t_gather = torch.as_tensor(gather, device=self.device)
        self._t_gmask = f32(gmask)
        if self._use_phase:
            self._t_phase_place = f32(self._phase_place)
        self._t_node_lane_mask = f32(self._node_lane_mask)
        self._t_delay_onehot = f32(onehot)
        self._t_gate = f32(topo.phase_gate).reshape(M * P_max, L)
        self._t_valid = f32(topo.phase_valid)
        self._t_route = f32(topo.route)
        self._t_route_out = self._t_route.sum(1)
        self._t_entry = f32(topo.entry_lane)
        self._t_demand = f32(topo.demand)
        self._t_n_valid = torch.as_tensor(
            topo.phase_valid.sum(1).astype(np.int64), device=self.device)

    # ---- batched functions ----

    def reset(self, batch: int, generator: torch.Generator = None,
              offset: int = 0, total: Optional[int] = None
              ) -> Tuple[NetworkState, torch.Tensor]:
        """Fresh state for ``batch`` instances (rows ``[offset, offset +
        batch)`` of ``total``, see ``base.uniform_rows``). Queues start
        empty unless ``init_density > 0``, in which case they are drawn
        uniformly from ``generator``."""
        L, dev = self.topo.n_lane, self.device
        if self.cfg.init_density > 0:
            q0 = (uniform_rows((batch, L), generator, dev, offset, total)
                  * self.cfg.init_density * self.cfg.lane_capacity)
        else:
            q0 = torch.zeros((batch, L), device=dev)
        state = NetworkState(
            queue=q0,
            transit=torch.zeros((batch, self.max_delay, L), device=dev),
            wait=torch.zeros((batch, L), device=dev),
            prev_phase=torch.zeros((batch, self.topo.n_node), dtype=torch.int64,
                                   device=dev),
            t=torch.zeros((batch,), dtype=torch.int64, device=dev),
            done=torch.zeros((batch,), dtype=torch.bool, device=dev),
            dropped=torch.zeros((batch,), device=dev))
        return state, self._obs(state)

    def _obs(self, s: NetworkState) -> torch.Tensor:
        c = self.cfg
        # "wave" = all vehicles on the incoming lane: queued + approaching
        wave = s.queue + s.transit.sum(1)
        feats = torch.clamp(wave / c.norm_wave, 0.0, c.clip_wave)
        if self._use_queue:
            qn = torch.clamp(s.queue / c.norm_wave, 0.0, c.clip_wave)
            feats = torch.cat([feats, qn], -1)
        if self._use_wait:
            wt = torch.clamp(s.wait / c.norm_wait, 0.0, c.clip_wait)
            feats = torch.cat([feats, wt], -1)
        # packed per-agent: valid dims are the first n_s_ls[i] of each row
        out = feats[:, self._t_gather] * self._t_gmask
        if self._use_phase:
            onehot = torch.nn.functional.one_hot(
                s.prev_phase, self.topo.phase_gate.shape[1]).float()
            out = out + torch.einsum("bmp,mpw->bmw", onehot,
                                     self._t_phase_place)
        return out

    def step(self, s: NetworkState, action: torch.Tensor
             ) -> Tuple[NetworkState, torch.Tensor, torch.Tensor,
                        torch.Tensor, Dict[str, torch.Tensor]]:
        """action: [B, M] int phase index per node."""
        c = self.cfg
        cap = c.lane_capacity
        B = action.shape[0]
        P = self.topo.phase_gate.shape[1]
        # clamp invalid (padded) phases to 0 .. n_valid - 1
        act = torch.minimum(torch.clamp(action.long(), min=0),
                            self._t_n_valid - 1)
        # green gate of the chosen phase, per lane: [B, L]
        onehot = torch.nn.functional.one_hot(act, P).float()
        lane_gate = onehot.reshape(B, -1) @ self._t_gate
        switched = (act != s.prev_phase).float()               # [B, M]
        # yellow window: lanes of switched nodes see no green for the
        # first yellow_interval_sec substeps
        lane_switch = switched @ self._t_node_lane_mask        # [B, L]
        t_idx = torch.clamp(s.t, max=self.topo.demand.shape[0] - 1)
        demand_t = self._t_demand[t_idx]                       # [B, L]

        route, route_out = self._t_route, self._t_route_out
        delay_onehot = self._t_delay_onehot[None]              # [1, D, L]
        inflow = demand_t * self._t_entry
        q, transit, w, dropped = s.queue, s.transit, s.wait, s.dropped
        flows = arrivals_out = entered_in = None
        for k in range(c.control_interval_sec):
            # vehicles finishing link traversal join the stop-line queue
            arriving = transit[:, 0]
            transit = torch.cat(
                [transit[:, 1:], torch.zeros_like(transit[:, :1])], 1)
            q = q + arriving
            # arrivals past capacity are counted in `dropped`
            overflow = torch.clamp(q - cap, min=0.0)
            q = q - overflow
            yellow = 1.0 if k < c.yellow_interval_sec else 0.0
            g = lane_gate * (1.0 - yellow * lane_switch)
            # downstream space counts queued AND in-transit occupancy
            occ = q + transit.sum(1)
            space = torch.clamp(cap - occ, min=0.0) @ route.T
            # lanes whose flow exits the network are never blocked
            space = torch.where(route_out > 1e-6,
                                space / torch.clamp(route_out, min=1e-6),
                                torch.full_like(space, cap))
            dq = torch.minimum(torch.minimum(q, g * c.sat_flow), space)
            q2 = q - dq
            # routed vehicles enter the downstream link and arrive after
            # lane_delay[l'] substeps (one-hot scatter by static delay)
            routed = dq @ route
            transit = transit + delay_onehot * routed[:, None, :]
            # entry demand enters its boundary link, same travel delay
            free = torch.clamp(cap - (q2 + transit.sum(1)), min=0.0)
            accepted = torch.minimum(inflow, free)
            transit = transit + delay_onehot * accepted[:, None, :]
            dropped = (dropped + (inflow - accepted).sum(-1)
                       + overflow.sum(-1))
            served = (dq > 1e-4).float()
            w = (w + 1.0) * (q2 > 0.1).float() * (1.0 - served)
            arrived = (dq * torch.clamp(1.0 - route_out, min=0.0)).sum(-1)
            if flows is None:
                flows, arrivals_out = dq.sum(-1), arrived
                entered_in = accepted.sum(-1)
            else:
                flows = flows + dq.sum(-1)
                arrivals_out = arrivals_out + arrived
                entered_in = entered_in + accepted.sum(-1)
            q = q2

        t_new = s.t + 1
        done = t_new >= self.episode_steps
        s_new = NetworkState(queue=q, transit=transit, wait=w,
                             prev_phase=act, t=t_new, done=done,
                             dropped=dropped)
        node_queue = q @ self._t_node_lane_mask.T               # [B, M]
        node_wait = w @ self._t_node_lane_mask.T
        if c.objective == "queue":
            reward = -node_queue
        elif c.objective == "wait":
            reward = -node_wait
        else:  # hybrid
            reward = -(node_queue + c.coef_wait * node_wait)
        info = {"avg_queue": node_queue.mean(-1),
                "avg_wait": node_wait.mean(-1),
                "throughput": flows,
                "arrived": arrivals_out,
                "entered": entered_in,
                "dropped": dropped}
        return s_new, self._obs(s_new), reward.float(), done, info

    def record(self, s: NetworkState) -> Dict[str, torch.Tensor]:
        """Per-step traffic series (queue / wait / wave per node), each
        with the leading [B] axis."""
        node_mask_t = self._t_node_lane_mask.T
        in_transit = s.transit.sum(1)
        return {"node_queue": s.queue @ node_mask_t,
                "node_wait": s.wait @ node_mask_t,
                "node_wave": (s.queue + in_transit) @ node_mask_t,
                "total_queue": s.queue.sum(-1),
                "total_transit": in_transit.sum(-1),
                "dropped": s.dropped}

    # ---- greedy baseline ----

    def greedy_action(self, s: NetworkState, on: str = "wave",
                      delta: float = 0.0) -> torch.Tensor:
        """[B, M] int64: per node, the valid phase serving the largest
        demand (the first such phase on a tie).

        ``on='wave'`` scores phases by all vehicles on the served lanes
        (queued + approaching), the observation the learned policies get;
        ``on='queue'`` by stop-line queues only. ``delta > 0`` adds
        hysteresis: keep the current phase unless the best competing
        phase's score exceeds it by more than ``delta`` vehicles (every
        switch costs ``yellow_interval_sec`` of lost discharge)."""
        M, P = self._t_valid.shape
        x = s.queue if on == "queue" else s.queue + s.transit.sum(1)
        served = (x @ self._t_gate.T).reshape(-1, M, P)
        served = torch.where(self._t_valid > 0, served,
                             torch.full_like(served, -torch.inf))
        best = torch.argmax(served, dim=-1)
        if delta <= 0:
            return best
        prev = s.prev_phase
        keep = torch.gather(served, -1, prev[..., None])[..., 0]
        top = torch.gather(served, -1, best[..., None])[..., 0]
        return torch.where(top > keep + delta, best, prev)

    def controller_action(self, s: NetworkState) -> torch.Tensor:
        """The strongest known hand controller of this env family:
        hysteresis at ``cfg.hysteresis_delta``, scored on
        ``cfg.hysteresis_on``. The naive baseline of record and the
        kickstart teacher."""
        return self.greedy_action(s, on=str(self.cfg.hysteresis_on),
                                  delta=float(self.cfg.hysteresis_delta))

    def prev_action(self, s: NetworkState) -> torch.Tensor:
        """[B, M] previous control action (current signal phase)."""
        return s.prev_phase
