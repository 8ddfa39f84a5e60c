"""SUMO-free traffic-signal network engine, batched in PyTorch.

Counterpart of ``deeprl_network_tpu/envs/network.py``: the same
store-and-forward queue/flow dynamics (stop-line queues, an in-transit ring
buffer per lane with a static link delay, expected-space spillback, yellow
windows after a phase switch, entry demand dropped when a link is full),
written for B env instances at once. Every state leaf carries a leading
``[B]`` axis; the JAX engine's ``vmap`` becomes that axis. Its step, the
1-second substeps that XLA fuses into one computation, is one kernel launch
on the card (``ops/network_env.py``; the plain PyTorch twin on the CPU),
with the auto-reset select folded in by ``step_autoreset``. The static
tables are built in numpy exactly as in the JAX engine, then moved to
``device``.
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
from deeprl_network_tpu_torch.ops.network_env import (
    EnvScalars, NetworkEnvTables, network_env_step, network_obs_ref,
    reset_state,
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
        # link travel time: static per-lane delay (a one-hot [D, L] scatter
        # map in the twin, a slot per lane in the kernel)
        delay = (topo.lane_delay if topo.lane_delay is not None
                 else np.ones(topo.n_lane))
        delay = np.clip(np.asarray(delay, np.int64), 1, None)
        self.max_delay = int(delay.max())

        # the step's tables on the device, and the names reset, record and
        # the greedy controllers read
        self.tables = NetworkEnvTables(
            topo, gather, gmask,
            self._phase_place if self._use_phase else None,
            self._node_lane_mask, delay, self._use_queue, self._use_wait,
            self.device)
        self.scalars = EnvScalars.from_config(cfg)
        self._t_gate = self.tables.gate
        self._t_valid = self.tables.valid
        self._t_node_lane_mask = self.tables.node_lane_mask

    # ---- batched functions ----

    def _reset_queue(self, batch: int, generator: torch.Generator = None,
                     offset: int = 0, total: Optional[int] = None
                     ) -> Optional[torch.Tensor]:
        """The reset's queues: drawn uniformly from ``generator`` when
        ``init_density > 0`` (rows ``[offset, offset + batch)`` of
        ``total``, see ``base.uniform_rows``), else None (empty)."""
        if self.cfg.init_density <= 0:
            return None
        return (uniform_rows((batch, self.topo.n_lane), generator,
                             self.device, offset, total)
                * self.cfg.init_density * self.cfg.lane_capacity)

    def reset(self, batch: int, generator: torch.Generator = None,
              offset: int = 0, total: Optional[int] = None
              ) -> Tuple[NetworkState, torch.Tensor]:
        """Fresh state for ``batch`` instances (rows ``[offset, offset +
        batch)`` of ``total``, see ``base.uniform_rows``). Queues start
        empty unless ``init_density > 0``, in which case they are drawn
        uniformly from ``generator``."""
        state = reset_state(NetworkState, self.tables, batch,
                            self._reset_queue(batch, generator, offset,
                                              total))
        return state, self._obs(state)

    def _obs(self, s: NetworkState) -> torch.Tensor:
        return network_obs_ref(self.tables, self.scalars, s)

    def step(self, s: NetworkState, action: torch.Tensor
             ) -> Tuple[NetworkState, torch.Tensor, torch.Tensor,
                        torch.Tensor, Dict[str, torch.Tensor]]:
        """action: [B, M] int phase index per node. One launch of the env
        kernel on the card (``ops/network_env.py``), its plain twin on the
        CPU."""
        return network_env_step(self.tables, self.scalars, s,
                                action.long().contiguous())

    def step_autoreset(self, s: NetworkState, action: torch.Tensor,
                       generator: torch.Generator = None, offset: int = 0,
                       total: Optional[int] = None):
        """``step`` and, for rows that are done, a fresh reset in the same
        launch: what ``AutoResetEnv.step`` returns (state and obs of the
        reset where done; reward, done and info of the transition). The
        reset's draw, if any, is taken from ``generator`` as ``reset``
        takes it, after the step's."""
        q0 = self._reset_queue(action.shape[0], generator, offset, total)
        return network_env_step(self.tables, self.scalars, s,
                                action.long().contiguous(), q0,
                                auto_reset=True)

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
