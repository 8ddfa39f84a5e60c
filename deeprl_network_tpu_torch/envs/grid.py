"""5x5 grid ATSC scenario, a copy of ``deeprl_network_tpu/envs/grid.py``
(reference envs/large_grid_env.py +
envs/large_grid_data/build_file.py; SURVEY.md section 2.2 item 7).

Topology: 25 four-way intersections nt1..nt25 on a 5x5 lattice (reference
node naming / neighbor map `_init_neighbor_map`). Every approach has 3
movement queues (left / through / right), so each node observes 12 "wave"
lanes — the reference's 12-lane state. Uniform action space of 5 green
phases (reference LargeGridPhase; exact SUMO ryg strings are unverifiable
[M], the movement sets below are the design choice of record):

    p0: N+S through + right      p1: N+S left
    p2: E+W through + right      p3: E+W left
    p4: all right turns (permissive clearing phase)

Demand reproduces the reference build_file.py pattern in structure: two
flow groups with time-shifted trapezoidal profiles — group 1 (west/east
boundary origins) peaking at ``peak_flow1`` veh/hr, group 2 (north/south
origins) at ``peak_flow2`` veh/hr, switching over the hour-long episode.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs.network import (
    NetworkTopology, TrafficNetworkEnv,
)

# directions: index 0=N, 1=E, 2=S, 3=W; approach d = traffic arriving FROM
# that side. movements: 0=left, 1=through, 2=right.
DIRS = ["N", "E", "S", "W"]
DR = {"N": (-1, 0), "E": (0, 1), "S": (1, 0), "W": (0, -1)}
# heading of traffic approaching from side d (e.g. from N it travels S)
HEADING = {"N": "S", "E": "W", "S": "N", "W": "E"}
LEFT_OF = {"S": "E", "W": "S", "N": "W", "E": "N"}   # left turn of heading
RIGHT_OF = {"S": "W", "W": "N", "N": "E", "E": "S"}  # right turn of heading

# phase -> list of (approach_dir, movement) that get green
GRID_PHASES: List[List[Tuple[str, int]]] = [
    [("N", 1), ("N", 2), ("S", 1), ("S", 2)],
    [("N", 0), ("S", 0)],
    [("E", 1), ("E", 2), ("W", 1), ("W", 2)],
    [("E", 0), ("W", 0)],
    [("N", 2), ("E", 2), ("S", 2), ("W", 2)],
]

# turn fractions applied when routing a discharged vehicle into the next
# node's movement lanes (and for boundary demand): left/through/right
TURN_FRACTIONS = np.array([0.25, 0.5, 0.25])


def build_grid_topology(cfg: EnvConfig, size: int = 5) -> NetworkTopology:
    M = size * size

    def node_id(r, c):
        return r * size + c

    # lanes: (node, approach, movement) for all 4 approaches x 3 movements
    lane_id: Dict[Tuple[int, str, int], int] = {}
    lanes: List[Tuple[int, str, int]] = []
    for n in range(M):
        for d in DIRS:
            for mv in range(3):
                lane_id[(n, d, mv)] = len(lanes)
                lanes.append((n, d, mv))
    L = len(lanes)

    node_adj = np.zeros((M, M), np.float32)
    for r in range(size):
        for c in range(size):
            n = node_id(r, c)
            for d in DIRS:
                dr, dc = DR[d]
                rr, cc = r + dr, c + dc
                if 0 <= rr < size and 0 <= cc < size:
                    node_adj[n, node_id(rr, cc)] = 1.0

    # routing: lane (n, d, mv) discharges vehicles heading out_dir; they
    # travel to the neighbor node in out_dir and arrive at its approach
    # opposite(out_dir), splitting over movements by TURN_FRACTIONS.
    OPP = {"N": "S", "S": "N", "E": "W", "W": "E"}
    route = np.zeros((L, L), np.float32)
    for li, (n, d, mv) in enumerate(lanes):
        heading = HEADING[d]
        out_dir = (heading if mv == 1
                   else LEFT_OF[heading] if mv == 0 else RIGHT_OF[heading])
        r, c = divmod(n, size)
        dr, dc = DR[out_dir]
        rr, cc = r + dr, c + dc
        if not (0 <= rr < size and 0 <= cc < size):
            continue  # exits the network
        n2 = node_id(rr, cc)
        arr_approach = OPP[out_dir]
        for mv2 in range(3):
            route[li, lane_id[(n2, arr_approach, mv2)]] = TURN_FRACTIONS[mv2]

    # phase gates
    P = len(GRID_PHASES)
    phase_gate = np.zeros((M, P, L), np.float32)
    for n in range(M):
        for p, movements in enumerate(GRID_PHASES):
            for d, mv in movements:
                phase_gate[n, p, lane_id[(n, d, mv)]] = 1.0
    phase_valid = np.ones((M, P), np.float32)

    # entry lanes: approaches on the boundary (no upstream neighbor)
    entry = np.zeros((L,), np.float32)
    entry_side = {}
    for li, (n, d, mv) in enumerate(lanes):
        r, c = divmod(n, size)
        dr, dc = DR[d]
        rr, cc = r + dr, c + dc
        if not (0 <= rr < size and 0 <= cc < size):
            entry[li] = 1.0
            entry_side[li] = d

    demand = build_grid_demand(cfg, lanes, entry_side)

    node_lanes = [[lane_id[(n, d, mv)] for d in DIRS for mv in range(3)]
                  for n in range(M)]
    # uniform link travel time: the grid's SUMO links are equal-length
    # (reference build_file.py lattice), so every approach — boundary
    # entries included — takes cfg.link_delay_sec to traverse
    lane_delay = np.full((L,), max(int(cfg.link_delay_sec), 1), np.int32)
    return NetworkTopology(
        n_node=M,
        lane_node=np.array([n for (n, _, _) in lanes], np.int32),
        phase_gate=phase_gate, phase_valid=phase_valid, route=route,
        entry_lane=entry, demand=demand, node_adj=node_adj,
        node_lanes=node_lanes, lane_delay=lane_delay)


def build_grid_demand(cfg: EnvConfig, lanes, entry_side) -> np.ndarray:
    """Per-control-step external arrival rates [T, L] in veh/s.

    Reference build_file.py: time-varying multi-origin flows with
    peak_flow1 (major) and peak_flow2 (minor) switching groups [M]. Here:
    trapezoidal profiles — group 1 (E/W origins) ramps 0->peak over
    [0, 0.15], holds to 0.4, decays by 0.6; group 2 (N/S origins) shifted
    to [0.3, 0.55, 0.9] of the episode.
    """
    T = cfg.episode_steps_atsc
    L = len(lanes)
    tau = np.arange(T) / max(T - 1, 1)

    def trapezoid(t0, t1, t2, t3):
        y = np.zeros(T)
        ramp = (tau - t0) / max(t1 - t0, 1e-6)
        hold = np.ones(T)
        down = 1.0 - (tau - t2) / max(t3 - t2, 1e-6)
        y = np.where(tau < t0, 0.0,
                     np.where(tau < t1, ramp,
                              np.where(tau < t2, hold,
                                       np.where(tau < t3, down, 0.0))))
        return y

    g1 = trapezoid(0.0, 0.15, 0.40, 0.60) * cfg.peak_flow1 / 3600.0
    g2 = trapezoid(0.30, 0.45, 0.70, 0.90) * cfg.peak_flow2 / 3600.0
    demand = np.zeros((T, L), np.float32)
    for li, side in entry_side.items():
        # split each boundary approach's inflow over its 3 movement lanes
        mv = lanes[li][2]
        frac = TURN_FRACTIONS[mv] * cfg.demand_scale
        if side in ("E", "W"):
            demand[:, li] = g1 * frac
        else:
            demand[:, li] = g2 * frac
    return demand


class LargeGridEnv(TrafficNetworkEnv):
    """25-agent 5x5 grid (reference LargeGridEnv), batched on ``device``."""

    def __init__(self, cfg: EnvConfig, device="cuda"):
        super().__init__(cfg, build_grid_topology(cfg, size=5), device)
