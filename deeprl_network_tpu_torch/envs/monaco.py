"""Monaco-scale irregular ATSC scenario, a copy of
``deeprl_network_tpu/envs/monaco.py`` (reference envs/real_net_env.py +
envs/real_net_data/; SURVEY.md section 2.2 item 8).

The reference drives an OSM-derived Monaco subnet (~28 signalized nodes,
heterogeneous 2-6 phase action spaces, hand-written neighbor_map) through
SUMO. The OSM data is unavailable (empty reference mount) and SUMO is gone
by design, so this module ships a *fixed, deterministic* irregular network
with the published network's structure (see DEFAULT_DATA below): 28
signalized nodes on an irregular planar graph (degree 1-4, boundary
spurs), per-node heterogeneous action counts (explicit phase tables,
2-6 actions), heterogeneous observation sizes, boundary demand with the
peak_flow1/peak_flow2 profiles, all running on the generic
store-and-forward engine (envs/network.py). The topology and demand
functions are numpy, as in the JAX package; the graph file is this
package's own copy.

Lane model for irregular graphs: an approach is an (in-neighbor -> node)
link, including virtual EXT approaches at boundary entry nodes; each
approach owns one movement queue per out-neighbor (no U-turns), plus an
exit movement at boundary nodes. Phases gate whole approaches: each node's
phase list is the singles (one approach green) plus, for 4-approach
nodes, combined opposite-pair phases — giving n_a from 2 to 6.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs.network import (
    NetworkTopology, TrafficNetworkEnv,
)

# The default graph ships as checked-in data (the "real_net_data" of
# this rebuild): real_net_data/monaco_28.json, matching the published
# Monaco network's STRUCTURE — 28 signalized nodes [H], irregular
# planar coastal-strip graph (degree histogram {1:4, 2:8, 3:14, 4:2},
# including boundary spurs characteristic of OSM signal subnets) and
# heterogeneous explicit phase tables with n_a spanning 2-6 (histogram
# {2:8, 3:8, 4:6, 5:4, 6:2}) [M] — see the JSON's _provenance field and
# tests/test_monaco_env.py::test_default_topology_structure (the two
# packages' files are held byte-equal by tests/test_torch_monaco.py).
DEFAULT_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "real_net_data", "monaco_28.json")

EXT = -1  # virtual exterior neighbor id


def load_network_data(path: str):
    """External network-data loader (reference envs/real_net_data/): a
    JSON file with the real OSM-derived graph can be dropped in if it
    becomes available, replacing the synthetic default. Schema:

        {"nodes":  [{"x": 0.0, "y": 0.0}, ...],     # planar coordinates
         "edges":  [[0, 1], ...],                   # undirected links
         "entry_nodes": [0, 6, ...],                # boundary demand/exit
         "phases": {"3": [[0], [1, 4]], ...}}       # OPTIONAL: per-node
                                                    # approach-group lists
                                                    # (by neighbor id;
                                                    # default: derived)

    Returns (node_xy [M,2] float, edges list, entry_nodes list,
    phases dict[int -> list[list[int]]] or {}).
    """
    with open(path) as f:
        d = json.load(f)
    node_xy = np.array([(n["x"], n["y"]) for n in d["nodes"]], np.float64)
    edges = [tuple(int(x) for x in e) for e in d["edges"]]
    entry_nodes = [int(n) for n in d["entry_nodes"]]
    phases = {int(k): [[int(f) for f in ph] for ph in v]
              for k, v in d.get("phases", {}).items()}
    return node_xy, edges, entry_nodes, phases


# the default graph, loaded once at import (kept as module attributes for
# introspection/tests; build_monaco_topology re-reads the file so a
# cfg.network_data drop-in never sees stale state)
NODE_XY, EDGES, ENTRY_NODES, DEFAULT_PHASES = load_network_data(DEFAULT_DATA)


def build_monaco_topology(cfg: EnvConfig) -> NetworkTopology:
    node_xy, edges, entry_nodes, phase_override = load_network_data(
        getattr(cfg, "network_data", "") or DEFAULT_DATA)
    M = len(node_xy)
    nbrs: List[List[int]] = [[] for _ in range(M)]
    for a, b in edges:
        nbrs[a].append(b)
        nbrs[b].append(a)
    for i in range(M):
        nbrs[i] = sorted(nbrs[i])

    node_adj = np.zeros((M, M), np.float32)
    for a, b in edges:
        node_adj[a, b] = node_adj[b, a] = 1.0

    # approaches: (node, from) where from in nbrs[node] (+ EXT at entries)
    # movements: (node, from, to) with to in nbrs[node]+[EXT at entries],
    # to != from
    lane_id: Dict[Tuple[int, int, int], int] = {}
    lanes: List[Tuple[int, int, int]] = []
    approaches: List[List[int]] = [[] for _ in range(M)]  # list of 'from'
    for n in range(M):
        froms = list(nbrs[n]) + ([EXT] if n in entry_nodes else [])
        approaches[n] = froms
        for f in froms:
            tos = [t for t in nbrs[n] if t != f]
            if n in entry_nodes and f != EXT:
                tos.append(EXT)  # exit movement at boundary nodes
            for t in tos:
                lane_id[(n, f, t)] = len(lanes)
                lanes.append((n, f, t))
    L = len(lanes)

    # routing: movement (n, f, t) with t != EXT discharges into node t,
    # arriving from n, splitting uniformly over t's movements from n.
    route = np.zeros((L, L), np.float32)
    for li, (n, f, t) in enumerate(lanes):
        if t == EXT:
            continue
        dests = [(t, n, t2) for t2 in
                 ([x for x in nbrs[t] if x != n]
                  + ([EXT] if t in entry_nodes else []))]
        dests = [d for d in dests if d in lane_id]
        if not dests:
            continue
        w = 1.0 / len(dests)
        for d in dests:
            route[li, lane_id[d]] = w

    # phases: per node, singles (one approach all-green) plus, for
    # 4-approach nodes, two combined phases pairing far-apart approaches.
    # Loaded data may override per node with explicit approach groups
    # (the real RealNetPhase tables, once available).
    phase_sets: List[List[List[int]]] = []  # per node: list of approach-lists
    for n in range(M):
        fr = approaches[n]
        if n in phase_override:
            phase_sets.append([list(g) for g in phase_override[n]][:6])
            continue
        singles = [[f] for f in fr]
        phases = list(singles)
        if len(fr) >= 4:
            # pair approaches by opposing geometry: (0,2) and (1,3) of the
            # sorted list — crude but fixed
            phases.append([fr[0], fr[2]])
            if len(fr) >= 4:
                phases.append([fr[1], fr[3]])
        phase_sets.append(phases[:6])  # cap at 6 actions

    P_max = max(len(p) for p in phase_sets)
    phase_gate = np.zeros((M, P_max, L), np.float32)
    phase_valid = np.zeros((M, P_max), np.float32)
    for n in range(M):
        for p, fr_list in enumerate(phase_sets[n]):
            phase_valid[n, p] = 1.0
            for li, (nn, f, t) in enumerate(lanes):
                if nn == n and f in fr_list:
                    phase_gate[n, p, li] = 1.0

    entry = np.zeros((L,), np.float32)
    entry_ids = []
    for li, (n, f, t) in enumerate(lanes):
        if f == EXT:
            entry[li] = 1.0
            entry_ids.append(li)

    demand = build_monaco_demand(cfg, lanes, entry_ids)

    node_lanes = [[li for li, (n, f, t) in enumerate(lanes) if n == m]
                  for m in range(M)]
    # heterogeneous link travel times scaled by planar edge length: a lane
    # (n, f, t) queues at n fed by the f->n link; cfg.link_delay_sec is
    # the travel time of a unit-length edge (EXT boundary links use it
    # directly). Irregular delays are part of the Monaco task structure.
    base = max(int(cfg.link_delay_sec), 1)
    lane_delay = np.zeros((L,), np.int32)
    # normalize planar distances by the MEAN edge length so the scale of
    # the coordinates (unit-lattice synthetic graph vs meters in real OSM
    # drop-ins) cancels: a mean-length edge takes `base` seconds either
    # way, and only the relative heterogeneity survives (ADVICE round 2:
    # raw meter coordinates would saturate every lane at 3*base).
    edge_lens = [float(np.linalg.norm(node_xy[n] - node_xy[f]))
                 for (n, f, t) in lanes if f != EXT]
    mean_len = max(float(np.mean(edge_lens)) if edge_lens else 1.0, 1e-9)
    for li, (n, f, t) in enumerate(lanes):
        if f == EXT:
            lane_delay[li] = base
        else:
            d = float(np.linalg.norm(node_xy[n] - node_xy[f])) / mean_len
            lane_delay[li] = int(np.clip(round(d * base), 1, 3 * base))
    return NetworkTopology(
        n_node=M,
        lane_node=np.array([n for (n, _, _) in lanes], np.int32),
        phase_gate=phase_gate, phase_valid=phase_valid, route=route,
        entry_lane=entry, demand=demand, node_adj=node_adj,
        node_lanes=node_lanes, lane_delay=lane_delay)


def build_monaco_demand(cfg: EnvConfig, lanes, entry_ids) -> np.ndarray:
    """Two time-shifted trapezoidal flow groups over the entry lanes,
    alternating by entry index (reference real_net_data flow sampling)."""
    T = cfg.episode_steps_atsc
    L = len(lanes)
    tau = np.arange(T) / max(T - 1, 1)

    def trap(t0, t1, t2, t3):
        return np.where(
            tau < t0, 0.0,
            np.where(tau < t1, (tau - t0) / max(t1 - t0, 1e-6),
                     np.where(tau < t2, 1.0,
                              np.where(tau < t3,
                                       1.0 - (tau - t2) / max(t3 - t2, 1e-6),
                                       0.0))))

    g1 = trap(0.0, 0.2, 0.5, 0.7) * cfg.peak_flow1 / 3600.0
    g2 = trap(0.25, 0.45, 0.75, 0.95) * cfg.peak_flow2 / 3600.0
    demand = np.zeros((T, L), np.float32)
    # each entry approach splits its inflow over its movement lanes
    by_approach: Dict[Tuple[int, int], List[int]] = {}
    for li in entry_ids:
        n, f, t = lanes[li]
        by_approach.setdefault((n, f), []).append(li)
    for k, ((n, f), lis) in enumerate(sorted(by_approach.items())):
        prof = g1 if k % 2 == 0 else g2
        for li in lis:
            demand[:, li] = prof / len(lis) * cfg.demand_scale
    return demand


class RealNetEnv(TrafficNetworkEnv):
    """28-agent Monaco-scale irregular network (reference RealNetEnv),
    batched on ``device``."""

    def __init__(self, cfg: EnvConfig, device="cuda"):
        super().__init__(cfg, build_monaco_topology(cfg), device)
