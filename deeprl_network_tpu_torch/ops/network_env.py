"""One control step of the store-and-forward ATSC engine: the CUDA kernel,
its plain twin, and the tables both read.

Counterpart of ``TrafficNetworkEnv.step`` in
``deeprl_network_tpu/envs/network.py``, whose 1-second substeps the JAX
package unrolls (``lax.scan(..., unroll=control_interval_sec)``) so that XLA
fuses the whole step into one computation. Here the step is one launch of
``csrc/network_env.cu`` for all B env rows: the phase clamp and lane gates,
the yellow window, the substeps in the reference's op order, the node
rewards, ``info``, ``t``/``done``, the observation and, with ``auto_reset``,
the per-row select of a fresh reset state where ``done`` (the observation is
then that of the selected state, as ``AutoResetEnv.step`` returns it).

Dispatch is by the tensors' device: CUDA tensors launch the kernel (and
raise if the launch fails; there is no fallback), CPU tensors run the plain
twin ``network_env_step_ref``, the PyTorch engine of ``envs/network.py``
moved here. The wrapper counts its launches in ``LAUNCHES``. Every output is
a new tensor: the input state is never written, since the rollout reads the
pre-step state after the step.

``NetworkEnvTables`` holds both forms of the static tables: the dense ones
the twin multiplies by (``gate``, ``route``, ``node_lane_mask``, ...) and
the sparse ones the kernel walks (route rows in CSR for ``space``, route
columns in CSC for ``routed``, each lane's delay slot, owning node and gate
row, each node's lane list). The sparse ones lie in one int32 and one f32
tensor (``ints``, ``floats``); their named fields are views of those.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from deeprl_network_tpu_torch.ops import _build
from deeprl_network_tpu_torch.ops.lstm_cell import _carve

# kernel launches by name, counted by the wrapper where it launches
LAUNCHES = {"network_env_step": 0}

INFO_KEYS = ("avg_queue", "avg_wait", "throughput", "arrived", "entered",
             "dropped")
_OBJECTIVES = {"queue": 0, "wait": 1}      # anything else: hybrid (2)
# the kernel's Dims struct (csrc/network_env.cu), field for field: sizes and
# obs channels, offsets of the int32 tables, of the f32 tables, then the
# configuration's integers
_DIMS = ("L", "M", "P", "D", "W", "T_dem", "use_queue", "use_wait",
         "use_phase",
         "row_ptr", "row_col", "col_ptr", "col_row", "lane_slot", "lane_node",
         "node_ptr", "node_lane", "gather32", "phase_col", "n_valid32",
         "row_val", "col_val", "route_out", "entry", "demand", "lane_gate",
         "gmask",
         "episode_steps", "control_interval_sec", "yellow_interval_sec",
         "objective")
# the kernel's Scalars struct, field for field
_SCALARS = ("lane_capacity", "sat_flow", "norm_wave", "clip_wave",
            "norm_wait", "clip_wait", "coef_wait")
_lib: Optional[ctypes.CDLL] = None


class EnvScalars(NamedTuple):
    """The configuration numbers of one step (from an ``EnvConfig``)."""

    lane_capacity: float
    sat_flow: float
    norm_wave: float
    clip_wave: float
    norm_wait: float
    clip_wait: float
    coef_wait: float
    objective: str
    control_interval_sec: int
    yellow_interval_sec: int
    episode_steps: int

    @classmethod
    def from_config(cls, cfg) -> "EnvScalars":
        return cls(float(cfg.lane_capacity), float(cfg.sat_flow),
                   float(cfg.norm_wave), float(cfg.clip_wave),
                   float(cfg.norm_wait), float(cfg.clip_wait),
                   float(cfg.coef_wait), str(cfg.objective),
                   int(cfg.control_interval_sec),
                   int(cfg.yellow_interval_sec), int(cfg.episode_steps_atsc))


def _csr(mat: np.ndarray):
    """(row pointers, column indices, values) of ``mat``'s nonzeros, each
    row's in ascending column order."""
    rows, cols = np.nonzero(mat)
    ptr = np.zeros(mat.shape[0] + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr), cols, mat[rows, cols]


class NetworkEnvTables:
    """The static tables of one ``TrafficNetworkEnv`` on its device, built
    once from the numpy tables the env assembles: ``topo`` (a
    ``NetworkTopology``), the obs gather map ``gather``/``gmask`` [M, W],
    the phase one-hot placement ``phase_place`` [M, P, W] (None without
    ``phase_in_obs``), ``node_lane_mask`` [M, L], ``delay`` [L] (link
    travel seconds, >= 1) and the obs channels.

    The kernel takes two simplifications that hold on every topology the
    port builds (the 3x3, 5x5 and 10x10 grids and Monaco-28); the
    constructor raises on a topology that breaks them: each lane is in
    exactly one node's lane list, and ``phase_gate[m, :, l]`` is zero
    unless lane l is in node m's list. The lane gate and the yellow switch
    are then per-lane gathers."""

    def __init__(self, topo, gather: np.ndarray, gmask: np.ndarray,
                 phase_place: Optional[np.ndarray],
                 node_lane_mask: np.ndarray, delay: np.ndarray,
                 use_queue: bool, use_wait: bool, device):
        L, M = topo.n_lane, topo.n_node
        P = topo.phase_gate.shape[1]
        D = int(delay.max())
        W = gather.shape[1]
        self.L, self.M, self.P, self.D, self.W = L, M, P, D, W
        self.use_queue, self.use_wait = bool(use_queue), bool(use_wait)
        self.use_phase = phase_place is not None
        self.device = device

        # each lane in exactly one node's list, gated by that node only
        lane_node = np.full(L, -1, np.int64)
        for m, ls in enumerate(topo.node_lanes):
            for l in ls:
                if lane_node[l] >= 0:
                    raise ValueError(f"lane {l} is in the lane lists of "
                                     f"nodes {lane_node[l]} and {m}")
                lane_node[l] = m
        if (lane_node < 0).any():
            raise ValueError(f"lanes {np.nonzero(lane_node < 0)[0]} are in "
                             "no node's lane list")
        foreign = topo.phase_gate.copy()
        foreign[lane_node, :, np.arange(L)] = 0.0
        if foreign.any():
            raise ValueError("a phase of one node gates a lane of another")
        n_valid = topo.phase_valid.sum(1).astype(np.int64)
        phase_col = np.full(M, -1, np.int64)
        if self.use_phase:
            # the one-hot of phase p < n_valid[m] sits at column
            # phase_col[m] + p of node m's row
            phase_col = np.argmax(phase_place[:, 0], axis=1)
            rebuilt = np.zeros_like(phase_place)
            for m in range(M):
                for p in range(n_valid[m]):
                    rebuilt[m, p, phase_col[m] + p] = 1.0
            if not np.array_equal(rebuilt, phase_place):
                raise ValueError("phase_place is not a one-hot placement "
                                 "after each node's lane features")
        route = np.asarray(topo.route, np.float32)
        row_ptr, row_col, row_val = _csr(route)
        col_ptr, col_row, col_val = _csr(route.T)
        node_ptr, node_lane, _ = _csr(node_lane_mask)
        # route_out in the twin's f32 sum order, one copy for both paths
        route_out = torch.as_tensor(route).sum(1).numpy()
        ints = dict(row_ptr=row_ptr, row_col=row_col, col_ptr=col_ptr,
                    col_row=col_row, lane_slot=delay - 1,
                    lane_node=lane_node, node_ptr=node_ptr,
                    node_lane=node_lane, gather32=gather,
                    phase_col=phase_col, n_valid32=n_valid)
        floats = dict(row_val=row_val, col_val=col_val, route_out=route_out,
                      entry=topo.entry_lane, demand=topo.demand,
                      lane_gate=topo.phase_gate[lane_node, :, np.arange(L)],
                      gmask=gmask)
        self.ints, self._int_off = self._pack(ints, np.int32)
        self.floats, self._float_off = self._pack(floats, np.float32)

        # the twin's dense tables
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=device)
        self.gate = f32(topo.phase_gate).reshape(M * P, L)
        self.valid = f32(topo.phase_valid)
        self.node_lane_mask = f32(node_lane_mask)
        onehot = np.zeros((D, L), np.float32)
        onehot[delay - 1, np.arange(L)] = 1.0
        self.delay_onehot = f32(onehot)
        self.route = f32(route)
        self.n_valid = torch.as_tensor(n_valid, device=device)
        self.gather = torch.as_tensor(gather, dtype=torch.int64,
                                      device=device)
        self.phase_place = None if phase_place is None else f32(phase_place)
        self._c_args: Dict[EnvScalars, tuple] = {}

    def _pack(self, arrays, dtype):
        """One device tensor of numpy ``dtype`` holding ``arrays`` one after
        another; each becomes an attribute, a view of its piece. Returns
        (tensor, {name: offset})."""
        arrays = {k: np.asarray(a) for k, a in arrays.items()}
        offsets, at = {}, 0
        for name, a in arrays.items():
            offsets[name] = at
            at += a.size
        packed = torch.as_tensor(np.concatenate(
            [a.ravel() for a in arrays.values()]).astype(dtype),
            device=self.device)
        for name, a in arrays.items():
            off = offsets[name]
            setattr(self, name, packed[off:off + a.size].view(a.shape))
        return packed, offsets

    def c_args(self, scalars: EnvScalars):
        """The kernel's Dims and Scalars structs as ctypes arrays (kept per
        ``scalars``)."""
        got = self._c_args.get(scalars)
        if got is None:
            vals = dict(
                L=self.L, M=self.M, P=self.P, D=self.D, W=self.W,
                T_dem=int(self.demand.shape[0]),
                use_queue=int(self.use_queue), use_wait=int(self.use_wait),
                use_phase=int(self.use_phase),
                objective=_OBJECTIVES.get(scalars.objective, 2),
                **self._int_off, **self._float_off,
                **{k: getattr(scalars, k) for k in (
                    "episode_steps", "control_interval_sec",
                    "yellow_interval_sec")})
            dims = (ctypes.c_int * len(_DIMS))(*(int(vals[k])
                                                 for k in _DIMS))
            scal = (ctypes.c_float * len(_SCALARS))(
                *(getattr(scalars, k) for k in _SCALARS))
            got = self._c_args[scalars] = (dims, scal)
        return got


def reset_state(state_type, tables: NetworkEnvTables, batch: int,
                q0: Optional[torch.Tensor] = None):
    """A fresh state of ``batch`` rows: queues ``q0`` (empty when None),
    nothing in transit, no wait, phase 0, t 0, not done."""
    L, dev = tables.L, tables.device
    return state_type(
        queue=torch.zeros((batch, L), device=dev) if q0 is None else q0,
        transit=torch.zeros((batch, tables.D, L), device=dev),
        wait=torch.zeros((batch, L), device=dev),
        prev_phase=torch.zeros((batch, tables.M), dtype=torch.int64,
                               device=dev),
        t=torch.zeros((batch,), dtype=torch.int64, device=dev),
        done=torch.zeros((batch,), dtype=torch.bool, device=dev),
        dropped=torch.zeros((batch,), device=dev))


def network_obs_ref(tables: NetworkEnvTables, c: EnvScalars, s):
    """[B, M, W] observation of state ``s``: per node, its lanes' wave
    (queued + approaching), then queue and wait where configured, packed
    left-aligned, then the current phase's one-hot (``phase_in_obs``)."""
    # "wave" = all vehicles on the incoming lane: queued + approaching
    wave = s.queue + s.transit.sum(1)
    feats = torch.clamp(wave / c.norm_wave, 0.0, c.clip_wave)
    if tables.use_queue:
        qn = torch.clamp(s.queue / c.norm_wave, 0.0, c.clip_wave)
        feats = torch.cat([feats, qn], -1)
    if tables.use_wait:
        wt = torch.clamp(s.wait / c.norm_wait, 0.0, c.clip_wait)
        feats = torch.cat([feats, wt], -1)
    # packed per-agent: valid dims are the first n_s_ls[i] of each row
    out = feats[:, tables.gather] * tables.gmask
    if tables.use_phase:
        onehot = torch.nn.functional.one_hot(s.prev_phase, tables.P).float()
        out = out + torch.einsum("bmp,mpw->bmw", onehot, tables.phase_place)
    return out


def network_env_step_ref(tables: NetworkEnvTables, c: EnvScalars, s,
                         action: torch.Tensor,
                         reset_q0: Optional[torch.Tensor] = None,
                         auto_reset: bool = False):
    """Plain twin of the kernel: (state', obs, reward [B, M], done [B],
    info) of one control step; ``action`` [B, M] int phase index per node.
    With ``auto_reset``, rows that are done take the fresh reset state with
    queues ``reset_q0`` (empty when None), and ``obs`` is that state's;
    reward, done and info describe the terminating transition."""
    cap = c.lane_capacity
    B = action.shape[0]
    P = tables.P
    # clamp invalid (padded) phases to 0 .. n_valid - 1
    act = torch.minimum(torch.clamp(action.long(), min=0),
                        tables.n_valid - 1)
    # green gate of the chosen phase, per lane: [B, L]
    onehot = torch.nn.functional.one_hot(act, P).float()
    lane_gate = onehot.reshape(B, -1) @ tables.gate
    switched = (act != s.prev_phase).float()               # [B, M]
    # yellow window: lanes of switched nodes see no green for the
    # first yellow_interval_sec substeps
    lane_switch = switched @ tables.node_lane_mask         # [B, L]
    t_idx = torch.clamp(s.t, max=tables.demand.shape[0] - 1)
    demand_t = tables.demand[t_idx]                        # [B, L]

    route, route_out = tables.route, tables.route_out
    delay_onehot = tables.delay_onehot[None]               # [1, D, L]
    inflow = demand_t * tables.entry
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
    done = t_new >= c.episode_steps
    s_new = type(s)(queue=q, transit=transit, wait=w, prev_phase=act,
                    t=t_new, done=done, dropped=dropped)
    node_queue = q @ tables.node_lane_mask.T               # [B, M]
    node_wait = w @ tables.node_lane_mask.T
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
    obs = network_obs_ref(tables, c, s_new)
    if auto_reset:
        # per-row select: the fresh state where done
        rs = reset_state(type(s), tables, B, reset_q0)
        pick = lambda x, y: torch.where(
            done.reshape(done.shape + (1,) * (x.ndim - 1)), x, y)
        s_new = type(s)(*(pick(x, y) for x, y in zip(rs, s_new)))
        obs = pick(network_obs_ref(tables, c, rs), obs)
    return s_new, obs, reward.float(), done, info


def _kernel() -> ctypes.CDLL:
    """The library, built and loaded at first use."""
    global _lib
    if _lib is None:
        lib = _build.load("network_env")
        fn = lib.network_env_step
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(tables: NetworkEnvTables, s, action: torch.Tensor,
                reset_q0: Optional[torch.Tensor]) -> None:
    """Raise unless every input is a contiguous tensor of the kernel's
    dtype and shape on the tables' device."""
    B, L, M, D = action.shape[0], tables.L, tables.M, tables.D
    f32, i64 = torch.float32, torch.int64
    want = [("queue", s.queue, (B, L), f32),
            ("transit", s.transit, (B, D, L), f32),
            ("wait", s.wait, (B, L), f32),
            ("prev_phase", s.prev_phase, (B, M), i64),
            ("t", s.t, (B,), i64),
            ("done", s.done, (B,), torch.bool),
            ("dropped", s.dropped, (B,), f32),
            ("action", action, (B, M), i64)]
    if reset_q0 is not None:
        want.append(("reset_q0", reset_q0, (B, L), f32))
    for name, x, shape, dtype in want:
        if x.device != tables.ints.device:
            raise ValueError(f"network_env_step: {name} on {x.device}, the "
                             f"tables on {tables.ints.device}")
        if x.dtype != dtype:
            raise TypeError(f"network_env_step: {name} is {x.dtype}, the "
                            f"kernel takes {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"network_env_step: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"network_env_step: {name} is not contiguous")


def network_env_step(tables: NetworkEnvTables, c: EnvScalars, s,
                     action: torch.Tensor,
                     reset_q0: Optional[torch.Tensor] = None,
                     auto_reset: bool = False):
    """One control step of B env rows (see ``network_env_step_ref``):
    launches ``csrc/network_env.cu`` for CUDA tensors, runs the plain twin
    for CPU tensors. Returns (state', obs, reward, done, info); ``state'``
    has the input state's type. Every output is a new tensor: the state's
    float leaves are views of one allocation, the observation, reward and
    info of another (the rollout keeps those for the whole update, so they
    never hold the state's storage)."""
    if action.device.type == "cpu":
        return network_env_step_ref(tables, c, s, action, reset_q0,
                                    auto_reset)
    if action.device.type != "cuda":
        raise ValueError(f"network_env_step: unsupported device "
                         f"{action.device}")
    _check_cuda(tables, s, action, reset_q0)
    lib = _kernel()
    dims, scal = tables.c_args(c)
    B, L, M, D, W, dev = (action.shape[0], tables.L, tables.M, tables.D,
                          tables.W, action.device)
    queue, transit, wait, dropped = _carve(
        torch.empty(B * (L * (D + 2) + 1), dtype=torch.float32,
                    device=dev),
        [(B, L), (B, D, L), (B, L), (B,)])
    prev_phase, t = _carve(torch.empty(B * (M + 1), dtype=torch.int64,
                                       device=dev), [(B, M), (B,)])
    done_state = torch.empty(B, dtype=torch.bool, device=dev)
    done = torch.empty(B, dtype=torch.bool, device=dev)
    obs, reward, info = _carve(
        torch.empty(B * (M * W + M + 6), dtype=torch.float32, device=dev),
        [(B, M, W), (B, M), (6, B)])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.network_env_step(
            ctypes.addressof(dims), ctypes.addressof(scal),
            tables.ints.data_ptr(), tables.floats.data_ptr(),
            s.queue.data_ptr(), s.transit.data_ptr(), s.wait.data_ptr(),
            s.prev_phase.data_ptr(), s.t.data_ptr(), s.dropped.data_ptr(),
            action.data_ptr(),
            None if reset_q0 is None else reset_q0.data_ptr(),
            queue.data_ptr(), prev_phase.data_ptr(), done_state.data_ptr(),
            done.data_ptr(), obs.data_ptr(), B, int(auto_reset), stream)
    if err != 0:
        raise RuntimeError(f"network_env_step kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["network_env_step"] += 1
    state = type(s)(queue=queue, transit=transit, wait=wait,
                    prev_phase=prev_phase, t=t, done=done_state,
                    dropped=dropped)
    return state, obs, reward, done, dict(zip(INFO_KEYS, info.unbind(0)))
