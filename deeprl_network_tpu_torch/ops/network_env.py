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
moved here. The wrapper counts its launches in ``LAUNCHES`` (a launch
captured into a CUDA graph counts once, at the capture). Every output is a
new tensor: the input state is never written, since the rollout reads the
pre-step state after the step.

``NetworkEnvTables`` holds both forms of the static tables: the dense ones
the twin multiplies by (``gate``, ``route``, ``node_lane_mask``, ...) and
the sparse ones the kernel reads (each lane's route row for ``space`` and
route column for ``routed`` as ``PAIRS`` (index, value) pairs, each lane's
delay slot, owning node and gate row, each node's lane list). The sparse
ones lie in one int32 and one f32 tensor (``ints``, ``floats``); their named
fields are views of those. ``launch_shape`` picks the kernel's lanes a
thread and threads a block, ``occupancy`` reads what the card makes of
them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from deeprl_network_tpu_torch.ops import _build

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
         "pair_row", "pair_col", "lane_slot", "lane_node", "node_ptr",
         "node_lane", "gather32", "phase_col", "n_valid32",
         "pair_row_val", "pair_col_val", "route_out", "entry", "demand",
         "lane_gate", "gmask",
         "episode_steps", "control_interval_sec", "yellow_interval_sec",
         "objective")
PAIRS = 3    # nonzeros of a route row or column the kernel takes, at most
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
    """(row pointers, column indices) of ``mat``'s nonzeros, each row's in
    ascending column order."""
    rows, cols = np.nonzero(mat)
    ptr = np.zeros(mat.shape[0] + 1, np.int64)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr), cols


def _pairs(mat: np.ndarray, what: str):
    """[PAIRS, n] column indices and values of each row's nonzeros of
    ``mat`` [n, n'] in ascending column order, padded with index 0 and value
    0 (a padded term adds an exact 0). Raises if a row has more than
    ``PAIRS``."""
    nnz = (mat != 0).sum(1)
    if nnz.max(initial=0) > PAIRS:
        raise ValueError(f"{what} {int(np.argmax(nnz))} has {int(nnz.max())} "
                         f"nonzeros; the kernel takes at most {PAIRS}")
    idx = np.zeros((PAIRS, mat.shape[0]), np.int64)
    val = np.zeros((PAIRS, mat.shape[0]), np.float32)
    for r in range(mat.shape[0]):
        cols = np.nonzero(mat[r])[0]
        idx[:len(cols), r] = cols
        val[:len(cols), r] = mat[r, cols]
    return idx, val


def launch_shape(L: int):
    """(lanes a thread, threads a block) of the kernel for ``L`` lanes: one
    lane a thread up to 160 lanes, two up to 2,048, then as few as fit 1,024
    threads; lane l belongs to thread l % threads. The card holds six blocks
    of up to 160 threads an SM (csrc/network_env.cu)."""
    lanes = 1 if L <= 160 else 2 if L <= 2048 else -(-L // 1024)
    return lanes, (-(-L // lanes) + 31) // 32 * 32


class NetworkEnvTables:
    """The static tables of one ``TrafficNetworkEnv`` on its device, built
    once from the numpy tables the env assembles: ``topo`` (a
    ``NetworkTopology``), the obs gather map ``gather``/``gmask`` [M, W],
    the phase one-hot placement ``phase_place`` [M, P, W] (None without
    ``phase_in_obs``), ``node_lane_mask`` [M, L], ``delay`` [L] (link
    travel seconds, >= 1) and the obs channels.

    The kernel takes three simplifications that hold on every topology the
    port builds (the 3x3, 5x5 and 10x10 grids and Monaco-28); the
    constructor raises on a topology that breaks them: each lane is in
    exactly one node's lane list, ``phase_gate[m, :, l]`` is zero unless
    lane l is in node m's list (the lane gate and the yellow switch are
    then per-lane gathers), and no route row or column has more than
    ``PAIRS`` nonzeros (a lane's pairs fit its registers)."""

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
        pair_row, pair_row_val = _pairs(route, "route row")
        pair_col, pair_col_val = _pairs(route.T, "route column")
        node_ptr, node_lane = _csr(node_lane_mask)
        # route_out in the twin's f32 sum order, one copy for both paths
        route_out = torch.as_tensor(route).sum(1).numpy()
        ints = dict(pair_row=pair_row, pair_col=pair_col,
                    lane_slot=delay - 1, lane_node=lane_node,
                    node_ptr=node_ptr, node_lane=node_lane, gather32=gather,
                    phase_col=phase_col, n_valid32=n_valid)
        floats = dict(pair_row_val=pair_row_val, pair_col_val=pair_col_val,
                      route_out=route_out, entry=topo.entry_lane,
                      demand=topo.demand,
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
        self.lanes, self.threads = launch_shape(L)
        self._c_args: Dict[EnvScalars, tuple] = {}
        self._inputs: Dict[tuple, tuple] = {}

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

    def inputs(self, B: int, with_q0: bool):
        """The kernel's inputs for B rows, (name, shape, dtype) each, in the
        order ``_check_cuda`` reads them (kept per (B, ``with_q0``))."""
        got = self._inputs.get((B, with_q0))
        if got is None:
            L, M, D = self.L, self.M, self.D
            f32, i64 = torch.float32, torch.int64
            got = (("queue", (B, L), f32), ("transit", (B, D, L), f32),
                   ("wait", (B, L), f32), ("prev_phase", (B, M), i64),
                   ("t", (B,), i64), ("done", (B,), torch.bool),
                   ("dropped", (B,), f32), ("action", (B, M), i64))
            if with_q0:
                got += (("reset_q0", (B, L), f32),)
            self._inputs[(B, with_q0)] = got
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


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot [..., n] of ``x`` (in range), by comparison:
    ``F.one_hot`` reads the indices' range back to the host on the CPU."""
    return (x[..., None] == torch.arange(n, device=x.device)).float()


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
        onehot = _one_hot(s.prev_phase, tables.P)
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
    onehot = _one_hot(act, P)
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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/network_env.cu) with its C entries' argument
    types set."""
    lib.network_env_step.argtypes = [ctypes.c_void_p] * 23 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.network_env_step.restype = ctypes.c_int
    lib.network_env_occupancy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
    lib.network_env_occupancy.restype = ctypes.c_int
    return lib


def _kernel() -> ctypes.CDLL:
    """The library, built and loaded at first use."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load("network_env"))
    return _lib


def _refuse(tables: NetworkEnvTables, name: str, x: torch.Tensor,
            shape: tuple, dtype: torch.dtype) -> None:
    """Raise for the first property of ``x`` the kernel does not take, in
    the order device, dtype, shape, contiguity."""
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


def _check_cuda(tables: NetworkEnvTables, s, action: torch.Tensor,
                reset_q0: Optional[torch.Tensor]) -> None:
    """Raise unless every input is a contiguous tensor of the kernel's
    dtype and shape on the tables' device: the state's fields, ``action``,
    then ``reset_q0`` where given."""
    want = tables.inputs(action.shape[0], reset_q0 is not None)
    dev = tables.ints.device
    for x, (name, shape, dtype) in zip(
            (s.queue, s.transit, s.wait, s.prev_phase, s.t, s.done,
             s.dropped, action, reset_q0), want):
        if (x.device != dev or x.dtype is not dtype or x.shape != shape
                or not x.is_contiguous()):
            _refuse(tables, name, x, shape, dtype)


def occupancy(tables: NetworkEnvTables, c: EnvScalars) -> Dict[str, int]:
    """What the card makes of the kernel's launch for ``tables`` and ``c``:
    lanes a thread, threads a block, registers a thread, blocks an SM,
    shared bytes a block, local (spilled) bytes a thread. Needs the card."""
    lib = _kernel()
    lanes, threads = tables.lanes, tables.threads
    dims = tables.c_args(c)[0]
    out = (ctypes.c_int * 4)()
    err = lib.network_env_occupancy(ctypes.addressof(dims), lanes, threads,
                                    ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"network_env_occupancy failed: cudaError {err}")
    return dict(lanes=lanes, threads=threads, registers=out[0],
                blocks_per_sm=out[1], smem_bytes=out[2], local_bytes=out[3])


def network_env_step(tables: NetworkEnvTables, c: EnvScalars, s,
                     action: torch.Tensor,
                     reset_q0: Optional[torch.Tensor] = None,
                     auto_reset: bool = False):
    """One control step of B env rows (see ``network_env_step_ref``):
    launches ``csrc/network_env.cu`` for CUDA tensors, runs the plain twin
    for CPU tensors. Returns (state', obs, reward, done, info); ``state'``
    has the input state's type. Every output is a new tensor, a view of one
    of four allocations: the state's floats, its ints, the two done flags,
    and the observation, reward and info (the rollout keeps those for the
    whole update, so they never hold the state's storage). Four
    allocations and their views cost the host less than one allocation an
    output."""
    if action.device.type == "cpu":
        return network_env_step_ref(tables, c, s, action, reset_q0,
                                    auto_reset)
    if action.device.type != "cuda":
        raise ValueError(f"network_env_step: unsupported device "
                         f"{action.device}")
    _check_cuda(tables, s, action, reset_q0)
    lib = _kernel()
    dev = tables.ints.device
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return network_env_step(tables, c, s, action, reset_q0,
                                    auto_reset)
    B, L, M, D, W = action.shape[0], tables.L, tables.M, tables.D, tables.W
    dims, scal = tables.c_args(c)
    queue, transit, wait, dropped = torch.empty(
        B * (L * (D + 2) + 1), dtype=torch.float32, device=dev
    ).split_with_sizes((B * L, B * D * L, B * L, B))
    prev_phase, t = torch.empty(
        B * (M + 1), dtype=torch.int64, device=dev).split_with_sizes((B * M, B))
    done_state, done = torch.empty(
        2 * B, dtype=torch.bool, device=dev).split_with_sizes((B, B))
    obs, reward, *info = torch.empty(
        B * (M * W + M + len(INFO_KEYS)), dtype=torch.float32, device=dev
    ).split_with_sizes((B * M * W, B * M) + (B,) * len(INFO_KEYS))
    err = lib.network_env_step(
        ctypes.addressof(dims), ctypes.addressof(scal),
        tables.ints.data_ptr(), tables.floats.data_ptr(),
        s.queue.data_ptr(), s.transit.data_ptr(), s.wait.data_ptr(),
        s.prev_phase.data_ptr(), s.t.data_ptr(), s.dropped.data_ptr(),
        action.data_ptr(),
        None if reset_q0 is None else reset_q0.data_ptr(),
        queue.data_ptr(), transit.data_ptr(), wait.data_ptr(),
        dropped.data_ptr(), prev_phase.data_ptr(), t.data_ptr(),
        done_state.data_ptr(), done.data_ptr(), obs.data_ptr(),
        reward.data_ptr(), info[0].data_ptr(), B, int(auto_reset),
        tables.lanes, tables.threads,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"network_env_step kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["network_env_step"] += 1
    state = type(s)(queue=queue.view(B, L), transit=transit.view(B, D, L),
                    wait=wait.view(B, L), prev_phase=prev_phase.view(B, M),
                    t=t, done=done_state, dropped=dropped)
    return (state, obs.view(B, M, W), reward.view(B, M), done,
            dict(zip(INFO_KEYS, info)))
