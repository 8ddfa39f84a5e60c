"""Fused per-agent LSTM cell: CUDA kernels, their plain twins, and the
``autograd.Function`` that joins forward and backward.

Counterpart of ``deeprl_network_tpu/ops/pallas_lstm.py``. The multi-agent
policies apply N independent LSTM cells (per-agent weights) to a
[B, N, features] activation every control step. ``fused_agent_lstm`` runs
that whole cell (both products, bias, the four gates, the done-masked state
update) as one kernel launch, and its backward as two (``tc``) or three
(``general``) more launches that recompute the gates instead of storing
them.

Dispatch is first by the tensors' device: CUDA tensors launch a kernel (and
raise if a launch fails; there is no fallback), CPU tensors run the plain
PyTorch twins ``lstm_cell_fwd_ref`` / ``lstm_cell_bwd_ref``, which keep the
kernels' signatures and rounding points. On the card there are two
hand-written kernels, chosen by ``kernel_variant(dtype, F, H)``:
``csrc/lstm_cell_tc.cu`` (bf16 on the tensor cores, the flagship path) and
``csrc/lstm_cell.cu`` (f32 products on the CUDA cores: float32, and bf16
widths the first does not take; any F and H, tiles chosen by
``general_plan``). Each source states its design and its bound.
Both wrappers count their launches in ``LAUNCHES``: totals under
``lstm_cell_fwd`` / ``lstm_cell_bwd`` and, beside them, per variant
(``lstm_cell_fwd_tc``, ``lstm_cell_fwd_general``, ...). A launch that a
CUDA graph captures counts once, at the capture: its replays run no Python.

Shapes: params = (wx [N,F,4H], wh [N,H,4H], b [N,4H]); carry = (c, h) each
[B,N,H]; x [B,N,F]; done [B]. float32 or bfloat16 (one dtype for all),
f32 accumulation and gate math.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from deeprl_network_tpu_torch.ops import _build

# kernel launches by name, counted by the wrappers where they launch
LAUNCHES = {"lstm_cell_fwd": 0, "lstm_cell_bwd": 0,
            "lstm_cell_fwd_tc": 0, "lstm_cell_fwd_general": 0,
            "lstm_cell_bwd_tc": 0, "lstm_cell_bwd_general": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# tile shapes of the general kernels by config index (ActCfg, DxdhCfg and
# kWK / kWM in lstm_cell.cu): the gate kernels' (batch rows, hidden units),
# the [dx | dh] kernel's (batch rows, K columns), the weight kernel's
# (K rows, 4H columns)
_ACT_TILES = ((1, 8), (4, 8), (8, 8), (16, 16), (32, 32))
_DXDH_TILES = ((4, 32), (16, 32), (64, 64))
_WGT_TILE = (64, 64)
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
_TC_BT = 32       # batch rows per tile, kBT in lstm_cell_tc.cu
_TC_MAX_FH = 64   # largest F and H, kMaxFH in lstm_cell_tc.cu
_lib: Optional[SimpleNamespace] = None
_sm_counts: Dict[int, int] = {}
_scratch_cache: Dict[tuple, tuple] = {}


def _kernels() -> SimpleNamespace:
    """Both libraries, built (in parallel) and loaded at first use."""
    global _lib
    if _lib is None:
        _build.build(["lstm_cell", "lstm_cell_tc"])
        general = _build.load("lstm_cell")
        tc = _build.load("lstm_cell_tc")
        P, I = ctypes.c_void_p, ctypes.c_int
        general.lstm_cell_fwd.argtypes = [I] + [P] * 11 + [I] * 6 + [P]
        general.lstm_cell_bwd.argtypes = [I] + [P] * 18 + [I] * 7 + [P]
        tc.lstm_cell_tc_fwd.argtypes = [P] * 11 + [I] * 5 + [P]
        tc.lstm_cell_tc_bwd.argtypes = [P] * 18 + [I] * 5 + [P]
        for fn in (general.lstm_cell_fwd, general.lstm_cell_bwd,
                   tc.lstm_cell_tc_fwd, tc.lstm_cell_tc_bwd):
            fn.restype = I
        _lib = SimpleNamespace(general=general, tc=tc)
    return _lib


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the twins: f32, or f64 for float64 inputs
    (used by gradcheck)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _check_cuda(x: torch.Tensor, *tensors: torch.Tensor) -> int:
    """Validate the kernels' inputs; return the dtype code."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"lstm cell kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"mixed dtypes {t.dtype} and {x.dtype}")
        if not t.is_contiguous():
            raise ValueError("lstm cell kernels take contiguous tensors")
    return _DTYPE_CODE[x.dtype]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _gates(wx, wh, b, h_in, x, acc):
    """z = x @ wx + h_in @ wh + b in ``acc`` precision, split (i, f, o, u)
    and activated."""
    z = (torch.einsum("bnf,nfg->bng", x.to(acc), wx.to(acc))
         + torch.einsum("bnh,nhg->bng", h_in.to(acc), wh.to(acc))
         + b.to(acc))
    i, f, o, u = torch.chunk(z, 4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(u)


def lstm_cell_fwd_ref(wx, wh, b, c, h, x, done, residuals: bool = True):
    """Plain twin of the forward kernel: (c', h', h_in, c_in), the last two
    None without ``residuals``."""
    dt = x.dtype
    acc = _acc_dtype(dt)
    mask = (1.0 - done.to(dt))[:, None, None]
    h_in = h * mask
    c_in = c * mask
    i, f, o, u = _gates(wx, wh, b, h_in, x, acc)
    c_new = f * c_in.to(acc) + i * u
    h_new = o * torch.tanh(c_new)
    if not residuals:
        h_in = c_in = None
    return c_new.to(dt).contiguous(), h_new.to(dt).contiguous(), h_in, c_in


def lstm_cell_bwd_ref(wx, wh, b, x, h_in, c_in, c_new, done, dc_new, dh_new):
    """Plain twin of the backward kernels: (dx, dh, dc_prev, dwx, dwh, db),
    the weight grads in the accumulation dtype."""
    dt = x.dtype
    acc = _acc_dtype(dt)
    i, f, o, u = _gates(wx, wh, b, h_in, x, acc)
    tc = torch.tanh(c_new.to(acc))
    dhn = dh_new.to(acc)
    dc = dhn * o * (1.0 - tc * tc) + dc_new.to(acc)
    g_i = (dc * u) * i * (1.0 - i)
    g_f = (dc * c_in.to(acc)) * f * (1.0 - f)
    g_o = (dhn * tc) * o * (1.0 - o)
    g_u = (dc * i) * (1.0 - u * u)
    gz = torch.cat([g_i, g_f, g_o, g_u], dim=-1)
    gz_dt = gz.to(dt).to(acc)            # product operand in compute dtype
    mask = (1.0 - done.to(dt)).to(acc)[:, None, None]
    dx = torch.einsum("bng,nfg->bnf", gz_dt, wx.to(acc)).to(dt)
    dh = (torch.einsum("bng,nhg->bnh", gz_dt, wh.to(acc)) * mask).to(dt)
    dc_prev = ((dc * f) * mask).to(dt).contiguous()
    dwx = torch.einsum("bnf,bng->nfg", x.to(acc), gz_dt)
    dwh = torch.einsum("bnh,bng->nhg", h_in.to(acc), gz_dt)
    db = gz.sum(0)                       # the f32 gz, as the TPU kernel
    return dx, dh, dc_prev, dwx, dwh, db


def kernel_variant(dtype: torch.dtype, F: int, H: int) -> str:
    """Which hand-written kernel a CUDA call takes: a pure function of the
    dtype and the widths. ``"tc"`` (``csrc/lstm_cell_tc.cu``: bf16 operands
    on the tensor cores) for bfloat16 with F and H multiples of 16 and at
    most 64; ``"general"`` (``csrc/lstm_cell.cu``: CUDA-core FMAs in f32)
    for float32, which TF32 tensor cores could not hold to 1e-5, and for
    every other width."""
    if dtype == torch.bfloat16 and F % 16 == 0 and H % 16 == 0 \
            and 0 < F <= _TC_MAX_FH and 0 < H <= _TC_MAX_FH:
        return "tc"
    return "general"


def tc_splits(B: int, N: int, sm_count: int) -> int:
    """Blocks per agent of the tensor-core kernels (grid N x splits, each
    block walking ceil(tiles / splits) batch tiles of 32 rows with its
    agent's weights staged once): as many as fill the card's SMs once, at
    most one per tile."""
    tiles = -(-B // _TC_BT)
    return max(1, min(tiles, sm_count // max(N, 1)))


class GeneralPlan(NamedTuple):
    """Grids and tile shapes of one general-kernel call. Block (x, y) of
    the gate kernels (forward, backward pass 1) owns agent
    ``x // ceil(H / act_units)``, hidden units ``(x % ceil(H / act_units))
    * act_units`` onwards and batch rows ``y * act_rows`` onwards; block
    (x, y) of the [dx | dh] kernel owns agent ``x // ceil(K / dxdh_cols)``,
    the K columns from ``(x % ceil(K / dxdh_cols)) * dxdh_cols`` and rows
    from ``y * dxdh_rows``; block (n, y, z) of the weight kernel owns agent
    n, K rows from ``y * 64`` and 4H columns from ``z * 64``."""
    act: int                        # config index of the gate kernels
    act_rows: int
    act_units: int
    act_grid: Tuple[int, int]
    dxdh: int                       # config index of the [dx | dh] kernel
    dxdh_rows: int
    dxdh_cols: int
    dxdh_grid: Tuple[int, int]
    weight_grid: Tuple[int, int, int]


def _pick(tiles, B: int, blocks, sm_count: int) -> int:
    """The config with the most work a block whose grid still fills the
    ``sm_count`` SMs, among those whose rows the batch fills (the one-row
    or smallest tile always); else the one with the most blocks."""
    fits = [i for i, (rows, _) in enumerate(tiles) if rows <= B] or [0]
    for i in reversed(fits):
        if blocks(*tiles[i]) >= sm_count:
            return i
    return max(fits, key=lambda i: blocks(*tiles[i]))


def general_plan(B: int, N: int, F: int, H: int, sm_count: int) -> GeneralPlan:
    """Tiles and grids of the general kernels (``csrc/lstm_cell.cu``) for a
    call at these sizes on a card of ``sm_count`` SMs: for each kernel the
    largest tile whose grid fills the card, rows no more than B (B = 1 gets
    one-row tiles in the gate kernels)."""
    cdiv = lambda a, b: -(-a // b)
    K = F + H
    act = _pick(_ACT_TILES, B,
                lambda r, j: N * cdiv(H, j) * cdiv(B, r), sm_count)
    dxdh = _pick(_DXDH_TILES, B,
                 lambda r, k: N * cdiv(K, k) * cdiv(B, r), sm_count)
    (ar, aj), (dr, dk) = _ACT_TILES[act], _DXDH_TILES[dxdh]
    return GeneralPlan(
        act, ar, aj, (N * cdiv(H, aj), cdiv(B, ar)),
        dxdh, dr, dk, (N * cdiv(K, dk), cdiv(B, dr)),
        (N, cdiv(K, _WGT_TILE[0]), cdiv(4 * H, _WGT_TILE[1])))


def _general_args(x: torch.Tensor, F: int, H: int, tensors):
    """(plan, vec) of a general-kernel call; raises where a grid would
    exceed CUDA's limits. ``vec``: rows in whole 16-byte pieces (the
    kernels' cp.async path), else element-wise copies."""
    B, N = x.shape[:2]
    plan = general_plan(B, N, F, H, _sm_count(x.device))
    if max(plan.act_grid[1], plan.dxdh_grid[1], *plan.weight_grid[1:]) \
            > _MAX_GRID_YZ:
        raise ValueError(f"lstm cell general kernels: B={B}, F={F}, H={H} "
                         f"need a grid dimension over {_MAX_GRID_YZ}")
    ve = 16 // x.element_size()
    vec = F % ve == 0 and H % ve == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)
    return plan, int(vec)


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _scratch(device, stream: int, N: int, B: int, G: int, splits: int):
    """The backward's scratch (gz_T [N, B, G] bf16 and the db partials
    [N, splits, G] f32), kept per (device, stream) and reused by later calls
    of the same shape (another shape replaces it). Both tensors are written
    and consumed by the two launches of one wrapper call, so reuse is safe
    as long as all calls that share them run in order on one stream, which
    the key's stream ensures. Under a CUDA graph's capture they come from
    the graph's pool instead, for the graph's life: a cached pair may be
    replaced (and freed) while the graph still replays."""
    if torch.cuda.is_current_stream_capturing():
        return (torch.empty((N, B, G), dtype=torch.bfloat16, device=device),
                torch.empty((N, splits, G), dtype=torch.float32,
                            device=device))
    key, shape = (str(device), stream), (N, B, G, splits)
    got = _scratch_cache.get(key)
    if got is None or got[0] != shape:
        got = (shape,
               torch.empty((N, B, G), dtype=torch.bfloat16, device=device),
               torch.empty((N, splits, G), dtype=torch.float32,
                           device=device))
        _scratch_cache[key] = got
    return got[1], got[2]


def _carve(buf: torch.Tensor, shapes):
    """Contiguous views of the given shapes, one after another in ``buf``."""
    out, at = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(buf[at:at + n].view(shape))
        at += n
    return out


def _count(name: str, variant: str) -> None:
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_{variant}"] += 1


def _variant_for(x: torch.Tensor, F: int, H: int, tensors,
                 _variant: Optional[str]) -> str:
    variant = kernel_variant(x.dtype, F, H) if _variant is None else _variant
    if variant not in ("tc", "general"):
        raise ValueError(f"unknown kernel variant {variant!r}")
    if variant == "tc":
        if kernel_variant(x.dtype, F, H) != "tc":
            raise ValueError(f"the tensor-core kernels do not take "
                             f"{x.dtype}, F={F}, H={H}")
        for t in tensors:
            if t is not None and t.data_ptr() % 16:
                raise ValueError("the tensor-core kernels take 16-byte "
                                 "aligned tensors")
    return variant


def lstm_cell_fwd(wx, wh, b, c, h, x, done, residuals: bool = True, *,
                  _variant: Optional[str] = None,
                  _splits: Optional[int] = None):
    """Forward cell: (c', h', h_in, c_in). Launches a CUDA kernel for CUDA
    tensors (which one: ``kernel_variant``), the plain twin for CPU
    tensors. The outputs are views of one allocation; nothing is reused
    between calls. ``_variant`` and ``_splits`` are for
    measurements (the earlier kernel at a shape the rule gives to the new
    one, other grids); the model's path never passes them."""
    if x.device.type == "cpu":
        return lstm_cell_fwd_ref(wx, wh, b, c, h, x, done, residuals)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell_fwd: unsupported device {x.device}")
    done = done.to(x.dtype).contiguous()
    code = _check_cuda(x, wx, wh, b, c, h, done)
    B, N, F = x.shape
    H = h.shape[-1]
    if wx.shape != (N, F, 4 * H) or wh.shape != (N, H, 4 * H) \
            or b.shape != (N, 4 * H) or c.shape != (B, N, H) \
            or h.shape != (B, N, H) or done.shape != (B,):
        raise ValueError("lstm_cell_fwd: inconsistent shapes")
    variant = _variant_for(x, F, H, (x, wx, wh, b, c, h, done), _variant)
    if variant == "general":
        plan, vec = _general_args(x, F, H, (x, h, wx, wh))
    lib = _kernels()
    n_out = 4 if residuals else 2
    outs = _carve(torch.empty(n_out * B * N * H, dtype=x.dtype,
                              device=x.device), [(B, N, H)] * n_out)
    h_new, c_new = outs[:2]
    h_in, c_in = outs[2:] if residuals else (None, None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (_ptr(x), _ptr(h), _ptr(c), _ptr(done), _ptr(wx), _ptr(wh),
                _ptr(b), _ptr(h_new), _ptr(c_new), _ptr(h_in), _ptr(c_in))
        if variant == "tc":
            splits = _splits or tc_splits(B, N, _sm_count(x.device))
            err = lib.tc.lstm_cell_tc_fwd(*ptrs, B, N, F, H, splits, stream)
        else:
            err = lib.general.lstm_cell_fwd(code, *ptrs, B, N, F, H,
                                            plan.act, vec, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell_fwd ({variant}) kernel launch "
                           f"failed: cudaError {err}")
    _count("lstm_cell_fwd", variant)
    return c_new, h_new, h_in, c_in


def lstm_cell_bwd(wx, wh, b, x, h_in, c_in, c_new, done, dc_new, dh_new, *,
                  _variant: Optional[str] = None,
                  _splits: Optional[int] = None):
    """Backward cell: (dx, dh, dc_prev, dwx, dwh, db), the weight grads in
    f32. Launches the CUDA kernels for CUDA tensors (which: see
    ``kernel_variant``), the plain twin for CPU tensors. The activation
    grads are views of one fresh allocation and the weight grads of a
    second; the tensor-core variant's scratch is reused between calls
    (``_scratch``), the general variant's is allocated per call.
    ``_variant`` and ``_splits`` are for measurements only."""
    if x.device.type == "cpu":
        return lstm_cell_bwd_ref(wx, wh, b, x, h_in, c_in, c_new, done,
                                 dc_new, dh_new)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell_bwd: unsupported device {x.device}")
    done = done.to(x.dtype).contiguous()
    dc_new, dh_new = dc_new.contiguous(), dh_new.contiguous()
    code = _check_cuda(x, wx, wh, b, h_in, c_in, c_new, done, dc_new, dh_new)
    B, N, F = x.shape
    H = h_in.shape[-1]
    variant = _variant_for(
        x, F, H, (x, wx, wh, b, h_in, c_in, c_new, done, dc_new, dh_new),
        _variant)
    if variant == "general":
        plan, vec = _general_args(x, F, H, (x, h_in, wx, wh))
    lib = _kernels()
    G = 4 * H
    dx, dh, dc_prev = _carve(
        torch.empty(B * N * (F + 2 * H), dtype=x.dtype, device=x.device),
        [(B, N, F), (B, N, H), (B, N, H)])
    dwx, dwh, db = _carve(
        torch.empty(N * (F + H + 1) * G, dtype=torch.float32,
                    device=x.device), [(N, F, G), (N, H, G), (N, G)])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if variant == "tc":
            splits = _splits or tc_splits(B, N, _sm_count(x.device))
            gz, db_part = _scratch(x.device, stream, N, B, G, splits)
        else:
            gz = torch.empty((N, B, G), dtype=x.dtype, device=x.device)
            db_part = torch.empty((N, plan.act_grid[1], G),
                                  dtype=torch.float32, device=x.device)
        ptrs = (_ptr(x), _ptr(h_in), _ptr(c_in), _ptr(c_new), _ptr(dc_new),
                _ptr(dh_new), _ptr(done), _ptr(wx), _ptr(wh), _ptr(b),
                _ptr(dx), _ptr(dh), _ptr(dc_prev), _ptr(gz), _ptr(db_part),
                _ptr(dwx), _ptr(dwh), _ptr(db))
        if variant == "tc":
            err = lib.tc.lstm_cell_tc_bwd(*ptrs, B, N, F, H, splits, stream)
        else:
            err = lib.general.lstm_cell_bwd(code, *ptrs, B, N, F, H,
                                            plan.act, plan.dxdh, vec, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell_bwd ({variant}) kernel launch "
                           f"failed: cudaError {err}")
    _count("lstm_cell_bwd", variant)
    return dx, dh, dc_prev, dwx, dwh, db


class FusedAgentLSTM(torch.autograd.Function):
    """The cell with its fused backward. Saves the residuals of the JAX
    custom VJP: (params, x, h_in, c_in, c_new, done); ``done`` gets no
    gradient, and the f32 weight grads are cast to the params' dtype."""

    @staticmethod
    def forward(ctx, wx, wh, b, c, h, x, done, residuals):
        c_new, h_new, h_in, c_in = lstm_cell_fwd(wx, wh, b, c, h, x, done,
                                                 residuals)
        if residuals:
            ctx.save_for_backward(wx, wh, b, x, h_in, c_in, c_new, done)
        return c_new, h_new

    @staticmethod
    def backward(ctx, dc_new, dh_new):
        wx, wh, b, x, h_in, c_in, c_new, done = ctx.saved_tensors
        dx, dh, dc_prev, dwx, dwh, db = lstm_cell_bwd(
            wx, wh, b, x, h_in, c_in, c_new, done, dc_new, dh_new)
        return (dwx.to(wx.dtype), dwh.to(wh.dtype), db.to(b.dtype), dc_prev,
                dh, dx, None, None)


def fused_agent_lstm(params, carry, x, done) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """params = (wx, wh, b); carry = (c, h). Returns (c', h'): the
    counterpart of the JAX ``fused_agent_lstm``, differentiable in params,
    carry and x. Inputs are made contiguous (the kernels read a row-major
    [B, N, X] layout). The forward stores its residuals only when a backward
    can follow."""
    wx, wh, b = (t.contiguous() for t in params)
    c, h = (t.contiguous() for t in carry)
    x, done = x.contiguous(), done.contiguous()
    residuals = torch.is_grad_enabled() and any(
        t.requires_grad for t in (wx, wh, b, c, h, x))
    return FusedAgentLSTM.apply(wx, wh, b, c, h, x, done, residuals)
