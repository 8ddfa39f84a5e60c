"""Fused per-agent LSTM cell: CUDA kernels, their plain twins, and the
``autograd.Function`` that joins forward and backward.

Counterpart of ``deeprl_network_tpu/ops/pallas_lstm.py``. The multi-agent
policies apply N independent LSTM cells (per-agent weights) to a
[B, N, features] activation every control step. ``fused_agent_lstm`` runs
that whole cell (both products, bias, the four gates, the done-masked state
update) as one kernel launch, and its backward as one more pair of
launches that recompute the gates instead of storing them
(``csrc/lstm_cell.cu`` states the design and its bound).

Dispatch is by the tensors' device: CUDA tensors launch the kernels (and
raise if a launch fails; there is no fallback), CPU tensors run the plain
PyTorch twins ``lstm_cell_fwd_ref`` / ``lstm_cell_bwd_ref``, which keep the
kernels' signatures and rounding points. Both wrappers count their kernel
launches in ``LAUNCHES``.

Shapes: params = (wx [N,F,4H], wh [N,H,4H], b [N,4H]); carry = (c, h) each
[B,N,H]; x [B,N,F]; done [B]. float32 or bfloat16 (one dtype for all),
f32 accumulation and gate math.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeprl_network_tpu_torch.ops import _build

# kernel launches by name, counted by the wrappers where they launch
LAUNCHES = {"lstm_cell_fwd": 0, "lstm_cell_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BT = 32       # batch rows per block, kBT in lstm_cell.cu
_MAX_K = 256   # largest F + H, kKMax in lstm_cell.cu
_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lstm_cell")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.lstm_cell_fwd.argtypes = [I] + [P] * 11 + [I] * 4 + [P]
        lib.lstm_cell_fwd.restype = I
        lib.lstm_cell_bwd.argtypes = [I] + [P] * 18 + [I] * 4 + [P]
        lib.lstm_cell_bwd.restype = I
        _lib = lib
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


def lstm_cell_fwd(wx, wh, b, c, h, x, done, residuals: bool = True):
    """Forward cell: (c', h', h_in, c_in). Launches the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
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
    if F + H > _MAX_K:
        raise ValueError(f"lstm_cell_fwd: F + H = {F + H} exceeds {_MAX_K}")
    lib = _kernels()
    h_new, c_new = torch.empty_like(h), torch.empty_like(c)
    h_in = torch.empty_like(h) if residuals else None
    c_in = torch.empty_like(c) if residuals else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lstm_cell_fwd(code, _ptr(x), _ptr(h), _ptr(c), _ptr(done),
                                _ptr(wx), _ptr(wh), _ptr(b), _ptr(h_new),
                                _ptr(c_new), _ptr(h_in), _ptr(c_in),
                                B, N, F, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell_fwd kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["lstm_cell_fwd"] += 1
    return c_new, h_new, h_in, c_in


def lstm_cell_bwd(wx, wh, b, x, h_in, c_in, c_new, done, dc_new, dh_new):
    """Backward cell: (dx, dh, dc_prev, dwx, dwh, db), the weight grads in
    f32. Launches the CUDA kernels for CUDA tensors, the plain twin for CPU
    tensors."""
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
    if F + H > _MAX_K:
        raise ValueError(f"lstm_cell_bwd: F + H = {F + H} exceeds {_MAX_K}")
    lib = _kernels()
    G = 4 * H
    n_tiles = -(-B // _BT)
    dx = torch.empty_like(x)
    dh, dc_prev = torch.empty_like(h_in), torch.empty_like(c_in)
    gz = torch.empty((N, B, G), dtype=x.dtype, device=x.device)
    db_part = torch.empty((N, n_tiles, G), dtype=torch.float32,
                          device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    dwx = torch.empty((N, F, G), **f32)
    dwh = torch.empty((N, H, G), **f32)
    db = torch.empty((N, G), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lstm_cell_bwd(code, _ptr(x), _ptr(h_in), _ptr(c_in),
                                _ptr(c_new), _ptr(dc_new), _ptr(dh_new),
                                _ptr(done), _ptr(wx), _ptr(wh), _ptr(b),
                                _ptr(dx), _ptr(dh), _ptr(dc_prev), _ptr(gz),
                                _ptr(db_part), _ptr(dwx), _ptr(dwh), _ptr(db),
                                B, N, F, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell_bwd kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["lstm_cell_bwd"] += 1
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
