"""DIAL's message head over packed neighbour lists: a CUDA kernel each way,
their plain twins, and the ``autograd.Function`` that joins them.

The MA2C_DIAL policy with ``sparse_comm`` sends its neighbours the messages

    m[b,n] = ((1 - done[b]) h[b,n]) W_dial[n] + b_dial[n]

and ``comm_embed`` sums them over the packed lists (``models/policies.py``
``_embed``). As PyTorch ops the head was the done mask (a cast, a subtract
and a broadcast multiply), the einsum ``bmh,mhd->bmd`` (a bmm over agents
whose output is [agent, row] major), the bias add over that layout and the
copy that ``comm_embed``'s wrapper made to get the messages as [B, N, D]
rows; the backward, their autograd: two bmms with their permute copies, the
bias gradient's reduction over B and the mask's backward, about 16 kernels a
control step. ``dial_head`` computes it in one launch each way
(``csrc/dial_head.cu`` states the design and its bound: 1.5 us forward and
2.3 us backward at the flagship's shape, by bytes), the mask and the bias in
the forward's epilogue, the messages written as the rows ``comm_embed``
reads; the backward's sums over B split over a thread-block cluster and
added in a fixed order. It replaces no TPU kernel: XLA fuses the JAX
package's einsum.

Dispatch: CPU tensors run the plain twins ``dial_head_fwd_ref`` /
``dial_head_bwd_ref``; CUDA tensors launch a kernel, and raise if a launch
fails (there is no fallback): the tensor-core pair where ``takes_tc``
accepts the widths (bf16, where the LSTM cell takes its tensor-core
kernel), else the ``general`` pair (f32 FMAs on the CUDA cores: float32,
and every other width), so that every packed DIAL call on a card runs one
launch each way. Both paths make the same checks first. The twins keep the
kernels' rounding points: the product accumulated in f32, masked and the
bias added in f32, rounded once; the gradients summed in f32 and rounded
once. Launches are counted in ``LAUNCHES``: ``dial_head_fwd`` /
``dial_head_bwd``; which pair ran follows from ``takes_tc``. A launch that
a CUDA graph captures counts once, at the capture.

Shapes: h [B, N, H] (the unmasked carry), done [B] or None (no mask), w
[N, H, D], b [N, D]; m and its gradient [B, N, D]. float32 or bfloat16, one
dtype for all; h contiguous (the kernel reads its rows in place).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeprl_network_tpu_torch.ops import _build
from deeprl_network_tpu_torch.ops import lstm_cell
from deeprl_network_tpu_torch.ops.lstm_cell import (
    _DTYPE_CODE, _acc_dtype, _ptr,
)

LAUNCHES = {"dial_head_fwd": 0, "dial_head_bwd": 0}

_BT = 64            # rows of a tile, kBT in dial_head.cu
_MAX_CLUSTER = 8    # kMaxCluster: the portable cluster size
_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    """The library, built and loaded at first use."""
    global _lib
    if _lib is None:
        lib = _build.load("dial_head")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dial_head_fwd.argtypes = [I, I] + [P] * 5 + [I] * 4 + [P]
        lib.dial_head_bwd.argtypes = [I, I] + [P] * 7 + [I] * 5 + [P]
        for fn in (lib.dial_head_fwd, lib.dial_head_bwd):
            fn.restype = I
        _lib = lib
    return _lib


def _mask(done, dt):
    """1 - done in the compute dtype, [B, 1, 1]; None where ``done`` is."""
    return None if done is None else (1.0 - done.to(dt))[:, None, None]


def dial_head_fwd_ref(h, done, w, b):
    """Plain twin of the forward kernel: m [B, N, D]."""
    dt = h.dtype
    acc = _acc_dtype(dt)
    m = torch.einsum("bnh,nhd->bnd", h.to(acc), w.to(acc))
    mask = _mask(done, dt)
    if mask is not None:
        m = m * mask.to(acc)
    return (m + b.to(acc)).to(dt).contiguous()


def dial_head_bwd_ref(h, done, w, dm):
    """Plain twin of the backward kernel: (dh, dw, db), each summed in f32
    and rounded once to the compute dtype; dw's operand is the masked row
    of h in the compute dtype."""
    dt = h.dtype
    acc = _acc_dtype(dt)
    g = dm.to(acc)
    mask = _mask(done, dt)
    x = h if mask is None else h * mask
    dw = torch.einsum("bnh,bnd->nhd", x.to(acc), g).to(dt)
    dh = torch.einsum("bnd,nhd->bnh", g, w.to(acc))
    if mask is not None:
        dh = dh * mask.to(acc)
    return dh.to(dt).contiguous(), dw.contiguous(), g.sum(0).to(dt)


def takes_tc(dtype: torch.dtype, H: int, D: int) -> bool:
    """Whether a CUDA call launches the tensor-core kernels, from what the
    call can see: the LSTM cell's rule (``lstm_cell.kernel_variant``) over
    the head's widths, bfloat16 with H and D multiples of 16, at most 64.
    Every other CUDA call launches the ``general`` kernels."""
    return lstm_cell.kernel_variant(dtype, D, H) == "tc"


def bwd_cluster(B: int) -> int:
    """Blocks per agent of the tensor-core backward, a thread-block cluster
    (at most 8): the fewest that give no block more tiles than 8 blocks
    would (6 at B=768: two tiles each)."""
    tiles = -(-B // _BT)
    per = -(-tiles // _MAX_CLUSTER)
    return -(-tiles // per)


def _check(name: str, h, done, w, b=None):
    """Raise on what neither the kernels nor the twins take; returns
    (B, N, H, D)."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: takes float32 or bfloat16, got {h.dtype}")
    for t, what in ((w, "w"), (b, "b")):
        if t is None:
            continue
        if t.device != h.device:
            raise ValueError(f"{name}: {what} on {t.device}, h on {h.device}")
        if t.dtype != h.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, h {h.dtype}")
    if done is not None and done.device != h.device:
        raise ValueError(f"{name}: done on {done.device}, h on {h.device}")
    if h.dim() != 3:
        raise ValueError(f"{name}: h must be [B, N, H], got {tuple(h.shape)}")
    B, N, H = h.shape
    D = w.shape[-1]
    if w.shape != (N, H, D) or (b is not None and b.shape != (N, D)) \
            or (done is not None and done.shape != (B,)):
        raise ValueError(f"{name}: inconsistent shapes")
    if not h.is_contiguous():
        raise ValueError(f"{name}: h must be contiguous (its rows are read "
                         "in place)")
    return B, N, H, D


def _ready(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` contiguous, 16-byte aligned and in ``dtype`` (a copy only
    where it is not: ``done`` in another dtype, or a weight in another
    layout)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def dial_head_fwd(h, done, w, b) -> torch.Tensor:
    """Forward: m [B, N, D], contiguous. Launches a CUDA kernel for CUDA
    tensors (the tensor-core one where ``takes_tc`` accepts the widths), the
    plain twin for CPU tensors."""
    B, N, H, D = _check("dial_head_fwd", h, done, w, b)
    dev, dt = h.device, h.dtype
    if dev.type == "cpu":
        return dial_head_fwd_ref(h, done, w, b)
    tc = takes_tc(dt, H, D)
    h, w, b = (_ready(t, dt) for t in (h, w, b))
    done = None if done is None else _ready(done, dt)
    m = torch.empty((B, N, D), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _launch("dial_head_fwd", _kernels().dial_head_fwd, _DTYPE_CODE[dt],
                int(tc), _ptr(h), _ptr(done), _ptr(w), _ptr(b), _ptr(m), B,
                N, H, D, torch.cuda.current_stream(dev).cuda_stream)
    return m


def dial_head_bwd(h, done, w, dm
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward: (dh, dw, db) in the compute dtype, dw and db views of one
    allocation. One launch of the pair the forward took for CUDA tensors,
    the plain twin for CPU tensors."""
    B, N, H, D = _check("dial_head_bwd", h, done, w)
    if dm.shape != (B, N, D):
        raise ValueError("dial_head_bwd: inconsistent shapes")
    dev, dt = h.device, h.dtype
    if dev.type == "cpu":
        return dial_head_bwd_ref(h, done, w, dm)
    tc = takes_tc(dt, H, D)
    h, w, dm = (_ready(t, dt) for t in (h, w, dm))
    done = None if done is None else _ready(done, dt)
    dh = torch.empty((B, N, H), dtype=dt, device=dev)
    flat = torch.empty(N * H * D + N * D, dtype=dt, device=dev)
    dw, db = flat[:N * H * D].view(N, H, D), flat[N * H * D:].view(N, D)
    with torch.cuda.device(dev):
        _launch("dial_head_bwd", _kernels().dial_head_bwd, _DTYPE_CODE[dt],
                int(tc), _ptr(h), _ptr(done), _ptr(w), _ptr(dm), _ptr(dh),
                _ptr(dw), _ptr(db), B, N, H, D, bwd_cluster(B) if tc else 1,
                torch.cuda.current_stream(dev).cuda_stream)
    return dh, dw, db


class DialHead(torch.autograd.Function):
    """The head with its fused backward. Saves (h, done, w); ``done`` gets
    no gradient."""

    @staticmethod
    def forward(ctx, h, done, w, b):
        m = dial_head_fwd(h, done, w, b)
        ctx.save_for_backward(h, done, w)
        return m

    @staticmethod
    def backward(ctx, dm):
        h, done, w = ctx.saved_tensors
        dh, dw, db = dial_head_bwd(h, done, w, dm)
        return dh, None, dw, db


def dial_head(h, done, w, b) -> torch.Tensor:
    """m = ((1 - done) h) W + b of the module docstring: differentiable in
    h, w and b; ``done`` is data (detached here), None for no mask."""
    return DialHead.apply(h, None if done is None else done.detach(), w, b)
