"""The comm input embedding over packed neighbour lists (NeurComm's and
DIAL's): a CUDA kernel each way, their plain twins, and the
``autograd.Function`` that joins them.

The MA2C_NC policy with ``sparse_comm`` feeds each agent's LSTM cell with

    e[b,n] = relu(obs[b,n] W_obs[n] + b_obs[n]
                  + sum_k fp[b, nbr[n,k]] W_fp[n,k]
                  + sum_k ((1 - done[b]) h[b, nbr[n,k]]) W_msg[n,k])

over the valid slots k of agent n (``models/policies.py`` ``_embed``).
The MA2C_DIAL policy makes the same call with no fingerprint term (``fp``
and ``w_fp`` None: A = 0) and its messages m = ((1 - done) h) W_dial +
b_dial in the place of h, unmasked (``done`` None): the message head is a
kernel of its own (``ops/dial_head.py``), which writes m as the [B, N, D]
rows read here and takes the gradient of m back to h and the head. As
PyTorch ops that is a gather of a [B, N, K, X] tensor for
each sender feature, three einsums, the adds and the relu: about 12
kernels a control step forward and 16 backward, where the gradient of
``h``'s gather is a sorting ``index_put``. ``comm_embed`` computes it in one
launch forward and one backward call (two launches on the tensor cores:
g = de * (e > 0), then the gradients; ``csrc/comm_embed.cu`` states the
design and its bound): the gather is read inside the per-agent product and
the backward sums over the reverse neighbour list, deterministically. It
replaces no TPU kernel: XLA fuses the JAX package's einsum chain.

Dispatch is by the tensors' device: CUDA tensors launch a kernel (and raise
if a launch fails; there is no fallback), CPU tensors run the plain twins
``comm_embed_fwd_ref`` / ``comm_embed_bwd_ref``, which keep the kernels'
rounding points: the gather, one product over the concatenated terms
[obs | 1 | fp slots | h slots] accumulated in f32, one rounding, then relu.
On the card ``kernel_variant`` picks ``"tc"`` (bf16 on the tensor cores,
where the LSTM cell takes its tensor-core kernel and the layout fits) or
``"general"`` (f32 FMAs on the CUDA cores: float32, and every other width).
Launches are counted in ``LAUNCHES``: ``comm_embed_fwd`` / ``comm_embed_bwd``
and per variant (``comm_embed_fwd_tc``, ...) for the calls that mask their
sender feature by ``done`` (NeurComm's), ``comm_embed_dial_*`` for those
that do not (DIAL's messages); both run the same kernels. A launch that a
CUDA graph captures counts once, at the capture.

Shapes: obs [B,N,S], fp [B,N,A] or None, h [B,N,H] (the unmasked carry, or
DIAL's messages, H = n_msg), done [B] or None, w_obs [N,S,F], b_obs [N,F],
w_fp [N,K,A,F] or None, w_msg [N,K,H,F] (packed by ``mask_comm_params``),
and the tables of ``neighbour_tables``: nbr [N,K] and rev [N,R] int32.
float32 or bfloat16, one dtype for all.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from deeprl_network_tpu_torch.ops import _build
from deeprl_network_tpu_torch.ops import lstm_cell
from deeprl_network_tpu_torch.ops.lstm_cell import (
    _DTYPE_CODE, _acc_dtype, _ptr,
)

LAUNCHES = {f"{family}_{d}{v}": 0
            for family in ("comm_embed", "comm_embed_dial")
            for d in ("fwd", "bwd") for v in ("", "_tc", "_general")}

_VARIANT_CODE = {"general": 0, "tc": 1}
_BT = 64            # batch rows of a tile, kBT in comm_embed.cu
_TC_MAX_W = 64      # kMaxW: largest F, H and padded [obs | 1 | fp] width
_MAX_SMEM = 232448  # shared memory one block may opt into on the H100
_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    """The library, built and loaded at first use."""
    global _lib
    if _lib is None:
        lib = _build.load("comm_embed")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.comm_embed_fwd.argtypes = [I, I] + [P] * 10 + [I] * 8 + [P]
        lib.comm_embed_bwd.argtypes = [I, I] + [P] * 15 + [I] * 9 + [P]
        lib.comm_embed_smem.argtypes = [I] * 7
        for fn in (lib.comm_embed_fwd, lib.comm_embed_bwd,
                   lib.comm_embed_smem):
            fn.restype = I
        _lib = lib
    return _lib


def neighbour_tables(idx: np.ndarray, valid: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(nbr [N, K], rev [N, R]) int32 from ``PolicySpec.neighbor_lists``:
    nbr holds each receiver's senders by slot, -1 in an empty slot; row m of
    rev lists ``receiver * K + slot`` for every slot that reads sender m, in
    ascending order, padded with -1 to R = the largest in-degree (at least
    1). Built once on the host."""
    n, k = idx.shape
    nbr = np.where(valid > 0, idx, -1).astype(np.int32)
    readers = [[] for _ in range(n)]
    for i in range(n):
        for s in range(k):
            if nbr[i, s] >= 0:
                readers[nbr[i, s]].append(i * k + s)
    r = max(1, max(len(x) for x in readers))
    rev = np.full((n, r), -1, np.int32)
    for m, x in enumerate(readers):
        rev[m, :len(x)] = x
    return nbr, rev


def _operand(obs, fp, h, done, nbr):
    """The gathered operand [B, N, S + 1 + K A + K H] in the compute dtype:
    [obs | 1 | fp of each slot | h of each slot, times 1 - done], empty slots
    zero; no fingerprint columns where ``fp`` is None, h unmasked where
    ``done`` is."""
    dt = h.dtype
    if done is not None:
        h = h * (1.0 - done.to(dt))[:, None, None]
    vm = (nbr >= 0).to(dt)[None, :, :, None]
    idx = nbr.clamp(min=0).long()
    one = torch.ones(h.shape[:2] + (1,), dtype=dt, device=h.device)
    fps = [] if fp is None else [(fp[:, idx] * vm).flatten(2)]
    return torch.cat([obs, one, *fps, (h[:, idx] * vm).flatten(2)], -1)


def comm_embed_fwd_ref(obs, fp, h, done, w_obs, b_obs, w_fp, w_msg, nbr):
    """Plain twin of the forward kernel: e [B, N, F]."""
    dt = h.dtype
    acc = _acc_dtype(dt)
    w_fps = [] if w_fp is None else [w_fp.flatten(1, 2)]
    w = torch.cat([w_obs, b_obs[:, None], *w_fps, w_msg.flatten(1, 2)], 1)
    e = torch.einsum("bnd,ndf->bnf", _operand(obs, fp, h, done, nbr).to(acc),
                     w.to(acc)).to(dt)
    return torch.relu(e)


def comm_embed_bwd_ref(obs, fp, h, done, w_msg, nbr, rev, e, de):
    """Plain twin of the backward kernel: (dh, dw_obs, db_obs, dw_fp,
    dw_msg), each summed in f32 and rounded once to the compute dtype; the
    gradient of an empty slot is 0; dw_fp is None where ``fp`` is."""
    dt = h.dtype
    acc = _acc_dtype(dt)
    N, K, H, F = w_msg.shape
    S, A = obs.shape[-1], 0 if fp is None else fp.shape[-1]
    g = torch.where(e > 0, de, torch.zeros_like(de)).to(acc)
    dw = torch.einsum("bnd,bnf->ndf",
                      _operand(obs, fp, h, done, nbr).to(acc), g).to(dt)
    dw_obs, db, dw_fp, dw_msg = torch.split(dw, [S, 1, K * A, K * H], 1)
    r = rev.clamp(min=0).long()
    gg = g[:, r // K] * (rev >= 0).to(acc)[None, :, :, None]   # [B, N, R, F]
    dh = torch.einsum("bmrf,mrhf->bmh", gg, w_msg[r // K, r % K].to(acc))
    if done is not None:
        dh = dh * (1.0 - done.to(dt)).to(acc)[:, None, None]
    return (dh.to(dt), dw_obs.contiguous(), db[:, 0].contiguous(),
            None if fp is None else dw_fp.reshape(N, K, A, F),
            dw_msg.reshape(N, K, H, F))


def tc_shared_bytes(S: int, A: int, K: int, F: int, H: int,
                    R: int) -> Tuple[int, int]:
    """Dynamic shared memory of the tensor-core forward and backward
    (``FwdLayout`` and ``BwdLayout`` in comm_embed.cu)."""
    up16 = lambda x: -(-x // 16) * 16
    Pp = up16(S + 1 + K * A)
    D = Pp + K * H
    fwd_stage = _BT * (D + 8) * 2 + _BT * (F + 8) * 2 + _BT * 2
    fwd = D * (F + 8) * 2 + 3 * fwd_stage + up16(K * 4) + 10 * 8
    bwd_stage = _BT * (F + 8) * 2 + _BT * (_TC_MAX_W + 8) * 2 + _BT * 2
    bwd = (R * H * (F + 8) * 2 + 3 * bwd_stage + _BT * _TC_MAX_W * 4
           + up16(max(K, R) * 4) + 7 * 8)
    return fwd, bwd


def kernel_variant(dtype: torch.dtype, S: int, A: int, K: int, F: int,
                   H: int, R: int) -> str:
    """Which kernel a CUDA call takes, from what the call can see: ``"tc"``
    where the LSTM cell takes its tensor-core kernel (bf16, F and H
    multiples of 16, at most 64), the [obs | 1 | fp] columns fit 64 and both
    layouts fit one block's shared memory; else ``"general"``."""
    if lstm_cell.kernel_variant(dtype, F, H) == "tc" \
            and S + 1 + K * A <= _TC_MAX_W \
            and max(tc_shared_bytes(S, A, K, F, H, R)) <= _MAX_SMEM:
        return "tc"
    return "general"


def tc_splits(B: int, N: int, sm_count: int) -> int:
    """Blocks per agent of the tensor-core forward: as many as fill the
    card's SMs once (one block an SM fits), at most one a tile."""
    return max(1, min(-(-B // _BT), sm_count // max(N, 1)))


def dh_splits(B: int, R: int) -> int:
    """Blocks per sender of the tensor-core dh: 2 R (each then streams about
    half as many chunks as a weight-gradient pair's half walks tiles; 6 and
    12 blocks per sender timed alike at the flagship shape, 4 slower), at
    most one a tile."""
    return max(1, min(-(-B // _BT), 2 * R))


def _count(name: str, variant: str, done) -> None:
    """A launch under NeurComm's keys, or DIAL's where the call masks
    nothing (``done`` None)."""
    if done is None:
        name = name.replace("comm_embed", "comm_embed_dial")
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_{variant}"] += 1


def _ready(t: torch.Tensor, dtype, device, name: str) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned on the kernel's device and in
    its dtype (a copy only where it is not)."""
    if t.device != device:
        raise ValueError(f"comm_embed: {name} on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"comm_embed: {name} is {t.dtype}, expected {dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dims(obs, fp, h, done, w_msg, nbr, rev):
    B, N, H = h.shape
    S, A = obs.shape[-1], 0 if fp is None else fp.shape[-1]
    K, F = w_msg.shape[1], w_msg.shape[3]
    if obs.shape != (B, N, S) or (fp is not None and fp.shape != (B, N, A)) \
            or (done is not None and done.shape != (B,)) \
            or w_msg.shape != (N, K, H, F) or nbr.shape != (N, K) \
            or rev.ndim != 2 or rev.shape[0] != N:
        raise ValueError("comm_embed: inconsistent shapes")
    return B, N, S, A, K, F, H


def _variant_for(dtype, dims, R, _variant):
    S, A, K, F, H = dims[2:]
    auto = kernel_variant(dtype, S, A, K, F, H, R)
    variant = auto if _variant is None else _variant
    if variant not in _VARIANT_CODE:
        raise ValueError(f"unknown kernel variant {variant!r}")
    if variant == "tc" and auto != "tc":
        raise ValueError(f"the tensor-core kernels do not take {dtype}, "
                         f"S={S}, A={A}, K={K}, F={F}, H={H}, R={R}")
    return variant


def _launch(name: str, variant: str, done, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} ({variant}) kernel launch failed: "
                           f"cudaError {err}")
    _count(name, variant, done)


def _ready_or_none(t, dtype, device, name):
    return None if t is None else _ready(t, dtype, device, name)


def comm_embed_fwd(obs, fp, h, done, w_obs, b_obs, w_fp, w_msg, nbr, rev, *,
                   _variant: Optional[str] = None) -> torch.Tensor:
    """Forward: e [B, N, F]. Launches the CUDA kernel for CUDA tensors
    (which one: ``kernel_variant``, from every shape, so that the backward
    takes the same), the plain twin for CPU tensors. ``fp`` with ``w_fp``,
    and ``done``, may be None (no fingerprint term; h unmasked).
    ``_variant`` is for tests and measurements; the model's path never
    passes it."""
    if h.device.type == "cpu":
        return comm_embed_fwd_ref(obs, fp, h, done, w_obs, b_obs, w_fp,
                                  w_msg, nbr)
    if h.device.type != "cuda":
        raise ValueError(f"comm_embed_fwd: unsupported device {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"comm_embed kernels take float32 or bfloat16, got "
                        f"{h.dtype}")
    dims = _dims(obs, fp, h, done, w_msg, nbr, rev)
    B, N, S, A, K, F, H = dims
    if w_obs.shape != (N, S, F) or b_obs.shape != (N, F) \
            or (w_fp is None) != (fp is None) \
            or (w_fp is not None and w_fp.shape != (N, K, A, F)):
        raise ValueError("comm_embed_fwd: inconsistent weight shapes")
    dev, dt = h.device, h.dtype
    obs, fp, h, w_obs, b_obs, w_fp, w_msg = (
        _ready_or_none(t, dt, dev, name) for t, name in (
            (obs, "obs"), (fp, "fp"), (h, "h"), (w_obs, "w_obs"),
            (b_obs, "b_obs"), (w_fp, "w_fp"), (w_msg, "w_msg")))
    if done is not None:
        done = _ready(done.to(dt), dt, dev, "done")
    nbr = _ready(nbr, torch.int32, dev, "nbr")
    variant = _variant_for(dt, dims, rev.shape[1], _variant)
    splits = 1
    if variant == "tc":
        splits = tc_splits(B, N, lstm_cell._sm_count(dev))
    e = torch.empty((B, N, F), dtype=dt, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("comm_embed_fwd", variant, done, lib.comm_embed_fwd,
                _DTYPE_CODE[dt], _VARIANT_CODE[variant], _ptr(obs), _ptr(fp),
                _ptr(h), _ptr(done), _ptr(w_obs), _ptr(b_obs), _ptr(w_fp),
                _ptr(w_msg), _ptr(nbr), _ptr(e), B, N, S, A, K, F, H, splits,
                stream)
    return e


def comm_embed_bwd(obs, fp, h, done, w_msg, nbr, rev, e, de, *,
                   _variant: Optional[str] = None):
    """Backward: (dh, dw_obs, db_obs, dw_fp, dw_msg), all in the compute
    dtype, the weight gradients views of one allocation (dw_fp None where
    ``fp`` is). Launches one CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors."""
    if h.device.type == "cpu":
        return comm_embed_bwd_ref(obs, fp, h, done, w_msg, nbr, rev, e, de)
    if h.device.type != "cuda":
        raise ValueError(f"comm_embed_bwd: unsupported device {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"comm_embed kernels take float32 or bfloat16, got "
                        f"{h.dtype}")
    dims = _dims(obs, fp, h, done, w_msg, nbr, rev)
    B, N, S, A, K, F, H = dims
    R = rev.shape[1]
    if e.shape != (B, N, F) or de.shape != (B, N, F):
        raise ValueError("comm_embed_bwd: inconsistent shapes")
    dev, dt = h.device, h.dtype
    obs, fp, h, w_msg, e, de = (
        _ready_or_none(t, dt, dev, name) for t, name in (
            (obs, "obs"), (fp, "fp"), (h, "h"), (w_msg, "w_msg"), (e, "e"),
            (de, "de")))
    if done is not None:
        done = _ready(done.to(dt), dt, dev, "done")
    nbr = _ready(nbr, torch.int32, dev, "nbr")
    rev = _ready(rev, torch.int32, dev, "rev")
    variant = _variant_for(dt, dims, R, _variant)
    splits = dh_splits(B, R) if variant == "tc" else 1
    dh = torch.empty((B, N, H), dtype=dt, device=dev)
    # the tensor-core backward's g = de * (e > 0), formed once and read by
    # its second kernel
    g = torch.empty_like(e) if variant == "tc" else None
    sizes = [N * S * F, N * F, N * K * A * F, N * K * H * F]
    flat = torch.empty(sum(sizes), dtype=dt, device=dev)
    dw_obs, db, dw_fp, dw_msg = (
        part.view(shape) for part, shape in zip(
            torch.split(flat, sizes),
            [(N, S, F), (N, F), (N, K, A, F), (N, K, H, F)]))
    if fp is None:
        dw_fp = None
    lib = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("comm_embed_bwd", variant, done, lib.comm_embed_bwd,
                _DTYPE_CODE[dt], _VARIANT_CODE[variant], _ptr(obs), _ptr(fp),
                _ptr(h), _ptr(done), _ptr(w_msg), _ptr(nbr), _ptr(rev),
                _ptr(e), _ptr(de), _ptr(g), _ptr(dh), _ptr(dw_obs), _ptr(db),
                _ptr(dw_fp), _ptr(dw_msg), B, N, S, A, K, F, H, R, splits,
                stream)
    return dh, dw_obs, db, dw_fp, dw_msg


class CommEmbed(torch.autograd.Function):
    """The embedding with its fused backward. Saves (obs, fp, h, done,
    w_msg, nbr, rev) and its output e, whose sign is the relu's mask (the
    LSTM cell keeps e as its input, so it costs no memory); obs, fp, done
    and the tables get no gradient, nor a ``w_fp`` that is None."""

    @staticmethod
    def forward(ctx, obs, fp, h, done, w_obs, b_obs, w_fp, w_msg, nbr, rev):
        e = comm_embed_fwd(obs, fp, h, done, w_obs, b_obs, w_fp, w_msg, nbr,
                           rev)
        ctx.save_for_backward(obs, fp, h, done, w_msg, nbr, rev, e)
        return e

    @staticmethod
    def backward(ctx, de):
        obs, fp, h, done, w_msg, nbr, rev, e = ctx.saved_tensors
        dh, dw_obs, db, dw_fp, dw_msg = comm_embed_bwd(
            obs, fp, h, done, w_msg, nbr, rev, e, de)
        return None, None, dh, None, dw_obs, db, dw_fp, dw_msg, None, None


def comm_embed(obs, fp, h, done, w_obs, b_obs, w_fp, w_msg, nbr,
               rev) -> torch.Tensor:
    """e = relu(...) of the module docstring: differentiable in h and the
    weights. ``fp`` is data (detached here); ``obs`` gets no gradient, and
    an ``obs`` that requires one is refused. DIAL's call: ``fp``, ``done``
    and ``w_fp`` None, h its messages."""
    if obs.requires_grad:
        raise ValueError("comm_embed: obs gets no gradient; detach it")
    return CommEmbed.apply(obs, None if fp is None else fp.detach(), h, done,
                           w_obs, b_obs, w_fp, w_msg, nbr, rev)
