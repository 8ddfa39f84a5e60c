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
launch forward and two backward (g = de * (e > 0), then the gradients;
``csrc/comm_embed.cu`` states the design and its bound): the gather is read
inside the per-agent product and the backward sums over the reverse
neighbour list, deterministically. It replaces no TPU kernel: XLA fuses the
JAX package's einsum chain.

Dispatch: CPU tensors run the plain twins ``comm_embed_fwd_ref`` /
``comm_embed_bwd_ref``; CUDA tensors launch a kernel, and raise if a launch
fails (there is no fallback): the tensor-core pair where ``takes_tc``
accepts the call (bf16 where the LSTM cell takes its tensor-core kernel,
and the layout fits), else the ``general`` pair (f32 FMAs on the CUDA
cores: float32, and every other width), one launch a call where the twin
takes a dozen ops. Both paths make the same checks first. The twins keep
the kernels' rounding points: the gather, one product over the
concatenated terms [obs | 1 | fp slots | h slots] accumulated in f32, one
rounding, then relu. Launches are counted in ``LAUNCHES``:
``comm_embed_fwd`` / ``comm_embed_bwd`` for the calls that mask their
sender feature by ``done`` (NeurComm's), ``comm_embed_dial_*`` for those
that do not (DIAL's messages); both run the same kernels, and which pair
ran follows from ``takes_tc``. A launch that a CUDA graph captures counts
once, at the capture.

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

LAUNCHES = {f"{family}_{d}": 0
            for family in ("comm_embed", "comm_embed_dial")
            for d in ("fwd", "bwd")}

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


def takes_tc(dtype: torch.dtype, S: int, A: int, K: int, F: int, H: int,
             R: int) -> bool:
    """Whether a CUDA call launches the tensor-core kernels, from what the
    call can see: where the LSTM cell takes its tensor-core kernel (bf16, F
    and H multiples of 16, at most 64), the [obs | 1 | fp] columns fit 64
    and both layouts fit one block's shared memory. Every other CUDA call
    launches the ``general`` kernels."""
    return (lstm_cell.kernel_variant(dtype, F, H) == "tc"
            and S + 1 + K * A <= _TC_MAX_W
            and max(tc_shared_bytes(S, A, K, F, H, R)) <= _MAX_SMEM)


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


def _dims(name, obs, fp, h, done, w_msg, nbr, rev, **same):
    """(B, N, S, A, K, F, H) after the checks both paths make: h on the CPU
    or a CUDA device in float32 or bfloat16, consistent shapes, every
    tensor on h's device, those of ``same`` (None skipped) in h's dtype and
    the tables int32."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: takes float32 or bfloat16, got {h.dtype}")
    B, N, H = h.shape
    S, A = obs.shape[-1], 0 if fp is None else fp.shape[-1]
    K, F = w_msg.shape[1], w_msg.shape[3]
    if obs.shape != (B, N, S) or (fp is not None and fp.shape != (B, N, A)) \
            or (done is not None and done.shape != (B,)) \
            or w_msg.shape != (N, K, H, F) or nbr.shape != (N, K) \
            or rev.ndim != 2 or rev.shape[0] != N:
        raise ValueError("comm_embed: inconsistent shapes")
    typed = [(t, what, h.dtype) for what, t in
             dict(obs=obs, fp=fp, w_msg=w_msg, **same).items()]
    for t, what, dtype in typed + [(done, "done", None),
                                   (nbr, "nbr", torch.int32),
                                   (rev, "rev", torch.int32)]:
        if t is None:
            continue
        if t.device != h.device:
            raise ValueError(f"comm_embed: {what} on {t.device}, expected "
                             f"{h.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"comm_embed: {what} is {t.dtype}, expected "
                            f"{dtype}")
    return B, N, S, A, K, F, H


def _ready(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` contiguous and 16-byte aligned (a copy only where it is not)."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, done, fn, *args) -> None:
    """Launch ``fn``; count it under NeurComm's keys, or DIAL's where the
    call masks nothing (``done`` None)."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if done is None:
        name = name.replace("comm_embed", "comm_embed_dial")
    LAUNCHES[name] += 1


def comm_embed_fwd(obs, fp, h, done, w_obs, b_obs, w_fp, w_msg, nbr,
                   rev) -> torch.Tensor:
    """Forward: e [B, N, F]. Launches a CUDA kernel for CUDA tensors (the
    tensor-core one where ``takes_tc`` accepts the call, from every shape,
    so that the backward takes the same), the plain twin for CPU tensors.
    ``fp`` with ``w_fp``, and ``done``, may be None (no fingerprint term; h
    unmasked)."""
    B, N, S, A, K, F, H = _dims("comm_embed_fwd", obs, fp, h, done, w_msg,
                                nbr, rev, w_obs=w_obs, b_obs=b_obs,
                                w_fp=w_fp)
    if w_obs.shape != (N, S, F) or b_obs.shape != (N, F) \
            or (w_fp is None) != (fp is None) \
            or (w_fp is not None and w_fp.shape != (N, K, A, F)):
        raise ValueError("comm_embed_fwd: inconsistent weight shapes")
    dev, dt = h.device, h.dtype
    if dev.type == "cpu":
        return comm_embed_fwd_ref(obs, fp, h, done, w_obs, b_obs, w_fp,
                                  w_msg, nbr)
    tc = takes_tc(dt, S, A, K, F, H, rev.shape[1])
    obs, fp, h, w_obs, b_obs, w_fp, w_msg, nbr = map(
        _ready, (obs, fp, h, w_obs, b_obs, w_fp, w_msg, nbr))
    if done is not None:
        done = _ready(done.to(dt))
    e = torch.empty((B, N, F), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        _launch("comm_embed_fwd", done, _kernels().comm_embed_fwd,
                _DTYPE_CODE[dt], int(tc), _ptr(obs), _ptr(fp), _ptr(h),
                _ptr(done), _ptr(w_obs), _ptr(b_obs), _ptr(w_fp), _ptr(w_msg),
                _ptr(nbr), _ptr(e), B, N, S, A, K, F, H,
                tc_splits(B, N, lstm_cell._sm_count(dev)) if tc else 1,
                torch.cuda.current_stream(dev).cuda_stream)
    return e


def comm_embed_bwd(obs, fp, h, done, w_msg, nbr, rev, e, de):
    """Backward: (dh, dw_obs, db_obs, dw_fp, dw_msg), all in the compute
    dtype (dw_fp None where ``fp`` is). Launches the CUDA backward of the
    pair the forward took for CUDA tensors, the weight gradients views of
    one allocation; the plain twin for CPU tensors."""
    B, N, S, A, K, F, H = _dims("comm_embed_bwd", obs, fp, h, done, w_msg,
                                nbr, rev, e=e, de=de)
    R = rev.shape[1]
    if e.shape != (B, N, F) or de.shape != (B, N, F):
        raise ValueError("comm_embed_bwd: inconsistent shapes")
    dev, dt = h.device, h.dtype
    if dev.type == "cpu":
        return comm_embed_bwd_ref(obs, fp, h, done, w_msg, nbr, rev, e, de)
    tc = takes_tc(dt, S, A, K, F, H, R)
    obs, fp, h, w_msg, nbr, rev, e, de = map(
        _ready, (obs, fp, h, w_msg, nbr, rev, e, de))
    if done is not None:
        done = _ready(done.to(dt))
    dh = torch.empty((B, N, H), dtype=dt, device=dev)
    # the tensor-core backward's g = de * (e > 0), formed once by its first
    # kernel and read by the second
    g = torch.empty_like(e) if tc else None
    sizes = [N * S * F, N * F, N * K * A * F, N * K * H * F]
    flat = torch.empty(sum(sizes), dtype=dt, device=dev)
    dw_obs, db, dw_fp, dw_msg = (
        part.view(shape) for part, shape in zip(
            torch.split(flat, sizes),
            [(N, S, F), (N, F), (N, K, A, F), (N, K, H, F)]))
    if fp is None:
        dw_fp = None
    with torch.cuda.device(dev):
        _launch("comm_embed_bwd", done, _kernels().comm_embed_bwd,
                _DTYPE_CODE[dt], int(tc), _ptr(obs), _ptr(fp), _ptr(h),
                _ptr(done), _ptr(w_msg), _ptr(nbr), _ptr(rev), _ptr(e),
                _ptr(de), _ptr(g), _ptr(dh), _ptr(dw_obs), _ptr(db),
                _ptr(dw_fp), _ptr(dw_msg), B, N, S, A, K, F, H, R,
                dh_splits(B, R) if tc else 1,
                torch.cuda.current_stream(dev).cuda_stream)
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
