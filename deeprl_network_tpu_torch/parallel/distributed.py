"""Process-group set-up and the collectives of data-parallel training
(counterpart of ``deeprl_network_tpu/parallel/distributed.py``).

Every rank runs the same program on its own slice of the env batch; params
stay replicated. ``maybe_initialize`` joins the ranks into one
``torch.distributed`` process group: NCCL between CUDA cards, gloo on the
CPU and for ranks that share one card. Single-process runs need none of
this; ``maybe_initialize`` is a no-op unless torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) or explicit arguments are
present:

    torchrun --nproc_per_node=G -m deeprl_network_tpu_torch.main ...

The collectives are ``all_reduce`` and ``broadcast`` only (gloo offers no
``all_gather`` for CUDA tensors), so one code path serves both backends.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# a dead peer fails the run after this long instead of hanging it
TIMEOUT = datetime.timedelta(minutes=30)
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def maybe_initialize(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the default process group when running data-parallel.

    Returns True if the group is (now) initialized. Explicit arguments
    (``init_method`` such as ``"tcp://localhost:29500"``, with
    ``world_size`` and ``rank``) override torchrun's variables. ``backend``
    defaults to NCCL where a CUDA card is present and gloo otherwise;
    ``backend="gloo"`` lets several ranks share one card. Under NCCL each
    rank takes the card ``LOCAL_RANK``.
    """
    if dist.is_initialized():
        return True
    explicit = init_method is not None
    auto = all(v in os.environ for v in _TORCHRUN_VARS)
    if not (explicit or auto):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = dict(init_method=init_method, world_size=world_size,
                  rank=rank) if explicit else {}
    dist.init_process_group(backend, timeout=TIMEOUT, **kwargs)
    if backend == "nccl":
        # before the first collective, which builds the communicator on
        # the current card
        torch.cuda.set_device(_local_rank())
    log.info("torch.distributed initialized: rank %d of %d, backend %s",
             dist.get_rank(), dist.get_world_size(), backend)
    return True


def _local_rank() -> int:
    """``LOCAL_RANK`` where torchrun set it, else the rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank() % max(torch.cuda.device_count(), 1)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Only the primary rank writes logs, metric rows, evaluations and
    checkpoint files."""
    return rank() == 0


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` under NCCL, else
    ``device`` itself (gloo ranks may share one card)."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", _local_rank())
    return device


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _unflat(flat: torch.Tensor, like: List[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over ranks of each tensor, through ONE ``all_reduce`` of a
    flat f32 buffer (sum, then divided by the world size)."""
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return _unflat(flat / dist.get_world_size(), tensors)


def broadcast(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Rank 0's values of ``tensors`` on every rank, through one
    ``broadcast`` of a flat f32 buffer (exact for f32 and bf16 tensors)."""
    flat = _flat(tensors)
    dist.broadcast(flat, src=0)
    return _unflat(flat, tensors)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's rows of it (rank r holds rows
    ``[r*b, (r+1)*b)``): each rank writes its rows into a zero-filled
    global buffer and one ``all_reduce`` sums them, which is exact. Bools
    travel as uint8 and half types as f32."""
    b, n, r = t.shape[0], world_size(), rank()
    wire = {torch.bool: torch.uint8, torch.bfloat16: torch.float32,
            torch.float16: torch.float32}.get(t.dtype, t.dtype)
    buf = torch.zeros((n * b,) + tuple(t.shape[1:]), dtype=wire,
                      device=t.device)
    buf[r * b:(r + 1) * b] = t.to(wire)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.dtype)


def all_ok(ok: bool, device) -> bool:
    """True on every rank when ``ok`` holds on every rank; also a barrier
    (an ``all_reduce`` of one flag)."""
    flag = torch.tensor([0.0 if ok else 1.0], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.SUM)
    return float(flag) == 0.0
