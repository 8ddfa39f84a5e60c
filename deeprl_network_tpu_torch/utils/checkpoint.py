"""Checkpoint/resume on ``torch.save`` (counterpart of
``deeprl_network_tpu/utils/checkpoint.py``, which uses orbax).

The FULL TrainState round-trips: params, optimizer state, batched env state,
LSTM carries (in their compute dtype), fingerprints, the sampling generator's
state and the step, so a resumed run continues mid-episode exactly: ``k``
updates, save, restore, ``k`` more updates equal ``2k`` updates in one go
bit for bit.

A checkpoint is one file ``<model_dir>/checkpoint_<step>.pt`` holding a plain
nested dict of CPU tensors, ints, strings and lists (NamedTuples and the
TrainState dataclass are stored by field name), so it loads with
``torch.load(..., weights_only=True)``. It is written under a temporary name
and renamed, so a killed run leaves no half file.

Under data parallelism (an initialized process group of more than one
rank, ``parallel/``) every rank calls ``save``: the per-env fields of the
TrainState (``rollout.PER_ENV_FIELDS``) are assembled to the global batch
and rank 0 writes the one file, which is then exactly what one process
training the global batch would write. ``restore`` on any world size loads
the file and keeps the rank's rows, so a checkpoint moves between world
sizes; ``restore_params`` reads the params alone in any process.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, List, Optional

import torch

from deeprl_network_tpu_torch.models.policies import tree_map
from deeprl_network_tpu_torch.parallel import distributed
from deeprl_network_tpu_torch.utils.rollout import PER_ENV_FIELDS, TrainState

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def _to_plain(obj: Any) -> Any:
    """Tensors to the CPU, NamedTuples / dataclasses / dicts to dicts by
    field name, a ``torch.Generator`` to its device type and state."""
    if obj is None or isinstance(obj, (int, str)):
        return obj
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, torch.Generator):
        return {"device_type": obj.device.type, "state": obj.get_state()}
    if hasattr(obj, "_fields"):                      # NamedTuple
        return {f: _to_plain(getattr(obj, f)) for f in obj._fields}
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _tensor_like(like: torch.Tensor, node: Any, path: str,
                 what: str) -> torch.Tensor:
    t = torch.as_tensor(node)
    if t.shape != like.shape:
        raise ValueError(
            f"checkpoint {what} {path!r} has shape {tuple(t.shape)}, "
            f"model expects {tuple(like.shape)} (different topology or "
            f"model config?)")
    return t.to(device=like.device)


def _from_plain(like: Any, node: Any, path: str) -> Any:
    """Rebuild ``like``'s structure from the stored plain tree; every
    tensor goes to the device of its counterpart in ``like``."""
    if like is None:
        return None
    if node is None:
        raise ValueError(f"checkpoint has nothing at {path!r}, which the "
                         f"current state requires")
    if torch.is_tensor(like):
        t = _tensor_like(like, node, path, "leaf")
        if t.dtype != like.dtype:
            raise ValueError(
                f"checkpoint leaf {path!r} has dtype {t.dtype}, the "
                f"current state {like.dtype} (different compute_dtype?)")
        return t
    if isinstance(like, torch.Generator):
        if node["device_type"] != like.device.type:
            raise ValueError(
                f"the checkpoint's generator state was saved on a "
                f"{node['device_type']!r} device and cannot be restored "
                f"into a {like.device.type!r} generator: a generator state "
                f"is specific to the device type (restore_params works "
                f"across devices)")
        gen = torch.Generator(device=like.device)
        gen.set_state(node["state"])
        return gen
    if isinstance(like, (int, str)):
        return type(like)(node)
    if hasattr(like, "_fields"):
        missing = [f for f in like._fields if f not in node]
        if missing:
            raise ValueError(f"checkpoint has no field "
                             f"{path + '.' + missing[0]!r}")
        return type(like)(*(_from_plain(getattr(like, f), node[f],
                                        path + "." + f)
                            for f in like._fields))
    if dataclasses.is_dataclass(like):
        return type(like)(**{
            f.name: _from_plain(getattr(like, f.name), node.get(f.name),
                                path + "." + f.name)
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _from_plain(v, node.get(k), path + "." + str(k))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(node) != len(like):
            raise ValueError(f"checkpoint holds {len(node)} entries at "
                             f"{path!r}, the current state {len(like)}")
        return [_from_plain(v, n, f"{path}[{i}]")
                for i, (v, n) in enumerate(zip(like, node))]
    raise TypeError(f"cannot restore a {type(like).__name__} at {path!r}")


def _map_plain(fn, node):
    """A stored plain tree (dicts of tensors) with ``fn`` applied to every
    tensor."""
    if isinstance(node, dict):
        return {k: _map_plain(fn, v) for k, v in node.items()}
    return fn(torch.as_tensor(node))


def _global_state(ts: TrainState) -> TrainState:
    """The TrainState of the whole global batch, from every rank's rows
    (a collective: every rank must call it)."""
    return dataclasses.replace(ts, **{
        f: tree_map(distributed.gather_rows, getattr(ts, f))
        for f in PER_ENV_FIELDS})


def _rank_rows(raw: dict, like: TrainState) -> dict:
    """The stored TrainState tree with its per-env fields cut to this
    rank's rows, the rows ``like`` holds."""
    b, n, r = like.obs.shape[0], distributed.world_size(), \
        distributed.rank()
    stored = torch.as_tensor(raw["obs"]).shape[0]
    if stored != b * n:
        raise ValueError(
            f"checkpoint holds a global batch of {stored} envs; this run "
            f"has {n} rank(s) of {b} (a global batch of {b * n})")
    return dict(raw, **{f: _map_plain(lambda t: t[r * b:(r + 1) * b], raw[f])
                        for f in PER_ENV_FIELDS})


class CheckpointManager:
    def __init__(self, model_dir: str, max_to_keep: int = 5):
        self.path = os.path.abspath(model_dir)
        os.makedirs(self.path, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _file(self, step: int) -> str:
        return os.path.join(self.path, f"checkpoint_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        steps = (_NAME.match(f) for f in os.listdir(self.path))
        return sorted(int(m.group(1)) for m in steps if m)

    def save(self, step: int, train_state: Any) -> None:
        """Write ``train_state`` (a TrainState, or any tree of NamedTuples,
        dicts, lists, tensors and ints) as the checkpoint of ``step``, then
        drop the oldest checkpoints beyond ``max_to_keep``. Under data
        parallelism every rank calls it with its TrainState, and rank 0
        writes the global one."""
        if distributed.world_size() == 1:
            self._write(step, train_state)
            return
        state = _global_state(train_state)
        ok = False
        try:
            if distributed.is_primary():
                self._write(step, state)
            ok = True
        finally:
            # a barrier that also tells the other ranks whether the file
            # was written (rank 0 raises its own error)
            written = distributed.all_ok(ok, train_state.obs.device)
        if not written:
            raise RuntimeError(f"rank 0 failed to write the checkpoint of "
                               f"step {step}")

    def _write(self, step: int, train_state: Any) -> None:
        final = self._file(step)
        tmp = final + f".tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                torch.save(_to_plain(train_state), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        if self.max_to_keep and self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._file(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._file(step), map_location="cpu",
                          weights_only=True)

    def restore(self, train_state_like: Any, step: Optional[int] = None
                ) -> Any:
        """The stored state in the structure, devices and dtypes of
        ``train_state_like``; ``None`` when there is no checkpoint. A
        TrainState's per-env fields are this rank's rows of the stored
        global batch."""
        raw = self._load(step)
        if raw is None:
            return None
        if (isinstance(train_state_like, TrainState)
                and distributed.world_size() > 1):
            raw = _rank_rows(raw, train_state_like)
        return _from_plain(train_state_like, raw, "state")

    def restore_params(self, params_like: Any,
                       step: Optional[int] = None) -> Any:
        """Restore ONLY the policy params, regardless of how the rest of
        the TrainState was shaped at save time (a checkpoint written by a
        data-parallel run carries a global env batch; evaluation needs
        none of it), from any device to the device of ``params_like``.
        Reads the raw stored tree and rebuilds the params NamedTuple
        structure by field name."""
        raw = self._load(step)
        if raw is None:
            return None
        raw_params = raw["params"]

        def pick(like, node, path):
            if like is None:
                return None
            if node is None:
                raise ValueError(
                    f"checkpoint params missing a leaf at {path!r} that "
                    f"the current model requires (stored None / absent); "
                    f"model and checkpoint disagree structurally")
            if hasattr(like, "_fields"):      # NamedTuple
                vals = []
                for f in like._fields:
                    want = getattr(like, f)
                    # tolerate fields added after the checkpoint was
                    # written ONLY when the template says they are unused
                    if f not in node:
                        if want is None:
                            vals.append(None)
                            continue
                        raise ValueError(
                            f"checkpoint params missing field "
                            f"{path + '.' + f!r} required by the model")
                    vals.append(pick(want, node[f], path + "." + f))
                return type(like)(*vals)
            if isinstance(like, dict):
                return {k: pick(v, node.get(k), path + "." + k)
                        for k, v in like.items()}
            return _tensor_like(like, node, path, "param").to(like.dtype)

        return pick(params_like, raw_params, "params")
