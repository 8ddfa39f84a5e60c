"""One CUDA graph an update: the port's counterpart of the JAX package's
``jax.jit(train_step, donate_argnums=0)`` (``utils/rollout.py``).

``GraphedStep`` captures a function of tensors once and replays it on every
later call, so that an update costs the host one graph launch and a handful
of copies in place of every kernel launch of the update from Python:

- **Capture.** A warm-up call on a side stream (it builds the kernels,
  loads their libraries, allocates the backward's scratch and sets up
  autograd's streams), then ``torch.cuda.graph(g, stream=side)`` around a
  second call. The warm-up reads the static inputs and draws from a copy of
  the caller's generator, so the caller's state and generator do not move.
  One graph is kept for each key the caller gives (``rollout.py``: whether
  the Gumbel noise is given).
- **Noise.** The function draws from ``self.generator``, which every graph
  registers (``CUDAGraph.register_generator_state``): each replay then reads
  that generator's seed and offset as they are when it starts and advances
  them by what one call draws. Before a replay the caller's generator state
  is copied into it (``set_state``, which keeps the registered state object)
  and after the replay back, so the caller's generator advances as the
  eager call would advance it, and a replay from a state draws what the
  eager call from that state draws.
- **Values, not donation.** The inputs and outputs live in arenas: one flat
  buffer per dtype, each leaf a view at an offset aligned as the caching
  allocator aligns a block (512 bytes), so that no kernel sees another
  alignment than in the eager call. After a replay each output arena is
  cloned once and the caller gets views of the clones: no returned leaf
  shares storage with a static buffer, and the caller may keep any earlier
  state. A state whose leaves are the views of one such clone is copied
  into the static inputs with one ``copy_`` an arena; any other state (the
  first call, a restored checkpoint) leaf by leaf.

Nothing runs in Python at a replay: code that counts or watches calls (the
kernel wrappers' launch counters) sees the warm-up and the capture only.
So the graph's own span (``utils/spans.py``) is two marks captured as its
first and last nodes, around ``fn`` and the pack of its outputs; the host
spans ``copy_in``, ``scalars_write`` and ``launch`` time a call's copies into
the static inputs, the scalars' write and the replay.

There is no fallback: a capture or a replay that fails raises. On the CPU
nothing here is used; the caller runs its function directly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple,
)

import torch

from deeprl_network_tpu_torch.utils.spans import Spans

ALIGN_BYTES = 512     # the caching allocator's block alignment


class Arena:
    """The layout of a list of tensors in one flat buffer per dtype: leaf i
    is ``bufs[dtype][off:off + numel].view(shape)``, every offset aligned to
    ``ALIGN_BYTES``. ``size`` is each buffer's length in elements."""

    def __init__(self, like: Sequence[torch.Tensor]):
        self.slots: List[Tuple[torch.dtype, int, Tuple[int, ...], int]] = []
        self.size: Dict[torch.dtype, int] = {}
        for t in like:
            step = max(ALIGN_BYTES // t.element_size(), 1)
            off = -(-self.size.get(t.dtype, 0) // step) * step
            self.slots.append((t.dtype, off, tuple(t.shape), t.numel()))
            self.size[t.dtype] = off + t.numel()

    def alloc(self, device) -> Dict[torch.dtype, torch.Tensor]:
        return {dt: torch.empty(n, dtype=dt, device=device)
                for dt, n in self.size.items()}

    def views(self, bufs: Dict[torch.dtype, torch.Tensor]
              ) -> List[torch.Tensor]:
        return [bufs[dt][off:off + n].view(shape)
                for dt, off, shape, n in self.slots]

    def pack(self, tensors: Sequence[torch.Tensor], device
             ) -> Dict[torch.dtype, torch.Tensor]:
        """New buffers holding ``tensors``; the padding is left as it is."""
        bufs = self.alloc(device)
        for view, t in zip(self.views(bufs), tensors):
            view.copy_(t)
        return bufs

    def base_of(self, tensors: Sequence[torch.Tensor], dtype: torch.dtype
                ) -> Optional[torch.Tensor]:
        """The one flat tensor whose views at this layout's offsets are all
        of ``tensors`` of ``dtype`` (a clone handed out after a replay),
        else None."""
        base = None
        for t, (dt, off, shape, n) in zip(tensors, self.slots):
            if dt != dtype:
                continue
            b = t._base
            if base is None:
                base = b
            if (b is None or b is not base or b.dtype != dt or b.ndim != 1
                    or b.numel() < self.size[dt] or tuple(t.shape) != shape
                    or not t.is_contiguous()
                    or t.data_ptr() != b.data_ptr() + off * t.element_size()):
                return None
        return base

    def copy_in(self, bufs: Dict[torch.dtype, torch.Tensor],
                tensors: Sequence[torch.Tensor]) -> None:
        """Write ``tensors`` into ``bufs``: one copy a dtype where they are
        views of one clone of this layout, else one copy a leaf."""
        views = None
        for dt, buf in bufs.items():
            base = self.base_of(tensors, dt)
            if base is not None:
                buf.copy_(base[:self.size[dt]])
                continue
            if views is None:
                views = self.views(bufs)
            for v, t, slot in zip(views, tensors, self.slots):
                if slot[0] == dt:
                    v.copy_(t)


class HostScalars:
    """A few f32 values from the host into a device tensor: on a card
    through one asynchronous copy from pinned memory (before the pinned
    buffer is written again the host waits for the previous copy, not for
    the work queued before it), on the CPU by a plain copy."""

    def __init__(self, n: int, device):
        self.device = torch.device(device)
        self.n = n
        self.host = None
        if self.device.type == "cuda":
            self.host = torch.empty(n, dtype=torch.float32, pin_memory=True)
            self._copied = torch.cuda.Event()

    def write(self, values: Sequence[float], out: torch.Tensor) -> None:
        if self.host is None:
            out.copy_(torch.tensor(values, dtype=torch.float32))
            return
        self._copied.synchronize()
        self.host.numpy()[:] = values
        out.copy_(self.host, non_blocking=True)
        self._copied.record()

    def tensor(self, values: Sequence[float]) -> torch.Tensor:
        """A new device tensor holding ``values``."""
        out = torch.empty(self.n, dtype=torch.float32, device=self.device)
        self.write(values, out)
        return out


@dataclass
class _Captured:
    """One key's graph and its static tensors."""

    graph: Any
    arena_in: Arena
    state_in: Dict[torch.dtype, torch.Tensor]
    scalars_in: torch.Tensor                   # [n] f32
    extras_in: List[Optional[torch.Tensor]]    # None where absent
    out_arena: Arena
    out_bufs: Dict[torch.dtype, torch.Tensor]  # written by every replay
    n_state: int
    names: List[str]                           # the output dict's keys
    times: Dict[str, float]   # seconds of warm-up, capture, instantiation


StepFn = Callable[[List[torch.Tensor], torch.Tensor,
                   List[Optional[torch.Tensor]], torch.Generator],
                  Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]]


class GraphedStep:
    """``fn(state, scalars, extras, generator) -> (state', outputs)`` as one
    CUDA graph a key. ``state`` and ``state'`` are lists of tensors of the
    same dtypes and shapes; ``scalars`` is an f32 tensor of host values
    written before every replay; ``extras`` are more inputs (tensors, or
    None where a key has none) copied into static buffers; ``outputs`` is
    a dict of tensors. ``fn`` must read nothing back to the host and may
    not write its inputs.

    ``graph`` makes a graph and ``capture(g, stream)`` is its capture
    context (a stand-in pair runs the capture and replay contract without
    a card). ``spans`` gets the graph's marks and the host spans of each
    call (on the CPU its marks do nothing)."""

    def __init__(self, fn: StepFn, device, n_scalars: int, spans: Spans,
                 graph: Callable = None, capture: Callable = None):
        self.fn = fn
        self.device = torch.device(device)
        self._graph = graph or (
            lambda: torch.cuda.CUDAGraph(keep_graph=True))
        self._capture = capture or (
            lambda g, stream: torch.cuda.graph(g, stream=stream))
        self.generator = torch.Generator(device=self.device)
        self.scalars = HostScalars(n_scalars, self.device)
        self.graphs: Dict[Hashable, _Captured] = {}
        self.spans = spans

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _capture_key(self, key: Hashable, state: Sequence[torch.Tensor],
                     scalars: Sequence[float],
                     extras: Sequence[Optional[torch.Tensor]],
                     generator: torch.Generator) -> _Captured:
        arena_in = Arena(state)
        state_in = arena_in.pack(state, self.device)
        views_in = arena_in.views(state_in)
        scalars_in = self.scalars.tensor(scalars)
        extras_in = [None if e is None else e.to(self.device, copy=True)
                     for e in extras]
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        times = {}
        # warm-up on the side stream, from a copy of the caller's generator
        t0 = time.perf_counter()
        warm = torch.Generator(device=self.device)
        warm.set_state(generator.get_state())
        if cuda:
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.fn(views_in, scalars_in, extras_in, warm)
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            self.fn(views_in, scalars_in, extras_in, warm)
        self._sync()
        times["warmup_s"] = time.perf_counter() - t0
        # capture; the outputs are copied into one arena a dtype, which the
        # graph's pool holds
        t0 = time.perf_counter()
        g = self._graph()
        if cuda:
            g.register_generator_state(self.generator)
        with self._capture(g, side):
            self.spans.begin("graph")
            new_state, outputs = self.fn(views_in, scalars_in, extras_in,
                                         self.generator)
            names = list(outputs)
            leaves = list(new_state) + [outputs[k] for k in names]
            out_arena = Arena(leaves)
            out_bufs = out_arena.pack(leaves, self.device)
            self.spans.end("graph")
        self._sync()
        times["capture_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        g.instantiate()
        self._sync()
        times["instantiate_s"] = time.perf_counter() - t0
        for (dt, _, shape, _), t in zip(arena_in.slots, new_state):
            if (t.dtype, tuple(t.shape)) != (dt, shape):
                raise ValueError(f"the step returned a state leaf "
                                 f"{t.dtype}{tuple(t.shape)} for "
                                 f"{dt}{shape}")
        got = _Captured(g, arena_in, state_in, scalars_in, extras_in,
                        out_arena, out_bufs, len(new_state), names, times)
        self.graphs[key] = got
        return got

    def __call__(self, key: Hashable, state: Sequence[torch.Tensor],
                 scalars: Sequence[float],
                 extras: Sequence[Optional[torch.Tensor]],
                 generator: torch.Generator
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """One call of ``fn`` as a replay of ``key``'s graph, captured on
        the key's first call: (new state, outputs), views of fresh clones
        of the output arenas. ``generator`` advances as ``fn`` would
        advance it."""
        got = self.graphs.get(key)
        if got is None:
            got = self._capture_key(key, state, scalars, extras, generator)
        else:
            with self.spans.host("copy_in"):
                got.arena_in.copy_in(got.state_in, state)
                for static, e in zip(got.extras_in, extras):
                    if (static is None) != (e is None):
                        raise ValueError(f"graph {key!r} was captured with "
                                         f"other extras")
                    if e is not None:
                        static.copy_(e)
            with self.spans.host("scalars_write"):
                self.scalars.write(scalars, got.scalars_in)
        self.generator.set_state(generator.get_state())
        with self.spans.host("launch"):
            got.graph.replay()
        generator.set_state(self.generator.get_state())
        bufs = {dt: b.clone() for dt, b in got.out_bufs.items()}
        views = got.out_arena.views(bufs)
        return (views[:got.n_state],
                dict(zip(got.names, views[got.n_state:])))
