"""Spans inside the port's update, on the card's clock and on the host's.

A CUDA graph replays an update with nothing running in Python, so the
boundaries inside it are device work captured into the graph. A **mark** is
a one-thread kernel (``ops/csrc/spans.cu``) that reads the card's
``%globaltimer`` and writes it into a ring of stamps on the card, at row
``slot % ROWS`` and the mark's column; ``slot`` is a counter on the card
that the update's last mark advances. Each mark's kernel is named after its
span and edge (``span_env_begin``, ``span_env_end``), so a profiler's trace
of the card can be read by name. Marks are always captured; on the CPU a
mark does nothing.

The layout of one update (``Layout``; parents in brackets):

- ``graph`` (none): the first and last nodes of a replay, around the update
  and the pack of its outputs; only where ``jit`` captures a graph.
- ``update`` (``graph``): the update body, ``rollout.py`` ``_update``.
- ``rollout`` (``update``): the params masked (and cast) for the window,
  then the T steps.
- ``step`` (``rollout``): one rollout step, marked on the sampled steps
  only (``sampled_steps``: every 8th from the 4th). It holds ``policy``
  (from ``step``'s begin to ``env``'s begin: the noise, the forward and the
  Gumbel-max sampling) and ``env`` (the env's step, auto-reset included);
  the bookkeeping is ``step``'s self time. Every step of a window runs the
  same kernels, so a sampled step stands for any other: the readings scale
  the samples' sum by T over their number. The marks lie outside the
  ``remat`` checkpoint, so its recompute does not run them again.
- ``comm`` (``policy``): the policy's input embedding with its comm term
  (``models/policies.py`` ``_embed``: NeurComm's and DIAL's kernels, or the
  family's einsums), on the sampled steps. Its marks lie inside the
  forward, so under ``remat`` the rollout enters them for the forward alone
  and not for the checkpoint's recompute.
- ``returns`` (``update``): the bootstrap value, the returns, the loss
  terms (on the replay path the policy's second pass) and the metrics.
- ``backward`` (``update``): ``torch.autograd.grad``.
- ``allreduce`` (``update``): the all-reduce of the gradients and metrics,
  only under data parallelism.
- ``optimizer`` (``update``): the gradient norm, RMSProp, the params' write
  and the consensus.

``train_step``'s host spans (``HOST_SPANS``: ``train_step``, ``schedule``,
``copy_in``, ``scalars_write``, which holds the wait for the previous
update's copy, and ``launch``, the graph's replay or the eager body) write
their ``perf_counter_ns`` begin and end into a host ring at the slot of the
update they issued; while a profiler runs each is also a
``torch.profiler.record_function`` range, so a trace shows them above the
marks.

``Spans.read(n)`` reads the last n updates in one copy from the card, and
puts the card's stamps on the host's clock (``Clock``) by an offset
bracketed between two host clock reads around a clock mark and a
synchronise (the tightest of ``CLOCK_BRACKETS``), measured when the ring is
made and again at each read (the two clocks drift apart by microseconds a
second, so a gap long before the read is placed less well). ``Spans.means(n)``,
the Trainer's, reads the durations alone: the one copy, no clock.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler

ROWS = 256                   # updates the rings hold
SAMPLE_FROM, SAMPLE_EVERY = 4, 8
CLOCK_BRACKETS = 5
HOST_SPANS = ("train_step", "schedule", "copy_in", "scalars_write", "launch")
# every device span and its parent; ``policy`` has no marks of its own
PARENT = {"graph": None, "update": "graph", "rollout": "update",
          "step": "rollout", "policy": "step", "comm": "policy",
          "env": "step", "returns": "update", "backward": "update",
          "allreduce": "update", "optimizer": "update"}
SAMPLED = ("step", "policy", "comm", "env")

Mark = Tuple[str, str, Optional[int]]    # (span, "begin" or "end", sample)


def sampled_steps(T: int) -> List[int]:
    """The rollout steps whose ``step``, ``comm`` and ``env`` spans are
    marked: every
    ``SAMPLE_EVERY``-th from ``SAMPLE_FROM`` (at T = 120 the 15 steps 4, 12,
    ..., 116, never the window's first or last), and at least one."""
    return list(range(SAMPLE_FROM, T, SAMPLE_EVERY)) or [T // 2]


class Layout:
    """The marks of one update, in the order they run: mark i stamps
    column i of its update's row. ``graph``: the update is a graph's
    replay; ``allreduce``: it averages over data-parallel ranks."""

    def __init__(self, T: int, graph: bool, allreduce: bool):
        self.T = T
        self.samples = sampled_steps(T)
        self.sample_of = {t: k for k, t in enumerate(self.samples)}
        self.outer = "graph" if graph else "update"
        pair = lambda span: [(span, "begin", None), (span, "end", None)]
        marks: List[Mark] = [("update", "begin", None),
                             ("rollout", "begin", None)]
        for k in range(len(self.samples)):
            marks += [("step", "begin", k), ("comm", "begin", k),
                      ("comm", "end", k), ("env", "begin", k),
                      ("env", "end", k), ("step", "end", k)]
        marks += [("rollout", "end", None)] + pair("returns") \
            + pair("backward") + (pair("allreduce") if allreduce else []) \
            + pair("optimizer") + [("update", "end", None)]
        if graph:
            marks = [("graph", "begin", None)] + marks \
                + [("graph", "end", None)]
        self.marks = marks
        self.column = {m: i for i, m in enumerate(marks)}
        present = {span for span, _, _ in marks}
        self.spans = [s for s in PARENT
                      if s in present or (s == "policy" and "step" in present)]
        # each span's (begin, end) column pairs, grouped by span: one pair,
        # or one a sample; ``policy`` runs from a step's begin to its env's
        begin, end, self._first, scale = [], [], [], []
        n = len(self.samples)
        for s in self.spans:
            self._first.append(len(begin))
            if s in SAMPLED:
                first = "step" if s == "policy" else s
                last = ("env", "begin") if s == "policy" else (s, "end")
                begin += [self.column[(first, "begin", k)] for k in range(n)]
                end += [self.column[last + (k,)] for k in range(n)]
                scale.append(T / n)
            else:
                begin.append(self.column[(s, "begin", None)])
                end.append(self.column[(s, "end", None)])
                scale.append(1.0)
        self._begin, self._end = np.array(begin), np.array(end)
        self._scale = np.array(scale)
        # children[c, p]: span c's parent is span p
        self._children = np.zeros((len(self.spans),) * 2)
        for c, span in enumerate(self.spans):
            p = self.parent(span)
            if p is not None:
                self._children[c, self.spans.index(p)] = 1.0

    def kernel(self, col: int) -> str:
        span, edge, _ = self.marks[col]
        return f"span_{span}_{edge}"

    def parent(self, span: str) -> Optional[str]:
        p = PARENT[span]
        return p if p in self.spans else None

    def durations_ns(self, rows: np.ndarray) -> np.ndarray:
        """Each span's nanoseconds (columns in ``spans``' order) in each of
        ``rows`` [n, marks] of stamps; a sampled span is its samples' sum
        scaled by T over their number."""
        pairs = (rows[:, self._end] - rows[:, self._begin]).astype(np.float64)
        return np.add.reduceat(pairs, self._first, axis=1) * self._scale

    def self_times(self, dur: np.ndarray) -> np.ndarray:
        """Each span's duration less its children's, from
        ``durations_ns``."""
        return dur - dur @ self._children


class Clock(NamedTuple):
    """Host ns = card ns + ``offset_ns``, to within ``uncertainty_ns``."""

    offset_ns: float
    uncertainty_ns: float

    def host_ns(self, card_ns: int) -> float:
        return card_ns + self.offset_ns


def clock_offset(brackets: Sequence[Tuple[int, int]],
                 stamps: Sequence[int]) -> Clock:
    """The offset from the tightest bracket: the card stamped ``stamps[i]``
    between the host's reads ``brackets[i]``."""
    (a, b), d = min(zip(brackets, stamps), key=lambda x: x[0][1] - x[0][0])
    return Clock((a + b) / 2 - int(d), (b - a) / 2)


def host_span_at(rows: Sequence[np.ndarray], t: float) -> str:
    """The innermost host span of ``rows`` (each [span, begin/end] ns: the
    spans of one ``train_step``) under way at host time ``t``, else
    "python": the host was outside ``train_step``."""
    name, width = "python", None
    for row in rows:
        for span, (b, e) in zip(HOST_SPANS, row):
            if e > 0 and b <= t <= e and (width is None or e - b < width):
                name, width = span, e - b
    return name


def read_rows(layout: Layout, stamps: np.ndarray, host: Optional[np.ndarray],
              done: int, n: int, clock: Optional[Clock]) -> List[Dict]:
    """The readings of the last ``n`` of the ``done`` updates the rings
    hold: ``stamps`` [ROWS, marks] card ns, ``host`` [ROWS, HOST_SPANS, 2]
    host ns (None where the host's slots do not match the card's). For
    each update: ``spans`` (each device span's ``ms``, ``self_ms`` and
    whether it is ``sampled``) and ``host`` (each host span's ms); with a
    ``clock``, also ``gap_ms`` (since the previous update's end on the
    card, where the ring still holds it), ``gap_during`` (the host span
    under way when the gap ended: of the ``train_step`` that issued this
    update or of the next, which waits in ``scalars_write`` for this update
    to start) and the clock's ``clock_uncertainty_ms``."""
    rows = stamps.shape[0]
    end = layout.column[(layout.outer, "end", None)]
    begin = layout.column[(layout.outer, "begin", None)]
    slots = range(max(done - min(n, rows), 0), done)
    block = stamps[[s % rows for s in slots]]
    dur = layout.durations_ns(block) / 1e6
    own = layout.self_times(dur)
    out = []
    for i, s in enumerate(slots):
        rec = {"slot": s,
               "spans": {k: {"ms": float(dur[i, j]),
                             "self_ms": float(own[i, j]),
                             "sampled": k in SAMPLED}
                         for j, k in enumerate(layout.spans)},
               "host": None}
        if host is not None:
            rec["host"] = {k: (e - b) / 1e6
                           for k, (b, e) in zip(HOST_SPANS, host[s % rows])
                           if e > 0}
        out.append(rec)
        if clock is None:
            continue
        rec.update(gap_ms=None, gap_during=None,
                   clock_uncertainty_ms=clock.uncertainty_ns / 1e6)
        if s >= 1 and s - 1 >= done - rows:
            t0 = int(block[i, begin])
            rec["gap_ms"] = (t0 - int(stamps[(s - 1) % rows, end])) / 1e6
            if host is not None:
                calls = [host[i % rows] for i in (s, s + 1) if i < done]
                rec["gap_during"] = host_span_at(calls, clock.host_ns(t0))
    return out


def mean_ms(readings: List[Dict]) -> Dict[str, float]:
    """Each device and host span's mean ms over ``readings``."""
    sums: Dict[str, List[float]] = {}
    for r in readings:
        for k, v in r["spans"].items():
            sums.setdefault(k, []).append(v["ms"])
        for k, v in (r["host"] or {}).items():
            sums.setdefault(k, []).append(v)
    return {k: sum(v) / len(v) for k, v in sums.items()}


class _HostSpan:
    """One host span of ``train_step``: ``perf_counter_ns`` at its begin and
    end into its row of the update being issued; while a profiler runs,
    also a ``record_function`` range (one boolean's check otherwise)."""

    __slots__ = ("name", "row", "_range", "_t0")

    def __init__(self, name: str, row: np.ndarray):
        self.name, self.row, self._range, self._t0 = name, row, None, 0

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.row[0], self.row[1] = self._t0, time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.span_mark.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.span_mark.restype = ctypes.c_int
    lib.span_clock_mark.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.span_clock_mark.restype = ctypes.c_int
    return lib


class Spans:
    """The marks of one ``make_a2c``'s updates and its host spans, and their
    reader. On a card the ring, its slot counter and the clock's cells are
    one int64 tensor allocated here, before any capture and outside every
    graph's pool, for the life of this object. ``launch(kernel, column,
    advance)`` launches a mark (on a card the kernel, on the current
    stream; a stand-in records); on the CPU there is none, and ``read``
    finds nothing. ``clock`` is the latest offset of the card's clock,
    measured here and at each ``read``."""

    def __init__(self, T: int, device, graph: bool, allreduce: bool):
        self.layout = Layout(T, graph, allreduce)
        self.device = torch.device(device)
        self.launch: Optional[Callable[[str, int, bool], None]] = None
        self.ring: Optional[torch.Tensor] = None
        self.host_ring = np.zeros((ROWS, len(HOST_SPANS), 2), np.int64)
        self._now = np.zeros((len(HOST_SPANS), 2), np.int64)
        self._host = {k: _HostSpan(k, self._now[i])
                      for i, k in enumerate(HOST_SPANS)}
        self.slot = 0               # train_step calls committed
        self.clock = Clock(0.0, 0.0)
        if self.device.type == "cuda":
            from deeprl_network_tpu_torch.ops import _build
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._lib = _bind(_build.load("spans"))
            cols = len(self.layout.marks)
            self.ring = torch.zeros(ROWS * cols + 1 + CLOCK_BRACKETS,
                                    dtype=torch.int64, device=self.device)
            self._slot_at = ROWS * cols
            self.launch = self._launch
            brackets = self._brackets()
            self.clock = clock_offset(
                brackets, self.ring[-CLOCK_BRACKETS:].cpu().tolist())

    # ---- the card ----

    def _stream(self) -> int:
        return torch._C._cuda_getCurrentRawStream(self.device.index)

    def _launch(self, kernel: str, col: int, advance: bool) -> None:
        ptr, item = self.ring.data_ptr(), self.ring.element_size()
        with torch.cuda.device(self.device):
            err = self._lib.span_mark(
                kernel.encode(), ptr, ptr + self._slot_at * item, col,
                len(self.layout.marks), ROWS, int(advance), self._stream())
        if err != 0:
            raise RuntimeError(f"{kernel} launch failed: cudaError {err}")

    def _brackets(self) -> List[Tuple[int, int]]:
        """Host clock reads around each of ``CLOCK_BRACKETS`` clock marks
        and a synchronise; the marks write the ring's last cells."""
        first = self.ring.data_ptr() + (self.ring.numel() - CLOCK_BRACKETS) \
            * self.ring.element_size()
        out = []
        with torch.cuda.device(self.device):
            for k in range(CLOCK_BRACKETS):
                a = time.perf_counter_ns()
                err = self._lib.span_clock_mark(
                    first + k * self.ring.element_size(), self._stream())
                torch.cuda.synchronize(self.device)
                out.append((a, time.perf_counter_ns()))
                if err != 0:
                    raise RuntimeError(f"span_clock launch failed: "
                                       f"cudaError {err}")
        return out

    def _mark(self, span: str, edge: str, t: Optional[int]) -> None:
        if self.launch is None:
            return
        k = None
        if t is not None:
            k = self.layout.sample_of.get(t)
            if k is None:
                return
        col = self.layout.column[(span, edge, k)]
        self.launch(self.layout.kernel(col), col,
                    col == len(self.layout.marks) - 1)

    def begin(self, span: str, t: Optional[int] = None) -> None:
        """Mark ``span``'s begin; ``t``, the rollout step of a ``step``,
        ``comm`` or ``env`` span, marks only where it is sampled."""
        self._mark(span, "begin", t)

    def end(self, span: str, t: Optional[int] = None) -> None:
        self._mark(span, "end", t)

    # ---- the host ----

    def host(self, name: str) -> _HostSpan:
        """The host span ``name`` of the ``train_step`` under way, a
        context manager."""
        return self._host[name]

    def commit(self) -> None:
        """The host spans of the ``train_step`` that just ended go to the
        host ring at its update's slot."""
        self.host_ring[self.slot % ROWS] = self._now
        self._now[:] = 0
        self.slot += 1

    # ---- reading ----

    def _rows(self, got: np.ndarray, n: int,
              clock: Optional[Clock]) -> List[Dict]:
        cols = len(self.layout.marks)
        done = int(got[self._slot_at])
        host = self.host_ring if self.slot == done else None
        return read_rows(self.layout, got[:ROWS * cols].reshape(ROWS, cols),
                         host, done, n, clock)

    def read(self, n: int) -> List[Dict]:
        """The last ``n`` updates (at most ``ROWS``; see ``read_rows``):
        one copy from the card after the clock's brackets. Where the card
        has run other updates than ``train_step`` issued (the eager body
        called directly), the host spans are left out."""
        if self.ring is None:
            return []
        brackets = self._brackets()
        got = self.ring.cpu().numpy()
        self.clock = clock_offset(brackets, got[-CLOCK_BRACKETS:])
        return self._rows(got, n, self.clock)

    def means(self, n: int) -> Dict[str, float]:
        """Each span's mean ms over the last ``n`` updates: one copy from
        the card, no clock and no gaps."""
        if self.ring is None:
            return {}
        return mean_ms(self._rows(self.ring.cpu().numpy(), n, None))
