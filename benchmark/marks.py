"""The program's span marks in a device trace: one-thread kernels named
``span_<span>_begin`` and ``span_<span>_end`` that the port captures into
each update's CUDA graph (a graph's first and last nodes are
``span_graph_begin`` and ``span_graph_end``). They are found by name alone;
a trace without them (a program that has no marks) reads as no update.

A span runs from its begin mark's start to its end mark's start, as the
program's own ring stamps them. The ``step`` and ``env`` spans are marked
on a sample of the rollout's steps: a reading sums the samples and scales
them by T over their number, found in the trace.
"""

from __future__ import annotations

import re
import statistics
from typing import Callable, List, NamedTuple, Optional

from benchmark.trace import Event

MARK = re.compile(r"(?<!\w)span_([a-z]+)_(begin|end)(?!\w)")


class Mark(NamedTuple):
    span: str
    edge: str
    start_ns: int
    end_ns: int


def updates(evs: List[Event]) -> List[List[Mark]]:
    """Each whole update's marks in time order, from its outermost span's
    begin (``graph``, or ``update`` where no graph runs) to its end."""
    marks = sorted((Mark(m.group(1), m.group(2), e.start_ns,
                         e.start_ns + e.dur_ns)
                    for e in evs if e.device
                    for m in [MARK.search(e.name)] if m),
                   key=lambda m: m.start_ns)
    outer = "graph" if any(m.span == "graph" for m in marks) else "update"
    out, cur = [], None
    for m in marks:
        if m.span == outer and m.edge == "begin":
            cur = [m]
        elif cur is not None:
            cur.append(m)
            if m.span == outer and m.edge == "end":
                out.append(cur)
                cur = None
    return out


def _starts(update: List[Mark], span: str, edge: str) -> List[int]:
    return [m.start_ns for m in update if m.span == span and m.edge == edge]


def span_ms(update: List[Mark], span: str) -> Optional[float]:
    """``span``'s ms in one update (its samples summed where it has
    several), or None where the update has no such marks."""
    b, e = _starts(update, span, "begin"), _starts(update, span, "end")
    if not b or len(b) != len(e):
        return None
    return sum(y - x for x, y in zip(b, e)) / 1e6


def sampled_ms(update: List[Mark], span: str, T: int) -> Optional[float]:
    """A sampled span's ms an update: ``env`` (env begin to env end) or
    ``policy`` (step begin to env begin), summed over the samples and
    scaled by T over their number."""
    if span == "policy":
        b, e = _starts(update, "step", "begin"), _starts(update, "env", "begin")
    else:
        b, e = _starts(update, span, "begin"), _starts(update, span, "end")
    if not b or len(b) != len(e):
        return None
    return sum(y - x for x, y in zip(b, e)) / 1e6 * T / len(b)


def median_over_updates(evs: Optional[List[Event]],
                        of: Callable[[List[Mark]], Optional[float]]
                        ) -> Optional[float]:
    """The median of ``of(update)`` over the trace's whole updates, or None
    where none reads."""
    vals = [v for u in updates(evs or []) for v in [of(u)] if v is not None]
    return statistics.median(vals) if vals else None
