"""The device trace of a short stretch, and what the readers take from it.

``traced`` runs a block under ``torch.profiler`` (CUDA activity: the
kernels, copies and sets on the card and the CUDA runtime calls on the
host), with the card idle 0.2 s at both ends: the profiler drops device
records that its clock places outside its window. A trace leaves CUPTI set
up in its process and slows every later CUDA call there, so a run traces
last, after its timed window. ``events`` reads the profiler's raw events
(its event tree takes seconds to build for thousands of kernels).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, NamedTuple, Tuple

EDGE_S = 0.2


class Event(NamedTuple):
    device: bool     # a kernel, copy or set on the card; else a host call
    name: str
    start_ns: int
    dur_ns: int


@contextlib.contextmanager
def traced():
    """Yields the profiler; read it with ``events`` after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(EDGE_S)


def events(prof) -> List[Event]:
    from torch.autograd import DeviceType
    return [Event(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(),
                  e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _is_launch(name: str) -> bool:
    return ("Launch" in name or "Memcpy" in name or "Memset" in name) and (
        name.startswith("cuda") or name.startswith("cu"))


def summary(evs: List[Event], top: int = 10) -> Dict:
    """The stretch from its first launch on the host to the end of its
    last host call (the final synchronise): ``window_s``, ``busy_s`` (the
    union of device activity inside it), ``device_ops`` (device seconds by
    name, the ``top`` largest), ``idle_gaps`` (the gaps between device
    activity, summed by the host call under way when each ended, the
    ``top`` largest) and ``n_device`` (kernels, copies and sets)."""
    dev = sorted((e for e in evs if e.device), key=lambda e: e.start_ns)
    host = sorted((e for e in evs if not e.device), key=lambda e: e.start_ns)
    launches = [e for e in host if _is_launch(e.name)]
    if not dev or not launches:
        return {}
    start = launches[0].start_ns
    # the final synchronise ends just after the last device activity; a
    # host call after the closing idle edge is the profiler's own
    last = max(e.start_ns + e.dur_ns for e in dev)
    end = max(e.start_ns + e.dur_ns for e in host
              if e.start_ns <= last + EDGE_S * 5e8)
    busy, cur, gaps = 0, start, []
    for e in dev:
        a, b = max(e.start_ns, start), min(e.start_ns + e.dur_ns, end)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if end > cur:
        gaps.append((cur, end))
    by_op: Dict[str, float] = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.dur_ns / 1e9
    by_gap: Dict[str, float] = {}
    starts = [e.start_ns for e in host]
    for a, b in gaps:
        name = _host_at(host, starts, b)
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e9
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (end - start) / 1e9, "busy_s": busy / 1e9,
            "n_device": len(dev), "device_ops": [list(x) for x in order(by_op)],
            "idle_gaps": [list(x) for x in order(by_gap)]}


def _host_at(host: List[Event], starts: List[int], t: int) -> str:
    """The host call under way at ``t`` (the latest started before it, if
    it has not ended), else "python": the host was between CUDA calls."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and host[i].start_ns + host[i].dur_ns >= t:
        return host[i].name
    return "python"


def device_time(evs: List[Event], match) -> Tuple[int, float]:
    """(count, seconds) of device events whose name ``match`` accepts."""
    sel = [e for e in evs if e.device and match(e.name)]
    return len(sel), sum(e.dur_ns for e in sel) / 1e9


def launch_note(evs: List[Event]) -> str:
    """The host's seconds in each kind of launch call over the stretch
    (the median call, and the count), for standard error."""
    calls: Dict[str, List[float]] = {}
    for e in evs:
        if not e.device and _is_launch(e.name):
            calls.setdefault(e.name, []).append(e.dur_ns / 1e9)
    parts = [f"{k} x{len(v)} median {sorted(v)[len(v) // 2]!r} s"
             for k, v in sorted(calls.items())]
    return "host launch calls in the traced stretch: " + "; ".join(parts)
