"""The share of each traced update's ``graph`` span (its first mark's
start to its last mark's end, ``benchmark/marks.py``) in which no kernel,
copy or set other than a mark ran on the card, the median over the traced
updates. Marks count as idle and the gaps between graphs are left out:
against ``device_idle_pct``, it says whether the card waits inside the
graph or between graphs."""

import statistics

from benchmark.marks import MARK, updates


def read(obs):
    evs = obs.get("trace")
    graphs = [(u[0].start_ns, u[-1].end_ns) for u in updates(evs or [])
              if u[0].span == "graph"]
    if not graphs:
        return None
    work = sorted((e.start_ns, e.start_ns + e.dur_ns) for e in evs
                  if e.device and not MARK.search(e.name))
    shares = []
    for a, b in graphs:
        busy, cur = 0, a
        for s, e in work:
            if s >= b:
                break
            s, e = max(s, cur), min(e, b)
            if e > s:
                busy += e - s
                cur = e
        shares.append(100.0 * (1.0 - busy / (b - a)))
    return statistics.median(shares)
