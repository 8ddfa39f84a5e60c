"""The share of the traced stretch of updates, from its first launch on the
host to its final synchronise, in which no kernel, copy or set ran on the
card."""

from benchmark.trace import summary


def read(obs):
    if not obs.get("trace") or not obs.get("trace_updates"):
        return None
    s = summary(obs["trace"])
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s else None
