"""Milliseconds an update on the card of the policy's input embedding with
its comm term: the program's ``comm`` span (``span_comm_begin`` to
``span_comm_end``, marked around ``_embed`` on the sampled rollout steps),
summed and scaled by T over the samples (``benchmark/marks.py``), the
median over the traced updates. A program without the span reads
nothing."""

from benchmark.marks import median_over_updates, sampled_ms


def read(obs):
    shp = obs.get("shapes")
    if not shp:
        return None
    return median_over_updates(obs.get("trace"),
                               lambda u: sampled_ms(u, "comm", shp["T"]))
