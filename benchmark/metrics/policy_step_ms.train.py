"""Milliseconds an update on the card of the policy's rollout steps: from
each sampled step's begin to its env's begin (the noise, the forward and
the Gumbel-max sampling), summed and scaled by T over the samples
(``benchmark/marks.py``), the median over the traced updates."""

from benchmark.marks import median_over_updates, sampled_ms


def read(obs):
    shp = obs.get("shapes")
    if not shp:
        return None
    return median_over_updates(obs.get("trace"),
                               lambda u: sampled_ms(u, "policy", shp["T"]))
