"""Milliseconds an update on the card of the env's steps (auto-reset
included): the ``env`` spans of the sampled rollout steps, summed and
scaled by T over the samples (``benchmark/marks.py``), the median over the
traced updates. On the grid it holds ``network_env_kernel`` and its
wrapper's ops; on the platoon the env's PyTorch ops."""

from benchmark.marks import median_over_updates, sampled_ms


def read(obs):
    shp = obs.get("shapes")
    if not shp:
        return None
    return median_over_updates(obs.get("trace"),
                               lambda u: sampled_ms(u, "env", shp["T"]))
