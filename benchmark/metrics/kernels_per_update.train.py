"""Kernels, copies and sets that ran on the card in the traced stretch,
per update."""


def read(obs):
    evs, n = obs.get("trace"), obs.get("trace_updates")
    if not evs or not n:
        return None
    return sum(1 for e in evs if e.device) / n
