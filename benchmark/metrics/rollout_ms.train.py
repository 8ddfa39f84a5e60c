"""Milliseconds an update on the card of the ``rollout`` span (the params
masked and cast for the window, then its T steps), from the program's span
marks in the traced stretch (``benchmark/marks.py``): the median over the
traced updates."""

from benchmark.marks import median_over_updates, span_ms


def read(obs):
    return median_over_updates(obs.get("trace"),
                               lambda u: span_ms(u, "rollout"))
