"""Milliseconds on the card between the CUDA events the benchmark records
on the stream before consecutive ``train_step`` calls of the window: one
update's device time, idle gaps inside it included (the median)."""

import statistics


def read(obs):
    dev = obs.get("window", {}).get("device_s")
    return statistics.median(dev) * 1e3 if dev else None
