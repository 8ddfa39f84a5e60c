"""What the benchmark's tests share: cells cut to a tiny size, which the
runners run on the CPU with the program's plain twins, and the marker of
the tests that need a card (decided when a test is set up)."""

import copy

import pytest

from benchmark import spec

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


def tiny(name: str, **params):
    """The cell ``name`` with 16-wide layers, T = 8 and ``params``."""
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config["model"].update(num_fc=16, num_lstm=16, batch_size=8)
    cell.params.update(params)
    return cell


def short_episodes(cell, steps: int):
    """``cell`` with episodes of ``steps`` control steps on both sides, so
    that a tiny check passes an episode's end."""
    env = cell.config["env"]
    if "episode_length_sec" in env:
        env["episode_length_sec"] = steps * int(env["control_interval_sec"])
    else:
        env["episode_length"] = steps
    return cell
