"""What the benchmark's tests share: cells cut to a tiny size, which the
runners run on the CPU with the program's plain twins, and the marker of
the tests that need a card (decided when a test is set up)."""

import copy

import pytest

from benchmark import spec

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


GRID = "grid25_ma2c_nc.train_b768"
# the grid cell's files with ``agent`` swapped to the comm families that
# have no cell: FP, CommNet, DIAL
FAMILY_CASES = [f"{GRID}:{a}" for a in ("ia2c_fp", "ma2c_cnet", "ma2c_dial")]


def tiny(name: str, **params):
    """The cell ``name`` (or, for ``<cell>:<agent>``, that cell's files with
    ``agent`` swapped) with 16-wide layers, T = 8 and ``params``."""
    name, _, agent = name.partition(":")
    cell = copy.deepcopy(spec.load_cell(name))
    if agent:
        cell.config["agent"] = agent
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
