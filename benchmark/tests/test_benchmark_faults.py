"""The harness, driven with the timed path broken underneath (and the look
for a card skipped, on the CPU at a tiny size), finds ``correct`` false:
a step that hands its state back unchanged, half of the batch left out of
the loss, an action altered where it is sampled, the carry or the
observation left unreset where an episode ends; and, under each comm
family that has no cell, a fault of its own mechanism. The cells' own
limits judge."""

import time

import pytest

from benchmark import faults, judge, spec
from benchmark.tests.helpers import GRID, short_episodes, tiny

TRAIN_CELLS = ["grid25_ma2c_nc.train_b768", "cacc_catchup_ma2c_nc.train_b64"]


def _run(cell, fault, seed=3_000_000_019, **kw):
    with faults.FAULTS[fault]():
        return spec.traffic_runner(cell.kind).run(
            cell, seed, 0.1, False, time.perf_counter(), "cpu", **kw)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_faults_fail(name, fault):
    cell = tiny(name, num_envs=16)
    cell.config["assumed"]["compute_dtype"] = "float32"
    out = _run(cell, fault)
    assert not judge.verdict(out["numbers"], cell.limits), out["numbers"]


@pytest.mark.parametrize("fault", ["carry_kept", "stale_obs"])
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_episode_end_faults_fail(name, fault):
    """Faults that show only where an episode ends: the check, passing one,
    fails them."""
    cell = short_episodes(tiny(name, num_envs=16, check_updates=3), 12)
    cell.config["assumed"]["compute_dtype"] = "float32"
    out = _run(cell, fault)
    assert not judge.verdict(out["numbers"], cell.limits), out["numbers"]


@pytest.mark.parametrize("name,fault", [
    (f"{GRID}:ia2c_fp", "fp_zeroed"), (f"{GRID}:ma2c_cnet", "commnet_sum"),
    (f"{GRID}:ma2c_dial", "dial_no_bias")])
def test_comm_family_faults_fail(name, fault):
    """A fault of each comm family's own mechanism fails the check: the
    comparison sees the fingerprints, CommNet's mean, DIAL's message
    bias."""
    cell = tiny(name, num_envs=16)
    cell.config["assumed"]["compute_dtype"] = "float32"
    out = _run(cell, fault)
    assert not judge.verdict(out["numbers"], cell.limits), out["numbers"]
