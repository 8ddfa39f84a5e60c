"""A dry run of each cell, and of the grid's files under each comm family
that has no cell (FP, CommNet, DIAL), on the CPU at a tiny size: the
traffic runner's set-up, window and check with the program's plain twins,
and the result line it makes; and the reference against the port in
float32, where they agree to rounding."""

import time

import pytest
import torch

from benchmark import run as bench_run, spec
from benchmark.tests.helpers import FAMILY_CASES, GRID, short_episodes, tiny
from benchmark.traffic import train

TRAIN_CELLS = [GRID, "cacc_catchup_ma2c_nc.train_b64"]


def _f32(cell):
    cell.config["assumed"]["compute_dtype"] = "float32"
    return cell


@pytest.mark.parametrize("name", TRAIN_CELLS + FAMILY_CASES)
def test_train_cell_dry_run(name):
    cell = _f32(tiny(name, num_envs=4))
    out = spec.traffic_runner(cell.kind).run(cell, 3_000_000_017, 0.2, False,
                                             time.perf_counter(), "cpu")
    assert out["attempted"] % 5 == 0 and out["attempted"] >= 5
    assert out["failed"] == 0
    # float32 on both sides: the port's twins and the reference agree to
    # rounding
    assert max(out["numbers"].values()) < 1e-5, out["numbers"]
    result = bench_run.assemble(cell, out, False, "cpu")
    assert result["correct"] is True
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("name", TRAIN_CELLS + FAMILY_CASES)
def test_check_passes_an_episode_end(name):
    """Episodes of 12 steps, three updates of 8: the auto-reset, the carry
    masked and the fingerprints reset at the episode's end agree between
    the port's twins and the reference."""
    cell = short_episodes(_f32(tiny(name, num_envs=4, check_updates=3)), 12)
    out = spec.traffic_runner(cell.kind).run(cell, 3_000_000_023, 0.1, False,
                                             time.perf_counter(), "cpu")
    assert max(out["numbers"].values()) < 1e-5, out["numbers"]


@pytest.mark.parametrize("name", [GRID] + FAMILY_CASES)
def test_bf16_grid_reads_its_rounding(name):
    """The grid as configured (bf16 compute on the twins) parts from the
    float32 reference by bf16's rounding, far above float32's."""
    cell = tiny(name, num_envs=4)
    out = spec.traffic_runner(cell.kind).run(cell, 7, 0.1, False,
                                             time.perf_counter(), "cpu")
    assert 1e-5 < max(out["numbers"].values()) < 0.1, out["numbers"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_reference_in_blocks_of_rows(name):
    """The reference over its batch in blocks of rows (``reference_block``)
    follows the same updates as over the whole batch at once."""
    cell = short_episodes(tiny(name, num_envs=6), 12)
    p0 = train.make_weights(cell, 9, "cpu")
    whole = train.follow(cell, 9, p0, 6, 2, "cpu")
    cell.params["reference_block"] = 4
    blocks = train.follow(cell, 9, p0, 6, 2, "cpu")
    for a, b in zip(whole, blocks):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(a["loss"])
        for k in a["params"]:
            torch.testing.assert_close(b["params"][k], a["params"][k],
                                       rtol=1e-5, atol=1e-7)
