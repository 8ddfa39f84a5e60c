"""The control of the correctness check: the reference put in the
program's place one precision below the configuration's (fp8 for the bf16
grid, TF32 for the f32 platoon) has to come out not correct,
while the program as configured comes out correct. On the card at each
cell's own size on three seeds (``benchmark/calibrate.py`` reads the same
numbers for ``PERF.md``); on the CPU at a tiny size, the control reads
above the sound program, in each cell and under each comm family that has
no cell."""

import pytest
import torch

from benchmark import judge, spec
from benchmark.tests.helpers import FAMILY_CASES, needs_cuda, tiny

CELLS = ["grid25_ma2c_nc.train_b768", "cacc_catchup_ma2c_nc.train_b64"]


def _rows(cell, seed, device):
    rows = spec.traffic_runner(cell.kind).calibration_rows
    return dict(rows(cell, seed, ["sound"], True, torch.device(device)))


@needs_cuda
@pytest.mark.parametrize("seed", [101, 202, 3_000_000_303])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, seed):
    cell = spec.load_cell(name)
    got = _rows(cell, seed, "cuda")
    assert judge.verdict(got["sound"], cell.limits), got["sound"]
    assert not judge.verdict(got["control"], cell.limits), got["control"]


@pytest.mark.parametrize("name", CELLS + FAMILY_CASES)
def test_control_reads_above_the_program_on_the_cpu(name):
    got = _rows(tiny(name, num_envs=16), 5, "cpu")
    assert max(got["control"].values()) > 3 * max(got["sound"].values())
