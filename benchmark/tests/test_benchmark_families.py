"""The yardstick for every comm family the reference computes (IA2C, FP,
NeurComm, CommNet, DIAL): the reference takes each from a configuration's
``agent`` and refuses IA2C_CU; the seeded weights pass through the bridge
to the program's parameter tree and back by name, with the program's own
shapes; the two cells' weights and model FLOPs are what they were before
the other families entered (frozen); each comm type's FLOPs are its hand
count."""

import math

import pytest
import torch

from benchmark import program, roofline, spec
from benchmark.reference import COMM, build_reference
from benchmark.tests.helpers import GRID, tiny
from benchmark.traffic import train

CACC = "cacc_catchup_ma2c_nc.train_b64"
FAMILIES = ["ia2c", "ia2c_fp", "ma2c_nc", "ma2c_cnet", "ma2c_dial"]


@pytest.mark.parametrize("agent", FAMILIES)
def test_weights_pass_the_bridge_by_name_in_the_programs_shapes(agent):
    cell = tiny(f"{GRID}:{agent}", num_envs=2)
    w = train.make_weights(cell, 11, "cpu")
    back = program.named(program.to_program(w))
    assert list(back) == list(w)
    assert all(back[k] is w[k] for k in w)
    _, fns = program.build(cell.config, 2, "cpu")
    ts = fns.init_state(11)
    own = program.named(ts.params)
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in w.items()}
    assert list(program.named(ts.params, ts.opt_state.ms)) == list(w)


def test_named_refuses_a_leaf_it_cannot_name():
    w = train.make_weights(tiny(GRID), 11, "cpu")
    params = program.to_program(w)._replace(w_nobs=torch.zeros(1))
    with pytest.raises(ValueError, match="w_nobs"):
        program.named(params)
    with pytest.raises(ValueError, match="more leaves"):
        program.named(params._replace(w_nobs=None),
                      list(w.values()) + [torch.zeros(1)])


@pytest.mark.parametrize("agent,comm", [
    ("ia2c_fp", "fp"), ("ma2c_cnet", "commnet"), ("ma2c_dial", "dial")])
def test_reference_takes_the_family_from_agent(agent, comm):
    cell = tiny(f"{GRID}:{agent}")
    _, policy = build_reference(cell.config, "cpu")
    assert policy.comm == COMM[agent] == comm


def test_reference_refuses_the_consensus_family():
    cell = tiny(f"{GRID}:ia2c_cu")
    with pytest.raises(ValueError, match="consensus"):
        build_reference(cell.config, "cpu")
    with pytest.raises(ValueError, match="consensus"):
        train.make_weights(cell, 11, "cpu")


# (sum, sum of squares) of each weight leaf at seed 3,000,000,017 on the
# CPU, exactly rounded (math.fsum), as the harness drew them before the
# FP, CommNet and DIAL families entered
FROZEN_WEIGHTS = {
    GRID: {
        "w_obs.w": (-21.95753884895248, 603.0319831071956),
        "lstm.wx": (-31.433373861767848, 1601.4797888907576),
        "lstm.wh": (5.064378499950679, 1601.2318337551246),
        "actor.w": (0.11342896234398836, 0.012294890287077701),
        "critic.w": (-5.34413604133988, 24.287848297690083),
        "w_fp": (-2.9729387691070315, 251.92071673400312),
        "w_msg": (-5.0286238819735445, 3201.497395493683)},
    CACC: {
        "w_obs.w": (-2.1032616615630104, 62.89257021023309),
        "lstm.wx": (-21.87676476823242, 514.8470614643018),
        "lstm.wh": (-4.518178717325071, 509.42124744368857),
        "actor.w": (0.07302408842360819, 0.003369311182725556),
        "critic.w": (2.129063223626872, 8.26156248829871),
        "w_fp": (0.025933044536941452, 62.409044279914674),
        "w_msg": (-6.955202584461631, 1030.673376841595)}}
# update_model_flops at each cell's shapes, as before
FROZEN_FLOPS = {GRID: 666104954880.0, CACC: 15141437440.0}


@pytest.mark.parametrize("name", [GRID, CACC])
def test_the_cells_weights_and_flops_are_frozen(name):
    cell = spec.load_cell(name)
    w = train.make_weights(cell, 3_000_000_017, "cpu")
    sums = {k: (math.fsum(v.double().flatten().tolist()),
                math.fsum((v.double() ** 2).flatten().tolist()))
            for k, v in w.items() if not k.endswith(".b")}
    assert sums == FROZEN_WEIGHTS[name]
    assert all(not v.any() for k, v in w.items() if k.endswith(".b"))
    s = train.shapes(cell)
    assert roofline.update_model_flops(
        s["B"], s["T"], s["n_s"], s["n_a"], s["F"], s["H"], s["degrees"],
        s["comm"]) == FROZEN_FLOPS[name]


# B = 2, T = 1, n_s = 3, n_a = 2, F = 4, H = 5, two agents of degrees 1 and
# 2. An agent-step without comm: 2*3*4 + 2*(4+5)*4*5 + 2*5*2 + 2*5 = 414;
# the update: B x (sum over agents) x (3T + 1) = 2 x 4 x (sum).
@pytest.mark.parametrize("comm,per_agent_comm", [
    ("none", 0),
    ("fp", (2 * 1 * 2 * 4) + (2 * 2 * 2 * 4)),              # 2 deg n_a F
    ("neurcomm", 48 + (2 * 1 * 5 * 4) + (2 * 2 * 5 * 4)),   # + 2 deg H F
    ("commnet", (2 * 5 * 4 + 1 * 5) + (2 * 5 * 4 + 2 * 5)),  # 2 H F + deg H
    ("dial", (2 * 5 * 4 + 2 * 1 * 4 * 4)                    # 2 H F
     + (2 * 5 * 4 + 2 * 2 * 4 * 4))])                       # + 2 deg F F
def test_update_model_flops_by_hand(comm, per_agent_comm):
    got = roofline.update_model_flops(2, 1, 3, 2, 4, 5, [1.0, 2.0], comm)
    assert got == 2 * 4 * (2 * 414 + per_agent_comm)
