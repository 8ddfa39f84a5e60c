"""The port's ``CheckpointManager`` (``torch.save`` of a plain tree): the
whole TrainState round-trips, so resume is EXACT: k updates, save, restore
into a fresh state, k more updates give params, optimizer state and metrics
bit-equal to 2k updates in one go (tolerance: none). Also the directory
bookkeeping, and ``restore_params`` with the JAX module's structural checks
and messages."""

import dataclasses
import os

import pytest
import torch

from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.rollout import make_a2c

ENVS = {
    "grid": (LargeGridEnv, dict(scenario="large_grid", coop_gamma=0.9,
                                episode_length_sec=60, init_density=0.2)),
    # initial noise on: every auto-reset draws from the state's generator
    "cacc": (CACCEnv, dict(scenario="cacc_slowdown", coop_gamma=0.9,
                           episode_length=12)),
    "monaco": (RealNetEnv, dict(scenario="real_net", coop_gamma=0.9,
                                episode_length_sec=60)),
}
F32 = dict(compute_dtype="float32")
BF16 = dict(compute_dtype="bfloat16", remat=True, sparse_comm=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fns(env_name="cacc", agent="ma2c_nc", **model_kw):
    cls, env_kw = ENVS[env_name]
    model_kw = dict(dict(batch_size=8, num_envs=4, num_fc=16, num_lstm=16),
                    **model_kw)
    return make_a2c(cls(EnvConfig(**env_kw), device="cpu"),
                    ModelConfig(**model_kw), TrainConfig(total_step=10_000),
                    agent=agent, device="cpu")


def _leaves(ts):
    """Every tensor of a TrainState, in a fixed order."""
    out = tree_leaves(ts.params) + list(ts.opt_state.ms)
    out += [t for t in ts.env_state] + [ts.obs, ts.fp, ts.carry.c,
                                        ts.carry.h, ts.prev_done, ts.ep_ret,
                                        ts.ep_len, ts.last_ep_ret,
                                        ts.last_ep_len,
                                        ts.generator.get_state()]
    return out


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    assert type(a.env_state) is type(b.env_state)
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("env_name,model_kw", [
    ("grid", F32), ("grid", BF16), ("cacc", F32), ("cacc", BF16),
    ("monaco", F32)],
    ids=["grid-f32", "grid-bf16-remat", "cacc-f32", "cacc-bf16-remat",
         "monaco-f32"])
def test_resume_is_exact(env_name, model_kw, tmp_path):
    """Two updates, save, restore into a state built from another seed, two
    more updates (the second pair crosses an episode end and its resets):
    bit-equal to four updates in one go."""
    fns, k = _fns(env_name, **model_kw), 2
    ts = fns.init_state(3)
    straight = []
    for _ in range(2 * k):
        ts, m = fns.train_step(ts)
        straight.append(m)
    ts_straight = ts

    ts = fns.init_state(3)
    for _ in range(k):
        ts, _ = fns.train_step(ts)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(ts.step, ts)
    assert ckpt.latest_step() == ts.step == k * fns.steps_per_update
    saved = ts
    ts = CheckpointManager(str(tmp_path)).restore(fns.init_state(99))
    _assert_states_equal(ts, saved)
    assert ts.generator is not saved.generator
    assert ts.carry.h.dtype == (torch.bfloat16 if model_kw is BF16
                                else torch.float32)
    resumed = []
    for _ in range(k):
        ts, m = fns.train_step(ts)
        resumed.append(m)
    _assert_states_equal(ts, ts_straight)
    for got, want in zip(resumed, straight[k:]):
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(torch.as_tensor(got[key]),
                               torch.as_tensor(want[key])), key
    assert float(m["episode_len"]) == 12.0


def test_directory_bookkeeping(tmp_path):
    """``max_to_keep`` prunes the oldest, ``latest_step`` reads the
    directory (another manager sees the same), a step saved twice is
    overwritten, no temporary file stays, nothing to restore gives None."""
    ckpt = CheckpointManager(str(tmp_path / "model"), max_to_keep=2)
    assert ckpt.latest_step() is None
    like = {"params": {"w": torch.zeros(3)}, "step": 0}
    assert ckpt.restore(like) is None
    assert ckpt.restore_params({"w": torch.zeros(3)}) is None
    for step in (10, 30, 20, 30):
        ckpt.save(step, {"params": {"w": torch.full((3,), float(step))},
                         "step": step})
    assert ckpt.all_steps() == [20, 30]
    assert sorted(os.listdir(ckpt.path)) == ["checkpoint_20.pt",
                                             "checkpoint_30.pt"]
    other = CheckpointManager(str(tmp_path / "model"))
    assert other.latest_step() == 30
    got = other.restore(like)
    assert got["step"] == 30 and torch.equal(got["params"]["w"],
                                             torch.full((3,), 30.0))
    assert other.restore(like, step=20)["step"] == 20
    # the file is a plain tree: it loads with weights_only
    raw = torch.load(os.path.join(ckpt.path, "checkpoint_20.pt"),
                     weights_only=True)
    assert raw["step"] == 20
    with pytest.raises(TypeError, match="cannot checkpoint"):
        ckpt.save(40, {"x": object()})
    assert ckpt.all_steps() == [20, 30]
    assert len(os.listdir(ckpt.path)) == 2


def test_restore_params_across_env_batch_and_structure_errors(tmp_path):
    """``restore_params`` reads a checkpoint whose env batch differs from
    the current one (as a data-parallel run's would), where the full
    ``restore`` refuses; and its three structural errors."""
    big = _fns(num_envs=4)
    ts, _ = big.train_step(big.init_state(0))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(ts.step, ts)
    small = _fns(num_envs=2)
    like = small.init_state(5)
    params = ckpt.restore_params(like.params)
    assert type(params) is type(ts.params)
    for a, b in zip(tree_leaves(params), tree_leaves(ts.params)):
        assert torch.equal(a, b)
    assert params.w_dial is None and params.w_nobs is None
    out = small.eval_episode(params, 0, 4)
    assert torch.isfinite(out["episode_return"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(like)

    # a leaf the model needs was stored None (IA2C has no comm weights)
    ia2c = _fns(agent="ia2c")
    other = CheckpointManager(str(tmp_path / "ia2c"))
    other.save(1, ia2c.init_state(0))
    with pytest.raises(ValueError, match="missing a leaf at 'params.w_fp'"):
        other.restore_params(like.params)
    # the other way round: what the template marks unused is dropped
    assert other.restore_params(ia2c.init_state(1).params).w_fp is None
    assert ckpt.restore_params(ia2c.init_state(1).params).w_fp is None

    # a field absent from the file: tolerated only where the template says
    # it is unused
    raw = torch.load(os.path.join(ckpt.path, f"checkpoint_{ts.step}.pt"),
                     weights_only=True)
    del raw["params"]["w_nobs"]
    torch.save(raw, os.path.join(ckpt.path, "checkpoint_7.pt"))
    assert ckpt.restore_params(like.params, step=7).w_nobs is None
    nobs = _fns(neighbor_obs=True).init_state(0).params
    with pytest.raises(ValueError,
                       match="missing field 'params.w_nobs' required"):
        ckpt.restore_params(nobs, step=7)

    wide = _fns(num_fc=32).init_state(0).params
    with pytest.raises(ValueError, match=r"param 'params.w_obs.w' has shape "
                       r"\(8, 4, 16\), model expects \(8, 4, 32\)"):
        ckpt.restore_params(wide)


def test_carry_dtype_and_generator_device_are_checked(tmp_path):
    bf16 = _fns(**BF16)
    ts, _ = bf16.train_step(bf16.init_state(0))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(ts.step, ts)
    back = ckpt.restore(bf16.init_state(1))
    assert back.carry.c.dtype == back.carry.h.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tree_leaves(back.params))
    f32 = _fns(sparse_comm=True, remat=True)
    with pytest.raises(ValueError, match="dtype torch.bfloat16"):
        ckpt.restore(f32.init_state(1))
    # params restore whatever the rest holds
    assert ckpt.restore_params(f32.init_state(1).params) is not None
    # a generator state is specific to the device type
    path = os.path.join(ckpt.path, f"checkpoint_{ts.step}.pt")
    raw = torch.load(path, weights_only=True)
    assert raw["generator"]["device_type"] == "cpu"
    raw["generator"]["device_type"] = "cuda"
    torch.save(raw, path)
    with pytest.raises(ValueError, match="specific to the device type"):
        ckpt.restore(bf16.init_state(1))
    assert ckpt.restore_params(bf16.init_state(1).params) is not None


def test_env_state_is_stored_by_field_name(tmp_path):
    """Grid, Monaco and CACC states are different NamedTuples: each is
    stored under its field names and comes back as its own type."""
    for name in ENVS:
        fns = _fns(name)
        ts = fns.init_state(0)
        ckpt = CheckpointManager(str(tmp_path / name))
        ckpt.save(0, ts)
        raw = torch.load(os.path.join(ckpt.path, "checkpoint_0.pt"),
                         weights_only=True)
        assert set(raw) == {f.name for f in dataclasses.fields(ts)}
        assert set(raw["env_state"]) == set(ts.env_state._fields)
        assert type(ckpt.restore(ts).env_state) is type(ts.env_state)
    # Monaco's stored engine state does not fit the platoon's type
    with pytest.raises(ValueError, match="no field 'state.env_state.h'"):
        ckpt.restore({"env_state": _fns("cacc").init_state(0).env_state})
