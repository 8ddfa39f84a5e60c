"""The port's cross-process path (``parallel/distributed.py``, the
data-parallel checkpoint, the CLI under torchrun's variables) on the CPU with
gloo, the twin of ``tests/test_distributed.py``: real worker processes, one
torch thread each, every wait bounded (180 s), so a hung collective fails
the test instead of the suite's clock.

- 2 processes, 3 updates and a checkpoint round trip equal the 1-process
  run of the same global batch (loss rtol 1e-4; params rtol 2e-4, atol 2e-6,
  the bars of ``tests/test_distributed.py``);
- a checkpoint moves between world sizes: 2 ranks -> 1 process holds the
  ranks' rows concatenated, 1 process -> 2 ranks continues the same run;
- ``main train`` on 2 ranks writes what a 1-process run writes, once.
"""

import configparser
import os
import re
import socket
import time

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.main import main
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.parallel import distributed
from deeprl_network_tpu_torch.parallel.smoke_worker import launch, run_ranks
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.rollout import PER_ENV_FIELDS, make_a2c

ENV = dict(scenario="cacc_catchup", coop_gamma=0.9)
MODEL = dict(batch_size=8, num_envs=8, num_fc=16, num_lstm=16,
             reward_norm=1000.0)
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranks(n, spec, out):
    return run_ranks(n, spec, str(out), device="cpu", backend="gloo",
                     timeout=180, env=ONE_THREAD)


def single(seed=0, **model_kw):
    fns = make_a2c(CACCEnv(EnvConfig(**ENV), device="cpu"),
                   ModelConfig(**dict(MODEL, **model_kw)),
                   TrainConfig(total_step=10_000), agent="ma2c_nc",
                   device="cpu")
    return fns, fns.init_state(seed)


def per_env(ts):
    return {f"{f}{j}": leaf for f in PER_ENV_FIELDS
            for j, leaf in enumerate(tree_leaves(getattr(ts, f)))}


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    spec = dict(agent="ma2c_nc", env=ENV, model=MODEL, updates=3,
                ckpt=str(out / "ckpt"))
    return ranks(2, spec, out), out


def test_two_process_distributed_matches_single_process(two_process_run):
    results, out = two_process_run
    fns, ts = single()
    for _ in range(3):
        ts, metrics = fns.train_step(ts)
    # rank 0 wrote the one checkpoint file of the global state
    assert os.listdir(out / "ckpt") == [f"checkpoint_{ts.step}.pt"]
    for r in results:
        assert r["step"] == ts.step
        np.testing.assert_allclose(r["metrics"][-1]["loss"],
                                   float(metrics["loss"]), rtol=1e-4)
        got = np.load(r["npz"])
        for i, leaf in enumerate(tree_leaves(ts.params)):
            # the cross-process reduction may reassociate differently than
            # the single-process batch mean
            np.testing.assert_allclose(got[f"p{i}"], leaf.numpy(),
                                       rtol=2e-4, atol=2e-6,
                                       err_msg=f"params leaf {i}")


def test_checkpoint_moves_between_world_sizes(two_process_run, tmp_path):
    """2 ranks -> 1 process: the per-env fields are the ranks' rows
    concatenated, the params rank 0's. 1 process -> 2 ranks: each rank
    takes its rows, and one more update on 2 ranks equals one more update
    in the process that wrote the file."""
    results, out = two_process_run
    fns, like = single(seed=5)
    back = CheckpointManager(str(out / "ckpt")).restore(like)
    rows = [np.load(r["npz"]) for r in results]
    for k, leaf in per_env(back).items():
        want = np.concatenate([z[k] for z in rows])
        np.testing.assert_array_equal(leaf.float().numpy(), want, err_msg=k)
    for i, leaf in enumerate(tree_leaves(back.params)):
        np.testing.assert_array_equal(leaf.numpy(), rows[0][f"p{i}"])
    assert back.step == results[0]["step"]

    # the other way: 1 process wrote it, 2 ranks go on from it
    ts, _ = fns.train_step(like)
    CheckpointManager(str(tmp_path / "one")).save(ts.step, ts)
    results = ranks(2, dict(agent="ma2c_nc", env=ENV, model=MODEL,
                            updates=1, restore=str(tmp_path / "one")),
                    tmp_path / "two")
    ts, m = fns.train_step(ts)
    rows = [np.load(r["npz"]) for r in results]
    np.testing.assert_array_equal(np.concatenate([z["obs0"] for z in rows]),
                                  ts.obs.numpy())
    for r, z in zip(results, rows):
        assert r["step"] == ts.step
        np.testing.assert_allclose(r["metrics"][0]["loss"], float(m["loss"]),
                                   rtol=1e-5, atol=1e-6)
        for i, leaf in enumerate(tree_leaves(ts.params)):
            np.testing.assert_allclose(z[f"p{i}"], leaf.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"param {i}")


def _ini(path):
    cp = configparser.ConfigParser()
    cp["ENV_CONFIG"] = {"scenario": "cacc_catchup", "coop_gamma": "-1",
                        "episode_length": "40", "seed": "12",
                        "test_seeds": "2000,2500"}
    cp["MODEL_CONFIG"] = {"agent": "ia2c", "batch_size": "8",
                          "num_fc": "16", "num_lstm": "16", "num_envs": "8",
                          "reward_norm": "1000"}
    cp["TRAIN_CONFIG"] = {"total_step": "640", "test_interval": "320",
                          "log_interval": "160"}
    with open(path, "w") as f:
        cp.write(f)
    return str(path)


def _files(base):
    """Every file under a run dir, sorted; the names of log/ (a log file
    named by the time, TensorBoard's event files) with their digits
    masked."""
    out = []
    for d, _, files in os.walk(base):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), base)
            if rel.startswith("log" + os.sep):
                rel = re.sub(r"\d+", "#", rel)
            out.append(rel)
    return sorted(out)


def test_cli_train_on_two_ranks_writes_one_run_dir(tmp_path):
    """``main train`` under torchrun's variables on 2 gloo ranks: rank 0
    alone writes ``data/``, ``log/`` and ``model/``, the same files as a
    1-process run of the same config, with the same log rows and the same
    final state up to float reassociation."""
    ini = _ini(tmp_path / "config_ia2c_cacc_catchup.ini")
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    args = ["train", "--config-dir", ini, "--test-mode", "in_train_test"]
    main(["--device", "cpu", "--base-dir", one] + args)
    launch(2, ["-m", "deeprl_network_tpu_torch.main", "--device", "cpu",
               "--base-dir", two] + args, str(tmp_path / "ranks"),
           timeout=180, env=ONE_THREAD)
    assert _files(two) == _files(one)
    assert {"data/train_log.csv", "data/test_log.csv",
            "model/checkpoint_640.pt"} <= set(_files(one))
    for name in ("train_log.csv", "test_log.csv"):
        with open(os.path.join(one, "data", name)) as f1, \
                open(os.path.join(two, "data", name)) as f2:
            r1, r2 = f1.read().splitlines(), f2.read().splitlines()
        assert r1[0] == r2[0] and len(r1) == len(r2) == (
            5 if name == "train_log.csv" else 3)
    raw = [torch.load(os.path.join(d, "model", "checkpoint_640.pt"),
                      weights_only=True) for d in (one, two)]
    assert torch.equal(raw[0]["obs"], raw[1]["obs"])
    assert raw[0]["step"] == raw[1]["step"] == 640
    for name, w in raw[0]["params"].items():
        if w is not None:
            for k in w:
                np.testing.assert_allclose(raw[1]["params"][name][k], w[k],
                                           rtol=1e-4, atol=1e-6)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_paths(monkeypatch):
    """Without torchrun's variables or arguments nothing happens; with
    explicit arguments (one rank, gloo) the group forms, and ``axis_name``
    over it reduces to the identity: the update equals the plain one bit
    for bit."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_initialize() is False
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.is_primary()
    env = CACCEnv(EnvConfig(**ENV), device="cpu")
    with pytest.raises(ValueError, match="maybe_initialize"):
        make_a2c(env, ModelConfig(**MODEL), TrainConfig(), agent="ma2c_nc",
                 axis_name="data", device="cpu")
    try:
        assert distributed.maybe_initialize(
            init_method=f"tcp://localhost:{_free_port()}", world_size=1,
            rank=0, backend="gloo")
        assert torch.distributed.get_backend() == "gloo"
        assert distributed.local_device("cpu") == torch.device("cpu")
        with pytest.raises(ValueError, match="n_replicas=2"):
            make_a2c(env, ModelConfig(**MODEL), TrainConfig(),
                     agent="ma2c_nc", axis_name="data", n_replicas=2,
                     device="cpu")
        dp = make_a2c(env, ModelConfig(**MODEL), TrainConfig(),
                      agent="ma2c_nc", axis_name="data", device="cpu")
        fns, ts = single()
        a, ma = dp.train_step(dp.init_state(0))
        b, mb = fns.train_step(ts)
        for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
            assert torch.equal(x, y)
        assert float(ma["loss"]) == float(mb["loss"])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_failures_are_reported(tmp_path):
    """A rank that fails fails the launch (the others are killed at once),
    and so does a launch that outlives its timeout."""
    with pytest.raises(RuntimeError, match="divisible by the world size 2"):
        ranks(2, dict(agent="ma2c_nc", env=ENV,
                      model=dict(MODEL, num_envs=3)), tmp_path / "odd")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out after 2"):
        launch(2, ["-c", "import time; time.sleep(120)"],
               str(tmp_path / "hang"), timeout=2, env=ONE_THREAD)
    assert time.monotonic() - t0 < 60
