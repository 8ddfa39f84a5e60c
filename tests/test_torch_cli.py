"""The port's host loop and CLI (``config.save_config``, ``utils/logging``,
``utils/trainer``, ``main``) against the JAX package's: config snapshots
load in either package, the ``tests/test_cli.py`` flows run with
``--device cpu``, ``Counter`` agrees call for call, ``Trainer.run`` equals
direct ``train_step`` calls bit for bit, and ``evaluate --naive`` through
both CLIs writes the same csv files (equal headers; values within 1e-4
relative or one unit of the last printed digit, whichever is larger: the
controller path is deterministic when ``init_density = 0``)."""

import configparser
import csv
import dataclasses
import glob
import json
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch

from deeprl_network_tpu import config as jconfig
from deeprl_network_tpu.main import main as jmain
from deeprl_network_tpu.utils import logging as jlogging
from deeprl_network_tpu.utils.trainer import Counter as JCounter
from deeprl_network_tpu_torch import config as tconfig
from deeprl_network_tpu_torch.main import init_agent, init_env, main
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.utils import logging as tlogging
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.trainer import Counter, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ini(path, env, model, train=None):
    cp = configparser.ConfigParser()
    cp["ENV_CONFIG"] = env
    cp["MODEL_CONFIG"] = model
    cp["TRAIN_CONFIG"] = train or {"total_step": "640",
                                   "test_interval": "320",
                                   "log_interval": "160"}
    with open(path, "w") as f:
        cp.write(f)
    return str(path)


SMALL_MODEL = {"batch_size": "8", "num_fc": "16", "num_lstm": "16",
               "num_envs": "8", "reward_norm": "1000"}


@pytest.fixture(scope="module")
def tiny_ini(tmp_path_factory):
    """The tiny CACC config of ``tests/test_cli.py``."""
    return _ini(
        tmp_path_factory.mktemp("cfg") / "config_ia2c_cacc_catchup.ini",
        {"scenario": "cacc_catchup", "coop_gamma": "-1",
         "episode_length": "40", "seed": "12", "test_seeds": "2000,2500"},
        dict(SMALL_MODEL, agent="ia2c"))


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


# ---- config ----

@pytest.mark.parametrize("name", ["config_ma2c_nc_net.ini",
                                  "config_ia2c_cacc_catchup.ini",
                                  "config_ia2c_cu_grid.ini"])
def test_save_config_round_trip_and_cross_package(name, tmp_path):
    """A snapshot written by either package loads in both, equal to what
    the original file gives; the two snapshots are the same text."""
    src = os.path.join(ROOT, "configs", name)
    want = tconfig.load_config(src)
    t_snap, j_snap = str(tmp_path / "t.ini"), str(tmp_path / "j.ini")
    tconfig.save_config(want, t_snap)
    jconfig.save_config(jconfig.load_config(src), j_snap)
    with open(t_snap) as a, open(j_snap) as b:
        assert a.read() == b.read()
    for snap in (t_snap, j_snap):
        got = tconfig.load_config(snap)
        assert got == want and got.agent == want.agent
        assert dataclasses.asdict(jconfig.load_config(snap)) == \
            dataclasses.asdict(want)


def test_config_classes_have_the_same_fields_and_defaults():
    for name in ("EnvConfig", "ModelConfig", "TrainConfig"):
        jf = dataclasses.fields(getattr(jconfig, name))
        tf = dataclasses.fields(getattr(tconfig, name))
        assert [f.name for f in tf] == [f.name for f in jf], name
        assert [f.default for f in tf] == [f.default for f in jf], name


# ---- logging ----

def test_metric_writer_csv_jsonl(tmp_path):
    w = tlogging.MetricWriter(str(tmp_path), "train_log")
    w.write({"step": 10, "loss": 1.5})
    w.write({"step": 20, "loss": torch.tensor(0.5)})
    assert [r["step"] for r in _rows(tmp_path / "train_log.csv")] == \
        ["10.0", "20.0"]
    with open(tmp_path / "train_log.jsonl") as f:
        assert json.loads(f.readlines()[1])["loss"] == 0.5
    # the same rows through the JAX package's writer give the same files
    j = jlogging.MetricWriter(str(tmp_path / "j"), "train_log")
    j.write({"step": 10, "loss": 1.5})
    j.write({"step": 20, "loss": 0.5})
    for ext in ("csv", "jsonl"):
        with open(tmp_path / f"train_log.{ext}") as a, \
                open(tmp_path / "j" / f"train_log.{ext}") as b:
            assert a.read() == b.read()


def test_metric_writer_tensorboard_mirror(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    tb = tmp_path / "tb"
    w = tlogging.MetricWriter(str(tmp_path), "train_log", tb_dir=str(tb))
    w.write({"step": 10, "loss": 1.5, "episode_return": -3.0})
    w.close()
    event_files = [f for f in os.listdir(tb / "train_log")
                   if "tfevents" in f]
    assert event_files, "no TensorBoard event file written"
    assert os.path.getsize(tb / "train_log" / event_files[0]) > 0


def test_metric_writer_without_tensorboard_says_so_once(
        tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(tlogging.MetricWriter, "_told_no_tensorboard", False)
    with caplog.at_level(logging.INFO, logger=tlogging.log.name):
        for name in ("train_log", "test_log"):
            w = tlogging.MetricWriter(str(tmp_path), name,
                                      tb_dir=str(tmp_path / "tb"))
            w.write({"step": 1, "loss": 2.0})
            w.close()
    told = [r for r in caplog.records if "tensorboard" in r.getMessage()]
    assert len(told) == 1 and told[0].levelno == logging.INFO
    assert _rows(tmp_path / "test_log.csv")[0]["loss"] == "2.0"
    assert not os.path.exists(tmp_path / "tb")


class _BrokenTensorboard(types.ModuleType):
    """A ``torch.utils.tensorboard`` that fails as an installed but broken
    one does: ``import_error`` raises TypeError on import of SummaryWriter
    (a protobuf mismatch does that), ``build_error`` raises on
    construction."""

    def __init__(self, how):
        super().__init__("torch.utils.tensorboard")
        self.how = how

    def __getattr__(self, name):
        if name != "SummaryWriter":
            raise AttributeError(name)
        if self.how == "import_error":
            raise TypeError("Descriptors cannot be created directly")

        def summary_writer(*args, **kwargs):
            raise OSError("cannot open the event file")
        return summary_writer


@pytest.mark.parametrize("how", ["import_error", "build_error"])
def test_trainer_writes_logs_when_tensorboard_is_broken(
        tiny_ini, tmp_path, monkeypatch, caplog, how):
    """As the JAX package's writer, the port's goes on with csv and jsonl
    when tensorboard raises anything on import or construction, and says so
    once: a whole Trainer run still writes its logs."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        _BrokenTensorboard(how))
    monkeypatch.setattr(tlogging.MetricWriter, "_told_no_tensorboard", False)
    cfg, fns = _tiny(tiny_ini)
    with caplog.at_level(logging.INFO, logger=tlogging.log.name):
        Trainer(fns, cfg, str(tmp_path), seed=cfg.env.seed,
                in_train_test=True).run()
    data = tmp_path / "data"
    rows = _rows(data / "train_log.csv")
    assert rows and all(float(r["step"]) > 0 for r in rows)
    with open(data / "train_log.jsonl") as f:
        assert len(f.readlines()) == len(rows)
    assert _rows(data / "test_log.csv")
    told = [r for r in caplog.records if "tensorboard" in r.getMessage()]
    assert len(told) == 1


def test_resolved_recipe_and_init_dir_match_jax(tmp_path):
    t = tconfig.load_config(os.path.join(ROOT, "configs",
                                         "config_ma2c_nc_net.ini"))
    j = jconfig.load_config(os.path.join(ROOT, "configs",
                                         "config_ma2c_nc_net.ini"))
    assert tlogging.resolved_recipe("ma2c_nc", t.env, t.model, t.train,
                                    note="x") == \
        jlogging.resolved_recipe("ma2c_nc", j.env, j.model, j.train,
                                 note="x")
    dirs = tlogging.init_dir(str(tmp_path / "run"))
    assert sorted(dirs) == ["data", "log", "model"]
    assert all(os.path.isdir(d) for d in dirs.values())


# ---- Counter, Trainer ----

def test_counter_matches_jax_counter():
    calls = ([("update", 64)] * 7 + [("fast_forward", 1000)]
             + [("update", 64)] * 12 + [("fast_forward", 320)]
             + [("update", 200)] * 5)
    a, b = Counter(1300, 320, 160), JCounter(1300, 320, 160)
    for name, arg in calls:
        assert getattr(a, name)(arg) == getattr(b, name)(arg)
        got = (a.cur_step, a.should_log(), a.should_test(), a.should_stop())
        assert got == (b.cur_step, b.should_log(), b.should_test(),
                       b.should_stop())
    assert a.should_stop()


def _tiny(tiny_ini, **train_kw):
    cfg = tconfig.load_config(tiny_ini)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **train_kw))
    env = init_env(cfg, device="cpu")
    return cfg, init_agent(env, cfg, device="cpu")


def test_trainer_run_equals_direct_train_steps(tiny_ini, tmp_path):
    """10 updates through ``Trainer.run`` (logging, in-train tests and
    checkpoints along the way) leave the state that 10 direct ``train_step``
    calls from ``init_state(seed)`` leave, bit for bit; the last checkpoint
    holds it; the logged window means are the means of the direct metrics."""
    cfg, fns = _tiny(tiny_ini)
    trainer = Trainer(fns, cfg, str(tmp_path), seed=cfg.env.seed,
                      in_train_test=True)
    got = trainer.run()
    ts, direct = fns.init_state(cfg.env.seed), []
    for _ in range(10):
        ts, m = fns.train_step(ts)
        direct.append(m)
    assert got.step == ts.step == 640
    for a, b in zip(tree_leaves(got.params) + got.opt_state.ms,
                    tree_leaves(ts.params) + ts.opt_state.ms):
        assert torch.equal(a, b)
    assert torch.equal(got.generator.get_state(), ts.generator.get_state())
    back = CheckpointManager(trainer.dirs["model"]).restore(
        fns.init_state(0))
    assert back.step == 640 and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back.params),
                                          tree_leaves(ts.params)))
    rows = _rows(os.path.join(trainer.dirs["data"], "train_log.csv"))
    # log thresholds 160, 320, 480, 640 fire at steps 192, 320, 512, 640
    assert [float(r["step"]) for r in rows] == [192.0, 320.0, 512.0, 640.0]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(
            float(rows[1][key]),
            np.mean([float(m[key]) for m in direct[3:5]]), rtol=1e-6)
    assert len(_rows(os.path.join(trainer.dirs["data"],
                                  "test_log.csv"))) == 2


def test_save_interval_ratchet_and_profile(tiny_ini, tmp_path):
    """``save_interval`` decouples checkpoints from log rows and ratchets
    past the current step; ``profile=True`` writes a trace of three
    updates (CPU activity here) and the run goes on after it."""
    cfg, fns = _tiny(tiny_ini, save_interval=100, total_step=400)
    trainer = Trainer(fns, cfg, str(tmp_path), seed=1, profile=True,
                      in_train_test=False)
    ts = trainer.run()
    # 4 updates under the profiler are not counted: 7 more reach 448
    assert ts.step == (4 + 7) * 64
    # saves at 128 (>=100), 256 (>=200), 320 (>=300), 448 (>=400) + final
    assert trainer.ckpt.all_steps() == [128, 256, 320, 448]
    trace = os.path.join(trainer.dirs["log"], "trace.json")
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


# ---- the CLI's flows (tests/test_cli.py) ----

def test_train_and_evaluate_end_to_end(tiny_ini, tmp_path_factory):
    base = str(tmp_path_factory.mktemp("run"))
    main(CPU + ["--base-dir", base, "train", "--config-dir", tiny_ini,
                "--test-mode", "in_train_test"])
    assert os.path.exists(os.path.join(base, "data", "train_log.csv"))
    assert os.path.exists(os.path.join(base, "data", "test_log.csv"))
    assert sorted(os.listdir(os.path.join(base, "model"))) == [
        f"checkpoint_{s}.pt" for s in (192, 320, 512, 640)]
    snaps = glob.glob(os.path.join(base, "data", "*.ini"))
    assert len(snaps) == 1
    assert tconfig.load_config(snaps[0]) == tconfig.load_config(tiny_ini)
    main(CPU + ["--base-dir", base, "evaluate", "--evaluation-seeds",
                "2000,2500"])
    rows = _rows(os.path.join(base, "eva_data", "eval_log.csv"))
    assert [float(r["seed"]) for r in rows] == [2000.0, 2500.0]
    assert all(np.isfinite(float(r["episode_return"])) for r in rows)
    assert os.path.exists(os.path.join(base, "eva_data",
                                       "episode_seed2500.csv"))
    # CACC carries no traffic keys: no reference ATSC artifacts
    assert not glob.glob(os.path.join(base, "eva_data", "*_traffic.csv"))
    # evaluate --agents: run subdirectories under a parent dir
    main(CPU + ["--base-dir", os.path.dirname(base), "evaluate", "--agents",
                os.path.basename(base), "--evaluation-seeds", "2000",
                "--demo"])
    assert len(_rows(os.path.join(base, "eva_data", "eval_log.csv"))) == 3


def test_train_no_test_mode_skips_test_log(tiny_ini, tmp_path_factory):
    base = str(tmp_path_factory.mktemp("run_nt"))
    main(CPU + ["--base-dir", base, "train", "--config-dir", tiny_ini,
                "--single-device"])
    assert os.path.exists(os.path.join(base, "data", "train_log.csv"))
    assert not os.path.exists(os.path.join(base, "data", "test_log.csv"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        main(CPU + ["--base-dir", str(tmp_path_factory.mktemp("empty")),
                    "evaluate", "--config-dir", tiny_ini])


def test_train_restore_resumes(tiny_ini, tmp_path_factory):
    """--restore continues from the latest checkpoint with the remaining
    budget, and equals an uninterrupted run of the doubled budget."""
    base = str(tmp_path_factory.mktemp("run_restore"))
    main(CPU + ["--base-dir", base, "train", "--config-dir", tiny_ini])
    log_csv = os.path.join(base, "data", "train_log.csv")
    steps_before = [float(r["step"]) for r in _rows(log_csv)]
    cp = configparser.ConfigParser()
    cp.read(tiny_ini)
    cp["TRAIN_CONFIG"]["total_step"] = str(
        2 * int(cp["TRAIN_CONFIG"]["total_step"]))
    bigger = os.path.join(os.path.dirname(tiny_ini), "bigger.ini")
    with open(bigger, "w") as f:
        cp.write(f)
    main(CPU + ["--base-dir", base, "train", "--config-dir", bigger,
                "--restore"])
    steps_after = [float(r["step"]) for r in _rows(log_csv)]
    assert len(steps_after) > len(steps_before)
    assert max(steps_after) == 1280.0 > max(steps_before)
    # resumed, not restarted: the new rows continue past the checkpoint
    assert min(steps_after[len(steps_before):]) > max(steps_before)
    # lr and entropy schedules are constant in this config, so the resumed
    # run must equal 20 direct updates exactly
    cfg, fns = _tiny(bigger)
    ts = fns.init_state(cfg.env.seed)
    for _ in range(20):
        ts, _ = fns.train_step(ts)
    got = CheckpointManager(os.path.join(base, "model")).restore_params(
        ts.params)
    for a, b in zip(tree_leaves(got), tree_leaves(ts.params)):
        assert torch.equal(a, b)


def test_cli_without_a_card_fails_unless_asked_for_the_cpu(tiny_ini,
                                                           tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for cmd in (["train", "--config-dir", tiny_ini],
                ["evaluate", "--config-dir", tiny_ini, "--naive"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--base-dir", str(tmp_path)] + cmd)
    assert not os.path.exists(tmp_path / "eva_data")
    with pytest.raises(SystemExit):
        main(["--base-dir", str(tmp_path), "--device", "tpu", "train",
              "--config-dir", tiny_ini])


# ---- both CLIs side by side ----

def _assert_csv_close(t_path, j_path):
    th, jh = _header(t_path), _header(j_path)
    assert th == jh, (t_path, th, jh)
    trows, jrows = _rows(t_path), _rows(j_path)
    assert len(trows) == len(jrows) > 0
    for i, (tr, jr) in enumerate(zip(trows, jrows)):
        for k in jh:
            a, b = tr[k], jr[k]
            digits = len(b.split(".")[1]) if "." in b and "e" not in b \
                else 0
            tol = max(1e-4 * abs(float(b)), 1.01 * 10.0 ** -digits
                      if digits else 0.0)
            assert abs(float(a) - float(b)) <= tol, (t_path, i, k, a, b)


NAIVE = {
    "grid": {"scenario": "large_grid", "coop_gamma": "0.9",
             "episode_length_sec": "100", "peak_flow1": "3000",
             "peak_flow2": "2500"},
    "monaco": {"scenario": "real_net", "coop_gamma": "0.9",
               "episode_length_sec": "100", "objective": "hybrid",
               "peak_flow1": "3000", "peak_flow2": "2500",
               "hysteresis_on": "wave", "hysteresis_delta": "4"},
}


@pytest.mark.parametrize("name", sorted(NAIVE))
def test_evaluate_naive_artifacts_equal_the_jax_cli(name, tmp_path):
    ini = _ini(tmp_path / "config_ma2c_nc_x.ini", NAIVE[name], SMALL_MODEL)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    args = ["evaluate", "--config-dir", ini, "--naive",
            "--evaluation-seeds", "2000,2500"]
    main(CPU + ["--base-dir", tdir] + args)
    jmain(["--base-dir", jdir] + args)
    scenario = NAIVE[name]["scenario"]
    files = (["eval_log.csv", "episode_seed2000.csv", "episode_seed2500.csv"]
             + [f"{scenario}_greedy_{kind}.csv"
                for kind in ("traffic", "control", "trip")])
    assert sorted(os.listdir(os.path.join(tdir, "eva_data"))) == \
        sorted(os.listdir(os.path.join(jdir, "eva_data")))
    for f in files:
        _assert_csv_close(os.path.join(tdir, "eva_data", f),
                          os.path.join(jdir, "eva_data", f))
    traffic = _rows(os.path.join(tdir, "eva_data",
                                 f"{scenario}_greedy_traffic.csv"))
    assert len(traffic) == 2 * 20
    assert max(float(r["total_queue"]) for r in traffic) > 0


def test_train_and_test_log_headers_equal_the_jax_cli(tiny_ini, tmp_path):
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    args = ["train", "--config-dir", tiny_ini, "--test-mode",
            "in_train_test"]
    main(CPU + ["--base-dir", tdir] + args)
    jmain(["--base-dir", jdir] + args)
    for f in ("train_log.csv", "test_log.csv"):
        t, j = os.path.join(tdir, "data", f), os.path.join(jdir, "data", f)
        assert _header(t) == _header(j), f
        assert [r["step"] for r in _rows(t)] == [r["step"] for r in _rows(j)]
    with open(glob.glob(os.path.join(tdir, "data", "*.ini"))[0]) as a, \
            open(glob.glob(os.path.join(jdir, "data", "*.ini"))[0]) as b:
        assert a.read() == b.read()
