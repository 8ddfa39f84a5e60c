"""The port's learning and evaluation harnesses
(``deeprl_network_tpu_torch/scripts/``) against the JAX repo's root
``scripts/``: the hand-controller sweep form by form, the envs they build,
their tables, flags and defaults, the reward decomposition, and each
harness's ``main`` at a tiny size on the CPU with the JAX rows' keys."""

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from deeprl_network_tpu_torch.scripts import (
    cacc_reward_decompose, grid_demo, ladder_atsc, slowdown_demo, train_atsc,
    train_atsc_families, train_cacc_families, validate_learning,
)
from deeprl_network_tpu_torch.scripts._harness import check_rows
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.rollout import make_a2c

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESSES = {
    "train_atsc": train_atsc,
    "train_atsc_families": train_atsc_families,
    "ladder_atsc": ladder_atsc,
    "grid_demo": grid_demo,
    "train_cacc_families": train_cacc_families,
    "validate_learning": validate_learning,
    "slowdown_demo": slowdown_demo,
    "cacc_reward_decompose": cacc_reward_decompose,
}
SCENARIOS = (("grid", 3, 720), ("grid", 5, 60), ("monaco", 5, 60))
AGENTS = ("ia2c", "ia2c_fp", "ia2c_cu", "ma2c_nc", "ma2c_cnet", "ma2c_dial")
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_script(name):
    """The JAX repo's ``scripts/<name>.py``, loaded by path (its top level
    puts "." and "scripts" on ``sys.path``: undone here)."""
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


# ---- the hand-controller bar ----

@pytest.mark.parametrize("scenario,grid_size,horizon", SCENARIOS)
def test_greedy_returns_match_jax(scenario, grid_size, horizon):
    """Every form of the sweep, every seed, within 1e-5 of the JAX sweep:
    the 3x3 grid of the acceptance bar at the full 720 steps, the 5x5 grid
    and Monaco-28 over their first 60."""
    env, _ = train_atsc.build_env(scenario, "ma2c_nc", 8.0, 10,
                                  grid_size=grid_size, device="cpu")
    got = train_atsc.greedy_returns(env, train_atsc.EVAL_SEEDS, horizon)
    jta = _jax_script("train_atsc")
    jenv, _ = jta.build_env(scenario, "ma2c_nc", 8.0, 10,
                            grid_size=grid_size)
    want = jta.greedy_returns(jenv, jta.EVAL_SEEDS, horizon)
    assert list(got) == list(want)
    for form in want:
        assert len(got[form]) == len(want[form]) == 3
        for a, b in zip(got[form], want[form]):
            assert _rel(a, b) <= RTOL, (form, a, b)


@torch.no_grad()
def _one_row(env, seed, on, delta, horizon):
    """The return of one form's controller on one env row alone."""
    state = train_atsc.reset_seeds(env, (seed,))
    total = 0.0
    for _ in range(horizon):
        a = env.greedy_action(state, on=on, delta=delta)
        state, _, r, _, _ = env.step(state, a)
        total += float(r.sum())
    return total


@pytest.mark.parametrize("init_density", [0.0, 0.3])
def test_batched_rows_equal_single_runs(init_density):
    """Every (form, seed) pair is one row of one batch: each row's return
    is that form's controller run alone from that seed, also where the
    reset draws from the seed."""
    env, _ = train_atsc.build_env("grid", "ma2c_nc", 8.0, 10, device="cpu")
    env.cfg = dataclasses.replace(env.cfg, init_density=init_density)
    seeds, horizon = (10000, 10001, 10002), 20
    batched = train_atsc.greedy_returns(env, seeds, horizon)
    for name, on, delta in train_atsc.GREEDY_FORMS:
        for s, got in zip(seeds, batched[name]):
            want = _one_row(env, s, on, delta, horizon)
            assert got == pytest.approx(want, rel=1e-6), (name, s)
    rows = np.array(list(batched.values()))
    if init_density == 0.0:
        assert (rows == rows[:, :1]).all()     # the reset draws nothing
    else:
        assert not (rows == rows[:, :1]).all()


def test_greedy_disagreements_are_float_ties():
    """Monaco-28, queue-scored hysteresis at delta 2, stepped in lockstep
    with the JAX env on the JAX controller's actions over the full 720
    steps: the states stay within 1e-5, and wherever the port's controller
    picks another phase than the JAX one, the node's switch test
    ``top > keep + delta`` sits on a tie to float32 rounding (the two
    packages sum a phase's lanes in another order). This is why a whole
    720-step sweep can leave a form's return off the JAX one (ROADMAP
    queue 3)."""
    jta = _jax_script("train_atsc")
    on, delta = "queue", 2.0
    jenv, _ = jta.build_env("monaco", "ma2c_nc", 8.0, 10)
    env, _ = train_atsc.build_env("monaco", "ma2c_nc", 8.0, 10,
                                  device="cpu")
    js, _ = jenv.reset(jax.random.key(10000))
    s = train_atsc.reset_seeds(env, (10000,))
    jstep = jax.jit(jenv.step)
    jact = jax.jit(lambda st: jenv.greedy_action(st, on=on, delta=delta))
    M, P = env._t_valid.shape
    with torch.no_grad():
        for _ in range(720):
            ja = np.array(jact(js))
            pa = env.greedy_action(s, on=on, delta=delta).numpy()[0]
            for m in np.nonzero(ja != pa)[0]:
                served = (s.queue @ env._t_gate.T).reshape(M, P)[m]
                keep, switch = served[int(s.prev_phase[0, m])], served[ja[m]]
                assert abs(float(switch - keep - delta)) <= 1e-5, (m, served)
            js, *_ = jstep(js, jnp.asarray(ja))
            s, *_ = env.step(s, torch.as_tensor(ja)[None])
            np.testing.assert_allclose(s.queue.numpy()[0],
                                       np.asarray(js.queue), rtol=1e-5,
                                       atol=1e-4)


@pytest.mark.parametrize("scenario,grid_size", [("grid", 5), ("grid", 3),
                                                ("monaco", 5)])
def test_build_env_matches_jax(scenario, grid_size):
    """Field for field the JAX ``EnvConfig`` (hysteresis form and delta
    included) for every agent, and the same env: class, agents,
    observation widths, episode length."""
    jta = _jax_script("train_atsc")
    for agent in AGENTS:
        for obs in (False, True):
            for delta in (None, 2.0):
                args = (scenario, agent, 4.0, 7, obs, obs, grid_size, delta)
                env, ecfg = train_atsc.build_env(*args, device="cpu")
                jenv, jcfg = jta.build_env(*args)
                assert (dataclasses.asdict(ecfg)
                        == dataclasses.asdict(jcfg)), args
                assert env.cfg == ecfg
                assert type(env).__name__ == type(jenv).__name__
                assert env.spec.n_agent == jenv.spec.n_agent
                assert env.spec.n_s_ls == tuple(jenv.spec.n_s_ls)
                assert env.episode_steps == jenv.episode_steps


# ---- tables, flags and defaults ----

class _Parsed(Exception):
    pass


def _jax_defaults(name, monkeypatch):
    """The JAX script's argparse defaults: its ``main()`` is run up to its
    ``parse_args`` call, which returns the parse of no arguments."""
    mod = _jax_script(name)
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise _Parsed(vars(parse(self, [])))

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as e:
            mod.main()
    return e.value.args[0]


@pytest.mark.parametrize("name", list(HARNESSES))
def test_flags_and_defaults_equal_jax(name, monkeypatch):
    got = vars(HARNESSES[name].parse_args([]))
    want = _jax_defaults(name, monkeypatch)
    assert list(got) == list(want)
    if name == "slowdown_demo":
        # the port draws the figure only when --out is given
        assert got.pop("out") is None
        want.pop("out")
    assert got == want


def test_ladder_and_eval_seeds_equal_jax():
    assert ladder_atsc.LADDER == _jax_script("ladder_atsc").LADDER
    for name in ("train_atsc", "train_atsc_families", "ladder_atsc"):
        assert HARNESSES[name].EVAL_SEEDS == _jax_script(name).EVAL_SEEDS


# ---- the reward decomposition ----

_NUM = re.compile(r"-?\d+(?:\.\d+)?")


def test_decomposition_prints_the_jax_numbers(tmp_path):
    """Line for line the JAX script's printout of record
    (``results/cacc_reward_decompose_r5.txt``); every number within 1e-5;
    and the OVM teacher's episode within 1e-5 of the JAX rollout."""
    out = tmp_path / "decompose.txt"
    cacc_reward_decompose.main(["--out", str(out)], device="cpu")
    got = out.read_text().splitlines()
    with open(os.path.join(ROOT, "results",
                           "cacc_reward_decompose_r5.txt")) as f:
        want = f.read().splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
        for x, y in zip(_NUM.findall(a), _NUM.findall(b)):
            assert _rel(float(x), float(y)) <= RTOL, (a, b)

    jcd = _jax_script("cacc_reward_decompose")
    from deeprl_network_tpu.config import EnvConfig as JEnvConfig
    kw = dict(scenario="cacc_slowdown", init_noise_h=0.0, init_noise_v=0.0)
    got = cacc_reward_decompose.rollout_teacher(EnvConfig(**kw), "cpu")
    want = jcd.rollout_teacher(JEnvConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        # 1e-5 of the series' largest value: a reward is a difference of
        # squares of speeds near 30 m/s
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=RTOL * np.abs(want[k]).max(),
                                   err_msg=k)


# ---- each harness's main at a tiny size ----

def _check_rows(name, rows, unreached=()):
    """Every row the port wrote has the keys of a JAX row, and every JAX
    row but ``unreached`` was written."""
    check_rows(name, rows, os.path.join(ROOT, "scripts", f"{name}.py"),
               unreached)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _stdout_rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _tiny(monkeypatch, mod, **env_kw):
    """16/16 widths for every model the harness builds, and ``env_kw`` (the
    cut horizon) for every env config."""
    monkeypatch.setattr(mod, "ModelConfig",
                        functools.partial(ModelConfig, num_fc=16,
                                          num_lstm=16))
    if env_kw:
        monkeypatch.setattr(mod, "EnvConfig",
                            functools.partial(EnvConfig, **env_kw))


TWO_UPDATES = str(2 * 120 * 2)           # B=2 envs, T=120
ATSC_CUT = dict(episode_length_sec=60)   # 12 control steps
CACC_CUT = dict(episode_length=40)


def test_train_atsc_main_rows_and_checkpoint(tmp_path, monkeypatch):
    _tiny(monkeypatch, train_atsc, **ATSC_CUT)
    out, ckpt = tmp_path / "rows.jsonl", tmp_path / "ckpt"
    train_atsc.main(["--grid-size", "3", "--steps", TWO_UPDATES,
                     "--num-envs", "2", "--seeds", "0,1",
                     "--ckpt", str(ckpt), "--out", str(out)], device="cpu")
    rows = _jsonl(out)
    _check_rows("train_atsc", rows)
    finals = [r for r in rows if "final_eval_sampled" in r]
    assert [r["seed"] for r in finals] == [0, 1]
    for r in finals:
        assert {k for k in r if k.startswith("greedy_")} == {
            "greedy_" + n for n, _, _ in train_atsc.GREEDY_FORMS}
        assert r["baseline_best"] == max(
            np.mean(r["greedy_" + n]) for n, _, _ in
            train_atsc.GREEDY_FORMS)
        assert len(r["final_eval_sampled"]) == 3
    env, _ = train_atsc.build_env("grid", "ma2c_nc", 8.0, 10, grid_size=3,
                                  device="cpu")
    fns = make_a2c(env, train_atsc.ModelConfig(batch_size=120, num_envs=2),
                   TrainConfig(total_step=int(TWO_UPDATES)),
                   agent="ma2c_nc", device="cpu")
    like = fns.init_state(7)
    for seed in (0, 1):
        ts = CheckpointManager(str(ckpt / f"seed{seed}")).restore(like)
        assert ts.step == int(TWO_UPDATES)
        assert not torch.equal(ts.params.w_obs.w, like.params.w_obs.w)


def test_train_atsc_families_main_rows(tmp_path, monkeypatch):
    _tiny(monkeypatch, train_atsc_families)
    monkeypatch.setattr(train_atsc, "EnvConfig",
                        functools.partial(EnvConfig, **ATSC_CUT))
    out = tmp_path / "rows.jsonl"
    train_atsc_families.main(["--grid-size", "3", "--steps", TWO_UPDATES,
                              "--num-envs", "2", "--seeds", "0",
                              "--agents", "ia2c_cu,ma2c_dial",
                              "--consensus-masked", "0", "--out", str(out)],
                             device="cpu")
    rows = _jsonl(out)
    _check_rows("train_atsc_families", rows)
    assert [r["agent"] for r in rows if r.get("final")] == ["ia2c_cu",
                                                          "ma2c_dial"]
    assert sum("baselines" in r for r in rows) == 1


def test_ladder_atsc_main_rows(tmp_path, monkeypatch):
    _tiny(monkeypatch, ladder_atsc)
    monkeypatch.setattr(train_atsc, "EnvConfig",
                        functools.partial(EnvConfig, **ATSC_CUT))
    out = tmp_path / "rows.jsonl"
    ladder_atsc.main(["--steps", TWO_UPDATES, "--num-envs", "2",
                      "--only", "pq_kick_sp2", "--out", str(out)],
                     device="cpu")
    rows = _jsonl(out)
    _check_rows("ladder_atsc", rows)
    final = rows[-1]
    assert final["variant"] == "pq_kick_sp2" and "kick_ce" in rows[-2]
    assert {k for k in final if k.startswith("greedy_")} == {
        "greedy_" + n for n, _, _ in train_atsc.GREEDY_FORMS}


def test_grid_demo_main_rows(monkeypatch, capsys):
    _tiny(monkeypatch, grid_demo, **ATSC_CUT)
    grid_demo.main(["--steps", TWO_UPDATES, "--num-envs", "2"],
                   device="cpu")
    rows = _stdout_rows(capsys)
    _check_rows("grid_demo", rows)
    assert [r["eval_policy"] for r in rows[-2:]] == ["sample", "controller"]
    assert set(rows[-1]) == {"eval_policy", "episode_return", "avg_queue",
                             "avg_wait"}


def test_train_cacc_families_main_rows(tmp_path, monkeypatch):
    _tiny(monkeypatch, train_cacc_families, **CACC_CUT)
    out = tmp_path / "rows.jsonl"
    train_cacc_families.main(["--agents", "ia2c_fp,ma2c_dial", "--seeds",
                              "0", "--steps", TWO_UPDATES, "--num-envs", "2",
                              "--collision-penalty", "5000",
                              "--out", str(out)], device="cpu")
    rows = _jsonl(out)
    _check_rows("train_cacc_families", rows)
    recipes = [r["recipe"] for r in rows if "recipe" in r]
    assert [r["env"]["coop_gamma"] for r in recipes] == [-1.0, 0.9]
    assert all(r["model"]["reward_clip"] == 5.0 for r in recipes)
    assert len([r for r in rows if "step" in r]) == 2 * 2


def test_validate_learning_main_rows(monkeypatch, capsys):
    _tiny(monkeypatch, validate_learning, **CACC_CUT)
    validate_learning.main(["--steps", TWO_UPDATES, "--num-envs", "2"],
                           device="cpu")
    rows = _stdout_rows(capsys)
    _check_rows("validate_learning", rows)
    assert [len(r.get("final_eval_sampled", r.get("final_eval_greedy", [])))
            for r in rows[-2:]] == [5, 5]


def test_slowdown_demo_main_rows(tmp_path, monkeypatch):
    _tiny(monkeypatch, slowdown_demo, **CACC_CUT)
    out = tmp_path / "rows.jsonl"
    slowdown_demo.main(["--steps", str(2 * 120 * 64), "--jsonl", str(out)],
                       device="cpu")          # B=64 is the script's own
    rows = _jsonl(out)
    series = [r for r in rows if "series" in r]
    _check_rows("slowdown_demo", [r for r in rows if "series" not in r],
                unreached={("wrote",)})
    assert [r["series"] for r in series] == [
        "learned (MA2C_NC, sampled)", "spacing controller"]
    for r in series:
        assert np.array(r["velocity"]).shape == (40, 8)
        assert np.array(r["headway"]).shape == (40, 8)
        assert len(r["v_lead"]) == len(r["alive"]) == 40
    assert not any("wrote" in r for r in rows)


def test_row_check_rejects_other_keys():
    """The row check fails a row with a key the JAX script does not write,
    a row without one it does, and a run that never writes a JAX row."""
    run = {"run": {}}
    final = {"agent": "ia2c", "seed": 0, "final": True, "collision_rate": 0.0,
             "episode_len": 600.0, "eval_episode_len": 600.0,
             "eval_return": -1.0, "eval_collision": 0.0}
    log = {"agent": "ia2c", "seed": 0, "step": 1, "episode_len": 1.0,
           "collision_rate": 0.0, "headway_err": 0.0, "sps": 1.0}
    rows = [run, {"recipe": {}}, log, final]
    _check_rows("train_cacc_families", rows)
    for bad in ({**final, "extra": 1},
                {k: v for k, v in final.items() if k != "eval_return"}):
        with pytest.raises(AssertionError, match="fits no row"):
            _check_rows("train_cacc_families", rows + [bad])
    with pytest.raises(AssertionError, match="no row with the keys"):
        _check_rows("train_cacc_families", rows[:-1])
