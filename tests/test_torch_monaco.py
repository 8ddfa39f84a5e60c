"""The port's Monaco-28 env (``envs/monaco.py`` on the batched engine)
against the JAX package: the graph file and every topology array exactly,
the engine step for step at 1e-5 on recorded random actions that include
phases invalid for low-degree nodes, the hand controllers exactly, two whole
updates (rtol 1e-4 on metrics, atol 1e-5 on params) with the noise JAX
draws, an eval and a record episode, and every ``configs/*.ini`` file through
one update of the port."""

import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_eval_record import HORIZON, _assert_same, _pair
from test_torch_grid_env import TOPO_FIELDS, _compare
from test_torch_train import _assert_updates_match, _build_pair

from deeprl_network_tpu.config import EnvConfig as JEnvConfig
from deeprl_network_tpu.envs import monaco as jmonaco
from deeprl_network_tpu.envs.wrappers import AutoResetEnv as JAutoReset
from deeprl_network_tpu_torch.config import (
    EnvConfig, TrainConfig, load_config,
)
from deeprl_network_tpu_torch.envs import monaco
from deeprl_network_tpu_torch.envs.wrappers import AutoResetEnv
from deeprl_network_tpu_torch.main import init_agent, init_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INI = sorted(glob.glob(os.path.join(ROOT, "configs", "*.ini")))
# 12-step episodes, so that two 8-step updates cross an auto-reset
MONACO_KW = dict(scenario="real_net", coop_gamma=0.9, episode_length_sec=60,
                 objective="hybrid")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_graph_file_is_a_byte_equal_copy():
    with open(monaco.DEFAULT_DATA, "rb") as a, \
            open(jmonaco.DEFAULT_DATA, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(monaco.DEFAULT_DATA).startswith(
        os.path.join(ROOT, "deeprl_network_tpu_torch"))


def test_module_attributes_equal_jax():
    assert np.array_equal(monaco.NODE_XY, jmonaco.NODE_XY)
    assert monaco.EDGES == jmonaco.EDGES
    assert monaco.ENTRY_NODES == jmonaco.ENTRY_NODES
    assert monaco.DEFAULT_PHASES == jmonaco.DEFAULT_PHASES
    assert monaco.EXT == jmonaco.EXT == -1


def _assert_topo_equal(tt, jt):
    assert tt.n_node == jt.n_node and tt.node_lanes == jt.node_lanes
    for f in TOPO_FIELDS:
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("kw", [
    dict(), dict(link_delay_sec=4, peak_flow1=700.0, demand_scale=1.5,
                 episode_length_sec=300)], ids=["default", "scaled"])
def test_topology_equals_jax(kw):
    kw = dict(scenario="real_net", **kw)
    tt = monaco.build_monaco_topology(EnvConfig(**kw))
    _assert_topo_equal(tt, jmonaco.build_monaco_topology(JEnvConfig(**kw)))
    if not kw.get("link_delay_sec"):
        assert (tt.n_node, tt.n_lane, tt.phase_gate.shape) == \
            (28, 148, (28, 6, 148))
        assert (tt.lane_delay.min(), tt.lane_delay.max()) == (7, 18)
        # exit movements: all-zero route rows
        assert (tt.route.sum(1) < 1e-6).sum() > 0


def test_network_data_loader_roundtrip_and_phase_override(tmp_path):
    """The loader round trip rebuilds the default topology, and a phase
    override lands in the phase tables, in both packages alike."""
    path = tmp_path / "net.json"
    data = {"nodes": [{"x": float(x), "y": float(y)}
                      for x, y in monaco.NODE_XY],
            "edges": [list(e) for e in monaco.EDGES],
            "entry_nodes": list(monaco.ENTRY_NODES),
            "phases": {str(k): v for k, v in monaco.DEFAULT_PHASES.items()}}
    path.write_text(json.dumps(data))
    cfg = EnvConfig(scenario="real_net", episode_length_sec=300)
    loaded = dataclasses.replace(cfg, network_data=str(path))
    _assert_topo_equal(monaco.build_monaco_topology(loaded),
                       monaco.build_monaco_topology(cfg))
    data["phases"] = {"0": [[1, 7]]}
    path.write_text(json.dumps(data))
    ovr = monaco.build_monaco_topology(loaded)
    _assert_topo_equal(ovr, jmonaco.build_monaco_topology(JEnvConfig(
        scenario="real_net", episode_length_sec=300,
        network_data=str(path))))
    assert int(ovr.phase_valid[0].sum()) == 1
    assert monaco.RealNetEnv(loaded, device="cpu").spec.n_a_ls[0] == 1


@pytest.mark.parametrize("kw", [
    dict(objective="queue"), dict(objective="hybrid"),
    dict(objective="wait", phase_in_obs=True, queue_in_obs=True)],
    ids=["queue", "hybrid", "wait-phase-queue"])
def test_env_spec_equals_jax(kw):
    kw = dict(scenario="real_net", coop_gamma=0.9, **kw)
    js = jmonaco.RealNetEnv(JEnvConfig(**kw)).spec
    ts = monaco.RealNetEnv(EnvConfig(**kw), device="cpu").spec
    assert (ts.n_agent, ts.n_s_ls, ts.n_a_ls, ts.coop_gamma) == \
        (js.n_agent, js.n_s_ls, js.n_a_ls, js.coop_gamma)
    assert min(ts.n_a_ls) == 2 and max(ts.n_a_ls) == 6
    for f in ("neighbor_mask", "distance_mask", "obs_mask", "action_mask"):
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    assert np.array_equal(ts.spatial_discount(), js.spatial_discount())


def _envs(env_kw):
    return (jmonaco.RealNetEnv(JEnvConfig(**env_kw)),
            monaco.RealNetEnv(EnvConfig(**env_kw), device="cpu"))


@pytest.mark.parametrize("kw", [
    dict(objective="queue"), dict(objective="hybrid"),
    dict(objective="hybrid", phase_in_obs=True, queue_in_obs=True)],
    ids=["queue", "hybrid", "hybrid-phase-queue"])
def test_monaco_step_for_step_across_reset(kw):
    """B=3 envs over 30 recorded random actions drawn from 0..5, so most
    nodes (2 to 4 phases) also see invalid ones, which the engine clamps to
    the node's last phase; 100 s episodes = 20 steps, so the run crosses an
    auto-reset. The demand is raised so that queues, waits, spillback and
    the 18-row transit ring all carry vehicles."""
    env_kw = dict(scenario="real_net", coop_gamma=0.9,
                  episode_length_sec=100, peak_flow1=3000.0,
                  peak_flow2=2500.0, **kw)
    jenv, tenv = _envs(env_kw)
    assert tenv.max_delay == 18
    jwrap, twrap = JAutoReset(jenv), AutoResetEnv(tenv)
    B, steps = 3, 30
    acts = np.random.default_rng(0).integers(0, 6, (steps, B, 28))
    n_a = np.asarray(tenv.spec.n_a_ls)
    assert (acts >= n_a).any()
    jstate, jobs = jax.vmap(jwrap.reset)(
        jax.random.split(jax.random.key(0), B))
    tstate, tobs = twrap.reset(B)
    _compare(tstate, jstate.env, "reset state")
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-5)
    jstep = jax.jit(jax.vmap(jwrap.step))
    n_done = 0
    for t in range(steps):
        jstate, jobs, jr, jd, jinfo = jstep(jstate, acts[t].astype(np.int32))
        tstate, tobs, tr, td, tinfo = twrap.step(tstate,
                                                 torch.tensor(acts[t]))
        what = f"step {t}"
        _compare(tstate, jstate.env, what)
        # the clamp: the phase now showing is valid for its node
        assert (tstate.prev_phase.numpy() < n_a).all(), what
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-5,
                                   err_msg=f"{what} obs")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                                   rtol=1e-6, err_msg=f"{what} reward")
        assert np.array_equal(td.numpy(), np.asarray(jd)), what
        assert tinfo.keys() == jinfo.keys()
        for k in jinfo:
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                       atol=1e-5, rtol=1e-6,
                                       err_msg=f"{what} info {k}")
        n_done += int(td.sum())
    assert n_done == 3
    assert float(tinfo["throughput"].sum()) > 0


def test_hybrid_obs_packed_per_node():
    """Ragged lane counts: node i's obs is [wave(k_i), wait(k_i), 0 pad],
    so its first ``n_s_ls[i]`` dims are its valid features."""
    env = monaco.RealNetEnv(EnvConfig(scenario="real_net", coop_gamma=0.9,
                                      objective="hybrid", peak_flow1=3000.0),
                            device="cpu")
    s, obs = env.reset(2)
    for _ in range(6):
        s, obs, *_ = env.step(s, env.greedy_action(s))
    c = env.cfg
    q = (s.queue + s.transit.sum(1)).numpy()
    w = s.wait.numpy()
    assert q.max() > 0
    for b in range(2):
        for i, lanes in enumerate(env.topo.node_lanes):
            k = len(lanes)
            assert env.spec.n_s_ls[i] == 2 * k
            np.testing.assert_allclose(
                obs[b, i, :k], np.clip(q[b, lanes] / c.norm_wave, 0,
                                       c.clip_wave), rtol=1e-6)
            np.testing.assert_allclose(
                obs[b, i, k:2 * k], np.clip(w[b, lanes] / c.norm_wait, 0,
                                            c.clip_wait), rtol=1e-6)
            assert not obs[b, i, 2 * k:].any()


@pytest.mark.parametrize("on,delta", [("wave", 0.0), ("wave", 4.0),
                                      ("queue", 0.0), ("queue", 3.0)])
def test_greedy_and_controller_actions_match_jax(on, delta):
    """``greedy_action`` and ``controller_action`` (``hysteresis_on`` /
    ``hysteresis_delta`` from the config; the ``*_net.ini`` files use wave
    and 4) with padded phases, on every state of a random-action run."""
    env_kw = dict(scenario="real_net", coop_gamma=0.9, peak_flow1=3000.0,
                  peak_flow2=2500.0, hysteresis_on=on,
                  hysteresis_delta=delta)
    jenv, tenv = _envs(env_kw)
    B, steps = 3, 25
    acts = np.random.default_rng(3).integers(0, 6, (steps, B, 28))
    n_a = np.asarray(tenv.spec.n_a_ls)
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    tstate, _ = tenv.reset(B)
    jgreedy = jax.jit(jax.vmap(lambda s: jenv.greedy_action(s, on, delta)))
    jctrl = jax.jit(jax.vmap(jenv.controller_action))
    jstep = jax.jit(jax.vmap(jenv.step))
    n_switch = 0
    for t in range(steps + 1):
        ta = tenv.greedy_action(tstate, on, delta).numpy()
        assert np.array_equal(ta, np.asarray(jgreedy(jstate))), f"step {t}"
        assert (ta < n_a).all()
        tc = tenv.controller_action(tstate).numpy()
        assert np.array_equal(tc, np.asarray(jctrl(jstate))), f"step {t}"
        assert np.array_equal(tc, ta)
        n_switch += int((ta != tstate.prev_phase.numpy()).sum())
        if t < steps:
            jstate = jstep(jstate, acts[t].astype(np.int32))[0]
            tstate = tenv.step(tstate, torch.tensor(acts[t]))[0]
    assert n_switch > 0


def test_record_matches_jax():
    jenv, tenv = _envs(dict(scenario="real_net", coop_gamma=0.9,
                            peak_flow1=3000.0))
    B = 2
    acts = np.random.default_rng(4).integers(0, 6, (12, B, 28))
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    tstate, _ = tenv.reset(B)
    jstep = jax.jit(jax.vmap(jenv.step))
    for t in range(12):
        jstate = jstep(jstate, acts[t].astype(np.int32))[0]
        tstate = tenv.step(tstate, torch.tensor(acts[t]))[0]
    jrec, trec = jax.vmap(jenv.record)(jstate), tenv.record(tstate)
    assert trec.keys() == jrec.keys()
    for k in jrec:
        assert trec[k].shape == jrec[k].shape, k
        np.testing.assert_allclose(trec[k].numpy(), np.asarray(jrec[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(trec["total_queue"].sum()) > 0


@pytest.mark.parametrize("agent,model_kw", [
    ("ma2c_nc", dict(sparse_comm=True, remat=True)),
    ("ia2c_cu", dict(consensus_masked=True))])
def test_train_step_matches_jax_on_monaco(agent, model_kw):
    """Two updates against JAX with JAX's Gumbel noise: ragged obs and
    action masks through the policy, the sampler and (IA2C_CU) the masked
    consensus. The sampler never picks a padded phase."""
    jfns, jts, tfns, tts = _build_pair(agent, MONACO_KW, **model_kw)
    assert tfns.spec.n_agent == 28 and tfns.spec.n_a_max == 6
    seen = []
    # the functions close over the env that _build_pair made
    tenv = tfns.train_step.__closure__ and next(
        c.cell_contents for c in tfns.train_step.__closure__
        if isinstance(c.cell_contents, monaco.RealNetEnv))
    step = tenv.step
    tenv.step = lambda s, a: (seen.append(a.clone()), step(s, a))[1]
    _assert_updates_match(jfns, jts, tfns, tts)
    acts = torch.stack(seen)
    assert acts.shape == (16, 4, 28)
    n_a = torch.as_tensor(tenv.spec.n_a_ls)
    assert (acts < n_a).all() and (acts >= 0).all()
    assert len(acts.unique()) > 2


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_eval_episode_matches_jax_on_monaco(greedy):
    jfns, jparams, tfns, tparams, g = _pair("ma2c_nc", MONACO_KW)
    jout = jfns.eval_episode(jparams, jax.random.key(7), HORIZON, greedy)
    tout = tfns.eval_episode(tparams, 7, HORIZON, greedy, gumbel=g)
    _assert_same(tout, jout, rtol=1e-4)
    assert float(tout["episode_len"]) == 12.0


@pytest.mark.parametrize("policy", ["sample", "controller"])
def test_record_episode_matches_jax_on_monaco(policy):
    jfns, jparams, tfns, tparams, g = _pair("ia2c_fp", MONACO_KW)
    if policy == "controller":
        jparams = tparams = None
    jout = jfns.record_episode(jparams, jax.random.key(7), HORIZON, policy)
    tout = tfns.record_episode(tparams, 7, HORIZON, policy=policy, gumbel=g)
    _assert_same(tout, jout)
    n_a = torch.as_tensor(tfns.spec.action_mask.sum(1)).long()
    assert (tout["action"] < n_a).all()


@pytest.mark.parametrize("path", INI, ids=os.path.basename)
def test_every_config_file_takes_an_update(path):
    """All 24 ``configs/*.ini`` files build their env and agent through the
    CLI's ``init_env`` / ``init_agent`` and take one update, at the file's
    widths with the rollout cut to T=4, B=2."""
    cfg = load_config(path)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, batch_size=4, num_envs=2),
        train=TrainConfig(total_step=1000))
    env = init_env(cfg, device="cpu")
    fns = init_agent(env, cfg, device="cpu")
    ts, m = fns.train_step(fns.init_state(cfg.env.seed))
    assert np.isfinite(float(m["loss"])) and ts.step == 8
    if cfg.scenario == "real_net":
        assert env.spec.n_agent == 28 and fns.spec.n_lstm == 64
