"""The port's batched grid ATSC engine against the JAX engine, step for
step under auto-reset, on the same fixed numpy action sequences."""

import jax
import numpy as np
import pytest
import torch

from deeprl_network_tpu.config import EnvConfig as JEnvConfig
from deeprl_network_tpu.envs import grid as jgrid
from deeprl_network_tpu.envs.network import TrafficNetworkEnv as JNetEnv
from deeprl_network_tpu.envs.wrappers import AutoResetEnv as JAutoReset
from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs import grid
from deeprl_network_tpu_torch.envs.network import TrafficNetworkEnv
from deeprl_network_tpu_torch.envs.wrappers import AutoResetEnv

TOPO_FIELDS = ("lane_node", "phase_gate", "phase_valid", "route",
               "entry_lane", "demand", "node_adj", "lane_delay")


@pytest.mark.parametrize("size", [5, 10])
def test_topology_equals_jax_builders(size):
    kw = dict(scenario="large_grid", coop_gamma=0.9)
    jt = jgrid.build_grid_topology(JEnvConfig(**kw), size)
    tt = grid.build_grid_topology(EnvConfig(**kw), size)
    assert tt.n_node == jt.n_node and tt.node_lanes == jt.node_lanes
    for f in TOPO_FIELDS:
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_env_spec_equals_jax():
    kw = dict(scenario="large_grid", coop_gamma=0.9)
    js = jgrid.LargeGridEnv(JEnvConfig(**kw)).spec
    ts = grid.LargeGridEnv(EnvConfig(**kw), device="cpu").spec
    assert (ts.n_s_ls, ts.n_a_ls, ts.coop_gamma) == \
        (js.n_s_ls, js.n_a_ls, js.coop_gamma)
    for f in ("neighbor_mask", "distance_mask", "obs_mask", "action_mask"):
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    assert np.array_equal(ts.spatial_discount(), js.spatial_discount())


def _compare(tree_t, tree_j, what):
    for name, a in tree_t._asdict().items():
        np.testing.assert_allclose(a.numpy().astype(np.float64),
                                   np.asarray(getattr(tree_j, name),
                                              np.float64),
                                   atol=1e-5, err_msg=f"{what} {name}")


def _run(env_kw, size, steps, B=3, seed=0):
    jcfg, tcfg = JEnvConfig(**env_kw), EnvConfig(**env_kw)
    jenv = JAutoReset(JNetEnv(jcfg, jgrid.build_grid_topology(jcfg, size)))
    tenv = AutoResetEnv(TrafficNetworkEnv(
        tcfg, grid.build_grid_topology(tcfg, size), device="cpu"))
    M = size * size
    acts = np.random.default_rng(seed).integers(0, 5, (steps, B, M))
    jstate, jobs = jax.vmap(jenv.reset)(
        jax.random.split(jax.random.key(seed), B))
    tstate, tobs = tenv.reset(B)
    _compare(tstate, jstate.env, "reset state")
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-5)
    jstep = jax.jit(jax.vmap(jenv.step))
    n_done = 0
    for t in range(steps):
        jstate, jobs, jr, jd, jinfo = jstep(jstate, acts[t].astype(np.int32))
        tstate, tobs, tr, td, tinfo = tenv.step(tstate, torch.tensor(acts[t]))
        what = f"step {t}"
        _compare(tstate, jstate.env, what)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-5,
                                   err_msg=f"{what} obs")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                                   err_msg=f"{what} reward")
        assert np.array_equal(td.numpy(), np.asarray(jd)), what
        assert tinfo.keys() == jinfo.keys()
        for k in jinfo:
            np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                       atol=1e-5, rtol=1e-6,
                                       err_msg=f"{what} info {k}")
        n_done += int(td.sum())
    return n_done


def test_grid25_step_for_step_across_reset():
    # 100 s episodes = 20 control steps: 30 steps cross an auto-reset
    n_done = _run(dict(scenario="large_grid", coop_gamma=0.9,
                       episode_length_sec=100), 5, 30)
    assert n_done == 3


def test_grid100_step_for_step():
    _run(dict(scenario="large_grid", coop_gamma=0.9), 10, 5)


def test_obs_channels_and_hybrid_reward_step_for_step():
    _run(dict(scenario="large_grid", coop_gamma=0.9, queue_in_obs=True,
              phase_in_obs=True, objective="hybrid", episode_length_sec=40),
         5, 10, seed=1)


def test_reset_draws_queues_when_init_density_positive():
    env = grid.LargeGridEnv(EnvConfig(scenario="large_grid",
                                      init_density=0.5), device="cpu")
    s1, _ = env.reset(2, torch.Generator().manual_seed(0))
    s2, _ = env.reset(2, torch.Generator().manual_seed(0))
    assert torch.equal(s1.queue, s2.queue)
    assert 0 < float(s1.queue.max()) <= 0.5 * 40.0
