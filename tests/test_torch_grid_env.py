"""The port's batched grid ATSC engine against the JAX engine, step for
step under auto-reset, on the same fixed numpy action sequences, and a scan
of T steps against the JAX scan."""

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


@pytest.mark.parametrize("on,delta", [("wave", 0.0), ("queue", 0.0),
                                      ("queue", 3.0), ("wave", 1.5)])
def test_greedy_and_controller_actions_match_jax(on, delta):
    """``greedy_action`` on every state of a 25-step random-action run (the
    reset state, all queues empty, is a five-way tie: both take phase 0),
    and ``controller_action`` with the config's hysteresis."""
    env_kw = dict(scenario="large_grid", coop_gamma=0.9, peak_flow1=3000.0,
                  peak_flow2=2500.0, hysteresis_on=on,
                  hysteresis_delta=delta)
    jenv = jgrid.LargeGridEnv(JEnvConfig(**env_kw))
    tenv = grid.LargeGridEnv(EnvConfig(**env_kw), device="cpu")
    B, steps = 3, 25
    acts = np.random.default_rng(3).integers(0, 5, (steps, B, 25))
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    tstate, _ = tenv.reset(B)
    jgreedy = jax.jit(jax.vmap(lambda s: jenv.greedy_action(s, on, delta)))
    jctrl = jax.jit(jax.vmap(jenv.controller_action))
    jstep = jax.jit(jax.vmap(jenv.step))
    tie = tenv.greedy_action(tstate, on, delta)
    assert tie.dtype == torch.int64 and not tie.any()
    n_switch = 0
    for t in range(steps + 1):
        ja = np.asarray(jgreedy(jstate))
        ta = tenv.greedy_action(tstate, on, delta).numpy()
        assert np.array_equal(ta, ja), f"step {t}"
        assert np.array_equal(tenv.controller_action(tstate).numpy(),
                              np.asarray(jctrl(jstate))), f"step {t}"
        n_switch += int((ta != tstate.prev_phase.numpy()).sum())
        if t < steps:
            jstate = jstep(jstate, acts[t].astype(np.int32))[0]
            tstate = tenv.step(tstate, torch.tensor(acts[t]))[0]
    assert n_switch > 0


def test_greedy_action_masks_invalid_phases_and_breaks_ties_first():
    """Padded phases score -inf before the argmax, and equal scores go to
    the first phase, as ``jnp.argmax`` does."""
    tcfg = EnvConfig(scenario="large_grid")
    topo = grid.build_grid_topology(tcfg, 5)
    topo.phase_valid[:, 0] = 0.0          # phase 0 is now padding
    tenv = TrafficNetworkEnv(tcfg, topo, device="cpu")
    state, _ = tenv.reset(1)
    # empty network: every valid phase serves 0, the first VALID one wins
    assert torch.all(tenv.greedy_action(state) == 1)
    q = state.queue.clone()
    lanes = topo.node_lanes[7]
    q[0, lanes[1]] = 4.0                  # N through: served by phase 0 only
    q[0, lanes[3]] = 4.0                  # E left: phase 3
    q[0, lanes[9]] = 4.0                  # W left: phase 3 as well
    q[0, lanes[0]] = 8.0                  # N left: phase 1, equal to phase 3
    a = tenv.greedy_action(state._replace(queue=q), on="queue")
    assert int(a[0, 7]) == 1


def test_record_matches_jax():
    env_kw = dict(scenario="large_grid", coop_gamma=0.9,
                  episode_length_sec=100)
    jenv = jgrid.LargeGridEnv(JEnvConfig(**env_kw))
    tenv = grid.LargeGridEnv(EnvConfig(**env_kw), device="cpu")
    B = 2
    acts = np.random.default_rng(4).integers(0, 5, (12, B, 25))
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


# ---- a scan of the env under auto-reset, with its actions drawn or given ----

def env_scan(wenv, state, obs, generator, T, actions=None):
    """T steps of ``wenv`` (batched, with auto-reset) from ``state`` under
    ``torch.no_grad()``; returns (state, obs, rewards [T, B, N]). Each
    step's actions are drawn uniformly in [0, n_a_max) from ``generator``
    on the obs' device, unless ``actions`` [T, B, N] are given."""
    B, dev = obs.shape[0], obs.device
    shape = (B, wenv.spec.n_agent)
    rewards = []
    with torch.no_grad():
        for t in range(T):
            a = (actions[t] if actions is not None else
                 torch.randint(0, wenv.spec.n_a_max, shape,
                               generator=generator, device=dev))
            state, obs, r, _, _ = wenv.step(state, a, generator)
            rewards.append(r)
        return state, obs, torch.stack(rewards)


def test_env_scan_equals_jax_scan_on_the_same_actions():
    B, T = 2, 8
    cfg = dict(scenario="large_grid", coop_gamma=0.9)
    jenv = JAutoReset(jgrid.LargeGridEnv(JEnvConfig(**cfg)))
    N = jenv.spec.n_agent
    acts = np.random.default_rng(0).integers(
        0, jenv.spec.n_a_max, (T, B, N)).astype(np.int32)

    @jax.jit
    def jscan(state, acts):
        def body(s, a):
            s2, obs, r, d, info = jax.vmap(jenv.step)(s, a)
            return s2, (obs, r)
        return jax.lax.scan(body, state, acts)

    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    _, (jobs, jr) = jscan(jstate, acts)
    wenv = AutoResetEnv(grid.LargeGridEnv(EnvConfig(**cfg), device="cpu"))
    gen = torch.Generator().manual_seed(0)
    state, obs = wenv.reset(B, gen)
    _, obs, rewards = env_scan(
        wenv, state, obs, gen, T, actions=torch.from_numpy(acts).long())
    assert rewards.shape == (T, B, N)
    assert float(np.abs(np.asarray(jr)).sum()) > 0   # queues formed
    np.testing.assert_allclose(rewards.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs)[-1], atol=1e-5)


def test_env_scan_draws_its_actions_from_the_generator():
    B, T = 3, 4
    wenv = AutoResetEnv(grid.LargeGridEnv(
        EnvConfig(scenario="large_grid", coop_gamma=0.9, peak_flow1=3000.0),
        device="cpu"))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        state, obs = wenv.reset(B, gen)
        outs.append(env_scan(wenv, state, obs, gen, T))
    (s1, o1, r1), (s2, o2, r2) = outs
    assert torch.equal(r1, r2) and torch.equal(o1, o2)
    assert torch.equal(s1.prev_phase, s2.prev_phase)
    assert int(s1.prev_phase.max()) < wenv.spec.n_a_max
    assert len(torch.unique(s1.prev_phase)) > 1
