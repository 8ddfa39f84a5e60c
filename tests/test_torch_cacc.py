"""The port's batched CACC platoon against the JAX env, step for step under
fixed numpy action sequences, for both scenarios and both ``v_target``s,
through a collision and through the horizon (under auto-reset, with the
initial noise set to 0 because the two packages draw it from different
generators), plus the hand controller on every visited state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprl_network_tpu.config import EnvConfig as JEnvConfig
from deeprl_network_tpu.envs.cacc import CACCEnv as JCACCEnv
from deeprl_network_tpu.envs.wrappers import AutoResetEnv as JAutoReset
from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs.cacc import OVM_GAINS, CACCEnv, CACCState
from deeprl_network_tpu_torch.envs.wrappers import AutoResetEnv

TOL = dict(rtol=1e-5, atol=1e-5)
# a free-running f32 trajectory of quantities near 30 drifts from the other
# framework's by a few ulps a step (cos, fused multiply-adds)
TOL_FREE = dict(rtol=1e-5, atol=3e-4)


def _envs(**kw):
    return JCACCEnv(JEnvConfig(**kw)), CACCEnv(EnvConfig(**kw), device="cpu")


def _compare_state(ts, js, what, tol=TOL):
    for name, a in ts._asdict().items():
        np.testing.assert_allclose(
            a.numpy().astype(np.float64),
            np.asarray(getattr(js, name), np.float64), **tol,
            err_msg=f"{what} {name}")


def _to_port(js) -> CACCState:
    """A JAX CACCState (batched) as the port's."""
    return CACCState(
        h=torch.tensor(np.asarray(js.h)), v=torch.tensor(np.asarray(js.v)),
        u=torch.tensor(np.asarray(js.u)),
        v_lead=torch.tensor(np.asarray(js.v_lead)),
        t=torch.tensor(np.asarray(js.t, np.int64)),
        done=torch.tensor(np.asarray(js.done)))


@pytest.mark.parametrize("v_target", ["profile", "fixed"])
@pytest.mark.parametrize("scenario", ["cacc_catchup", "cacc_slowdown"])
def test_step_for_step_through_collision_and_horizon(scenario, v_target):
    """B = 4 platoons for 130 steps of 100-step episodes: env 0 coasts
    (gains 0, which in slow-down runs into the leader), env 1 takes the
    full-gain law, envs 2-3 random gains. Every done, by collision or by
    horizon, auto-resets and the comparison goes on. Each step is held to
    1e-5 from the JAX run's own state (state, obs, reward, done, info and
    the hand controller's action); the port's free-running trajectory is
    held to the JAX one at ``TOL_FREE``."""
    jenv, tenv = _envs(scenario=scenario, v_target=v_target, coop_gamma=0.9,
                       episode_length=100, init_noise_h=0.0,
                       init_noise_v=0.0)
    jwrap, twrap = JAutoReset(jenv), AutoResetEnv(tenv)
    B, steps, n = 4, 130, 8
    acts = np.random.default_rng(0).integers(0, 4, (steps, B, n))
    acts[:, 0], acts[:, 1] = 0, 3
    jstate, jobs = jax.vmap(jwrap.reset)(
        jax.random.split(jax.random.key(0), B))
    tstate, tobs = twrap.reset(B)
    _compare_state(tstate, jstate.env, "reset")
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
    jstep = jax.jit(jax.vmap(jwrap.step))
    jctrl = jax.jit(jax.vmap(jenv.controller_action))
    n_collision = n_horizon = 0
    for t in range(steps):
        what = f"step {t}"
        forced = _to_port(jstate.env)
        assert np.array_equal(tenv.controller_action(forced).numpy(),
                              np.asarray(jctrl(jstate.env))), what
        act = torch.tensor(acts[t])
        jstate, jobs, jr, jd, jinfo = jstep(jstate, acts[t].astype(np.int32))
        fstate, fobs, fr, fd, finfo = twrap.step(forced, act)
        tstate, tobs, tr, td, _ = twrap.step(tstate, act)
        _compare_state(fstate, jstate.env, what)
        _compare_state(tstate, jstate.env, what + " free-running", TOL_FREE)
        np.testing.assert_allclose(fobs.numpy(), np.asarray(jobs), **TOL,
                                   err_msg=f"{what} obs")
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs),
                                   **TOL_FREE, err_msg=f"{what} obs")
        np.testing.assert_allclose(fr.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-4, err_msg=f"{what} reward")
        assert np.array_equal(fd.numpy(), np.asarray(jd)), what
        assert np.array_equal(td.numpy(), np.asarray(jd)), what
        assert finfo.keys() == jinfo.keys()
        for k in jinfo:
            np.testing.assert_allclose(
                finfo[k].numpy().astype(np.float64),
                np.asarray(jinfo[k], np.float64), **TOL,
                err_msg=f"{what} info {k}")
        n_collision += int(finfo["collision"].sum())
        n_horizon += int((fd & ~finfo["collision"]).sum())
    assert n_horizon >= 1
    if scenario == "cacc_slowdown":
        assert n_collision >= 1


def test_collision_reward_is_per_env():
    _, tenv = _envs(scenario="cacc_slowdown", episode_length=600,
                    init_noise_h=0.0, init_noise_v=0.0)
    state, _ = tenv.reset(2)
    # env 0 one step from a collision, env 1 untouched
    h = state.h.clone()
    h[0, 3] = 1.01
    v = state.v.clone()
    v[0, 2] = 0.0
    state = state._replace(h=h, v=v)
    _, _, reward, done, info = tenv.step(
        state, torch.zeros((2, 8), dtype=torch.int64))
    assert info["collision"].tolist() == [True, False]
    assert done.tolist() == [True, False]
    assert torch.all(reward[0] == -1000.0)
    assert torch.all(reward[1] > -1000.0)


def test_spec_and_tables_equal_jax():
    jenv, tenv = _envs(scenario="cacc_catchup", coop_gamma=0.9)
    js, ts = jenv.spec, tenv.spec
    assert (ts.n_agent, ts.n_s_ls, ts.n_a_ls, ts.coop_gamma) == \
        (js.n_agent, js.n_s_ls, js.n_a_ls, js.coop_gamma)
    for f in ("neighbor_mask", "distance_mask", "obs_mask", "action_mask"):
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    assert np.array_equal(ts.spatial_discount(), js.spatial_discount())
    from deeprl_network_tpu.envs.cacc import OVM_GAINS as J_GAINS
    assert np.array_equal(OVM_GAINS, J_GAINS)
    with pytest.raises(ValueError, match="unknown CACC scenario"):
        CACCEnv(EnvConfig(scenario="cacc_merge"), device="cpu")


@pytest.mark.parametrize("scenario", ["cacc_catchup", "cacc_slowdown"])
def test_reset_with_noise_and_record_match_jax(scenario):
    jenv, tenv = _envs(scenario=scenario)
    rng = np.random.default_rng(2)
    nh = rng.uniform(-1, 1, (3, 8)).astype(np.float32)
    nv = rng.uniform(-40, 40, (3, 8)).astype(np.float32)   # clips v to range
    jstate, jobs = jax.vmap(jenv.reset_with_noise)(jnp.asarray(nh),
                                                   jnp.asarray(nv))
    tstate, tobs = tenv.reset_with_noise(nh, nv)
    _compare_state(tstate, jstate, "reset_with_noise")
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
    jrec, trec = jax.vmap(jenv.record)(jstate), tenv.record(tstate)
    assert trec.keys() == jrec.keys()
    for k in jrec:
        np.testing.assert_allclose(trec[k].numpy(), np.asarray(jrec[k]),
                                   **TOL)
    assert np.array_equal(tenv.greedy_action(tstate).numpy(),
                          np.asarray(jax.vmap(jenv.greedy_action)(jstate)))


def test_reset_draws_noise_within_bounds():
    _, tenv = _envs(scenario="cacc_catchup", init_noise_h=1.0,
                    init_noise_v=0.5)
    s1, _ = tenv.reset(64, torch.Generator().manual_seed(0))
    s2, _ = tenv.reset(64, torch.Generator().manual_seed(0))
    assert torch.equal(s1.h, s2.h) and torch.equal(s1.v, s2.v)
    assert float((s1.h[:, 1:] - 20.0).abs().max()) <= 1.0
    assert float((s1.h[:, 0] - 40.0).abs().max()) <= 1.0
    assert 0.5 < float((s1.h[:, 1:] - 20.0).abs().max())
    assert float((s1.v - 15.0).abs().max()) <= 0.5


def test_spacing_greedy_all_inf_row_takes_action_zero():
    """A vehicle whose four candidate gains all end in a collision scores
    all-inf; ``argmin`` then gives 0 in both packages."""
    jenv, tenv = _envs(scenario="cacc_slowdown", v_target="profile")
    n = 8
    h = np.full((1, n), 20.0, np.float32)
    h[0, 2] = 0.5                         # below h_min whatever the gain
    v = np.full((1, n), 30.0, np.float32)
    tstate = CACCState(
        h=torch.tensor(h), v=torch.tensor(v), u=torch.zeros(1, n),
        v_lead=torch.full((1,), 30.0), t=torch.zeros(1, dtype=torch.int64),
        done=torch.zeros(1, dtype=torch.bool))
    ta = tenv.controller_action(tstate)
    from deeprl_network_tpu.envs.cacc import CACCState as JState
    jstate = JState(h=jnp.asarray(h[0]), v=jnp.asarray(v[0]),
                    u=jnp.zeros(n), v_lead=jnp.asarray(30.0, jnp.float32),
                    t=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool))
    ja = np.asarray(jenv.controller_action(jstate))
    assert int(ta[0, 2]) == 0 and int(ja[2]) == 0
    assert np.array_equal(ta[0].numpy(), ja)
    assert int(torch.argmin(torch.full((4,), torch.inf))) == 0
