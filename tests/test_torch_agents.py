"""The port's reference-style agent classes (``models/agents.py``) against
the JAX package's: with the params carried across by ``params_from_jax``
and the Gumbel noise the JAX agent draws from its key, both agents take the
same actions in a host-driven loop over a JAX env; values agree at 1e-5,
``backward`` stats at rtol 1e-4 and every param at atol 1e-5 after two
``n_step`` batches. Also ``save`` / ``load`` and ragged obs packing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprl_network_tpu.config import (
    EnvConfig as JEnvConfig, ModelConfig as JModelConfig,
)
from deeprl_network_tpu.envs.cacc import CACCEnv as JCACCEnv
from deeprl_network_tpu.envs.monaco import RealNetEnv as JRealNetEnv
from deeprl_network_tpu.models import agents as JM
from deeprl_network_tpu_torch.config import ModelConfig
from deeprl_network_tpu_torch.models import agents as TM
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.utils.convert import params_from_jax

MODEL_KW = dict(batch_size=5, num_fc=16, num_lstm=16, reward_norm=1000.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(name):
    if name == "cacc":      # 7-step episodes: the loop crosses an end
        return JCACCEnv(JEnvConfig(scenario="cacc_catchup", coop_gamma=0.9,
                                   episode_length=7))
    return JRealNetEnv(JEnvConfig(scenario="real_net", coop_gamma=0.9,
                                  episode_length_sec=35, objective="hybrid",
                                  peak_flow1=3000.0))


def _pair(cls_name, env, seed=0, **model_kw):
    """(JAX agent, port agent) with the same params."""
    kw = dict(MODEL_KW, **model_kw)
    args = (env.n_s_ls, env.n_a_ls, env.neighbor_mask, env.distance_mask,
            env.coop_gamma)
    jm = getattr(JM, cls_name)(*args, total_step=1000,
                               model_config=JModelConfig(**kw), seed=seed)
    tm = getattr(TM, cls_name)(*args, total_step=1000,
                               model_config=ModelConfig(**kw), seed=seed,
                               device="cpu")
    # a 0.01-scale actor makes the policy near-uniform: scale it up so the
    # fingerprints and the action masks matter
    jm.params = jm.params._replace(
        actor=jm.params.actor._replace(w=jm.params.actor.w * 100.0))
    tm.params = params_from_jax(jax.tree.map(np.asarray, jm.params), "cpu")
    return jm, tm


def _jax_noise(jm):
    """[N, A] Gumbel noise the JAX agent's next sampling forward draws."""
    _, k = jax.random.split(jm.key)
    return np.asarray(jax.random.gumbel(
        k, (jm.n_agent, jm.spec.n_a_max), jnp.float32))


@pytest.mark.parametrize("cls_name,env_name", [
    ("IA2C", "cacc"), ("MA2C_NC", "cacc"), ("IA2C_CU", "monaco"),
    ("MA2C_NC", "monaco"), ("IA2C_FP", "cacc"), ("MA2C_DIAL", "cacc"),
    ("MA2C_CNET", "cacc")])
def test_agent_loop_matches_jax(cls_name, env_name):
    env = _env(env_name)
    jm, tm = _pair(cls_name, env)
    n_a = np.asarray(env.n_a_ls)
    state, ob = env.reset(jax.random.key(0))
    done = True
    p0 = tm.params.w_obs.w.clone()
    n_done = 0
    for batch in range(2):
        for _ in range(jm.n_step):
            ob_np = np.asarray(ob)
            g = _jax_noise(jm)
            ja, jv = jm.forward(ob_np, done, out_type="pv")
            ta, tv = tm.forward(ob_np, done, out_type="pv", gumbel=g)
            assert ta.shape == (env.n_agent,) and ta.dtype == np.int64
            assert np.array_equal(ta, ja) and (ta < n_a).all()
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tm.get_policy(), jm.get_policy(),
                                       rtol=1e-5, atol=1e-6)
            state, ob, reward, done, info = env.step(state, jnp.asarray(ja))
            done = bool(done)
            for m, a in ((jm, ja), (tm, ta)):
                m.add_transition(np.asarray(ob), a, np.asarray(reward), None,
                                 float(done))
            if done:
                n_done += 1
                state, ob = env.reset(jax.random.key(1))
        jR = jm.forward(np.asarray(ob), done, out_type="v")
        tR = tm.forward(np.asarray(ob), done, out_type="v")
        np.testing.assert_allclose(tR, jR, rtol=1e-5, atol=1e-5)
        if done:
            jR, tR = np.zeros_like(jR), np.zeros_like(tR)
        jstats, tstats = jm.backward(jR), tm.backward(tR)
        assert tstats.keys() == jstats.keys() == {"total", "policy",
                                                  "value", "entropy"}
        for k in jstats:
            np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{batch} {k}")
        jl = [np.asarray(x) for x in jax.tree.leaves(jm.params)]
        tl = [x.numpy() for x in tree_leaves(tm.params)]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, atol=1e-5)
    assert n_done >= 1 and tm.cur_step == jm.cur_step == 10
    assert tm.opt_state.count == 2 and not torch.equal(p0, tm.params.w_obs.w)


def test_forward_out_types_and_own_noise():
    """``v`` leaves the carry and fingerprints alone; the agent's own draw
    comes from a generator seeded with ``seed`` and respects the action
    mask."""
    env = _env("monaco")
    n_a = np.asarray(env.n_a_ls)
    _, a1 = _pair("MA2C_NC", env, seed=3)
    _, a2 = _pair("MA2C_NC", env, seed=3)
    _, ob = env.reset(jax.random.key(0))
    ob = np.asarray(ob)
    fp0 = a1.get_policy()
    v = a1.forward(ob, True, out_type="v")
    assert v.shape == (28,) and v.dtype == np.float32
    assert np.array_equal(a1.get_policy(), fp0)
    assert not a1.carry.h.any()
    acts = []
    for _ in range(6):
        x, y = a1.forward(ob, False), a2.forward(ob, False, out_type="p")
        assert np.array_equal(x, y) and (x < n_a).all()
        acts.append(x)
    assert len({tuple(a) for a in acts}) > 1
    assert a1.carry.h.any() and a1.get_policy().shape == (28, 6)
    a, v2 = a1.forward(ob, False, out_type="pv")
    assert a.shape == v2.shape == (28,)
    a1.reset()
    assert not a1.carry.h.any() and np.array_equal(a1.get_policy(), fp0)


def test_save_load_roundtrip(tmp_path):
    env = _env("cacc")
    _, m1 = _pair("IA2C_CU", env, seed=0)
    _, m2 = _pair("IA2C_CU", env, seed=99)
    state, ob = env.reset(jax.random.key(0))
    for _ in range(m1.n_step):
        a = m1.forward(np.asarray(ob), False)
        state, ob, reward, done, _ = env.step(state, jnp.asarray(a))
        m1.add_transition(np.asarray(ob), a, np.asarray(reward), None, 0.0)
    m1.backward(m1.forward(np.asarray(ob), False, out_type="v"))
    assert not m2.load(str(tmp_path))
    m1.save(str(tmp_path))              # at cur_step
    m1.save(str(tmp_path), step=7)
    assert m2.load(str(tmp_path), checkpoint=7) and m2.load(str(tmp_path))
    for a, b in zip(tree_leaves(m1.params) + m1.opt_state.ms,
                    tree_leaves(m2.params) + m2.opt_state.ms):
        assert torch.equal(a, b)
    assert m2.opt_state.count == m1.opt_state.count == 1
    assert float(m1.opt_state.ms[0].abs().sum()) > 0


def test_ragged_obs_packing():
    model = TM.IA2C([3, 5], [2, 2], np.eye(2, dtype=np.float32)[::-1],
                    np.array([[0, 1], [1, 0]]), -1.0, total_step=100,
                    model_config=ModelConfig(num_fc=8, num_lstm=8),
                    device="cpu")
    packed = model._pack_obs([np.ones(3), np.ones(5)])
    assert packed.shape == (2, 5) and packed.dtype == torch.float32
    np.testing.assert_allclose(packed[0], [1, 1, 1, 0, 0])
    dense = model._pack_obs(np.arange(10.0).reshape(2, 5))
    assert dense.dtype == torch.float32 and float(dense[1, 4]) == 9.0
    assert model.forward([np.ones(3), np.ones(5)], True).shape == (2,)


def test_class_names_and_comm_types():
    for name in ("IA2C", "IA2C_FP", "IA2C_CU", "MA2C_NC", "MA2C_CNET",
                 "MA2C_DIAL"):
        assert getattr(TM, name).agent_name == \
            getattr(JM, name).agent_name == name.lower()
