"""The port's train step against the JAX package: MA2C_NC on grid-25 (dense
and sparse + remat, f32 and bf16), then every one of the six families on the
grid and MA2C_NC and IA2C_CU on the CACC platoon.

Both packages start from the same params (converted from JAX) and take the
same actions: the port is fed the Gumbel noise that the JAX step draws from
its per-env keys (rollout.py ``_split_env_keys`` + ``jax.random.categorical``
= argmax(logits + gumbel)). Two updates of T=8 steps over 12-step episodes,
so the second update crosses an auto-reset. f32 is held at rtol 1e-4 on the
metrics and atol 1e-5 on every param; bf16 (other rounding points in the
two frameworks) at 0.05 relative on the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprl_network_tpu.config import (
    EnvConfig as JEnvConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from deeprl_network_tpu.envs.cacc import CACCEnv as JCACCEnv
from deeprl_network_tpu.envs.grid import LargeGridEnv as JLargeGridEnv
from deeprl_network_tpu.envs.monaco import RealNetEnv as JRealNetEnv
from deeprl_network_tpu.utils.rollout import make_a2c as jmake_a2c
from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.utils.convert import params_from_jax
from deeprl_network_tpu_torch.utils.rollout import make_a2c

METRICS = ("loss", "policy_loss", "value_loss", "entropy", "grad_norm",
           "episode_return")


AGENTS = ["ia2c", "ia2c_fp", "ia2c_cu", "ma2c_nc", "ma2c_cnet", "ma2c_dial"]
GRID_KW = dict(scenario="large_grid", coop_gamma=0.9, episode_length_sec=60)
# 12-step episodes; no initial noise: the packages draw it from different
# generators, and under auto-reset it cannot be injected
CACC_KW = dict(scenario="cacc_slowdown", coop_gamma=0.9, episode_length=12,
               init_noise_h=0.0, init_noise_v=0.0)


def _build_pair(agent, env_kw, **model_kw):
    """(JAX fns, JAX state, port fns, port state) of one agent on the grid,
    Monaco or the platoon, from the same params."""
    model_kw = dict(dict(batch_size=8, num_envs=4, num_fc=16, num_lstm=16),
                    **model_kw)
    if env_kw["scenario"].startswith("cacc"):
        jenv = JCACCEnv(JEnvConfig(**env_kw))
        tenv = CACCEnv(EnvConfig(**env_kw), device="cpu")
    elif env_kw["scenario"] == "real_net":
        jenv = JRealNetEnv(JEnvConfig(**env_kw))
        tenv = RealNetEnv(EnvConfig(**env_kw), device="cpu")
    else:
        jenv = JLargeGridEnv(JEnvConfig(**env_kw))
        tenv = LargeGridEnv(EnvConfig(**env_kw), device="cpu")
    jfns = jmake_a2c(jenv, JModelConfig(**model_kw),
                     JTrainConfig(total_step=10_000), agent=agent)
    tfns = make_a2c(tenv, ModelConfig(**model_kw),
                    TrainConfig(total_step=10_000), agent=agent,
                    device="cpu")
    jts = jfns.init_state(jax.random.key(0))
    # a 0.01-scale actor makes the policy near-uniform, and with it the
    # fingerprints; scale it up so their reset on done is visible
    p = jts.params
    jts = jfns.init_state(jax.random.key(0), params=p._replace(
        actor=p.actor._replace(w=p.actor.w * 100.0)))
    tts = tfns.init_state(
        0, params=params_from_jax(jax.tree.map(np.asarray, jts.params),
                                  "cpu"))
    return jfns, jts, tfns, tts


def _build(sparse, remat, dtype="float32"):
    return _build_pair("ma2c_nc", GRID_KW, sparse_comm=sparse, remat=remat,
                       compute_dtype=dtype)


def _jax_gumbel(keys: np.ndarray, T: int, N: int, A: int) -> np.ndarray:
    """[T, B, N, A] noise the JAX train step draws from per-env keys."""
    split = jax.vmap(jax.random.split)
    draw = jax.vmap(lambda k: jax.random.gumbel(k, (N, A), jnp.float32))
    k, out = jnp.asarray(keys), []
    for _ in range(T):
        ks = split(k)
        k = ks[:, 0]
        out.append(np.asarray(draw(ks[:, 1])))
    return np.stack(out)


def _run_both(jfns, jts, tfns, tts, n_updates=2):
    spec = tfns.spec
    for _ in range(n_updates):
        # copy before the JAX call: train_step donates its argument
        keys = np.asarray(jts.key).copy()
        g = _jax_gumbel(keys, 8, spec.n_agent, spec.n_a_max)
        jts, jm = jfns.train_step(jts)
        tts, tm = tfns.train_step(tts, gumbel=torch.as_tensor(g))
        yield jts, jm, tts, tm


def _assert_updates_match(jfns, jts, tfns, tts, metrics=METRICS,
                          episode_len=12.0):
    """Two updates: the metrics at rtol 1e-4 (and the same set of them),
    every param at atol 1e-5; the second update crosses an episode end
    (of ``episode_len`` steps)."""
    for jts, jm, tts, tm in _run_both(jfns, jts, tfns, tts):
        assert tm.keys() == jm.keys()
        for k in metrics:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        jl = [np.asarray(x) for x in jax.tree.leaves(jts.params)]
        tl = [x.numpy() for x in tree_leaves(tts.params)]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, atol=1e-5)
    assert float(tm["episode_len"]) == episode_len
    return jts, tts


@pytest.mark.parametrize("sparse,remat", [(False, False), (True, True)])
def test_train_step_matches_jax(sparse, remat):
    _assert_updates_match(*_build(sparse, remat))


@pytest.mark.parametrize("agent", AGENTS)
def test_train_step_families_match_jax_on_grid(agent):
    """Each family with ``neighbor_obs`` where the family talks to its
    neighbours, sparse + remat for the message families."""
    comm = agent.startswith("ma2c")
    _assert_updates_match(*_build_pair(
        agent, GRID_KW, sparse_comm=comm, remat=comm,
        neighbor_obs=agent in ("ia2c_fp", "ma2c_dial")))


@pytest.mark.parametrize("agent,masked", [("ma2c_nc", True),
                                          ("ia2c_cu", True),
                                          ("ia2c_cu", False)])
def test_train_step_matches_jax_on_cacc(agent, masked):
    _assert_updates_match(*_build_pair(agent, CACC_KW,
                                       consensus_masked=masked))


@pytest.mark.parametrize("agent,model_kw,call", [
    ("ma2c_nc", dict(axis_name="data"), None),
])
def test_unported_paths_raise(agent, model_kw, call):
    """What the port refuses raises, naming the way out: ``axis_name``
    without the default process group points at ``maybe_initialize``."""
    model_kw = dict(model_kw)
    axis = model_kw.pop("axis_name", None)
    env = LargeGridEnv(EnvConfig(scenario="large_grid", coop_gamma=0.9),
                       device="cpu")
    with pytest.raises(ValueError, match="maybe_initialize"):
        fns = make_a2c(env, ModelConfig(num_envs=2, **model_kw),
                       TrainConfig(), agent=agent, axis_name=axis,
                       device="cpu")
        getattr(fns, call)(None, 0)


@pytest.mark.parametrize("agent", ["ma2c_cnet", "ma2c_dial"])
def test_train_step_bf16_families_track_jax(agent):
    """bf16 compute: COMMNET's neighbour mean and DIAL's messages round in
    the params' dtype; the loss stays within 0.05 of the JAX step's. The JAX
    COMMNET step does not trace in bf16 (its f32 adjacency promotes the
    embedding, and the scan carry changes dtype), so that family's bf16 step
    is held against the JAX f32 step."""
    kw = dict(sparse_comm=True, remat=True, neighbor_obs=True)
    jdtype = "float32" if agent == "ma2c_cnet" else "bfloat16"
    jfns, jts, _, _ = _build_pair(agent, GRID_KW, compute_dtype=jdtype, **kw)
    _, _, tfns, tts = _build_pair(agent, GRID_KW, compute_dtype="bfloat16",
                                  **kw)
    jts, jm, tts, tm = next(_run_both(jfns, jts, tfns, tts, n_updates=1))
    assert all(p.dtype == torch.float32 for p in tree_leaves(tts.params))
    assert tts.carry.h.dtype == torch.bfloat16
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=0.05)


def test_train_step_bf16_tracks_jax():
    jfns, jts, tfns, tts = _build(True, True, "bfloat16")
    jts, jm, tts, tm = next(_run_both(jfns, jts, tfns, tts, n_updates=1))
    loss = float(tm["loss"])
    assert np.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in tree_leaves(tts.params))
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=0.05)
