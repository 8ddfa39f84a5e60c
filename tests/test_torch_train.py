"""The port's fused MA2C_NC train step on grid-25 against the JAX package.

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
from deeprl_network_tpu.envs.grid import LargeGridEnv as JLargeGridEnv
from deeprl_network_tpu.utils.rollout import make_a2c as jmake_a2c
from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.utils.convert import params_from_jax
from deeprl_network_tpu_torch.utils.rollout import make_a2c

METRICS = ("loss", "policy_loss", "value_loss", "entropy", "grad_norm",
           "episode_return")


def _build(sparse, remat, dtype="float32"):
    env_kw = dict(scenario="large_grid", coop_gamma=0.9,
                  episode_length_sec=60)
    model_kw = dict(batch_size=8, num_envs=4, num_fc=16, num_lstm=16,
                    sparse_comm=sparse, remat=remat, compute_dtype=dtype)
    jfns = jmake_a2c(JLargeGridEnv(JEnvConfig(**env_kw)),
                     JModelConfig(**model_kw),
                     JTrainConfig(total_step=10_000), agent="ma2c_nc")
    tfns = make_a2c(LargeGridEnv(EnvConfig(**env_kw), device="cpu"),
                    ModelConfig(**model_kw), TrainConfig(total_step=10_000),
                    agent="ma2c_nc", device="cpu")
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


@pytest.mark.parametrize("sparse,remat", [(False, False), (True, True)])
def test_train_step_matches_jax(sparse, remat):
    jfns, jts, tfns, tts = _build(sparse, remat)
    for jts, jm, tts, tm in _run_both(jfns, jts, tfns, tts):
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
        jl = [np.asarray(x) for x in jax.tree.leaves(jts.params)]
        tl = [x.numpy() for x in tree_leaves(tts.params)]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, atol=1e-5)
    # the second update crossed an episode end
    assert float(tm["episode_len"]) == 12.0


@pytest.mark.parametrize("agent,model_kw,call", [
    ("ma2c_nc", dict(fused_grad=False), None),
    ("ia2c_cu", {}, None),
    ("ma2c_cnet", {}, None),
    ("ia2c_fp", {}, None),
    ("ma2c_dial", {}, None),
    ("ma2c_nc", dict(neighbor_obs=True), None),
    ("ma2c_nc", dict(switch_penalty=1.0), None),
    ("ma2c_nc", dict(kickstart_coef=1.0), None),
    ("ma2c_nc", dict(axis_name="data"), None),
    ("ma2c_nc", {}, "eval_episode"),
    ("ma2c_nc", {}, "record_episode"),
])
def test_unported_paths_raise(agent, model_kw, call):
    """What this slice does not port raises, pointing at ROADMAP.md."""
    model_kw = dict(model_kw)
    axis = model_kw.pop("axis_name", None)
    env = LargeGridEnv(EnvConfig(scenario="large_grid", coop_gamma=0.9),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fns = make_a2c(env, ModelConfig(num_envs=2, **model_kw),
                       TrainConfig(), agent=agent, axis_name=axis,
                       device="cpu")
        getattr(fns, call)(None, 0)


def test_train_step_bf16_tracks_jax():
    jfns, jts, tfns, tts = _build(True, True, "bfloat16")
    jts, jm, tts, tm = next(_run_both(jfns, jts, tfns, tts, n_updates=1))
    loss = float(tm["loss"])
    assert np.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in tree_leaves(tts.params))
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=0.05)
