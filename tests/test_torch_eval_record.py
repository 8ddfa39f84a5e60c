"""``eval_episode`` and ``record_episode`` of the port against the JAX
package, on the grid and on the CACC platoon: greedy, sampled with the noise
JAX draws from its key, and the hand controller. Same keys, same shapes
``[horizon, ...]``, values at 1e-5 relative to their size (1e-4 on sums over
an episode). The horizon is longer than the episode, so the ``alive``
weighting is exercised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import CACC_KW, GRID_KW, _build_pair

from deeprl_network_tpu_torch.utils.rollout import _default_horizon

HORIZON = 16          # episodes end after 12 steps


def _jax_episode_gumbel(key, horizon: int, N: int, A: int) -> np.ndarray:
    """[horizon, N, A] noise that the JAX eval/record episode draws:
    ``k_env, k_run = split(key)``, then per step ``k_run, k_act =
    split(k_run)`` and ``categorical(k_act, logits)``, which is
    argmax(logits + gumbel(k_act))."""
    _, k = jax.random.split(key)
    out = []
    for _ in range(horizon):
        k, k_act = jax.random.split(k)
        out.append(np.asarray(jax.random.gumbel(k_act, (N, A), jnp.float32)))
    return np.stack(out)


def _pair(agent, env_kw, **model_kw):
    jfns, jts, tfns, tts = _build_pair(agent, env_kw, **model_kw)
    g = torch.tensor(_jax_episode_gumbel(
        jax.random.key(7), HORIZON, tfns.spec.n_agent, tfns.spec.n_a_max))
    return jfns, jts.params, tfns, tts.params, g


def _assert_same(tout, jout, rtol=1e-5):
    assert tout.keys() == jout.keys()
    for k, j in jout.items():
        j = np.asarray(j)
        t = tout[k].numpy()
        assert t.shape == j.shape, k
        if j.dtype.kind in "iub":
            assert np.array_equal(t, j), k
        else:
            np.testing.assert_allclose(
                t, j, rtol=rtol, atol=rtol * max(1.0, float(np.abs(j).max())),
                err_msg=k)


CASES = [("ma2c_nc", GRID_KW, dict(sparse_comm=True)),
         ("ia2c_fp", GRID_KW, dict(neighbor_obs=True)),
         ("ma2c_dial", CACC_KW, {}),
         ("ia2c_cu", CACC_KW, {})]
IDS = ["nc-grid", "fp-grid", "dial-cacc", "cu-cacc"]


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("agent,env_kw,model_kw", CASES, ids=IDS)
def test_eval_episode_matches_jax(agent, env_kw, model_kw, greedy):
    jfns, jparams, tfns, tparams, g = _pair(agent, env_kw, **model_kw)
    jout = jfns.eval_episode(jparams, jax.random.key(7), HORIZON, greedy)
    tout = tfns.eval_episode(tparams, 7, HORIZON, greedy, gumbel=g)
    _assert_same(tout, jout, rtol=1e-4)
    assert float(tout["episode_len"]) <= 12.0
    assert all(v.ndim == 0 for v in tout.values())


@pytest.mark.parametrize("policy", ["greedy", "sample", "controller"])
@pytest.mark.parametrize("agent,env_kw,model_kw", CASES[::2], ids=IDS[::2])
def test_record_episode_matches_jax(agent, env_kw, model_kw, policy):
    jfns, jparams, tfns, tparams, g = _pair(agent, env_kw, **model_kw)
    if policy == "controller":     # needs no params
        jparams = tparams = None
    jout = jfns.record_episode(jparams, jax.random.key(7), HORIZON, policy)
    tout = tfns.record_episode(tparams, 7, HORIZON, policy, gumbel=g)
    _assert_same(tout, jout)
    alive = tout["alive"]
    assert alive.shape == (HORIZON,) and alive[0] == 1 and alive[-1] == 0
    assert tout["action"].shape == (HORIZON, tfns.spec.n_agent)


def test_eval_defaults_sample_and_are_reproducible():
    """Without ``gumbel`` the noise comes from a generator seeded by the
    int: same seed, same episode; and sampling is the default."""
    _, _, tfns, tparams, _ = _pair("ma2c_nc", CACC_KW)
    a = tfns.eval_episode(tparams, 11)
    b = tfns.eval_episode(tparams, 11)
    c = tfns.eval_episode(tparams, torch.Generator().manual_seed(11))
    greedy = tfns.eval_episode(tparams, 11, greedy=True)
    assert float(a["episode_return"]) == float(b["episode_return"]) \
        == float(c["episode_return"])
    assert float(a["episode_return"]) != float(greedy["episode_return"])
    with pytest.raises(ValueError, match="record policy"):
        tfns.record_episode(tparams, 0, policy="best")


def test_eval_keeps_f32_params_under_bf16_training():
    """A bf16 trainer evaluates with its f32 masters: the carry follows the
    params' dtype, so eval equals the f32 trainer's eval exactly."""
    _, _, f32, tparams, g = _pair("ma2c_cnet", GRID_KW)
    _, _, bf16, _, _ = _pair("ma2c_cnet", GRID_KW, compute_dtype="bfloat16")
    a = f32.eval_episode(tparams, 0, HORIZON, gumbel=g)
    b = bf16.eval_episode(tparams, 0, HORIZON, gumbel=g)
    assert float(a["episode_return"]) == float(b["episode_return"])


def test_default_horizon():
    _, _, grid_fns, _, _ = _pair("ia2c", GRID_KW)
    rec = grid_fns.record_episode(None, 0, policy="controller")
    assert rec["reward"].shape == (12, 25)

    class Cfg:
        scenario, episode_length = "cacc_catchup", 33

    class E:
        cfg = Cfg()
    assert _default_horizon(E()) == 33
    assert _default_horizon(object()) == 600
