"""The replay update (``fused_grad=False``) and the training-only shaping
(``switch_penalty``, ``kickstart_coef``) of the port's train step: each
against the JAX package over two updates with the JAX step's Gumbel noise,
the fused update against the replay update inside the port, and the
``ValueError``s of the combinations neither package supports."""

import numpy as np
import pytest
import torch

from test_torch_train import (
    CACC_KW, GRID_KW, _assert_updates_match, _build_pair,
)

from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.utils.rollout import make_a2c

METRICS = ("loss", "policy_loss", "value_loss", "entropy", "grad_norm",
           "episode_return", "step_reward")


@pytest.mark.parametrize("agent,env_kw,model_kw", [
    ("ma2c_nc", GRID_KW, dict(fused_grad=False)),
    ("ma2c_dial", GRID_KW, dict(fused_grad=False, sparse_comm=True,
                                remat=True)),
    ("ia2c_cu", CACC_KW, dict(fused_grad=False)),
    ("ma2c_nc", GRID_KW, dict(switch_penalty=0.5)),
    ("ma2c_nc", GRID_KW, dict(kickstart_coef=0.7, kickstart_ratio=0.01)),
    ("ia2c", GRID_KW, dict(switch_penalty=0.5, kickstart_coef=0.7,
                           remat=True)),
    ("ma2c_nc", CACC_KW, dict(kickstart_coef=0.7)),
], ids=["replay-nc-grid", "replay-dial-grid-sparse-remat", "replay-cu-cacc",
        "switch-penalty", "kickstart-annealed", "both-remat",
        "kickstart-cacc"])
def test_train_step_variants_match_jax(agent, env_kw, model_kw):
    """``kickstart_ratio=0.01`` of 10,000 steps puts the second update
    (step 32 of a 100-step ramp) on the annealed part of the weight."""
    metrics = METRICS + (("kick_ce",) if "kickstart_coef" in model_kw
                         else ())
    _assert_updates_match(*_build_pair(agent, env_kw, **model_kw),
                          metrics=metrics)


def test_switch_penalty_leaves_true_reward_metrics_alone():
    """The penalty enters the training reward only: ``step_reward`` and the
    episode return stay on the true reward, the loss moves."""
    runs = {}
    for pen in (0.0, 5.0):
        _, _, tfns, tts = _build_pair("ma2c_nc", GRID_KW, switch_penalty=pen)
        g = torch.tensor(np.random.default_rng(0).gumbel(
            size=(8, 4, 25, 5)).astype(np.float32))
        runs[pen] = tfns.train_step(tts, gumbel=g)[1]
    assert float(runs[0.0]["step_reward"]) == float(runs[5.0]["step_reward"])
    assert float(runs[0.0]["loss"]) != float(runs[5.0]["loss"])


@pytest.mark.parametrize("agent,env_kw,model_kw", [
    ("ia2c", CACC_KW, {}),
    ("ma2c_nc", GRID_KW, dict(sparse_comm=True)),
    ("ma2c_dial", CACC_KW, dict(remat=True)),
    ("ma2c_cnet", GRID_KW, dict(neighbor_obs=True)),
    ("ia2c_fp", CACC_KW, {}),
    ("ia2c_cu", GRID_KW, {}),
])
def test_fused_update_equals_replay_update(agent, env_kw, model_kw):
    """Inside the port: three updates from the same state and noise through
    both gradient paths give the same loss, params and trajectory."""
    env_cls = CACCEnv if env_kw["scenario"].startswith("cacc") \
        else LargeGridEnv
    env = env_cls(EnvConfig(**env_kw), device="cpu")
    fns = {fused: make_a2c(
        env, ModelConfig(batch_size=8, num_envs=3, num_fc=16, num_lstm=16,
                         fused_grad=fused, **model_kw),
        TrainConfig(total_step=10_000), agent=agent, device="cpu")
        for fused in (True, False)}
    ts = {fused: f.init_state(3) for fused, f in fns.items()}
    rng = np.random.default_rng(5)
    n, a = fns[True].spec.n_agent, fns[True].spec.n_a_max
    for _ in range(3):
        g = torch.tensor(rng.gumbel(size=(8, 3, n, a)).astype(np.float32))
        ts[True], m_f = fns[True].train_step(ts[True], gumbel=g)
        ts[False], m_r = fns[False].train_step(ts[False], gumbel=g)
        assert m_f.keys() == m_r.keys()
        for k in ("loss", "grad_norm", "step_reward"):
            np.testing.assert_allclose(float(m_f[k]), float(m_r[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    for x, y in zip(tree_leaves(ts[True].params),
                    tree_leaves(ts[False].params)):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(ts[True].obs, ts[False].obs)
    torch.testing.assert_close(ts[True].carry.h, ts[False].carry.h)


@pytest.mark.parametrize("env_name,model_kw,match", [
    ("grid", dict(fused_grad=False, compute_dtype="bfloat16"), "bfloat16"),
    ("grid", dict(fused_grad=False, switch_penalty=1.0), "fused-gradient"),
    ("grid", dict(fused_grad=False, kickstart_coef=1.0), "fused-gradient"),
    ("cacc", dict(switch_penalty=1.0), "prev_action"),
])
def test_unsupported_combinations_raise_value_error(env_name, model_kw,
                                                    match):
    """The JAX package's own refusals: bf16 and shaping need the fused
    path, and ``switch_penalty`` needs an env with a persistent action."""
    env = (LargeGridEnv(EnvConfig(**GRID_KW), device="cpu")
           if env_name == "grid"
           else CACCEnv(EnvConfig(**CACC_KW), device="cpu"))
    with pytest.raises(ValueError, match=match):
        make_a2c(env, ModelConfig(num_envs=2, **model_kw), TrainConfig(),
                 agent="ma2c_nc", device="cpu")


def test_kickstart_needs_a_controller():
    from deeprl_network_tpu_torch.envs.base import Env

    class Bare(Env):
        device = torch.device("cpu")
        spec = CACCEnv(EnvConfig(**CACC_KW), device="cpu").spec

    with pytest.raises(ValueError, match="controller_action"):
        make_a2c(Bare(), ModelConfig(kickstart_coef=1.0), TrainConfig(),
                 agent="ia2c", device="cpu")
