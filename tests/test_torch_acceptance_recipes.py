"""The three recipes of ``tests/test_acceptance.py`` as the port trains them
on the card (``tests/test_torch_acceptance.py``), held against the JAX
package at a cut size: B=2 envs, T=8 steps, two updates with the JAX step's
Gumbel noise, at the bars of ``tests/test_torch_train.py`` (metrics rtol
1e-4, params atol 1e-5). The budget is cut to 64 env steps so that the
linear lr, entropy and kickstart schedules move inside the two updates. The
3x3 grid's greedy returns over 60 steps match JAX's at 1e-5.

The grid runs 12-step episodes, so the second update crosses an auto-reset.
The platoons keep the recipes' initial noise: the port starts from the JAX
state's draw, and 16-step episodes end at the last step of the second
update, so no draw of either package's own stream enters the window. (A
platoon started without noise sits exactly at equilibrium: its observations
are float residues of order 1e-7 whose sign the two packages' dynamics
round differently, and the embedding's relu kink turns that into gradients
1e-3 apart. That is f32 rounding, not the recipe.)"""

import jax
import numpy as np
import pytest
import torch

from deeprl_network_tpu.config import (
    EnvConfig as JEnvConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from deeprl_network_tpu.envs.cacc import CACCEnv as JCACCEnv
from deeprl_network_tpu.envs.grid import (
    build_grid_topology as jbuild_grid_topology,
)
from deeprl_network_tpu.envs.network import (
    TrafficNetworkEnv as JTrafficNetworkEnv,
)
from deeprl_network_tpu.utils.rollout import make_a2c as jmake_a2c
from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.envs.grid import build_grid_topology
from deeprl_network_tpu_torch.envs.network import TrafficNetworkEnv
from deeprl_network_tpu_torch.scripts.train_atsc import greedy_returns
from deeprl_network_tpu_torch.utils.convert import params_from_jax
from deeprl_network_tpu_torch.utils.rollout import make_a2c
from test_acceptance import (
    _greedy_return as jgreedy_return, _small_grid_env as jsmall_grid_env,
)
from test_torch_cacc import _to_port
from test_torch_train import METRICS, _assert_updates_match

CACC_CUT = dict(episode_length=16)
GRID_RECIPE = dict(scenario="large_grid", coop_gamma=0.9, clip_wave=8.0,
                   phase_in_obs=True, queue_in_obs=True)
RECIPES = {
    "cacc_catchup_ia2c": ("ia2c", dict(scenario="cacc_catchup",
                                       coop_gamma=-1.0, **CACC_CUT),
                          dict(reward_norm=1000.0)),
    "cacc_slowdown_ma2c_nc": ("ma2c_nc", dict(scenario="cacc_slowdown",
                                              coop_gamma=0.9, **CACC_CUT),
                              dict(reward_norm=1000.0, lr_decay="linear")),
    "grid3x3_ma2c_nc_kickstart": (
        "ma2c_nc", dict(GRID_RECIPE, episode_length_sec=60),
        dict(lr_init=2.5e-3, lr_decay="linear", entropy_coef=0.003,
             entropy_decay="linear", reward_norm=2000.0, kickstart_coef=1.0,
             kickstart_ratio=0.5)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(env_kw):
    if env_kw["scenario"].startswith("cacc"):
        return (JCACCEnv(JEnvConfig(**env_kw)),
                CACCEnv(EnvConfig(**env_kw), device="cpu"))
    jcfg, tcfg = JEnvConfig(**env_kw), EnvConfig(**env_kw)
    return (JTrafficNetworkEnv(jcfg, jbuild_grid_topology(jcfg, size=3)),
            TrafficNetworkEnv(tcfg, build_grid_topology(tcfg, size=3),
                              device="cpu"))


@pytest.mark.parametrize("name", list(RECIPES))
def test_acceptance_recipe_matches_jax(name):
    agent, env_kw, recipe = RECIPES[name]
    model_kw = dict(batch_size=8, num_envs=2, **recipe)
    jenv, tenv = _envs(env_kw)
    jfns = jmake_a2c(jenv, JModelConfig(**model_kw),
                     JTrainConfig(total_step=64), agent=agent)
    tfns = make_a2c(tenv, ModelConfig(**model_kw), TrainConfig(total_step=64),
                    agent=agent, device="cpu")
    jts = jfns.init_state(jax.random.key(0))
    # a 0.01-scale actor makes the policy near-uniform; scale it so the
    # sampled actions and the fingerprints depend on the params
    p = jts.params
    jts = jfns.init_state(jax.random.key(0), params=p._replace(
        actor=p.actor._replace(w=p.actor.w * 100.0)))
    tts = tfns.init_state(
        0, params=params_from_jax(jax.tree.map(np.asarray, jts.params),
                                  "cpu"))
    episode_len = 12.0
    if env_kw["scenario"].startswith("cacc"):
        tts.env_state = _to_port(jts.env_state.env)
        tts.obs = torch.tensor(np.asarray(jts.obs))
        episode_len = 16.0
    metrics = METRICS + ("lr", "beta", "step_reward")
    if "kickstart_coef" in recipe:
        metrics += ("kick_ce",)
    _assert_updates_match(jfns, jts, tfns, tts, metrics=metrics,
                          episode_len=episode_len)


@pytest.mark.parametrize("on", ["queue", "wave"])
def test_small_grid_greedy_returns_match_jax(on):
    jenv, _ = jsmall_grid_env()
    tenv = TrafficNetworkEnv(EnvConfig(**GRID_RECIPE),
                             build_grid_topology(EnvConfig(**GRID_RECIPE),
                                                 size=3), device="cpu")
    assert tenv.episode_steps == jenv.episode_steps == 720
    want = jgreedy_return(jenv, 60, on)
    got = greedy_returns(tenv, (0,), 60)[on][0]
    assert got < 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
