"""The harness's only door into the program (``deeprl_network_tpu_torch``):
its env, its A2C functions and its parameter tree, built from a
configuration's file. Nothing here is timed or judged; the traffic runners
time and judge what these build.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional

import torch

from benchmark.reference.policy import PARAM_NAMES


def load_object(path: str):
    """``module:attr`` -> the object."""
    module, _, attr = path.partition(":")
    return getattr(importlib.import_module(module), attr)


def env_config(config: Dict):
    from deeprl_network_tpu_torch.config import EnvConfig
    env = dict(config["env"])
    if "test_seeds" in env:
        env["test_seeds"] = tuple(env["test_seeds"])
    return EnvConfig(**env)


def model_config(config: Dict, num_envs: int):
    from deeprl_network_tpu_torch.config import ModelConfig
    return ModelConfig(**config["model"], **config["assumed"],
                       num_envs=num_envs)


def train_config(config: Dict):
    from deeprl_network_tpu_torch.config import TrainConfig
    return TrainConfig(**config["train"])


def build(config: Dict, num_envs: int, device, **make_kw):
    """(env, A2C functions) of the configuration for ``num_envs`` envs on
    ``device``; ``make_kw`` go to ``make_a2c``."""
    from deeprl_network_tpu_torch.utils.rollout import make_a2c
    env = load_object(config["program_env"])(env_config(config),
                                             device=device)
    fns = make_a2c(env, model_config(config, num_envs), train_config(config),
                   agent=config["agent"], num_envs=num_envs, device=device,
                   **make_kw)
    return env, fns


def to_program(named: Dict[str, torch.Tensor]):
    """The program's parameter tree holding the named tensors."""
    from deeprl_network_tpu_torch.models.layers import FCParams, LSTMParams
    from deeprl_network_tpu_torch.models.policies import PolicyParams
    w_dial = (FCParams(named["w_dial.w"], named["w_dial.b"])
              if "w_dial.w" in named else None)
    return PolicyParams(
        w_obs=FCParams(named["w_obs.w"], named["w_obs.b"]),
        lstm=LSTMParams(named["lstm.wx"], named["lstm.wh"], named["lstm.b"]),
        actor=FCParams(named["actor.w"], named["actor.b"]),
        critic=FCParams(named["critic.w"], named["critic.b"]),
        w_fp=named.get("w_fp"), w_msg=named.get("w_msg"), w_dial=w_dial)


def named(params, leaves: Optional[List[torch.Tensor]] = None
          ) -> Dict[str, torch.Tensor]:
    """The program's parameter tree as named tensors, each named by its
    field and sub-field (``w_obs.w``, ``w_msg``, ``w_dial.b``); with
    ``leaves`` (one tensor a leaf in the tree's leaf order, such as the
    optimizer's state), those in the leaves' place. Raises on a leaf that
    the reference has no name for."""
    it = iter(leaves) if leaves is not None else None
    out = {}
    for field, value in zip(params._fields, params):
        subs = (zip((f"{field}.{s}" for s in value._fields), value)
                if isinstance(value, tuple) else [(field, value)])
        for name, leaf in subs:
            if leaf is None:
                continue
            if name not in PARAM_NAMES:
                raise ValueError(f"the reference has no parameter {name!r}")
            out[name] = leaf if it is None else next(it)
    if it is not None and next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
