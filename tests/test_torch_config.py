"""The port's copy of the config system parses every ``configs/*.ini`` file
exactly as the JAX package's ``load_config`` does."""

import dataclasses
import glob
import os

import pytest

from deeprl_network_tpu import config as jconfig
from deeprl_network_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INI = sorted(glob.glob(os.path.join(ROOT, "configs", "*.ini")))


def test_dataclass_fields_and_defaults_match():
    for name in ("EnvConfig", "ModelConfig", "TrainConfig", "Config"):
        jf = {f.name: f for f in dataclasses.fields(getattr(jconfig, name))}
        tf = {f.name: f for f in dataclasses.fields(getattr(tconfig, name))}
        assert jf.keys() == tf.keys(), name
        for k in jf:
            assert jf[k].type == tf[k].type, (name, k)
    assert dataclasses.asdict(tconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())


@pytest.mark.parametrize("path", INI, ids=os.path.basename)
def test_load_config_matches_jax(path):
    want = jconfig.load_config(path)
    got = tconfig.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.agent == want.agent and got.scenario == want.scenario


def test_invalid_values_raise():
    with pytest.raises(ValueError):
        tconfig.EnvConfig(hysteresis_on="Queue")
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(os.path.join(ROOT, "configs", "missing.ini"))
