"""The plain reference: env engines, the policy and the A2C update in plain
PyTorch and NumPy, float32. It imports nothing
of the program (``deeprl_network_tpu_torch``), of its JAX original, or of
JAX: a configuration's file names its reference env, and the reference is
built from that file alone.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from benchmark.reference.policy import Policy

# the families the reference policy computes, and whether they talk
COMM = {"ia2c": False, "ma2c_nc": True}


def build_reference(config: Dict, device) -> Tuple[object, Policy]:
    """(env, policy) of a configuration's file on ``device``."""
    module, _, attr = config["reference_env"].partition(":")
    if not module.startswith("benchmark.reference."):
        raise ValueError(f"reference env {config['reference_env']!r} lies "
                         "outside benchmark/reference")
    env = getattr(importlib.import_module(module), attr)(config["env"],
                                                         device)
    if config["agent"] not in COMM:
        raise ValueError(f"the reference has no policy for "
                         f"{config['agent']!r}")
    return env, Policy(env.adj, env.action_mask, COMM[config["agent"]],
                       device)
