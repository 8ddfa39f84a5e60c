"""The plain reference: env engines, the policy and the A2C update in plain
PyTorch and NumPy, float32. It imports nothing
of the program (``deeprl_network_tpu_torch``), of its JAX original, or of
JAX: a configuration's file names its reference env and its ``agent``, and
the reference is built from that file alone.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from benchmark.reference.policy import Policy

# the families the reference policy computes, and their comm types
COMM = {"ia2c": "none", "ia2c_fp": "fp", "ma2c_nc": "neurcomm",
        "ma2c_cnet": "commnet", "ma2c_dial": "dial"}


def build_reference(config: Dict, device) -> Tuple[object, Policy]:
    """(env, policy) of a configuration's file on ``device``."""
    module, _, attr = config["reference_env"].partition(":")
    if not module.startswith("benchmark.reference."):
        raise ValueError(f"reference env {config['reference_env']!r} lies "
                         "outside benchmark/reference")
    agent = config["agent"]
    if agent not in COMM:
        why = " (it has no consensus step)" if agent == "ia2c_cu" else ""
        raise ValueError(f"the reference has no policy for {agent!r}{why}")
    env = getattr(importlib.import_module(module), attr)(config["env"],
                                                         device)
    return env, Policy(env.adj, env.action_mask, COMM[agent], device)
