"""Parameters from the JAX package into the port.

``params_from_jax`` takes the JAX ``PolicyParams`` as a tree of NamedTuples
holding numpy arrays (``jax.tree.map(np.asarray, ts.params)``) and returns
the port's ``PolicyParams`` with the same values on ``device``, so both
packages compute the same function. It matches the NamedTuples by class
name and field order; it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from deeprl_network_tpu_torch.models.layers import FCParams, LSTMParams
from deeprl_network_tpu_torch.models.policies import PolicyParams

_CLASSES = {cls.__name__: cls for cls in (PolicyParams, FCParams,
                                          LSTMParams)}


def params_from_jax(np_params, device="cuda"):
    if np_params is None:
        return None
    if isinstance(np_params, tuple):
        cls = _CLASSES.get(type(np_params).__name__)
        if cls is None or cls._fields != type(np_params)._fields:
            raise TypeError(f"no port counterpart for "
                            f"{type(np_params).__name__}")
        return cls(*(params_from_jax(v, device) for v in np_params))
    return torch.tensor(np.asarray(np_params), device=device)
