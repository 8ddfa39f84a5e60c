"""The policy's weights, made on the device from the seed in one draw.

Each weight block is Gaussian with the variance of the published
orthogonal initialisation at the same scale, scale^2 / max(fan_in,
fan_out): sqrt(2) for the observation embedding, the fingerprint and
message blocks and DIAL's message head, 1 for the LSTM and the critic, and
the caller's ``actor_scale`` for the actor (the train cells' 0.01, as at
the start of training). Per-edge blocks [N, N, ., F] (``w_fp``; ``w_msg``
of NeurComm and DIAL) are divided by sqrt(degree) of the receiving agent
and zero between non-neighbours; CommNet's shared map is not. Biases
(``*.b``) are zero, as initialised. The blocks are drawn in
``param_shapes``' order.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference.policy import param_shapes

SQRT2 = math.sqrt(2.0)


def param_seed(seed: int) -> int:
    """The weights' own seed, apart from the noise's (a generator seeded
    alike would draw the same uniforms)."""
    return (seed * 6364136223846793005 + 1442695040888963407) % (2 ** 63)


def make_params(seed: int, adj: np.ndarray, n_s: int, n_a: int, F: int,
                H: int, comm: str, actor_scale: float, device
                ) -> Dict[str, torch.Tensor]:
    n = adj.shape[0]
    shapes = param_shapes(n, n_s, n_a, F, H, comm)
    weights = [(k, s) for k, s in shapes if not k.endswith(".b")]
    gen = torch.Generator(device=device)
    gen.manual_seed(param_seed(seed))
    draw = torch.randn(sum(math.prod(s) for _, s in weights), generator=gen,
                       device=device)
    deg = torch.as_tensor(np.maximum(adj.sum(1), 1.0), dtype=torch.float32,
                          device=device)
    edge = torch.as_tensor(adj, dtype=torch.float32, device=device)
    scale = {"w_obs.w": SQRT2, "lstm.wx": 1.0, "lstm.wh": 1.0,
             "actor.w": actor_scale, "critic.w": 1.0, "w_fp": SQRT2,
             "w_msg": SQRT2, "w_dial.w": SQRT2}
    out, at = {}, 0
    for k, s in shapes:
        if k.endswith(".b"):
            out[k] = torch.zeros(s, device=device)
            continue
        w = draw[at:at + math.prod(s)].view(s)
        at += math.prod(s)
        w = w * (scale[k] / math.sqrt(max(s[-2], s[-1])))
        if len(s) == 4:
            w = w * (edge / deg.sqrt()[:, None])[:, :, None, None]
        out[k] = w.contiguous()
    return out
