"""Auto-reset wrapper (counterpart of ``deeprl_network_tpu/envs/wrappers.py``).

The reference trainer resets an env mid-batch on done. For B batched
instances that becomes a per-env ``torch.where`` between the stepped state
and a fresh reset, or, for an env with ``step_autoreset`` (the ATSC
engine), the same select inside its step kernel."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeprl_network_tpu_torch.envs.base import Env


def _where(pred: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Per-env select: ``pred`` [B] broadcast over x's trailing axes."""
    return torch.where(pred.reshape(pred.shape + (1,) * (x.ndim - 1)), x, y)


def _tree_where(pred: torch.Tensor, a, b):
    """Per-env select over the leaves of two batched state NamedTuples."""
    return type(a)(*(_where(pred, x, y) for x, y in zip(a, b)))


class AutoResetEnv:
    """Wraps an :class:`Env`; on done, the returned state/obs are from a
    fresh reset while reward/done describe the terminating transition.
    A data-parallel rank's wrapper serves rows ``[offset, offset + batch)``
    of a global batch of ``total``: every reset draws at the global shape
    and keeps those rows.

    An env whose ``step`` was replaced on the instance (a caller that
    watches the actions) takes the generic path, so that the replacement
    sees every step."""

    def __init__(self, env: Env, offset: int = 0,
                 total: Optional[int] = None):
        self.env = env
        self.spec = env.spec
        self.offset = offset
        self.total = total

    def reset(self, batch: int, generator: torch.Generator = None):
        return self.env.reset(batch, generator, self.offset, self.total)

    def step(self, state, action: torch.Tensor,
             generator: torch.Generator = None
             ) -> Tuple[object, torch.Tensor, torch.Tensor, torch.Tensor,
                        Dict[str, torch.Tensor]]:
        fused = getattr(self.env, "step_autoreset", None)
        if fused is not None and "step" not in vars(self.env):
            return fused(state, action, generator, self.offset, self.total)
        s2, obs2, reward, done, info = self.env.step(state, action)
        rs, robs = self.reset(action.shape[0], generator)
        env_new = _tree_where(done, rs, s2)
        obs_new = _where(done, robs, obs2)
        return env_new, obs_new, reward, done, info
