"""Environment API of the port (counterpart of ``deeprl_network_tpu/envs/base.py``).

The JAX envs are pure functions over one env instance's state, batched with
``vmap``. Here every env is batched natively: the state is a NamedTuple of
``[B, ...]`` tensors on the env's device, and

    state, obs = env.reset(batch, generator)
    state, obs, reward, done, info = env.step(state, action)

advance all B instances at once. A data-parallel rank holds rows
``[offset, offset + batch)`` of a global batch of ``total``: its resets
draw their noise at the global shape and keep those rows
(``reset(batch, generator, offset, total)``, through :func:`uniform_rows`),
so ranks with one seed stay in step and the global batch draws what one
process would. An :class:`Env` instance holds only static
data (graph masks, phase tables, normalizers). :class:`EnvSpec` and
:func:`hop_distances` are numpy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class EnvSpec:
    """Static multi-agent space description (reference env attributes)."""

    n_agent: int
    n_s_ls: Tuple[int, ...]          # per-agent obs dims (pre-padding)
    n_a_ls: Tuple[int, ...]          # per-agent action counts
    neighbor_mask: np.ndarray        # [N, N] {0,1}, no self-loops
    distance_mask: np.ndarray        # [N, N] int hop distances
    coop_gamma: float

    @property
    def n_s_max(self) -> int:
        return max(self.n_s_ls)

    @property
    def n_a_max(self) -> int:
        return max(self.n_a_ls)

    @property
    def obs_mask(self) -> np.ndarray:
        m = np.zeros((self.n_agent, self.n_s_max), np.float32)
        for i, n in enumerate(self.n_s_ls):
            m[i, :n] = 1.0
        return m

    @property
    def action_mask(self) -> np.ndarray:
        m = np.zeros((self.n_agent, self.n_a_max), np.float32)
        for i, n in enumerate(self.n_a_ls):
            m[i, :n] = 1.0
        return m

    def spatial_discount(self) -> np.ndarray:
        """Reward mixing matrix D with r_tilde = D @ r.

        coop_gamma alpha >= 0: D_ij = alpha^d(i,j) (spatial discounting).
        alpha < 0: every agent sees the global sum.
        """
        if self.coop_gamma < 0:
            return np.ones((self.n_agent, self.n_agent), np.float32)
        return np.power(self.coop_gamma,
                        self.distance_mask.astype(np.float32)).astype(np.float32)


def uniform_rows(shape, generator: Optional[torch.Generator], device,
                 offset: int = 0, total: Optional[int] = None
                 ) -> torch.Tensor:
    """U[0, 1) noise of ``shape`` = (batch, ...): rows ``[offset, offset +
    batch)`` of one draw at (``total``, ...) (default: the batch itself)."""
    batch = shape[0]
    total = batch if total is None else total
    u = torch.rand((total,) + tuple(shape[1:]), generator=generator,
                   device=device)
    return u[offset:offset + batch]


class Env:
    """Base class: holds an :class:`EnvSpec`; subclasses implement the
    batched ``reset(batch, generator, offset, total)`` and
    ``step(state, action)``."""

    spec: EnvSpec

    def reset(self, batch: int, generator=None, offset: int = 0,
              total: Optional[int] = None):
        raise TypeError(f"{type(self).__name__} has no batched reset")

    def step(self, state, action):
        raise TypeError(f"{type(self).__name__} has no batched step")

    def record(self, state):
        """Per-step measurement series for evaluation output."""
        return {}

    def prev_action(self, state):
        """[B, N] previous control action, or None."""
        return None

    def controller_action(self, state):
        """The strongest built-in hand controller's action, or None."""
        return None

    # convenience passthroughs matching the reference attribute names
    @property
    def n_agent(self) -> int:
        return self.spec.n_agent

    @property
    def n_s_ls(self):
        return self.spec.n_s_ls

    @property
    def n_a_ls(self):
        return self.spec.n_a_ls

    @property
    def neighbor_mask(self):
        return self.spec.neighbor_mask

    @property
    def distance_mask(self):
        return self.spec.distance_mask

    @property
    def coop_gamma(self):
        return self.spec.coop_gamma


def hop_distances(adj: np.ndarray) -> np.ndarray:
    """All-pairs hop distance from a {0,1} adjacency (BFS / min-plus)."""
    n = adj.shape[0]
    dist = np.full((n, n), n + 1, np.int32)
    np.fill_diagonal(dist, 0)
    dist[adj > 0] = 1
    for _ in range(n):
        new = np.minimum(dist, (dist[:, :, None] + dist[None, :, :]).min(1))
        if np.array_equal(new, dist):
            break
        dist = new
    return dist
