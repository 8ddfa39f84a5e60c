"""NN/RL primitives with TF1-parity semantics (counterpart of
``deeprl_network_tpu/models/layers.py``).

- orthogonal weight init with a scale factor, each trailing [in, out] block
  independently orthogonal (per-agent / per-edge stacked weights);
- the reference LSTM step: gates split (i, f, o, u), no forget bias,
  done-masking of the carried (c, h) BEFORE the gates;
- TF1 RMSProp with a global-norm clip, written out by hand: eps INSIDE the
  sqrt and the optax clip form, which ``torch.optim.RMSprop`` and
  ``torch.nn.utils.clip_grad_norm_`` do not reproduce.

Initializers draw from an explicit ``torch.Generator`` on the CPU and move
the result to ``device``.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch


def ortho_init(shape: Tuple[int, ...], scale: float = 1.0,
               dtype=torch.float32, generator: torch.Generator = None,
               device=None) -> torch.Tensor:
    """Orthogonal initializer matching baselines/TF1 ``ortho_init``.

    For >2D shapes the leading axes are treated as batch: each [in, out]
    block is independently orthogonal.
    """
    if len(shape) < 2:
        raise ValueError("ortho_init needs >=2D shape")
    *batch, n_in, n_out = shape
    n_blocks = math.prod(batch) if batch else 1
    a = torch.randn((n_blocks, n_in, n_out), generator=generator)
    u, _, vt = torch.linalg.svd(a, full_matrices=False)
    q = u if u.shape[-2:] == (n_in, n_out) else vt
    w = (scale * q).reshape(*batch, n_in, n_out)
    return w.to(device=device, dtype=dtype)


class FCParams(NamedTuple):
    w: torch.Tensor  # [..., n_in, n_out]
    b: torch.Tensor  # [..., n_out]


def fc_init(n_in: int, n_out: int, scale: float = 1.0,
            batch_shape: Tuple[int, ...] = (), dtype=torch.float32,
            generator: torch.Generator = None, device=None) -> FCParams:
    """fc layer params: ortho W, zero b."""
    w = ortho_init((*batch_shape, n_in, n_out), scale, dtype, generator,
                   device)
    b = torch.zeros((*batch_shape, n_out), dtype=dtype, device=device)
    return FCParams(w, b)


def fc_apply(p: FCParams, x: torch.Tensor) -> torch.Tensor:
    return x @ p.w + p.b


class LSTMParams(NamedTuple):
    wx: torch.Tensor  # [..., n_in, 4*n_h]
    wh: torch.Tensor  # [..., n_h, 4*n_h]
    b: torch.Tensor   # [..., 4*n_h]


def lstm_init(n_in: int, n_h: int, scale: float = 1.0,
              batch_shape: Tuple[int, ...] = (), dtype=torch.float32,
              generator: torch.Generator = None, device=None) -> LSTMParams:
    wx = ortho_init((*batch_shape, n_in, 4 * n_h), scale, dtype, generator,
                    device)
    wh = ortho_init((*batch_shape, n_h, 4 * n_h), scale, dtype, generator,
                    device)
    b = torch.zeros((*batch_shape, 4 * n_h), dtype=dtype, device=device)
    return LSTMParams(wx, wh, b)


def lstm_step(p: LSTMParams, carry: Tuple[torch.Tensor, torch.Tensor],
              x: torch.Tensor, done: torch.Tensor
              ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One LSTM step (reference agents/utils.py ``lstm``).

    carry = (c, h), each [..., n_h]; ``done`` broadcastable to carry[..., 0]
    and applied BEFORE the gates: c,h <- c,h * (1 - done). Gate split order
    is (i, f, o, u); no forget-gate bias.
    """
    c, h = carry
    mask = (1.0 - done)[..., None].to(c.dtype)
    c = c * mask
    h = h * mask
    z = x @ p.wx + h @ p.wh + p.b
    i, f, o, u = torch.chunk(z, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    u = torch.tanh(u)
    c_new = f * c + i * u
    h_new = o * torch.tanh(c_new)
    return (c_new, h_new), h_new


def one_hot(x: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """[..., n] one-hot of integer ``x``; an index outside [0, n) gives a
    zero row, as ``jax.nn.one_hot`` does (``F.one_hot`` raises)."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class RMSPropState(NamedTuple):
    count: int                   # updates applied so far
    ms: List[torch.Tensor]       # running mean of g^2, one per param


class TF1RMSProp:
    """TF1 RMSProp + global-norm clip (reference ``prepare_loss``:
    RMSProp(rmsp_alpha, rmsp_epsilon), clip_by_global_norm(max_grad_norm)).

    ``update`` runs three steps over a list of gradients:
      1. clip: g <- g / norm * max_grad_norm, only when norm >= max_grad_norm;
      2. ms <- decay * ms + (1 - decay) * g^2, with ms starting at 0;
      3. update = -lr(count) * g / sqrt(ms + eps).
    The params then take ``p + update``. Each step is written in the
    operation order of the optax chain the JAX package uses.
    """

    def __init__(self, lr_schedule: Callable[[int], float],
                 decay: float = 0.99, eps: float = 1e-5,
                 max_grad_norm: float = 40.0):
        self.lr_schedule = lr_schedule
        self.decay = decay
        self.eps = eps
        self.max_grad_norm = max_grad_norm

    def init(self, params: Sequence[torch.Tensor]) -> RMSPropState:
        return RMSPropState(0, [torch.zeros_like(p) for p in params])

    def update(self, grads: Sequence[torch.Tensor], state: RMSPropState,
               lr: Optional[torch.Tensor] = None
               ) -> Tuple[List[torch.Tensor], RMSPropState]:
        """``lr``: the learning rate as a device tensor (a CUDA graph's
        update reads it from there); ``lr_schedule(state.count)`` where
        None."""
        norm = global_norm(grads)
        clip = norm >= self.max_grad_norm
        grads = [torch.where(clip, g / norm * self.max_grad_norm, g)
                 for g in grads]
        ms = [(1.0 - self.decay) * g * g + self.decay * m
              for g, m in zip(grads, state.ms)]
        if lr is None:
            lr = self.lr_schedule(state.count)
        updates = [g * torch.rsqrt(m + self.eps) * (-lr)
                   for g, m in zip(grads, ms)]
        return updates, RMSPropState(state.count + 1, ms)


def tf1_rmsprop(lr_schedule: Callable[[int], float], decay: float = 0.99,
                eps: float = 1e-5, max_grad_norm: float = 40.0
                ) -> TF1RMSProp:
    return TF1RMSProp(lr_schedule, decay, eps, max_grad_norm)
