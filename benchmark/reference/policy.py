"""Plain PyTorch reference of the multi-agent recurrent policy (IA2C and
MA2C_NC, NeurComm; Chu et al., ICLR 2020, arXiv:2004.01339, eqs. of
section 4), float32, dense per-edge blocks, no kernel of the program.

For agent i of N, with h_j the neighbours' hidden states of the previous
step and pi_j their policy fingerprints:

    e_i = relu(s_i W_obs_i + b_obs_i + sum_j pi_j W_fp[i, j] + sum_j h_j W_msg[i, j])
    (c_i, h_i) = LSTM(e_i, (c_i, h_i) * (1 - done)), gates (i, f, o, u), no forget bias
    logits_i = h_i W_actor_i + b_actor_i (invalid actions at -1e9)
    v_i = h_i W_critic_i + b_critic_i

(the fingerprint and message terms for MA2C_NC only; IA2C has neither).
Per-edge blocks of non-neighbours are masked to zero. Parameters are a dict
of named float32 tensors (``PARAM_NAMES``); ``q`` takes every operand of a
matrix product (identity for the reference, a rounding to a lower precision
for the control).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

BIG_NEG = -1e9
PARAM_NAMES = ("w_obs.w", "w_obs.b", "lstm.wx", "lstm.wh", "lstm.b",
               "actor.w", "actor.b", "critic.w", "critic.b", "w_fp", "w_msg")


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def param_shapes(n: int, s: int, a: int, f: int, h: int, comm: bool
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in the order the program's
    parameter tree lists its leaves."""
    shapes = [("w_obs.w", (n, s, f)), ("w_obs.b", (n, f)),
              ("lstm.wx", (n, f, 4 * h)), ("lstm.wh", (n, h, 4 * h)),
              ("lstm.b", (n, 4 * h)), ("actor.w", (n, h, a)),
              ("actor.b", (n, a)), ("critic.w", (n, h, 1)),
              ("critic.b", (n, 1))]
    if comm:
        shapes += [("w_fp", (n, n, a, f)), ("w_msg", (n, n, h, f))]
    return shapes


class Policy:
    """The policy of one configuration: ``adj`` [N, N] neighbours,
    ``action_mask`` [N, A], ``comm`` (MA2C_NC) or not (IA2C)."""

    def __init__(self, adj: np.ndarray, action_mask: np.ndarray, comm: bool,
                 device):
        dev = torch.device(device)
        self.comm = comm
        self.adj = torch.as_tensor(adj, dtype=torch.float32, device=dev)
        self.logit_mask = torch.as_tensor(
            (1.0 - action_mask) * BIG_NEG, dtype=torch.float32, device=dev)
        self.uniform_fp = torch.as_tensor(
            action_mask / action_mask.sum(-1, keepdims=True),
            dtype=torch.float32, device=dev)

    def masked(self, p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The per-edge blocks with non-neighbours zeroed (gradients of the
        zeroed blocks are zero)."""
        if not self.comm:
            return p
        m = self.adj[:, :, None, None]
        return {**p, "w_fp": p["w_fp"] * m, "w_msg": p["w_msg"] * m}

    def step(self, p: Dict[str, torch.Tensor], c: torch.Tensor,
             h: torch.Tensor, obs: torch.Tensor, fp: torch.Tensor,
             done: torch.Tensor, q=identity):
        """One control step of B instances: (c', h', logits [B, N, A],
        values [B, N]); ``p`` from ``masked``."""
        keep = (1.0 - done)[:, None, None]
        c, h = c * keep, h * keep
        e = torch.einsum("bns,nsf->bnf", q(obs), q(p["w_obs.w"])) \
            + p["w_obs.b"]
        if self.comm:
            e = e + torch.einsum("bma,nmaf->bnf", q(fp), q(p["w_fp"]))
            e = e + torch.einsum("bmh,nmhf->bnf", q(h), q(p["w_msg"]))
        e = torch.relu(e)
        z = (torch.einsum("bnf,nfg->bng", q(e), q(p["lstm.wx"]))
             + torch.einsum("bnh,nhg->bng", q(h), q(p["lstm.wh"]))
             + p["lstm.b"])
        i, f, o, u = torch.chunk(z, 4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        logits = (torch.einsum("bnh,nha->bna", q(h2), q(p["actor.w"]))
                  + p["actor.b"] + self.logit_mask)
        values = (torch.einsum("bnh,nhv->bnv", q(h2), q(p["critic.w"]))
                  + p["critic.b"])[..., 0]
        return c2, h2, logits, values
