"""Plain PyTorch reference of the multi-agent recurrent policy of the five
A2C families without a consensus step (Chu et al., ICLR 2020,
arXiv:2004.01339, eqs. of section 4), float32, dense per-edge blocks, no
kernel of the program.

For agent i of N, with A_ij the neighbour mask, deg_i = max(sum_j A_ij, 1),
h_j the hidden states of the previous step and fp_j the neighbours' policy
fingerprints:

    e_i = relu(s_i W_obs_i + b_obs_i + comm_i)
    (c_i, h_i) = LSTM(e_i, (c_i, h_i) * (1 - done)), gates (i, f, o, u), no forget bias
    logits_i = h_i W_actor_i + b_actor_i (invalid actions at -1e9)
    v_i = h_i W_critic_i + b_critic_i

where the comm term ``comm_i`` is the comm type's (``COMM_TYPES``):

    none      0                                          (IA2C)
    fp        sum_j fp_j W_fp[i, j]                      (IA2C_FP)
    neurcomm  sum_j fp_j W_fp[i, j] + sum_j h_j W_msg[i, j]          (MA2C_NC)
    commnet   (sum_j A_ij h_j / deg_i) W_msg, one shared [H, F] map  (MA2C_CNET)
    dial      sum_j m_j W_msg[i, j], m_j = h_j W_dial_j + b_dial_j   (MA2C_DIAL)

Fingerprints are data (no gradient flows into them); h_j and m_j carry the
gradient across agents. Per-edge blocks [N, N, ., F] of non-neighbours are
masked to zero; CommNet's shared map is not. Parameters are a dict of named
float32 tensors (``param_shapes``); ``q`` takes every operand of a matrix
product (identity for the reference, a rounding to a lower precision for
the control).

Departures from the published description: the concatenation of the
neighbours' inputs into one matrix product is written as a sum of per-edge
blocks, which is the same product. Where the description leaves a choice
open, the reference takes: DIAL's message continuous (no discretising
unit), with the bias b_dial_j, and as wide as the embedding (n_msg = F; the
configuration files state no message width); CommNet's mean over the
neighbours alone, an agent with none dividing by 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

BIG_NEG = -1e9
COMM_TYPES = ("none", "fp", "neurcomm", "commnet", "dial")
# every name a parameter of the reference may have
PARAM_NAMES = ("w_obs.w", "w_obs.b", "lstm.wx", "lstm.wh", "lstm.b",
               "actor.w", "actor.b", "critic.w", "critic.b", "w_fp", "w_msg",
               "w_dial.w", "w_dial.b")


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def param_shapes(n: int, s: int, a: int, f: int, h: int, comm: str
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of comm type ``comm``, in the order
    the program's parameter tree lists its leaves. DIAL's message width is
    ``f``."""
    if comm not in COMM_TYPES:
        raise ValueError(f"unknown comm type {comm!r}")
    shapes = [("w_obs.w", (n, s, f)), ("w_obs.b", (n, f)),
              ("lstm.wx", (n, f, 4 * h)), ("lstm.wh", (n, h, 4 * h)),
              ("lstm.b", (n, 4 * h)), ("actor.w", (n, h, a)),
              ("actor.b", (n, a)), ("critic.w", (n, h, 1)),
              ("critic.b", (n, 1))]
    if comm in ("fp", "neurcomm"):
        shapes.append(("w_fp", (n, n, a, f)))
    if comm == "neurcomm":
        shapes.append(("w_msg", (n, n, h, f)))
    elif comm == "commnet":
        shapes.append(("w_msg", (h, f)))
    elif comm == "dial":
        shapes += [("w_msg", (n, n, f, f)), ("w_dial.w", (n, h, f)),
                   ("w_dial.b", (n, f))]
    return shapes


class Policy:
    """The policy of one configuration: ``adj`` [N, N] neighbours,
    ``action_mask`` [N, A], ``comm`` one of ``COMM_TYPES``."""

    def __init__(self, adj: np.ndarray, action_mask: np.ndarray, comm: str,
                 device):
        if comm not in COMM_TYPES:
            raise ValueError(f"unknown comm type {comm!r}")
        dev = torch.device(device)
        self.comm = comm
        self.adj = torch.as_tensor(adj, dtype=torch.float32, device=dev)
        self.deg = torch.clamp(self.adj.sum(1), min=1.0)
        self.logit_mask = torch.as_tensor(
            (1.0 - action_mask) * BIG_NEG, dtype=torch.float32, device=dev)
        self.uniform_fp = torch.as_tensor(
            action_mask / action_mask.sum(-1, keepdims=True),
            dtype=torch.float32, device=dev)

    def masked(self, p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The per-edge blocks with non-neighbours zeroed (gradients of the
        zeroed blocks are zero)."""
        m = self.adj[:, :, None, None]
        return {k: v * m if k in ("w_fp", "w_msg") and v.ndim == 4 else v
                for k, v in p.items()}

    def step(self, p: Dict[str, torch.Tensor], c: torch.Tensor,
             h: torch.Tensor, obs: torch.Tensor, fp: torch.Tensor,
             done: torch.Tensor, q=identity):
        """One control step of B instances: (c', h', logits [B, N, A],
        values [B, N]); ``p`` from ``masked``."""
        keep = (1.0 - done)[:, None, None]
        c, h = c * keep, h * keep
        e = torch.einsum("bns,nsf->bnf", q(obs), q(p["w_obs.w"])) \
            + p["w_obs.b"]
        if self.comm in ("fp", "neurcomm"):
            e = e + torch.einsum("bma,nmaf->bnf", q(fp), q(p["w_fp"]))
        if self.comm == "neurcomm":
            e = e + torch.einsum("bmh,nmhf->bnf", q(h), q(p["w_msg"]))
        elif self.comm == "commnet":
            # the 0/1 mask is exact in every rounding
            mean = torch.einsum("nm,bmh->bnh", self.adj, q(h)) \
                / self.deg[:, None]
            e = e + torch.einsum("bnh,hf->bnf", q(mean), q(p["w_msg"]))
        elif self.comm == "dial":
            msg = torch.einsum("bmh,mhd->bmd", q(h), q(p["w_dial.w"])) \
                + p["w_dial.b"]
            e = e + torch.einsum("bmd,nmdf->bnf", q(msg), q(p["w_msg"]))
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
