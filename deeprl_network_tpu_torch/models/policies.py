"""Multi-agent recurrent policies: one LSTM cell per agent with neighbour
message passing (counterpart of ``deeprl_network_tpu/models/policies.py``).

Per-agent parameters are stacked on a leading [N] axis; per-edge
communication weights are dense [N, N, d_in, d_out] blocks whose non-edge
blocks are zero, or, with ``sparse_comm``, packed at use time to the
neighbour lists [N, K=max_degree, d_in, d_out]. Every function here works on
a batch of B env instances: activations are [B, N, ...].

This slice ports the IA2C embedding (``CommType.NONE``) and NeurComm
(``CommType.NEURCOMM``, MA2C_NC):
    e_i = relu(W_obs[i] o_i + sum_{j in N(i)} W_fp[i,j] fp_j
               + sum_{j in N(i)} W_msg[i,j] h_j),
with the fingerprints detached (data, not a gradient path) and the gradient
flowing into the neighbours' hidden states. FP, COMMNET, DIAL, neighbour
observations and weight consensus are not ported yet (ROADMAP.md queue 1
item 9) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeprl_network_tpu_torch.models.layers import (
    FCParams, LSTMParams, fc_init, lstm_init, ortho_init,
)
from deeprl_network_tpu_torch.ops.lstm_cell import fused_agent_lstm

BIG_NEG = -1e9


class CommType(str, enum.Enum):
    NONE = "none"
    FP = "fp"
    NEURCOMM = "neurcomm"
    COMMNET = "commnet"
    DIAL = "dial"


AGENT_TO_COMM = {
    "ia2c": CommType.NONE,
    "ia2c_fp": CommType.FP,
    "ia2c_cu": CommType.NONE,
    "ma2c_nc": CommType.NEURCOMM,
    "ma2c_cnet": CommType.COMMNET,
    "ma2c_dial": CommType.DIAL,
}

_PORTED_COMM = (CommType.NONE, CommType.NEURCOMM)


@dataclass(frozen=True)
class PolicySpec:
    """Static policy description."""

    n_agent: int
    n_s_max: int
    n_a_max: int
    n_fc: int = 64
    n_lstm: int = 64
    comm_type: CommType = CommType.NONE
    n_msg: int = 64                      # DIAL message width
    sparse_comm: bool = False            # K-packed per-edge blocks
    neighbor_obs: bool = False
    obs_alpha: float = 1.0
    neighbor_mask: Optional[np.ndarray] = field(default=None, hash=False,
                                                compare=False)
    action_mask: Optional[np.ndarray] = field(default=None, hash=False,
                                              compare=False)

    def adj(self) -> np.ndarray:
        a = self.neighbor_mask
        if a is None:
            a = np.zeros((self.n_agent, self.n_agent), np.float32)
        return a.astype(np.float32)

    def neighbor_lists(self) -> Tuple[np.ndarray, np.ndarray]:
        """(idx [N, K] int32, valid [N, K] float32): row i holds the
        neighbor indices of agent i padded to K = max degree (padded slots
        point at 0 and carry valid=0)."""
        adj = self.adj()
        k = max(int(adj.sum(1).max()), 1)
        idx = np.zeros((self.n_agent, k), np.int32)
        valid = np.zeros((self.n_agent, k), np.float32)
        for i in range(self.n_agent):
            nbrs = np.flatnonzero(adj[i])
            idx[i, :len(nbrs)] = nbrs
            valid[i, :len(nbrs)] = 1.0
        return idx, valid

    def logit_mask(self) -> np.ndarray:
        """Additive mask: 0 for valid actions, BIG_NEG for padding."""
        if self.action_mask is None:
            return np.zeros((self.n_agent, self.n_a_max), np.float32)
        return ((1.0 - self.action_mask) * BIG_NEG).astype(np.float32)


def check_ported(spec: PolicySpec) -> None:
    """Raise for the policy features this slice does not port."""
    if spec.comm_type not in _PORTED_COMM:
        raise NotImplementedError(
            f"comm type {spec.comm_type.value!r} is not ported yet "
            "(ROADMAP.md queue 1 item 9)")
    if spec.neighbor_obs:
        raise NotImplementedError(
            "neighbor_obs is not ported yet (ROADMAP.md queue 1 item 9)")


class PolicyConsts(NamedTuple):
    """Device copies of a spec's static tables, built once per run so the
    step itself copies nothing from the host."""

    idx: torch.Tensor         # [N, K] int64 neighbour lists
    valid: torch.Tensor       # [N, K, 1, 1] f32
    adj: torch.Tensor         # [N, N, 1, 1] f32
    logit_mask: torch.Tensor  # [N, A] f32


def policy_consts(spec: PolicySpec, device) -> PolicyConsts:
    idx, valid = spec.neighbor_lists()
    return PolicyConsts(
        idx=torch.as_tensor(idx.astype(np.int64), device=device),
        valid=torch.as_tensor(valid, device=device)[:, :, None, None],
        adj=torch.as_tensor(spec.adj(), device=device)[:, :, None, None],
        logit_mask=torch.as_tensor(spec.logit_mask(), device=device))


class PolicyParams(NamedTuple):
    w_obs: FCParams                      # [N]: n_s_max -> n_fc
    lstm: LSTMParams                     # [N]: n_fc -> n_lstm
    actor: FCParams                      # [N]: n_lstm -> n_a_max
    critic: FCParams                     # [N]: n_lstm -> 1
    w_fp: Optional[torch.Tensor]         # [N, N, n_a_max, n_fc] (NEURCOMM)
    w_msg: Optional[torch.Tensor]        # NEURCOMM: [N, N, n_lstm, n_fc]
    w_dial: Optional[FCParams]           # DIAL (not ported)
    w_nobs: Optional[torch.Tensor] = None  # neighbor_obs (not ported)


class Carry(NamedTuple):
    c: torch.Tensor  # [B, N, n_lstm]
    h: torch.Tensor  # [B, N, n_lstm]


# ---- NamedTuple trees of tensors (None leaves skipped, field order) ----

def tree_leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, sub) for sub in tree))
    return fn(tree)


def tree_unflatten(tree, leaves: List[torch.Tensor]):
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def init_carry(spec: PolicySpec, batch: int, dtype=torch.float32,
               device=None) -> Carry:
    shape = (batch, spec.n_agent, spec.n_lstm)
    return Carry(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))


def init_fingerprint(spec: PolicySpec, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Uniform policy fingerprints [N, A] at episode start."""
    m = (spec.action_mask if spec.action_mask is not None
         else np.ones((spec.n_agent, spec.n_a_max), np.float32))
    m = torch.as_tensor(np.asarray(m, np.float32))
    return (m / m.sum(-1, keepdim=True)).to(device=device, dtype=dtype)


def init_policy_params(generator: torch.Generator, spec: PolicySpec,
                       dtype=torch.float32, device=None) -> PolicyParams:
    """Orthogonal init per block; per-edge blocks scaled by 1/sqrt(deg) so
    the summed message keeps the variance of the reference's concat-ortho
    init; non-edge blocks zero."""
    check_ported(spec)
    n, s, a = spec.n_agent, spec.n_s_max, spec.n_a_max
    kw = dict(dtype=dtype, generator=generator, device=device)
    adj = spec.adj()
    deg = np.maximum(adj.sum(1), 1.0)
    edge_scale = torch.as_tensor(
        (1.0 / np.sqrt(deg))[:, None, None, None].astype(np.float32),
        device=device).to(dtype)

    w_obs = fc_init(s, spec.n_fc, scale=np.sqrt(2.0), batch_shape=(n,), **kw)
    lstm = lstm_init(spec.n_fc, spec.n_lstm, scale=1.0, batch_shape=(n,),
                     **kw)
    actor = fc_init(spec.n_lstm, a, scale=0.01, batch_shape=(n,), **kw)
    critic = fc_init(spec.n_lstm, 1, scale=1.0, batch_shape=(n,), **kw)
    w_fp = w_msg = None
    if spec.comm_type == CommType.NEURCOMM:
        w_fp = ortho_init((n, n, a, spec.n_fc), np.sqrt(2.0), **kw) \
            * edge_scale
        w_msg = ortho_init((n, n, spec.n_lstm, spec.n_fc), np.sqrt(2.0),
                           **kw) * edge_scale
    params = PolicyParams(w_obs, lstm, actor, critic, w_fp, w_msg, None,
                          None)
    # non-edge blocks start (and stay) zero; see mask_comm_params
    return mask_comm_params(spec, params, sparse=False)


def _needs_edge_mask(spec: PolicySpec) -> bool:
    return spec.neighbor_mask is not None and (
        spec.comm_type is not CommType.NONE or spec.neighbor_obs)


def mask_comm_params(spec: PolicySpec, params: PolicyParams,
                     consts: Optional[PolicyConsts] = None,
                     sparse: Optional[bool] = None) -> PolicyParams:
    """Zero the per-edge weight blocks of non-edges (dense), or pack the
    dense [N, N, din, dout] blocks to the neighbour lists [N, K, din, dout]
    (``spec.sparse_comm``). Done once per update, outside the T-step loop;
    gradients flow through the mask (or the gather) back into the dense
    blocks, so non-edge blocks get zero gradient."""
    check_ported(spec)
    if not _needs_edge_mask(spec):
        return params
    if consts is None:
        consts = policy_consts(spec, params.w_obs.w.device)
    sparse = spec.sparse_comm if sparse is None else sparse
    if sparse:
        rows = torch.arange(spec.n_agent, device=consts.idx.device)[:, None]
        pack = lambda w: w[rows, consts.idx] * consts.valid.to(w.dtype)
    else:
        pack = lambda w: w * consts.adj.to(w.dtype)
    w_fp = pack(params.w_fp) if params.w_fp is not None else None
    w_msg = pack(params.w_msg) if params.w_msg is not None else None
    return params._replace(w_fp=w_fp, w_msg=w_msg)


def _embed(spec: PolicySpec, params: PolicyParams, h_prev: torch.Tensor,
           obs: torch.Tensor, fp: torch.Tensor,
           consts: PolicyConsts) -> torch.Tensor:
    """Pre-LSTM input embedding [B, N, n_fc]: own obs through the per-agent
    fc plus the NeurComm message terms."""
    check_ported(spec)
    sparse = spec.sparse_comm and spec.neighbor_mask is not None
    e = torch.einsum("bns,nsf->bnf", obs, params.w_obs.w) + params.w_obs.b
    if spec.comm_type == CommType.NEURCOMM:
        fp_in = fp.detach()
        if sparse:  # packed [N, K, A, F] by mask_comm_params
            e = e + torch.einsum("bnka,nkaf->bnf", fp_in[:, consts.idx],
                                 params.w_fp)
            # differentiable comm: gradient flows into neighbours' h
            e = e + torch.einsum("bnkh,nkhf->bnf", h_prev[:, consts.idx],
                                 params.w_msg)
        else:
            e = e + torch.einsum("bma,nmaf->bnf", fp_in, params.w_fp)
            e = e + torch.einsum("bmh,nmhf->bnf", h_prev, params.w_msg)
    return torch.relu(e)


def policy_step_batched(spec: PolicySpec, params: PolicyParams,
                        carry: Carry, obs: torch.Tensor, fp: torch.Tensor,
                        done: torch.Tensor,
                        consts: Optional[PolicyConsts] = None
                        ) -> Tuple[Carry, torch.Tensor, torch.Tensor]:
    """One control step for all N agents of B env instances; the per-agent
    LSTM cell runs as one fused kernel (``ops/lstm_cell.py``).

    ``params`` must have passed :func:`mask_comm_params`.
    carry: (c, h) each [B, N, H]; obs [B, N, S]; fp [B, N, A]; done [B].
    Returns (new carry, masked logits [B, N, A], values [B, N]).
    """
    if consts is None:
        consts = policy_consts(spec, obs.device)
    done = done.to(carry.h.dtype)
    h_prev = carry.h * (1.0 - done)[:, None, None]
    e = _embed(spec, params, h_prev, obs, fp, consts)
    c2, h2 = fused_agent_lstm(
        (params.lstm.wx, params.lstm.wh, params.lstm.b),
        (carry.c, carry.h), e, done)
    logits = (torch.einsum("bnh,nha->bna", h2, params.actor.w)
              + params.actor.b)
    logits = logits + consts.logit_mask
    value = (torch.einsum("bnh,nhv->bnv", h2, params.critic.w)
             + params.critic.b)[..., 0]
    return Carry(c2, h2), logits, value
