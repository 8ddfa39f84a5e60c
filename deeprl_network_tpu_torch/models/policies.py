"""Multi-agent recurrent policies: one LSTM cell per agent with neighbour
message passing (counterpart of ``deeprl_network_tpu/models/policies.py``).

Per-agent parameters are stacked on a leading [N] axis; per-edge
communication weights are dense [N, N, d_in, d_out] blocks whose non-edge
blocks are zero, or, with ``sparse_comm``, packed at use time to the
neighbour lists [N, K=max_degree, d_in, d_out]. Every function here works on
a batch of B env instances: activations are [B, N, ...].

Family -> comm type, each a term added to the own-obs embedding before the
relu (``_embed``):
- IA2C      -> ``CommType.NONE``: nothing added;
- IA2C_FP   -> ``CommType.FP``: sum_j W_fp[i,j] fp_j (fingerprints are data,
  detached);
- IA2C_CU   -> ``CommType.NONE`` plus :func:`consensus_update` after every
  optimizer step;
- MA2C_NC   -> ``CommType.NEURCOMM``: the FP term plus sum_j W_msg[i,j] h_j,
  the gradient flowing into the neighbours' hidden states;
- MA2C_CNET -> ``CommType.COMMNET``: one shared map [n_lstm, n_fc] of the mean
  neighbour hidden state;
- MA2C_DIAL -> ``CommType.DIAL``: per-agent messages m_j = W_dial[j] h_j + b_j
  delivered through per-edge blocks [n_msg, n_fc].
``neighbor_obs`` adds sum_j W_nobs[i,j] (obs_alpha o_j), detached, to any of
them.

``embed_marks(mark)`` has ``policy_step_batched`` call ``mark("begin")``
and ``mark("end")`` around ``_embed`` while it is entered: the rollout marks
its ``comm`` span so (``utils/spans.py``).
"""

from __future__ import annotations

import contextlib
import enum
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeprl_network_tpu_torch.models.layers import (
    FCParams, LSTMParams, fc_init, lstm_init, ortho_init,
)
from deeprl_network_tpu_torch.ops.comm_embed import (
    comm_embed, neighbour_tables,
)
from deeprl_network_tpu_torch.ops.dial_head import dial_head
from deeprl_network_tpu_torch.ops.lstm_cell import fused_agent_lstm

BIG_NEG = -1e9
# called with "begin" and "end" around ``_embed`` (``embed_marks``)
_embed_mark: Optional[Callable[[str], None]] = None


@contextlib.contextmanager
def embed_marks(mark: Optional[Callable[[str], None]]):
    """``policy_step_batched`` calls ``mark("begin")`` before its comm
    embedding and ``mark("end")`` after it while this is entered (None:
    no marks)."""
    global _embed_mark
    outer, _embed_mark = _embed_mark, mark
    try:
        yield
    finally:
        _embed_mark = outer


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


class PolicyConsts(NamedTuple):
    """Device copies of a spec's static tables, built once per run so the
    step itself copies nothing from the host."""

    idx: torch.Tensor         # [N, K] int64 neighbour lists
    valid: torch.Tensor       # [N, K, 1, 1] f32
    adj: torch.Tensor         # [N, N, 1, 1] f32
    logit_mask: torch.Tensor  # [N, A] f32
    deg: torch.Tensor         # [N, 1] f32 max(degree, 1), the COMMNET mean
    nbr: torch.Tensor         # [N, K] int32 neighbour lists, -1 in empty slots
    rev: torch.Tensor         # [N, R] int32 receiver * K + slot per sender
                              # (ops/comm_embed.py neighbour_tables)


def policy_consts(spec: PolicySpec, device) -> PolicyConsts:
    idx, valid = spec.neighbor_lists()
    adj = torch.as_tensor(spec.adj(), device=device)
    nbr, rev = neighbour_tables(idx, valid)
    return PolicyConsts(
        idx=torch.as_tensor(idx.astype(np.int64), device=device),
        valid=torch.as_tensor(valid, device=device)[:, :, None, None],
        adj=adj[:, :, None, None],
        logit_mask=torch.as_tensor(spec.logit_mask(), device=device),
        deg=torch.clamp(adj.sum(-1, keepdim=True), min=1.0),
        nbr=torch.as_tensor(nbr, device=device),
        rev=torch.as_tensor(rev, device=device))


class PolicyParams(NamedTuple):
    w_obs: FCParams                      # [N]: n_s_max -> n_fc
    lstm: LSTMParams                     # [N]: n_fc -> n_lstm
    actor: FCParams                      # [N]: n_lstm -> n_a_max
    critic: FCParams                     # [N]: n_lstm -> 1
    w_fp: Optional[torch.Tensor]         # [N, N, n_a_max, n_fc] (FP/NEURCOMM)
    w_msg: Optional[torch.Tensor]        # NEURCOMM: [N, N, n_lstm, n_fc];
                                         # DIAL: [N, N, n_msg, n_fc];
                                         # COMMNET: [n_lstm, n_fc] shared
    w_dial: Optional[FCParams]           # [N]: n_lstm -> n_msg (DIAL)
    w_nobs: Optional[torch.Tensor] = None  # [N, N, n_s_max, n_fc]
                                         # (neighbor_obs)


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
    init; non-edge blocks zero. Leaves are drawn from ``generator`` in the
    order w_obs, lstm, actor, critic, w_fp, w_msg, w_dial, w_nobs."""
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
    w_fp = w_msg = w_dial = w_nobs = None
    ct = spec.comm_type
    if ct in (CommType.FP, CommType.NEURCOMM):
        w_fp = ortho_init((n, n, a, spec.n_fc), np.sqrt(2.0), **kw) \
            * edge_scale
    if ct == CommType.NEURCOMM:
        w_msg = ortho_init((n, n, spec.n_lstm, spec.n_fc), np.sqrt(2.0),
                           **kw) * edge_scale
    elif ct == CommType.COMMNET:
        w_msg = ortho_init((spec.n_lstm, spec.n_fc), np.sqrt(2.0), **kw)
    elif ct == CommType.DIAL:
        w_msg = ortho_init((n, n, spec.n_msg, spec.n_fc), np.sqrt(2.0),
                           **kw) * edge_scale
        w_dial = fc_init(spec.n_lstm, spec.n_msg, scale=np.sqrt(2.0),
                         batch_shape=(n,), **kw)
    if spec.neighbor_obs:
        w_nobs = ortho_init((n, n, s, spec.n_fc), np.sqrt(2.0), **kw) \
            * edge_scale
    params = PolicyParams(w_obs, lstm, actor, critic, w_fp, w_msg, w_dial,
                          w_nobs)
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
    blocks, so non-edge blocks get zero gradient. COMMNET's shared 2-D
    ``w_msg`` has no edge blocks and passes through untouched."""
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
    w_nobs = pack(params.w_nobs) if params.w_nobs is not None else None
    w_msg = params.w_msg
    if w_msg is not None and spec.comm_type in (CommType.NEURCOMM,
                                                CommType.DIAL):
        w_msg = pack(w_msg)
    return params._replace(w_fp=w_fp, w_msg=w_msg, w_nobs=w_nobs)


def _embed(spec: PolicySpec, params: PolicyParams, h_prev: torch.Tensor,
           obs: torch.Tensor, fp: torch.Tensor, consts: PolicyConsts,
           done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-LSTM input embedding [B, N, n_fc]: own obs through the per-agent
    fc plus the comm type's message term. With ``done`` [B] given,
    ``h_prev`` is the unmasked carry and rows where ``done`` is set read
    zeros of it. NEURCOMM and DIAL over packed neighbour lists
    (``sparse_comm``, no ``neighbor_obs``) are one kernel each way
    (``ops/comm_embed.py``, the plain twin on the CPU): DIAL's message head
    is a kernel of its own (``ops/dial_head.py``: the done mask and the bias
    inside, the messages written as the rows the embedding reads), and the
    embedding sums the messages over the lists without a fingerprint term or
    a mask; every other case runs the einsums below. Einsum
    letters: b env, n receiving agent, m sending agent (dense), k neighbour
    slot (packed), x the sender's feature (obs, fingerprint, hidden state or
    DIAL message), d DIAL message width, f embedding."""
    sparse = spec.sparse_comm and spec.neighbor_mask is not None
    ct = spec.comm_type
    kernel = sparse and not spec.neighbor_obs
    if kernel and ct is CommType.NEURCOMM:
        if done is None:
            done = h_prev.new_zeros(h_prev.shape[0])
        return comm_embed(obs, fp, h_prev, done, params.w_obs.w,
                          params.w_obs.b, params.w_fp, params.w_msg,
                          consts.nbr, consts.rev)
    if kernel and ct is CommType.DIAL:
        msg = dial_head(h_prev, done, params.w_dial.w, params.w_dial.b)
        return comm_embed(obs, None, msg, None, params.w_obs.w,
                          params.w_obs.b, None, params.w_msg, consts.nbr,
                          consts.rev)
    if done is not None:
        h_prev = h_prev * (1.0 - done.to(h_prev.dtype))[:, None, None]
    if ct == CommType.DIAL:
        msg = (torch.einsum("bmh,mhd->bmd", h_prev, params.w_dial.w)
               + params.w_dial.b)
    idx = consts.idx

    def edge_sum(x, w):
        """sum over senders of x[sender] @ w[receiver, sender]: w packed
        [N, K, X, F] by mask_comm_params, or dense [N, N, X, F]."""
        if sparse:
            return torch.einsum("bnkx,nkxf->bnf", x[:, idx], w)
        return torch.einsum("bmx,nmxf->bnf", x, w)

    e = torch.einsum("bns,nsf->bnf", obs, params.w_obs.w) + params.w_obs.b
    if spec.neighbor_obs:
        # alpha-scaled neighbour observations: data only, like fingerprints
        e = e + edge_sum(obs.detach() * spec.obs_alpha, params.w_nobs)
    if ct in (CommType.FP, CommType.NEURCOMM):
        e = e + edge_sum(fp.detach(), params.w_fp)
    if ct == CommType.NEURCOMM:
        # differentiable comm: gradient flows into neighbours' h
        e = e + edge_sum(h_prev, params.w_msg)
    elif ct == CommType.COMMNET:
        # in the activations' dtype, so that the cell sees one dtype
        adj = consts.adj[:, :, 0, 0].to(h_prev.dtype)
        mean_h = (adj @ h_prev) / consts.deg.to(h_prev.dtype)
        e = e + mean_h @ params.w_msg
    elif ct == CommType.DIAL:
        e = e + edge_sum(msg, params.w_msg)
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
    mark = _embed_mark
    if mark is not None:
        mark("begin")
    e = _embed(spec, params, carry.h, obs, fp, consts, done)
    if mark is not None:
        mark("end")
    c2, h2 = fused_agent_lstm(
        (params.lstm.wx, params.lstm.wh, params.lstm.b),
        (carry.c, carry.h), e, done)
    logits = (torch.einsum("bnh,nha->bna", h2, params.actor.w)
              + params.actor.b)
    logits = logits + consts.logit_mask
    value = (torch.einsum("bnh,nhv->bnv", h2, params.critic.w)
             + params.critic.b)[..., 0]
    return Carry(c2, h2), logits, value


def policy_step(spec: PolicySpec, params: PolicyParams, carry: Carry,
                obs: torch.Tensor, fp: torch.Tensor, done: torch.Tensor,
                consts: Optional[PolicyConsts] = None
                ) -> Tuple[Carry, torch.Tensor, torch.Tensor]:
    """One control step for all N agents of ONE env instance, the JAX
    package's single-env API: :func:`policy_step_batched` at B = 1 (on a
    CUDA tensor the cell is the same single kernel launch).

    carry: (c, h) each [N, H]; obs [N, S]; fp [N, A]; done a 0-dim tensor.
    Returns (new carry [N, H] x2, masked logits [N, A], values [N]).
    """
    done = torch.as_tensor(done, dtype=carry.h.dtype,
                           device=carry.h.device).reshape(1)
    new, logits, values = policy_step_batched(
        spec, params, Carry(carry.c[None], carry.h[None]), obs[None],
        fp[None], done, consts)
    return Carry(new.c[0], new.h[0]), logits[0], values[0]


# ---- IA2C_CU weight consensus ----

def consensus_matrix(neighbor_mask: np.ndarray) -> np.ndarray:
    """Row-normalized (A + I): theta_i <- mean over N(i) u {i}."""
    a = neighbor_mask.astype(np.float32) + np.eye(len(neighbor_mask),
                                                 dtype=np.float32)
    return a / a.sum(1, keepdims=True)


def _agent_mix(mix: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j mix[i, j] x[j] over the leading agent axis. Weight
    averaging must be exact whatever the compute dtype and the TF32 switch
    say, so the product runs in float64 (which no tensor core shortens) and
    is rounded once to x's dtype."""
    out = mix.double() @ x.double().reshape(x.shape[0], -1)
    return out.reshape((mix.shape[0],) + x.shape[1:]).to(x.dtype)


def _masked_axis_consensus(closed: torch.Tensor, leaf: torch.Tensor,
                           valid: torch.Tensor, axis: int) -> torch.Tensor:
    """Consensus-average ``leaf`` [N, ...] over the closed neighbourhood,
    restricted along ``axis`` to the slices each agent actually uses.

    valid: [N, K] with K = leaf.shape[axis]; slice k of agent j enters the
    average only where valid[j, k] = 1, and the mean renormalizes by the
    number of contributing neighbours per slice. Slices invalid for agent i
    itself keep their own value. With an all-ones mask this reduces exactly
    to the plain row-normalized (A + I) average."""
    lv = leaf.movedim(axis, 1)                              # [N, K, ...]
    vm = valid.reshape(valid.shape + (1,) * (lv.ndim - 2))
    num = _agent_mix(closed, vm * lv)
    den = torch.clamp(_agent_mix(closed, valid), min=1.0)
    out = torch.where(vm > 0, num / den.reshape(vm.shape), lv)
    return out.movedim(1, axis)


class ConsensusTables(NamedTuple):
    """Device copies of the consensus's masks, built once per run so that
    the update copies nothing from the host (``consensus_update``)."""

    closed: torch.Tensor                # [N, N] A + I
    mix: torch.Tensor                   # [N, N] row-normalized A + I
    adj: torch.Tensor                   # [N, N] A
    action_mask: Optional[torch.Tensor]  # [N, A]
    obs_mask: Optional[torch.Tensor]    # [N, S]


def consensus_tables(neighbor_mask: np.ndarray,
                     action_mask: Optional[np.ndarray] = None,
                     obs_mask: Optional[np.ndarray] = None,
                     device=None) -> ConsensusTables:
    n = len(neighbor_mask)
    closed = neighbor_mask.astype(np.float32) + np.eye(n, dtype=np.float32)
    f32 = lambda m: None if m is None else torch.as_tensor(
        m.astype(np.float32), device=device)
    return ConsensusTables(
        closed=f32(closed), mix=f32(closed / closed.sum(1, keepdims=True)),
        adj=f32(neighbor_mask), action_mask=f32(action_mask),
        obs_mask=f32(obs_mask))


def consensus_update(params: PolicyParams, neighbor_mask: np.ndarray,
                     action_mask: Optional[np.ndarray] = None,
                     obs_mask: Optional[np.ndarray] = None,
                     tables: Optional[ConsensusTables] = None
                     ) -> PolicyParams:
    """IA2C_CU post-update weight consensus: per-agent weights are averaged
    over the closed neighbourhood.

    With ``action_mask`` / ``obs_mask`` (heterogeneous graphs) the average
    is shape-aware: actor-head columns are averaged only across neighbours
    for which that action index is valid, and obs-embedding rows only
    across neighbours that use that obs dim, renormalized by the
    contributing count; an agent's padded slices are kept as they are.
    Dense per-edge blocks [N, N, ...] average block (i, j) only over
    neighbours k that also own an edge to j. Leaves without a leading agent
    axis (COMMNET's shared message map) are returned untouched. On all-ones
    masks the actor/obs handling reduces exactly to the plain average.

    ``tables`` (``consensus_tables`` of the same masks on the params'
    device) replace the masks, which are then not read."""
    if tables is None:
        tables = consensus_tables(neighbor_mask, action_mask, obs_mask,
                                  params.w_obs.w.device)
    n = tables.closed.shape[0]
    closed, mix, adj = tables.closed, tables.mix, tables.adj

    def plain(leaf):
        if leaf.ndim == 0 or leaf.shape[0] != n:
            return leaf                      # no agent axis: not averaged
        return _agent_mix(mix, leaf)

    def edge_blocks(leaf):
        if leaf is not None and leaf.ndim >= 2 and leaf.shape[:2] == (n, n):
            return _masked_axis_consensus(closed, leaf, adj, axis=1)
        return tree_map(plain, leaf)

    if tables.action_mask is None and tables.obs_mask is None:
        return tree_map(plain, params)

    actor, w_obs = params.actor, params.w_obs
    if tables.action_mask is not None:
        am = tables.action_mask
        actor = FCParams(
            w=_masked_axis_consensus(closed, actor.w, am, axis=2),
            b=_masked_axis_consensus(closed, actor.b, am, axis=1))
    else:
        actor = tree_map(plain, actor)
    if tables.obs_mask is not None:
        om = tables.obs_mask
        w_obs = FCParams(
            w=_masked_axis_consensus(closed, w_obs.w, om, axis=1),
            b=plain(w_obs.b))
    else:
        w_obs = tree_map(plain, w_obs)
    return params._replace(
        w_obs=w_obs,
        lstm=tree_map(plain, params.lstm),
        actor=actor,
        critic=tree_map(plain, params.critic),
        w_fp=edge_blocks(params.w_fp),
        w_msg=edge_blocks(params.w_msg),
        w_dial=tree_map(plain, params.w_dial),
        w_nobs=edge_blocks(params.w_nobs))
