"""The comm embedding over packed neighbour lists (``ops/comm_embed.py``),
NeurComm's call and DIAL's (no fingerprint term, its messages unmasked):
its plain twin against the PyTorch ops it replaces (the ``edge_sum``
composition, kept here as the yardstick; for DIAL also over dense blocks)
on the 5x5 grid, Monaco-28 and a random graph with padded slots, in f32
and, under one relu mask, in bf16; the reverse neighbour table; the
dispatch of ``_embed``; and, on a card (``needs_cuda``), the CUDA kernels
against the twin and against the ops, their launch counts and a bitwise
deterministic backward. No JAX is imported: the card's machine has none
(``test_torch_comm.py`` holds the twin to the JAX package).

On a card: ``python -m pytest --noconftest -q tests/test_torch_comm_embed.py
-k cuda``."""

import dataclasses

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.models import policies as tp
from deeprl_network_tpu_torch.models.layers import FCParams
from deeprl_network_tpu_torch.ops import comm_embed as ce

# decided when each test is set up, not at import
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid_adj(rows=5, cols=5):
    adj = np.zeros((rows * cols, rows * cols), np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for rr, cc in ((r + 1, c), (r, c + 1)):
                if rr < rows and cc < cols:
                    adj[i, rr * cols + cc] = adj[rr * cols + cc, i] = 1
    return adj


def _monaco_adj():
    from deeprl_network_tpu_torch.config import EnvConfig
    from deeprl_network_tpu_torch.envs.monaco import build_monaco_topology
    return np.asarray(build_monaco_topology(EnvConfig()).node_adj,
                      np.float32)


def _random_adj(n=11, k=5, seed=3):
    """A directed graph: every agent reads 1..k senders (so slots pad), some
    agents are read by more than k and one by nobody."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), np.float32)
    for i in range(n):
        deg = int(rng.integers(1, k + 1))
        senders = rng.choice([j for j in range(n) if j not in (i, n - 1)],
                             size=deg, replace=False)
        adj[i, senders] = 1
    adj[0, :] = 0
    adj[0, 1:k + 1] = 1                  # one agent with a full row
    adj[:, n - 1] = 0                    # read by nobody
    return adj


GRAPHS = {"grid25": _grid_adj, "monaco28": _monaco_adj,
          "random_k5": _random_adj}


def _spec(adj, n_s, n_a, width, comm=tp.CommType.NEURCOMM, sparse=True,
          nobs=False):
    return tp.PolicySpec(n_agent=len(adj), n_s_max=n_s, n_a_max=n_a,
                         n_fc=width, n_lstm=width, n_msg=width,
                         comm_type=comm, sparse_comm=sparse, neighbor_obs=nobs,
                         neighbor_mask=adj)


def _case(adj, B, n_s=12, n_a=5, width=16, seed=0, dtype=torch.float32,
          device="cpu", comm=tp.CommType.NEURCOMM):
    """Dense comm params (non-edge blocks zero) and inputs of a spec; the
    carry is unmasked and rows 1, 4, 7, ... are done. DIAL's params are the
    own-obs fc, the message head (w_dial, b_dial; messages as wide as the
    cell) and the message blocks."""
    spec = _spec(adj, n_s, n_a, width, comm=comm)
    rng = np.random.default_rng(seed)
    n, H, F = spec.n_agent, spec.n_lstm, spec.n_fc
    t = lambda *s, scale=1.0: torch.tensor(
        (rng.standard_normal(s) * scale).astype(np.float32))
    mask = torch.as_tensor(adj)[:, :, None, None]
    deg = max(1.0, float(adj.sum(1).max()))
    if comm is tp.CommType.DIAL:
        M = width
        params = dict(
            w_obs=t(n, n_s, F, scale=n_s ** -0.5), b_obs=t(n, F, scale=0.1),
            w_dial=t(n, H, M, scale=H ** -0.5), b_dial=t(n, M, scale=0.5),
            w_msg=t(n, n, M, F, scale=(deg * M) ** -0.5) * mask)
    else:
        params = dict(
            w_obs=t(n, n_s, F, scale=n_s ** -0.5), b_obs=t(n, F, scale=0.1),
            w_fp=t(n, n, n_a, F, scale=(deg * n_a) ** -0.5) * mask,
            w_msg=t(n, n, H, F, scale=(deg * H) ** -0.5) * mask)
    fp = torch.tensor(rng.random((B, n, n_a)).astype(np.float32))
    inputs = dict(obs=t(B, n, n_s), fp=fp / fp.sum(-1, keepdim=True),
                  h=t(B, n, H, scale=0.5),
                  done=(torch.arange(B) % 3 == 1).float())
    cast = lambda d: {k: v.to(device=device, dtype=dtype)
                      for k, v in d.items()}
    return spec, cast(params), cast(inputs)


def _pack(spec, device):
    """(consts, the packing of dense [N, N, X, F] blocks to [N, K, X, F]
    as ``mask_comm_params`` makes it)."""
    consts = tp.policy_consts(spec, device)
    rows = torch.arange(spec.n_agent, device=device)[:, None]
    return consts, lambda w: w[rows, consts.idx] * consts.valid.to(w.dtype)


def _packed(spec, params, device="cpu"):
    """The packed [N, K, X, F] blocks, as ``mask_comm_params`` makes them."""
    consts, pack = _pack(spec, device)
    return consts, pack(params["w_fp"]), pack(params["w_msg"])


def _edge_sum_pre(spec, consts, obs, fp, h, done, w_obs, b_obs, w_fp,
                  w_msg):
    """The yardstick before its relu: the PyTorch ops that ``_embed`` ran
    for packed NEURCOMM before the kernel (the masked carry, ``edge_sum``
    for the fingerprints and for h, the adds)."""
    h_prev = h * (1.0 - done.to(h.dtype))[:, None, None]
    idx = consts.idx
    edge_sum = lambda x, w: torch.einsum("bnkx,nkxf->bnf", x[:, idx], w)
    e = torch.einsum("bns,nsf->bnf", obs, w_obs) + b_obs
    e = e + edge_sum(fp.detach(), w_fp)
    return e + edge_sum(h_prev, w_msg)


def _neurcomm(spec, leaves, inputs):
    """NeurComm's e through the kernel's wrapper (the twin on the CPU), from
    ``leaves``: h and the dense weights, packed here."""
    consts, w_fp, w_msg = _packed(spec, leaves, leaves["h"].device)
    return ce.comm_embed(inputs["obs"], inputs["fp"], leaves["h"],
                         inputs["done"], leaves["w_obs"], leaves["b_obs"],
                         w_fp, w_msg, consts.nbr, consts.rev)


def _neurcomm_pre(spec, leaves, inputs):
    consts, w_fp, w_msg = _packed(spec, leaves, leaves["h"].device)
    return _edge_sum_pre(spec, consts, inputs["obs"], inputs["fp"],
                         leaves["h"], inputs["done"], leaves["w_obs"],
                         leaves["b_obs"], w_fp, w_msg)


def _dial_params(spec, leaves):
    """DIAL's parameter tree from ``leaves``, masked or packed as the
    policy's update makes it (``mask_comm_params``), and its consts."""
    consts = tp.policy_consts(spec, leaves["h"].device)
    params = tp.PolicyParams(
        w_obs=FCParams(leaves["w_obs"], leaves["b_obs"]), lstm=None,
        actor=None, critic=None, w_fp=None, w_msg=leaves["w_msg"],
        w_dial=FCParams(leaves["w_dial"], leaves["b_dial"]))
    return tp.mask_comm_params(spec, params, consts), consts


def _dial(spec, leaves, inputs):
    """DIAL's e through ``_embed`` as the policy runs it: the message head,
    then the kernel's wrapper over packed lists (a ``sparse_comm`` spec) or
    the einsums over dense blocks."""
    params, consts = _dial_params(spec, leaves)
    return tp._embed(spec, params, leaves["h"], inputs["obs"], inputs["fp"],
                     consts, inputs["done"])


def _dial_pre(spec, leaves, inputs):
    """The yardstick before its relu: the PyTorch ops that ``_embed`` ran
    for packed DIAL before the kernel (the masked carry, the message head,
    ``edge_sum`` of the messages, the adds)."""
    p, consts = _dial_params(spec, leaves)
    h = leaves["h"] * (1.0 - inputs["done"].to(leaves["h"].dtype))[
        :, None, None]
    msg = torch.einsum("bmh,mhd->bmd", h, p.w_dial.w) + p.w_dial.b
    e = torch.einsum("bns,nsf->bnf", inputs["obs"], p.w_obs.w) + p.w_obs.b
    return e + torch.einsum("bnkx,nkxf->bnf", msg[:, consts.idx], p.w_msg)


def _message(spec, leaves, inputs):
    """DIAL's call from its messages (``leaves["h"]``): the kernel's own
    inputs, no fingerprints, nothing masked."""
    consts, pack = _pack(spec, leaves["h"].device)
    w_msg = pack(leaves["w_msg"])
    return ce.comm_embed(inputs["obs"], None, leaves["h"], None,
                         leaves["w_obs"], leaves["b_obs"], None, w_msg,
                         consts.nbr, consts.rev)


def _message_pre(spec, leaves, inputs):
    consts, pack = _pack(spec, leaves["h"].device)
    w_msg = pack(leaves["w_msg"])
    e = torch.einsum("bns,nsf->bnf", inputs["obs"], leaves["w_obs"]) \
        + leaves["b_obs"]
    return e + torch.einsum("bnkx,nkxf->bnf", leaves["h"][:, consts.idx],
                            w_msg)


# each family's path through the kernel's wrapper, and its yardstick's
# pre-activation; "dial_message": DIAL's call from given messages
FAMILY = {"neurcomm": (tp.CommType.NEURCOMM, _neurcomm, _neurcomm_pre),
          "dial": (tp.CommType.DIAL, _dial, _dial_pre),
          "dial_message": (tp.CommType.DIAL, _message, _message_pre)}
POLICIES = ("neurcomm", "dial")       # the families' paths from the carry


def _leaves(params, inputs):
    """Fresh leaves that take a gradient: h and the dense weights."""
    return {k: v.clone().requires_grad_()
            for k, v in dict(h=inputs["h"], **params).items()}


def _grads(fn, spec, params, inputs):
    """e and the gradients of sum(sin(e)) w.r.t. the carry and the dense
    weights (through the packing)."""
    leaves = _leaves(params, inputs)
    e = fn(spec, leaves, inputs)
    grads = torch.autograd.grad(torch.sin(e.float()).sum(),
                                list(leaves.values()))
    return e.detach(), dict(zip(leaves, grads))


def _yardstick(pre):
    return lambda *args: torch.relu(pre(*args))


TWIN_CASES = [pytest.param(family, graph, B,
                           id=(f"{graph}-{B}" if family == "neurcomm"
                               else f"{family}-{graph}-{B}"))
              for family in POLICIES for graph in GRAPHS for B in (1, 37)]


@pytest.mark.parametrize("family,graph,B", TWIN_CASES)
def test_twin_matches_edge_sum_ops(family, graph, B):
    """The twin through its autograd.Function (the CPU path of ``_embed``)
    against the ops it replaces, in f32: forward 1e-6, every gradient
    1e-5; the carry's rows that are done get no gradient. DIAL (no
    fingerprint term, its messages unmasked) also against its einsums over
    dense blocks, and its bias b_dial takes the gradient of the done rows,
    whose messages are the bias alone."""
    comm, kernel, pre = FAMILY[family]
    adj = GRAPHS[graph]()
    spec, params, inputs = _case(adj, B, n_a=6 if graph == "monaco28" else 5,
                                 comm=comm)
    got, g_got = _grads(kernel, spec, params, inputs)
    wants = [_grads(_yardstick(pre), spec, params, inputs)]
    if comm is tp.CommType.DIAL:
        dense = dataclasses.replace(spec, sparse_comm=False)
        wants.append(_grads(kernel, dense, params, inputs))
    for want, g_want in wants:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        for name in g_want:
            np.testing.assert_allclose(g_got[name].numpy(),
                                       g_want[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    assert float(got.abs().sum()) > 0 and bool((got == 0).any())
    done = inputs["done"] > 0
    assert done.any() == (B > 1) and not g_got["h"][done].any()
    assert g_got["h"][~done].abs().sum() > 0
    if comm is tp.CommType.DIAL:
        ended = dict(inputs, done=torch.ones_like(inputs["done"]))
        _, g_ended = _grads(kernel, spec, params, ended)
        assert not g_ended["h"].any() and not g_ended["w_dial"].any()
        assert g_ended["b_dial"].abs().sum() > 0


def _off(got, want, tol):
    """Elements of ``got`` off the bar ``tol`` (absolute and relative)."""
    got, want = got.float(), want.float()
    return (got - want).abs() > tol + tol * want.abs()


def _against_ops(spec, params, inputs, tol, family="neurcomm"):
    """``family``'s path through ``comm_embed`` (the kernel on a card, the
    twin on the CPU) against the ops it replaces: e, and the gradients of
    sum(e * cot) w.r.t. the carry and the dense weights (through the
    packing). The ops round each product and each add, the kernel once, so a
    pre-activation near 0 can take the other sign there, and a relu mask
    that differs moves the gradient of every sender its receiver row reads.
    Hence: every gradient meets the bar against the ops' gradients taken
    under the kernel's relu mask; the masks differ only where the ops'
    pre-activation lies within the bar of 0; and against the ops' own
    gradients, dh misses the bar only in a (row, sender) whose receivers'
    masks differ. Returns (entries whose masks differ, elements of dh off
    the bar under the ops' own mask)."""
    _, kernel, pre_fn = FAMILY[family]
    mine = _leaves(params, inputs)
    e = kernel(spec, mine, inputs)
    g = torch.Generator(device=e.device).manual_seed(7)
    cot = torch.randn(e.shape, device=e.device, generator=g).to(e.dtype)
    dot = lambda x: (x.float() * cot.float()).sum()
    got = torch.autograd.grad(dot(e), list(mine.values()))
    ops = _leaves(params, inputs)
    pre = pre_fn(spec, ops, inputs)
    on = e.detach() > 0
    assert not _off(e, torch.relu(pre), tol).any(), "e"
    flips = on != (pre.detach() > 0)
    assert not _off(pre.detach()[flips], torch.zeros(()), tol).any()
    want = torch.autograd.grad(dot(torch.where(on, pre, 0.0)),
                               list(ops.values()), retain_graph=True)
    for name, a, b in zip(ops, got, want):
        assert a.dtype == e.dtype, name
        bad = _off(a, b, tol)
        assert not bad.any(), (f"{name}: {int(bad.sum())} elements off by "
                               f"up to {float((a - b).abs().max()):.3e}")
    own = torch.autograd.grad(dot(torch.relu(pre)), ops["h"])[0]
    adj = torch.as_tensor(spec.adj(), device=e.device)
    moved = flips.any(-1).float() @ adj
    bad = _off(got[0], own, tol)
    assert not bad[moved == 0].any()
    return int(flips.sum()), int(bad.sum())


@pytest.mark.parametrize("family,graph", [
    pytest.param(family, graph, id=(graph if family == "neurcomm"
                                    else f"{family}-{graph}"))
    for family in POLICIES for graph in GRAPHS])
def test_twin_matches_edge_sum_ops_in_bf16(family, graph):
    """The twin through its Function against the ops in bf16 at B=37 and
    the bf16 bar 0.05 (``_against_ops``)."""
    adj = GRAPHS[graph]()
    spec, params, inputs = _case(adj, 37, n_a=6 if graph == "monaco28" else 5,
                                 dtype=torch.bfloat16, comm=FAMILY[family][0])
    _against_ops(spec, params, inputs, 0.05, family)


def test_twin_backward_zeroes_empty_slots():
    """The packed weights' gradients of an empty slot are exactly 0, and a
    sender that nobody reads gets no gradient."""
    adj = _random_adj()
    spec, params, inputs = _case(adj, 9)
    consts, w_fp, w_msg = _packed(spec, params)
    args = (inputs["obs"], inputs["fp"], inputs["h"], inputs["done"])
    e = ce.comm_embed_fwd(*args, params["w_obs"], params["b_obs"], w_fp,
                          w_msg, consts.nbr, consts.rev)
    de = torch.randn(e.shape, generator=torch.Generator().manual_seed(1))
    dh, dw_obs, db, dw_fp, dw_msg = ce.comm_embed_bwd(
        *args, w_msg, consts.nbr, consts.rev, e, de)
    empty = consts.nbr < 0
    assert empty.any()
    assert not dw_fp[empty].any() and not dw_msg[empty].any()
    assert dw_msg[~empty].abs().sum() > 0
    assert not dh[:, -1].any()           # agent n-1 is read by nobody
    assert db.shape == (spec.n_agent, spec.n_fc)
    np.testing.assert_allclose(db.numpy(),
                               torch.where(e > 0, de, 0.0).sum(0).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_neighbour_tables(graph):
    """nbr holds each agent's senders by slot (-1 where the slot is
    empty); rev lists, for each sender, receiver * K + slot of every slot
    that reads it, ascending, -1 padded to the largest in-degree."""
    adj = GRAPHS[graph]()
    spec = _spec(adj, 3, 2, 8)
    idx, valid = spec.neighbor_lists()
    nbr, rev = ce.neighbour_tables(idx, valid)
    n, k = idx.shape
    assert nbr.dtype == rev.dtype == np.int32
    for i in range(n):
        senders = np.flatnonzero(adj[i])
        assert list(nbr[i, :len(senders)]) == list(senders)
        assert (nbr[i, len(senders):] == -1).all()
    in_deg = adj.sum(0).astype(int)
    assert rev.shape == (n, max(1, in_deg.max()))
    for m in range(n):
        want = [i * k + s for i in range(n) for s in range(k)
                if nbr[i, s] == m]
        assert list(rev[m, :len(want)]) == want
        assert (rev[m, len(want):] == -1).all()
    consts = tp.policy_consts(spec, "cpu")
    assert torch.equal(consts.nbr, torch.as_tensor(nbr))
    assert torch.equal(consts.rev, torch.as_tensor(rev))


def test_random_graph_reads_more_than_k():
    """The random graph's reverse table is wider than its slots, and has a
    sender with an empty row: the cases the kernel's dh must take."""
    spec = _spec(_random_adj(), 3, 2, 8)
    nbr, rev = ce.neighbour_tables(*spec.neighbor_lists())
    assert rev.shape[1] > nbr.shape[1] == 5
    assert (rev[-1] == -1).all()


OPS_CASES = [(tp.CommType.NEURCOMM, False, False),
             (tp.CommType.NEURCOMM, True, True),
             (tp.CommType.FP, True, False),
             (tp.CommType.DIAL, True, False),
             (tp.CommType.COMMNET, True, False),
             (tp.CommType.NONE, True, False)]


@pytest.mark.parametrize("comm,sparse,nobs", OPS_CASES + [
    (tp.CommType.NEURCOMM, True, False)])
def test_embed_dispatch(monkeypatch, comm, sparse, nobs):
    """``_embed`` takes the kernel's wrapper for packed NEURCOMM and DIAL
    without ``neighbor_obs`` only, and the message head's wrapper for that
    DIAL alone; dense comm, FP, COMMNET, NONE and ``neighbor_obs`` keep
    their ops, and ``policy_step_batched`` gives the same step either way it
    is asked (``done`` folded in, or a masked carry)."""
    calls, heads = [], []
    real, real_head = tp.comm_embed, tp.dial_head
    monkeypatch.setattr(tp, "comm_embed",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tp, "dial_head",
                        lambda *a: heads.append(1) or real_head(*a))
    adj = _grid_adj(3, 3)
    spec = _spec(adj, 5, 4, 8, comm=comm, sparse=sparse, nobs=nobs)
    params = tp.mask_comm_params(spec, tp.init_policy_params(
        torch.Generator().manual_seed(0), spec))
    consts = tp.policy_consts(spec, "cpu")
    rng = np.random.default_rng(2)
    h = torch.tensor(rng.standard_normal((4, 9, 8)).astype(np.float32))
    obs = torch.tensor(rng.standard_normal((4, 9, 5)).astype(np.float32))
    fp = torch.full((4, 9, 4), 0.25)
    done = torch.tensor([0.0, 1.0, 0.0, 1.0])
    e = tp._embed(spec, params, h, obs, fp, consts, done)
    engaged = comm in (tp.CommType.NEURCOMM, tp.CommType.DIAL) \
        and sparse and not nobs
    assert len(calls) == int(engaged)
    assert len(heads) == int(engaged and comm is tp.CommType.DIAL)
    masked = tp._embed(spec, params, h * (1 - done)[:, None, None], obs, fp,
                       consts)
    np.testing.assert_allclose(e.numpy(), masked.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wrapper_refuses_obs_with_gradient_and_detaches_fp():
    spec, params, inputs = _case(_grid_adj(), 3)
    consts, w_fp, w_msg = _packed(spec, params)
    w = (params["w_obs"], params["b_obs"], w_fp, w_msg, consts.nbr,
         consts.rev)
    with pytest.raises(ValueError, match="obs gets no gradient"):
        ce.comm_embed(inputs["obs"].clone().requires_grad_(), inputs["fp"],
                      inputs["h"], inputs["done"], *w)
    fp = inputs["fp"].clone().requires_grad_()
    h = inputs["h"].clone().requires_grad_()
    e = ce.comm_embed(inputs["obs"], fp, h, inputs["done"], *w)
    gh, gf = torch.autograd.grad(e.sum(), [h, fp], allow_unused=True)
    assert gf is None and gh is not None


def test_kernel_variant_and_shared_memory():
    """``takes_tc`` where the LSTM cell takes its tensor-core kernel and the
    [obs | 1 | fp] columns fit 64 (DIAL's call has no fp columns); at the
    flagship's sizes one forward block and two backward blocks fit an SM;
    float32, odd widths, wide fingerprints and large in-degrees take the
    ``general`` kernels."""
    bf, f32 = torch.bfloat16, torch.float32
    assert ce.takes_tc(bf, 12, 5, 4, 64, 64, 4)
    assert ce.takes_tc(bf, 12, 0, 4, 64, 64, 4)
    assert not ce.takes_tc(f32, 12, 0, 4, 64, 64, 4)
    assert ce.takes_tc(bf, 12, 6, 4, 64, 64, 4)
    assert ce.takes_tc(bf, 12, 5, 4, 16, 16, 4)
    assert not ce.takes_tc(f32, 12, 5, 4, 64, 64, 4)
    assert not ce.takes_tc(bf, 12, 5, 4, 8, 8, 4)
    assert not ce.takes_tc(bf, 12, 5, 4, 64, 128, 4)
    assert not ce.takes_tc(bf, 40, 6, 4, 64, 64, 4)
    assert not ce.takes_tc(bf, 12, 5, 4, 64, 64, 40)
    fwd, bwd = ce.tc_shared_bytes(12, 5, 4, 64, 64, 4)
    assert fwd == (304 * 72 * 2 + 3 * (64 * 312 * 2 + 64 * 72 * 2 + 128)
                   + 16 + 80)
    assert bwd == (4 * 64 * 72 * 2 + 3 * (64 * 72 * 2 + 64 * 72 * 2 + 128)
                   + 64 * 64 * 4 + 16 + 56)
    assert fwd <= ce._MAX_SMEM < 2 * fwd and 2 * bwd <= ce._MAX_SMEM
    fwd, bwd = ce.tc_shared_bytes(12, 0, 4, 64, 64, 4)      # DIAL's
    assert fwd == (272 * 72 * 2 + 3 * (64 * 280 * 2 + 64 * 72 * 2 + 128)
                   + 16 + 80)
    assert fwd <= ce._MAX_SMEM and 2 * bwd <= ce._MAX_SMEM
    assert ce.tc_splits(768, 25, 132) == 5 and ce.tc_splits(30, 25, 132) == 1
    assert ce.dh_splits(768, 4) == 8 and ce.dh_splits(10, 4) == 1


def test_wrapper_refuses_other_devices_and_dtypes():
    spec, params, inputs = _case(_grid_adj(), 2)
    consts, w_fp, w_msg = _packed(spec, params)
    args = [inputs["obs"], inputs["fp"], inputs["h"], inputs["done"],
            params["w_obs"], params["b_obs"], w_fp, w_msg, consts.nbr,
            consts.rev]
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        ce.comm_embed_fwd(*meta)


# ---------------------------------------------------------------- the card

CARD_CASES = [
    # (name, graph, B, n_s, n_a, width, dtype, tc); n_a 0: DIAL's call (no
    # fingerprint term, its messages unmasked); tc: whether ``takes_tc``
    # accepts the call (else the ``general`` kernels run)
    ("flagship", "grid25", 768, 12, 5, 64, torch.bfloat16, True),
    ("monaco_768", "monaco28", 768, 12, 6, 64, torch.bfloat16, True),
    ("ragged_k5", "random_k5", 37, 7, 3, 32, torch.bfloat16, True),
    ("eval_b1", "grid25", 1, 12, 5, 64, torch.float32, False),
    ("widths_8", "grid25", 8, 12, 5, 8, torch.float32, False),
    ("ragged_k5_f32", "random_k5", 37, 7, 3, 16, torch.float32, False),
    # bf16 outside the tensor-core rule: twice the flagship's width
    ("flagship_bf16_general", "grid25", 100, 12, 5, 128, torch.bfloat16,
     False),
    ("dial_flagship", "grid25", 768, 12, 0, 64, torch.bfloat16, True),
    ("dial_ragged_k5", "random_k5", 37, 7, 0, 32, torch.bfloat16, True),
    ("dial_eval_b1", "grid25", 1, 12, 0, 64, torch.float32, False),
    ("dial_flagship_f32", "grid25", 768, 12, 0, 64, torch.float32, False),
]
CARD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (0.05, 0.05)}


def _card_args(graph, B, n_s, n_a, width, dtype):
    """The forward's arguments on the card; with ``n_a`` 0 DIAL's: its
    messages from the masked carry through the head, no fp, done or
    w_fp."""
    if n_a:
        spec, params, inputs = _case(GRAPHS[graph](), B, n_s=n_s, n_a=n_a,
                                     width=width, dtype=dtype, device="cuda")
        consts, w_fp, w_msg = _packed(spec, params, "cuda")
        return (inputs["obs"], inputs["fp"], inputs["h"], inputs["done"],
                params["w_obs"], params["b_obs"], w_fp, w_msg, consts.nbr,
                consts.rev)
    spec, params, inputs = _case(GRAPHS[graph](), B, n_s=n_s, width=width,
                                 dtype=dtype, device="cuda",
                                 comm=tp.CommType.DIAL)
    p, consts = _dial_params(spec, dict(params, h=inputs["h"]))
    h = inputs["h"] * (1.0 - inputs["done"])[:, None, None]
    msg = torch.einsum("bmh,mhd->bmd", h, p.w_dial.w) + p.w_dial.b
    return (inputs["obs"], None, msg, None, p.w_obs.w, p.w_obs.b, None,
            p.w_msg, consts.nbr, consts.rev)


def _close(got, want, tol, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    bad = (got - want).abs() > tol + tol * want.abs()
    assert not bad.any(), (f"{what}: {int(bad.sum())} elements off by up to "
                           f"{float((got - want).abs().max()):.3e}")


@needs_cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_cuda_kernels_match_twin(case):
    """Each kernel against the twin on the card, forward and backward, the
    pair ``takes_tc`` picks being the case's; the launch counts move by one
    a call, under DIAL's keys for DIAL's call; two backward calls are
    bitwise equal."""
    name, graph, B, n_s, n_a, width, dtype, tc = case
    fwd = _card_args(graph, B, n_s, n_a, width, dtype)
    assert ce.takes_tc(dtype, n_s, n_a, fwd[8].shape[1], width, width,
                       fwd[9].shape[1]) == tc
    before = dict(ce.LAUNCHES)
    e = ce.comm_embed_fwd(*fwd)
    want = ce.comm_embed_fwd_ref(*fwd[:9])
    torch.cuda.synchronize()
    tol_f, tol_b = CARD_TOL[dtype]
    _close(e, want, tol_f, f"{name} e")
    g = torch.Generator(device="cuda").manual_seed(5)
    de = torch.randn(e.shape, device="cuda", generator=g).to(dtype)
    obs, fp, h, done, _, _, _, w_msg, nbr, rev = fwd
    bwd = (obs, fp, h, done, w_msg, nbr, rev, want, de)
    got_b = ce.comm_embed_bwd(*bwd)
    want_b = ce.comm_embed_bwd_ref(*bwd)
    again = ce.comm_embed_bwd(*bwd)
    torch.cuda.synchronize()
    for what, a, b, c in zip(("dh", "dw_obs", "db_obs", "dw_fp", "dw_msg"),
                             got_b, want_b, again):
        if b is None:
            assert a is None and c is None and fp is None, what
            continue
        _close(a, b, tol_b, f"{name} {what}")
        assert torch.equal(a, c), f"{name} {what} differs between calls"
    moved = {k: v - before[k] for k, v in ce.LAUNCHES.items()
             if v != before[k]}
    base = "comm_embed" if n_a else "comm_embed_dial"
    assert moved == {f"{base}_fwd": 1, f"{base}_bwd": 2}


@needs_cuda
def test_cuda_shared_memory_mirror():
    """The Python mirror of the tensor-core layouts equals the kernel's
    own."""
    lib = ce._kernels()
    for dims in ((12, 5, 4, 64, 64, 4), (12, 6, 4, 64, 64, 4),
                 (7, 3, 5, 32, 32, 9), (12, 0, 4, 64, 64, 4)):
        assert ce.tc_shared_bytes(*dims) == (lib.comm_embed_smem(0, *dims),
                                             lib.comm_embed_smem(1, *dims))


@needs_cuda
@pytest.mark.parametrize("family,dtype,tol", [
    pytest.param(family, dtype, tol, id=("" if family == "neurcomm"
                                         else f"{family}_") + name)
    for family in POLICIES
    for dtype, tol, name in ((torch.bfloat16, 0.05, "bf16_tc"),
                             (torch.float32, 1e-4, "f32_general"))])
def test_cuda_function_matches_edge_sum_ops(family, dtype, tol):
    """Through the autograd.Function on the card at the flagship's shape
    (B=768, the 5x5 grid, widths 64), against the ops it replaces
    (``_against_ops``): bf16 on the tensor cores at the bf16 bar, f32 on
    the CUDA cores with TF32 off at 1e-4; NeurComm's call and DIAL's. For
    DIAL the kernel's own inputs (its messages and weights) meet the bar,
    and so does the whole chain through the message head in f32 and, in
    bf16, the carry's gradient; the head's weight gradients sum the message
    gradient over 768 rows, which the ops round once a slot and the kernel
    once, so in bf16 they part from the ops' by the ops' own rounding
    (up to 0.25 in a few dozen elements): there the kernel's path is held
    to be no farther from float32 than the ops' path."""
    assert not torch.backends.cuda.matmul.allow_tf32
    spec, params, inputs = _case(_grid_adj(), 768, width=64, dtype=dtype,
                                 device="cuda", comm=FAMILY[family][0])
    if family == "neurcomm":
        _against_ops(spec, params, inputs, tol)
        return
    p, _ = _dial_params(spec, dict(params, h=inputs["h"]))
    h = inputs["h"] * (1.0 - inputs["done"])[:, None, None]
    msg = torch.einsum("bmh,mhd->bmd", h, p.w_dial.w) + p.w_dial.b
    _against_ops(spec, {k: params[k] for k in ("w_obs", "b_obs", "w_msg")},
                 dict(inputs, h=msg.detach()), tol, "dial_message")
    if dtype == torch.float32:
        _against_ops(spec, params, inputs, tol, "dial")
    else:
        _head_nearer_float32(spec, params, inputs, tol)


def _head_nearer_float32(spec, params, inputs, tol):
    """DIAL's chain in bf16: the carry's gradient meets the bar against
    the ops; the carry's and the head's gradients are, in RMS, no farther
    from float32 (the ops' chain on the same bf16 values, under the
    kernel's relu mask) than the ops' bf16 path is."""
    _, kernel, pre_fn = FAMILY["dial"]
    mine = _leaves(params, inputs)
    e = kernel(spec, mine, inputs)
    g = torch.Generator(device=e.device).manual_seed(7)
    cot = torch.randn(e.shape, device=e.device, generator=g).to(e.dtype)
    dot = lambda x: (x.float() * cot.float()).sum()
    on = e.detach() > 0
    got = dict(zip(mine, torch.autograd.grad(dot(e), list(mine.values()))))
    ops = _leaves(params, inputs)
    want = dict(zip(ops, torch.autograd.grad(
        dot(torch.where(on, pre_fn(spec, ops, inputs), 0.0)),
        list(ops.values()))))
    f32 = lambda d: {k: v.float() for k, v in d.items()}
    ref = _leaves(f32(params), f32(inputs))
    truth = dict(zip(ref, torch.autograd.grad(
        dot(torch.where(on, pre_fn(spec, ref, f32(inputs)), 0.0)),
        list(ref.values()))))
    assert not _off(got["h"], want["h"], tol).any(), "h"
    rms = lambda a, b: float((a.float() - b).pow(2).mean().sqrt())
    for name in ("h", "w_dial", "b_dial"):
        assert got[name].abs().sum() > 0, name
        assert rms(got[name], truth[name]) <= rms(want[name], truth[name]), \
            name
