"""The port's five comm types against the JAX package: ``_embed`` and
``policy_step_batched`` with NONE, FP, NEURCOMM, COMMNET and DIAL, dense and
``sparse_comm``, with and without ``neighbor_obs``, on numpy-seeded inputs
and params carried across by ``params_from_jax``. Values at 1e-5; the
gradients w.r.t. ``h_prev``, the fingerprints (zero: they are data) and every
param at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprl_network_tpu.models import policies as jp
from deeprl_network_tpu_torch.models import policies as tp
from deeprl_network_tpu_torch.utils.convert import params_from_jax

COMMS = [tp.CommType.NONE, tp.CommType.FP, tp.CommType.NEURCOMM,
         tp.CommType.COMMNET, tp.CommType.DIAL]
AGENTS = ["ia2c", "ia2c_fp", "ia2c_cu", "ma2c_nc", "ma2c_cnet", "ma2c_dial"]


def _graph():
    """6 agents, degrees 1..3 (a line with one chord), so K-packing pads."""
    adj = np.zeros((6, 6), np.float32)
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (1, 4)]:
        adj[i, j] = adj[j, i] = 1
    return adj


def _specs(comm, sparse, nobs, n_s=5, n_a=4, width=8, n_msg=6):
    adj = _graph()
    amask = np.ones((len(adj), n_a), np.float32)
    amask[2, 3:] = 0                      # one agent with a padded action
    kw = dict(n_agent=len(adj), n_s_max=n_s, n_a_max=n_a, n_fc=width,
              n_lstm=width, n_msg=n_msg, sparse_comm=sparse,
              neighbor_obs=nobs, obs_alpha=0.9, neighbor_mask=adj,
              action_mask=amask)
    return (jp.PolicySpec(comm_type=jp.CommType(comm.value), **kw),
            tp.PolicySpec(comm_type=comm, **kw))


def _inputs(spec, B, seed=1):
    rng = np.random.default_rng(seed)
    n, H = spec.n_agent, spec.n_lstm
    c = (rng.standard_normal((B, n, H)) * 0.5).astype(np.float32)
    h = (rng.standard_normal((B, n, H)) * 0.5).astype(np.float32)
    obs = rng.standard_normal((B, n, spec.n_s_max)).astype(np.float32)
    fp = rng.random((B, n, spec.n_a_max)).astype(np.float32)
    fp /= fp.sum(-1, keepdims=True)
    done = (rng.random(B) < 0.4).astype(np.float32)
    return c, h, obs, fp, done


def _jax_params(jspec, seed=0):
    """JAX init with the zero biases made non-zero, so they are tested."""
    p = jp.init_policy_params(jax.random.key(seed), jspec)
    rng = np.random.default_rng(seed + 7)
    noisy = lambda fc: fc._replace(b=jnp.asarray(
        rng.standard_normal(fc.b.shape).astype(np.float32) * 0.1))
    p = p._replace(w_obs=noisy(p.w_obs), actor=noisy(p.actor))
    if p.w_dial is not None:
        p = p._replace(w_dial=noisy(p.w_dial))
    return p


def _np(t):
    return t.detach().numpy()


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("nobs", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("comm", COMMS)
def test_embed_matches_jax(comm, sparse, nobs):
    jspec, tspec = _specs(comm, sparse, nobs)
    jparams = _jax_params(jspec)
    _, h, obs, fp, _ = _inputs(tspec, B=3)

    def jloss(p, h, fp):
        mp = jp.mask_comm_params(jspec, p)
        e = jax.vmap(lambda hh, o, f: jp._embed(jspec, mp, hh, o, f))(
            h, jnp.asarray(obs), fp)
        return jnp.sum(jnp.sin(e)), e
    (_, je), (jgp, jgh, jgf) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jparams, jnp.asarray(h), jnp.asarray(fp))

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = [p.requires_grad_() for p in tp.tree_leaves(tparams)]
    th = torch.tensor(h, requires_grad=True)
    tf = torch.tensor(fp, requires_grad=True)
    te = tp._embed(tspec, tp.mask_comm_params(tspec, tparams), th,
                   torch.tensor(obs), tf, tp.policy_consts(tspec, "cpu"))
    grads = torch.autograd.grad(torch.sum(torch.sin(te)),
                                leaves + [th, tf], allow_unused=True)
    _close(te, je, 1e-5, "embedding")
    jleaves = jax.tree.leaves(jgp)
    assert len(jleaves) == len(leaves)
    for a, b in zip(grads[:-2], jleaves):
        if a is None:       # a leaf the embedding does not read
            assert not np.asarray(b).any()
        else:
            _close(a, b, 1e-4, "param grad")
    gh, gf = grads[-2:]
    if comm in (tp.CommType.NONE, tp.CommType.FP):
        assert gh is None and not np.asarray(jgh).any()
    else:
        _close(gh, jgh, 1e-4, "grad h_prev")
        assert float(gh.abs().sum()) > 0
    # fingerprints are data: no gradient path in either package
    assert gf is None and not np.asarray(jgf).any()


@pytest.mark.parametrize("sparse,nobs", [(False, False), (True, True)])
@pytest.mark.parametrize("comm", COMMS)
def test_policy_step_matches_jax(comm, sparse, nobs):
    jspec, tspec = _specs(comm, sparse, nobs)
    jparams = _jax_params(jspec)
    inputs = _inputs(tspec, B=4)
    c, h, obs, fp, done = [jnp.asarray(a) for a in inputs]

    def jloss(p):
        mp = jp.mask_comm_params(jspec, p)
        nc, lo, v = jax.vmap(jp.policy_step,
                             in_axes=(None, None, 0, 0, 0, 0))(
            jspec, mp, jp.Carry(c, h), obs, fp, done)
        return jnp.sum(lo[..., :3] ** 2) + jnp.sum(jnp.sin(v)) \
            + jnp.sum(nc.h), (nc, lo, v)
    (_, (jnc, jlo, jv)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jparams)

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = [p.requires_grad_() for p in tp.tree_leaves(tparams)]
    tc, th, tobs, tfp, tdone = [torch.tensor(a) for a in inputs]
    tnc, tlo, tv = tp.policy_step_batched(
        tspec, tp.mask_comm_params(tspec, tparams), tp.Carry(tc, th), tobs,
        tfp, tdone)
    loss = torch.sum(tlo[..., :3] ** 2) + torch.sum(torch.sin(tv)) \
        + torch.sum(tnc.h)
    tg = torch.autograd.grad(loss, leaves)
    _close(tlo, jlo, 1e-5, "logits")
    _close(tv, jv, 1e-5, "values")
    _close(tnc.c, jnc.c, 1e-5, "c")
    _close(tnc.h, jnc.h, 1e-5, "h")
    for a, b in zip(tg, jax.tree.leaves(jg)):
        _close(a, b, 1e-4, "param grad")


def test_mask_comm_params_leaves_commnet_map_untouched():
    """COMMNET's shared [H, F] map is no stack of edge blocks: neither the
    dense mask nor the K-packing may index it."""
    for sparse in (False, True):
        _, spec = _specs(tp.CommType.COMMNET, sparse, True)
        p = tp.init_policy_params(torch.Generator().manual_seed(0), spec)
        assert p.w_msg.shape == (8, 8)
        mp = tp.mask_comm_params(spec, p)
        assert mp.w_msg is p.w_msg
        k = int(_graph().sum(1).max())
        assert mp.w_nobs.shape == ((6, k, 5, 8) if sparse else (6, 6, 5, 8))


@pytest.mark.parametrize("agent", AGENTS)
def test_init_shapes_match_jax_and_convert(agent):
    """Every family's leaves, ``w_dial`` (an FCParams inside PolicyParams),
    ``w_nobs`` and COMMNET's 2-D ``w_msg`` included: the port's init has the
    JAX init's structure and shapes, and ``params_from_jax`` carries the JAX
    values across unchanged."""
    comm = tp.AGENT_TO_COMM[agent]
    jspec, tspec = _specs(comm, False, True)
    jparams = jp.init_policy_params(jax.random.key(0), jspec)
    tparams = tp.init_policy_params(torch.Generator().manual_seed(0), tspec)
    conv = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert type(conv) is tp.PolicyParams
    for name in tp.PolicyParams._fields:
        j, t, c = (getattr(x, name) for x in (jparams, tparams, conv))
        assert (j is None) == (t is None) == (c is None), name
        if j is None:
            continue
        assert type(t).__name__ == type(j).__name__ == type(c).__name__ \
            or not isinstance(j, tuple), name
        for a, b, d in zip(tp.tree_leaves(t), jax.tree.leaves(j),
                           tp.tree_leaves(c)):
            assert tuple(a.shape) == b.shape == tuple(d.shape), name
            assert np.array_equal(d.numpy(), np.asarray(b)), name
    if comm is tp.CommType.COMMNET:
        assert conv.w_msg.ndim == 2
    if comm is tp.CommType.DIAL:
        assert conv.w_dial.w.shape == (6, 8, 6)
        assert conv.w_msg.shape == (6, 6, 6, 8)
    # non-edge blocks start at zero in both
    nonedge = torch.as_tensor(_graph() == 0)
    for w in (tparams.w_fp, tparams.w_nobs):
        assert w is None or torch.all(w[nonedge] == 0)


def test_init_draw_order_keeps_earlier_seeds():
    """The leaves NONE and NEURCOMM had before the other families were
    added are drawn first and in the same order, so a seed still gives the
    same params: ``neighbor_obs`` only appends a draw."""
    for comm in (tp.CommType.NONE, tp.CommType.NEURCOMM):
        _, plain = _specs(comm, False, False)
        _, nobs = _specs(comm, False, True)
        a = tp.init_policy_params(torch.Generator().manual_seed(3), plain)
        b = tp.init_policy_params(torch.Generator().manual_seed(3), nobs)
        for x, y in zip(tp.tree_leaves(a),
                        tp.tree_leaves(b._replace(w_nobs=None))):
            assert torch.equal(x, y)


@pytest.mark.parametrize("comm", [tp.CommType.COMMNET, tp.CommType.DIAL])
def test_message_gradient_reaches_neighbours_only(comm):
    """d(logit_0)/d(h_j) is non-zero for the neighbour 1 and zero for the
    non-neighbour 3."""
    for sparse in (False, True):
        _, spec = _specs(comm, sparse, False)
        params = tp.mask_comm_params(spec, tp.init_policy_params(
            torch.Generator().manual_seed(0), spec))
        h = torch.full((1, 6, 8), 0.1, requires_grad=True)
        _, logits, _ = tp.policy_step_batched(
            spec, params, tp.Carry(torch.zeros(1, 6, 8), h),
            torch.ones((1, 6, 5)), tp.init_fingerprint(spec)[None],
            torch.zeros(1))
        (g,) = torch.autograd.grad(logits[0, 0, :3].sum(), h)
        assert g[0, 1].abs().sum() > 1e-6
        assert torch.all(g[0, 3] == 0)
