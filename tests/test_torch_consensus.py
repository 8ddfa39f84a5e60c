"""The port's IA2C_CU weight consensus against the JAX package: the plain
row-normalized (A + I) average and the shape-aware form (``action_mask``,
``obs_mask``, per-edge blocks), on a homogeneous and on heterogeneous specs,
from params carried across by ``params_from_jax``. Every leaf at 1e-5."""

import jax
import numpy as np
import pytest
import torch

from deeprl_network_tpu.models import policies as jp
from deeprl_network_tpu_torch.models import policies as tp
from deeprl_network_tpu_torch.utils.convert import params_from_jax

LINE3 = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]], np.float32)
PAIR = np.array([[0, 1], [1, 0]], np.float32)


def _amask(n_a_ls):
    m = np.zeros((len(n_a_ls), max(n_a_ls)), np.float32)
    for i, na in enumerate(n_a_ls):
        m[i, :na] = 1.0
    return m


# name -> (adjacency, comm, spec kwargs, action_mask, obs_mask)
CASES = {
    "plain_homogeneous": (LINE3, "none", dict(n_s_max=4, n_a_max=3),
                          None, None),
    "masked_all_ones": (LINE3, "none", dict(n_s_max=4, n_a_max=3),
                        np.ones((3, 3), np.float32),
                        np.ones((3, 4), np.float32)),
    "masked_heterogeneous_heads": (
        LINE3, "none", dict(n_s_max=4, n_a_max=6,
                            action_mask=_amask((2, 6, 2))),
        _amask((2, 6, 2)), None),
    "masked_obs_rows": (
        PAIR, "none", dict(n_s_max=4, n_a_max=3), None,
        np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)),
    "masked_both_heterogeneous": (
        LINE3, "none", dict(n_s_max=4, n_a_max=6,
                            action_mask=_amask((2, 6, 2))),
        _amask((2, 6, 2)),
        np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 0]], np.float32)),
    "plain_edge_blocks": (LINE3, "neurcomm", dict(n_s_max=4, n_a_max=3,
                                                  neighbor_obs=True),
                          None, None),
    "masked_edge_blocks": (LINE3, "neurcomm", dict(n_s_max=4, n_a_max=3,
                                                   neighbor_obs=True),
                           np.ones((3, 3), np.float32), None),
    "masked_dial": (LINE3, "dial", dict(n_s_max=4, n_a_max=3, n_msg=5),
                    np.ones((3, 3), np.float32), None),
    "plain_commnet_shared_map": (LINE3, "commnet",
                                 dict(n_s_max=4, n_a_max=3), None, None),
    "masked_commnet_shared_map": (LINE3, "commnet",
                                  dict(n_s_max=4, n_a_max=3),
                                  np.ones((3, 3), np.float32), None),
}


def _both(name, seed=0):
    adj, comm, kw, amask, omask = CASES[name]
    kw = dict(n_agent=len(adj), n_fc=8, n_lstm=8, neighbor_mask=adj, **kw)
    jspec = jp.PolicySpec(comm_type=jp.CommType(comm), **kw)
    jparams = jp.init_policy_params(jax.random.key(seed), jspec)
    # biases start at zero: give them values, so their average is tested
    rng = np.random.default_rng(seed)
    jparams = jax.tree.map(
        lambda x: x + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        if x.ndim <= 2 and x.shape[0] == len(adj) else x, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return adj, amask, omask, jparams, tparams


@pytest.mark.parametrize("name", list(CASES))
def test_consensus_update_matches_jax(name):
    adj, amask, omask, jparams, tparams = _both(name)
    jnew = jp.consensus_update(jparams, adj, amask, omask)
    tnew = tp.consensus_update(tparams, adj, amask, omask)
    jl, tl = jax.tree.leaves(jnew), tp.tree_leaves(tnew)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    moved = [not torch.equal(a, b)
             for a, b in zip(tl, tp.tree_leaves(tparams))]
    assert any(moved)
    if "commnet" in name:       # no agent axis: returned as it is
        assert tnew.w_msg is tparams.w_msg


def test_consensus_matrix_equals_jax():
    adj = np.zeros((5, 5), np.float32)
    for i, j in [(0, 1), (1, 2), (1, 3), (3, 4)]:
        adj[i, j] = adj[j, i] = 1
    assert np.array_equal(tp.consensus_matrix(adj), jp.consensus_matrix(adj))
    np.testing.assert_allclose(tp.consensus_matrix(LINE3)[0], [0.5, 0.5, 0])


def test_masked_consensus_keeps_padded_slices():
    """The rule itself, not only parity: on n_a = (2, 6, 2) an agent's
    padded head columns keep their own value, columns valid on one agent
    only are unchanged, and shared columns average over the agents that
    own them."""
    adj, amask, _, _, tparams = _both("masked_heterogeneous_heads", seed=3)
    w = tparams.actor.w
    nw = tp.consensus_update(tparams, adj, amask).actor.w
    torch.testing.assert_close(nw[0, :, 0], (w[0, :, 0] + w[1, :, 0]) / 2)
    assert torch.equal(nw[0, :, 2:], w[0, :, 2:])
    torch.testing.assert_close(nw[1, :, 2:], w[1, :, 2:])
    torch.testing.assert_close(nw[1, :, 0], w[:, :, 0].mean(0))


def test_consensus_is_exact_in_low_precision_settings():
    """The average is not computed in the compute dtype: bf16 params come
    back as the rounded f32-exact average, not a bf16 product."""
    _, _, _, _, tparams = _both("plain_homogeneous")
    want = tp.consensus_update(tparams, LINE3).lstm.wx
    half = tp.tree_map(lambda t: t.to(torch.bfloat16), tparams)
    got = tp.consensus_update(half, LINE3).lstm.wx
    assert got.dtype == torch.bfloat16
    exact = tp.consensus_update(tp.tree_map(lambda t: t.float(), half),
                                LINE3).lstm.wx
    assert torch.equal(got, exact.to(torch.bfloat16))
    assert float((got.float() - want).abs().max()) < 0.02
