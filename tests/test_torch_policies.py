"""The port's batched NeurComm (MA2C_NC) policy step against
``jax.vmap(policy_step)`` of the JAX package, dense and ``sparse_comm``:
logits, values, new carry and every param gradient, from params converted
from JAX. f32; 1e-5 on outputs, 1e-4 on gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprl_network_tpu.envs.grid import build_grid_topology
from deeprl_network_tpu.config import EnvConfig as JEnvConfig
from deeprl_network_tpu.models import policies as jp
from deeprl_network_tpu_torch.models import policies as tp
from deeprl_network_tpu_torch.utils.convert import params_from_jax


def _specs(comm, adj, sparse, n_s=6, n_a=4, width=8):
    kw = dict(n_agent=len(adj), n_s_max=n_s, n_a_max=n_a, n_fc=width,
              n_lstm=width, n_msg=width, sparse_comm=sparse,
              neighbor_mask=adj, action_mask=np.ones((len(adj), n_a),
                                                      np.float32))
    return (jp.PolicySpec(comm_type=jp.CommType(comm.value), **kw),
            tp.PolicySpec(comm_type=comm, **kw))


def _line(n=3):
    adj = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1
    return adj


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


def _jax_step(jspec, params, inputs):
    c, h, obs, fp, done = [jnp.asarray(a) for a in inputs]

    def loss(p):
        mp = jp.mask_comm_params(jspec, p)
        nc, lo, v = jax.vmap(jp.policy_step,
                             in_axes=(None, None, 0, 0, 0, 0))(
            jspec, mp, jp.Carry(c, h), obs, fp, done)
        return jnp.sum(lo ** 2) + jnp.sum(jnp.sin(v)) + jnp.sum(nc.h), \
            (nc, lo, v)
    (_, out), g = jax.value_and_grad(loss, has_aux=True)(params)
    return out, jax.tree.leaves(g)


def _port_step(tspec, params, inputs):
    leaves = [p.requires_grad_() for p in tp.tree_leaves(params)]
    c, h, obs, fp, done = [torch.tensor(a) for a in inputs]
    mp = tp.mask_comm_params(tspec, params)
    nc, lo, v = tp.policy_step_batched(tspec, mp, tp.Carry(c, h), obs, fp,
                                       done)
    loss = torch.sum(lo ** 2) + torch.sum(torch.sin(v)) + torch.sum(nc.h)
    return (nc, lo, v), torch.autograd.grad(loss, leaves)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("comm", [tp.CommType.NEURCOMM, tp.CommType.NONE])
@pytest.mark.parametrize("sparse", [False, True])
def test_policy_step_matches_jax_on_grid25(comm, sparse):
    adj = build_grid_topology(JEnvConfig(scenario="large_grid")).node_adj
    jspec, tspec = _specs(comm, adj, sparse)
    params = jp.init_policy_params(jax.random.key(0), jspec)
    inputs = _inputs(tspec, B=3)
    (jnc, jlo, jv), jg = _jax_step(jspec, params, inputs)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    (tnc, tlo, tv), tg = _port_step(tspec, tparams, inputs)
    np.testing.assert_allclose(_np(tlo), np.asarray(jlo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5, atol=1e-5)
    for a, b in zip(tnc, jnc):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert len(tg) == len(jg)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_sparse_comm_equals_dense():
    adj = build_grid_topology(JEnvConfig(scenario="large_grid")).node_adj
    _, dense = _specs(tp.CommType.NEURCOMM, adj, False)
    _, sparse = _specs(tp.CommType.NEURCOMM, adj, True)
    params = tp.init_policy_params(torch.Generator().manual_seed(0), dense)
    inputs = _inputs(dense, B=2)
    (nc_d, lo_d, v_d), g_d = _port_step(dense, params, inputs)
    params = tp.tree_map(lambda t: t.detach(), params)
    (nc_s, lo_s, v_s), g_s = _port_step(sparse, params, inputs)
    torch.testing.assert_close(lo_s, lo_d, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v_s, v_d, rtol=1e-5, atol=1e-5)
    for a, b in zip(g_s, g_d):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_init_zeroes_non_edges_and_scales_edges():
    adj = _line(4)
    _, spec = _specs(tp.CommType.NEURCOMM, adj, False)
    p = tp.init_policy_params(torch.Generator().manual_seed(0), spec)
    nonedge = torch.as_tensor(adj == 0)
    assert torch.all(p.w_msg[nonedge] == 0) and torch.all(p.w_fp[nonedge] == 0)
    # edge (1, 0): node 1 has degree 2 -> block = sqrt(2)/sqrt(2) * ortho
    blk = p.w_msg[1, 0].double()
    np.testing.assert_allclose((blk.T @ blk).numpy(), np.eye(8), atol=1e-5)


def test_neurcomm_gradient_flows_through_neighbors():
    """d(logit_0)/d(h_1) is nonzero for NEURCOMM and zero for NONE; agent
    2 is never a neighbour of agent 0 on the line graph."""
    for comm, expect_flow in ((tp.CommType.NEURCOMM, True),
                              (tp.CommType.NONE, False)):
        for sparse in (False, True):
            _, spec = _specs(comm, _line(3), sparse, n_s=4, n_a=3)
            params = tp.mask_comm_params(spec, tp.init_policy_params(
                torch.Generator().manual_seed(0), spec))
            h = torch.full((1, 3, 8), 0.1, requires_grad=True)
            obs = torch.ones((1, 3, 4))
            fp = tp.init_fingerprint(spec)[None]
            _, logits, _ = tp.policy_step_batched(
                spec, params, tp.Carry(torch.zeros(1, 3, 8), h), obs, fp,
                torch.zeros(1))
            (g,) = torch.autograd.grad(logits[0, 0].sum(), h)
            if expect_flow:
                assert g[0, 1].abs().sum() > 1e-6
            else:
                assert torch.all(g[0, 1] == 0)
            assert torch.all(g[0, 2] == 0)
