"""The port's NN primitives, optimizer, schedules and A2C math against
closed forms and the JAX package (numpy-seeded inputs, f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprl_network_tpu.models import a2c as ja2c
from deeprl_network_tpu.models.layers import tf1_rmsprop as jtf1_rmsprop
from deeprl_network_tpu.utils.scheduler import make_schedule as jschedule
from deeprl_network_tpu_torch.models import a2c
from deeprl_network_tpu_torch.models.layers import (
    LSTMParams, fc_init, lstm_init, lstm_step, ortho_init, tf1_rmsprop,
)
from deeprl_network_tpu_torch.utils.scheduler import make_schedule


def _np_lstm_step(wx, wh, b, c, h, x, done):
    """Closed form: gates (i, f, o, u), done-mask BEFORE the gates."""
    c = c * (1 - done)
    h = h * (1 - done)
    z = x @ wx + h @ wh + b
    i, f, o, u = np.split(z, 4, axis=-1)
    sig = lambda v: 1 / (1 + np.exp(-v))
    i, f, o, u = sig(i), sig(f), sig(o), np.tanh(u)
    c2 = f * c + i * u
    return c2, o * np.tanh(c2)


@pytest.mark.parametrize("done", [0.0, 1.0])
def test_lstm_step_matches_closed_form(done):
    rng = np.random.RandomState(0)
    n_in, n_h = 5, 4
    arrs = [rng.randn(n_in, 4 * n_h), rng.randn(n_h, 4 * n_h),
            rng.randn(4 * n_h), rng.randn(n_h), rng.randn(n_h),
            rng.randn(n_in)]
    wx, wh, b, c, h, x = [a.astype(np.float32) for a in arrs]
    t = lambda a: torch.tensor(a)
    (c2, h2), out = lstm_step(LSTMParams(t(wx), t(wh), t(b)), (t(c), t(h)),
                              t(x), torch.tensor(done))
    ec, eh = _np_lstm_step(wx, wh, b, c, h, x, done)
    np.testing.assert_allclose(c2.numpy(), ec, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), eh, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), eh, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,scale", [((64, 64), 1.0),
                                         ((32, 32), np.sqrt(2.0)),
                                         ((16, 64), 1.0),
                                         ((64, 16), 0.01),
                                         ((3, 16, 16), 1.0)])
def test_ortho_init_orthogonal_with_scale(shape, scale):
    w = ortho_init(shape, scale, generator=torch.Generator().manual_seed(0))
    assert w.shape == shape and w.dtype == torch.float32
    w = w.double().reshape(-1, *shape[-2:]).numpy()
    n_in, n_out = shape[-2:]
    for blk in w:
        # orthonormal columns (n_in >= n_out) or rows (n_in < n_out)
        gram = blk.T @ blk if n_in >= n_out else blk @ blk.T
        np.testing.assert_allclose(gram, scale ** 2 * np.eye(min(shape[-2:])),
                                   atol=1e-5 * max(scale ** 2, 1e-4) + 1e-9)
    if len(w) > 1:
        assert not np.allclose(w[0], w[1])


def test_fc_and_lstm_init_shapes_and_zero_bias():
    g = torch.Generator().manual_seed(0)
    fc = fc_init(12, 8, batch_shape=(5,), generator=g)
    assert fc.w.shape == (5, 12, 8) and torch.equal(fc.b, torch.zeros(5, 8))
    p = lstm_init(8, 4, batch_shape=(5,), generator=g)
    assert p.wx.shape == (5, 8, 16) and p.wh.shape == (5, 4, 16)
    assert torch.equal(p.b, torch.zeros(5, 16))


def test_tf1_rmsprop_matches_optax_chain():
    """3 updates on the same grads, the second one clipped (norm > 40)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * scale
              for s in shapes] for scale in (0.5, 30.0, 2.0)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs)) for gs in grads]
    assert norms[0] < 40 < norms[1]
    lr = lambda count: 1e-3 * (1.0 + count)
    jopt = jtf1_rmsprop(lr, decay=0.99, eps=1e-5, max_grad_norm=40.0)
    topt = tf1_rmsprop(lr, decay=0.99, eps=1e-5, max_grad_norm=40.0)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.tensor(p) for p in params]
    jst, tst = jopt.init(jp), topt.init(tp)
    for gs in grads:
        ju, jst = jopt.update([jnp.asarray(g) for g in gs], jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = topt.update([torch.tensor(g) for g in gs], tst)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-8)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert tst.count == 3


def test_tf1_rmsprop_closed_form():
    lr, alpha, eps = 1e-3, 0.99, 1e-5
    opt = tf1_rmsprop(lambda c: lr, decay=alpha, eps=eps, max_grad_norm=1e9)
    g = np.array([0.5, 0.25], np.float32)
    (u,), _ = opt.update([torch.tensor(g)], opt.init([torch.zeros(2)]))
    expected = -lr * g / np.sqrt((1 - alpha) * g ** 2 + eps)
    np.testing.assert_allclose(u.numpy(), expected, rtol=1e-5)


@pytest.mark.parametrize("kind,ratio", [("constant", 1.0), ("linear", 0.5)])
def test_schedule_matches_jax(kind, ratio):
    js = jschedule(kind, 0.01, 1000, 1e-4, ratio)
    ts = make_schedule(kind, 0.01, 1000, 1e-4, ratio)
    for step in (0, 1, 250, 499, 500, 2000):
        assert ts(step) == float(js(jnp.asarray(step, jnp.int32)))


def test_nstep_returns_hand_computed():
    r = torch.tensor([[1.0], [2.0], [3.0]])
    R = a2c.nstep_returns(r, torch.tensor([0.0, 1.0, 0.0]),
                          torch.tensor([10.0]), 0.9)
    np.testing.assert_allclose(R[:, 0].numpy(), [2.8, 2.0, 12.0], rtol=1e-6)


def test_nstep_returns_matches_jax_batched():
    rng = np.random.default_rng(0)
    T, B, N = 7, 3, 4
    r = rng.standard_normal((T, B, N)).astype(np.float32)
    d = (rng.random((T, B)) < 0.3).astype(np.float32)
    boot = rng.standard_normal((B, N)).astype(np.float32)
    want = jax.vmap(ja2c.nstep_returns, in_axes=(1, 1, 0, None),
                    out_axes=1)(jnp.asarray(r), jnp.asarray(d),
                                jnp.asarray(boot), 0.99)
    got = a2c.nstep_returns(torch.tensor(r), torch.tensor(d),
                            torch.tensor(boot), 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_normalize_and_spatial_mix_match_jax():
    rng = np.random.default_rng(1)
    r = (rng.standard_normal((5, 3, 4)) * 5000).astype(np.float32)
    D = rng.random((4, 4)).astype(np.float32)
    jr = ja2c.spatial_mix(ja2c.normalize_rewards(jnp.asarray(r), 2000.0, 2.0),
                          jnp.asarray(D))
    tr = a2c.spatial_mix(a2c.normalize_rewards(torch.tensor(r), 2000.0, 2.0),
                         torch.tensor(D))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6)


def test_action_stats_with_masked_action_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 4, 5)).astype(np.float32)
    logits[:, 1, 4] = -1e9            # agent 1 has 4 valid actions
    actions = rng.integers(0, 4, (6, 4))
    jl, je = ja2c.action_stats(jnp.asarray(logits), jnp.asarray(actions))
    tl, te = a2c.action_stats(torch.tensor(logits), torch.tensor(actions))
    assert torch.isfinite(te).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)


def test_a2c_loss_terms_match_jax_with_grads():
    rng = np.random.default_rng(3)
    shape = (5, 3, 4)
    logp, ent, val, ret, adv = [rng.standard_normal(shape).astype(np.float32)
                                for _ in range(5)]

    def jloss(lp, en, v):
        return ja2c.a2c_loss_terms(lp, en, v, jnp.asarray(ret),
                                   jnp.asarray(adv), 0.01, 0.5)
    (jtot, jstats), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(logp), jnp.asarray(ent), jnp.asarray(val))
    t = [torch.tensor(a, requires_grad=True) for a in (logp, ent, val)]
    ttot, tstats = a2c.a2c_loss_terms(*t, torch.tensor(ret),
                                      torch.tensor(adv), 0.01, 0.5)
    tg = torch.autograd.grad(ttot, t)
    for a, b in zip(tstats, jstats):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
