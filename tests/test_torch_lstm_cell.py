"""The port's fused per-agent LSTM cell against the JAX package.

On the CPU the port's ``fused_agent_lstm`` runs its plain twins; they are
held against the JAX reference cell (``jax.vmap(lstm_step)``) and the
Pallas kernel in interpret mode, forward and gradients: the seven cases of
tests/test_pallas_ops.py, at its tolerances (1e-5 forward, 1e-4 grads, 0.05
bf16). A float64 gradcheck covers the autograd.Function's backward.

The CUDA kernels are held against the same twins on the same inputs by the
tests marked ``needs_cuda``, which skip without a card. JAX is imported
inside the fixture that needs it, so on a machine without JAX those card
tests still run:

    python -m pytest --noconftest -q tests/test_torch_lstm_cell.py -k cuda
"""

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.ops import lstm_cell as lc
from deeprl_network_tpu_torch.ops.lstm_cell import fused_agent_lstm

# decided when each test is set up, not at import
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

NAMES = ["wx", "wh", "b", "c", "h", "x"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX reference: vmapped lstm_step and the interpret-mode Pallas
    cell."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deeprl_network_tpu.models.layers import LSTMParams, lstm_step
    from deeprl_network_tpu.ops.pallas_lstm import fused_agent_lstm as pal

    def ref_step(wx, wh, b, c, h, x, done):
        p = LSTMParams(wx, wh, b)

        def per_env(c, h, x, d):
            (c2, h2), _ = jax.vmap(lstm_step, in_axes=(0, 0, 0, None))(
                p, (c, h), x, d)
            return c2, h2
        return jax.vmap(per_env)(c, h, x, done)

    def pallas_step(wx, wh, b, c, h, x, done):
        return pal((wx, wh, b), (c, h), x, done, True)

    def loss_grads(step, args, done):
        def loss(wx, wh, b, c, h, x):
            c2, h2 = step(wx, wh, b, c, h, x, done)
            return (jnp.sum(h2.astype(jnp.float32) ** 2)
                    + jnp.sum(jnp.sin(c2.astype(jnp.float32))))
        g = jax.grad(loss, argnums=tuple(range(6)))(
            *[jnp.asarray(a) for a in args])
        return [np.asarray(v, np.float32) for v in g]

    class NS:
        pass
    ns = NS()
    ns.jax, ns.jnp = jax, jnp
    ns.ref_step, ns.pallas_step, ns.loss_grads = ref_step, pallas_step, \
        loss_grads
    return ns


def setup(B=8, N=3, F=16, H=16, seed=0):
    """Numpy-seeded (wx, wh, b, c, h, x) and done."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    args = [f(N, F, 4 * H, scale=F ** -0.5), f(N, H, 4 * H, scale=H ** -0.5),
            f(N, 4 * H, scale=0.1), f(B, N, H), f(B, N, H), f(B, N, F)]
    done = (rng.random(B) < 0.3).astype(np.float32)
    return args, done


def port_step(args, done, device="cpu", dtype=torch.float32):
    t = [torch.tensor(a, device=device).to(dtype) for a in args]
    wx, wh, b, c, h, x = t
    c2, h2 = fused_agent_lstm((wx, wh, b), (c, h), x,
                              torch.tensor(done, device=device))
    return c2, h2


def port_grads(args, done, device="cpu", dtype=torch.float32):
    t = [torch.tensor(a, device=device).to(dtype).requires_grad_()
         for a in args]
    wx, wh, b, c, h, x = t
    c2, h2 = fused_agent_lstm((wx, wh, b), (c, h), x,
                              torch.tensor(done, device=device))
    loss = torch.sum(h2.float() ** 2) + torch.sum(torch.sin(c2.float()))
    grads = torch.autograd.grad(loss, t)
    for g, a in zip(grads, t):
        assert g.dtype == a.dtype
    return [g.float().cpu().numpy() for g in grads]


def _np(t):
    return t.float().detach().cpu().numpy()


def test_forward_matches_reference(J):
    args, done = setup()
    c_ref, h_ref = J.ref_step(*[J.jnp.asarray(a) for a in args],
                              J.jnp.asarray(done))
    c_pal, h_pal = J.pallas_step(*[J.jnp.asarray(a) for a in args],
                                 J.jnp.asarray(done))
    c, h = port_step(args, done)
    for want in ((c_ref, h_ref), (c_pal, h_pal)):
        np.testing.assert_allclose(_np(c), np.asarray(want[0]), atol=1e-5)
        np.testing.assert_allclose(_np(h), np.asarray(want[1]), atol=1e-5)


def test_gradients_match_reference(J):
    args, done = setup()
    g_ref = J.loss_grads(J.ref_step, args, J.jnp.asarray(done))
    g_pal = J.loss_grads(J.pallas_step, args, J.jnp.asarray(done))
    g = port_grads(args, done)
    for want in (g_ref, g_pal):
        for a, b, name in zip(g, want, NAMES):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                       err_msg=name)


def test_done_masks_carry_gradient():
    args, done = setup()
    g = port_grads(args, np.ones_like(done))
    np.testing.assert_allclose(g[3], 0.0, atol=1e-7)   # c
    np.testing.assert_allclose(g[4], 0.0, atol=1e-7)   # h


def test_odd_batch_sizes(J):
    args, done = setup(B=12)
    c_ref, h_ref = J.ref_step(*[J.jnp.asarray(a) for a in args],
                              J.jnp.asarray(done))
    c, h = port_step(args, done)
    np.testing.assert_allclose(_np(h), np.asarray(h_ref), atol=1e-5)
    np.testing.assert_allclose(_np(c), np.asarray(c_ref), atol=1e-5)


def test_policy_step_batched_matches_vmap(J):
    """The port's policy_step_batched (fused cell) equals the JAX
    jax.vmap(policy_step): outputs and parameter gradients."""
    jax, jnp = J.jax, J.jnp
    from deeprl_network_tpu.models import policies as jp
    from deeprl_network_tpu_torch.models import policies as tp
    from deeprl_network_tpu_torch.utils.convert import params_from_jax

    n, B = 4, 6
    adj = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1
    kw = dict(n_agent=n, n_s_max=5, n_a_max=3, n_fc=8, n_lstm=8, n_msg=8,
              neighbor_mask=adj, action_mask=np.ones((n, 3), np.float32))
    jspec = jp.PolicySpec(comm_type=jp.CommType.NEURCOMM, **kw)
    tspec = tp.PolicySpec(comm_type=tp.CommType.NEURCOMM, **kw)
    params = jp.init_policy_params(jax.random.key(0), jspec)
    rng = np.random.default_rng(1)
    c = (rng.standard_normal((B, n, 8)) * 0.3).astype(np.float32)
    h = (rng.standard_normal((B, n, 8)) * 0.3).astype(np.float32)
    obs = rng.standard_normal((B, n, 5)).astype(np.float32)
    fp = rng.random((B, n, 3)).astype(np.float32)
    fp /= fp.sum(-1, keepdims=True)
    done = np.array([0., 1., 0., 0., 1., 0.], np.float32)

    def jloss(p):
        mp = jp.mask_comm_params(jspec, p)
        nc, lo, v = jax.vmap(jp.policy_step, in_axes=(None, None, 0, 0, 0, 0))(
            jspec, mp, jp.Carry(jnp.asarray(c), jnp.asarray(h)),
            jnp.asarray(obs), jnp.asarray(fp), jnp.asarray(done))
        return jnp.sum(lo ** 2) + jnp.sum(v ** 2), (nc, lo, v)
    (_, (nc_r, lo_r, v_r)), g_r = jax.value_and_grad(jloss, has_aux=True)(
        params)

    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    leaves = [p.requires_grad_() for p in tp.tree_leaves(tparams)]
    mp = tp.mask_comm_params(tspec, tparams)
    nc, lo, v = tp.policy_step_batched(
        tspec, mp, tp.Carry(torch.tensor(c), torch.tensor(h)),
        torch.tensor(obs), torch.tensor(fp), torch.tensor(done))
    g = torch.autograd.grad(torch.sum(lo ** 2) + torch.sum(v ** 2), leaves)
    np.testing.assert_allclose(_np(lo), np.asarray(lo_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(v), np.asarray(v_r), rtol=1e-5, atol=1e-5)
    for a, b in zip(nc, nc_r):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    jl = jax.tree.leaves(g_r)
    assert len(jl) == len(g)
    for a, b in zip(g, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_bf16_forward_matches_f32_reference(J):
    args, done = setup()
    c_ref, h_ref = J.ref_step(*[J.jnp.asarray(a) for a in args],
                              J.jnp.asarray(done))
    c, h = port_step(args, done, dtype=torch.bfloat16)
    assert c.dtype == torch.bfloat16 and h.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(c), np.asarray(c_ref), atol=0.05,
                               rtol=0.05)
    np.testing.assert_allclose(_np(h), np.asarray(h_ref), atol=0.05,
                               rtol=0.05)


def test_bf16_gradients_match_f32_reference(J):
    args, done = setup()
    g_ref = J.loss_grads(J.ref_step, args, J.jnp.asarray(done))
    g = port_grads(args, done, dtype=torch.bfloat16)
    for a, b, name in zip(g, g_ref, NAMES):
        np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05, err_msg=name)


def test_plain_backward_gradcheck():
    """The autograd.Function's backward (the plain twin on the CPU)
    against finite differences in float64."""
    args, done = setup(B=4, N=2, F=3, H=2)
    t = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
         for a in args]
    d = torch.tensor(done, dtype=torch.float64)
    d[0], d[1] = 0.0, 1.0  # one masked and one live row

    def f(wx, wh, b, c, h, x):
        return fused_agent_lstm((wx, wh, b), (c, h), x, d)
    assert torch.autograd.gradcheck(f, t)


def test_plain_fwd_residuals_are_masked_carry():
    args, done = setup()
    wx, wh, b, c, h, x = [torch.tensor(a) for a in args]
    d = torch.tensor(done)
    _, _, h_in, c_in = lc.lstm_cell_fwd(wx, wh, b, c, h, x, d)
    keep = (1.0 - d)[:, None, None]
    assert torch.equal(h_in, h * keep) and torch.equal(c_in, c * keep)
    assert lc.lstm_cell_fwd(wx, wh, b, c, h, x, d, residuals=False)[2] is None


# a cell wider than the general kernel's old cap of F + H <= 256
WIDE = dict(B=6, N=2, F=64, H=256)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.05)])
def test_wide_cell_forward_matches_reference(J, dtype, tol):
    """The twin (the card's general kernels' yardstick) at K = 320 against
    the JAX reference cell and the interpret-mode Pallas cell."""
    args, done = setup(**WIDE)
    jargs = [J.jnp.asarray(a) for a in args]
    c, h = port_step(args, done, dtype=dtype)
    for want in (J.ref_step(*jargs, J.jnp.asarray(done)),
                 J.pallas_step(*jargs, J.jnp.asarray(done))):
        np.testing.assert_allclose(_np(c), np.asarray(want[0]), atol=tol,
                                   rtol=tol if dtype == torch.bfloat16 else 0)
        np.testing.assert_allclose(_np(h), np.asarray(want[1]), atol=tol,
                                   rtol=tol if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.05)])
def test_wide_cell_gradients_match_reference(J, dtype, tol):
    args, done = setup(**WIDE)
    g = port_grads(args, done, dtype=dtype)
    wants = [J.loss_grads(J.ref_step, args, J.jnp.asarray(done))]
    if dtype == torch.float32:
        wants.append(J.loss_grads(J.pallas_step, args, J.jnp.asarray(done)))
    for want in wants:
        for a, b, name in zip(g, want, NAMES):
            np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                       err_msg=name)


PLAN_CASES = [  # (B, N, F, H): the .ini steps, eval at B=1, the flagship
    (32, 28, 64, 64), (32, 8, 64, 64), (1, 25, 64, 64), (1, 28, 64, 64),
    (1, 8, 64, 64), (768, 25, 64, 64), (37, 3, 64, 256), (5, 2, 128, 1024),
    (12, 3, 16, 16), (37, 5, 24, 40), (9, 2, 5, 7),
]


@pytest.mark.parametrize("B,N,F,H", PLAN_CASES)
def test_general_plan_covers_every_output_once(B, N, F, H):
    """Each kernel's blocks, mapped as ``GeneralPlan`` states, own every
    (agent, row, hidden unit), (agent, row, K column) and (agent, K row, 4H
    column) exactly once; B=1 takes one-row gate tiles."""
    p = lc.general_plan(B, N, F, H, 132)
    K, G = F + H, 4 * H
    assert p.act_rows <= max(B, 1) and (B > 1 or p.act_rows == 1)

    def cover(grid, tiles_x, tile_x, rows, extent):
        seen = np.zeros((N, B, extent), np.int32)
        for bx in range(grid[0]):
            n, t = divmod(bx, tiles_x)
            for by in range(grid[1]):
                seen[n, by * rows:(by + 1) * rows,
                     t * tile_x:(t + 1) * tile_x] += 1
        return seen
    assert p.act_grid[0] == N * -(-H // p.act_units)
    assert (cover(p.act_grid, -(-H // p.act_units), p.act_units, p.act_rows,
                  H) == 1).all()
    assert p.dxdh_grid[0] == N * -(-K // p.dxdh_cols)
    assert (cover(p.dxdh_grid, -(-K // p.dxdh_cols), p.dxdh_cols,
                  p.dxdh_rows, K) == 1).all()
    n_w, ky, mz = p.weight_grid
    seen = np.zeros((N, K, G), np.int32)
    for n in range(n_w):
        for y in range(ky):
            for z in range(mz):
                seen[n, y * 64:(y + 1) * 64, z * 64:(z + 1) * 64] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("N", [8, 28])
def test_general_plan_fills_the_card_at_b32(N):
    """At the .ini files' B=32 (CACC N=8, Monaco N=28) every kernel's grid
    has at least one block per SM of an H100; at B=1 the gate kernels still
    give each agent several blocks."""
    p = lc.general_plan(32, N, 64, 64, 132)
    assert p.act_grid[0] * p.act_grid[1] >= 132
    assert p.dxdh_grid[0] * p.dxdh_grid[1] >= 132
    b1 = lc.general_plan(1, N, 64, 64, 132)
    assert b1.act_rows == 1 and b1.act_grid == (N * 8, 1)


# ---- the CUDA kernels against the twins (card only) ----

CUDA_CASES = [  # (B, N, F, H, dtype, tol fwd, tol grads)
    (8, 3, 16, 16, torch.float32, 1e-5, 1e-4),
    (12, 3, 16, 16, torch.float32, 1e-5, 1e-4),
    (37, 5, 24, 40, torch.float32, 1e-5, 1e-4),
    (768, 25, 64, 64, torch.float32, 1e-5, 1e-4),
    (8, 3, 16, 16, torch.bfloat16, 0.05, 0.05),
    (768, 25, 64, 64, torch.bfloat16, 0.05, 0.05),
    # the tensor-core kernels' edges: a short single tile, ragged last
    # tiles at unequal widths and at full width
    (12, 3, 16, 16, torch.bfloat16, 0.05, 0.05),
    (37, 5, 32, 48, torch.bfloat16, 0.05, 0.05),
    (100, 25, 64, 64, torch.bfloat16, 0.05, 0.05),
    # bf16 at a width that takes the general kernel
    (37, 5, 24, 40, torch.bfloat16, 0.05, 0.05),
    # the general kernels' tile shapes: B=1 (eval), the Monaco .ini step,
    # wide cells past the old F + H <= 256, and rows of no whole 16-byte
    # pieces (element-wise copies)
    (1, 28, 64, 64, torch.float32, 1e-5, 1e-4),
    (32, 28, 64, 64, torch.float32, 1e-5, 1e-4),
    (37, 3, 64, 256, torch.float32, 1e-5, 1e-4),
    (5, 2, 128, 1024, torch.float32, 1e-5, 1e-4),
    (37, 3, 64, 256, torch.bfloat16, 0.05, 0.05),
    (9, 2, 5, 7, torch.float32, 1e-5, 1e-4),
]

# (dtype, F, H) -> the kernel a CUDA call takes
VARIANT_CASES = [
    (torch.bfloat16, 64, 64, "tc"),
    (torch.bfloat16, 16, 16, "tc"),
    (torch.bfloat16, 32, 48, "tc"),
    (torch.bfloat16, 24, 40, "general"),   # not multiples of 16
    (torch.bfloat16, 64, 40, "general"),
    (torch.bfloat16, 128, 64, "general"),  # wider than the staged weights
    (torch.bfloat16, 64, 80, "general"),
    (torch.float32, 64, 64, "general"),    # TF32 would not hold 1e-5
    (torch.float32, 16, 16, "general"),
    (torch.bfloat16, 64, 256, "general"),  # wider than the old F + H cap
    (torch.float32, 64, 256, "general"),
]


@pytest.mark.parametrize("dtype,F,H,want", VARIANT_CASES)
def test_kernel_variant_rule(dtype, F, H, want):
    assert lc.kernel_variant(dtype, F, H) == want


def test_tc_splits_rule():
    """Blocks per agent: fill the SMs once, never more than one per tile."""
    assert lc.tc_splits(768, 25, 132) == 5      # 125 blocks, 24 tiles
    assert lc.tc_splits(100, 25, 132) == 4      # 4 tiles
    assert lc.tc_splits(12, 3, 132) == 1
    assert lc.tc_splits(768, 200, 132) == 1     # more agents than SMs


@needs_cuda
@pytest.mark.parametrize("B,N,F,H,dtype,tol_f,tol_g", CUDA_CASES)
def test_cuda_kernels_match_plain_twins(B, N, F, H, dtype, tol_f, tol_g):
    torch.backends.cuda.matmul.allow_tf32 = False
    args, done = setup(B, N, F, H)
    c, h = port_step(args, done, "cuda", dtype)
    c_ref, h_ref = port_step(args, done, "cpu", dtype)
    np.testing.assert_allclose(_np(c), _np(c_ref), atol=tol_f, rtol=tol_f)
    np.testing.assert_allclose(_np(h), _np(h_ref), atol=tol_f, rtol=tol_f)
    g = port_grads(args, done, "cuda", dtype)
    g_ref = port_grads(args, done, "cpu", dtype)
    for a, b, name in zip(g, g_ref, NAMES):
        np.testing.assert_allclose(a, b, atol=tol_g, rtol=tol_g,
                                   err_msg=name)


@needs_cuda
def test_cuda_done_masks_carry_gradient():
    args, done = setup()
    g = port_grads(args, np.ones_like(done), "cuda")
    np.testing.assert_allclose(g[3], 0.0, atol=1e-7)
    np.testing.assert_allclose(g[4], 0.0, atol=1e-7)


@needs_cuda
@pytest.mark.parametrize("dtype,F,H,want", VARIANT_CASES)
def test_cuda_variant_counts_and_bitwise_backward(dtype, F, H, want):
    """A CUDA call launches the variant the rule names, and only that one;
    two backward calls on the same inputs agree bitwise."""
    args, done = setup(37, 3, F, H)
    t = [torch.tensor(a, device="cuda").to(dtype) for a in args]
    wx, wh, b, c, h, x = t
    d = torch.tensor(done, device="cuda")
    before = dict(lc.LAUNCHES)
    c_new, h_new, h_in, c_in = lc.lstm_cell_fwd(wx, wh, b, c, h, x, d)
    bwd = lambda: lc.lstm_cell_bwd(wx, wh, b, x, h_in, c_in, c_new, d,
                                   torch.cos(c_new), torch.sin(h_new))
    first, second = bwd(), bwd()
    torch.cuda.synchronize()
    for a, bb in zip(first, second):
        assert torch.equal(a, bb)
    moved = {k: v - before[k] for k, v in lc.LAUNCHES.items()
             if v != before[k]}
    assert moved == {"lstm_cell_fwd": 1, f"lstm_cell_fwd_{want}": 1,
                     "lstm_cell_bwd": 2, f"lstm_cell_bwd_{want}": 2}


@needs_cuda
def test_cuda_kernels_count_launches_and_reject_bad_input():
    args, done = setup()
    before = dict(lc.LAUNCHES)
    port_grads(args, done, "cuda")
    assert lc.LAUNCHES["lstm_cell_fwd"] == before["lstm_cell_fwd"] + 1
    assert lc.LAUNCHES["lstm_cell_bwd"] == before["lstm_cell_bwd"] + 1
    wx, wh, b, c, h, x = [torch.tensor(a, device="cuda") for a in args]
    d = torch.tensor(done, device="cuda")
    with pytest.raises(TypeError):
        lc.lstm_cell_fwd(wx.double(), wh, b, c, h, x, d)
    with pytest.raises(ValueError):
        lc.lstm_cell_fwd(wx, wh, b, c, h.transpose(0, 1), x, d)
    with pytest.raises(ValueError):   # f32 cannot take the bf16 kernels
        lc.lstm_cell_fwd(wx, wh, b, c, h, x, d, _variant="tc")
