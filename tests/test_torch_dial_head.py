"""DIAL's message head over packed neighbour lists (``ops/dial_head.py``):
its plain twins through the ``autograd.Function`` against the PyTorch ops it
replaces (the done mask, the einsum, the bias add and their autograd) in f32
and bf16, with rows done, with no ``done`` and at batch sizes that do not
fill a tile; ``_embed``'s packed-DIAL path against the dense DIAL einsums;
the pure functions of the dispatch (the tensor-core rule, the cluster); the
wrapper's refusals; and, on a card (``needs_cuda``), the CUDA kernels against
the twins and the Function's gradients against the replaced ops' own
autograd, a bitwise deterministic backward, the launch counts of a captured
DIAL update, and NeurComm's embedding untouched. No JAX is imported: the
card's machine has none.

On a card: ``python -m pytest --noconftest -q tests/test_torch_dial_head.py
-k cuda``."""

import dataclasses

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.models import policies as tp
from deeprl_network_tpu_torch.models.layers import FCParams
from deeprl_network_tpu_torch.ops import comm_embed as ce
from deeprl_network_tpu_torch.ops import dial_head as dh

# decided when each test is set up, not at import
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (0.05, 0.05)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, N=5, H=16, D=16, done="some", seed=0, dtype=torch.float32,
            device="cpu"):
    """Numpy-seeded h, done, w, b of the head at its init's scale; ``done``:
    "some" (rows 1, 4, 7, ... done), "all", or "none" (None: no mask)."""
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.tensor(
        (rng.standard_normal(s) * scale).astype(np.float32)).to(
            device=device, dtype=dtype)
    flags = {"some": (torch.arange(B) % 3 == 1).float(),
             "all": torch.ones(B), "none": None}[done]
    if flags is not None:
        flags = flags.to(device=device, dtype=dtype)
    return (t(B, N, H, scale=0.5), flags, t(N, H, D, scale=H ** -0.5),
            t(N, D, scale=0.5))


def _ops(h, done, w, b):
    """The PyTorch ops that ``_embed`` ran for the head before the kernel:
    the masked carry, the einsum, the bias add."""
    if done is not None:
        h = h * (1.0 - done.to(h.dtype))[:, None, None]
    return torch.einsum("bmh,mhd->bmd", h, w) + b


def _grads(fn, h, done, w, b, cot):
    """m and the gradients of sum(m * cot) w.r.t. h, w and b."""
    leaves = [x.clone().requires_grad_() for x in (h, w, b)]
    m = fn(leaves[0], done, leaves[1], leaves[2])
    grads = torch.autograd.grad((m.float() * cot.float()).sum(), leaves)
    return m.detach(), dict(zip(("h", "w", "b"), grads))


def _off(got, want, tol):
    """Elements of ``got`` off the bar ``tol`` (absolute and relative)."""
    got, want = got.float(), want.float()
    return (got - want).abs() > tol + tol * want.abs()


def _close(got, want, tol, what):
    assert got.dtype == want.dtype, what
    assert torch.isfinite(got.float()).all(), what
    bad = _off(got, want, tol)
    assert not bad.any(), (f"{what}: {int(bad.sum())} elements off by up to "
                           f"{float((got.float() - want.float()).abs().max()):.3e}")


def _cot(B, N, D, dtype, device="cpu"):
    g = torch.Generator(device=device).manual_seed(7)
    return torch.randn((B, N, D), generator=g, device=device).to(dtype)


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("done", ["some", "all", "none"])
@pytest.mark.parametrize("B", [1, 37, 64])
def test_twin_matches_replaced_ops(dtype, done, B):
    """The twin through its Function (the CPU path of ``_embed``) against
    the ops it replaces: f32 1e-5 forward and 1e-4 gradients, bf16 0.05; the
    rows done give h no gradient and their messages are the bias alone."""
    h, flags, w, b = _inputs(B, done=done, dtype=dtype)
    cot = _cot(B, 5, 16, dtype)
    got, g_got = _grads(dh.dial_head, h, flags, w, b, cot)
    want, g_want = _grads(_ops, h, flags, w, b, cot)
    tol_f, tol_b = TOL[dtype]
    _close(got, want, tol_f, "m")
    assert got.is_contiguous() and got.shape == (B, 5, 16)
    for name in g_want:
        _close(g_got[name], g_want[name], tol_b, name)
    ended = torch.zeros(B, dtype=torch.bool) if flags is None else flags > 0
    assert not g_got["h"][ended].any()
    assert g_got["h"][~ended].abs().sum() > 0 or bool(ended.all())
    assert torch.equal(got[ended], b.expand(B, -1, -1)[ended])
    assert g_got["b"].abs().sum() > 0


@pytest.mark.parametrize("done", ["some", "none"])
def test_twin_backward_matches_its_forward_autograd(done):
    """The backward twin equals the forward twin's own autograd in f32 (the
    rounding points are the same: one f32 sum, one rounding)."""
    h, flags, w, b = _inputs(37, N=3, H=32, D=16, done=done)
    cot = _cot(37, 3, 16, torch.float32)
    _, want = _grads(dh.dial_head_fwd_ref, h, flags, w, b, cot)
    dh_, dw, db = dh.dial_head_bwd_ref(h, flags, w, cot)
    for name, got in (("h", dh_), ("w", dw), ("b", db)):
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _grid_adj(rows=3, cols=3):
    adj = np.zeros((rows * cols, rows * cols), np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for rr, cc in ((r + 1, c), (r, c + 1)):
                if rr < rows and cc < cols:
                    adj[i, rr * cols + cc] = adj[rr * cols + cc, i] = 1
    return adj


def _ragged_adj(n=7):
    """Agents reading 1 to 3 senders (so slots pad) and one read by
    nobody."""
    adj = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(1, 1 + i % 3 + 1):
            adj[i, (i + j) % (n - 1)] = 1
        adj[i, i] = 0
    adj[:, n - 1] = 0
    adj[n - 1, 0] = 1
    return adj


@pytest.mark.parametrize("graph", ["grid9", "ragged7"])
@pytest.mark.parametrize("done", ["some", "none"])
def test_embed_packed_dial_matches_dense_einsums(monkeypatch, graph, done):
    """``_embed`` for packed DIAL (the head's Function, then the comm
    embedding's, their twins on the CPU) against dense DIAL's einsums, in
    f32 at B=37: the embedding at 1e-5, the gradients of the carry and of
    every weight (through the packing) at 1e-4."""
    adj = _grid_adj() if graph == "grid9" else _ragged_adj()
    spec = tp.PolicySpec(n_agent=len(adj), n_s_max=5, n_a_max=3, n_fc=16,
                         n_lstm=16, n_msg=16, comm_type=tp.CommType.DIAL,
                         sparse_comm=True, neighbor_mask=adj)
    params = tp.init_policy_params(torch.Generator().manual_seed(3), spec)
    h, flags, _, _ = _inputs(37, N=len(adj), done=done)
    obs = _inputs(37, N=len(adj), H=5, seed=1)[0]
    fp = torch.full((37, len(adj), 3), 1.0 / 3)

    def run(s):
        leaves = [x.clone().requires_grad_() for x in (
            h, params.w_obs.w, params.w_obs.b, params.w_msg,
            params.w_dial.w, params.w_dial.b)]
        p = params._replace(w_obs=FCParams(leaves[1], leaves[2]),
                            w_msg=leaves[3],
                            w_dial=FCParams(leaves[4], leaves[5]))
        consts = tp.policy_consts(s, "cpu")
        p = tp.mask_comm_params(s, p, consts)
        e = tp._embed(s, p, leaves[0], obs, fp, consts, flags)
        return e.detach(), torch.autograd.grad(torch.sin(e).sum(), leaves)

    calls = []
    real = tp.dial_head
    monkeypatch.setattr(tp, "dial_head", lambda *a: calls.append(1)
                        or real(*a))
    got, g_got = run(spec)
    assert calls == [1]
    want, g_want = run(dataclasses.replace(spec, sparse_comm=False))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    for name, a, b in zip(("h", "w_obs", "b_obs", "w_msg", "w_dial",
                           "b_dial"), g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert float(got.abs().sum()) > 0 and g_got[4].abs().sum() > 0


def test_kernel_variant_and_cluster():
    """``takes_tc`` where the LSTM cell takes its tensor-core kernel (bf16,
    H and D multiples of 16, at most 64), not for float32 or any other
    width (those take the ``general`` kernels); the backward's cluster
    gives no block more tiles than eight blocks would."""
    bf, f32 = torch.bfloat16, torch.float32
    assert dh.takes_tc(bf, 64, 64)
    assert dh.takes_tc(bf, 16, 48)
    assert not dh.takes_tc(f32, 64, 64)
    assert not dh.takes_tc(bf, 64, 8)
    assert not dh.takes_tc(bf, 128, 64)
    assert not dh.takes_tc(bf, 24, 64)
    assert [dh.bwd_cluster(B) for B in (1, 64, 65, 384, 768, 1024, 1025,
                                        4096)] == [1, 1, 2, 6, 6, 8, 6, 8]
    for B in range(1, 3000, 37):
        tiles = -(-B // 64)
        c = dh.bwd_cluster(B)
        assert 1 <= c <= min(8, tiles)
        assert -(-tiles // c) == -(-tiles // min(8, tiles))


def _refusal(kind):
    """Arguments of a call that the wrapper refuses, the error and the
    message."""
    h, flags, w, b = _inputs(4)
    if kind == "device":
        return ((h.to("meta"), None, w.to("meta"), b.to("meta")),
                ValueError, "unsupported device")
    if kind == "dtype":
        return ((h.half(), None, w.half(), b.half()), TypeError,
                "float32 or bfloat16")
    if kind == "mixed_dtypes":
        return (h, flags, w.bfloat16(), b), TypeError, "w is"
    if kind == "non_contiguous":
        return ((h.transpose(0, 1).contiguous().transpose(0, 1), flags, w,
                 b), ValueError, "contiguous")
    if kind == "shapes":
        return (h, flags, w[:, :8], b), ValueError, "inconsistent"
    return (h, flags[:3], w, b), ValueError, "inconsistent"


@pytest.mark.parametrize("kind", ["device", "dtype", "mixed_dtypes",
                                  "non_contiguous", "shapes", "done_shape"])
def test_wrapper_refuses(kind):
    """Other devices, dtypes, a weight of another dtype, a non-contiguous
    carry (the kernel reads its rows in place) and inconsistent shapes are
    refused, forward and backward, before any twin or kernel runs."""
    args, err, match = _refusal(kind)
    with pytest.raises(err, match=match):
        dh.dial_head_fwd(*args)
    h, flags, w, b = args
    with pytest.raises(err, match=match):
        dh.dial_head_bwd(h, flags, w, torch.zeros(
            h.shape[:2] + (b.shape[-1],), dtype=h.dtype, device=h.device))


def test_done_gets_no_gradient():
    h, flags, w, b = _inputs(6)
    flags = flags.clone().requires_grad_()
    hh = h.clone().requires_grad_()
    m = dh.dial_head(hh, flags, w, b)
    gh, gd = torch.autograd.grad(m.sum(), [hh, flags], allow_unused=True)
    assert gd is None and gh is not None


# ---------------------------------------------------------------- the card

CARD_CASES = [
    # (name, B, N, H, D, dtype, done, tc); tc: whether ``takes_tc`` accepts
    # the widths (else the ``general`` kernels run)
    ("flagship", 768, 25, 64, 64, torch.bfloat16, "some", True),
    ("flagship_no_done", 768, 25, 64, 64, torch.bfloat16, "none", True),
    ("flagship_all_done", 768, 25, 64, 64, torch.bfloat16, "all", True),
    ("ragged_37", 37, 7, 32, 48, torch.bfloat16, "some", True),
    ("ragged_1025", 1025, 3, 48, 16, torch.bfloat16, "some", True),
    ("widths_16", 4, 25, 16, 16, torch.bfloat16, "some", True),
    ("eval_b1", 1, 25, 64, 64, torch.float32, "some", False),
    ("flagship_f32", 768, 25, 64, 64, torch.float32, "some", False),
    ("odd_f32", 37, 5, 24, 40, torch.float32, "none", False),
    # bf16 outside the tensor-core rule: twice the flagship's widths
    ("flagship_bf16_general", 100, 25, 128, 128, torch.bfloat16, "some",
     False),
]


@needs_cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_cuda_kernels_match_twin(case):
    """Each kernel against its twin on the card, forward and backward, the
    pair ``takes_tc`` picks being the case's; the launch counts move by one
    a call; two backward calls are bitwise equal."""
    name, B, N, H, D, dtype, done, tc = case
    h, flags, w, b = _inputs(B, N, H, D, done, dtype=dtype, device="cuda")
    assert dh.takes_tc(dtype, H, D) == tc
    before = dict(dh.LAUNCHES)
    m = dh.dial_head_fwd(h, flags, w, b)
    cot = _cot(B, N, D, dtype, "cuda")
    got = dh.dial_head_bwd(h, flags, w, cot)
    again = dh.dial_head_bwd(h, flags, w, cot)
    torch.cuda.synchronize()
    tol_f, tol_b = TOL[dtype]
    _close(m, dh.dial_head_fwd_ref(h, flags, w, b), tol_f, f"{name} m")
    assert m.is_contiguous() and m.shape == (B, N, D)
    for what, a, want, c in zip(("dh", "dw", "db"), got,
                                dh.dial_head_bwd_ref(h, flags, w, cot),
                                again):
        _close(a, want, tol_b, f"{name} {what}")
        assert torch.equal(a, c), f"{name} {what} differs between calls"
    moved = {k: v - before[k] for k, v in dh.LAUNCHES.items()
             if v != before[k]}
    assert moved == {"dial_head_fwd": 1, "dial_head_bwd": 2}


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_tc", "f32_general"])
@pytest.mark.parametrize("done", ["some", "none"])
def test_cuda_function_matches_replaced_ops(dtype, done):
    """The Function on the card at the flagship's shape (B=768, N=25, 64/64)
    against the replaced ops' own autograd (the mask, the einsum and the
    bias add, TF32 off): m and the gradients of h, w and b at the bf16 bar
    0.05 and, in f32, 1e-5 forward and 1e-4 backward."""
    assert not torch.backends.cuda.matmul.allow_tf32
    h, flags, w, b = _inputs(768, 25, 64, 64, done, dtype=dtype,
                             device="cuda")
    cot = _cot(768, 25, 64, dtype, "cuda")
    got, g_got = _grads(dh.dial_head, h, flags, w, b, cot)
    want, g_want = _grads(_ops, h, flags, w, b, cot)
    tol_f, tol_b = TOL[dtype]
    _close(got, want, tol_f, "m")
    for name in g_want:
        _close(g_got[name], g_want[name], tol_b, name)
        assert g_got[name].abs().sum() > 0, name


def _grid25():
    return _grid_adj(5, 5)


@needs_cuda
def test_cuda_neurcomm_embedding_untouched():
    """NeurComm over packed lists never reaches the head: ``_embed`` launches
    no head kernel, and its embedding and gradients are bitwise those of
    ``comm_embed`` called directly at the flagship's shape in bf16."""
    adj = _grid25()
    spec = tp.PolicySpec(n_agent=25, n_s_max=12, n_a_max=5, n_fc=64,
                         n_lstm=64, comm_type=tp.CommType.NEURCOMM,
                         sparse_comm=True, neighbor_mask=adj)
    bf = torch.bfloat16
    params = tp.init_policy_params(torch.Generator().manual_seed(0), spec)
    params = tp.tree_map(lambda x: x.to("cuda", bf), params)
    consts = tp.policy_consts(spec, "cuda")
    packed = tp.mask_comm_params(spec, params, consts)
    h, flags, _, _ = _inputs(768, 25, 64, 64, dtype=bf, device="cuda")
    obs = _inputs(768, 25, 12, seed=1, dtype=bf, device="cuda")[0]
    fp = torch.full((768, 25, 5), 0.2, dtype=bf, device="cuda")
    before = dict(dh.LAUNCHES)
    outs = []
    for direct in (False, True):
        hh = h.clone().requires_grad_()
        if direct:
            e = ce.comm_embed(obs, fp, hh, flags, packed.w_obs.w,
                              packed.w_obs.b, packed.w_fp, packed.w_msg,
                              consts.nbr, consts.rev)
        else:
            e = tp._embed(spec, packed, hh, obs, fp, consts, flags)
        outs.append((e.detach(), torch.autograd.grad(e.float().sum(), hh)[0]))
    torch.cuda.synchronize()
    assert dh.LAUNCHES == before
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@needs_cuda
def test_cuda_dial_update_counts_the_head():
    """A DIAL update with ``remat`` at bf16 widths of 16 over packed lists on
    the 5x5 grid, captured into its graph: the head's wrapper counts the
    capture's warm-up and the capture, each 2T+1 forward and T backward
    ``tc`` launches, as many as the comm embedding's; a NeurComm update
    counts none."""
    from deeprl_network_tpu_torch.config import (
        EnvConfig, ModelConfig, TrainConfig,
    )
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.utils.rollout import make_a2c
    T = 8
    for agent in ("ma2c_dial", "ma2c_nc"):
        env = LargeGridEnv(EnvConfig(scenario="large_grid", coop_gamma=0.9,
                                     episode_length_sec=60), device="cuda")
        fns = make_a2c(env, ModelConfig(
            num_envs=4, num_fc=16, num_lstm=16, batch_size=T,
            compute_dtype="bfloat16", sparse_comm=True, remat=True),
            TrainConfig(total_step=10 ** 6), agent=agent, jit=True,
            device="cuda")
        ts = fns.init_state(0)
        before, before_ce = dict(dh.LAUNCHES), dict(ce.LAUNCHES)
        for _ in range(3):
            ts, _ = fns.train_step(ts)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in dh.LAUNCHES.items()
                 if v != before[k]}
        if agent == "ma2c_nc":
            assert moved == {}
            continue
        assert moved == {"dial_head_fwd": 2 * (2 * T + 1),
                         "dial_head_bwd": 2 * T}
        assert ce.LAUNCHES["comm_embed_dial_fwd"] \
            - before_ce["comm_embed_dial_fwd"] == 2 * (2 * T + 1)
