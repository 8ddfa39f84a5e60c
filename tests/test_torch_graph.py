"""The port's ``jit``: the update body that a CUDA graph captures
(``utils/rollout.py`` ``_update``) and the graph's bookkeeping
(``utils/graph.py``).

On the CPU: the body of every family, on both gradient paths and on every
env, reads nothing back to the host (a dispatch mode that raises on the ops
that would); the schedules, which now enter the body as a tensor, move
between updates exactly as the JAX package's; the arenas round-trip a
TrainState of every env; the capture and replay contract holds with a
stand-in graph; ``make_a2c`` takes ``jit`` where the JAX package does.

On a card (``needs_cuda``; ``python -m pytest --noconftest -q
tests/test_torch_graph.py -k cuda``): the graph's update equals the eager
update bit for bit, a checkpoint resumes bit-exactly under the graph, and
two graph updates draw different noise, each what an eager draw from the
generator's state gives. JAX is imported only inside fixtures, so that the
card tests run where JAX is not installed.
"""

import contextlib
import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.envs.grid import (
    LargeGridEnv, build_grid_topology,
)
from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
from deeprl_network_tpu_torch.envs.network import TrafficNetworkEnv
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.parallel.train import make_parallel_a2c
from deeprl_network_tpu_torch.utils.graph import (
    ALIGN_BYTES, Arena, GraphedStep,
)
from deeprl_network_tpu_torch.utils.rollout import (
    gumbel_noise, make_a2c, state_from_leaves, state_leaves,
)
from deeprl_network_tpu_torch.utils.spans import Spans

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

AGENTS = ["ia2c", "ia2c_fp", "ia2c_cu", "ma2c_nc", "ma2c_cnet", "ma2c_dial"]
GRID_KW = dict(scenario="large_grid", coop_gamma=0.9, episode_length_sec=60)
CACC_KW = dict(scenario="cacc_slowdown", coop_gamma=0.9, episode_length=12)
MONACO_KW = dict(scenario="real_net", coop_gamma=0.9, episode_length_sec=60)
SMALL = dict(batch_size=8, num_envs=2, num_fc=16, num_lstm=16)
# what a CUDA graph's capture cannot hold: a value read back to the host
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select",
              "is_nonzero", "equal"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's train-step test helpers (imports JAX)."""
    import test_torch_train
    return test_torch_train


class NoHostReads(TorchDispatchMode):
    """Raises on every op that reads a tensor's value back to the host."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in HOST_READS or name.lstrip("_").startswith("unique"):
            raise AssertionError(f"the update body reads back: {func}")
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _env(kind, device="cpu", **kw):
    if kind == "grid":
        return LargeGridEnv(EnvConfig(**GRID_KW, **kw), device=device)
    if kind == "grid3":
        cfg = EnvConfig(**GRID_KW, **kw)
        return TrafficNetworkEnv(cfg, build_grid_topology(cfg, 3),
                                 device=device)
    if kind == "monaco":
        return RealNetEnv(EnvConfig(**MONACO_KW, **kw), device=device)
    return CACCEnv(EnvConfig(**CACC_KW, **kw), device=device)


BODY_CASES = (
    [(a, "grid", dict(fused_grad=f, remat=True,
                      sparse_comm=a.startswith("ma2c"),
                      neighbor_obs=a in ("ia2c_fp", "ma2c_dial")))
     for a in AGENTS for f in (True, False)]
    + [("ma2c_nc", "grid3", dict(kickstart_coef=0.7, switch_penalty=0.5,
                                 remat=True, sparse_comm=True)),
       ("ia2c", "grid3", dict(kickstart_coef=0.7, switch_penalty=0.5)),
       ("ma2c_nc", "monaco", dict(sparse_comm=True, remat=True)),
       ("ia2c_cu", "monaco", dict(fused_grad=False)),
       ("ma2c_nc", "cacc", dict(kickstart_coef=0.7)),
       ("ia2c_cu", "cacc", dict(fused_grad=False))])


@pytest.mark.parametrize(
    "agent,env_name,model_kw", BODY_CASES,
    ids=[f"{a}-{e}-{'fused' if kw.get('fused_grad', True) else 'replay'}"
         + ("-kick" if kw.get("kickstart_coef") else "")
         for a, e, kw in BODY_CASES])
def test_update_body_reads_nothing_back(agent, env_name, model_kw):
    """The body that a graph captures, at B=2 and T=8 (the platoon with its
    reset noise on, so the auto-reset draws): no op of the forward, the
    backward, the optimizer or the consensus reads a value back."""
    env = _env(env_name)
    fns = make_a2c(env, ModelConfig(**SMALL, **model_kw),
                   TrainConfig(total_step=10_000), agent=agent,
                   device="cpu")
    ts = fns.init_state(0)
    sched = torch.tensor([0.01, 0.5, 5e-4])
    mode = NoHostReads()
    with mode:
        new, metrics = fns.update(ts, sched, None, ts.generator)
        new, metrics = fns.update(new, sched, None, ts.generator)
    assert mode.ops > 1000
    assert all(torch.isfinite(v).all() for v in metrics.values())


def _moving_pair(jx, agent, **model_kw):
    """(JAX fns, JAX state, port fns, port state) on the grid with every
    schedule moving over three updates of 32 env steps: a linear lr over
    128 steps, a linear entropy coefficient and the kickstart anneal over
    64."""
    import jax
    from deeprl_network_tpu.config import (
        EnvConfig as JEnvConfig, ModelConfig as JModelConfig,
        TrainConfig as JTrainConfig,
    )
    from deeprl_network_tpu.envs.grid import LargeGridEnv as JLargeGridEnv
    from deeprl_network_tpu.utils.rollout import make_a2c as jmake_a2c
    from deeprl_network_tpu_torch.utils.convert import params_from_jax
    model_kw = dict(batch_size=8, num_envs=4, num_fc=16, num_lstm=16,
                    lr_decay="linear", entropy_decay="linear",
                    entropy_ratio=0.5, kickstart_ratio=0.5, **model_kw)
    jfns = jmake_a2c(JLargeGridEnv(JEnvConfig(**GRID_KW)),
                     JModelConfig(**model_kw), JTrainConfig(total_step=128),
                     agent=agent)
    tfns = make_a2c(LargeGridEnv(EnvConfig(**GRID_KW), device="cpu"),
                    ModelConfig(**model_kw), TrainConfig(total_step=128),
                    agent=agent, device="cpu")
    jts = jfns.init_state(jax.random.key(0))
    tts = tfns.init_state(0, params=params_from_jax(
        jax.tree.map(np.asarray, jts.params), "cpu"))
    return jfns, jts, tfns, tts


@pytest.mark.parametrize("agent,model_kw", [
    ("ma2c_nc", dict(kickstart_coef=0.7, sparse_comm=True, remat=True)),
    ("ia2c_cu", dict(fused_grad=False)),
], ids=["fused-kick", "replay-consensus"])
def test_moving_schedules_match_jax(jx, agent, model_kw):
    """Three updates whose learning rate, entropy coefficient and kickstart
    weight all move, against the JAX train step (``jit=True``) with its own
    noise: the metrics at rtol 1e-4, every param at atol 1e-5 (the bars of
    ``test_torch_train.py``), ``lr`` and ``beta`` as the JAX step's."""
    metrics = jx.METRICS + ("step_reward",) + (
        ("kick_ce",) if "kickstart_coef" in model_kw else ())
    lrs, betas = [], []
    for jts, jm, tts, tm in jx._run_both(*_moving_pair(jx, agent, **model_kw),
                                         n_updates=3):
        assert tm.keys() == jm.keys()
        for k in metrics:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        for k in ("lr", "beta"):
            assert isinstance(tm[k], float)
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-6,
                                       err_msg=k)
        for a, b in zip(tree_leaves(tts.params),
                        [np.asarray(x) for x in
                         jx.jax.tree.leaves(jts.params)]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
        lrs.append(tm["lr"])
        betas.append(tm["beta"])
    assert len(set(lrs)) == 3 and len(set(betas)) == 3


@pytest.mark.parametrize("env_name,dtype", [
    ("grid", "bfloat16"), ("grid3", "float32"), ("monaco", "float32"),
    ("cacc", "float32")])
def test_arena_round_trip(env_name, dtype):
    """A TrainState through the arenas: packed into static buffers, cloned,
    handed back as views of the clones, equal in value and dtype; no
    returned leaf shares storage with a static buffer; every slot aligned;
    a state of views of one clone copies in with one copy a dtype, any
    other state leaf by leaf."""
    env = _env(env_name)
    fns = make_a2c(env, ModelConfig(**SMALL, compute_dtype=dtype,
                                    sparse_comm=dtype == "bfloat16"),
                   TrainConfig(), agent="ma2c_nc", device="cpu")
    ts = fns.init_state(0)
    leaves = state_leaves(ts)
    arena = Arena(leaves)
    want = {torch.float32, torch.int64, torch.bool}
    if dtype == "bfloat16":
        want.add(torch.bfloat16)
    assert set(arena.size) == want
    static = arena.pack(leaves, "cpu")
    clones = {dt: b.clone() for dt, b in static.items()}
    back = state_from_leaves(ts, arena.views(clones), ts.step + 1,
                             ts.opt_state.count + 1, ts.generator)
    assert back.step == ts.step + 1
    assert back.opt_state.count == ts.opt_state.count + 1
    static_ptrs = {b.untyped_storage().data_ptr() for b in static.values()}
    for a, b in zip(state_leaves(back), leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() not in static_ptrs
        assert (a.data_ptr() - a.untyped_storage().data_ptr()) \
            % ALIGN_BYTES == 0
    views = state_leaves(back)
    for dt in arena.size:
        assert arena.base_of(views, dt) is clones[dt]
        assert arena.base_of(leaves, dt) is None
    for src in (views, leaves):
        again = arena.alloc("cpu")
        arena.copy_in(again, src)
        for a, b in zip(arena.views(again), leaves):
            assert torch.equal(a, b)


class StandInGraph:
    """What ``GraphedStep`` needs of a CUDA graph: replaying does nothing,
    so a call hands back what the capture computed."""

    def __init__(self):
        self.replays = 0

    def instantiate(self):
        pass

    def replay(self):
        self.replays += 1


def _cpu_spans():
    """The spans of a CPU update: their marks do nothing."""
    return Spans(4, "cpu", graph=True, allreduce=False)


def test_capture_and_replay_contract():
    """The first call of a key runs ``fn`` twice (the warm-up, then the
    capture) and no later call runs it: a replay only writes the static
    inputs (the scalars, the extras) and hands back clones of the outputs.
    Neither the warm-up nor the capture moves the caller's generator; each
    key has its graph; a key's extras keep their presence."""
    traced = []

    def fn(state, scalars, extras, generator):
        traced.append((scalars.clone(), extras[0] is None))
        torch.rand((2,), generator=generator)
        new = [state[0] * scalars[0], state[1] + 1]
        return new, {"m": new[0].sum()}

    step = GraphedStep(fn, "cpu", 1, _cpu_spans(), graph=StandInGraph,
                       capture=lambda g, stream: contextlib.nullcontext())
    state = [torch.ones(3), torch.zeros(2, dtype=torch.int64)]
    gen = torch.Generator().manual_seed(0)
    new, out = step("a", state, [2.0], [None], gen)
    assert [(t.item(), e) for t, e in traced] == [(2.0, True), (2.0, True)]
    assert set(step.graphs["a"].times) == {"warmup_s", "capture_s",
                                           "instantiate_s"}
    # neither the warm-up nor the capture draws from the caller's
    # generator, and a stand-in replay draws nothing: it has not moved
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(0).get_state())
    for _ in range(2):
        new, out = step("a", new, [3.0], [None], gen)
    assert len(traced) == 2
    assert step.graphs["a"].graph.replays == 3
    assert torch.equal(step.graphs["a"].scalars_in, torch.tensor([3.0]))
    # the static input holds the last call's state
    assert torch.equal(step.graphs["a"].arena_in.views(
        step.graphs["a"].state_in)[0], new[0])
    step("b", state, [1.0], [torch.zeros(4)], gen)
    assert len(traced) == 4 and set(step.graphs) == {"a", "b"}
    step("b", state, [1.0], [torch.ones(4)], gen)
    assert torch.equal(step.graphs["b"].extras_in[0], torch.ones(4))
    got = step.graphs["a"]
    statics = {b.untyped_storage().data_ptr() for b in got.out_bufs.values()}
    assert all(t.untyped_storage().data_ptr() not in statics
               for t in new + list(out.values()))
    assert torch.equal(new[0], torch.full((3,), 2.0))  # the capture's
    assert out["m"].item() == 6.0
    with pytest.raises(ValueError, match="other extras"):
        step("b", state, [1.0], [None], gen)


def test_graphed_step_refuses_a_state_of_other_dtypes():
    bad = GraphedStep(lambda s, c, e, g: ([s[0].double()], {}), "cpu", 1,
                      _cpu_spans(), graph=StandInGraph,
                      capture=lambda g, stream: contextlib.nullcontext())
    with pytest.raises(ValueError, match="state leaf"):
        bad("a", [torch.ones(2)], [0.0], [], torch.Generator())


def test_make_a2c_takes_jit_where_jax_does():
    """``jit`` with the JAX package's default and place (after
    ``n_replicas``), and ``make_parallel_a2c`` passes it on."""
    import ast
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, "deeprl_network_tpu", "utils",
                            "rollout.py")).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "make_a2c")
    jnames = [a.arg for a in fn.args.args]
    jdefault = fn.args.defaults[jnames.index("jit") - len(jnames)].value
    params = inspect.signature(make_a2c).parameters
    names = list(params)
    assert names[:len(jnames)] == jnames
    assert params["jit"].default is jdefault is True
    assert inspect.signature(make_parallel_a2c).parameters["jit"].default \
        is True


# ---- on the card ----

def _clone_state(ts):
    gen = torch.Generator(device=ts.generator.device)
    gen.set_state(ts.generator.get_state())
    return state_from_leaves(ts, [t.clone() for t in state_leaves(ts)],
                             ts.step, ts.opt_state.count, gen)


def _card_fns(jit, **model_kw):
    kw = dict(SMALL, num_envs=4, lr_decay="linear", entropy_decay="linear",
              **model_kw)
    return make_a2c(_env("grid", "cuda"), ModelConfig(**kw),
                    TrainConfig(total_step=256), agent="ma2c_nc", jit=jit,
                    device="cuda")


def _assert_same(a, b, ma=None, mb=None, generator=True):
    for x, y in zip(state_leaves(a), state_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)
    if generator:
        assert torch.equal(a.generator.get_state(),
                           b.generator.get_state())
    if ma is not None:
        assert ma.keys() == mb.keys()
        for k in ma:
            assert float(ma[k]) == float(mb[k]), k


@needs_cuda
@pytest.mark.parametrize("model_kw", [
    dict(), dict(fused_grad=False),
    dict(compute_dtype="bfloat16", sparse_comm=True, remat=True),
], ids=["f32-fused", "f32-replay", "bf16-sparse-remat"])
def test_cuda_graph_update_equals_eager(model_kw):
    """Three updates from one state through the graph and eagerly, the
    schedules moving: every TrainState leaf, the generator and every
    metric bit for bit."""
    graph, eager = _card_fns(True, **model_kw), _card_fns(False, **model_kw)
    ts_g = graph.init_state(0)
    ts_e = _clone_state(ts_g)
    for _ in range(3):
        ts_g, m_g = graph.train_step(ts_g)
        ts_e, m_e = eager.train_step(ts_e)
        _assert_same(ts_g, ts_e, m_g, m_e)


@needs_cuda
def test_cuda_checkpoint_resumes_under_graph(tmp_path):
    """Two updates, save, two more; a restore into the same functions and
    into new ones, then two updates: the same state bit for bit."""
    from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
    fns = _card_fns(True)
    ts = fns.init_state(0)
    for _ in range(2):
        ts, _ = fns.train_step(ts)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(ts.step, ts)
    like = ts
    for _ in range(2):
        ts, m = fns.train_step(ts)
    for f in (fns, _card_fns(True)):
        back = ckpt.restore(like)
        for _ in range(2):
            back, mb = f.train_step(back)
        _assert_same(back, ts, mb, m)


@needs_cuda
def test_cuda_graph_updates_draw_fresh_noise():
    """Each graph update draws what eager draws from the generator's state
    before it, given as ``gumbel`` to a second graph (whose generator then
    does not move); the two updates' draws differ."""
    fns = _card_fns(True)
    ts = fns.init_state(0)
    T, B, N, A = 8, 4, fns.spec.n_agent, fns.spec.n_a_max
    draws = []
    for _ in range(2):
        probe = torch.Generator(device="cuda")
        probe.set_state(ts.generator.get_state())
        g = torch.stack([gumbel_noise(probe, (B, N, A), "cuda")
                         for _ in range(T)])
        given, m_given = fns.train_step(_clone_state(ts), gumbel=g)
        ts, m = fns.train_step(ts)
        _assert_same(ts, given, m, m_given, generator=False)
        draws.append(g)
    assert not torch.equal(draws[0], draws[1])


@needs_cuda
def test_cuda_jit_refuses_gloo():
    """gloo stages its all-reduce through the host, which a graph cannot
    hold: ``jit=True`` on CUDA tensors raises, naming ``jit=False``, and
    ``jit=False`` builds."""
    import socket
    from deeprl_network_tpu_torch.parallel import distributed
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.maybe_initialize(f"tcp://localhost:{port}", 1, 0, "gloo")
    try:
        env = _env("grid", "cuda")
        kw = dict(agent="ma2c_nc", axis_name="data", n_replicas=1,
                  device="cuda")
        with pytest.raises(ValueError, match="jit=False"):
            make_a2c(env, ModelConfig(**SMALL), TrainConfig(), **kw)
        make_a2c(env, ModelConfig(**SMALL), TrainConfig(), jit=False, **kw)
    finally:
        torch.distributed.destroy_process_group()
