"""The port's public surface against the JAX package's: every name the JAX
``__init__`` files re-export, ``Scheduler``, ``fc_apply``, ``one_hot``, the
single-env ``policy_step`` (all six agents, f32, 1e-5) and
``graft_entry.entry``."""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprl_network_tpu.config import (
    EnvConfig as JEnvConfig, ModelConfig as JModelConfig,
)
from deeprl_network_tpu.envs.grid import LargeGridEnv as JLargeGridEnv
from deeprl_network_tpu.models import layers as jl
from deeprl_network_tpu.models import policies as jp
from deeprl_network_tpu.utils import scheduler as jsched
from deeprl_network_tpu.utils.rollout import (
    make_policy_spec as jmake_policy_spec,
)
from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig
from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
from deeprl_network_tpu_torch.models import layers as tl
from deeprl_network_tpu_torch.models import policies as tp
from deeprl_network_tpu_torch.utils import scheduler as tsched
from deeprl_network_tpu_torch.utils.convert import params_from_jax
from deeprl_network_tpu_torch.utils.rollout import make_policy_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENTS = ["ia2c", "ia2c_fp", "ia2c_cu", "ma2c_nc", "ma2c_cnet", "ma2c_dial"]
# JAX names the port replaces by design: the process group of
# parallel/distributed.py stands where the jax.sharding.Mesh does
SUBSTITUTES = {("parallel", "make_mesh"): "maybe_initialize"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_reexports():
    """(subpackage, name) for every name a JAX ``__init__`` re-exports."""
    out = []
    for sub in ("envs", "models", "ops", "parallel", "utils"):
        path = os.path.join(ROOT, "deeprl_network_tpu", sub, "__init__.py")
        with open(path) as f:
            tree = ast.parse(f.read())
        out += [(sub, a.name) for node in tree.body
                if isinstance(node, ast.ImportFrom) for a in node.names]
    return out


REEXPORTS = _jax_reexports()


def test_the_jax_surface_is_what_the_port_mirrors():
    assert len(REEXPORTS) == 35
    assert sum(sub == "models" for sub, _ in REEXPORTS) == 26


@pytest.mark.parametrize("sub,name", REEXPORTS,
                         ids=[f"{s}.{n}" for s, n in REEXPORTS])
def test_reexported_name_imports_from_the_port(sub, name):
    mod = importlib.import_module(f"deeprl_network_tpu_torch.{sub}")
    name = SUBSTITUTES.get((sub, name), name)
    assert getattr(mod, name) is not None


def test_tf1_rmsprop_factory_and_class_are_exported():
    from deeprl_network_tpu_torch.models import TF1RMSProp, tf1_rmsprop
    assert isinstance(tf1_rmsprop(lambda count: 1e-3), TF1RMSProp)


def test_parallel_package_rejects_unknown_names():
    import deeprl_network_tpu_torch.parallel as par
    with pytest.raises(AttributeError, match="no_such_name"):
        par.no_such_name  # noqa: B018


def test_host_side_wrapper():
    sch = tsched.Scheduler("linear", 1.0, 10)
    assert sch.get(5) == pytest.approx(0.5)


@pytest.mark.parametrize("kind,init,total,floor,ratio", [
    ("constant", 5e-4, 1000, 0.0, 1.0),
    ("linear", 2.5e-3, 1000, 0.0, 1.0),
    ("decay", 1.0, 777, 0.0, 1.0),
    ("linear", 1.0, 1000, 0.3, 1.0),
    ("linear", 0.003, 1000, 0.0, 0.5),
    ("decay", 0.01, 999, 1e-3, 0.25),
])
def test_scheduler_get_matches_jax(kind, init, total, floor, ratio):
    j = jsched.Scheduler(kind, init, total, floor, ratio)
    t = tsched.Scheduler(kind, init, total, floor, ratio)
    for step in list(range(0, 2 * total + 1, 7)) + [total, 2 * total]:
        got = t.get(step)
        assert isinstance(got, float)
        assert np.float32(got) == np.float32(j.get(step)), (kind, step)


@pytest.mark.parametrize("batch_shape", [(), (3,), (2, 5)])
def test_fc_apply_matches_jax(batch_shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    x = rng.standard_normal((*batch_shape, 6)).astype(np.float32)
    want = jl.fc_apply(jl.FCParams(jnp.asarray(w), jnp.asarray(b)),
                       jnp.asarray(x))
    got = tl.fc_apply(tl.FCParams(torch.tensor(w), torch.tensor(b)),
                      torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_one_hot_matches_jax(dtype):
    """Exact, out-of-range indices (negative, n and beyond) included: both
    give a zero row."""
    x = np.array([[0, 3, 4, -1], [5, 2, -7, 1]], np.int64)
    want = np.asarray(jl.one_hot(jnp.asarray(x), 5, getattr(jnp, dtype)))
    got = tl.one_hot(torch.tensor(x), 5, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 4, 5)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    assert not want[0, 3].any() and not want[1, 0].any()


def _grid_specs(agent, width=8):
    """The JAX and the port's PolicySpec of ``agent`` on the 5x5 grid."""
    cfg = dict(scenario="large_grid", coop_gamma=0.9)
    mcfg = dict(num_fc=width, num_lstm=width)
    jenv = JLargeGridEnv(JEnvConfig(**cfg))
    tenv = LargeGridEnv(EnvConfig(**cfg), device="cpu")
    return (jmake_policy_spec(jenv.spec, JModelConfig(**mcfg), agent),
            make_policy_spec(tenv.spec, ModelConfig(**mcfg), agent))


def _single_inputs(spec, seed=1):
    rng = np.random.default_rng(seed)
    n, H = spec.n_agent, spec.n_lstm
    c = (rng.standard_normal((n, H)) * 0.5).astype(np.float32)
    h = (rng.standard_normal((n, H)) * 0.5).astype(np.float32)
    obs = rng.standard_normal((n, spec.n_s_max)).astype(np.float32)
    fp = rng.random((n, spec.n_a_max)).astype(np.float32)
    fp /= fp.sum(-1, keepdims=True)
    return c, h, obs, fp


@pytest.mark.parametrize("done", [0.0, 1.0])
@pytest.mark.parametrize("agent", AGENTS)
def test_policy_step_matches_jax(agent, done):
    """The single-env step of every agent on the 5x5 grid, 8/8 widths, f32:
    new carry, masked logits and values within 1e-5 of JAX's."""
    jspec, tspec = _grid_specs(agent)
    params = jp.init_policy_params(jax.random.key(0), jspec)
    # a 0.01-scale actor gives near-equal logits; scale it so they differ
    params = params._replace(actor=params.actor._replace(
        w=params.actor.w * 100.0))
    c, h, obs, fp = _single_inputs(tspec)
    jc, jlo, jv = jp.policy_step(
        jspec, jp.mask_comm_params(jspec, params),
        jp.Carry(jnp.asarray(c), jnp.asarray(h)), jnp.asarray(obs),
        jnp.asarray(fp), jnp.asarray(done, jnp.float32))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tc, tlo, tv = tp.policy_step(
        tspec, tp.mask_comm_params(tspec, tparams),
        tp.Carry(torch.tensor(c), torch.tensor(h)), torch.tensor(obs),
        torch.tensor(fp), torch.tensor(done))
    n, H, A = tspec.n_agent, tspec.n_lstm, tspec.n_a_max
    assert tc.c.shape == tc.h.shape == (n, H)
    assert tlo.shape == (n, A) and tv.shape == (n,)
    for a, b in [(tc.c, jc.c), (tc.h, jc.h), (tlo, jlo), (tv, jv)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("agent", ["ma2c_nc", "ma2c_dial"])
def test_policy_step_is_row_zero_of_the_batched_step(agent):
    """Bit-equal to ``policy_step_batched`` at B=1; within 1e-6 of row 0 at
    B=3 (the CPU's batched products block differently with B)."""
    _, spec = _grid_specs(agent)
    params = tp.mask_comm_params(spec, tp.init_policy_params(
        torch.Generator().manual_seed(0), spec))
    rows = [_single_inputs(spec, seed) for seed in (1, 2, 3)]
    c, h, obs, fp = [torch.tensor(np.stack(a)) for a in zip(*rows)]
    done = torch.tensor([1.0, 0.0, 1.0])
    sc, slo, sv = tp.policy_step(spec, params, tp.Carry(c[0], h[0]), obs[0],
                                 fp[0], done[0])
    for B in (1, 3):
        bc, blo, bv = tp.policy_step_batched(
            spec, params, tp.Carry(c[:B], h[:B]), obs[:B], fp[:B], done[:B])
        for a, b in [(sc.c, bc.c[0]), (sc.h, bc.h[0]), (slo, blo[0]),
                     (sv, bv[0])]:
            if B == 1:
                assert torch.equal(a, b), agent
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_graft_entry_gives_the_jax_entry_shapes():
    import __graft_entry__ as jentry
    from deeprl_network_tpu_torch import graft_entry

    jfn, jargs = jentry.entry()
    tfn, targs = graft_entry.entry(device="cpu")
    for a, b in zip(jax.tree.leaves(jargs), tp.tree_leaves(targs)):
        assert tuple(b.shape) == a.shape
    jout, tout = jfn(*jargs), tfn(*targs)
    jleaves, tleaves = jax.tree.leaves(jout), tp.tree_leaves(tout)
    assert [tuple(t.shape) for t in tleaves] == [a.shape for a in jleaves]
    assert all(torch.isfinite(t).all() for t in tleaves)
