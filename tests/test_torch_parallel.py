"""The port's data parallelism (``deeprl_network_tpu_torch/parallel``) on the
CPU, twins of ``tests/test_parallel.py``: gloo ranks in worker processes
(``parallel/smoke_worker.py``, one torch thread each, killed after 180 s),
the global batch split over them, params replicated.

- an N-rank update equals the 1-process update on the combined batch (every
  rank draws its noise at the global shape and keeps its rows): obs exact,
  loss at rtol 1e-5, params at rtol 1e-4 / atol 1e-6, the bars of
  ``tests/test_parallel.py``;
- the slice against JAX: the port at 2 ranks, from the JAX params and fed
  its rows of the Gumbel noise JAX draws from its per-env keys, against
  ``make_parallel_a2c`` on a 4-device mesh; metrics at rtol 1e-4, every
  param at atol 1e-5, over two updates;
- ``restore_params`` from a 2-rank checkpoint drives a 1-process eval.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deeprl_network_tpu.config import (
    EnvConfig as JEnvConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from deeprl_network_tpu.envs.cacc import CACCEnv as JCACCEnv
from deeprl_network_tpu.parallel.train import (
    make_mesh, make_parallel_a2c as jmake_parallel_a2c,
)
from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.models.policies import tree_leaves
from deeprl_network_tpu_torch.parallel.smoke_worker import run_ranks
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.convert import params_from_jax
from deeprl_network_tpu_torch.utils.rollout import make_a2c
from test_torch_train import CACC_KW, METRICS, _jax_gumbel

ENV = dict(scenario="cacc_catchup", coop_gamma=0.9, episode_length=40)
MODEL = dict(batch_size=8, num_fc=16, num_lstm=16, num_envs=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranks(n, spec, out):
    """``n`` gloo ranks of ``spec`` on the CPU, one thread each."""
    return run_ranks(n, spec, str(out), device="cpu", backend="gloo",
                     timeout=180, env=dict(os.environ, OMP_NUM_THREADS="1"))


def rank_arrays(results):
    return [np.load(r["npz"]) for r in results]


def single(agent, env_kw, model_kw, seed):
    """The 1-process functions and initial state of the global batch."""
    fns = make_a2c(CACCEnv(EnvConfig(**env_kw), device="cpu"),
                   ModelConfig(**model_kw), TrainConfig(total_step=10_000),
                   agent=agent, device="cpu")
    return fns, fns.init_state(seed)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One update of MA2C_NC on 2 ranks of 4 envs (initial noise on), with a
    checkpoint saved after it."""
    out = tmp_path_factory.mktemp("two_ranks")
    spec = dict(agent="ma2c_nc", env=ENV, model=MODEL, updates=1,
                ckpt=str(out / "ckpt"))
    return ranks(2, spec, out), out


def test_global_batch_and_step_count(two_ranks):
    results, _ = two_ranks
    for r in results:
        # global env batch = envs a rank x ranks
        assert r["world_size"] == 2 and r["envs"] == 4
        assert r["backend"] == "gloo"
        assert np.isfinite(r["metrics"][0]["loss"])
        # the step counts every rank's env steps
        assert r["steps_per_update"] == r["step"] == 8 * MODEL["batch_size"]
        # one flat all-reduce an update: every param and the device metrics
        assert r["allreduce"]["calls"] == 1
    assert results[0]["metrics"] == results[1]["metrics"]


def test_params_stay_replicated_and_envs_differ(two_ranks):
    results, _ = two_ranks
    a, b = rank_arrays(results)
    n_params = sum(1 for k in a.files if k[0] == "p" and k[1:].isdigit())
    assert n_params > 5
    for i in range(n_params):
        np.testing.assert_array_equal(a[f"p{i}"], b[f"p{i}"])
    assert results[0]["params_sha256"] == results[1]["params_sha256"]
    # the ranks hold different envs (their rows of one global draw)
    h0, h1 = a["env_state0"], b["env_state0"]
    assert h0.shape == h1.shape == (4, 8)
    assert not np.allclose(h0, h1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("agent,levers", [
    ("ia2c", {}),
    ("ma2c_nc", {}),
    # the flagship lever set: sparse_comm's K-packing and remat
    ("ma2c_nc", {"sparse_comm": True, "remat": True}),
])
def test_multi_rank_update_equals_single_process(agent, levers, n, tmp_path):
    """The same 4-env global batch on n ranks and in one process: the same
    noise, so the same trajectories (obs bitwise), and the averaged update
    equals the batch-mean update up to float reassociation."""
    model = dict(MODEL, num_envs=4, **levers)
    results = ranks(n, dict(agent=agent, env=ENV, model=model, updates=2,
                            seed=7), tmp_path)
    fns, ts = single(agent, ENV, model, 7)
    for _ in range(2):
        ts, m = fns.train_step(ts)
    arrays = rank_arrays(results)
    obs = np.concatenate([z["obs0"] for z in arrays])
    np.testing.assert_array_equal(obs, ts.obs.numpy())
    for r in results:
        np.testing.assert_allclose(r["metrics"][-1]["loss"], float(m["loss"]),
                                   rtol=1e-5, atol=1e-6)
        assert r["step"] == ts.step
    for z in arrays:
        for i, p in enumerate(tree_leaves(ts.params)):
            np.testing.assert_allclose(z[f"p{i}"], p.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"param {i}")


def test_restore_params_from_dp_checkpoint_into_single_process(two_ranks):
    """A checkpoint written by 2 ranks restores its params into a 1-process
    eval whose env batch differs, exactly, and the eval runs."""
    results, out = two_ranks
    ckpt = CheckpointManager(str(out / "ckpt"))
    assert ckpt.all_steps() == [results[0]["step"]]
    fns, like = single("ma2c_nc", dict(ENV, episode_length=24),
                       dict(MODEL, num_envs=2), 3)
    params = ckpt.restore_params(like.params)
    stored = rank_arrays(results)[0]
    for i, p in enumerate(tree_leaves(params)):
        np.testing.assert_array_equal(p.numpy(), stored[f"p{i}"])
    out = fns.eval_episode(params, 3)
    assert np.isfinite(float(out["episode_return"]))


def test_two_rank_port_matches_jax_parallel(tmp_path):
    """The slice against JAX: 2 ranks of 2 envs against the JAX
    data-parallel step on a 4-device mesh (one env a device), from the same
    params and noise, over two updates that cross an episode end."""
    model = dict(batch_size=8, num_envs=4, num_fc=16, num_lstm=16)
    jenv = JCACCEnv(JEnvConfig(**CACC_KW))
    jpar = jmake_parallel_a2c(jenv, JModelConfig(**model),
                              JTrainConfig(total_step=10_000),
                              agent="ma2c_nc",
                              mesh=make_mesh(n_devices=4), envs_per_device=1)
    jts = jpar.init_state(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jts.params), "cpu")
    np.savez(tmp_path / "params.npz", **{
        f"p{i}": p.numpy() for i, p in enumerate(tree_leaves(tparams))})
    spec = jpar.spec
    gumbel, jmetrics = [], []
    for _ in range(2):
        # copy before the JAX call: train_step donates its argument
        keys = np.asarray(jts.key).copy()
        gumbel.append(_jax_gumbel(keys, 8, spec.n_agent, spec.n_a_max))
        jts, jm = jpar.train_step(jts)
        jmetrics.append({k: float(v) for k, v in jm.items()})
    np.savez(tmp_path / "gumbel.npz", gumbel=np.stack(gumbel))
    results = ranks(2, dict(agent="ma2c_nc", env=CACC_KW, model=model,
                            updates=2, params=str(tmp_path / "params.npz"),
                            gumbel=str(tmp_path / "gumbel.npz")), tmp_path)
    for r in results:
        for tm, jm in zip(r["metrics"], jmetrics):
            assert tm.keys() == jm.keys()
            for k in METRICS:
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
        assert r["metrics"][-1]["episode_len"] == 12.0
        assert r["step"] == int(jts.step)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jts.params)]
    for z in rank_arrays(results):
        for i, leaf in enumerate(jleaves):
            np.testing.assert_allclose(z[f"p{i}"], leaf, atol=1e-5,
                                       err_msg=f"param {i}")
