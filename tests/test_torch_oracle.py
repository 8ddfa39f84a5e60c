"""The port's batched engine against the native C++ oracle
(``native/sfq_oracle.cpp`` through the JAX package's ctypes bindings, which
import no JAX): a third, independent witness beside the JAX engine. The
port's ``LargeGridEnv`` and ``RealNetEnv`` at B=1 on the CPU and the oracle
run the same 50 random valid actions from the same drawn initial queues and
must agree at ``rtol=1e-4, atol=1e-3`` on node queues, waits, rewards,
throughput, termination, dropped vehicles and the final lane state with the
transit ring; the greedy controllers must agree exactly."""

import numpy as np
import pytest
import torch

from deeprl_network_tpu.envs import native_oracle
from deeprl_network_tpu.envs.native_oracle import NativeNetworkOracle
from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
from deeprl_network_tpu_torch.envs.monaco import RealNetEnv

TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _private_library(tmp_path_factory):
    """Build the oracle into a directory of this module's own: another test
    process may be rebuilding the shared ``native/libsfq_oracle.so`` (the
    JAX package's own oracle test forces a build) while this one loads."""
    mp = pytest.MonkeyPatch()
    mp.setattr(native_oracle, "_LIB", str(
        tmp_path_factory.mktemp("oracle") / "libsfq_oracle.so"))
    mp.setattr(native_oracle, "_lib_cache", None)
    yield
    mp.undo()


def _make_env(scenario):
    if scenario == "grid":
        return LargeGridEnv(EnvConfig(
            scenario="large_grid", episode_length_sec=600, init_density=0.3,
            objective="hybrid"), device="cpu")
    return RealNetEnv(EnvConfig(
        scenario="real_net", episode_length_sec=600, init_density=0.3,
        objective="queue"), device="cpu")


@pytest.mark.parametrize("scenario", ["grid", "monaco"])
def test_oracle_matches_port_engine(scenario):
    env = _make_env(scenario)
    oracle = NativeNetworkOracle(env)
    state, _ = env.reset(1, torch.Generator().manual_seed(7))
    assert float(state.queue.max()) > 0
    oracle.reset(state.queue[0].numpy())

    n_steps = 50
    rng = np.random.RandomState(3)
    n_a = np.array(env.spec.n_a_ls)
    actions = np.stack([rng.randint(0, n_a) for _ in range(n_steps)]
                       ).astype(np.int32)
    tq, tw, tr, tflow, tdone = [], [], [], [], []
    for t in range(n_steps):
        state, _, reward, done, info = env.step(
            state, torch.as_tensor(actions[t])[None])
        rec = env.record(state)
        tq.append(rec["node_queue"][0].numpy())
        tw.append(rec["node_wait"][0].numpy())
        tr.append(reward[0].numpy())
        tflow.append(float(info["throughput"][0]))
        tdone.append(bool(done[0]))
    out = oracle.rollout(actions)

    np.testing.assert_allclose(out["node_queue"], np.stack(tq), **TOL)
    np.testing.assert_allclose(out["node_wait"], np.stack(tw), **TOL)
    np.testing.assert_allclose(out["reward"], np.stack(tr), **TOL)
    np.testing.assert_allclose(out["throughput"], np.array(tflow), **TOL)
    assert list(out["done"]) == tdone
    np.testing.assert_allclose(out["dropped"], float(state.dropped[0]),
                               rtol=1e-4, atol=1e-2)
    # final lane-level state agrees too, in-transit ring buffer included
    np.testing.assert_allclose(oracle.queue, state.queue[0].numpy(), **TOL)
    np.testing.assert_allclose(oracle.wait, state.wait[0].numpy(), **TOL)
    assert oracle.transit_aligned.shape == tuple(state.transit[0].shape)
    np.testing.assert_allclose(oracle.transit_aligned,
                               state.transit[0].numpy(), **TOL)
    assert float(np.stack(tq).max()) > 0 and max(tflow) > 0


@pytest.mark.parametrize("scenario", ["grid", "monaco"])
def test_oracle_greedy_matches_port_greedy(scenario):
    env = _make_env(scenario)
    oracle = NativeNetworkOracle(env)
    state, _ = env.reset(1, torch.Generator().manual_seed(11))
    oracle.reset(state.queue[0].numpy())
    for _ in range(5):
        a_port = env.greedy_action(state)
        a_nat = oracle.greedy_action()
        np.testing.assert_array_equal(a_nat, a_port[0].numpy())
        state, *_ = env.step(state, a_port)
        oracle.rollout(a_nat[None])


def test_oracle_runs_past_the_episode_end_with_the_port():
    """60 s episodes = 12 control steps: ``done`` rises at the same step in
    both (the bare env does not reset)."""
    env = LargeGridEnv(EnvConfig(scenario="large_grid",
                                 episode_length_sec=60), device="cpu")
    oracle = NativeNetworkOracle(env)
    state, _ = env.reset(1)
    acts = np.zeros((14, 25), np.int32)
    done = []
    for t in range(14):
        state, _, _, d, _ = env.step(state, torch.as_tensor(acts[t])[None])
        done.append(bool(d[0]))
    assert list(oracle.rollout(acts)["done"]) == done
    assert done[10:12] == [False, True]
