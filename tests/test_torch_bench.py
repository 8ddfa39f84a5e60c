"""The port's throughput tools (``deeprl_network_tpu_torch/bench.py``,
``scripts/profile_step.py``, ``scripts/bench_variants.py``) against the JAX
repo's root ``bench.py`` and ``scripts/``: the same baseline inputs, the
same env for each scenario, the same variants table, and the tools' control
flow on the CPU."""

import ast
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from deeprl_network_tpu.config import EnvConfig as JEnvConfig
from deeprl_network_tpu.envs import grid as jgrid
from deeprl_network_tpu.envs.cacc import CACCEnv as JCACCEnv
from deeprl_network_tpu.envs.network import TrafficNetworkEnv as JNetEnv
from deeprl_network_tpu_torch import bench
from deeprl_network_tpu_torch.config import ModelConfig
from deeprl_network_tpu_torch.scripts import bench_variants, profile_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench_variants():
    """The JAX repo's ``scripts/bench_variants.py``, loaded by path (its top
    level puts "." on ``sys.path``: undone here)."""
    path = os.path.join(ROOT, "scripts", "bench_variants.py")
    spec = importlib.util.spec_from_file_location("_jax_bench_variants", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


# ---- bench.py ----

def test_baseline_inputs_equal_jax_topology():
    topo = jgrid.build_grid_topology(JEnvConfig(scenario="large_grid"))
    want = (np.stack([np.array(ls) for ls in topo.node_lanes]),
            topo.phase_gate, topo.demand, topo.route)
    for name, a, b in zip(("gather", "phase_gate", "demand", "route"),
                          bench.baseline_inputs(), want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert bench.measure_baseline(n_steps=5) > 0


def test_measure_gpu_runs_on_the_cpu():
    sps, loss = bench.measure_gpu(seconds_budget=0.01, num_envs=2,
                                  scenario="cacc_catchup", device="cpu")
    assert sps > 0 and math.isfinite(loss)


def test_measure_counts_whole_chunks():
    r = bench.measure(seconds_budget=0.01, num_envs=2,
                      scenario="cacc_catchup", device="cpu")
    assert r.updates == bench.CHUNK * len(r.chunk_s) > 0
    assert r.env_steps_per_s == pytest.approx(
        r.updates * 120 * 2 / r.window_s)
    assert r.warmup_s > 0 and r.init_s > 0


def _jax_bench_env(scenario, grid_size):
    """The env the JAX ``bench.py`` ``measure_tpu`` builds."""
    if scenario.startswith("cacc"):
        return JCACCEnv(JEnvConfig(scenario=scenario, coop_gamma=0.9))
    ecfg = JEnvConfig(scenario="large_grid", coop_gamma=0.9)
    if grid_size != 5:
        return JNetEnv(ecfg, jgrid.build_grid_topology(ecfg, grid_size))
    return jgrid.LargeGridEnv(ecfg)


@pytest.mark.parametrize("scenario,grid_size", [
    ("grid", 3), ("grid", 5), ("cacc_catchup", 5)])
def test_env_selection_matches_jax_bench(scenario, grid_size):
    env = bench.make_env(scenario, grid_size, device="cpu")
    jenv = _jax_bench_env(scenario, grid_size)
    assert type(env).__name__ == type(jenv).__name__
    assert env.spec.n_agent == jenv.spec.n_agent
    assert env.spec.n_s_ls == jenv.spec.n_s_ls
    assert env.spec.n_a_ls == jenv.spec.n_a_ls
    assert env.cfg.scenario == jenv.cfg.scenario
    assert env.spec.coop_gamma == jenv.spec.coop_gamma == 0.9
    if hasattr(jenv, "topo"):
        assert env.topo.n_lane == jenv.topo.n_lane
    else:
        assert not hasattr(env, "topo")


def test_main_prints_the_four_keys_last(monkeypatch, capsys):
    seen = {}

    def fake_measure(**kw):
        seen.update(kw)
        return 54321.0, 1.25

    monkeypatch.setattr(bench, "measure_baseline", lambda: 987.0)
    monkeypatch.setattr(bench, "measure_gpu", fake_measure)
    bench.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == BENCH_KEYS
    assert out == {"metric": "env_steps_per_s_per_gpu_grid25_ma2c_nc",
                   "value": 54321.0, "unit": "env-steps/s/gpu",
                   "vs_baseline": round(54321.0 / 987.0, 2)}
    assert seen == dict(num_envs=768, compute_dtype="bfloat16",
                        sparse_comm=True, remat=True)


# ---- scripts/profile_step.py ----

@pytest.mark.parametrize("thread", [True, False])
def test_time_it_makes_n_plus_one_calls(thread):
    seen = []

    def fn(x):
        seen.append(int(x))
        return x + 1, x * 2

    dt = profile_step.time_it(fn, torch.tensor(0), n=4,
                              sync=lambda out: out[1], thread=thread)
    assert dt >= 0
    assert seen == ([0, 1, 2, 3, 4] if thread else [0] * 5)


def test_profile_step_main_on_the_cpu(capsys):
    profile_step.main(["--num-envs", "2", "--t", "3"], device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # ``env_span`` reads the marks, which run on a card only
    assert set(out) == {"full_ma2c_nc", "ia2c"}
    assert all(v > 0 for v in out.values())


# ---- scripts/bench_variants.py ----

def test_variants_table_equals_the_jax_tool():
    path = os.path.join(ROOT, "scripts", "bench_variants.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    top = [a.name for node in tree.body if isinstance(node, ast.Import)
           for a in node.names]
    top += [node.module for node in tree.body
            if isinstance(node, ast.ImportFrom)]
    assert set(top) <= {"__future__", "argparse", "json", "sys", "time"}
    assert bench_variants.VARIANTS == _jax_bench_variants().VARIANTS


@pytest.mark.parametrize("name", sorted(bench_variants.VARIANTS))
def test_variant_overrides_build_the_model_config(name):
    over = dict(bench_variants.VARIANTS[name])
    num_envs = over.pop("num_envs", 512)
    assert over.pop("grid_size", 5) in (5, 7, 10)
    assert over.pop("scenario", "grid") in ("grid", "cacc_catchup")
    cfg = ModelConfig(batch_size=120, num_envs=num_envs, **over)
    assert cfg.num_envs == num_envs
    assert cfg.compute_dtype in ("float32", "bfloat16")


def test_run_variant_passes_the_variant_to_measure():
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return 1234.56, 7.891

    row = bench_variants.run_variant("n100_flag_sparse", 3.0, 512,
                                     device="cpu", measure=fake)
    assert seen == dict(seconds_budget=3.0, num_envs=192, grid_size=10,
                        scenario="grid", device="cpu",
                        compute_dtype="bfloat16", sparse_comm=True,
                        remat=True)
    assert row["variant"] == "n100_flag_sparse"
    assert (row["env_steps_per_s"], row["loss"]) == (1234.6, 7.891)
    assert row["total_s"] >= 0


def _raiser(exc):
    def measure(**kw):
        raise exc
    return measure


FUSED_ONLY = ("compute_dtype=bfloat16 is supported on the default "
              "fused-gradient path only")


@pytest.mark.parametrize("exc,key", [
    (ValueError(FUSED_ONLY), "unsupported"),
    (RuntimeError("CUDA error: an illegal memory access"), "error"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "error"),
])
def test_exceptions_become_rows(exc, key):
    row = bench_variants.run_variant("bf16", 1.0, 4, device="cpu",
                                     measure=_raiser(exc))
    assert set(row) == {"variant", key} and row["variant"] == "bf16"
    assert str(exc) in row[key]


@pytest.mark.parametrize("exc", [TypeError("bad override"),
                                 ValueError("another config error")])
def test_other_exceptions_propagate(exc):
    with pytest.raises(type(exc), match=str(exc)):
        bench_variants.run_variant("bf16", 1.0, 4, device="cpu",
                                   measure=_raiser(exc))


def test_bench_variants_main_writes_rows(tmp_path, monkeypatch):
    real = bench_variants.run_variant
    fake = lambda **kw: (float(kw["num_envs"]), 0.5)
    monkeypatch.setattr(bench_variants, "run_variant",
                        lambda *a: real(*a, measure=fake))
    out = tmp_path / "rows.jsonl"
    bench_variants.main(["--seconds", "0.5", "--num-envs", "4",
                         "--variants", "bf16_b256, cacc_f32_b64,bf16",
                         "--out", str(out)], device="cpu")
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows[0] == {"run": {"seconds": 0.5, "num_envs": 4,
                               "variants": "bf16_b256, cacc_f32_b64,bf16",
                               "out": str(out)}}
    assert [(r["variant"], r["env_steps_per_s"]) for r in rows[1:]] == [
        ("bf16_b256", 256.0), ("cacc_f32_b64", 64.0), ("bf16", 4.0)]
