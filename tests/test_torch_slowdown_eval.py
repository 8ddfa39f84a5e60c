"""What a slow-down eval return says about a policy.

The JAX probe (``scripts/train_cacc_families.py``) and the port's harness
score a policy by the mean sampled return of three episodes, seeds
2000-2002. Each seed draws the platoon's initial noise and every step's
sampling noise through the generator of its package and device: threefry
in JAX, mt19937 for the port on the CPU, Philox on a card. So one policy
meets other episodes in each, and a three-episode mean moves with them.

- ``test_cuda_eval_noise_has_the_cpu_law`` (card): the card's Gumbel draws
  have the law of the CPU's, and one policy's returns over 20 seeds agree in
  mean on the card and on the CPU (within 4 standard errors) while the
  episodes differ. With ``SLOWDOWN_EVAL_PARAMS`` naming a file the slow
  test wrote, that policy is held the same way.
- ``test_slowdown_policy_eval_by_generator`` (slow, CPU, JAX): MA2C_NC
  trained teacher-free for 10M steps (the harness's defaults, seed 0) by
  JAX and by the port; each policy evaluated over 20 seeds by JAX and by
  the port; the means go to ``$SLOWDOWN_EVAL_OUT/slowdown_eval.json`` and
  the JAX policy, converted, to ``jax_ma2c_nc.pt`` there.

Neither imports JAX at module level, so the card test runs on the card's
machine under ``--noconftest``:

    RUN_SLOW=1 SLOWDOWN_EVAL_OUT=_resume/eval python -m pytest -q -s \\
        tests/test_torch_slowdown_eval.py          # CPU, about 35 min
    SLOWDOWN_EVAL_PARAMS=_resume/eval/jax_ma2c_nc.pt python -m pytest \\
        --noconftest -q -s tests/test_torch_slowdown_eval.py   # on a card
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.models.policies import tree_map
from deeprl_network_tpu_torch.utils.rollout import gumbel_noise, make_a2c

slow = pytest.mark.skipif(
    os.environ.get("RUN_SLOW", "0") != "1",
    reason="long training run; set RUN_SLOW=1 to enable")
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

N_SEEDS = 20
# the harness's slow-down recipe (train_cacc_families defaults)
MODEL = dict(batch_size=120, num_envs=64, reward_norm=1000.0, reward_clip=2.0,
             gamma=0.99, lr_init=5e-4, entropy_coef=0.01,
             entropy_decay="constant", lr_decay="linear")
TOTAL_STEP = 10_000_000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test processes share the machine: more threads than one only
    fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_fns(device):
    env = CACCEnv(EnvConfig(scenario="cacc_slowdown", coop_gamma=0.9),
                  device=device)
    return make_a2c(env, ModelConfig(**MODEL), TrainConfig(
        total_step=TOTAL_STEP), agent="ma2c_nc", device=device)


def _port_evals(fns, params):
    return [fns.eval_episode(params, 2000 + s, None, False)
            for s in range(N_SEEDS)]


def _summary(evals):
    """Mean return of the first three seeds and of all, its standard error,
    every return, and the shortest episode."""
    rets = [float(e["episode_return"]) for e in evals]
    return {"first3": float(np.mean(rets[:3])), "mean": float(np.mean(rets)),
            "sem": float(np.std(rets, ddof=1) / math.sqrt(len(rets))),
            "returns": rets,
            "min_len": min(float(e["episode_len"]) for e in evals)}


def _same_law(a, b):
    """The 20-seed means of two evaluations within 4 standard errors."""
    return abs(a["mean"] - b["mean"]) <= 4 * math.hypot(a["sem"], b["sem"])


@needs_cuda
def test_cuda_eval_noise_has_the_cpu_law():
    g = torch.Generator(device="cuda").manual_seed(0)
    x = gumbel_noise(g, (1000, 1000), "cuda")
    y = gumbel_noise(g, (1000, 1000), "cuda")
    assert not torch.equal(x, y)
    assert abs(float(x.mean()) - 0.5772157) < 0.01          # Euler's gamma
    assert abs(float(x.var()) - math.pi ** 2 / 6) < 0.02

    fns = {d: _port_fns(d) for d in ("cuda", "cpu")}
    policies = {"random init (seed 0)": fns["cpu"].init_state(0).params}
    path = os.environ.get("SLOWDOWN_EVAL_PARAMS")
    if path:
        policies[os.path.basename(path)] = torch.load(path,
                                                      weights_only=False)
    for name, params in policies.items():
        got = {d: _summary(_port_evals(fns[d], tree_map(
            lambda t: t.to(d), params))) for d in fns}
        print(json.dumps({"policy": name, **got}))
        assert _same_law(got["cuda"], got["cpu"]), name
        assert got["cuda"]["returns"] != got["cpu"]["returns"], name


@slow
def test_slowdown_policy_eval_by_generator(tmp_path):
    import jax

    from deeprl_network_tpu.config import EnvConfig as JEnvConfig
    from deeprl_network_tpu.config import ModelConfig as JModelConfig
    from deeprl_network_tpu.config import TrainConfig as JTrainConfig
    from deeprl_network_tpu.envs.cacc import CACCEnv as JCACCEnv
    from deeprl_network_tpu.utils.rollout import make_a2c as jmake_a2c
    from deeprl_network_tpu_torch.utils.convert import params_from_jax

    out = os.environ.get("SLOWDOWN_EVAL_OUT") or str(tmp_path)
    os.makedirs(out, exist_ok=True)
    jfns = jmake_a2c(JCACCEnv(JEnvConfig(scenario="cacc_slowdown",
                                         coop_gamma=0.9)),
                     JModelConfig(**MODEL), JTrainConfig(
                         total_step=TOTAL_STEP), agent="ma2c_nc")
    fns = _port_fns("cpu")
    n_upd = TOTAL_STEP // fns.steps_per_update

    jts = jfns.init_state(jax.random.key(0))
    for _ in range(n_upd):
        jts, _ = jfns.train_step(jts)
    ts = fns.init_state(0)
    for _ in range(n_upd):
        ts, _ = fns.train_step(ts)

    jparams = params_from_jax(jax.device_get(jts.params), "cpu")
    torch.save(jparams, os.path.join(out, "jax_ma2c_nc.pt"))
    res = {
        "jax policy, JAX eval": _summary([
            jfns.eval_episode(jts.params, jax.random.key(2000 + s), None,
                              False) for s in range(N_SEEDS)]),
        "jax policy, port eval": _summary(_port_evals(fns, jparams)),
        "port policy, port eval": _summary(_port_evals(fns, ts.params)),
    }
    with open(os.path.join(out, "slowdown_eval.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps({k: {m: v[m] for m in ("first3", "mean", "sem",
                                            "min_len")}
                      for k, v in res.items()}))
    assert _same_law(res["jax policy, JAX eval"],
                     res["jax policy, port eval"])
    for v in res.values():                  # no eval episode crashed
        assert v["min_len"] == 600
