"""Card twin of ``tests/test_acceptance.py``: the JAX package's three
acceptance bars, trained end to end by the port on a CUDA card.

Same tests, configurations, budgets, seed (``init_state(0)``) and
thresholds as the JAX file:

1. ``test_cacc_catchup_parity``: IA2C (``coop_gamma=-1``) and MA2C_NC (0.9)
   master CACC catch-up within 2M steps;
2. ``test_cacc_slowdown_solved_teacher_free``: MA2C_NC solves slow-down at
   6M steps, no kickstart;
3. ``test_learned_beats_greedy_small_grid``: MA2C_NC with kickstart on the
   3x3 grid beats the greedy controller at 25M steps.

They train for minutes to an hour, need a card and import no JAX, so they
run on the card's machine under ``--noconftest`` (``tests/conftest.py``
imports JAX):

    RUN_SLOW=1 python -m pytest --noconftest -q tests/test_torch_acceptance.py

Each run writes its curve to ``$ACCEPTANCE_OUT/<run>.jsonl`` (a pytest
temporary directory when the variable is unset): one row an update, written
ten at a time, so a cut run still leaves its curve. A checkpoint is kept
every ``SAVE_EVERY`` updates under ``$ACCEPTANCE_OUT/<run>/model``; a run
that finds one resumes from it (resume is bit-exact, see
``tests/test_torch_checkpoint.py``). With ``ACCEPTANCE_STOP_AFTER_S`` set,
a run that has trained that many seconds saves at its next ten-update row
and skips, naming the step it reached, so a run longer than one sitting
continues in the next.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from deeprl_network_tpu_torch.envs.network import TrafficNetworkEnv
from deeprl_network_tpu_torch.scripts.train_atsc import greedy_returns
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.rollout import make_a2c

slow = pytest.mark.skipif(
    os.environ.get("RUN_SLOW", "0") != "1",
    reason="long training run; set RUN_SLOW=1 to enable")
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

DEVICE = "cuda"
LOGGED = ("env/collision", "episode_len", "env/headway_err",
          "episode_return")
ROW_EVERY = 10    # updates a curve row block holds; the final window too
SAVE_EVERY = 100  # updates between checkpoints


@pytest.fixture
def out_dir(tmp_path):
    out = os.environ.get("ACCEPTANCE_OUT") or str(tmp_path)
    os.makedirs(out, exist_ok=True)
    return out


def _launches(fn, *args):
    """(fn's result, the cell kernel launches it made by counter)."""
    from deeprl_network_tpu_torch.ops.lstm_cell import LAUNCHES
    before = dict(LAUNCHES)
    out = fn(*args)
    return out, {k: v - before[k] for k, v in LAUNCHES.items()
                 if v != before[k]}


def _expect_general(got, fwd, bwd):
    want = {"lstm_cell_fwd": fwd, "lstm_cell_fwd_general": fwd}
    if bwd:
        want.update({"lstm_cell_bwd": bwd, "lstm_cell_bwd_general": bwd})
    assert got == want, got


def _train(fns, tcfg, out, name):
    """Train from ``init_state(0)`` (or the run's last checkpoint) to
    ``tcfg.total_step``, writing the curve; returns the final TrainState and
    the metrics of the last ``ROW_EVERY`` updates as host floats. The first
    update is checked to run the f32 general cell kernels, T+1 forward and
    T backward launches (no remat)."""
    ts = fns.init_state(0)
    mgr = CheckpointManager(os.path.join(out, name, "model"), max_to_keep=2)
    curve = os.path.join(out, f"{name}.jsonl")
    rows = []
    if mgr.latest_step() is not None:
        ts = mgr.restore(ts)
        with open(curve) as f:
            rows = [r for r in map(json.loads, f) if r["step"] <= ts.step]
    with open(curve, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    stop_after = float(os.environ.get("ACCEPTANCE_STOP_AFTER_S", "inf"))
    t0 = time.perf_counter()
    update = ts.step // fns.steps_per_update
    pending, window = [], rows[-ROW_EVERY:]
    T = fns.steps_per_update // ts.obs.shape[0]
    first = True
    while ts.step < tcfg.total_step:
        (ts, m), counts = _launches(fns.train_step, ts)
        if first:
            _expect_general(counts, T + 1, T)
            first = False
        update += 1
        pending.append((update, ts.step, m))
        if len(pending) < ROW_EVERY and ts.step < tcfg.total_step:
            continue
        keys = [k for k in LOGGED if k in m]
        # one device-to-host transfer for the block
        vals = torch.stack([torch.stack([p[2][k].float() for k in keys])
                            for p in pending]).tolist()
        wall = time.perf_counter() - t0
        block = [dict(update=u, step=s, wall_s=wall, **dict(zip(keys, v)))
                 for (u, s, _), v in zip(pending, vals)]
        with open(curve, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in block)
        window = (window + block)[-ROW_EVERY:]
        pending = []
        if update % SAVE_EVERY == 0 or wall > stop_after:
            mgr.save(ts.step, ts)
        if wall > stop_after and ts.step < tcfg.total_step:
            pytest.skip(f"{name}: stopped after {wall:.0f} s at step "
                        f"{ts.step} of {tcfg.total_step}; rerun to resume")
    return ts, window


def _window_mean(window, key):
    return float(np.mean([r[key] for r in window]))


def _small_grid_env():
    from deeprl_network_tpu_torch.envs.grid import build_grid_topology

    # full 3600 s episodes, as in the JAX test (the claim is about
    # sustained congestion, not the empty-road regime of 720 s episodes)
    cfg = EnvConfig(scenario="large_grid", coop_gamma=0.9, clip_wave=8.0,
                    phase_in_obs=True, queue_in_obs=True)
    return TrafficNetworkEnv(cfg, build_grid_topology(cfg, size=3),
                             DEVICE), cfg


@slow
@needs_cuda
def test_learned_beats_greedy_small_grid(out_dir):
    """Learned MA2C_NC (phase+queue obs, kickstart toward the hysteresis
    teacher annealed to 0 by half-budget) beats the stronger of the queue
    and wave greedy controllers on a 3x3 grid within 25M steps; sampled
    eval at held-out seeds 10000-10002, as in the JAX test."""
    env, cfg = _small_grid_env()
    horizon = env.episode_steps
    # the grid's reset draws nothing, so one seed stands for all
    sweep = greedy_returns(env, (0,), horizon)
    greedy = max(sweep["queue"][0], sweep["wave"][0])

    mcfg = ModelConfig(batch_size=120, num_envs=64, lr_init=2.5e-3,
                       lr_decay="linear", entropy_coef=0.003,
                       entropy_decay="linear", reward_norm=2000.0,
                       kickstart_coef=1.0, kickstart_ratio=0.5)
    tcfg = TrainConfig(total_step=25_000_000)
    fns = make_a2c(env, mcfg, tcfg, agent="ma2c_nc", device=DEVICE)
    ts, _ = _train(fns, tcfg, out_dir, "grid3x3_ma2c_nc")
    rets = []
    for s in range(3):
        out, counts = _launches(fns.eval_episode, ts.params, 10_000 + s,
                                None, False)
        _expect_general(counts, horizon, 0)
        rets.append(float(out["episode_return"]))
    learned = float(np.mean(rets))
    with open(os.path.join(out_dir, "grid3x3_ma2c_nc_eval.json"), "w") as f:
        json.dump(dict(greedy=greedy, eval_returns=rets, learned=learned),
                  f)
    assert learned > greedy, (
        f"learned {learned:.0f} must beat greedy {greedy:.0f}")


@slow
@needs_cuda
def test_cacc_slowdown_solved_teacher_free(out_dir):
    """MA2C_NC ends a 6M-step slow-down run out of the crash regime, with
    no kickstart and the default collision penalty: final-window collision
    rate <= 5e-3 and episode length >= 500 of 600."""
    from deeprl_network_tpu_torch.envs.cacc import CACCEnv

    env = CACCEnv(EnvConfig(scenario="cacc_slowdown", coop_gamma=0.9),
                  DEVICE)
    mcfg = ModelConfig(batch_size=120, num_envs=64, reward_norm=1000.0,
                       lr_decay="linear")
    tcfg = TrainConfig(total_step=6_000_000)
    fns = make_a2c(env, mcfg, tcfg, agent="ma2c_nc", device=DEVICE)
    _, window = _train(fns, tcfg, out_dir, "cacc_slowdown_ma2c_nc")
    coll = _window_mean(window, "env/collision")
    eplen = _window_mean(window, "episode_len")
    assert coll <= 5e-3, coll
    assert eplen >= 500.0, eplen


@slow
@needs_cuda
def test_cacc_catchup_parity(out_dir):
    """IA2C and MA2C_NC both master CACC catch-up within 2M steps: collision
    rate <= 5e-3, episodes >= 500 steps, headway error <= 3 m over the last
    ten updates."""
    from deeprl_network_tpu_torch.envs.cacc import CACCEnv

    final = {}
    for agent in ("ia2c", "ma2c_nc"):
        coop = 0.9 if agent.startswith("ma2c") else -1.0
        env = CACCEnv(EnvConfig(scenario="cacc_catchup", coop_gamma=coop),
                      DEVICE)
        mcfg = ModelConfig(batch_size=120, num_envs=64, reward_norm=1000.0)
        tcfg = TrainConfig(total_step=2_000_000)
        fns = make_a2c(env, mcfg, tcfg, agent=agent, device=DEVICE)
        _, window = _train(fns, tcfg, out_dir, f"cacc_catchup_{agent}")
        final[agent] = [_window_mean(window, k) for k in
                        ("env/collision", "episode_len", "env/headway_err")]
    # both agents train before either is judged, so a failure shows both
    for agent, (coll, eplen, herr) in final.items():
        assert coll <= 5e-3, (agent, coll)
        assert eplen >= 500.0, (agent, eplen)
        assert herr <= 3.0, (agent, herr)
