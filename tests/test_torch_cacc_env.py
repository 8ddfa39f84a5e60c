"""The CACC platoon's env-step kernel (``ops/cacc_env.py``,
``csrc/cacc_env.cu``) and ``CACCEnv.step_autoreset``, without a card and on
one.

On the CPU: ``step_autoreset`` (the plain twin there) against
``AutoResetEnv``'s generic path (step, reset, per-platoon select) bit for
bit, the generator's state after every step included; the draws it skips;
an instance whose ``step`` was replaced; the numbers ``c_args`` folds for
the kernel (its f32 reciprocals and Python's products); the dispatch and
the wrapper's refusals. Card-only cases (``needs_cuda``) hold the kernel
against the twin on the card bit for bit, pin what it does with an action
outside [0, 4), and count its launches inside a captured update; they run
on a machine
without JAX (``python -m pytest --noconftest -q tests/test_torch_cacc_env.py
-k cuda``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs import cacc as cacc_mod
from deeprl_network_tpu_torch.envs.cacc import OVM_GAINS, CACCEnv
from deeprl_network_tpu_torch.envs.wrappers import AutoResetEnv
from deeprl_network_tpu_torch.ops import _build
from deeprl_network_tpu_torch.ops import cacc_env as ce

# decided when each test is set up, not at import
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

SCENARIOS = [(s, v) for s in ("catchup", "slowdown")
             for v in ("fixed", "profile")]
F = np.float32


def make_env(scenario="catchup", v_target="profile", device="cpu", **kw):
    kw.setdefault("episode_length", 200)
    return CACCEnv(EnvConfig(scenario=f"cacc_{scenario}", v_target=v_target,
                             **kw), device=device)


def schedule(steps, B, n, device="cpu", seed=1):
    """[steps, B, n] actions: uniform draws, but every third platoon takes
    action 0 (no control) throughout, which on the slow-down ramp runs it
    into its predecessor; on catch-up the uniform draws collide."""
    gen = torch.Generator(device=device).manual_seed(seed)
    acts = torch.randint(0, 4, (steps, B, n), device=device, generator=gen)
    reckless = (torch.arange(B, device=device) % 3 == 0)[None, :, None]
    return torch.where(reckless, torch.zeros_like(acts), acts)


def outputs(out):
    """(name, tensor) of one auto-reset step: the state's leaves, obs,
    reward, done and info."""
    state, obs, reward, done, info = out
    yield from zip(state._fields, state)
    yield from (("obs", obs), ("reward", reward), ("done", done))
    yield from ((f"info {k}", info[k]) for k in ce.INFO_KEYS)


def bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` as integers, so that equality is bit for bit (-0 is not 0)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same(got, want, what, ulp_keys=()):
    """Every output bit for bit, those named in ``ulp_keys`` within 2 ulp."""
    for (name, a), (_, b) in zip(outputs(got), outputs(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {name}"
        a, b = a.cpu(), b.cpu()
        if name in ulp_keys:
            ulp = (bits(a).long() - bits(b).long()).abs()
            assert int(ulp.max()) <= 2, f"{what} {name}: {int(ulp.max())} ulp"
        else:
            assert torch.equal(bits(a), bits(b)), f"{what} {name}"


def generic(env):
    """A wrapper that takes the generic path: ``step`` set on the instance
    (to the class's own)."""
    env.step = CACCEnv.step.__get__(env)
    return env


# ---- (i) step_autoreset against the generic path, on the CPU ----

@pytest.mark.parametrize("rows", [(0, None, 5), (2, 7, 3)],
                         ids=["whole", "rows_2_of_7"])
@pytest.mark.parametrize("scenario,v_target", SCENARIOS)
def test_step_autoreset_equals_generic_path(scenario, v_target, rows):
    """1,500 steps past the horizon (200) with collisions forced: every
    leaf, obs, reward, done and info bit for bit, and the generators in the
    same state after every step."""
    offset, total, B = rows
    fused = AutoResetEnv(make_env(scenario, v_target), offset, total)
    plain = AutoResetEnv(generic(make_env(scenario, v_target)), offset, total)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    s1, o1 = fused.reset(B, g1)
    s2, o2 = plain.reset(B, g2)
    acts = schedule(1500, B, 8)
    collisions = horizons = 0
    for t in range(1500):
        out1 = fused.step(s1, acts[t], g1)
        out2 = plain.step(s2, acts[t], g2)
        assert_same(out1, out2, f"step {t}")
        assert torch.equal(g1.get_state(), g2.get_state()), f"step {t}"
        s1, s2 = out1[0], out2[0]
        collisions += int(out1[4]["collision"].sum())
        horizons += int((out1[3] & ~out1[4]["collision"]).sum())
    assert collisions > 0 and horizons > 0, (collisions, horizons)


@pytest.mark.parametrize("amps", [(0.0, 0.0), (0.0, 1.0), (1.0, 0.0)])
def test_zero_noise_amplitude_draws_nothing(amps):
    """No uniform is drawn for an amplitude of 0, as ``reset`` draws none:
    the generator moves as on the generic path, not at all when both are
    0, and the outputs are the same bit for bit."""
    kw = dict(init_noise_h=amps[0], init_noise_v=amps[1], episode_length=5)
    fused = AutoResetEnv(make_env(**kw))
    plain = AutoResetEnv(generic(make_env(**kw)))
    g1, g2 = (torch.Generator().manual_seed(2) for _ in range(2))
    s1, _ = fused.reset(4, g1)
    s2, _ = plain.reset(4, g2)
    acts = schedule(12, 4, 8)
    for t in range(12):
        before = g1.get_state()
        out1, out2 = fused.step(s1, acts[t], g1), plain.step(s2, acts[t], g2)
        assert_same(out1, out2, f"step {t}")
        assert torch.equal(g1.get_state(), g2.get_state())
        assert torch.equal(g1.get_state(), before) == (amps == (0.0, 0.0))
        s1, s2 = out1[0], out2[0]


def test_replaced_step_takes_the_generic_path(monkeypatch):
    """An instance whose ``step`` was replaced (a caller that watches the
    actions) takes the generic path, which calls the replacement every
    step and never the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the replaced step reached cacc_env_step")
    monkeypatch.setattr(cacc_mod, "cacc_env_step", refuse)
    env = make_env(episode_length=4)
    seen, step = [], env.step
    env.step = lambda s, a: (seen.append(a), step(s, a))[1]
    w = AutoResetEnv(env)
    gen = torch.Generator().manual_seed(0)
    s, _ = w.reset(3, gen)
    acts = schedule(9, 3, 8)
    for t in range(9):
        s = w.step(s, acts[t], gen)[0]
    assert len(seen) == 9 and all(torch.equal(a, b)
                                  for a, b in zip(seen, acts))


# ---- (ii) the numbers the kernel is handed ----

@pytest.mark.parametrize("scenario,v_target", SCENARIOS)
def test_kernel_args_fold_as_the_ops_round(scenario, v_target):
    """``c_args`` hands the kernel each number as the ops reach f32: a
    divisor as its f32 reciprocal (PyTorch's CUDA ``tensor / x``), a
    Python product or difference folded in double and rounded once, the
    scenario's reset and ramp, the velocity target and the gain table."""
    env = make_env(scenario, v_target, slowdown_t=7.0, h_go=36.0)
    c = env.cfg
    scal, ints = env.kernel_args
    k = len(ce._SCALARS)
    got = dict(zip(ce._SCALARS, np.array(scal[:k], F)))
    assert got["inv_span"] == F(1) / F(36.0 - c.h_st)
    assert got["inv_ramp_t"] == F(1) / F(7.0)
    for name, x in (("inv_v_star", c.v_star), ("inv_h_star", c.h_star),
                    ("inv_u_max", c.u_max), ("inv_5", 5.0),
                    ("inv_n", c.n_vehicle)):
        assert got[name] == F(1) / F(x), name
    assert got["half_v_max"] == F(0.5 * c.v_max)
    assert got["pi"] == F(np.pi)
    assert got["neg_penalty"] == F(-c.collision_penalty)
    assert got["ramp_dv"] == F(c.v_star - c.slowdown_v0)
    ramp = scenario == "slowdown"
    assert got["h0_first"] == F(c.h_star if ramp
                                else c.catchup_ratio * c.h_star)
    assert got["v0_start"] == F(c.slowdown_v0 if ramp else c.v_star)
    assert np.array_equal(np.array(scal[k:], F).reshape(4, 2), OVM_GAINS)
    assert list(ints) == [c.n_vehicle, c.episode_length, int(ramp),
                          int(v_target == "profile")]


# ---- (iii) dispatch and refusals ----

def test_cpu_tensors_run_the_twin_without_a_build(monkeypatch):
    """On the CPU ``step_autoreset`` runs the plain twin from the uniforms
    it draws: no build, no load, no count; every output equals the twin's
    and the input state is unchanged. The kernel's wrapper refuses CPU
    tensors."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path touched the kernel build")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    env = make_env()
    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset(4, gen)
    copy = [x.clone() for x in st]
    before = dict(ce.LAUNCHES)
    a = schedule(1, 4, 8)[0]
    draws = torch.Generator().set_state(gen.get_state())
    u_h, u_v = (torch.rand((4, 8), generator=draws) for _ in range(2))
    got = env.step_autoreset(st, a, gen)
    assert_same(got, env.step_autoreset_ref(st, a, u_h, u_v), "twin")
    assert isinstance(got[0], cacc_mod.CACCState)
    assert all(torch.equal(x, y) for x, y in zip(st, copy))
    with pytest.raises(ValueError, match="unsupported device cpu"):
        ce.cacc_env_step(env.kernel_args, st, a, u_h, u_v)
    assert ce.LAUNCHES == before and ce._lib is None


def _inputs(n=8, B=4, **kw):
    env = make_env(n_vehicle=n, **kw)
    st, _ = env.reset(B, torch.Generator().manual_seed(0))
    a = torch.zeros((B, n), dtype=torch.int64)
    u = torch.rand((B, n), generator=torch.Generator().manual_seed(1))
    return env, st, a, u


REFUSALS = {
    "h_f64": (TypeError, lambda st, a, u: (st._replace(h=st.h.double()), a,
                                           u, u)),
    "action_i32": (TypeError, lambda st, a, u: (st, a.int(), u, u)),
    "done_f32": (TypeError, lambda st, a, u: (
        st._replace(done=st.done.float()), a, u, u)),
    "v_shape": (ValueError, lambda st, a, u: (st._replace(v=st.v[:, :7]), a,
                                              u, u)),
    "u_v_shape": (ValueError, lambda st, a, u: (st, a, u, u[:3])),
    "t_device": (ValueError, lambda st, a, u: (
        st._replace(t=torch.empty(4, dtype=torch.int64, device="meta")), a,
        u, u)),
    "h_not_contiguous": (ValueError, lambda st, a, u: (
        st._replace(h=st.h.t().contiguous().t()), a, u, u)),
    "u_h_missing": (ValueError, lambda st, a, u: (st, a, None, u)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The wrapper's checks (run before every launch) raise on a wrong
    dtype, shape or device, a non-contiguous input and a missing draw."""
    err, bad = REFUSALS[case]
    env, st, a, u = _inputs()
    ce.check_inputs(env.kernel_args, st, a, u, u, torch.device("cpu"))
    with pytest.raises(err):
        ce.check_inputs(env.kernel_args, *bad(st, a, u), torch.device("cpu"))


def test_wrapper_refuses_more_than_a_warp_and_other_devices():
    """More than 32 vehicles (a platoon lies in one warp) and a device
    that is neither the CPU nor a card are refused."""
    env, st, a, u = _inputs(n=33, B=2)
    with pytest.raises(ValueError, match="at most 32"):
        ce.check_inputs(env.kernel_args, st, a, u, u, torch.device("cpu"))
    env, st, a, u = _inputs()
    meta = [x.to("meta") for x in (a, u)]
    with pytest.raises(ValueError, match="unsupported device"):
        env.step_autoreset(st._replace(**{k: getattr(st, k).to("meta")
                                          for k in st._fields}), meta[0])


# ---- (iv) on the card ----

@needs_cuda
@pytest.mark.parametrize("B", [1, 37, 64, 512])
@pytest.mark.parametrize("scenario,v_target", SCENARIOS)
def test_cuda_kernel_equals_twin(scenario, v_target, B):
    """Lockstep over 1,500 steps (the horizon 200, collisions forced): the
    kernel against the twin on the card from the kernel's state, the same
    actions and uniforms; every state leaf, obs, reward, done and collision
    bit for bit, the two info means (logged, in no loss) within 2 ulp of
    ``torch.mean``."""
    env = make_env(scenario, v_target, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(B)
    st, _ = env.reset(B, gen)
    acts = schedule(1500, B, 8, device="cuda", seed=B)
    n_done = 0
    for t in range(1500):
        u_h, u_v = (torch.rand((B, 8), device="cuda", generator=gen)
                    for _ in range(2))
        got = ce.cacc_env_step(env.kernel_args, st, acts[t], u_h, u_v)
        want = env.step_autoreset_ref(st, acts[t], u_h, u_v)
        assert_same(got, want, f"step {t}",
                    ulp_keys=("info headway_err", "info velocity_err"))
        n_done += int(got[3].sum())
        st = got[0]
    assert n_done >= B


@needs_cuda
def test_cuda_kernel_actions_outside_the_table():
    """Actions -4 to -1 give what the twin gives (the gain table counted
    from its end). Any other action outside [0, 4), where the twin raises,
    gives that vehicle NaN gains: its control, velocity, headway and reward
    and its follower's headway come out NaN; the other platoons are the
    twin's bit for bit."""
    env = make_env(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    st, _ = env.reset(4, gen)
    u_h, u_v = (torch.rand((4, 8), device="cuda", generator=gen)
                for _ in range(2))
    a = torch.full((4, 8), 3, dtype=torch.int64, device="cuda")
    a[0] = torch.arange(-4, 4, device="cuda")
    want = env.step_autoreset_ref(st, a, u_h, u_v)
    assert_same(ce.cacc_env_step(env.kernel_args, st, a, u_h, u_v), want,
                "actions -4 to 3",
                ulp_keys=("info headway_err", "info velocity_err"))
    bad = a.clone()
    bad[1, 2], bad[2, 5] = 4, -5
    got = ce.cacc_env_step(env.kernel_args, st, bad, u_h, u_v)
    s2, reward, done = got[0], got[2], got[3]
    assert not done.any()
    for b, i in ((1, 2), (2, 5)):
        for name, x in (("u", s2.u[b, i]), ("v", s2.v[b, i]),
                        ("h", s2.h[b, i]), ("reward", reward[b, i]),
                        ("follower's h", s2.h[b, i + 1])):
            assert torch.isnan(x), (b, i, name)
    for (name, x), (_, y) in zip(outputs(got), outputs(want)):
        assert torch.equal(bits(x[[0, 3]]), bits(y[[0, 3]])), name


@needs_cuda
def test_cuda_fused_path_draws_as_the_generic_path_and_counts():
    """On the card, ``AutoResetEnv`` takes the kernel (one launch a step)
    and its generator ends where the generic path's does, with the same
    outputs bit for bit (info means within 2 ulp); the input state is left
    as it was."""
    envs = [make_env("slowdown", device="cuda"),
            generic(make_env("slowdown", device="cuda"))]
    wraps = [AutoResetEnv(e, 8, 24) for e in envs]
    gens = [torch.Generator(device="cuda").manual_seed(3) for _ in envs]
    states = [w.reset(8, g)[0] for w, g in zip(wraps, gens)]
    acts = schedule(300, 8, 8, device="cuda")
    before = ce.LAUNCHES["cacc_env_step"]
    for t in range(300):
        copy = [x.clone() for x in states[0]]
        outs = [w.step(s, acts[t], g) for w, s, g in zip(wraps, states,
                                                         gens)]
        assert_same(*outs, f"step {t}",
                    ulp_keys=("info headway_err", "info velocity_err"))
        assert all(torch.equal(x, y) for x, y in zip(states[0], copy))
        states = [o[0] for o in outs]
    assert ce.LAUNCHES["cacc_env_step"] == before + 300
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


# one cell's set-up, a short window and the traced stretch, as the benchmark
# runs them; prints what _kernels_an_update returns, as JSON
_COUNT = """
import json, sys
from benchmark.spec import load_cell
from benchmark.traffic import train
from deeprl_network_tpu_torch.ops import cacc_env
run = train.Run(load_cell(sys.argv[1]), 2301000001, "cuda")
issued = cacc_env.LAUNCHES["cacc_env_step"]
run.window(1.0)
evs = [e for e in run.trace_stretch() if e.device]
n = train.TRACE_UPDATES
print(json.dumps({"graphed": run.fns.graphed is not None,
                  "kernels": len(evs) / n,
                  "env_kernels": sum("cacc_env_kernel" in e.name
                                     for e in evs) / n,
                  "issued": issued}))
"""


def _kernels_an_update(name):
    """{graphed, kernels (kernels, copies and sets on the card an update),
    env_kernels (``cacc_env_kernel`` an update), issued (the wrapper's
    launches through the set-up's checked updates: the graph's warm-up and
    capture)} of a benchmark cell, run as the benchmark runs it: in a new
    process, whose first trace this is (a process's later traces count a
    few copies fewer), after the set-up and a short window."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _COUNT, name], cwd=root,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@needs_cuda
def test_cuda_captured_platoon_update_runs_one_env_kernel_a_step():
    """The platoon cell's update (B = 64, T = 120, one CUDA graph) runs
    ``cacc_env_kernel`` once a step; the wrapper counted the graph's warm-up
    and its capture; the update runs under 14,000 kernels (24,801 with the
    env as PyTorch ops)."""
    got = _kernels_an_update("cacc_catchup_ma2c_nc.train_b64")
    T = 120
    assert got["graphed"] and got["issued"] == 2 * T, got
    assert got["env_kernels"] == T, got
    assert got["kernels"] < 14000, got


@needs_cuda
def test_cuda_flagship_update_kernel_count_unchanged():
    """The flagship's update steps the ATSC env through its own kernel and
    never the platoon's: its wrapper issues nothing and the card runs no
    ``cacc_env_kernel`` (the benchmark's ``kernels_per_update`` keeps the
    update's whole count)."""
    got = _kernels_an_update("grid25_ma2c_nc.train_b768")
    assert got["env_kernels"] == 0 and got["issued"] == 0, got
