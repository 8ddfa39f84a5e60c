"""The ATSC env-step kernel (``ops/network_env.py``, ``csrc/network_env.cu``)
without a card, and on one.

On the CPU: the tables' assumptions and the launch shapes on every topology
the kernel takes; a numpy emulation of the kernel's own algorithm over
``NetworkEnvTables`` (the padded route pairs, the transit ring, the
fixed-order sums, the auto-reset select, then the observation of the
selected state) held step for step against the JAX engine, at the bars of
``tests/test_torch_grid_env.py``; the wrapper's dispatch and its refusals. Card-only cases (``needs_cuda``) hold the kernel
against its plain twin; JAX is imported only in fixtures, so they run on a
machine without it (``python -m pytest --noconftest -q
tests/test_torch_network_env.py -k cuda``)."""

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.config import EnvConfig
from deeprl_network_tpu_torch.envs import grid, monaco
from deeprl_network_tpu_torch.envs.network import (
    NetworkState, TrafficNetworkEnv,
)
from deeprl_network_tpu_torch.envs.wrappers import AutoResetEnv
from deeprl_network_tpu_torch.ops import _build
from deeprl_network_tpu_torch.ops import network_env as ne

# decided when each test is set up, not at import
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

TOPOLOGIES = ("grid3", "grid5", "grid10", "monaco")
F = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small, and several test processes share the
    machine: more threads than one only fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topology(name, cfg):
    if name == "monaco":
        return monaco.build_monaco_topology(cfg)
    return grid.build_grid_topology(cfg, int(name[4:]))


def _env_kw(name, **kw):
    scenario = "real_net" if name == "monaco" else "large_grid"
    return dict(scenario=scenario, coop_gamma=0.9, **kw)


def make_env(name, device="cpu", **kw):
    cfg = EnvConfig(**_env_kw(name, **kw))
    return TrafficNetworkEnv(cfg, _topology(name, cfg), device=device)


# ---- (i) the tables ----

def _shared_bytes(L, M, D, substeps, threads):
    """Shared memory of one block as the kernel lays it out (its Layout):
    the mbarrier (16 bytes), the transit ring [D, L] twice, queue, wait,
    three lane-feature rows, each (substep, warp)'s five partial sums, each
    substep's five sums, two node rows and the clamped actions."""
    return (16 + 4 * L * (2 * D + 5) + 20 * substeps * (threads // 32 + 1)
            + 12 * M)


# (lanes a thread, threads a block, shared bytes a block) of each topology
# at five substeps: up to 160 threads a block and 37 KB, six blocks share an
# SM (228 KB of shared memory, 64 registers a thread)
SHAPES = {"grid3": (1, 128, 11_424), "grid5": (2, 160, 30_916),
          "grid10": (2, 608, 123_216), "monaco": (1, 160, 25_224)}


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_tables_hold_the_kernel_assumptions(name):
    """Each lane in exactly one node's list, gated by that node only; route
    rows and columns of at most 3 nonzeros, in ascending order, padded with
    (0, 0.0), equal to the dense route; the per-lane gate rows equal the
    dense product; rows of 16-byte multiples for the bulk copies; the launch
    shape and its shared memory, the ring taking any D."""
    env = make_env(name, queue_in_obs=True, phase_in_obs=True)
    T, topo = env.tables, env.topo
    L, M = topo.n_lane, topo.n_node
    counts = np.zeros(L, int)
    for ls in topo.node_lanes:
        counts[ls] += 1
    assert (counts == 1).all()
    lane_node = T.lane_node.numpy()
    for m in range(M):
        assert not topo.phase_gate[m][:, lane_node != m].any()
    for idx, val, mat in ((T.pair_row, T.pair_row_val, topo.route),
                          (T.pair_col, T.pair_col_val, topo.route.T)):
        idx, val = idx.numpy(), val.numpy()
        assert idx.shape == val.shape == (ne.PAIRS, L) == (3, L)
        assert ((mat != 0).sum(1) <= 3).all()
        dense = np.zeros_like(mat, dtype=np.float32)
        for r in range(L):
            n = int((val[:, r] != 0).sum())
            assert (val[:n, r] != 0).all() and (val[n:, r] == 0).all()
            assert (np.diff(idx[:n, r]) > 0).all() and (idx[n:, r] == 0).all()
            dense[r, idx[:n, r]] = val[:n, r]
        assert np.array_equal(dense, mat.astype(np.float32))
    assert (4 * L) % 16 == 0
    lanes, threads, smem = SHAPES[name]
    assert ne.launch_shape(L) == (T.lanes, T.threads) == (lanes, threads)
    assert lanes * threads >= L > lanes * (threads - 32) and threads <= 1024
    assert _shared_bytes(L, M, T.D, env.scalars.control_interval_sec,
                         threads) == smem
    assert threads > 160 or 6 * (smem + 1024) <= 228 * 1024
    assert smem <= 227 * 1024
    P = topo.phase_gate.shape[1]
    onehots = torch.eye(P)[None].expand(M, P, P)       # every phase p
    for p in range(P):
        dense = onehots[:, p].reshape(1, -1) @ T.gate
        assert torch.equal(dense[0], T.lane_gate[:, p])
    assert T.lane_slot.min() >= 0 and T.lane_slot.max() < T.D
    node_lane = T.node_lane.numpy()
    ptr = T.node_ptr.numpy()
    for m, ls in enumerate(topo.node_lanes):
        assert list(node_lane[ptr[m]:ptr[m + 1]]) == sorted(ls)
    assert torch.equal(T.route_out, T.route.sum(1))


@pytest.mark.parametrize("L", [1, 32, 108, 148, 160, 161, 300, 320, 321,
                               1200, 2048, 2049, 8192])
def test_launch_shape_covers_every_lane(L):
    """Every lane has a thread, no warp is idle, and the block fits an
    instance of the kernel: one lane a thread up to 160 lanes (160 threads
    at most), two up to 2,048 (160 threads at most up to 320 lanes), then
    up to 8 lanes a thread in 1,024 threads."""
    lanes, threads = ne.launch_shape(L)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert lanes * threads >= L > lanes * (threads - 32)
    assert (lanes == 1) == (L <= 160) and (lanes <= 2) == (L <= 2048)
    assert lanes > 1 or threads <= 160
    assert L > 320 or threads <= 160
    assert lanes <= 8


@pytest.mark.parametrize("fault", ["two lists", "foreign gate",
                                   "four route nonzeros"])
def test_tables_refuse_a_topology_that_breaks_them(fault):
    cfg = EnvConfig(**_env_kw("grid3"))
    topo = grid.build_grid_topology(cfg, 3)
    if fault == "two lists":
        topo.node_lanes = [list(ls) for ls in topo.node_lanes]
        topo.node_lanes[1].append(topo.node_lanes[0][0])
    elif fault == "four route nonzeros":
        topo.route = np.array(topo.route, copy=True)
        topo.route[0, :4] = 0.25
    else:
        lane = topo.node_lanes[0][0]
        topo.phase_gate = topo.phase_gate.copy()
        topo.phase_gate[1, 0, lane] = 1.0
    with pytest.raises(ValueError):
        TrafficNetworkEnv(cfg, topo, device="cpu")


# ---- (ii) the kernel's algorithm in numpy ----

def _padded(ptr, idx, val=None):
    """[n, K] indices and values of a CSR table, rows padded with index 0
    and value 0 (a padded term adds an exact 0)."""
    n = len(ptr) - 1
    K = max(int(np.diff(ptr).max()), 1)
    I = np.zeros((n, K), np.int64)
    V = np.zeros((n, K), F)
    for r in range(n):
        k = ptr[r + 1] - ptr[r]
        I[r, :k] = idx[ptr[r]:ptr[r + 1]]
        V[r, :k] = 1.0 if val is None else val[ptr[r]:ptr[r + 1]]
    return I, V


def _block_sum(v, threads, per):
    """[B] sums of v [B, L] in the kernel's order: each thread's lanes in
    order, a shuffle-down tree in each warp, the warps in order."""
    B, L = v.shape
    pad = np.zeros((B, threads * per), F)
    pad[:, :L] = v
    th = np.zeros((B, threads), F)
    for i in range(per):
        th = th + pad[:, i * threads:(i + 1) * threads]
    x = th.reshape(B, threads // 32, 32).copy()
    for off in (16, 8, 4, 2, 1):
        x[..., :off] = x[..., :off] + x[..., off:2 * off]
    s = np.zeros(B, F)
    for wp in range(threads // 32):
        s = s + x[:, wp, 0]
    return s


def emulate_step(T, c, s, action, q0=None, auto_reset=False):
    """The kernel's algorithm on numpy f32 arrays: ``s`` a dict of the
    state's fields [B, ...], ``action`` [B, M]. Returns (state dict, obs,
    reward, done, info dict)."""
    A = {k: v.numpy() for k, v in vars(T).items()
         if isinstance(v, torch.Tensor)}
    L, M, D = T.L, T.M, T.D
    B = action.shape[0]
    cap, sat = F(c.lane_capacity), F(c.sat_flow)
    per, threads = ne.launch_shape(L)
    rows = A["pair_row"].T, A["pair_row_val"].T
    cols = A["pair_col"].T, A["pair_col_val"].T
    nodes = _padded(A["node_ptr"], A["node_lane"])
    ro, lanes = A["route_out"], np.arange(L)
    act = np.minimum(np.maximum(action, 0), A["n_valid32"] - 1)
    ln = A["lane_node"]
    gate = A["lane_gate"][lanes, act[:, ln]]
    sw = (act[:, ln] != s["prev_phase"][:, ln]).astype(F)
    demand = A["demand"]
    inflow = demand[np.clip(s["t"], 0, len(demand) - 1)] * A["entry"]
    ring, q, w = s["transit"].copy(), s["queue"].copy(), s["wait"].copy()

    def transit_sum(head):
        acc = np.zeros((B, L), F)
        for d in range(D):
            acc = acc + ring[:, (head + d) % D]
        return acc

    def gather_sum(table, x):
        I, V = table
        acc = np.zeros((B, I.shape[0]), F)
        for j in range(I.shape[1]):
            acc = acc + V[:, j] * x[:, I[:, j]]
        return acc

    head, sums = 0, []
    for k in range(c.control_interval_sec):
        yellow = F(1.0 if k < c.yellow_interval_sec else 0.0)
        old, head = head, (head + 1) % D
        arriving = ring[:, old].copy()
        ring[:, old] = 0.0
        q = q + arriving
        ovf = np.maximum(q - cap, F(0))
        q = q - ovf
        fr = np.maximum(cap - (q + transit_sum(head)), F(0))
        sp = gather_sum(rows, fr)
        sp = np.where(ro > F(1e-6), sp / np.maximum(ro, F(1e-6)), cap)
        g = gate * (F(1) - yellow * sw)
        dq = np.minimum(np.minimum(q, g * sat), sp)
        slot = (head + A["lane_slot"]) % D
        ring[:, slot, lanes] += gather_sum(cols, dq)
        q2 = q - dq
        free = np.maximum(cap - (q2 + transit_sum(head)), F(0))
        acc = np.minimum(inflow, free)
        ring[:, slot, lanes] += acc
        sums.append([_block_sum(v, threads, per) for v in (
            inflow - acc, ovf, dq, dq * np.maximum(F(1) - ro, F(0)), acc)])
        served = (dq > F(1e-4)).astype(F)
        w = (w + F(1)) * (q2 > F(0.1)).astype(F) * (F(1) - served)
        q = q2

    dropped = s["dropped"].copy()
    flows, arrived, entered = (np.zeros(B, F) for _ in range(3))
    for s_in, s_ovf, s_dq, s_arr, s_acc in sums:
        dropped = (dropped + s_in) + s_ovf
        flows, arrived, entered = flows + s_dq, arrived + s_arr, \
            entered + s_acc
    nq, nw = gather_sum(nodes, q), gather_sum(nodes, w)
    reward = {"queue": -nq, "wait": -nw}.get(
        c.objective, -(nq + F(c.coef_wait) * nw))
    avg = lambda x: sum((x[:, m] for m in range(1, M)), x[:, 0]) / F(M)
    info = {"avg_queue": avg(nq), "avg_wait": avg(nw), "throughput": flows,
            "arrived": arrived, "entered": entered, "dropped": dropped}
    t_new = s["t"] + 1
    done = t_new >= c.episode_steps
    reset = done & auto_reset
    canon = ring[:, (head + np.arange(D)) % D]
    ts = np.zeros((B, L), F)
    for d in range(D):
        ts = ts + canon[:, d]
    r1 = reset[:, None]
    q_new = np.where(r1, np.zeros((B, L), F) if q0 is None else q0, q)
    w_new = np.where(r1, F(0), w)
    ts = np.where(r1, F(0), ts)
    state = dict(queue=q_new,
                 transit=np.where(reset[:, None, None], F(0), canon),
                 wait=w_new, prev_phase=np.where(r1, 0, act),
                 t=np.where(reset, 0, t_new), done=done & ~reset,
                 dropped=np.where(reset, F(0), dropped))
    feats = [np.clip((q_new + ts) / F(c.norm_wave), F(0), F(c.clip_wave))]
    if T.use_queue:
        feats.append(np.clip(q_new / F(c.norm_wave), F(0), F(c.clip_wave)))
    if T.use_wait:
        feats.append(np.clip(w_new / F(c.norm_wait), F(0), F(c.clip_wait)))
    obs = np.concatenate(feats, -1)[:, A["gather32"]] * A["gmask"]
    if T.use_phase:
        ph = state["prev_phase"]
        on = ph < A["n_valid32"]
        b_idx, m_idx = np.nonzero(on)
        obs[b_idx, m_idx, A["phase_col"][m_idx] + ph[b_idx, m_idx]] += F(1)
    return state, obs, reward.astype(F), done, info


def _np_state(st):
    return {k: v.numpy().copy() for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def J():
    """The JAX engine: (env config class, topology builders, engine,
    auto-reset wrapper)."""
    pytest.importorskip("jax")
    from deeprl_network_tpu.config import EnvConfig as JEnvConfig
    from deeprl_network_tpu.envs import grid as jgrid
    from deeprl_network_tpu.envs import monaco as jmonaco
    from deeprl_network_tpu.envs.network import TrafficNetworkEnv as JNetEnv
    from deeprl_network_tpu.envs.wrappers import AutoResetEnv as JAutoReset

    def build(name, **kw):
        cfg = JEnvConfig(**_env_kw(name, **kw))
        topo = (jmonaco.build_monaco_topology(cfg) if name == "monaco"
                else jgrid.build_grid_topology(cfg, int(name[4:])))
        return JAutoReset(JNetEnv(cfg, topo))
    return build


def _close(a, b, what, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=what,
                               **(tol or dict(atol=1e-5)))


# (topology, env options, steps, B, action range, resets expected)
JAX_CASES = {
    "grid25_across_reset": ("grid5", dict(episode_length_sec=100), 30, 3,
                            5, 3),
    "grid100": ("grid10", {}, 5, 2, 5, 0),
    "obs_channels_hybrid": ("grid5", dict(
        queue_in_obs=True, phase_in_obs=True, objective="hybrid",
        episode_length_sec=40), 10, 3, 5, 3),
    "monaco_across_reset": ("monaco", dict(episode_length_sec=100,
                                           objective="hybrid"), 30, 3, 6, 3),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_kernel_algorithm_matches_jax_step_for_step(J, case):
    """The emulation from the port's reset state against
    ``jax.vmap(JAutoReset(JNetEnv(...)).step)`` on the same recorded
    actions (invalid phases included on Monaco): state, obs and reward at
    atol 1e-5, done exactly, info at atol 1e-5 and rtol 1e-6."""
    import jax
    name, kw, steps, B, n_act, n_resets = JAX_CASES[case]
    env = make_env(name, **kw)
    jenv = J(name, **kw)
    acts = np.random.default_rng(1).integers(
        0, n_act, (steps, B, env.topo.n_node))
    jstate, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), B))
    st, _ = env.reset(B)
    s = _np_state(st)
    jstep = jax.jit(jax.vmap(jenv.step))
    n_done = 0
    for t in range(steps):
        jstate, jobs, jr, jd, jinfo = jstep(jstate, acts[t].astype(np.int32))
        s, obs, r, d, info = emulate_step(env.tables, env.scalars, s, acts[t],
                                          auto_reset=True)
        what = f"{case} step {t}"
        for k, v in s.items():
            _close(v, getattr(jstate.env, k), f"{what} {k}")
        _close(obs, jobs, f"{what} obs")
        _close(r, jr, f"{what} reward")
        assert np.array_equal(d, np.asarray(jd)), what
        assert info.keys() == jinfo.keys()
        for k in info:
            _close(info[k], jinfo[k], f"{what} info {k}", atol=1e-5,
                   rtol=1e-6)
        n_done += int(d.sum())
    assert n_done == n_resets


def _twin_run(env, B, steps, seed, generator=None, offset=0, total=None):
    """(actions, [(reset_q0, state before, twin outputs)] a step) of
    ``steps`` twin steps under auto-reset with the reset's draws from
    ``generator``, as ``step_autoreset`` takes them."""
    acts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 5, (steps, B, env.topo.n_node)))
    st, _ = env.reset(B, generator, offset, total)
    out = []
    for t in range(steps):
        q0 = env._reset_queue(B, generator, offset, total)
        res = ne.network_env_step_ref(env.tables, env.scalars, st, acts[t],
                                      q0, auto_reset=True)
        out.append((q0, st, res))
        st = res[0]
    return acts, out


# Held against the twin, the reset noise fills a node's 12 lanes to sums
# above 128, where one f32 ulp is 1.5e-5: the sums over lanes (reward,
# dropped, info) take rtol 1e-6 beside atol 1e-5, as info does everywhere.
SUMS = dict(atol=1e-5, rtol=1e-6)


def _assert_emulation_matches(env, acts, run, what):
    for t, (q0, st, (s2, obs, r, d, info)) in enumerate(run):
        es, eobs, er, ed, einfo = emulate_step(
            env.tables, env.scalars, _np_state(st), acts[t].numpy(),
            None if q0 is None else q0.numpy(), auto_reset=True)
        for k, v in es.items():
            _close(v, getattr(s2, k).numpy(), f"{what} step {t} {k}",
                   **(SUMS if k == "dropped" else {}))
        _close(eobs, obs.numpy(), f"{what} step {t} obs")
        _close(er, r.numpy(), f"{what} step {t} reward", **SUMS)
        assert np.array_equal(ed, d.numpy())
        for k in einfo:
            _close(einfo[k], info[k].numpy(), f"{what} step {t} {k}",
                   **SUMS)


def test_kernel_algorithm_matches_twin_with_reset_noise():
    """init_density > 0: every reset draws queues; the emulation takes the
    twin's draws (``reset_q0``) across two resets. The twin is held against
    JAX by ``tests/test_torch_grid_env.py``."""
    env = make_env("grid5", init_density=0.5, episode_length_sec=50)
    acts, run = _twin_run(env, 3, 22, seed=2,
                          generator=torch.Generator().manual_seed(0))
    assert sum(int(res[3].sum()) for _, _, res in run) == 6
    assert float(run[10][0].max()) > 0
    _assert_emulation_matches(env, acts, run, "init_density")


def test_kernel_algorithm_on_a_ranks_rows():
    """A data-parallel rank's rows (``offset``/``total``): the emulation on
    rows 2..3 of 4, with the rank's draws at the global shape, equals rows
    2..3 of the whole batch's twin run."""
    env = make_env("grid5", init_density=0.5, episode_length_sec=50)
    acts, whole = _twin_run(env, 4, 12,
                            seed=3, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    st, _ = env.reset(2, gen, 2, 4)
    s = _np_state(st)
    for t in range(12):
        q0 = env._reset_queue(2, gen, 2, 4).numpy()
        assert np.array_equal(q0, whole[t][0][2:].numpy())
        s, obs, r, d, info = emulate_step(env.tables, env.scalars, s,
                                          acts[t, 2:].numpy(), q0, True)
        s2, wobs, wr, wd, winfo = whole[t][2]
        for k, v in s.items():
            _close(v, getattr(s2, k)[2:].numpy(), f"rank step {t} {k}",
                   **(SUMS if k == "dropped" else {}))
        _close(obs, wobs[2:].numpy(), f"rank step {t} obs")
        _close(r, wr[2:].numpy(), f"rank step {t} reward", **SUMS)
        assert np.array_equal(d, wd[2:].numpy())
    assert sum(int(w[2][3].sum()) for w in whole) == 4


# ---- (iii) dispatch ----

def test_cpu_tensors_run_the_twin_without_a_build(monkeypatch):
    """CPU tensors take the plain twin: no build, no load, no count; every
    output is new and the input state is unchanged."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path touched the kernel build")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    env = make_env("grid5", init_density=0.5)
    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset(2, gen)
    before = dict(ne.LAUNCHES)
    copy = [x.clone() for x in st]
    a = torch.as_tensor(np.random.default_rng(0).integers(0, 5, (2, 25)))
    q0 = env._reset_queue(2, gen)
    for auto in (False, True):
        got = ne.network_env_step(env.tables, env.scalars, st, a, q0, auto)
        want = ne.network_env_step_ref(env.tables, env.scalars, st, a, q0,
                                       auto)
        assert isinstance(got[0], NetworkState)
        for x, y in zip(got[0], want[0]):
            assert torch.equal(x, y)
        for x, y in zip(got[1:4], want[1:4]):
            assert torch.equal(x, y)
        assert all(torch.equal(got[4][k], want[4][k]) for k in want[4])
    assert all(torch.equal(x, y) for x, y in zip(st, copy))
    assert ne.LAUNCHES == before and ne._lib is None


def test_autoreset_wrapper_takes_the_fused_step():
    """``AutoResetEnv.step`` on the ATSC env goes through
    ``step_autoreset``, equal bit for bit to the generic path (step, reset,
    per-row select) with the same generator draws; an env whose ``step`` was
    replaced on the instance takes the generic path."""
    env = make_env("grid3", init_density=0.5, episode_length_sec=30)
    fused, generic = AutoResetEnv(env, 1, 3), AutoResetEnv(env, 1, 3)
    seen = []
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    s1, _ = fused.reset(2, g1)
    s2, _ = generic.reset(2, g2)
    acts = torch.as_tensor(np.random.default_rng(4).integers(0, 5,
                                                             (9, 2, 9)))
    step = env.step
    for t in range(9):
        out1 = fused.step(s1, acts[t], g1)
        env.step = lambda s, a: (seen.append(a), step(s, a))[1]
        out2 = generic.step(s2, acts[t], g2)
        del env.step
        s1, s2 = out1[0], out2[0]
        for x, y in zip(list(out1[0]) + list(out1[1:4]),
                        list(out2[0]) + list(out2[1:4])):
            assert torch.equal(x, y), t
    assert len(seen) == 9
    assert torch.equal(g1.get_state(), g2.get_state())


def _refusal_in_full(tables, s, action, reset_q0):
    """The wrapper's input check in its plain form, field by field: device,
    dtype, shape, contiguity. Its faster check must make the same refusals
    with the same exceptions and messages."""
    B, L, M, D = action.shape[0], tables.L, tables.M, tables.D
    f32, i64 = torch.float32, torch.int64
    want = [("queue", s.queue, (B, L), f32),
            ("transit", s.transit, (B, D, L), f32),
            ("wait", s.wait, (B, L), f32),
            ("prev_phase", s.prev_phase, (B, M), i64),
            ("t", s.t, (B,), i64),
            ("done", s.done, (B,), torch.bool),
            ("dropped", s.dropped, (B,), f32),
            ("action", action, (B, M), i64)]
    if reset_q0 is not None:
        want.append(("reset_q0", reset_q0, (B, L), f32))
    for name, x, shape, dtype in want:
        if x.device != tables.ints.device:
            raise ValueError(f"network_env_step: {name} on {x.device}, the "
                             f"tables on {tables.ints.device}")
        if x.dtype != dtype:
            raise TypeError(f"network_env_step: {name} is {x.dtype}, the "
                            f"kernel takes {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"network_env_step: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"network_env_step: {name} is not contiguous")


def _spoil(x, fault):
    """``x`` with one property the kernel does not take."""
    if fault == "dtype":
        return x.to({torch.float32: torch.float64, torch.int64: torch.int32,
                     torch.bool: torch.uint8}[x.dtype])
    if fault == "shape":
        return x[..., :-1].contiguous()
    if fault == "strides":    # the same shape, not contiguous
        if x.ndim == 1:
            return torch.stack([x, x], 1)[:, 0]
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)
    return x.to("meta")        # another device


FIELDS = ("queue", "transit", "wait", "prev_phase", "t", "done", "dropped",
          "action", "reset_q0")


@pytest.mark.parametrize("fault", ["dtype", "shape", "strides", "device"])
@pytest.mark.parametrize("field", FIELDS)
def test_input_check_refuses_what_it_refused(field, fault):
    """Each input the kernel does not take, field by field: the wrapper's
    check raises the plain check's exception with its message, and passes
    every input that one passes."""
    env = make_env("grid3", init_density=0.5)
    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset(3, gen)
    args = dict(st._asdict(), action=torch.as_tensor(
        np.random.default_rng(0).integers(0, 5, (3, 9))),
        reset_q0=env._reset_queue(3, gen))
    for q0 in (args["reset_q0"], None):
        ne._check_cuda(env.tables, st, args["action"], q0)
        _refusal_in_full(env.tables, st, args["action"], q0)
    args[field] = _spoil(args[field], fault)
    call = (env.tables, NetworkState(*(args[k] for k in FIELDS[:7])),
            args["action"], args["reset_q0"])
    with pytest.raises((TypeError, ValueError)) as want:
        _refusal_in_full(*call)
    with pytest.raises(want.type) as got:
        ne._check_cuda(*call)
    assert str(got.value) == str(want.value)
    assert fault != "device" or "on meta, the tables on cpu" in str(got.value)


# ---- (iv) on the card ----

# (topology, env options, B, steps, auto-reset, init_density rows)
CUDA_CASES = {
    "grid25_across_reset": ("grid5", dict(episode_length_sec=100), 64, 30,
                            True),
    "grid100": ("grid10", {}, 16, 10, True),
    "grid100_b128": ("grid10", {}, 128, 8, True),
    "obs_channels_hybrid": ("grid5", dict(
        queue_in_obs=True, phase_in_obs=True, objective="hybrid",
        episode_length_sec=40), 32, 12, True),
    "monaco_across_reset": ("monaco", dict(episode_length_sec=100,
                                           objective="hybrid"), 32, 30, True),
    "init_density": ("grid5", dict(init_density=0.5, episode_length_sec=50),
                     32, 22, True),
    "b1_unwrapped": ("grid5", {}, 1, 30, False),
}


def _cuda_close(got, want, what):
    for name, a, b in _pairs(got, want):
        a, b = a.float().cpu(), b.float().cpu()
        bad = (a - b).abs() > 1e-5 + 1e-5 * b.abs()
        assert not bad.any(), f"{what} {name}: off by " \
            f"{float((a - b).abs().max())}"


def _pairs(got, want):
    (s1, o1, r1, d1, i1), (s2, o2, r2, d2, i2) = got, want
    yield from zip(s1._fields, s1, s2)
    yield from (("obs", o1, o2), ("reward", r1, r2), ("done", d1, d2))
    yield from ((k, i1[k], i2[k]) for k in i2)


@needs_cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_kernel_matches_twin(case):
    """Lockstep: kernel and twin from the kernel's state at every step,
    same actions and reset draws, within 1e-5 (absolute and relative)."""
    name, kw, B, steps, auto = CUDA_CASES[case]
    env = make_env(name, device="cuda", **kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    st, _ = env.reset(B, gen)
    n_a = max(env.spec.n_a_ls) + 1
    for t in range(steps):
        a = torch.randint(0, n_a, (B, env.topo.n_node), device="cuda",
                          generator=gen)
        q0 = env._reset_queue(B, gen) if auto else None
        got = ne.network_env_step(env.tables, env.scalars, st, a, q0, auto)
        want = ne.network_env_step_ref(env.tables, env.scalars, st, a, q0,
                                       auto)
        _cuda_close(got, want, f"{case} step {t}")
        st = got[0]


@needs_cuda
def test_cuda_kernel_leaves_its_input_counts_and_refuses_bad_input():
    env = make_env("grid5", device="cuda", init_density=0.5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    st, _ = env.reset(8, gen)
    a = torch.randint(0, 5, (8, 25), device="cuda", generator=gen)
    copy = [x.clone() for x in st]
    before = ne.LAUNCHES["network_env_step"]
    for _ in range(3):
        out = ne.network_env_step(env.tables, env.scalars, st, a,
                                  env._reset_queue(8, gen), True)
    torch.cuda.synchronize()
    assert ne.LAUNCHES["network_env_step"] == before + 3
    assert all(torch.equal(x, y) for x, y in zip(st, copy))
    assert out[0].queue.data_ptr() != st.queue.data_ptr()
    with pytest.raises(TypeError):
        ne.network_env_step(env.tables, env.scalars,
                            st._replace(queue=st.queue.double()), a)
    with pytest.raises(TypeError):
        ne.network_env_step(env.tables, env.scalars, st, a.int())
    with pytest.raises(ValueError):
        ne.network_env_step(env.tables, env.scalars, st._replace(
            wait=st.wait.t().contiguous().t()), a)
    with pytest.raises(ValueError):
        ne.network_env_step(env.tables, env.scalars, st, a[:, :24])
    assert ne.LAUNCHES["network_env_step"] == before + 3


@needs_cuda
def test_cuda_generator_state_equals_the_twins_after_30_steps():
    """init_density > 0: the fused path (``step_autoreset``) and the
    generic path on the twin draw the same noise, so after 30 steps (two
    resets) the generators are in the same state, and so are the episode
    clocks and phases."""
    envs = [make_env("grid5", device="cuda", init_density=0.5,
                     episode_length_sec=50) for _ in range(2)]
    twin = envs[1]
    twin.step = lambda s, a: ne.network_env_step_ref(
        twin.tables, twin.scalars, s, a)
    wraps = [AutoResetEnv(e, 8, 24) for e in envs]
    gens = [torch.Generator(device="cuda").manual_seed(3) for _ in envs]
    states = [w.reset(8, g)[0] for w, g in zip(wraps, gens)]
    acts = torch.randint(0, 5, (30, 8, 25), device="cuda", generator=(
        torch.Generator(device="cuda").manual_seed(1)))
    for t in range(30):
        states = [w.step(s, acts[t], g)[0]
                  for w, s, g in zip(wraps, states, gens)]
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    for k in ("t", "done", "prev_phase"):
        assert torch.equal(getattr(states[0], k), getattr(states[1], k)), k


@needs_cuda
def test_cuda_kernel_is_deterministic():
    """Two calls on the same inputs are equal bit for bit (no atomics)."""
    env = make_env("grid5", device="cuda", init_density=0.5)
    gen = torch.Generator(device="cuda").manual_seed(2)
    st, _ = env.reset(96, gen)
    for t in range(12):
        a = torch.randint(0, 5, (96, 25), device="cuda", generator=gen)
        q0 = env._reset_queue(96, gen)
        one = ne.network_env_step(env.tables, env.scalars, st, a, q0, True)
        two = ne.network_env_step(env.tables, env.scalars, st, a, q0, True)
        for name, x, y in _pairs(one, two):
            assert torch.equal(x, y), f"step {t} {name}"
        st = one[0]


@needs_cuda
def test_cuda_kernel_refuses_rows_the_bulk_copies_cannot_take():
    """A state row that does not start on 16 bytes: the launch is refused
    and raises, nothing is counted."""
    env = make_env("grid5", device="cuda")
    st, _ = env.reset(4)
    a = torch.zeros((4, 25), dtype=torch.int64, device="cuda")
    shifted = torch.zeros(4 * 300 + 1, device="cuda")[1:].view(4, 300)
    before = ne.LAUNCHES["network_env_step"]
    with pytest.raises(RuntimeError, match="cudaError 1"):
        ne.network_env_step(env.tables, env.scalars,
                            st._replace(queue=shifted), a)
    assert ne.LAUNCHES["network_env_step"] == before


@needs_cuda
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_cuda_launch_shape_fits_the_card(name):
    """What the card makes of each topology's launch: the shape and shared
    memory of ``SHAPES``, no spilled registers, six blocks an SM up to 160
    threads a block."""
    env = make_env(name, device="cuda")
    lanes, threads, smem = SHAPES[name]
    got = ne.occupancy(env.tables, env.scalars)
    assert (got["lanes"], got["threads"], got["smem_bytes"]) == (
        lanes, threads, smem)
    assert got["local_bytes"] == 0, got
    assert threads > 160 or got["blocks_per_sm"] >= 6, got
