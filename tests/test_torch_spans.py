"""The spans inside the port's update (``utils/spans.py``): the marks that
the update body and the graph launch, the host spans of ``train_step``, and
the reading of the rings.

On the CPU a recording stand-in takes the place of the mark's launch (as
``GraphedStep`` takes a stand-in graph and capture): the marks of one
update, on the fused and the replay path, at T = 120 and at a small T, with
``remat`` on and off and with ``axis_name``, run in the layout's order and
nest in their parents (``comm`` in ``policy``, marked once a sampled step,
never in the ``remat`` recompute); the rings' arithmetic on synthetic
stamps (durations, self times, the sampled spans' scaling, the slot
wrapping past the ring);
the Trainer's read of durations alone, without the clock; the clock's
offset against a fake clock; ``record_function`` only while a
profiler runs; the Trainer's log row.

On a card (``needs_cuda``; ``python -m pytest --noconftest -q
tests/test_torch_spans.py -k cuda``): a profiled replay runs exactly the
layout's mark kernels, by name; the stamps are monotone; the graphed update
with its marks equals the eager one bit for bit; the platoon's env span is
above 0; a captured DIAL update takes the comm-embedding kernels under
DIAL's launch keys. This file imports nothing of JAX.
"""

import contextlib
import socket
import time
import types

import numpy as np
import pytest
import torch

from deeprl_network_tpu_torch.config import (
    EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.envs.cacc import CACCEnv
from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
from deeprl_network_tpu_torch.parallel import distributed
from deeprl_network_tpu_torch.utils import spans as spans_mod
from deeprl_network_tpu_torch.utils.graph import GraphedStep
from deeprl_network_tpu_torch.utils.rollout import (
    make_a2c, state_from_leaves, state_leaves,
)
from deeprl_network_tpu_torch.utils.spans import (
    HOST_SPANS, ROWS, Clock, Layout, Spans, clock_offset, host_span_at,
    mean_ms, read_rows, sampled_steps,
)
from deeprl_network_tpu_torch.utils.trainer import Trainer

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

CACC = dict(scenario="cacc_catchup", coop_gamma=0.9, episode_length=12)
GRID = dict(scenario="large_grid", coop_gamma=0.9, episode_length_sec=60)
TINY = dict(num_envs=1, num_fc=8, num_lstm=8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fns(T, device="cpu", env="cacc", jit=True, dp=False, agent="ma2c_nc",
         **model_kw):
    e = (CACCEnv(EnvConfig(**CACC), device=device) if env == "cacc"
         else LargeGridEnv(EnvConfig(**GRID), device=device))
    mcfg = ModelConfig(**dict(TINY, batch_size=T, **model_kw))
    return make_a2c(e, mcfg, TrainConfig(total_step=10 ** 6),
                    agent=agent, jit=jit, device=device,
                    axis_name="data" if dp else None)


def _record(spans):
    """Replace ``spans``' mark launch by a recording stand-in."""
    seen = []
    spans.launch = lambda kernel, col, advance: seen.append(
        (kernel, col, advance))
    return seen


def _names(layout):
    return [layout.kernel(i) for i in range(len(layout.marks))]


# ---- the layout ----

@pytest.mark.parametrize("T", [120, 8])
def test_sampled_steps(T):
    steps = sampled_steps(T)
    assert steps == list(range(4, T, 8))
    assert steps and 0 not in steps and T - 1 not in steps
    assert sampled_steps(3) == [1] and sampled_steps(1) == [0]


LAYOUT_CASES = [(T, fused, remat) for T in (120, 8)
                for fused in (True, False) for remat in (True, False)]


@pytest.mark.parametrize("T,fused,remat", LAYOUT_CASES)
def test_marks_of_one_update_run_in_the_layout(T, fused, remat):
    """One ``train_step`` launches exactly the layout's marks in its order,
    on either gradient path, with ``remat`` or without: the checkpoint's
    recompute runs none again (the ``comm`` marks inside the forward run
    for the forward alone: one begin and one end a sampled step, none on
    the other steps); only the last mark advances the slot. Without a
    graph there are no graph marks."""
    fns = _fns(T, fused_grad=fused, remat=remat)
    layout = fns.spans.layout
    seen = _record(fns.spans)
    ts = fns.init_state(0)
    fns.train_step(ts)
    assert [k for k, _, _ in seen] == _names(layout)
    assert [c for _, c, _ in seen] == list(range(len(layout.marks)))
    assert [a for _, _, a in seen] == [False] * (len(seen) - 1) + [True]
    n = len(sampled_steps(T))
    assert len(seen) == 10 + 6 * n    # 100 at T = 120, 102 with a graph
    assert layout.outer == "update" and "graph" not in layout.spans
    assert "allreduce" not in layout.spans
    names = [k for k, _, _ in seen]
    comm = [i for i, k in enumerate(names) if k.startswith("span_comm_")]
    assert len(comm) == 2 * n
    assert max(comm) < names.index("span_rollout_end")


def test_allreduce_marks_only_under_axis_name():
    """Under ``axis_name`` (one gloo rank here) the all-reduce is marked
    between the backward and the optimizer."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        distributed.maybe_initialize(f"tcp://localhost:{port}", 1, 0, "gloo")
        fns = _fns(8, dp=True)
        seen = _record(fns.spans)
        fns.train_step(fns.init_state(0))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    names = [k for k, _, _ in seen]
    assert names == _names(fns.spans.layout)
    i = names.index("span_allreduce_begin")
    assert names[i - 1:i + 3] == ["span_backward_end", "span_allreduce_begin",
                                  "span_allreduce_end",
                                  "span_optimizer_begin"]


def _intervals(marks):
    """{(span, sample): (begin index, end index)} of a mark list."""
    out = {}
    for i, (span, edge, k) in enumerate(marks):
        out.setdefault((span, k), [None, None])[edge == "end"] = i
    return out


@pytest.mark.parametrize("graph,allreduce", [(True, True), (True, False),
                                             (False, False)])
def test_spans_nest_in_their_parents(graph, allreduce):
    """Every span's marks lie inside its parent's; a sampled span's
    samples inside the one parent or the same sample of its sampled
    parent; the outermost span holds every mark. ``policy`` runs from a
    step's begin to its env's begin, and holds ``comm``."""
    layout = Layout(120, graph, allreduce)
    iv = _intervals(layout.marks)
    for k in range(len(layout.samples)):
        iv[("policy", k)] = [iv[("step", k)][0], iv[("env", k)][0]]
    assert iv[(layout.outer, None)] == [0, len(layout.marks) - 1]
    for (span, k), (b, e) in iv.items():
        assert b < e
        parent = layout.parent(span)
        if parent is None:
            assert span == layout.outer
            continue
        pk = k if parent in spans_mod.SAMPLED else None
        pb, pe = iv[(parent, pk)]
        # ``policy`` begins with its step
        assert (pb == b if span == "policy" else pb < b) and e < pe, (
            span, k, parent)
    assert layout.spans == (["graph"] if graph else []) + [
        "update", "rollout", "step", "policy", "comm", "env", "returns",
        "backward"] + (["allreduce"] if allreduce else []) + ["optimizer"]
    assert layout.parent("update") == ("graph" if graph else None)
    assert layout.parent("comm") == "policy"
    assert len(layout.marks) == 10 + 90 + 2 * graph + 2 * allreduce


def test_graph_marks_are_captured_around_the_update():
    """``GraphedStep`` with a stand-in graph: the warm-up runs the body's
    marks without the graph's (so it advances nothing), the capture runs
    the graph's marks around the body's, a replay runs no mark from Python,
    and each replay's host spans are timed into the host ring."""
    spans = Spans(8, "cpu", graph=True, allreduce=False)
    seen = _record(spans)

    def fn(state, scalars, extras, generator):
        spans.begin("update")
        new = [state[0] * scalars[0]]
        spans.end("update")
        return new, {"m": new[0].sum()}

    class StandInGraph:
        def instantiate(self):
            pass

        def replay(self):
            pass

    step = GraphedStep(fn, "cpu", 1, graph=StandInGraph,
                       capture=lambda g, stream: contextlib.nullcontext(),
                       spans=spans)
    gen = torch.Generator().manual_seed(0)
    new, _ = step("a", [torch.ones(3)], [2.0], [None], gen)
    assert [k for k, _, _ in seen] == [
        "span_update_begin", "span_update_end", "span_graph_begin",
        "span_update_begin", "span_update_end", "span_graph_end"]
    assert [a for _, _, a in seen] == [False] * 5 + [True]
    spans.commit()
    del seen[:]
    step("a", new, [3.0], [None], gen)
    spans.commit()
    assert seen == []
    row = spans.host_ring[1]
    for name in ("copy_in", "scalars_write", "launch"):
        b, e = row[HOST_SPANS.index(name)]
        assert 0 < b <= e
    assert spans.slot == 2


# ---- the rings' arithmetic ----

def _synthetic(layout, rows, done, base=10 ** 12):
    """Stamps in which every mark follows the one before by 1000 ns, except
    ``env`` (each sample 5000 ns) and ``backward`` (7000 ns), and each
    update starts 100,000 ns after the one before."""
    stamps = np.zeros((rows, len(layout.marks)), np.int64)
    for s in range(max(done - rows, 0), done):
        t = base + s * 100_000
        for i, (span, edge, _) in enumerate(layout.marks):
            if i:
                t += {("env", "end"): 5000,
                      ("backward", "end"): 7000}.get((span, edge), 1000)
            stamps[s % rows, i] = t
    return stamps


def test_durations_self_times_and_scaling():
    """Durations from the stamps; a sampled span scaled by T over its
    samples (15 at T = 120); each self time its span less its children
    (``policy`` less ``comm``)."""
    layout = Layout(120, graph=True, allreduce=False)
    row = _synthetic(layout, 1, 1)[0]
    d = layout.durations_ns(row[None])
    assert d.shape == (1, len(layout.spans))
    dur = dict(zip(layout.spans, d[0]))
    n = 15
    assert dur["env"] == pytest.approx(n * 5000 * 120 / n)
    # a step: begin -> comm begin -> comm end -> env begin -> env end ->
    # step end
    assert dur["comm"] == pytest.approx(n * 1000 * 120 / n)
    assert dur["policy"] == pytest.approx(n * 3000 * 120 / n)
    assert dur["step"] == pytest.approx(n * 9000 * 120 / n)
    assert dur["backward"] == 7000
    assert dur["update"] == row[-2] - row[1]
    assert dur["graph"] == row[-1] - row[0]
    own = dict(zip(layout.spans, layout.self_times(d)[0]))
    assert own["step"] == pytest.approx(dur["step"] - dur["policy"]
                                        - dur["env"])
    assert own["rollout"] == pytest.approx(dur["rollout"] - dur["step"])
    assert own["update"] == pytest.approx(
        dur["update"] - sum(dur[k] for k in ("rollout", "returns",
                                             "backward", "optimizer")))
    assert own["graph"] == dur["graph"] - dur["update"] == 2000
    assert own["env"] == dur["env"] and own["comm"] == dur["comm"]
    assert own["policy"] == pytest.approx(dur["policy"] - dur["comm"])


def test_read_rows_wraps_the_slot_and_attributes_the_gaps():
    """The last n of more updates than the ring holds: slots past ROWS
    read their rows modulo ROWS; each gap runs from the previous update's
    end to this one's begin, and is put down to the innermost host span
    under way at its end on the host's clock (or "python" outside
    ``train_step``); without matching host slots the host is left out."""
    layout = Layout(16, graph=True, allreduce=False)
    done, n = ROWS + 10, 20
    stamps = _synthetic(layout, ROWS, done)
    offset = 5_000_000
    host = np.zeros((ROWS, len(HOST_SPANS), 2), np.int64)
    for s in range(done - n, done):
        t = int(stamps[s % ROWS, 0]) + offset      # the graph's begin
        i = HOST_SPANS.index
        host[s % ROWS, i("train_step")] = (t - 900, t + 900)
        if s % 2:
            host[s % ROWS, i("launch")] = (t - 100, t + 100)
        else:
            host[s % ROWS, i("scalars_write")] = (t - 500, t - 300)
    out = read_rows(layout, stamps, host, done, n, Clock(offset, 1500.0))
    assert [r["slot"] for r in out] == list(range(done - n, done))
    span_ms = (len(layout.marks) - 1 + 4 * len(layout.samples) + 6) * 1e-3
    for r in out:
        assert r["spans"]["graph"]["ms"] == pytest.approx(span_ms)
        assert r["gap_ms"] == pytest.approx(0.1 - span_ms)
        assert r["gap_during"] == ("launch" if r["slot"] % 2
                                   else "train_step")
        assert r["host"]["train_step"] == pytest.approx(1800 / 1e6)
        assert r["clock_uncertainty_ms"] == 1.5e-3
        assert r["spans"]["env"]["sampled"]
        assert not r["spans"]["backward"]["sampled"]
    # the ring holds ROWS updates: the oldest has no previous one to gap
    back = read_rows(layout, stamps, None, done, 10 ** 6, Clock(offset, 0))
    assert len(back) == ROWS and back[0]["slot"] == done - ROWS
    assert back[0]["gap_ms"] is None and back[1]["gap_ms"] is not None
    assert back[1]["host"] is None and back[1]["gap_during"] is None
    first = read_rows(layout, _synthetic(layout, ROWS, 3), None, 3, 5,
                      Clock(0, 0))
    assert [r["slot"] for r in first] == [0, 1, 2]
    assert first[0]["gap_ms"] is None
    means = mean_ms(out)
    assert means["graph"] == pytest.approx(span_ms)
    assert means["train_step"] == pytest.approx(1800 / 1e6)
    assert means["launch"] == pytest.approx(200 / 1e6)
    # without a clock: the same spans and host spans, and no gaps
    bare = read_rows(layout, stamps, host, done, n, None)
    assert [set(r) for r in bare] == [{"slot", "spans", "host"}] * n
    assert [(r["spans"], r["host"]) for r in bare] == \
        [(r["spans"], r["host"]) for r in out]


def test_means_reads_the_ring_once_without_the_clock(monkeypatch):
    """``Spans.means`` (the Trainer's) copies the ring once and reads
    durations only: no clock brackets, no gaps; ``read`` brackets the
    clock first and attributes the gaps."""
    spans = Spans(8, "cpu", graph=True, allreduce=False)
    assert spans.means(3) == {} and spans.read(3) == []  # no ring
    layout = spans.layout
    cols = len(layout.marks)
    done = 4
    stamps = _synthetic(layout, ROWS, done)
    ring = np.zeros(ROWS * cols + 1 + spans_mod.CLOCK_BRACKETS, np.int64)
    ring[:ROWS * cols] = stamps.reshape(-1)
    ring[ROWS * cols] = done
    spans.ring, spans._slot_at = torch.from_numpy(ring), ROWS * cols
    bracketed = []
    monkeypatch.setattr(spans, "_brackets", lambda: bracketed.append(1) or
                        [(10, 30)] * spans_mod.CLOCK_BRACKETS)
    got = spans.means(3)
    assert bracketed == []
    want = mean_ms(read_rows(layout, stamps, None, done, 3, None))
    assert got == want and got["env"] > 0
    read = spans.read(3)
    assert bracketed == [1] and spans.clock == Clock(20.0, 10.0)
    assert [r["slot"] for r in read] == [1, 2, 3]
    assert all(r["gap_ms"] is not None for r in read)
    assert mean_ms(read) == got


def test_host_span_at():
    """Over the spans of two calls: the innermost under way, else
    "python"."""
    row = np.zeros((len(HOST_SPANS), 2), np.int64)
    row[0] = (100, 200)
    row[HOST_SPANS.index("launch")] = (150, 160)
    nxt = np.zeros_like(row)
    nxt[0] = (210, 400)
    nxt[HOST_SPANS.index("scalars_write")] = (220, 300)
    assert host_span_at([row], 155) == "launch"
    assert host_span_at([row], 170) == "train_step"
    assert host_span_at([row], 250) == "python"
    assert host_span_at([row, nxt], 250) == "scalars_write"
    assert host_span_at([row, nxt], 205) == "python"


def test_gap_ended_while_the_next_call_waited():
    """A gap that ends while the host waits in the next call's
    ``scalars_write`` (the host ahead of the card) is put down to it."""
    layout = Layout(8, graph=True, allreduce=False)
    stamps = _synthetic(layout, ROWS, 3)
    host = np.zeros((ROWS, len(HOST_SPANS), 2), np.int64)
    t = int(stamps[1, 0])
    host[1, 0] = (t - 10_000, t - 5000)             # the call that issued 1
    host[2, 0] = (t - 4000, t + 4000)               # the next call
    host[2, HOST_SPANS.index("scalars_write")] = (t - 3000, t + 50)
    got = read_rows(layout, stamps, host, 3, 2, Clock(0, 0))
    assert got[0]["slot"] == 1 and got[0]["gap_during"] == "scalars_write"


def test_clock_offset_against_a_fake_clock():
    """A fake card clock runs ``true`` ns behind the host's; each bracket
    holds one stamp. The offset comes from the tightest bracket, and lies
    within its half width of the truth."""
    rng = np.random.default_rng(0)
    true = 123_456_789
    brackets, stamps = [], []
    t = 10 ** 9
    for width in (4000, 900, 2500, 12000, 1500):
        a = t
        at = a + int(rng.integers(0, width + 1))     # the stamp, host time
        brackets.append((a, a + width))
        stamps.append(at - true)
        t += 50_000
    clock = clock_offset(brackets, stamps)
    assert clock.uncertainty_ns == 450
    assert abs(clock.offset_ns - true) <= clock.uncertainty_ns
    # the host time of a card stamp: the tightest bracket's middle
    assert abs(clock.host_ns(stamps[1])
               - (brackets[1][0] + brackets[1][1]) / 2) <= 0.5
    for d, (a, b) in zip(stamps, brackets):
        assert a - 450 <= clock.host_ns(d) <= b + 450


# ---- the host spans ----

def test_record_function_only_while_a_profiler_runs(monkeypatch):
    """The host spans enter ``record_function`` only under an active
    profiler; their times go to the host ring either way, at the slot of
    the update each ``train_step`` issued."""
    entered = []

    class Recorder(contextlib.ContextDecorator):
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    fns = _fns(8)
    ts = fns.init_state(0)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Recorder)
    ts, _ = fns.train_step(ts)
    assert entered == []
    row = fns.spans.host_ring[0]
    for name in ("train_step", "schedule", "scalars_write", "launch"):
        b, e = row[HOST_SPANS.index(name)]
        assert 0 < b <= e
    assert tuple(row[HOST_SPANS.index("copy_in")]) == (0, 0)  # eager
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        fns.train_step(ts)
    assert entered == ["train_step", "schedule", "scalars_write", "launch"]
    assert fns.spans.slot == 2
    assert fns.spans.read(5) == []          # no ring on the CPU


def test_trainer_row_adds_each_spans_mean():
    """The log row gets ``span/<name>_ms`` from the spans' means over its
    window (none where the reader finds nothing, as on the CPU)."""
    rows = []
    asked = []

    def means(n):
        asked.append(n)
        return {"env": 1.5, "launch": 0.25}

    trainer = Trainer.__new__(Trainer)
    trainer.fns = types.SimpleNamespace(spans=types.SimpleNamespace(
        means=means))
    trainer.counter = types.SimpleNamespace(cur_step=64)
    trainer.train_writer = types.SimpleNamespace(write=rows.append)
    window = [{"loss": torch.tensor(1.0), "lr": 0.1} for _ in range(3)]
    trainer._log_row(window, 0.0, 0, 0.0)
    assert asked == [3]
    assert rows[0]["span/env_ms"] == 1.5 and rows[0]["span/launch_ms"] == 0.25
    assert rows[0]["loss"] == 1.0


# ---- on the card ----

def _card(T=8, env="grid", jit=True):
    return _fns(T, "cuda", env=env, jit=jit, num_envs=4, num_fc=16,
                num_lstm=16)


@needs_cuda
def test_cuda_profiled_replay_runs_the_layouts_marks():
    """Under the profiler one replay runs exactly the layout's mark
    kernels, in its order, by name; the stamps of every update read are
    monotone along the layout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fns = _card()
    ts = fns.init_state(0)
    for _ in range(2):
        ts, _ = fns.train_step(ts)
    torch.cuda.synchronize()
    # the profiler drops the card's records its clock puts near its edges
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        ts, _ = fns.train_step(ts)
        torch.cuda.synchronize()
        time.sleep(0.2)
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and e.name().startswith("span_")),
                 key=lambda e: e.start_ns())
    layout = fns.spans.layout
    assert [e.name() for e in evs] == _names(layout)
    assert layout.outer == "graph"
    got = fns.spans.read(3)
    assert [r["slot"] for r in got] == [0, 1, 2]
    ring = fns.spans.ring.cpu().numpy()
    stamps = ring[:ROWS * len(layout.marks)].reshape(ROWS, -1)
    for s in range(3):
        assert np.all(np.diff(stamps[s]) >= 0)
    for r in got:
        assert all(v["ms"] >= 0 for v in r["spans"].values())
        assert r["host"]["launch"] > 0


@needs_cuda
def test_cuda_graph_with_marks_equals_eager():
    """The graphed update with its marks equals the eager one (which marks
    too) bit for bit over three updates, and both rings read them."""
    graph, eager = _card(jit=True), _card(jit=False)
    ts_g = graph.init_state(0)
    gen = torch.Generator(device="cuda")
    gen.set_state(ts_g.generator.get_state())
    ts_e = state_from_leaves(ts_g, [t.clone() for t in state_leaves(ts_g)],
                             ts_g.step, ts_g.opt_state.count, gen)
    for _ in range(3):
        ts_g, m_g = graph.train_step(ts_g)
        ts_e, m_e = eager.train_step(ts_e)
        for x, y in zip(state_leaves(ts_g), state_leaves(ts_e)):
            assert torch.equal(x, y)
        for k in m_g:
            assert float(m_g[k]) == float(m_e[k]), k
    for fns in (graph, eager):
        got = fns.spans.read(3)
        assert len(got) == 3 and all(r["host"] for r in got)
        assert all(r["spans"]["update"]["ms"] > 0 for r in got)


@needs_cuda
def test_cuda_platoon_env_span_is_above_zero():
    fns = _card(T=16, env="cacc")
    ts = fns.init_state(0)
    for _ in range(3):
        ts, _ = fns.train_step(ts)
    got = fns.spans.read(2)
    assert len(got) == 2
    for r in got:
        assert r["spans"]["env"]["ms"] > 0
        assert r["spans"]["env"]["sampled"]
        assert r["gap_during"] in HOST_SPANS + ("python",)
        assert r["clock_uncertainty_ms"] >= 0
    assert fns.spans.means(2)["env"] > 0
    assert spans_mod.CLOCK_BRACKETS == 5


@needs_cuda
def test_cuda_dial_update_takes_the_comm_embedding_kernels():
    """A DIAL update with ``remat`` at bf16 widths of 16 over packed lists,
    captured into its graph: the wrappers count the capture's warm-up and
    the capture, each 2T+1 forward and T backward calls under DIAL's
    ``LAUNCHES`` keys and none under NeurComm's; its ``comm`` span reads."""
    from deeprl_network_tpu_torch.ops import comm_embed as ce
    T = 8
    fns = _fns(T, "cuda", env="grid", agent="ma2c_dial", num_envs=4,
               num_fc=16, num_lstm=16, compute_dtype="bfloat16",
               sparse_comm=True, remat=True)
    ts = fns.init_state(0)
    before = dict(ce.LAUNCHES)
    ts, _ = fns.train_step(ts)
    ts, _ = fns.train_step(ts)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in ce.LAUNCHES.items()
             if v != before[k]}
    assert moved == {"comm_embed_dial_fwd": 2 * (2 * T + 1),
                     "comm_embed_dial_bwd": 2 * T}
    got = fns.spans.read(2)
    assert len(got) == 2 and all(r["spans"]["comm"]["ms"] > 0 for r in got)
