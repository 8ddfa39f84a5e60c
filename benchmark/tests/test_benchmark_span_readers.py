"""The readers of the program's span marks (``benchmark/marks.py`` and the
metrics that read it) on synthetic traces: nothing without marks, the
median over updates, the sampled spans' scaling, and the idle share inside
the graphs, which counts marks as idle and leaves the gaps between graphs
out."""

import pytest

from benchmark import marks, spec
from benchmark.trace import Event

US = 1_000          # ns
T = 16
SAMPLES = (4, 12)   # the program's sampled steps at T = 16

NEW = ["graph_span_ms.train", "rollout_ms.train", "env_ms.train",
       "policy_step_ms.train", "backward_ms.train", "optimizer_ms.train",
       "in_graph_idle_pct.train"]


def _update(t, scale, graph=True):
    """One update from ``t``: its marks (1 us each) around kernels of
    ``scale`` times a fixed length; returns (events, time at its end)."""
    evs = []

    def mark(span, edge):
        nonlocal t
        evs.append(Event(True, f"span_{span}_{edge}", t, US))
        t += US

    def work(name, dur):
        nonlocal t
        evs.append(Event(True, name, t, int(dur * scale)))
        t += int(dur * scale)

    if graph:
        mark("graph", "begin")
    mark("update", "begin")
    mark("rollout", "begin")
    for step in range(T):
        if step in SAMPLES:
            mark("step", "begin")
        work("void policy_kernel<64>(Args)", 20 * US)
        if step in SAMPLES:
            mark("env", "begin")
        work("network_env_kernel(Args)", 30 * US)
        if step in SAMPLES:
            mark("env", "end")
        t += 10 * US                    # idle inside the graph
        if step in SAMPLES:
            mark("step", "end")
    mark("rollout", "end")
    mark("returns", "begin")
    work("returns_kernel", 40 * US)
    mark("returns", "end")
    mark("backward", "begin")
    work("lstm_tc_bwd_act_kernel", 400 * US)
    mark("backward", "end")
    mark("optimizer", "begin")
    work("rmsprop_kernel", 50 * US)
    mark("optimizer", "end")
    mark("update", "end")
    if graph:
        evs.append(Event(True, "Memcpy DtoD (Device -> Device)", t, 5 * US))
        t += 5 * US
        mark("graph", "end")
    return evs, t


def _trace(scales=(1.0, 3.0, 1.0), graph=True):
    """A graph launch on the host, updates with a 1 ms gap between them
    (copies in it), a final synchronise."""
    evs, t = [Event(False, "cudaGraphLaunch", 0, 100 * US)], 100 * US
    for sc in scales:
        ev, t = _update(t, sc, graph)
        evs += ev
        evs.append(Event(True, "Memcpy HtoD (Pinned -> Device)", t + 10 * US,
                         500 * US))
        t += 1000 * US
    evs.append(Event(False, "cudaDeviceSynchronize", 100 * US, t))
    return evs


SHAPES = {"T": T, "B": 8}


def read(name, obs):
    return spec.metric_reader(name)(obs)


@pytest.mark.parametrize("name", NEW)
def test_no_marks_read_nothing(name):
    """The parent's trace (no marks) and no trace at all read None."""
    plain = [e for e in _trace() if not e.name.startswith("span_")]
    assert read(name, {"trace": plain, "trace_updates": 3,
                       "shapes": SHAPES}) is None
    assert read(name, {}) is None
    assert read(name, {"trace": None, "shapes": SHAPES}) is None


def test_updates_split_at_the_outermost_span():
    got = marks.updates(_trace())
    assert len(got) == 3
    assert all(u[0].span == "graph" and u[0].edge == "begin"
               and u[-1].span == "graph" and u[-1].edge == "end" for u in got)
    eager = marks.updates(_trace(graph=False))
    assert len(eager) == 3 and eager[0][0].span == "update"
    # a stretch cut inside an update is no update
    assert len(marks.updates(_trace()[:-40])) == 2


def test_spans_are_the_median_over_updates():
    """Each plain span from its begin mark's start to its end mark's
    start, the median of three updates (the middle one three times as
    long)."""
    obs = {"trace": _trace(), "trace_updates": 3, "shapes": SHAPES}
    assert read("backward_ms.train", obs) == pytest.approx((400 + 1) * 1e-3)
    assert read("optimizer_ms.train", obs) == pytest.approx((50 + 1) * 1e-3)
    steps = T * 60 + len(SAMPLES) * 4          # work and idle, sample marks
    assert read("rollout_ms.train", obs) == pytest.approx((steps + 1) * 1e-3)
    n_marks = 4 + 4 * len(SAMPLES) + 8
    graph = T * 60 + 40 + 400 + 50 + 5 + n_marks - 1   # to the last start
    assert read("graph_span_ms.train", obs) == pytest.approx(graph * 1e-3)
    slow = {**obs, "trace": _trace((3.0, 3.0, 1.0))}
    assert read("backward_ms.train", slow) == pytest.approx(
        (1200 + 1) * 1e-3)


def test_sampled_spans_are_scaled_by_t_over_the_samples():
    """env: env begin to env end of each sample; policy: step begin to env
    begin; both summed over the samples and scaled by T / samples."""
    obs = {"trace": _trace(), "trace_updates": 3, "shapes": SHAPES}
    per = T / len(SAMPLES)
    assert read("env_ms.train", obs) == pytest.approx(
        len(SAMPLES) * (30 + 1) * 1e-3 * per)
    assert read("policy_step_ms.train", obs) == pytest.approx(
        len(SAMPLES) * (20 + 1) * 1e-3 * per)
    assert marks.sampled_ms(marks.updates(obs["trace"])[0], "env", T) == \
        pytest.approx(T * 31e-3)


def test_in_graph_idle_counts_marks_as_idle_and_leaves_out_the_gaps():
    """Inside a graph: the 10 us a step with no kernel and every mark's
    1 us are idle; the copies between graphs do not count."""
    obs = {"trace": _trace(), "trace_updates": 3, "shapes": SHAPES}
    n_marks = 4 + 4 * len(SAMPLES) + 8
    work = T * 50 + 40 + 400 + 50 + 5
    idle = T * 10 + n_marks
    assert read("in_graph_idle_pct.train", obs) == pytest.approx(
        100 * idle / (work + idle))
    # without a graph span the share has nothing to read
    assert read("in_graph_idle_pct.train",
                {**obs, "trace": _trace(graph=False)}) is None


def test_every_new_metric_is_declared_for_both_cells():
    per_layer = {m["name"]: m for m in spec.load_json(
        f"{spec.ROOT}/BENCHMARK.json")["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "device_trace"
        assert m["moves"] == "train_env_steps_per_s"
        assert m["workloads"] == ["grid25_ma2c_nc.train_b768",
                                  "cacc_catchup_ma2c_nc.train_b64"]
