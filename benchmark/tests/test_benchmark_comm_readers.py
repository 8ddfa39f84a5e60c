"""The readers of the policy's comm: ``comm_ms.train`` (the program's
``comm`` span) and ``comm_embed_roofline.train`` (the comm-embedding
kernels' share of their bound) on synthetic traces, and the frozen bound
(``roofline/embed.py``) against ``chip_smoke.py``'s own count at the grid
cells' shapes."""

import pytest
import torch

from benchmark import roofline, spec
from benchmark.roofline.embed import embed_bytes_flops
from benchmark.trace import Event
from benchmark.traffic import train

US = 1_000          # ns
T = 16
SAMPLES = (4, 12)   # the program's sampled steps at T = 16
GRIDS = ["grid25_ma2c_nc.train_b768", "grid25_ma2c_dial.train_b768"]


def _update(t, comm_us, embed=True):
    """One graphed update from ``t``: on each step a comm-embedding forward
    of 3 us inside ``comm_us`` of comm work (its marks on the sampled
    steps), then the rest of the policy and the env; after the rollout one
    backward call (its relu-gradient pass and its kernel); returns (events,
    time at its end)."""
    evs = []

    def dev(name, dur):
        nonlocal t
        evs.append(Event(True, name, t, dur))
        t += dur

    mark = lambda span, edge: dev(f"span_{span}_{edge}", US)
    mark("graph", "begin")
    mark("update", "begin")
    for step in range(T):
        sampled = step in SAMPLES
        if sampled:
            mark("step", "begin")
            mark("comm", "begin")
        if embed:
            dev("void (anonymous namespace)::comm_embed_tc_fwd_kernel<4>"
                "(Args)", 3 * US)
            dev("elementwise_kernel", comm_us * US - 3 * US)
        else:
            dev("index_elementwise_kernel", comm_us * US)
        if sampled:
            mark("comm", "end")
        dev("lstm_tc_fwd_kernel", 10 * US)
        if sampled:
            mark("env", "begin")
        dev("network_env_kernel", 20 * US)
        if sampled:
            mark("env", "end")
            mark("step", "end")
    if embed:
        dev("(anonymous namespace)::comm_embed_tc_relu_grad_kernel(Args)",
            2 * US)
        dev("void (anonymous namespace)::comm_embed_tc_bwd_kernel<4, 4>"
            "(Args)", 6 * US)
    mark("update", "end")
    mark("graph", "end")
    return evs, t


def _trace(comm_us=(5, 9, 5), embed=True, marks=True):
    evs, t = [Event(False, "cudaGraphLaunch", 0, 100 * US)], 100 * US
    for c in comm_us:
        ev, t = _update(t, c, embed)
        evs += ev
        t += 1000 * US
    evs.append(Event(False, "cudaDeviceSynchronize", 100 * US, t))
    if not marks:
        evs = [e for e in evs if not e.name.startswith("span_")]
    return evs


def _shapes(cell):
    return train.shapes(spec.load_cell(cell))


def read(name, obs):
    return spec.metric_reader(name)(obs)


def test_comm_ms_sums_and_scales_the_samples():
    """Each sample from its begin mark's start to its end mark's start
    (the comm work and the begin mark), summed, scaled by T over the
    samples; the median of three updates, the middle one slower."""
    shp = dict(_shapes(GRIDS[1]), T=T)
    obs = {"trace": _trace(), "trace_updates": 3, "shapes": shp}
    per = T / len(SAMPLES)
    assert read("comm_ms.train", obs) == pytest.approx(
        len(SAMPLES) * (5 + 1) * 1e-3 * per)
    slow = {**obs, "trace": _trace((9, 9, 5))}
    assert read("comm_ms.train", slow) == pytest.approx(
        len(SAMPLES) * (9 + 1) * 1e-3 * per)


def test_comm_ms_reads_nothing_without_the_span():
    """A program without the ``comm`` marks (the parent's) reads None."""
    shp = dict(_shapes(GRIDS[1]), T=T)
    plain = [e for e in _trace() if "span_comm" not in e.name]
    assert read("comm_ms.train", {"trace": plain, "shapes": shp}) is None
    assert read("comm_ms.train", {}) is None
    assert read("comm_ms.train", {"trace": None, "shapes": shp}) is None


@pytest.mark.parametrize("cell", GRIDS)
def test_comm_embed_roofline_is_the_bound_over_the_kernels_time(cell):
    """The bound of T forward and one backward call an update (the
    backward counted by its second kernel), over all the comm-embedding
    kernels' time; DIAL's bound has no fingerprint term (A = 0)."""
    shp = _shapes(cell)
    obs = {"trace": _trace(), "trace_updates": 3, "shapes": shp}
    (fb, ff), (bb, bf) = embed_bytes_flops(
        shp["comm"], shp["B"], shp["n_s"],
        shp["n_a"] if shp["comm"] == "neurcomm" else 0, shp["F"],
        shp["F"] if shp["comm"] == "dial" else shp["H"], shp["degrees"],
        "bfloat16")
    bound = 3 * (T * roofline.bound_s(fb, ff, "bfloat16")
                 + roofline.bound_s(bb, bf, "bfloat16"))
    secs = 3 * (T * 3 + 2 + 6) * 1e-6
    got = read("comm_embed_roofline.train", obs)
    assert got == pytest.approx(100 * bound / secs)
    assert 0 < got < 100


def test_comm_embed_bound_of_dial_drops_the_fingerprints():
    deg = _shapes(GRIDS[1])["degrees"]
    nc = embed_bytes_flops("neurcomm", 768, 12, 5, 64, 64, deg, "bfloat16")
    dial = embed_bytes_flops("dial", 768, 12, 5, 64, 64, deg, "bfloat16")
    assert dial == embed_bytes_flops("dial", 768, 12, 0, 64, 64, deg,
                                     "bfloat16")
    edges = sum(deg)
    assert nc[0][1] - dial[0][1] == 2 * 768 * 64 * edges * 5
    # the fingerprints [B, N, 5], the done flags, W_fp's valid blocks
    assert nc[0][0] - dial[0][0] == 2 * (768 * 25 * 5 + 768
                                         + edges * 5 * 64)
    with pytest.raises(ValueError, match="commnet"):
        embed_bytes_flops("commnet", 768, 12, 5, 64, 64, deg, "bfloat16")


@pytest.mark.parametrize("cell", GRIDS)
def test_comm_embed_roofline_reads_nothing_without_kernels(cell):
    """The ops path (the parent's DIAL), no trace, and the families with
    no comm-embedding kernel read None, never 0."""
    shp = _shapes(cell)
    ops = {"trace": _trace(embed=False), "trace_updates": 3, "shapes": shp}
    assert read("comm_embed_roofline.train", ops) is None
    assert read("comm_embed_roofline.train", {}) is None
    other = {**ops, "trace": _trace(), "shapes": {**shp, "comm": "commnet"}}
    assert read("comm_embed_roofline.train", other) is None


@pytest.mark.parametrize("cell", GRIDS)
def test_embed_bound_equals_chip_smokes_count(cell):
    """The frozen count at each grid cell's shape equals ``chip_smoke.py``
    ``embed_bytes_flops`` of the program's own spec; at the flagship's the
    bound is 1.89 us forward and 3.60 us backward, by bytes."""
    import chip_smoke
    from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.utils.rollout import make_policy_spec
    c = spec.load_cell(cell)
    shp = train.shapes(c)
    env = LargeGridEnv(EnvConfig(scenario="large_grid"), device="cpu")
    pspec = make_policy_spec(env.spec, ModelConfig(
        num_fc=shp["F"], num_lstm=shp["H"], sparse_comm=True),
        c.config["agent"])
    want = chip_smoke.embed_bytes_flops(pspec, shp["B"], torch.bfloat16)
    got = embed_bytes_flops(shp["comm"], shp["B"], shp["n_s"], shp["n_a"],
                            shp["F"], shp["F"] if shp["comm"] == "dial"
                            else shp["H"], shp["degrees"], shp["dtype"])
    assert got == want
    if shp["comm"] == "neurcomm":
        (fb, ff), (bb, bf) = got
        assert roofline.bound_s(fb, ff, "bfloat16") * 1e6 == \
            pytest.approx(1.89, abs=0.005)
        assert roofline.bound_s(bb, bf, "bfloat16") * 1e6 == \
            pytest.approx(3.60, abs=0.005)
        assert fb / roofline.PEAK_BYTES_PER_S > ff / 989e12
