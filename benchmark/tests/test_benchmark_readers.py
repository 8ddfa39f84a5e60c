"""Each per-layer metric's reader on a synthetic trace and window: the
number it should give, and nothing where there is nothing to read."""

import pytest

from benchmark import roofline, spec
from benchmark.trace import Event, summary

MS = 1_000_000   # ns


def _trace():
    """Two updates: a graph launch on the host, then on the card two cell
    forward kernels, one backward (act + weight), an env kernel and an NCCL
    all-reduce, with a 1 ms gap, and a final synchronise."""
    evs = [Event(False, "cudaGraphLaunch", 0, MS // 10)]
    t = MS // 10
    for _ in range(2):
        for name, dur in (("void lstm_tc_fwd_kernel<64>(Args)", MS),
                          ("void lstm_tc_fwd_kernel<64>(Args)", MS),
                          ("void lstm_tc_bwd_act_kernel<64>(Args)", MS),
                          ("void lstm_tc_bwd_weight_kernel<64>(Args)", MS),
                          ("network_env_kernel(Args)", MS),
                          ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", MS)):
            evs.append(Event(True, name, t, dur))
            t += dur
        t += MS            # an idle millisecond
    evs.append(Event(False, "cudaDeviceSynchronize", MS // 10, t - MS // 10))
    return evs


SHAPES = {"B": 768, "T": 120, "N": 25, "n_s": 12, "n_a": 5,
          "F": 64, "H": 64, "comm": "neurcomm", "degrees": [3.2] * 25,
          "dtype": "bfloat16",
          "env": {"L": 300, "M": 25, "P": 5, "D": 10, "W": 12,
                  "route_nnz": 720, "substeps": 5, "with_q0": False}}
OBS = {"window": {"updates": 10, "window_s": 0.7, "host_s": [1e-3, 3e-3, 2e-3],
                  "device_s": [0.07, 0.06, 0.08]},
       "trace": _trace(), "trace_updates": 2, "shapes": SHAPES}


def read(name, obs):
    return spec.metric_reader(name)(obs)


def test_summary_of_the_synthetic_trace():
    s = summary(OBS["trace"])
    assert s["busy_s"] == pytest.approx(12e-3)
    assert s["window_s"] == pytest.approx(14e-3 + 1e-4)
    assert s["n_device"] == 12
    assert s["idle_gaps"] == [["cudaDeviceSynchronize", pytest.approx(2.1e-3)]]


def test_window_readers():
    assert read("train_step_host_ms.train", OBS) == pytest.approx(2.0)
    assert read("update_device_ms.train", OBS) == pytest.approx(70.0)
    flops = roofline.update_model_flops(768, 120, 12, 5, 64, 64,
                                        [3.2] * 25, "neurcomm")
    assert read("step_mfu.train", OBS) == pytest.approx(
        100 * flops * 10 / 0.7 / 989e12)


def test_trace_readers():
    assert read("kernels_per_update.train", OBS) == 6
    idle = 100 * (1 - 12e-3 / (14e-3 + 1e-4))
    assert read("device_idle_pct.train", OBS) == pytest.approx(idle)
    (fb, ff), (bb, bf) = roofline.cell_bytes_flops(768, 25, 64, 64,
                                                   "bfloat16")
    bound = (4 * roofline.bound_s(fb, ff, "bfloat16")
             + 2 * roofline.bound_s(bb, bf, "bfloat16"))
    assert read("lstm_roofline.train", OBS) == pytest.approx(
        100 * bound / 8e-3)
    nb, fl = roofline.env_bytes_flops(768, 300, 25, 5, 10, 12, 720, 5,
                                      False)
    assert read("env_kernel_roofline.train", OBS) == pytest.approx(
        100 * 2 * roofline.bound_s(nb, fl, "float32") / 2e-3)


@pytest.mark.parametrize("name", [
    "train_step_host_ms.train", "update_device_ms.train",
    "kernels_per_update.train", "lstm_roofline.train",
    "env_kernel_roofline.train", "device_idle_pct.train", "step_mfu.train"])
def test_readers_return_nothing_without_their_source(name):
    assert read(name, {}) is None
    no_kernels = {**OBS, "trace": [Event(False, "cudaGraphLaunch", 0, 1)],
                  "window": {}}
    assert read(name, no_kernels) in (None, 0.0)
