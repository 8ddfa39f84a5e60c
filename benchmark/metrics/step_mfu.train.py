"""The whole update's share of one card's peak: the policy's model FLOPs of
an update (forward and backward over this process's B x T x N agent-steps,
from the published equations of the cell's comm type:
``update_model_flops``) times the window's updates, over the window's
seconds and the peak of the compute dtype as the port runs it (bf16 989
TFLOP/s; f32 67 TFLOP/s, TF32 being off)."""

from benchmark.roofline import PEAK_FLOPS, update_model_flops


def read(obs):
    win, shp = obs.get("window"), obs.get("shapes")
    if not win or not shp:
        return None
    flops = update_model_flops(shp["B"], shp["T"], shp["n_s"], shp["n_a"],
                               shp["F"], shp["H"], shp["degrees"],
                               shp["comm"])
    rate = flops * win["updates"] / win["window_s"]
    return 100.0 * rate / PEAK_FLOPS[shp["dtype"]]
