"""The LSTM cell kernels' share of their roofline over the traced stretch:
the frozen bound of each forward and backward call (``cell_bytes_flops``
at the cell's B, N, F, H and compute dtype) summed over the calls the
trace holds, over the kernels' traced time (``lstm_*`` by name; a backward
call is counted by its ``*_bwd_act_kernel``)."""

import re

from benchmark.roofline import bound_s, cell_bytes_flops
from benchmark.trace import device_time

CELL = re.compile(r"(?<!\w)lstm_\w*kernel")
FWD = re.compile(r"(?<!\w)lstm_(tc_)?fwd_kernel")
BWD = re.compile(r"(?<!\w)lstm_(tc_)?bwd_act_kernel")


def read(obs):
    evs, shp = obs.get("trace"), obs.get("shapes")
    if not evs or not shp:
        return None
    n_f, _ = device_time(evs, FWD.search)
    n_b, _ = device_time(evs, BWD.search)
    _, secs = device_time(evs, CELL.search)
    if secs <= 0 or not (n_f or n_b):
        return None
    (fb, ff), (bb, bf) = cell_bytes_flops(shp["B"], shp["N"], shp["F"],
                                          shp["H"], shp["dtype"])
    bound = (n_f * bound_s(fb, ff, shp["dtype"])
             + n_b * bound_s(bb, bf, shp["dtype"]))
    return 100.0 * bound / secs
