"""The comm-embedding kernels' share of their roofline over the traced
stretch: the frozen bound of each forward and backward call
(``roofline/embed.py`` at the cell's B, N, S, A, K, F and H, A = 0 and
H = F for DIAL, and its compute dtype) summed over the calls the trace
holds, over the kernels' traced time (``comm_embed_*`` by name; a backward call is
counted by its ``comm_embed_tc_bwd_kernel`` or ``comm_embed_bwd_kernel``).
Nothing where no such kernel ran, as where a family's comm runs as
PyTorch ops."""

import re

from benchmark.roofline import bound_s
from benchmark.roofline.embed import embed_bytes_flops
from benchmark.trace import device_time

EMBED = re.compile(r"(?<!\w)comm_embed_\w*kernel")
FWD = re.compile(r"(?<!\w)comm_embed_(tc_)?fwd_kernel")
BWD = re.compile(r"(?<!\w)comm_embed_(tc_)?bwd_kernel")


def read(obs):
    evs, shp = obs.get("trace"), obs.get("shapes")
    if not evs or not shp or shp.get("comm") not in ("neurcomm", "dial"):
        return None
    n_f, _ = device_time(evs, FWD.search)
    n_b, _ = device_time(evs, BWD.search)
    _, secs = device_time(evs, EMBED.search)
    if secs <= 0 or not (n_f or n_b):
        return None
    dt = shp["dtype"]
    # DIAL's senders send messages as wide as the embedding (n_msg = F)
    X = shp["F"] if shp["comm"] == "dial" else shp["H"]
    (fb, ff), (bb, bf) = embed_bytes_flops(
        shp["comm"], shp["B"], shp["n_s"], shp["n_a"], shp["F"], X,
        shp["degrees"], dt)
    bound = n_f * bound_s(fb, ff, dt) + n_b * bound_s(bb, bf, dt)
    return 100.0 * bound / secs
