"""The ATSC env kernel's share of its roofline over the traced stretch:
the frozen bound of one control step (``env_bytes_flops`` at the cell's B
and the grid's lanes, nodes, phases, delay slots, obs width and route
nonzeros) times the launches traced, over their traced time
(``network_env_kernel`` by name)."""

import re

from benchmark.roofline import bound_s, env_bytes_flops
from benchmark.trace import device_time

KERNEL = re.compile(r"(?<!\w)network_env_kernel(?!\w)")


def read(obs):
    evs, shp = obs.get("trace"), obs.get("shapes")
    if not evs or not shp or "env" not in shp:
        return None
    n, secs = device_time(evs, KERNEL.search)
    if not n or secs <= 0:
        return None
    e = shp["env"]
    nbytes, flops = env_bytes_flops(shp["B"], e["L"], e["M"], e["P"], e["D"],
                                    e["W"], e["route_nnz"], e["substeps"],
                                    e["with_q0"])
    return 100.0 * n * bound_s(nbytes, flops, "float32") / secs
