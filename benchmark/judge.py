"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference, and each has its limit in the cell's
workload file.

Norms are compared leaf by leaf: the gap between the program's norm of a
leaf and the reference's, against the larger of the reference's norm of
that leaf and the median leaf's (some gradients are all but zero), and the
worst leaf counts.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import torch


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Optional[Iterable[str]] = None) -> List[float]:
    """|prog - ref| / max(ref, median of ref), leaf by leaf over
    ``names``."""
    names = list(ref if names is None else names)
    med = sorted(ref[k] for k in names)[len(names) // 2]
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names]


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   names: Optional[Iterable[str]] = None) -> float:
    return max(leaf_gaps(prog, ref, names))


def train_numbers(losses: List[float], ms1: Dict[str, torch.Tensor],
                  p0: Dict[str, torch.Tensor], p_last: Dict[str, torch.Tensor],
                  ref: List[Dict], decay: float) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of an update's loss;
    ``grad_norm_gap``: the first gradient as the optimizer took it, read
    from its state after one update (ms = (1 - decay) g^2 from ms = 0);
    ``param_change_gap``: the params' change over the updates, over the
    leaves whose first reference gradient is above a thousandth of the
    median leaf's (a leaf below it moves by round-off alone), and
    ``median_change_gap``, the same over the median leaf: steady from seed
    to seed where float32 reductions in another order set the worst
    leaf."""
    loss_gap = max(abs(lp - r["loss"]) / max(abs(r["loss"]), 1e-30)
                   for lp, r in zip(losses, ref))
    g_prog = {k: math.sqrt(float(v.double().sum()) / (1.0 - decay))
              for k, v in ms1.items()}
    g_ref = _norms(ref[0]["grads"])
    med = sorted(g_ref.values())[len(g_ref) // 2]
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    d_prog = _norms({k: p_last[k].double() - p0[k].double() for k in p0})
    d_ref = _norms({k: ref[-1]["params"][k].double() - p0[k].double()
                    for k in p0})
    change = sorted(leaf_gaps(d_prog, d_ref, moving))
    return {"loss_gap": loss_gap,
            "grad_norm_gap": worst_leaf_gap(g_prog, g_ref),
            "param_change_gap": change[-1],
            "median_change_gap": change[len(change) // 2]}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit at or under it (a number that is not
    finite fails). A number without a limit in the cell's workload file is
    reported and not compared (``PERF.md`` says why)."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    out = []
    for k, v in numbers.items():
        if k not in limits:
            out.append(f"check {k} {v!r} not compared")
            continue
        ok = math.isfinite(v) and v <= limits[k]
        out.append(f"check {k} {v!r} limit {limits[k]!r} "
                   f"{'ok' if ok else 'FAIL'}")
    return out


def as_json(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """The compared numbers, each with its value and its limit."""
    return {k: {"value": numbers[k] if math.isfinite(numbers[k])
                else str(numbers[k]), "limit": lim}
            for k, lim in limits.items()}
