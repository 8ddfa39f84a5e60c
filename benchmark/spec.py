"""What the harness finds by name: ``BENCHMARK.json`` at the root of the
checkout, a configuration's file under ``configs/``, a cell's file under
``workloads/``, a traffic kind's runner under ``traffic/`` and a per-layer
metric's reader under ``metrics/``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: Dict           # the configuration's file
    kind: str              # the traffic kind: traffic/<kind>.py drives it
    params: Dict           # the traffic's parameters
    limits: Dict[str, float]   # the correctness limits of this cell
    end_to_end: List[Dict]     # BENCHMARK.json's metrics this cell reports
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json; raises if any file it
    names is missing or disagrees with it."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(root, conf["file"]))
    for key in ("config", "chips"):
        if work[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key}={work[key]!r}"
                             f", BENCHMARK.json {entry[key]!r}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"], config=config,
                kind=work["kind"], params=work["params"],
                limits=work["limits"], end_to_end=e2e, per_layer=layer)


def traffic_runner(kind: str):
    """The module ``traffic/<kind>.py``."""
    if not NAME.match(kind):
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py``: observations -> a number, or None
    where it finds nothing to read."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
