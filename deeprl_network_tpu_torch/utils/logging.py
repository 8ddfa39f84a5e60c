"""Run-dir layout, python logging, and csv/jsonl metric output (a copy of
``deeprl_network_tpu/utils/logging.py``: same file names, column order and
number formatting, so both packages' run dirs read alike).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)


def resolved_recipe(agent: str, ecfg=None, mcfg=None, tcfg=None,
                    **extra) -> Dict:
    """Fully-resolved run recipe for jsonl run headers: every EnvConfig /
    ModelConfig / TrainConfig field as actually constructed, so a run's
    header alone reproduces it."""

    def d(cfg):
        return dataclasses.asdict(cfg) if cfg is not None else None

    return {"recipe": {"agent": agent, "env": d(ecfg), "model": d(mcfg),
                       "train": d(tcfg), **extra}}


def init_dir(base_dir: str, pathes=("data", "log", "model")) -> Dict[str, str]:
    dirs = {}
    for p in pathes:
        d = os.path.join(base_dir, p)
        os.makedirs(d, exist_ok=True)
        dirs[p] = d
    return dirs


def init_log(log_dir: Optional[str] = None) -> None:
    handlers = [logging.StreamHandler()]
    if log_dir:
        handlers.append(logging.FileHandler(
            os.path.join(log_dir, f"{int(time.time())}.log")))
    logging.basicConfig(
        format="%(asctime)s [%(levelname)s] %(message)s",
        level=logging.INFO, handlers=handlers, force=True)


class MetricWriter:
    """Appends metric rows to <dir>/<name>.csv and .jsonl, and, when
    ``tb_dir`` is given and tensorboard is usable, mirrors numeric fields
    as TensorBoard scalars keyed on the row's ``step``. Where tensorboard
    is absent, or raises anything on import or construction, it writes csv
    and jsonl only and says so once."""

    _told_no_tensorboard = False

    def __init__(self, out_dir: str, name: str, tb_dir: Optional[str] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.name = name
        self.csv_path = os.path.join(out_dir, f"{name}.csv")
        self.jsonl_path = os.path.join(out_dir, f"{name}.jsonl")
        self._fields = None
        self._tb = None
        if tb_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(tb_dir, name))
            except Exception as e:  # absent, or fails to import or to build
                if not MetricWriter._told_no_tensorboard:
                    MetricWriter._told_no_tensorboard = True
                    log.info("tensorboard is not usable (%s: %s): metrics go "
                             "to csv and jsonl only", type(e).__name__, e)

    def write(self, row: Dict[str, float]) -> None:
        row = {k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in row.items()}
        new = not os.path.exists(self.csv_path)
        if self._fields is None:
            self._fields = list(row.keys())
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            step = int(row.get("step", 0))
            for k, v in row.items():
                if k != "step" and isinstance(v, float):
                    self._tb.add_scalar(f"{self.name}/{k}", v, step)
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
