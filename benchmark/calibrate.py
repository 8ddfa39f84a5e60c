"""The readings the correctness limits are set from, at a cell's own size:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        [--faults half_batch,token] [--control 1] [--sound 1] [--out FILE]

For each seed, one JSON line per variant with the numbers that decide
``correct``: ``sound`` (the program as the cell runs it, through its
set-up's checked updates), ``control`` (the reference in the program's
place, its matrix products one precision below the configuration's:
``reference/precision.py``) and each planted fault of ``faults.py``. The
cell's traffic kind reads them (``calibration_rows`` of
``traffic/<kind>.py``). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import spec


def _print(out, row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(line + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--sound", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    variants = (["sound"] if args.sound else []) + [
        f for f in args.faults.split(",") if f]
    rows = spec.traffic_runner(cell.kind).calibration_rows
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for name, numbers in rows(cell, seed, variants, args.control,
                                  torch.device(args.device)):
            _print(args.out, {"workload": cell.name, "seed": seed,
                              "variant": name, **numbers,
                              "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
