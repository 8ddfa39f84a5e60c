"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in ``BENCHMARK.json``, its configuration under
``configs/`` and its traffic under ``workloads/``, hands both to the
traffic kind's runner under ``traffic/``, and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, each read by its reader under ``metrics/``), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number that
decided ``correct`` with its limit, which also end standard error.

It exits 2 without a result where the card or the cards the cell asks for
are missing, and 3 where JAX, flax or the JAX package is loaded once the
window has closed. Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import nojax, spec  # noqa: E402

CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton"}


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fix_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc builds already lie in it)."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(root, ".bench_cache", sub)


def per_layer_values(cell, obs) -> dict:
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def assemble(cell, out: dict, trace_on: bool, device_name: str) -> dict:
    """The result line's object from a runner's output."""
    from benchmark import judge, trace
    device = {"platform": "gpu", "kind": device_name, "count": out["count"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": judge.verdict(out["numbers"], cell.limits),
              "attempted": out["attempted"], "failed": out["failed"]}
    if trace_on:
        result["metrics"] = per_layer_values(cell, out["obs"])
        summ = trace.summary(out["obs"]["trace"])
        device["busy_s"] = summ["busy_s"]
        device["window_s"] = summ["window_s"]
        result["device"] = device
        result["breakdown"] = {"device_ops": summ["device_ops"],
                               "idle_gaps": summ["idle_gaps"]}
    else:
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device
    result["checks"] = judge.as_json(out["numbers"], cell.limits)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    found = nojax.offenders()
    if found:
        print(f"refused: loaded before start-up: {found}", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    fix_caches(spec.ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"refused: {cell.name} needs {cell.chips} CUDA card(s), "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    runner = spec.traffic_runner(cell.kind)
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     T_START)
    found = nojax.offenders()
    if found:
        print(f"refused: loaded by the run: {found}", file=sys.stderr)
        return 3
    result = assemble(cell, out, bool(args.trace),
                      torch.cuda.get_device_name(0))
    for line in out.get("notes", []):
        print(line, file=sys.stderr)
    from benchmark import judge
    print("\n".join(judge.lines(out["numbers"], cell.limits)),
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
