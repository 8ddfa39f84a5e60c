"""Throughput sweep of the model levers on the card (the counterpart of the
JAX repo's ``scripts/bench_variants.py``): each named variant of
``VARIANTS`` runs ``bench.measure_gpu`` in turn, in ONE process, so each pays
its own warm-up but all share the card and the host.

    python -m deeprl_network_tpu_torch.scripts.bench_variants \
        --variants bf16_b256,bf16_b768 --out variants.jsonl

Each row: {"variant": ..., "env_steps_per_s": N, "loss": N, "total_s": N};
a variant the port cannot run gives {"variant": ..., "unsupported": ...},
and one that fails on the card (out of memory at the largest B, say)
{"variant": ..., "error": ...}, and the sweep goes on.

``VARIANTS`` is the JAX tool's table, key for key. The port's
``ModelConfig`` reads ``use_pallas`` and ``scan_unroll`` and ignores them
(the hand-written cell kernel runs whenever a card is present, and the
rollout is a Python loop), so ``f32`` and ``f32_pallas`` run the same
program, and so do ``bf16``, ``bf16_pallas``, ``bf16_unroll2`` and
``bf16_unroll4``. The rows stay: two identical programs measured in one
process read the run-to-run spread for free.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from deeprl_network_tpu_torch.bench import measure_gpu
from deeprl_network_tpu_torch.utils.device import resolve_device

VARIANTS = {
    # dtype, and the use_pallas flag (a no-op here)
    "f32": {},
    "bf16": {"compute_dtype": "bfloat16"},
    "f32_pallas": {"use_pallas": True},
    "bf16_pallas": {"compute_dtype": "bfloat16", "use_pallas": True},
    # 100 agents (10x10 grid) at B=128: dense vs K-packed sparse comm
    "n100_bf16": {"compute_dtype": "bfloat16", "grid_size": 10,
                  "num_envs": 128},
    "n100_bf16_sparse": {"compute_dtype": "bfloat16", "grid_size": 10,
                         "num_envs": 128, "sparse_comm": True},
    # the B knee, and the scan_unroll flag (a no-op here)
    "bf16_b256": {"compute_dtype": "bfloat16", "num_envs": 256},
    "bf16_b768": {"compute_dtype": "bfloat16", "num_envs": 768},
    "bf16_b1024": {"compute_dtype": "bfloat16", "num_envs": 1024},
    "bf16_b2048": {"compute_dtype": "bfloat16", "num_envs": 2048},
    "bf16_unroll2": {"compute_dtype": "bfloat16", "scan_unroll": 2},
    "bf16_unroll4": {"compute_dtype": "bfloat16", "scan_unroll": 4},
    "bf16_b1024_unroll2": {"compute_dtype": "bfloat16", "num_envs": 1024,
                           "scan_unroll": 2},
    # sparse_comm and remat alone, then stacked with B=768
    "bf16_sparse": {"compute_dtype": "bfloat16", "sparse_comm": True},
    "bf16_remat": {"compute_dtype": "bfloat16", "remat": True},
    "bf16_b768_remat": {"compute_dtype": "bfloat16", "num_envs": 768,
                        "remat": True},
    "bf16_b768_sparse_remat": {"compute_dtype": "bfloat16",
                               "num_envs": 768, "sparse_comm": True,
                               "remat": True},
    "bf16_sparse_remat": {"compute_dtype": "bfloat16",
                          "sparse_comm": True, "remat": True},
    "bf16_b2048_remat": {"compute_dtype": "bfloat16", "num_envs": 2048,
                         "remat": True},
    "bf16_b1024_sparse_remat": {"compute_dtype": "bfloat16",
                                "num_envs": 1024, "sparse_comm": True,
                                "remat": True},
    # N-scaling at the flagship levers, N*B held near 19.2k
    "n25_flag_dense": {"compute_dtype": "bfloat16", "num_envs": 768,
                       "remat": True},
    "n25_flag_sparse": {"compute_dtype": "bfloat16", "num_envs": 768,
                        "sparse_comm": True, "remat": True},
    "n49_flag_dense": {"compute_dtype": "bfloat16", "grid_size": 7,
                       "num_envs": 384, "remat": True},
    "n49_flag_sparse": {"compute_dtype": "bfloat16", "grid_size": 7,
                        "num_envs": 384, "sparse_comm": True,
                        "remat": True},
    "n100_flag_dense": {"compute_dtype": "bfloat16", "grid_size": 10,
                        "num_envs": 192, "remat": True},
    "n100_flag_sparse": {"compute_dtype": "bfloat16", "grid_size": 10,
                         "num_envs": 192, "sparse_comm": True,
                         "remat": True},
    # larger B at N=100 under sparse comm
    "n100_flag_sparse_b384": {"compute_dtype": "bfloat16",
                              "grid_size": 10, "num_envs": 384,
                              "sparse_comm": True, "remat": True},
    "n100_flag_sparse_b768": {"compute_dtype": "bfloat16",
                              "grid_size": 10, "num_envs": 768,
                              "sparse_comm": True, "remat": True},
    # the CACC platoon (8 agents): its B knee
    "cacc_f32_b64": {"scenario": "cacc_catchup", "num_envs": 64},
    "cacc_bf16_b256": {"scenario": "cacc_catchup", "num_envs": 256,
                       "compute_dtype": "bfloat16"},
    "cacc_bf16_b1024": {"scenario": "cacc_catchup", "num_envs": 1024,
                        "compute_dtype": "bfloat16"},
    "cacc_bf16_b4096": {"scenario": "cacc_catchup", "num_envs": 4096,
                        "compute_dtype": "bfloat16"},
    "cacc_bf16_b8192": {"scenario": "cacc_catchup", "num_envs": 8192,
                        "compute_dtype": "bfloat16"},
    "cacc_bf16_b4096_remat": {"scenario": "cacc_catchup",
                              "num_envs": 4096,
                              "compute_dtype": "bfloat16", "remat": True},
    "cacc_bf16_b8192_remat": {"scenario": "cacc_catchup",
                              "num_envs": 8192,
                              "compute_dtype": "bfloat16", "remat": True},
    "cacc_bf16_b16384": {"scenario": "cacc_catchup", "num_envs": 16384,
                         "compute_dtype": "bfloat16"},
    "cacc_f32_b4096": {"scenario": "cacc_catchup", "num_envs": 4096},
}


def run_variant(name, seconds, num_envs, device="cuda", measure=measure_gpu):
    """The row of one variant: ``measure`` (``measure_gpu``'s signature)
    on ``device`` with the variant's overrides; ``num_envs``, ``grid_size``
    and ``scenario`` from the variant where it names them."""
    over = dict(VARIANTS[name])
    kw = dict(seconds_budget=seconds,
              num_envs=over.pop("num_envs", num_envs),
              grid_size=over.pop("grid_size", 5),
              scenario=over.pop("scenario", "grid"), device=device)
    t0 = time.time()
    try:
        sps, loss = measure(**kw, **over)
    except ValueError as e:
        # the one unsupported combination is bf16 with fused_grad=False;
        # any other ValueError is a configuration error and propagates
        if "fused-gradient path only" not in str(e):
            raise
        return {"variant": name, "unsupported": str(e)}
    except RuntimeError as e:
        # failures on the card (torch.cuda.OutOfMemoryError is one) are
        # recorded and the sweep goes on. Programming errors (TypeError,
        # AttributeError from a mistyped override) propagate.
        row = {"variant": name, "error": f"{type(e).__name__}: {e}"[:400]}
    else:
        return {"variant": name, "env_steps_per_s": round(sps, 1),
                "loss": round(loss, 3),
                "total_s": round(time.time() - t0, 1)}
    # hand the failed variant's memory back before the next one: its frames
    # die with the exception, then the allocator's cache is emptied
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return row


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=45.0,
                   help="measure window per variant; 45 s, as bench.py")
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--variants",
                   default="f32,bf16,f32_pallas,bf16_pallas,"
                           "n100_bf16,n100_bf16_sparse")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = resolve_device(device)    # no card: fail here, not per row

    sink = open(args.out, "a") if args.out else sys.stdout

    def emit(row):
        print(json.dumps(row), file=sink, flush=True)
        if sink is not sys.stdout:
            print(json.dumps(row), file=sys.stderr, flush=True)

    try:
        emit({"run": vars(args)})
        for name in args.variants.split(","):
            emit(run_variant(name.strip(), args.seconds, args.num_envs,
                             device))
    finally:
        if sink is not sys.stdout:
            sink.close()


if __name__ == "__main__":
    main()
