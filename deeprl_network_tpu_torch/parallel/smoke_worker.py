"""One rank of a short data-parallel run, and ``launch``, which starts N ranks
and waits for them.

    python -m deeprl_network_tpu_torch.parallel.smoke_worker \\
        --device cpu --backend gloo --out DIR --spec '{"agent": "ma2c_nc", ...}'

The rank and the world come from torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), which
``launch`` sets as torchrun would. The spec (JSON) names the run:

- ``agent``; ``env``, ``model``, ``train``: ``EnvConfig`` / ``ModelConfig`` /
  ``TrainConfig`` fields (``model.num_envs`` is the global batch);
- ``seed`` (0) and ``updates`` (1): ``make_parallel_a2c(...).init_state(seed)``
  and that many ``train_step`` calls;
- ``params``: an ``.npz`` of the initial params (``p0``, ``p1``, ... in
  ``tree_leaves`` order) instead of drawing them from the seed;
- ``gumbel``: an ``.npz`` whose ``gumbel`` [updates, T, global B, N, A] is
  the sampling noise; each rank takes its rows;
- ``restore``: a checkpoint dir to restore the state from before the
  updates; ``ckpt``: a dir to save the final state into, restore it, and
  check the round trip.

Under NCCL the update is one CUDA graph (``make_parallel_a2c``'s ``jit``);
gloo, whose all-reduce stages through the host, runs eagerly (``jit=False``).
Under a graph the env step and the all-reduce run in Python only at the
graph's warm-up and capture, so the actions are not recorded, and the
launch and all-reduce counts are those issued or captured: two updates'
worth.

Each rank writes ``DIR/rank<r>.npz`` (final params ``p<i>``, per-env fields
``<field><j>``, the sampled ``actions`` [updates x T, B, N] without ``jit``,
per-update ``loss``) and prints ONE JSON line: metrics and wall time per update, the
kernels' launch counts (cell and env step), a digest of the params, the
gradient all-reduce's size, calls (issued or captured) and time. Any
failure exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeprl_network_tpu_torch.config import (
    Config, EnvConfig, ModelConfig, TrainConfig,
)
from deeprl_network_tpu_torch.main import init_env
from deeprl_network_tpu_torch.models.policies import (
    init_policy_params, tree_leaves, tree_unflatten,
)
from deeprl_network_tpu_torch.ops import (
    cacc_env, comm_embed, dial_head, lstm_cell, network_env,
)
from deeprl_network_tpu_torch.parallel import distributed
from deeprl_network_tpu_torch.parallel.train import make_parallel_a2c
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.rollout import PER_ENV_FIELDS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "deeprl_network_tpu_torch.parallel.smoke_worker"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _per_env_leaves(ts) -> Dict[str, torch.Tensor]:
    return {f"{f}{j}": leaf for f in PER_ENV_FIELDS
            for j, leaf in enumerate(tree_leaves(getattr(ts, f)))}


def _same_state(a, b) -> bool:
    pairs = (list(zip(tree_leaves(a.params), tree_leaves(b.params)))
             + list(zip(a.opt_state.ms, b.opt_state.ms))
             + list(zip(_per_env_leaves(a).values(),
                        _per_env_leaves(b).values())))
    return (all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)
            and torch.equal(a.generator.get_state(), b.generator.get_state())
            and a.step == b.step and a.opt_state.count == b.opt_state.count)


def run(spec: dict, device: str, out_dir: str) -> dict:
    """This rank's part of the run ``spec`` describes; returns its result
    line."""
    r = distributed.rank()
    dev = distributed.local_device(resolve_device(device))
    cfg = Config(agent=spec["agent"], env=EnvConfig(**spec.get("env", {})),
                 model=ModelConfig(**spec.get("model", {})),
                 train=TrainConfig(**spec.get("train",
                                              {"total_step": 10_000})))
    env = init_env(cfg, device=dev)
    jit = dist.get_backend() != "gloo"
    par = make_parallel_a2c(env, cfg.model, cfg.train, cfg.agent, jit=jit,
                            device=dev)
    params = None
    if spec.get("params"):
        stored = np.load(spec["params"])
        like = init_policy_params(torch.Generator(), par.spec, device=dev)
        params = tree_unflatten(like, [
            torch.as_tensor(stored[f"p{i}"], device=dev)
            for i in range(len(tree_leaves(like)))])
    ts = par.init_state(spec.get("seed", 0), params=params)
    if spec.get("restore"):
        ts = CheckpointManager(spec["restore"]).restore(ts)
        if ts is None:
            raise FileNotFoundError(f"no checkpoint in {spec['restore']}")
    b = ts.obs.shape[0]
    gumbel = None
    if spec.get("gumbel"):
        gumbel = np.load(spec["gumbel"])["gumbel"][:, :, r * b:(r + 1) * b]

    # record the sampled actions at the env (at its fused auto-reset step
    # where it has one), and the size of every gradient all-reduce at the
    # collective
    actions, reduced = [], []
    step_name = "step_autoreset" if hasattr(env, "step_autoreset") \
        else "step"
    env_step, reduce_mean = getattr(env, step_name), \
        distributed.all_reduce_mean

    def recording_step(state, action, *rest):
        actions.append(action.to(torch.uint8))
        return env_step(state, action, *rest)

    def counting_reduce(tensors):
        reduced.append(sum(t.numel() for t in tensors))
        return reduce_mean(tensors)

    if not jit:
        setattr(env, step_name, recording_step)
    distributed.all_reduce_mean = counting_reduce
    for counts in (lstm_cell.LAUNCHES, network_env.LAUNCHES,
                   cacc_env.LAUNCHES, comm_embed.LAUNCHES,
                   dial_head.LAUNCHES):
        for k in counts:
            counts[k] = 0
    metrics, update_s = [], []
    try:
        for u in range(spec.get("updates", 1)):
            g = None if gumbel is None else torch.as_tensor(gumbel[u])
            _sync(dev)
            t0 = time.perf_counter()
            ts, m = par.train_step(ts, gumbel=g)
            _sync(dev)
            update_s.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        if not jit:
            delattr(env, step_name)
        distributed.all_reduce_mean = reduce_mean
    launches = {k: v for k, v in {**lstm_cell.LAUNCHES,
                                  **network_env.LAUNCHES,
                                  **cacc_env.LAUNCHES,
                                  **comm_embed.LAUNCHES,
                                  **dial_head.LAUNCHES}.items() if v}
    # under a graph: issued by the warm-up and captured, then run by every
    # replay without Python
    if len(reduced) != (2 if jit and metrics else len(metrics)):
        raise AssertionError(f"{len(reduced)} gradient all-reduces issued "
                             f"or captured in {len(metrics)} updates "
                             f"(jit={jit})")

    if spec.get("ckpt"):
        ckpt = CheckpointManager(spec["ckpt"])
        ckpt.save(ts.step, ts)
        back = ckpt.restore(ts)
        if back is None or not _same_state(back, ts):
            raise AssertionError("the checkpoint round trip changed the "
                                 "state")

    # the all-reduce's own time: the same buffer, 20 calls after a barrier
    buf = torch.ones(reduced[0], device=dev)
    for _ in range(3):
        dist.all_reduce(buf)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(20):
        dist.all_reduce(buf)
    _sync(dev)
    allreduce_ms = (time.perf_counter() - t0) / 20 * 1e3

    leaves = [p.detach().cpu() for p in tree_leaves(ts.params)]
    digest = hashlib.sha256()
    for p in leaves:
        digest.update(p.numpy().tobytes())
    arrays = {f"p{i}": p.numpy() for i, p in enumerate(leaves)}
    for k, v in _per_env_leaves(ts).items():
        arrays[k] = (v.float() if v.dtype == torch.bfloat16 else v).cpu() \
            .numpy()
    if actions:
        arrays["actions"] = torch.stack(actions).cpu().numpy()
    arrays["loss"] = np.array([m["loss"] for m in metrics])
    npz = os.path.join(out_dir, f"rank{r}.npz")
    np.savez(npz, **arrays)
    return {"rank": r, "world_size": par.world_size,
            "backend": dist.get_backend(), "device": str(dev), "envs": b,
            "step": ts.step, "steps_per_update": par.steps_per_update,
            "metrics": metrics, "update_s": update_s, "launches": launches,
            "params_sha256": digest.hexdigest(),
            "jit": jit,
            "allreduce": {"calls": len(reduced), "floats": reduced[0],
                          "bytes": 4 * reduced[0], "ms": allreduce_ms},
            "npz": npz}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", required=True, help="the run, as JSON")
    ap.add_argument("--out", required=True, help="directory for rank<r>.npz")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: NCCL with a card, else gloo; gloo lets "
                         "ranks share one card")
    args = ap.parse_args(argv)
    if not distributed.maybe_initialize(backend=args.backend):
        raise RuntimeError("no process group: start the ranks with launch() "
                           "or torchrun")
    try:
        result = run(json.loads(args.spec), args.device, args.out)
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(n: int, argv: List[str], log_dir: str, timeout: float = 180.0,
           env: Optional[dict] = None) -> List[str]:
    """Run ``python <argv>`` as ranks 0..n-1 of one process group (torchrun's
    variables set, on this host), from the repository root; each rank's
    output goes to ``log_dir/rank<r>.{out,err}``. Waits for all of them and
    returns their standard outputs. The first rank to fail, or the
    ``timeout`` (seconds), kills every rank and raises."""
    os.makedirs(log_dir, exist_ok=True)
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, base.get("PYTHONPATH")) if p)
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(n))
    # every rank is on this host: bootstrap over the loopback interface
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        base.setdefault(var, "lo")
    paths = [(os.path.join(log_dir, f"rank{r}.out"),
              os.path.join(log_dir, f"rank{r}.err")) for r in range(n)]
    procs = []
    try:
        for r, (out, err) in enumerate(paths):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], cwd=ROOT, stdout=fo, stderr=fe,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        deadline = time.monotonic() + timeout
        timed_out = False
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                failed = [r for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        tails = []
        for r in failed:
            with open(paths[r][1]) as f:
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                             + f.read()[-4000:])
        what = f"timed out after {timeout} s" if timed_out else "failed"
        raise RuntimeError(f"{n} ranks of {' '.join(argv)}: {what}\n"
                           + "\n".join(tails))
    outs = []
    for out, _ in paths:
        with open(out) as f:
            outs.append(f.read())
    return outs


def run_ranks(n: int, spec: dict, out_dir: str, device: str = "cuda",
              backend: Optional[str] = None, timeout: float = 180.0,
              env: Optional[dict] = None) -> List[dict]:
    """``n`` worker ranks of ``spec``; their result lines, by rank."""
    argv = ["-m", MODULE, "--spec", json.dumps(spec), "--out", out_dir,
            "--device", device]
    if backend:
        argv += ["--backend", backend]
    outs = launch(n, argv, out_dir, timeout, env)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


if __name__ == "__main__":
    sys.exit(main())
