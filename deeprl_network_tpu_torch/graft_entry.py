"""Smoke entry points of the port (counterpart of ``__graft_entry__.py``):
a single-card forward check and a multi-rank dry run.

- :func:`entry` returns the flagship model's single-env policy forward
  (``models/policies.policy_step``: MA2C_NC / NeurComm over the 25-agent 5x5
  grid, 64/64) with example args on the card.
- :func:`dryrun_multichip` runs n ranks of ONE full data-parallel training
  step (rollout, BPTT, gradient all-reduce, RMSProp) at tiny shapes with the
  flagship's levers (``sparse_comm``, ``remat``), one env a rank.

    python -m deeprl_network_tpu_torch.graft_entry     # needs a card
"""

from __future__ import annotations

import math
import tempfile
from typing import Optional

import torch

TINY_SPEC = dict(
    agent="ma2c_nc",
    env=dict(scenario="large_grid", coop_gamma=0.9, episode_length_sec=300),
    # the dry run exercises the flagship lever set, so it checks the
    # data-parallel path the bench configuration runs
    model=dict(batch_size=8, num_fc=8, num_lstm=8, sparse_comm=True,
               remat=True),
    updates=1)


def entry(device="cuda"):
    """(fn, example_args): the flagship policy forward for ONE env instance
    with the JAX entry's shapes (obs [N, S], carry [N, H] x2, fp [N, A],
    done 0-dim). The params pass ``mask_comm_params`` once, here, as the
    JAX entry's params come masked from ``init_policy_params``."""
    from deeprl_network_tpu_torch.config import EnvConfig, ModelConfig
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.models.policies import (
        Carry, init_fingerprint, init_policy_params, mask_comm_params,
        policy_consts, policy_step,
    )
    from deeprl_network_tpu_torch.utils.rollout import make_policy_spec

    env = LargeGridEnv(EnvConfig(scenario="large_grid", coop_gamma=0.9),
                       device=device)
    spec = make_policy_spec(env.spec, ModelConfig(num_fc=64, num_lstm=64),
                            "ma2c_nc")
    dev = env.device
    consts = policy_consts(spec, dev)
    params = mask_comm_params(
        spec, init_policy_params(torch.Generator().manual_seed(0), spec,
                                 device=dev), consts)
    zeros = lambda: torch.zeros((spec.n_agent, spec.n_lstm), device=dev)
    carry = Carry(zeros(), zeros())
    fp = init_fingerprint(spec, device=dev)
    obs = torch.zeros((spec.n_agent, spec.n_s_max), device=dev)
    done = torch.zeros((), device=dev)

    def fn(params, carry, obs, fp, done):
        return policy_step(spec, params, carry, obs, fp, done, consts)

    return fn, (params, carry, obs, fp, done)


def dryrun_multichip(n: int, device="cuda", backend: Optional[str] = None):
    """One data-parallel train step on ``n`` ranks, tiny shapes, one env a
    rank. With fewer cards than ranks the ranks share ``cuda:0`` under
    gloo; with a card each, each rank takes its own under NCCL. Returns the
    ranks' result lines (``parallel/smoke_worker.py``)."""
    from deeprl_network_tpu_torch.parallel.smoke_worker import run_ranks
    if backend is None:
        backend = ("nccl" if device == "cuda"
                   and torch.cuda.device_count() >= n else "gloo")
    if device == "cuda":
        # build the kernels once here, not in every rank at once
        from deeprl_network_tpu_torch.ops import _build
        _build.build()
    spec = dict(TINY_SPEC, model=dict(TINY_SPEC["model"], num_envs=n))
    with tempfile.TemporaryDirectory() as out:
        results = run_ranks(n, spec, out, device=device, backend=backend,
                            timeout=300)
    for r in results:
        loss = r["metrics"][-1]["loss"]
        if not math.isfinite(loss):
            raise AssertionError(f"rank {r['rank']}: non-finite loss {loss}")
        if r["step"] != 8 * n:
            raise AssertionError(f"rank {r['rank']}: step {r['step']}, "
                                 f"expected {8 * n}")
    if len({r["params_sha256"] for r in results}) != 1:
        raise AssertionError("the ranks' params differ after the step")
    print(f"dryrun_multichip({n}): ok, backend={backend}, "
          f"loss={results[0]['metrics'][-1]['loss']:.4f}, "
          f"step={results[0]['step']}", flush=True)
    return results


if __name__ == "__main__":
    fn, args = entry()
    carry, logits, values = fn(*args)
    print("entry ok:", tuple(carry.h.shape), tuple(logits.shape),
          tuple(values.shape))
    dryrun_multichip(max(torch.cuda.device_count(), 2))
