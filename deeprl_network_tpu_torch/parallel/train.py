"""Data-parallel training over ``torch.distributed`` (counterpart of
``deeprl_network_tpu/parallel/train.py``, which shards the env batch over a
device mesh under ``shard_map``).

The reference has no distributed training (SURVEY.md section 2.1). Here,
as in the JAX package, env instances are split over the ranks and learner
params stay replicated: the model is ~100k params, so pure data
parallelism is the right point in design space. Each rank runs the fused
train step (``utils/rollout.py``) on its slice of the global batch, with one
gradient ``all_reduce`` per update.

Every rank seeds the same generator and draws each noise tensor at the
GLOBAL batch shape, keeping its own rows; params are drawn from the shared
seed and broadcast from rank 0, so every replica starts bit-identical.
Consequence: the same global batch runs the same trajectories on any world
size, and an N-rank update equals the 1-rank update on the combined batch
up to float reassociation (``tests/test_torch_parallel.py``).

    maybe_initialize()          # under torchrun, or with explicit args
    par = make_parallel_a2c(env, mcfg, tcfg, "ma2c_nc")
    ts = par.init_state(seed)
    ts, metrics = par.train_step(ts)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from deeprl_network_tpu_torch.config import ModelConfig, TrainConfig
from deeprl_network_tpu_torch.models.policies import (
    PolicyParams, init_policy_params, tree_leaves, tree_unflatten,
)
from deeprl_network_tpu_torch.parallel import distributed
from deeprl_network_tpu_torch.utils.rollout import (
    A2CFns, TrainState, make_a2c,
)

DATA_AXIS = "data"


class ParallelA2C(NamedTuple):
    init_state: Callable[..., TrainState]
    train_step: Callable
    eval_episode: Callable
    record_episode: Callable
    fns: A2CFns          # the underlying single-replica functions
    world_size: int

    @property
    def spec(self):
        return self.fns.spec

    @property
    def spans(self):
        return self.fns.spans

    @property
    def steps_per_update(self) -> int:
        # already GLOBAL steps: make_a2c was given n_replicas = world size
        return self.fns.steps_per_update


def make_parallel_a2c(env, mcfg: ModelConfig, tcfg: TrainConfig, agent: str,
                      envs_per_rank: Optional[int] = None, jit: bool = True,
                      device="cuda") -> ParallelA2C:
    """Data-parallel A2C over the default process group; the global batch
    is ``envs_per_rank`` x world size (default: ``mcfg.num_envs`` split
    evenly). ``jit`` as in ``make_a2c``: under NCCL the gradient all-reduce
    is captured in the update's CUDA graph; gloo on CUDA tensors needs
    ``jit=False``."""
    if not torch.distributed.is_initialized():
        raise ValueError("make_parallel_a2c needs the default process "
                         "group: call deeprl_network_tpu_torch.parallel."
                         "distributed.maybe_initialize() first")
    n = distributed.world_size()
    if envs_per_rank is None:
        if mcfg.num_envs % n != 0:
            raise ValueError(
                f"num_envs={mcfg.num_envs} (the GLOBAL env batch) must be "
                f"divisible by the world size {n}; pick a multiple or "
                f"pass envs_per_rank explicitly")
        envs_per_rank = mcfg.num_envs // n
    fns = make_a2c(env, mcfg, tcfg, agent=agent, num_envs=envs_per_rank,
                   axis_name=DATA_AXIS, n_replicas=n, jit=jit,
                   device=device)
    offset = distributed.rank() * envs_per_rank

    def init_state(seed: int = 0, params: Optional[PolicyParams] = None
                   ) -> TrainState:
        """Params from ``seed`` unless given, then rank 0's broadcast to
        all; this rank's rows of the global batch's env reset."""
        if params is None:
            params = init_policy_params(torch.Generator().manual_seed(seed),
                                        fns.spec, device=env.device)
        leaves = [p.detach().to(env.device, torch.float32)
                  for p in tree_leaves(params)]
        params = tree_unflatten(params, distributed.broadcast(leaves))
        return fns.init_state(seed, params=params, env_offset=offset)

    return ParallelA2C(
        init_state=init_state, train_step=fns.train_step,
        eval_episode=fns.eval_episode, record_episode=fns.record_episode,
        fns=fns, world_size=n)
