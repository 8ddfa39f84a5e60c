"""CLI / experiment runner (counterpart of ``deeprl_network_tpu/main.py``;
reference main.py, SURVEY.md section 2.2 item 1): ``train`` and ``evaluate``
subcommands over .ini config files.

    python -m deeprl_network_tpu_torch.main --base-dir /tmp/run train \
        --config-dir configs/config_ma2c_nc_grid.ini
    python -m deeprl_network_tpu_torch.main --base-dir /tmp/run evaluate \
        --evaluation-seeds 2000,2500,3000

Everything runs on the CUDA card unless ``--device cpu`` is given (before
the subcommand); without a card and without that option the command fails.
Under torchrun, ``train`` is data-parallel over the ranks (NCCL, one card
a rank; gloo with ``--device cpu``); ``num_envs`` is the global batch:

    torchrun --nproc_per_node=G -m deeprl_network_tpu_torch.main \
        --base-dir /tmp/run train --config-dir configs/config_ma2c_nc_grid.ini
"""

from __future__ import annotations

import argparse
import copy
import glob
import logging
import os
import shlex
import sys

import torch

from deeprl_network_tpu_torch.config import Config, load_config, save_config
from deeprl_network_tpu_torch.envs.base import Env
from deeprl_network_tpu_torch.parallel.distributed import (
    is_primary, local_device, maybe_initialize, world_size,
)
from deeprl_network_tpu_torch.parallel.train import make_parallel_a2c
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.logging import init_dir, init_log
from deeprl_network_tpu_torch.utils.rollout import make_a2c
from deeprl_network_tpu_torch.utils.trainer import Evaluator, Trainer

log = logging.getLogger(__name__)


def init_env(config: Config, naive_policy: bool = False,
             device="cuda") -> Env:
    """Dispatch on scenario (reference main.py init_env ~L40)."""
    scenario = config.env.scenario
    if scenario.startswith("cacc"):
        from deeprl_network_tpu_torch.envs.cacc import CACCEnv
        return CACCEnv(config.env, device=device)
    if scenario in ("large_grid", "grid"):
        from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
        return LargeGridEnv(config.env, device=device)
    if scenario in ("real_net", "monaco"):
        from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
        return RealNetEnv(config.env, device=device)
    raise ValueError(f"unknown scenario {scenario}")


def init_agent(env: Env, config: Config, num_envs=None, axis_name=None,
               device="cuda"):
    """Build the fused A2C functions (reference main.py init_agent ~L60)."""
    return make_a2c(env, config.model, config.train, agent=config.agent,
                    num_envs=num_envs, axis_name=axis_name, device=device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base-dir", required=True, help="experiment dir")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where envs, params and updates live; 'cuda' "
                        "(default) fails without a card")
    sub = p.add_subparsers(dest="option", required=True)
    t = sub.add_parser("train")
    t.add_argument("--config-dir", required=True, help=".ini config path")
    t.add_argument("--restore", action="store_true")
    t.add_argument("--test-mode", default="no_test",
                   choices=["no_test", "in_train_test"])
    t.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of three updates "
                        "at startup into base-dir/log/trace.json")
    t.add_argument("--single-device", action="store_true",
                   help="disable automatic data-parallel training over "
                        "the ranks when started by torchrun (then run "
                        "without torchrun: one process, one device)")
    e = sub.add_parser("evaluate")
    e.add_argument("--config-dir", default=None,
                   help="defaults to the snapshot in base-dir/data")
    e.add_argument("--agents", default=None,
                   help="comma list of run subdirectories under base-dir "
                        "to evaluate in turn (reference main.py evaluate "
                        "--agents); default: base-dir itself is the run")
    e.add_argument("--evaluation-seeds", default="2000,2500,3000")
    e.add_argument("--demo", action="store_true")
    e.add_argument("--naive", action="store_true",
                   help="evaluate the env's greedy controller baseline "
                        "(reference naive_policy path)")
    return p.parse_args(argv)


def train(args) -> None:
    n_ranks = world_size()
    if n_ranks > 1 and args.single_device:
        raise ValueError("--single-device trains in one process: run it "
                         "without torchrun")
    device = local_device(resolve_device(args.device))
    # only the primary rank writes the run dir's logs and config snapshot
    primary = is_primary()
    dirs = init_dir(args.base_dir)
    init_log(dirs["log"] if primary else None)
    config = load_config(args.config_dir)
    if primary:
        save_config(config, os.path.join(dirs["data"],
                                         os.path.basename(args.config_dir)))
    env = init_env(config, device=device)
    if n_ranks > 1:
        # the env batch split over the ranks (config num_envs is the
        # GLOBAL batch and must divide by the world size), params
        # replicated, grads averaged by one all_reduce an update
        fns = make_parallel_a2c(env, config.model, config.train,
                                agent=config.agent, device=device)
        log.info("data-parallel over %d ranks (%d envs a rank)", n_ranks,
                 config.model.num_envs // n_ranks)
    else:
        if device.type == "cuda" and torch.cuda.device_count() > 1:
            log.info(
                "%d CUDA devices visible: training on %s alone; to train "
                "on all of them: torchrun --nproc_per_node=%d -m "
                "deeprl_network_tpu_torch.main %s",
                torch.cuda.device_count(), env.device,
                torch.cuda.device_count(), shlex.join(args.argv))
        fns = init_agent(env, config, device=device)
    log.info("agent=%s scenario=%s n_agent=%d device=%s",
             config.agent, config.scenario, env.n_agent, env.device)
    trainer = Trainer(fns, config, args.base_dir, seed=config.env.seed,
                      profile=args.profile,
                      in_train_test=args.test_mode == "in_train_test")
    trainer.run(restore=args.restore)


def evaluate(args) -> None:
    if world_size() > 1:
        raise ValueError("evaluate runs in one process: run it without "
                         "torchrun")
    if args.agents:
        for name in args.agents.split(","):
            if not name.strip():
                continue
            sub_args = copy.copy(args)
            sub_args.agents = None
            sub_args.base_dir = os.path.join(args.base_dir, name.strip())
            evaluate(sub_args)
        return
    device = resolve_device(args.device)
    init_log(None)
    cfg_path = args.config_dir
    if cfg_path is None:
        cands = glob.glob(os.path.join(args.base_dir, "data", "*.ini"))
        if not cands:
            raise FileNotFoundError("no config snapshot in base-dir/data")
        cfg_path = cands[0]
    config = load_config(cfg_path)
    env = init_env(config, device=device)
    fns = init_agent(env, config, device=device)
    seeds = [int(s) for s in args.evaluation_seeds.split(",")]
    out_dir = os.path.join(args.base_dir, "eva_data")
    eval_kw = dict(seeds=seeds, demo=args.demo, scenario=config.scenario,
                   control_interval_sec=config.env.control_interval_sec)
    if args.naive:
        # greedy-controller baseline, no model needed (reference
        # main.py init_env(naive_policy=True) + greedy controllers)
        Evaluator(fns, out_dir, policy="controller", agent="greedy",
                  **eval_kw).run(None)
        return
    ts = fns.init_state(config.env.seed)
    # params-only restore: reads checkpoints whose env batch differs from
    # this state's, written on any device
    ckpt = CheckpointManager(os.path.join(args.base_dir, "model"))
    params = ckpt.restore_params(ts.params)
    if params is None:
        raise FileNotFoundError("no checkpoint found under base-dir/model")
    Evaluator(fns, out_dir, agent=config.agent, **eval_kw).run(params)


def main(argv=None):
    args = parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    # data parallelism: join the ranks before any device use (no-op unless
    # torchrun's variables are present); ranks on the CPU talk over gloo
    if not maybe_initialize(backend="gloo" if args.device == "cpu"
                            else None):
        return run(args)
    try:
        run(args)
    finally:
        torch.distributed.destroy_process_group()


def run(args) -> None:
    if args.option == "train":
        train(args)
    else:
        evaluate(args)


if __name__ == "__main__":
    main()
