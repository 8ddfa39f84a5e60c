"""The port stands alone: no import of JAX or of the JAX package anywhere in
``deeprl_network_tpu_torch/`` or ``chip_smoke.py``, importing it loads no
JAX, and its entry points refuse to fall back to the CPU."""

import ast
import importlib
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "deeprl_network_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "deeprl_network_tpu")
# the JAX repo's root scripts/, which the port's harnesses replace
ROOT_SCRIPTS = {"scripts"} | {
    f[:-3] for f in os.listdir(os.path.join(ROOT, "scripts"))
    if f.endswith(".py")}
HARNESSES = ("train_atsc", "train_atsc_families", "ladder_atsc", "grid_demo",
             "train_cacc_families", "validate_learning", "slowdown_demo",
             "cacc_reward_decompose")


def _port_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    # "deeprl_network_tpu_torch" is its own name
    return top in BANNED or top in ROOT_SCRIPTS


def test_no_jax_imports_in_port_sources():
    offenders = []
    files = list(_port_files())
    assert len(files) > 10
    for name in HARNESSES:
        assert os.path.join(PORT, "scripts", f"{name}.py") in files, name
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [(os.path.relpath(path, ROOT), m) for m in mods
                          if _banned(m)]
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import deeprl_network_tpu_torch.utils.rollout\n"
        "import deeprl_network_tpu_torch.utils.convert\n"
        "import deeprl_network_tpu_torch.envs.grid\n"
        "import deeprl_network_tpu_torch.envs.cacc\n"
        "import deeprl_network_tpu_torch.config\n"
        "import deeprl_network_tpu_torch.envs.monaco\n"
        "import deeprl_network_tpu_torch.main\n"
        "import deeprl_network_tpu_torch.models.agents\n"
        "import deeprl_network_tpu_torch.parallel.smoke_worker\n"
        "import deeprl_network_tpu_torch.graft_entry\n"
        "import deeprl_network_tpu_torch.bench\n"
        "import deeprl_network_tpu_torch.scripts.profile_step\n"
        "import deeprl_network_tpu_torch.scripts.bench_variants\n"
        + "".join(f"import deeprl_network_tpu_torch.scripts.{name}\n"
                  for name in HARNESSES) +
        "from deeprl_network_tpu_torch.models import (\n"
        "    a2c_loss, fc_apply, one_hot, policy_step, tf1_rmsprop,\n"
        "    TF1RMSProp)\n"
        "from deeprl_network_tpu_torch.utils import Scheduler, make_schedule\n"
        "from deeprl_network_tpu_torch.ops import fused_agent_lstm\n"
        "from deeprl_network_tpu_torch.envs import Env, EnvSpec, CACCEnv\n"
        "from deeprl_network_tpu_torch.parallel import (\n"
        "    make_parallel_a2c, ParallelA2C, maybe_initialize)\n"
        "from deeprl_network_tpu_torch.ops import lstm_cell\n"
        "assert lstm_cell._lib is None, 'importing the ops loaded a kernel'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r}]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from deeprl_network_tpu_torch.config import (
        EnvConfig, ModelConfig, TrainConfig,
    )
    from deeprl_network_tpu_torch.envs.grid import LargeGridEnv
    from deeprl_network_tpu_torch.utils.rollout import make_a2c
    cfg = EnvConfig(scenario="large_grid", coop_gamma=0.9)
    with pytest.raises(RuntimeError, match="cuda"):
        LargeGridEnv(cfg)
    env = LargeGridEnv(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_a2c(env, ModelConfig(), TrainConfig(), agent="ma2c_nc")
    from deeprl_network_tpu_torch.envs.monaco import RealNetEnv
    from deeprl_network_tpu_torch.main import main
    from deeprl_network_tpu_torch.models import agents
    with pytest.raises(RuntimeError, match="cuda"):
        RealNetEnv(EnvConfig(scenario="real_net"))
    ini = os.path.join(ROOT, "configs", "config_ma2c_nc_net.ini")
    for cmd in (["train", "--config-dir", ini],
                ["evaluate", "--config-dir", ini, "--naive"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--base-dir", os.path.join(ROOT, "no_such_run")] + cmd)
    from deeprl_network_tpu_torch.bench import measure_gpu
    from deeprl_network_tpu_torch.scripts import bench_variants, profile_step
    with pytest.raises(RuntimeError, match="cuda"):
        measure_gpu()
    with pytest.raises(RuntimeError, match="cuda"):
        profile_step.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        bench_variants.main(["--variants", "bf16"])
    for name in HARNESSES:
        mod = importlib.import_module(f"deeprl_network_tpu_torch.scripts."
                                      f"{name}")
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])
    for name in ("IA2C", "IA2C_FP", "IA2C_CU", "MA2C_NC", "MA2C_CNET",
                 "MA2C_DIAL"):
        with pytest.raises(RuntimeError, match="cuda"):
            getattr(agents, name)(env.n_s_ls, env.n_a_ls, env.neighbor_mask,
                                  env.distance_mask, 0.9, total_step=100)
