"""Typed configuration, .ini-compatible with the reference configs.

A copy of ``deeprl_network_tpu/config.py`` (the port imports nothing of the
JAX package): the same three ``[ENV_CONFIG]`` / ``[MODEL_CONFIG]`` /
``[TRAIN_CONFIG]`` sections of ``configs/*.ini`` parse into the same frozen
dataclasses with the same field names and defaults, so one .ini file
configures both packages.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _parse_scalar(v: str):
    s = v.strip()
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _parse_list(v: str, typ=float):
    return [typ(x) for x in v.replace(" ", "").split(",") if x != ""]


@dataclass(frozen=True)
class ModelConfig:
    """[MODEL_CONFIG]: optimizer, network widths, rollout length and the
    compute options of the fused train step."""

    rmsp_alpha: float = 0.99
    rmsp_epsilon: float = 1e-5
    max_grad_norm: float = 40.0
    gamma: float = 0.99
    lr_init: float = 5e-4
    lr_min: float = 0.0
    lr_decay: str = "constant"  # constant | linear
    entropy_coef: float = 0.01
    entropy_decay: str = "constant"
    entropy_ratio: float = 0.5
    value_coef: float = 0.5
    num_lstm: int = 64
    num_fc: int = 64
    batch_size: int = 120  # n_step rollout length T
    reward_norm: float = 2000.0
    reward_clip: float = 2.0
    neighbor_obs: bool = False   # alpha-scaled neighbour observations
    consensus_masked: bool = True  # shape-aware IA2C_CU weight consensus
    num_envs: int = 1            # B parallel env instances
    remat: bool = False          # recompute each step's policy activations
                                 # in the backward pass
    sparse_comm: bool = False    # pack per-edge comm blocks to the
                                 # neighbour lists [N, K=max_degree]
    use_pallas: bool = False     # read for .ini compatibility; the port
                                 # always runs its LSTM cell kernel on a
                                 # CUDA device
    compute_dtype: str = "float32"  # "bfloat16": policy compute in bf16
                                 # with f32 master params
    switch_penalty: float = 0.0  # training-only switch-cost shaping
    kickstart_coef: float = 0.0  # training-only CE toward the hand
                                 # controller
    kickstart_ratio: float = 0.5
    scan_unroll: int = 1         # read for .ini compatibility
    fused_grad: bool = True      # differentiate through the rollout
                                 # itself (no replay pass)

    @property
    def n_step(self) -> int:
        return self.batch_size


@dataclass(frozen=True)
class TrainConfig:
    """[TRAIN_CONFIG]: step budget and host-loop cadences."""

    total_step: int = 1_000_000
    test_interval: int = 20_000
    log_interval: int = 10_000
    save_interval: int = 0


@dataclass(frozen=True)
class EnvConfig:
    """[ENV_CONFIG]: superset of the CACC and ATSC keys; each env reads the
    keys of its own scenario."""

    scenario: str = "cacc_catchup"
    coop_gamma: float = -1.0
    seed: int = 12
    test_seeds: Tuple[int, ...] = (2000, 2500, 3000)

    # --- CACC ---
    n_vehicle: int = 8
    dt: float = 0.1
    episode_length: int = 600        # steps (60 s at dt=0.1)
    h_star: float = 20.0
    v_star: float = 15.0
    h_st: float = 5.0
    h_go: float = 35.0
    v_max: float = 30.0
    u_max: float = 2.5
    h_min: float = 1.0               # collision threshold
    catchup_ratio: float = 2.0
    slowdown_v0: float = 30.0
    slowdown_t: float = 30.0
    w_h: float = 1.0
    w_v: float = 5.0
    w_u: float = 1.0
    collision_penalty: float = 1000.0
    init_noise_h: float = 1.0
    init_noise_v: float = 1.0
    v_target: str = "profile"        # "profile" | "fixed"

    # --- ATSC ---
    episode_length_sec: int = 3600
    control_interval_sec: int = 5
    yellow_interval_sec: int = 2
    objective: str = "queue"         # queue | wait | hybrid
    norm_wave: float = 5.0
    norm_wait: float = 100.0
    clip_wave: float = 2.0
    clip_wait: float = 2.0
    coef_wait: float = 0.2
    peak_flow1: float = 1100.0       # veh/hr, grid demand group 1
    peak_flow2: float = 925.0        # veh/hr, grid demand group 2
    init_density: float = 0.0        # initial queue fill fraction
    sat_flow: float = 0.5            # veh/s saturation discharge per lane
    lane_capacity: float = 40.0      # veh per movement queue
    demand_scale: float = 1.0
    link_delay_sec: int = 10         # seconds to traverse a link (>= 1)
    phase_in_obs: bool = False       # append the current phase one-hot
    queue_in_obs: bool = False       # append each lane's halted count
    hysteresis_delta: float = 3.0
    hysteresis_on: str = "queue"     # "queue" | "wave"
    network_data: str = ""           # optional JSON graph (real_net)

    def __post_init__(self):
        if self.hysteresis_on not in ("queue", "wave"):
            raise ValueError(
                f"hysteresis_on must be 'queue' or 'wave', got "
                f"{self.hysteresis_on!r}")
        if self.v_target not in ("fixed", "profile"):
            raise ValueError(
                f"v_target must be 'fixed' or 'profile', got "
                f"{self.v_target!r}")

    @property
    def episode_steps_atsc(self) -> int:
        return self.episode_length_sec // self.control_interval_sec


@dataclass(frozen=True)
class Config:
    agent: str = "ma2c_nc"
    env: EnvConfig = field(default_factory=EnvConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @property
    def scenario(self) -> str:
        return self.env.scenario


_SECTION_TO_CLS = {
    "ENV_CONFIG": EnvConfig,
    "MODEL_CONFIG": ModelConfig,
    "TRAIN_CONFIG": TrainConfig,
}

# reference key -> our field, where names differ
_KEY_ALIASES = {
    "n_step": "batch_size",
}


def _load_section(cls, section: configparser.SectionProxy):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, raw in section.items():
        name = _KEY_ALIASES.get(key, key)
        if name not in fields:
            continue  # tolerate unknown reference keys
        f = fields[name]
        if f.type in ("Tuple[int, ...]",):
            kwargs[name] = tuple(_parse_list(raw, int))
        else:
            val = _parse_scalar(raw)
            if f.type == "float" and isinstance(val, int):
                val = float(val)
            if f.type == "int" and isinstance(val, float):
                val = int(val)
            kwargs[name] = val
    return cls(**kwargs)


def load_config(path: str, agent: Optional[str] = None) -> Config:
    """Load a reference-style .ini file.

    ``agent`` may be given explicitly or via an ``agent`` key in
    [MODEL_CONFIG]/[ENV_CONFIG]; otherwise it is inferred from the filename
    (config_<agent>_<scenario>.ini).
    """
    cp = configparser.ConfigParser()
    if not cp.read(path):
        raise FileNotFoundError(path)
    sections = {}
    for sec_name, cls in _SECTION_TO_CLS.items():
        if cp.has_section(sec_name):
            sections[sec_name] = _load_section(cls, cp[sec_name])
        else:
            sections[sec_name] = cls()
    if agent is None:
        for sec in ("MODEL_CONFIG", "ENV_CONFIG"):
            if cp.has_section(sec) and cp.has_option(sec, "agent"):
                agent = cp.get(sec, "agent")
                break
    if agent is None:
        base = os.path.basename(path)
        if base.startswith("config_"):
            parts = base[len("config_"):].rsplit(".", 1)[0]
            for known in ("ia2c_fp", "ia2c_cu", "ma2c_nc", "ma2c_cnet",
                          "ma2c_dial", "ia2c"):
                if parts.startswith(known):
                    agent = known
                    break
    if agent is None:
        agent = "ia2c"
    return Config(
        agent=agent,
        env=sections["ENV_CONFIG"],
        model=sections["MODEL_CONFIG"],
        train=sections["TRAIN_CONFIG"],
    )


def save_config(cfg: Config, path: str) -> None:
    """Snapshot the config into a run dir: the three sections with every
    field, plus the ``agent`` key, so that ``load_config`` of either
    package reads it back."""
    cp = configparser.ConfigParser()
    for sec_name, obj in (
        ("ENV_CONFIG", cfg.env),
        ("MODEL_CONFIG", cfg.model),
        ("TRAIN_CONFIG", cfg.train),
    ):
        cp.add_section(sec_name)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, tuple):
                v = ",".join(str(x) for x in v)
            cp.set(sec_name, f.name, str(v))
    cp.set("MODEL_CONFIG", "agent", cfg.agent)
    with open(path, "w") as fh:
        cp.write(fh)
