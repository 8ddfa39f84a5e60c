"""One control step of the CACC platoon with its auto-reset, as one CUDA
kernel.

The JAX package steps the platoon with plain ``jnp`` code
(``deeprl_network_tpu/envs/cacc.py`` ``CACCEnv.step``) that XLA fuses under
``jit``, reset and select included; no TPU kernel stands behind it. The
port's generic path (``envs/wrappers.py`` ``AutoResetEnv.step``) runs the
step, a whole reset every step and a ``torch.where`` over each state leaf
and the obs: about 96 PyTorch kernels a step on [B, n] tensors, each a node
of the update's CUDA graph. ``csrc/cacc_env.cu`` runs all of it as one
launch for the B platoons (its source says how it keeps each op's rounding,
so that its outputs equal the ops' on the card bit for bit).

``cacc_env_step`` takes numbers and tensors only: the config's scalars as
``c_args`` folds them, the state's leaves, the actions and the reset's raw
uniforms. It launches the kernel for CUDA tensors (and raises if the launch
fails; there is no fallback) and refuses any other device. The plain twin,
the same composition as PyTorch ops, is ``CACCEnv.step_autoreset_ref``
(``envs/cacc.py``), which ``CACCEnv.step_autoreset`` runs on the CPU. The
wrapper counts its launches in ``LAUNCHES`` (a launch captured into a CUDA
graph counts once, at the capture). Every output is a new tensor: the input
state is never written.

An action outside [0, 4) is where the two part. The twin indexes the gain
table with it: -4 to -1 count from the end, anything else raises (an
``IndexError`` on the CPU, a device-side assert on the card). The kernel
cannot raise without a sync, so it reads -4 to -1 as the twin does and
gives anything else NaN gains: that vehicle's control, velocity and reward
and its follower's headway come out NaN, and so does the loss.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deeprl_network_tpu_torch.ops import _build

# kernel launches by name, counted by the wrapper where it launches
LAUNCHES = {"cacc_env_step": 0}

MAX_VEHICLES = 32   # a platoon lies in one warp
INFO_KEYS = ("collision", "headway_err", "velocity_err")
# the kernel's Scalars struct (csrc/cacc_env.cu), field for field, then the
# OVM gain table
_SCALARS = ("h_st", "h_go", "pi", "inv_span", "half_v_max", "v_max", "u_max",
            "dt", "h_min", "v_star", "h_star", "inv_v_star", "inv_5",
            "inv_h_star", "inv_u_max", "inv_n", "w_h", "w_v", "w_u",
            "neg_penalty", "ramp_v0", "ramp_dv", "inv_ramp_t", "amp_h",
            "amp_v", "h0_first", "v0_start")
# the kernel's Ints struct, field for field
_INTS = ("n", "episode_length", "ramp", "profile")
_lib: Optional[ctypes.CDLL] = None

# (Scalars, Ints) as ctypes arrays, from ``c_args``
Args = Tuple[ctypes.Array, ctypes.Array]


def _inv(x: float) -> float:
    """1 / x as PyTorch's CUDA ``tensor / x`` rounds it: x to f32, then
    the f32 reciprocal."""
    return float(np.float32(1.0) / np.float32(x))


def c_args(cfg, scenario: str, gains: np.ndarray) -> Args:
    """The kernel's Scalars and Ints structs (ctypes arrays) for an
    ``EnvConfig``, its scenario (``catchup`` or ``slowdown``) and the OVM
    gain table [4, 2]. Each number is what the ops hand to f32: a Python
    product or difference of numbers is folded in double first
    (``0.5 * v_max``), a divisor becomes its f32 reciprocal."""
    c = cfg
    ramp = scenario != "catchup"
    vals = dict(
        h_st=c.h_st, h_go=c.h_go, pi=math.pi,
        inv_span=_inv(c.h_go - c.h_st), half_v_max=0.5 * c.v_max,
        v_max=c.v_max, u_max=c.u_max, dt=c.dt, h_min=c.h_min,
        v_star=c.v_star, h_star=c.h_star, inv_v_star=_inv(c.v_star),
        inv_5=_inv(5.0), inv_h_star=_inv(c.h_star),
        inv_u_max=_inv(c.u_max), inv_n=_inv(c.n_vehicle), w_h=c.w_h,
        w_v=c.w_v, w_u=c.w_u, neg_penalty=-c.collision_penalty,
        ramp_v0=c.slowdown_v0, ramp_dv=c.v_star - c.slowdown_v0,
        inv_ramp_t=_inv(c.slowdown_t), amp_h=c.init_noise_h,
        amp_v=c.init_noise_v,
        h0_first=c.h_star if ramp else c.catchup_ratio * c.h_star,
        v0_start=c.slowdown_v0 if ramp else c.v_star)
    floats = [float(vals[k]) for k in _SCALARS] \
        + [float(g) for g in np.asarray(gains, np.float32).ravel()]
    scal = (ctypes.c_float * len(floats))(*floats)
    ints = (ctypes.c_int * len(_INTS))(
        int(c.n_vehicle), int(c.episode_length), int(ramp),
        int(c.v_target != "fixed"))
    return scal, ints


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/cacc_env.cu) with its C entry's argument
    types set."""
    lib.cacc_env_step.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int,
                                                           ctypes.c_void_p]
    lib.cacc_env_step.restype = ctypes.c_int
    return lib


def _kernel() -> ctypes.CDLL:
    """The library, built and loaded at first use."""
    global _lib
    if _lib is None:
        _lib = bind(_build.load("cacc_env"))
    return _lib


def check_inputs(args: Args, s, action: torch.Tensor,
                 u_h: Optional[torch.Tensor], u_v: Optional[torch.Tensor],
                 device: torch.device) -> None:
    """Raise unless the kernel takes these inputs for ``args`` (from
    ``c_args``): at most ``MAX_VEHICLES`` vehicles, at least one platoon,
    and every input a contiguous tensor on ``device`` of the kernel's dtype
    and shape (the state's fields, the actions, then each uniform, which
    must be given exactly where its noise amplitude is not 0)."""
    scal, ints = args
    n, B = int(ints[_INTS.index("n")]), int(action.shape[0])
    if n > MAX_VEHICLES:
        raise ValueError(f"cacc_env_step: {n} vehicles; the kernel takes at "
                         f"most {MAX_VEHICLES} (a platoon in one warp)")
    if B < 1:
        raise ValueError("cacc_env_step: no platoon")
    f32, i64 = torch.float32, torch.int64
    want = [("h", s.h, (B, n), f32), ("v", s.v, (B, n), f32),
            ("u", s.u, (B, n), f32), ("v_lead", s.v_lead, (B,), f32),
            ("t", s.t, (B,), i64), ("done", s.done, (B,), torch.bool),
            ("action", action, (B, n), i64)]
    for name, u in (("u_h", u_h), ("u_v", u_v)):
        amp = scal[_SCALARS.index(f"amp_{name[-1]}")]
        if (u is None) != (amp == 0):
            raise ValueError(f"cacc_env_step: {name} is "
                             f"{'missing' if u is None else 'given'} at a "
                             f"noise amplitude of {amp}")
        if u is not None:
            want.append((name, u, (B, n), f32))
    for name, x, shape, dtype in want:
        if x.device != device:
            raise ValueError(f"cacc_env_step: {name} on {x.device}, the "
                             f"step on {device}")
        if x.dtype != dtype:
            raise TypeError(f"cacc_env_step: {name} is {x.dtype}, the "
                            f"kernel takes {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"cacc_env_step: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"cacc_env_step: {name} is not contiguous")


def cacc_env_step(args: Args, s, action: torch.Tensor,
                  u_h: Optional[torch.Tensor], u_v: Optional[torch.Tensor]):
    """One step of B platoons with auto-reset on the card, for ``args``
    (from ``c_args``): what ``CACCEnv.step_autoreset_ref`` returns, from
    the state ``s``, the actions [B, n] and the reset's uniforms [B, n]
    (None where the noise amplitude is 0). Returns (state', obs, reward,
    done, info); ``state'`` has the input state's type. Every output is a
    new tensor, a view of one of four allocations: the state's floats, its
    clock, the three flags, and the observation, reward and info's means."""
    dev = action.device
    if dev.type != "cuda":
        raise ValueError(f"cacc_env_step: unsupported device {dev} (the "
                         f"plain twin is CACCEnv.step_autoreset_ref)")
    check_inputs(args, s, action, u_h, u_v, dev)
    lib = _kernel()
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return cacc_env_step(args, s, action, u_h, u_v)
    scal, ints = args
    B, n = action.shape
    h, v, u, v_lead = torch.empty(
        B * (3 * n + 1), dtype=torch.float32, device=dev
    ).split_with_sizes((B * n, B * n, B * n, B))
    t = torch.empty(B, dtype=torch.int64, device=dev)
    done_state, done, collision = torch.empty(
        3 * B, dtype=torch.bool, device=dev).split_with_sizes((B, B, B))
    obs, reward, headway, velocity = torch.empty(
        B * (5 * n + 2), dtype=torch.float32, device=dev
    ).split_with_sizes((B * n * 4, B * n, B, B))
    err = lib.cacc_env_step(
        ctypes.addressof(scal), ctypes.addressof(ints), s.h.data_ptr(),
        s.v.data_ptr(), s.v_lead.data_ptr(), s.t.data_ptr(),
        action.data_ptr(), None if u_h is None else u_h.data_ptr(),
        None if u_v is None else u_v.data_ptr(), h.data_ptr(), v.data_ptr(),
        u.data_ptr(), v_lead.data_ptr(), t.data_ptr(), done_state.data_ptr(),
        done.data_ptr(), collision.data_ptr(), obs.data_ptr(),
        reward.data_ptr(), headway.data_ptr(), B,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"cacc_env_step kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["cacc_env_step"] += 1
    state = type(s)(h=h.view(B, n), v=v.view(B, n), u=u.view(B, n),
                    v_lead=v_lead, t=t, done=done_state)
    info = dict(zip(INFO_KEYS, (collision, headway, velocity)))
    return state, obs.view(B, n, 4), reward.view(B, n), done, info
