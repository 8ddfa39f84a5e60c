"""Traffic kind ``train``: one trainer's updates back to back, a closed
loop, as the port's Trainer and throughput tool drive ``train_step``.

Parameters (the cell's workload file): ``num_envs`` (B, envs of one
process); ``check_updates`` (the updates the check follows, 3 by default:
a cell sets enough to pass an episode's end, so that the check covers the
auto-reset, and the carry masked and the fingerprints reset where an
episode ended); ``reference_block`` (rows the reference runs at a time,
all by default: a cell whose batch is too large for the reference's
memory sets it).

Set-up builds the env and ``make_a2c(...)`` (a CUDA graph an update, its
default), makes the weights on the card from the seed, and drives that one
train state through ``check_updates`` updates by ``train_step`` itself: the
first captures the graph, the others replay it, and the losses, the
optimizer's state after the first and the params after the last are kept
for the check. The window then runs whole updates from that state, a
synchronise every ``CHUNK`` (as the Trainer paces them), until ``seconds``
have passed; CUDA events recorded on the stream between calls time each
update on the card. With ``trace`` a fixed stretch of ``TRACE_UPDATES``
updates is profiled after the window. Once the program's state is freed,
the reference follows the same first updates from the same weights and
seed, and ``judge.train_numbers`` compares.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from benchmark import faults, judge, params as params_mod, program, trace
from benchmark.reference import build_reference

CHUNK = 5
TRACE_UPDATES = 3
ACTOR_SCALE = 0.01     # the actor's weights at the start of training


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _deciles(xs):
    return ([round(q, 5) for q in statistics.quantiles(xs, n=10)]
            if len(xs) > 1 else xs)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_updates(cell) -> int:
    return int(cell.params.get("check_updates", 3))


def make_weights(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's weights from ``seed``, shaped by the reference's own
    description of the configuration."""
    cfg = cell.config
    ref_env, policy = build_reference(cfg, "cpu")
    m = cfg["model"]
    return params_mod.make_params(
        seed, ref_env.adj, ref_env.n_s, ref_env.n_a, int(m["num_fc"]),
        int(m["num_lstm"]), policy.comm, ACTOR_SCALE, device)


class Run:
    """One process's trainer: set-up, window, trace stretch, then what the
    check needs."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.B = int(cell.params["num_envs"])
        self.env, self.fns = program.build(cell.config, self.B, self.device)
        self.weights = make_weights(cell, seed, self.device)
        self.p0 = _cpu(self.weights)
        self.ts = self.fns.init_state(seed,
                                      params=program.to_program(self.weights))
        self.losses: List[float] = []
        self.ms1: Dict[str, torch.Tensor] = {}
        for i in range(check_updates(cell)):
            self.ts, m = self.fns.train_step(self.ts)
            self.losses.append(float(m["loss"]))
            if i == 0:
                self.ms1 = _cpu(program.named(self.ts.params,
                                              self.ts.opt_state.ms))
        self.p_last = _cpu(program.named(self.ts.params))
        _sync(self.device)

    def capture_times(self) -> Optional[Dict[str, float]]:
        graphed = getattr(self.fns, "graphed", None)
        if graphed is None or not graphed.graphs:
            return None
        return next(iter(graphed.graphs.values())).times

    def window(self, seconds: float) -> Dict:
        """Whole chunks of updates until ``seconds`` have passed."""
        cuda = self.device.type == "cuda"
        marks, host, bad, n = [], [], 0, 0
        _sync(self.device)
        t0 = time.perf_counter()
        while True:
            for _ in range(CHUNK):
                if cuda:
                    marks.append(torch.cuda.Event(enable_timing=True))
                    marks[-1].record()
                a = time.perf_counter()
                self.ts, m = self.fns.train_step(self.ts)
                host.append(time.perf_counter() - a)
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            loss = float(m["loss"])          # waits for the chunk
            n += CHUNK
            if not math.isfinite(loss):
                bad += CHUNK
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        device_s = []
        if cuda:
            torch.cuda.synchronize(self.device)
            # consecutive marks bound one update, but a chunk's last mark
            # and the next chunk's first bound no update
            for i in range(len(marks) - 1):
                if (i + 1) % (CHUNK + 1) != 0:
                    device_s.append(marks[i].elapsed_time(marks[i + 1]) / 1e3)
        return {"updates": n, "failed": bad, "window_s": window_s,
                "host_s": host, "device_s": device_s, "t0": t0}

    def trace_stretch(self) -> List[trace.Event]:
        with trace.traced() as prof:
            for _ in range(TRACE_UPDATES):
                self.ts, _ = self.fns.train_step(self.ts)
            torch.cuda.synchronize(self.device)
        return trace.events(prof)

    def free(self) -> None:
        self.ts = self.fns = self.env = self.weights = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def follow(cell, seed: int, p0, batch: int, updates: int, device,
           q_name: str = "identity") -> List[Dict]:
    """The reference's first ``updates`` from ``p0`` and ``seed`` over the
    ``batch`` (``reference.a2c.follow_train``), its matrix products'
    operands rounded by ``q_name``."""
    from benchmark.reference.a2c import follow_train
    from benchmark.reference.precision import ROUNDINGS, full_float32
    cfg = cell.config
    ref_env, policy = build_reference(cfg, device)
    with full_float32():
        return follow_train(ref_env, policy, p0,
                            {**cfg["model"], **cfg["assumed"]},
                            int(cfg["train"]["total_step"]), seed, batch,
                            updates, ROUNDINGS[q_name],
                            block=cell.params.get("reference_block"))


def reference_numbers(cell, seed: int, p0, losses, ms1, p_last, batch: int,
                      device) -> Dict[str, float]:
    """The reference's first updates against what the program kept."""
    ref = follow(cell, seed, p0, batch, len(losses), device)
    return judge.train_numbers(losses, ms1, p0, p_last, ref,
                               float(cell.config["model"]["rmsp_alpha"]))


def shapes(cell) -> Dict:
    """What the readers need of the cell's sizes (from the reference's own
    description of the configuration)."""
    cfg = cell.config
    ref_env, policy = build_reference(cfg, "cpu")
    m = cfg["model"]
    out = {"B": int(cell.params["num_envs"]),
           "T": int(m["batch_size"]), "N": ref_env.n_agent,
           "n_s": ref_env.n_s, "n_a": ref_env.n_a, "F": int(m["num_fc"]),
           "H": int(m["num_lstm"]), "comm": policy.comm,
           "degrees": [float(d) for d in ref_env.adj.sum(1)],
           "dtype": cfg["assumed"].get("compute_dtype", "float32")}
    if hasattr(ref_env, "route_nnz"):
        out["env"] = {"L": ref_env.L, "M": ref_env.M, "P": ref_env.P,
                      "D": ref_env.D, "W": ref_env.n_s,
                      "route_nnz": ref_env.route_nnz,
                      "substeps": ref_env.k_sub,
                      "with_q0": ref_env.init_density > 0}
    return out


def observations(win: Dict, evs, shp: Dict) -> Dict:
    return {"window": win, "trace": evs, "trace_updates": TRACE_UPDATES,
            "shapes": shp}


def run(cell, seed: int, seconds: float, trace_on: bool, t_start: float,
        device="cuda") -> Dict:
    r = Run(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    notes = [f"setup_s {setup_s!r}; graph capture {r.capture_times()}"]
    win = r.window(seconds)
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    evs = r.trace_stretch() if trace_on else None
    if evs:
        notes.append(trace.launch_note(evs))
    saved = (r.p0, r.losses, r.ms1, r.p_last)
    r.free()
    numbers = reference_numbers(cell, seed, *saved, r.B, r.device)
    steps = win["updates"] * r.B * int(cell.config["model"]["batch_size"])
    notes.append(f"window {win['updates']} updates in {win['window_s']!r} s;"
                 f" an update on the card, deciles (s): "
                 f"{_deciles(win['device_s'])}")
    return {"e2e": {"train_env_steps_per_s": steps / win["window_s"],
                    "setup_s": setup_s},
            "obs": observations(win, evs, shapes(cell)),
            "numbers": numbers, "attempted": win["updates"],
            "failed": win["failed"], "memory_peak_bytes": peak,
            "count": 1, "notes": notes}


def calibration_rows(cell, seed: int, variants, control: bool, device):
    """(variant, numbers) for ``calibrate.py``: each of ``variants``
    (``sound`` or a fault of ``faults.py``) through the set-up's checked
    updates, and with ``control`` the reference one precision below the
    configuration's, each against the reference followed once."""
    decay = float(cell.config["model"]["rmsp_alpha"])
    B, U = int(cell.params["num_envs"]), check_updates(cell)
    p0 = _cpu(make_weights(cell, seed, device))
    ref = None
    for name in variants:
        with (faults.FAULTS[name]() if name != "sound"
              else contextlib.nullcontext()):
            r = Run(cell, seed, device)
        saved = (r.losses, r.ms1, r.p_last)
        r.free()
        del r
        gc.collect()
        if ref is None:
            ref = follow(cell, seed, p0, B, U, device)
        yield name, judge.train_numbers(saved[0], saved[1], p0, saved[2],
                                        ref, decay)
    if control:
        from benchmark.reference.precision import BELOW
        q = BELOW[cell.config["assumed"].get("compute_dtype", "float32")]
        if ref is None:
            ref = follow(cell, seed, p0, B, U, device)
        ctl = follow(cell, seed, p0, B, U, device, q)
        ms1 = {k: (1.0 - decay) * g * g for k, g in ctl[0]["grads"].items()}
        yield "control", judge.train_numbers(
            [c["loss"] for c in ctl], ms1, p0, ctl[-1]["params"], ref, decay)
