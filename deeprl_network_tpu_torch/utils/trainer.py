"""Host-side training orchestration: Counter, Trainer, Evaluator
(counterpart of ``deeprl_network_tpu/utils/trainer.py``).

Rebuild of the reference ``utils.py`` L4 layer (SURVEY.md section 2.2
item 2). The whole n_step x B rollout + update is one ``train_step`` call
(utils/rollout.py), so this layer only sequences those calls, periodic
evaluation on held-out seeds, metric csv/jsonl output, and checkpoints.
Nothing in the update loop reads a tensor on the host: the window's
metrics are stacked on the device and moved once at a log boundary.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from deeprl_network_tpu_torch.config import Config
from deeprl_network_tpu_torch.parallel.distributed import is_primary
from deeprl_network_tpu_torch.utils.checkpoint import CheckpointManager
from deeprl_network_tpu_torch.utils.logging import MetricWriter, init_dir
from deeprl_network_tpu_torch.utils.rollout import A2CFns, TrainState

log = logging.getLogger(__name__)


class Counter:
    """Global step bookkeeping (reference utils.py Counter ~L20)."""

    def __init__(self, total_step: int, test_step: int, log_step: int):
        self.total_step = total_step
        self.test_step = test_step
        self.log_step = log_step
        self.cur_step = 0
        self._next_test = test_step
        self._next_log = log_step

    def update(self, n: int) -> int:
        self.cur_step += n
        return self.cur_step

    def fast_forward(self, step: int) -> None:
        """Jump to ``step`` (checkpoint restore) and ratchet the log/test
        thresholds past it — otherwise every post-resume update would
        fire should_log/should_test until the one-interval-per-call
        advance catches up."""
        self.cur_step = step
        self._next_test = (step // self.test_step + 1) * self.test_step
        self._next_log = (step // self.log_step + 1) * self.log_step

    def should_test(self) -> bool:
        if self.cur_step >= self._next_test:
            self._next_test += self.test_step
            return True
        return False

    def should_log(self) -> bool:
        if self.cur_step >= self._next_log:
            self._next_log += self.log_step
            return True
        return False

    def should_stop(self) -> bool:
        return self.cur_step >= self.total_step


def _window_means(window) -> Dict[str, float]:
    """Mean of every metric over a window of ``train_step`` metric dicts.
    The tensor metrics are stacked on their device and cross to the host
    in one transfer; ``lr`` and ``beta`` are Python floats already. Keys
    come out sorted: the JAX package's metric dicts leave ``jit`` that way,
    and the csv files of both packages keep one column order."""
    keys = sorted(window[-1])
    on_dev = [k for k in keys if torch.is_tensor(window[-1][k])]
    host = {}
    if on_dev:
        stacked = torch.stack([torch.stack([w[k].float() for k in on_dev])
                               for w in window])
        for k, col in zip(on_dev, stacked.cpu().numpy().T):
            host[k] = float(np.mean(col))
    return {k: host[k] if k in host
            else float(np.mean([w[k] for w in window])) for k in keys}


class Trainer:
    """Sequences fused train steps; logs and checkpoints.

    reference: utils.py Trainer.run (~L170): explore/backward collapse
    into fns.train_step; perform() becomes fns.eval_episode. Under data
    parallelism (``fns`` from ``parallel/train.py``) every rank runs a
    Trainer: all of them take every update, the profiler's updates and
    every checkpoint save (collectives), and only the primary writes log
    rows, the profiler trace and in-train evaluations.
    """

    def __init__(self, fns: A2CFns, cfg: Config, output_dir: str,
                 seed: int = 0, profile: bool = False,
                 in_train_test: bool = True):
        self.fns = fns
        self.cfg = cfg
        self.profile = profile
        # reference --test-mode: periodic held-out-seed evaluation episodes
        # during training (utils.py Tester); off under 'no_test'
        self.in_train_test = in_train_test
        self.dirs = init_dir(output_dir)
        self.counter = Counter(cfg.train.total_step,
                               cfg.train.test_interval,
                               cfg.train.log_interval)
        # decoupled checkpoint cadence (TrainConfig.save_interval);
        # <= 0 keeps the save-on-log behavior
        self._save_every = int(getattr(cfg.train, "save_interval", 0))
        self._next_save = self._save_every
        self.ckpt = CheckpointManager(self.dirs["model"])
        self.seed = seed
        self.primary = is_primary()
        if self.primary:
            # csv/jsonl plus TensorBoard scalars under log/ (the
            # reference's TF1 summary_writer surface)
            self.train_writer = MetricWriter(self.dirs["data"], "train_log",
                                             tb_dir=self.dirs["log"])
            self.test_writer = MetricWriter(self.dirs["data"], "test_log",
                                            tb_dir=self.dirs["log"])

    def run(self, restore: bool = False) -> TrainState:
        ts = self.fns.init_state(self.seed)
        if restore:
            restored = self.ckpt.restore(ts)
            if restored is not None:
                ts = restored
                self.counter.fast_forward(int(ts.step))
                if self._save_every > 0:
                    self._next_save = (int(ts.step) // self._save_every
                                       + 1) * self._save_every
                log.info("restored checkpoint at step %d", self.counter.cur_step)
        if self.profile:
            # trace of a few steady-state updates (host activity, and the
            # device's where the state lives on a card); open the file in
            # chrome://tracing or Perfetto
            from torch.profiler import ProfilerActivity, profile
            on_card = ts.obs.is_cuda
            ts, _ = self.fns.train_step(ts)  # warm-up
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            with profile(activities=acts) as prof:
                for _ in range(3):
                    ts, _ = self.fns.train_step(ts)
                if on_card:
                    torch.cuda.synchronize(ts.obs.device)
            if self.primary:
                trace = os.path.join(self.dirs["log"], "trace.json")
                prof.export_chrome_trace(trace)
                log.info("profiler trace written to %s", trace)
        t0 = time.time()
        window_metrics = []
        last_step, last_t = self.counter.cur_step, t0
        # steps_per_update is static: count host-side. No tensor is read
        # inside the loop (each read would be a stream synchronisation);
        # the device queue is paced every few updates instead, so an
        # unsynced loop cannot enqueue unbounded device work.
        spu = self.fns.steps_per_update
        updates_since_sync = 0
        while not self.counter.should_stop():
            ts, metrics = self.fns.train_step(ts)
            self.counter.update(spu)
            window_metrics.append(metrics)
            updates_since_sync += 1
            if updates_since_sync >= 5:
                if ts.obs.is_cuda:
                    torch.cuda.current_stream(ts.obs.device).synchronize()
                updates_since_sync = 0
            if self.counter.should_log():
                if self.primary:
                    last_t = self._log_row(window_metrics, t0, last_step,
                                           last_t)
                last_step = self.counter.cur_step
                window_metrics = []
                # every rank saves (under data parallelism the save
                # gathers the env batch; rank 0 writes)
                if self._save_every <= 0:
                    self.ckpt.save(self.counter.cur_step, ts)
            if (self._save_every > 0
                    and self.counter.cur_step >= self._next_save):
                # ratchet PAST the current step (like Counter.fast_forward):
                # a single +interval advance falls behind whenever
                # save_interval < steps_per_update and then saves on every
                # update forever (ADVICE r4)
                self._next_save = (self.counter.cur_step // self._save_every
                                   + 1) * self._save_every
                self.ckpt.save(self.counter.cur_step, ts)
            if (self.counter.should_test() and self.in_train_test
                    and self.primary):
                self.test(ts)
        self.ckpt.save(self.counter.cur_step, ts)
        return ts

    def _log_row(self, window_metrics, t0: float, last_step: int,
                 last_t: float) -> float:
        """Write the train_log row of the window since ``last_step``;
        returns the time it was taken at."""
        # ONE device->host transfer for the whole window
        m = _window_means(window_metrics)
        now = time.time()
        sps = (self.counter.cur_step - last_step) / max(now - last_t, 1e-9)
        row = {"step": self.counter.cur_step, "wall_s": now - t0,
               "env_steps_per_s": sps, **m}
        # each span's mean over the window's updates (on a card; the ring
        # holds the last 256), read once the window's means have waited
        # for its updates
        spans = self.fns.spans
        if spans is not None:
            row.update({f"span/{k}_ms": v for k, v in
                        spans.means(len(window_metrics)).items()})
        self.train_writer.write(row)
        log.info("step %d | R_ep %.1f | loss %.3f | sps %.0f",
                 self.counter.cur_step, m.get("episode_return", 0.0),
                 m["loss"], sps)
        return now

    def test(self, ts: TrainState) -> Dict[str, float]:
        rows = []
        for s in self.cfg.env.test_seeds:
            # sampled policy, matching the reference's perform()/Evaluator
            # (actions drawn from pi host-side; SURVEY.md section 3.3)
            out = self.fns.eval_episode(ts.params, int(s), None, False)
            keys = sorted(out)      # the JAX package's column order
            vals = torch.stack([out[k].float() for k in keys]).cpu()
            rows.append({k: float(v) for k, v in zip(keys, vals)})
        avg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        avg["step"] = self.counter.cur_step
        self.test_writer.write(avg)
        log.info("test @ %d: episode_return %.1f", self.counter.cur_step,
                 avg["episode_return"])
        return avg


class Evaluator:
    """Seed-swept evaluation of a trained policy (reference utils.py
    Evaluator ~L230): per-seed episode metrics plus per-step measurement
    series csvs (reference env.init_data/collect_tripinfo/output_data)."""

    def __init__(self, fns: A2CFns, output_dir: str, seeds=(2000, 2500, 3000),
                 demo: bool = False, policy: str = "sample",
                 record: bool = True, scenario: str = "", agent: str = "",
                 control_interval_sec: int = 5):
        self.fns = fns
        self.out_dir = output_dir
        self.writer = MetricWriter(output_dir, "eval_log")
        self.seeds = seeds
        self.policy = policy
        # reference artifact naming: {scenario}_{agent}_{trip,traffic,
        # control}.csv (envs/atsc_env.py output_data ~L285)
        self.scenario = scenario
        self.agent = agent
        self.control_interval_sec = control_interval_sec
        # reference --demo replays the episode in the SUMO GUI; this engine
        # has no GUI, so demo guarantees the full per-step series csvs are
        # written for offline replay/plotting instead
        self.record = record or demo
        if demo:
            log.info("--demo: this engine has no GUI; writing full "
                     "per-step series csvs for offline replay")

    def run(self, params) -> Dict[str, float]:
        rows = []
        episodes = []
        for s in self.seeds:
            seq = self.fns.record_episode(params, int(s), None,
                                          policy=self.policy)
            # sorted keys: the JAX package's column order in the csv files
            seq = {k: seq[k].cpu().numpy() for k in sorted(seq)}
            alive = seq.pop("alive")
            steps = int(alive.sum())
            ep_ret = float((seq["reward"].sum(-1) * alive).sum())
            row = {"seed": int(s), "episode_return": ep_ret,
                   "episode_len": steps}
            for k, v in seq.items():
                if v.ndim >= 1 and k != "action":
                    row[f"avg_{k}"] = float(np.mean(v[:steps]))
            self.writer.write(row)
            rows.append(row)
            episodes.append((int(s), seq, steps))
            if self.record:
                self._write_series(s, seq, steps)
        if self.record:
            self._write_reference_artifacts(episodes)
        avg = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0] if k != "seed"}
        log.info("eval over %d seeds: %s", len(self.seeds), avg)
        return avg

    def _write_reference_artifacts(self, episodes) -> None:
        """Reference eval artifact schema (envs/atsc_env.py output_data
        ~L285, SURVEY 2.2 item 6): `{scenario}_{agent}_traffic.csv` (one
        row per control step: network aggregates), `_control.csv` (one row
        per step x node: action + reward), `_trip.csv` (one row per
        episode: trip bookkeeping — the engine is aggregate, so per-
        vehicle tripinfo becomes conserved totals: entered / arrived /
        dropped vehicles and mean trip time = vehicle-seconds in network /
        arrivals). Written only for scenarios whose record()/info streams
        carry traffic keys (ATSC); CACC keeps its per-step platoon series
        in episode_seed{s}.csv, the reference CACC output_data."""
        import csv as _csv
        # guard set must cover EVERY key the writers below read (ADVICE
        # round 2: throughput/dropped were read but not guarded)
        need = {"avg_queue", "avg_wait", "arrived", "entered", "action",
                "reward", "total_queue", "total_transit", "throughput",
                "dropped"}
        if not episodes or not need <= set(episodes[0][1]):
            return
        tag = f"{self.scenario}_{self.agent}" if self.agent else self.scenario
        dt = float(self.control_interval_sec)

        with open(os.path.join(self.out_dir, f"{tag}_traffic.csv"),
                  "w", newline="") as f:
            w = _csv.writer(f)
            w.writerow(["episode", "step", "time_sec", "avg_queue",
                        "avg_wait", "throughput", "arrived", "entered",
                        "total_queue", "total_transit", "dropped"])
            for seed, seq, steps in episodes:
                for t in range(steps):
                    w.writerow([seed, t, t * dt] + [
                        f"{float(seq[k][t]):.4f}" for k in
                        ("avg_queue", "avg_wait", "throughput", "arrived",
                         "entered", "total_queue", "total_transit",
                         "dropped")])

        with open(os.path.join(self.out_dir, f"{tag}_control.csv"),
                  "w", newline="") as f:
            w = _csv.writer(f)
            w.writerow(["episode", "step", "time_sec", "node", "action",
                        "reward"])
            for seed, seq, steps in episodes:
                n_agent = seq["action"].shape[1]
                for t in range(steps):
                    for n in range(n_agent):
                        w.writerow([seed, t, t * dt, n,
                                    int(seq["action"][t, n]),
                                    f"{float(seq['reward'][t, n]):.4f}"])

        with open(os.path.join(self.out_dir, f"{tag}_trip.csv"),
                  "w", newline="") as f:
            w = _csv.writer(f)
            w.writerow(["episode", "entered_veh", "arrived_veh",
                        "dropped_veh", "avg_trip_sec", "avg_wait_sec"])
            for seed, seq, steps in episodes:
                entered = float(seq["entered"][:steps].sum())
                arrived = float(seq["arrived"][:steps].sum())
                dropped = float(seq["dropped"][steps - 1]) if steps else 0.0
                veh_sec = float((seq["total_queue"][:steps]
                                 + seq["total_transit"][:steps]).sum()) * dt
                avg_trip = veh_sec / max(arrived, 1e-6)
                avg_wait = float(seq["avg_wait"][:steps].mean())
                w.writerow([seed, f"{entered:.1f}", f"{arrived:.1f}",
                            f"{dropped:.1f}", f"{avg_trip:.2f}",
                            f"{avg_wait:.2f}"])

    def _write_series(self, seed: int, seq, steps: int) -> None:
        """Per-step csv, per-agent columns flattened (reference
        {scenario}_{agent}_traffic.csv / platoon csv schema)."""
        import csv as _csv
        path = os.path.join(self.out_dir, f"episode_seed{seed}.csv")
        cols, data = [], []
        for k, v in seq.items():
            v = v[:steps]
            if v.ndim == 1:
                cols.append(k)
                data.append(v[:, None])
            else:
                flat = v.reshape(steps, -1)
                cols.extend(f"{k}_{i}" for i in range(flat.shape[1]))
                data.append(flat)
        mat = np.concatenate(data, axis=1)
        with open(path, "w", newline="") as f:
            w = _csv.writer(f)
            w.writerow(["step"] + cols)
            for t in range(steps):
                w.writerow([t] + [f"{x:.4f}" for x in mat[t]])
