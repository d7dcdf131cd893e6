"""Fault tolerance (``repro.distributed.fault_tolerance``): the
checkpoint-restart driver and straggler monitoring, on one device.

* Checkpoint/restart — the driver saves the step-0 anchor, then every
  ``ckpt_every`` steps and at the end (async, one save in flight), and on
  a failure restores the latest COMMITTED checkpoint into the live
  parameters and optimizer state; batches are pure functions of (seed,
  step, shard) (``train/data.py``), so a restart replays the exact token
  stream and a restarted run equals an uninterrupted one bit for bit.
* Straggler mitigation — StragglerMonitor tracks per-step durations and
  flags workers above ``factor``×median; the pacing policy (bounded
  staleness) tolerates ``max_lag`` steps of lag before forcing a resync.
  On one device this is step-time anomaly detection; the policy itself is
  unit-tested.

``TrainDriver`` takes the single-device step or a mesh step
(``train.train_loop.make_train_step``, or the compressed step with its
error-feedback buffer closed over) as ``step_fn``; a mesh state's blocks
are saved as full leaves, so a checkpoint restores onto another mesh:
``run(..., shardings=)`` restores into those shardings, the reference's
elastic rescale (``train.checkpoint.restore(..., shardings=)``).

On a ``core.rank_mesh.RankMesh`` (the state's or the shardings' leaves
lie on one) the driver runs SPMD: every rank runs the same driver with the
same ``ckpt_dir``, ``step_fn`` and ``failure_at``. A save is the
checkpoint's collective (rank 0 writes the one directory); before each
read of the latest step rank 0 joins its save in flight, reads it and
shares it with every rank (``RankMesh.share``), so every rank takes the
same branch and restores the same step; the run ends with one more such
share, so every rank returns after the last checkpoint is committed. A
real crash of one rank is not this driver's: torchrun's elastic agent
restarts the job, and the relaunch resumes from the last committed step,
on a mesh of any shape.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

from repro_torch.distributed.sharding import rank_mesh_of
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    async_save: bool = True
    max_restarts: int = 3


class StragglerMonitor:
    """Per-worker step-duration tracking with bounded-staleness pacing."""

    def __init__(self, factor: float = 2.0, max_lag: int = 2, window: int = 32):
        self.factor = factor
        self.max_lag = max_lag
        self.window = window
        self.durations: Dict[int, List[float]] = {}
        self.progress: Dict[int, int] = {}

    def record(self, worker: int, step: int, duration: float) -> None:
        self.durations.setdefault(worker, []).append(duration)
        self.durations[worker] = self.durations[worker][-self.window:]
        self.progress[worker] = step

    def stragglers(self) -> List[int]:
        if len(self.durations) < 2:
            return []
        all_durs = [statistics.median(d) for d in self.durations.values()]
        med = statistics.median(all_durs)
        return [w for w, d in self.durations.items()
                if statistics.median(d) > self.factor * med]

    def must_resync(self) -> bool:
        """Bounded staleness: force a barrier when lag exceeds max_lag."""
        if not self.progress:
            return False
        return (max(self.progress.values()) - min(self.progress.values())
                > self.max_lag)


class SimulatedFailure(RuntimeError):
    pass


class TrainDriver:
    """Checkpoint-restart training loop.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``;
    ``batch_fn(step) -> device batch``. ``failure_at`` (test hook) raises a
    SimulatedFailure after those step indices complete compute but before
    their results are kept, exercising the restore path.
    """

    def __init__(self, step_fn: Callable, batch_fn: Callable,
                 ft: FTConfig, monitor: Optional[StragglerMonitor] = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ft = ft
        self.monitor = monitor or StragglerMonitor()
        self.restarts = 0
        self._pending_save = None
        self._mesh = None

    def _save(self, step: int, params, opt_state):
        if self._pending_save is not None:
            self._pending_save.join()           # one in flight at a time
        self._pending_save = ckpt.save(
            self.ft.ckpt_dir, step, {"params": params, "opt": opt_state},
            metadata={"step": step}, blocking=not self.ft.async_save)

    def _latest_step(self) -> Optional[int]:
        """The latest committed step, after the save in flight (a save
        still being written would leave a restore an older checkpoint: the
        same run, but the steps since it done again); on a ``RankMesh``
        rank 0's, shared with every rank."""
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None
        if self._mesh is None:
            return ckpt.latest_step(self.ft.ckpt_dir)
        step = ckpt.latest_step(self.ft.ckpt_dir) if self._mesh.rank == 0 else None
        return json.loads(self._mesh.share(json.dumps(step).encode()))

    def _restore(self, params, opt_state, shardings=None):
        step = self._latest_step()
        if step is None:
            return 0, params, opt_state
        tree, _ = ckpt.restore(self.ft.ckpt_dir, step, {"params": params, "opt": opt_state},
                               shardings)
        return step, tree["params"], tree["opt"]

    def run(self, params, opt_state, n_steps: int,
            failure_at: Optional[List[int]] = None, shardings=None) -> Dict:
        failure_at = set(failure_at or [])
        history = []
        self._mesh = rank_mesh_of((params, opt_state, shardings))
        step, params, opt_state = self._restore(params, opt_state, shardings)
        if self._latest_step() is None:
            self._save(0, params, opt_state)     # restart anchor at step 0
        while step < n_steps:
            try:
                t0 = time.monotonic()
                batch = self.batch_fn(step)
                new_params, new_opt, metrics = self.step_fn(
                    params, opt_state, batch)
                if step in failure_at:
                    failure_at.discard(step)
                    raise SimulatedFailure(f"injected at step {step}")
                params, opt_state = new_params, new_opt
                self.monitor.record(0, step, time.monotonic() - t0)
                history.append({"step": step,
                                "loss": float(metrics["loss"])})
                step += 1
                if step % self.ft.ckpt_every == 0 or step == n_steps:
                    self._save(step, params, opt_state)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.ft.max_restarts:
                    raise
                step, params, opt_state = self._restore(params, opt_state, shardings)
        self._latest_step()                     # the last save committed, on every rank
        return {"history": history, "restarts": self.restarts,
                "final_step": step, "params": params, "opt_state": opt_state}
