"""Fault tolerance: heartbeats, straggler detection, restart, elastic
restore (a port of ``repro.train.fault_tolerance``).

Components:
  * HeartbeatMonitor -- per-worker liveness with a deadline; a missed
    heartbeat marks the worker failed.
  * StragglerDetector -- EWMA of step durations; steps slower than
    ``threshold x`` the EWMA flag the step.
  * run_with_recovery -- wraps a training loop: on failure, restore the
    latest committed checkpoint and resume; the deterministic data pipeline
    (data/pipeline.py) replays the exact batch order.
  * elastic_restore -- restore a checkpoint onto a different mesh (new
    shardings) or onto one device: the leaves are logical, whole tensors,
    so restoring elsewhere is re-placement.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.train.checkpoint import CheckpointManager


class HeartbeatMonitor:
    def __init__(self, workers: list[str], deadline_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline = deadline_s
        self.clock = clock
        self.last: dict[str, float] = {w: clock() for w in workers}

    def beat(self, worker: str) -> None:
        self.last[worker] = self.clock()

    def failed_workers(self) -> list[str]:
        now = self.clock()
        return [w for w, t in self.last.items() if now - t > self.deadline]

    def healthy(self) -> bool:
        return not self.failed_workers()


class StragglerDetector:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.2,
                 warmup: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: float | None = None
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.ewma is None:
            self.ewma = duration_s
            return False
        is_straggler = (self.n > self.warmup
                        and duration_s > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append((step, duration_s))
        else:  # do not pollute the EWMA with outliers
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration_s
        return is_straggler


class WorkerFailure(RuntimeError):
    """Raised (or injected) when a worker is lost mid-step."""


@dataclasses.dataclass
class RecoveryStats:
    restarts: int = 0
    last_restored_step: int | None = None


def _restore(ckpt: CheckpointManager, like_tree, placement):
    """The newest checkpoint placed by ``placement``: a tree of
    ``NamedSharding``s (a mesh), a device, or None (where ``like_tree``'s
    leaves are)."""
    if isinstance(placement, dict):
        return ckpt.restore(like_tree, shardings=placement)
    return ckpt.restore(like_tree, device=placement)


def run_with_recovery(train_chunk: Callable[[Any, int, int], Any],
                      state: Any, ckpt: CheckpointManager,
                      state_shardings=None, *, total_steps: int,
                      ckpt_every: int, max_restarts: int = 10):
    """Run ``train_chunk(state, start_step, n_steps) -> state`` to
    ``total_steps`` with checkpoint/restart on failure (restored leaves
    placed by ``state_shardings``: a tree of ``NamedSharding``s, a device,
    or None for where ``state``'s are).

    ``train_chunk`` must raise on worker failure; recovery restores the
    newest committed checkpoint and replays from there."""
    stats = RecoveryStats()
    step = ckpt.latest_step() or 0
    if step:
        state, step = _restore(ckpt, state, state_shardings)
        stats.last_restored_step = step
    while step < total_steps:
        n = min(ckpt_every, total_steps - step)
        try:
            state = train_chunk(state, step, n)
            step += n
            ckpt.save(step, state, blocking=True)
        except WorkerFailure:
            stats.restarts += 1
            if stats.restarts > max_restarts:
                raise
            restored = ckpt.latest_step()
            if restored is None:
                step = 0                      # restart from scratch
            else:
                state, step = _restore(ckpt, state, state_shardings)
                stats.last_restored_step = step
    return state, stats


def elastic_restore(ckpt: CheckpointManager, like_tree, new_shardings):
    """Restore the latest checkpoint onto a different mesh (elastic
    scale-up/down; ``new_shardings`` a tree of ``NamedSharding``s) or onto
    one device (``new_shardings`` the device): logical shapes are
    mesh-independent, so restoring is re-placement."""
    return _restore(ckpt, like_tree, new_shardings)
