"""Fault tolerance & straggler mitigation for the training driver.

At 1000+ nodes the failure model is: any step may die (preemption, hardware),
some steps run slow (stragglers), and restarts may come back with a different
device count (elastic).  The policies here are host-side and composable with
`trainer.fit`:

  * `ResumableRun` — checkpoint/restart orchestration: restores the newest
    committed checkpoint, replays the data pipeline to the right position,
    and puts it on the device asked for (elastic restarts).
  * `FailureInjector` — deterministic fault injection for tests/drills: kills
    the process-equivalent (raises) at chosen steps.
  * `StragglerMonitor` — per-step deadline tracking with an EWMA baseline;
    flags and counts stragglers, and (policy hook) requests micro-batch
    redistribution when a persistent straggler is detected.

Counterpart of ``repro/train/fault.py``.  The reference's
``state_shardings`` (re-sharding onto the current mesh) becomes
``mesh`` and ``state_specs``: over a mesh the state's leaves are this
rank's slices under ``state_specs``, checkpoints hold full arrays, and a
restart on another mesh shape (or in one process) restores each rank's
slices under its own mesh (`checkpoint.save` / `checkpoint.restore`); the
step function takes and returns such slices.  ``device`` picks where a
restored state lands.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.device import DeviceLike
from repro_torch.train import checkpoint as ckpt


class InjectedFailure(RuntimeError):
    """Stands in for a node loss / preemption in drills."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time baseline; a step > threshold x baseline is a straggler."""

    threshold: float = 2.0
    alpha: float = 0.2
    baseline: Optional[float] = None
    straggler_steps: list = dataclasses.field(default_factory=list)
    consecutive: int = 0
    redistribute_after: int = 3
    redistributions: int = 0

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.baseline is not None
                        and dt > self.threshold * self.baseline)
        if self.baseline is None:
            self.baseline = dt
        elif not is_straggler:  # don't poison the baseline with outliers
            self.baseline = (1 - self.alpha) * self.baseline + self.alpha * dt
        if is_straggler:
            self.straggler_steps.append(step)
            self.consecutive += 1
            if self.consecutive >= self.redistribute_after:
                self.redistributions += 1  # policy hook: shrink slow host's
                self.consecutive = 0       # microbatch share / evict host
        else:
            self.consecutive = 0
        return is_straggler


@dataclasses.dataclass
class ResumableRun:
    """Checkpoint/restart orchestration around a step function."""

    ckpt_dir: str
    checkpoint_every: int = 10
    keep: int = 3

    def latest(self) -> Optional[int]:
        return ckpt.latest_step(self.ckpt_dir)

    def run(self, step_fn: Callable, state: Any, batches_fn: Callable,
            n_steps: int, *, injector: Optional[FailureInjector] = None,
            monitor: Optional[StragglerMonitor] = None,
            device: DeviceLike = None, mesh=None,
            state_specs: Any = None) -> tuple:
        """Runs up to n_steps, resuming from the newest checkpoint.

        `batches_fn(step) -> batch` must be random-access (deterministic,
        seekable) so the data pipeline replays exactly after restart.
        A restart restores the newest checkpoint into ``state`` (leaves on
        ``device``, default their own; see `checkpoint.restore`).  Over
        ``mesh`` the state holds this rank's slices under ``state_specs``,
        and every rank runs this call in lockstep.
        Returns (state, completed_steps, metrics_history).
        """
        start = 0
        last = self.latest()
        if last is not None:
            state = ckpt.restore(self.ckpt_dir, last, state, device=device,
                                 mesh=mesh, specs=state_specs)
            start = last + 1
        history = []
        for step in range(start, n_steps):
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.monotonic()
            state, metrics = step_fn(state, batches_fn(step))
            dt = time.monotonic() - t0
            if monitor is not None:
                metrics = dict(metrics)
                metrics["straggler"] = monitor.observe(step, dt)
            history.append(metrics)
            if (step + 1) % self.checkpoint_every == 0 or step == n_steps - 1:
                ckpt.save(self.ckpt_dir, step, state, keep=self.keep,
                          mesh=mesh, specs=state_specs)
        return state, n_steps - start, history


__all__ = ["InjectedFailure", "FailureInjector", "StragglerMonitor",
           "ResumableRun"]
