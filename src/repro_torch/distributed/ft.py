"""Fault-tolerance runtime (counterpart of `repro/distributed/ft.py`):
watchdog, preemption hook, retries, elastic resume.

  * `StepWatchdog`   — wall-clock deadline per step; a step exceeding the
    deadline marks the node "straggling" (logged and counted).
  * `PreemptionGuard` — converts SIGTERM into a "checkpoint now, then exit
    cleanly" request checked between steps.
  * `elastic_resume` — restore the latest checkpoint onto the devices of
    the ``like`` tree (`CheckpointManager.restore` moves each leaf there:
    card to CPU and back).
  * `RetryingStep`   — retries a step closure on transient failure with
    exponential backoff.
"""

from __future__ import annotations

import logging
import signal
import time
from typing import Any, Callable, Optional, Tuple

log = logging.getLogger("repro_torch.ft")


class StepWatchdog:
    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self.straggler_events = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def check(self, step: int) -> bool:
        """Returns True if this step straggled past the deadline."""
        dt = time.monotonic() - (self._t0 or time.monotonic())
        if dt > self.deadline_s:
            self.straggler_events += 1
            log.warning("step %d straggled: %.2fs > %.2fs deadline "
                        "(event #%d)", step, dt, self.deadline_s,
                        self.straggler_events)
            return True
        return False


class PreemptionGuard:
    """SIGTERM -> graceful 'save and exit' between steps."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM,):
                self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; will checkpoint and "
                    "exit at the next step boundary", signum)
        self.requested = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class RetryingStep:
    def __init__(self, fn: Callable, max_retries: int = 3,
                 backoff_s: float = 0.5):
        self.fn = fn
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.retry_events = 0

    def __call__(self, *args, **kwargs):
        delay = self.backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                return self.fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - retry any transient
                if attempt == self.max_retries:
                    raise
                self.retry_events += 1
                log.warning("step failed (%s); retry %d/%d in %.1fs",
                            e, attempt + 1, self.max_retries, delay)
                time.sleep(delay)
                delay *= 2


def elastic_resume(ckpt_mgr, like: Any) -> Tuple[int, Any]:
    """Restore the latest checkpoint onto the devices and dtypes of
    ``like`` (any device: the card or the CPU).  Returns (next_step,
    state); (0, like) when there is no checkpoint."""
    step, state = ckpt_mgr.restore_latest(like)
    if step is None:
        return 0, like
    log.info("elastic resume from step %d onto the like tree's devices",
             step)
    return step + 1, state
