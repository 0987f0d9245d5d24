"""Preemption handling: graceful SIGTERM/SIGINT drain for training (a
copy of ``lightgbm_tpu/resilience/preemption.py``).

On preemptible machines SIGTERM mid-training is the common case, not
the edge case. The guard turns the first signal into a *flag* the
training loop polls at iteration boundaries — the loop then drains the
step's pending device ring (``GBDT.sync()``), writes a final
full-state checkpoint, and raises :class:`TrainingPreempted` — all
within ``deadline_s`` of the signal. A second signal (impatient
supervisor) escalates to an immediate ``KeyboardInterrupt``.

Signal handlers only install from the main thread (CPython restriction);
elsewhere the guard degrades to an inert no-op so training inside worker
threads keeps working.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Optional

__all__ = ["PreemptionGuard", "TrainingPreempted"]


class TrainingPreempted(RuntimeError):
    """Training stopped early on SIGTERM/SIGINT after writing a final
    checkpoint; re-run with ``resume=auto`` to continue bit-identically
    from ``checkpoint_path``."""

    def __init__(self, signum: int, iteration: int,
                 checkpoint_path: Optional[str]):
        name = signal.Signals(signum).name if signum else "signal"
        super().__init__(
            f"training preempted by {name} at iteration {iteration}; "
            + (f"checkpoint written to {checkpoint_path}"
               if checkpoint_path else "no checkpoint written"))
        self.signum = signum
        self.iteration = int(iteration)
        self.checkpoint_path = checkpoint_path


class PreemptionGuard:
    """Context manager: latch SIGTERM/SIGINT into :attr:`fired`.

    ``enabled=False`` constructs an inert guard (the train loop uses one
    code path either way). ``deadline_s`` is the drain budget the loop
    should honor after the first signal; :meth:`deadline_exceeded`
    reports overrun so the caller can log it.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enabled: bool = True, deadline_s: float = 30.0):
        self.enabled = bool(enabled)
        self.deadline_s = float(deadline_s)
        self.fired = False
        self.signum = 0
        self.fired_at: Optional[float] = None
        self._prev = {}
        self._installed = False

    def _handler(self, signum, frame):
        if self.fired:
            # second signal: the supervisor is done waiting — escalate
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name} during preemption "
                "drain")
        self.fired = True
        self.signum = signum
        self.fired_at = time.monotonic()

    def __enter__(self) -> "PreemptionGuard":
        if not self.enabled:
            return self
        if threading.current_thread() is not threading.main_thread():
            self.enabled = False      # signal API is main-thread-only
            return self
        for sig in self.SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self._installed = False
        return False

    def deadline_exceeded(self) -> bool:
        return (self.fired_at is not None
                and time.monotonic() - self.fired_at > self.deadline_s)
