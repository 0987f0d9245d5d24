"""Capture discipline: count CUDA-graph captures and kernel-library
loads, enforce bounds (the port of
``lightgbm_tpu/analysis/recompile_guard.py``).

Steady-state training must not re-capture: the step captures ONE graph
per GOSS phase of a booster (``GBDT._capture``) and replays it every
iteration after, and the kernels' library loads once a process
(``ops.cuda_histogram.load_library``). A capture costs the body's eager
run plus the capture; a shape or a Python value leaking into the step
would turn the one-capture contract into a capture per iteration. This
guard makes the contract testable::

    with CaptureGuard(max_captures=0, boosters=[bst], label="steady"):
        for _ in range(20):
            bst.update()
    # raises CaptureError (TD201) when a capture or a load happened

It counts the watched boosters' ``GBDT.capture_count`` plus the
library's loads (``cuda_histogram.LIBRARY_LOADS``) inside the scope.
The serving batcher's bound is counted apart by :class:`ShapeRecorder`,
which wraps the batcher's ``predict_fn`` and records the distinct batch
shapes it sees (the power-of-two ladder allows
``log2(max_batch_rows) + 1``), where the JAX doctor reads a jitted
function's ``cache_size``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

from .report import TraceReport

__all__ = ["CaptureGuard", "CaptureError", "ShapeRecorder"]


class CaptureError(AssertionError):
    """Raised when a guarded scope exceeds its capture bound; carries
    the TD201 :class:`~.report.TraceReport` as ``.report``."""

    def __init__(self, report: TraceReport):
        self.report = report
        super().__init__(report.render())


def _gbdt(b):
    return getattr(b, "_gbdt", None) or b


class CaptureGuard:
    """Context manager counting graph captures and library loads in its
    scope.

    ``max_captures`` is the scope's documented bound (1 a GOSS phase for
    a booster's first iterations, 0 for a warmed steady state).
    ``boosters`` are the Boosters (or GBDTs) whose captures count. On
    exit the guard raises :class:`CaptureError` when the count exceeds
    the bound, unless ``strict=False``: the report is then kept on
    ``.report``. An error raised inside the scope propagates unmasked.
    """

    def __init__(self, max_captures: int, *, boosters: Sequence = (),
                 label: str = "scope", strict: bool = True):
        self.max_captures = int(max_captures)
        self.boosters = [_gbdt(b) for b in boosters]
        self.label = label
        self.strict = strict
        self.captures = 0
        self.loads = 0
        self.report: Optional[TraceReport] = None
        self._start = None

    @staticmethod
    def _loads() -> int:
        from ..ops import cuda_histogram as CH
        return CH.LIBRARY_LOADS

    def __enter__(self) -> "CaptureGuard":
        self._start = ([g.capture_count for g in self.boosters],
                       self._loads())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        counts, loads = self._start
        self.captures = sum(g.capture_count - c
                            for g, c in zip(self.boosters, counts))
        self.loads = self._loads() - loads
        rep = TraceReport(label=self.label)
        n = self.captures + self.loads
        if n > self.max_captures:
            rep.add("TD201", "error", "graph_capture",
                    f"{self.captures} CUDA-graph capture(s) and "
                    f"{self.loads} kernel-library load(s) in a scope "
                    f"bounded to {self.max_captures}; a shape or a host "
                    "value is leaking into the step and forcing it to "
                    "re-capture")
        self.report = rep
        if exc_type is not None:        # don't mask the real failure
            return False
        if self.strict and not rep.ok:
            raise CaptureError(rep)
        return False


class ShapeRecorder:
    """``fn`` wrapped to record the distinct shapes of its first
    argument (thread-safe: the batcher calls it from its worker)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.shapes: set = set()
        self._lock = threading.Lock()

    def __call__(self, X, *args, **kwargs):
        with self._lock:
            self.shapes.add(tuple(getattr(X, "shape", ())))
        return self.fn(X, *args, **kwargs)

    @property
    def signatures(self) -> int:
        return len(self.shapes)
