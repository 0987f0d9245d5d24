"""Profiling / tracing hooks (a port of ``lightgbm_tpu/profiler.py``).

Analog of the reference timing instrumentation (``Common::Timer`` /
``FunctionTimer``, common.h:973,1037, compiled under TIMETAG). On the
card the native tool is ``torch.profiler`` (CUPTI): Chrome traces
viewable in Perfetto or ``chrome://tracing``, with per-iteration step
ranges emitted by engine.train::

    with lightgbm_tpu_torch.profiler.trace("/tmp/prof"):
        lgt.train(params, ds, 100)
    # then open /tmp/prof/trace.json in Perfetto

What the trace attributes:

- ``boost_iter#<i>`` step ranges (engine.train) delimit iterations.
- Training phases — ``grads`` / ``sampling`` / ``build`` / ``update`` /
  ``eval`` — are ``record_function`` ranges opened by :func:`phase` in
  both training drivers (boosting/gbdt.py), ``prefetch`` around the
  out-of-core staging and the two ingest phases in data/ingest.py:

  * the eager loop launches each phase's kernels inside its range, so
    a trace attributes their device time to the phase (the ``/trace``
    summary follows each kernel to the range around its launch);
  * the captured step runs its body only at iteration 0 and at the
    CUDA-graph capture, as the JAX fused step's phases run only at
    trace time: a replayed iteration opens no phase range, and its
    kernels, launched by one ``CUDAGraph.replay()``, land in the
    summary's ``unknown`` bucket.

- Wall-clock phase TOTALS: :func:`collect_phase_totals` aggregates
  every :func:`phase` span inside a block into per-phase (total
  seconds, span count). A span measures the host: around eager launches
  it covers the enqueue (and any host sync inside it), not the device
  time. Span COUNTS are driver- and knob-dependent — the per-class loop
  fires ``build`` K times per iteration where the class-batched build
  fires it once — so comparisons must use the per-iteration totals
  (:meth:`PhaseTotals.per_iteration`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from .phases import KNOWN_PHASES

__all__ = ["trace", "step_annotation", "annotate", "phase",
           "open_phases",
           "PhaseTotals", "collect_phase_totals",
           "add_phase_collector", "remove_phase_collector",
           "TRACE_FILE", "start_profile", "stop_profile"]

# the Chrome trace a capture writes into its directory
TRACE_FILE = "trace.json"


def start_profile(cuda: Optional[bool] = None):
    """Start a ``torch.profiler`` capture of every thread of the process
    (CPU activities, and CUDA's where CUDA is initialised or ``cuda``
    says so); returns the running profile. A capture started on one
    thread (the telemetry server's) sees another's (the training loop's)
    ranges only with ``profile_all_threads``; a torch build whose
    profiler config lacks it traces the device's kernels and the
    starting thread's ranges only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        _keep_cupti()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:
        cfg = None
    prof = profile(activities=acts, experimental_config=cfg)
    prof.start()
    return prof


def _keep_cupti() -> None:
    """Keep CUPTI attached once a capture has started it: the training
    step is a CUDA graph, and CUPTI's teardown after a capture (and its
    lazy re-initialisation at a later launch) can land inside a graph
    capture and invalidate it. This is the workaround torch.profiler
    itself applies when inductor's CUDA graphs are on
    (torch/profiler/profiler.py, ``TEARDOWN_CUPTI``); set before the
    profiler starts, where kineto reads them. A value the caller set is
    kept."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")


def stop_profile(prof, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``log_dir``;
    returns the trace's path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir/trace.json``."""
    prof = start_profile()
    try:
        yield
    finally:
        stop_profile(prof, log_dir)


def step_annotation(name: str, step_num: Optional[int] = None):
    """Step range (the per-iteration wall-clock log of
    gbdt.cpp:246-249, as trace events)."""
    from torch.profiler import record_function
    return record_function(name if step_num is None
                           else f"{name}#{step_num}")


def annotate(name: str):
    """Named sub-range inside a step (global_timer sections analog)."""
    from torch.profiler import record_function
    return record_function(name)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Training-phase range: a ``record_function(name)`` and, for every
    active :class:`PhaseTotals` collector, the span's host wall seconds.

    ``name`` must be one of the canonical phases (``phases.py``); an
    unknown name would emit spans nothing downstream accounts for.
    """
    if name not in KNOWN_PHASES:
        raise ValueError(
            f"unknown profiler phase {name!r}; canonical phases are "
            f"{sorted(KNOWN_PHASES)} (lightgbm_tpu_torch/phases.py — add "
            "new phases there)")
    from torch.profiler import record_function
    cols = _COLLECTORS
    t0 = time.perf_counter() if cols else 0.0
    stack = _open_stack()
    stack.append(name)
    try:
        with record_function(name):
            yield
    finally:
        stack.pop()
        if cols:
            dt = time.perf_counter() - t0
            for col in cols:
                col._record(name, dt)


# The phases open on each thread, outermost first (the trace doctor's
# op recorder tags each op with them, the collective record each call).
_OPEN = threading.local()


def _open_stack() -> List[str]:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def open_phases() -> Tuple[str, ...]:
    """The :func:`phase` spans open on this thread, outermost first."""
    return tuple(_open_stack())


# ----------------------------------------------------------------------
# Aggregated per-phase wall-clock totals.
#
# Every active collector sees every span (a tuple, swapped atomically
# under the GIL): a collect_phase_totals() block around lgt.train and
# the telemetry session's collector inside it both need the spans — a
# single-slot design would make the inner one steal from the outer.
_COLLECTORS: Tuple["PhaseTotals", ...] = ()


def add_phase_collector(col: "PhaseTotals") -> None:
    """Register an additional live collector (telemetry session)."""
    global _COLLECTORS
    _COLLECTORS = _COLLECTORS + (col,)


def remove_phase_collector(col: "PhaseTotals") -> None:
    global _COLLECTORS
    _COLLECTORS = tuple(c for c in _COLLECTORS if c is not col)


class PhaseTotals:
    """Per-phase aggregate of every :func:`phase` span inside a
    :func:`collect_phase_totals` block: total seconds and span count
    per phase name."""

    def __init__(self):
        self._acc: Dict[str, List[float]] = {}
        # spans arrive from any thread that annotates — the training
        # loop, the prefetch worker, serving threads. The += on the
        # accumulator list is a read-modify-write, NOT atomic under the
        # GIL, so concurrent spans would silently drop time.
        self._lock = threading.Lock()

    def _record(self, name: str, dt: float) -> None:
        with self._lock:
            ent = self._acc.setdefault(name, [0.0, 0])
            ent[0] += dt
            ent[1] += 1

    def total_s(self, name: str) -> float:
        with self._lock:
            return self._acc.get(name, [0.0, 0])[0]

    def count(self, name: str) -> int:
        with self._lock:
            return int(self._acc.get(name, [0.0, 0])[1])

    def items(self) -> List[Tuple[str, float, int]]:
        with self._lock:
            return [(k, v[0], int(v[1]))
                    for k, v in sorted(self._acc.items())]

    def per_iteration(self, iterations: int) -> Dict[str, dict]:
        """{phase: {total_s, count, s_per_iter, spans_per_iter}} —
        ``s_per_iter`` is the comparable number: the K per-class
        ``build`` spans of one iteration and the one class-batched span
        both aggregate to that iteration's build seconds."""
        it = max(int(iterations), 1)
        with self._lock:
            return {k: {"total_s": v[0], "count": int(v[1]),
                        "s_per_iter": v[0] / it,
                        "spans_per_iter": v[1] / it}
                    for k, v in sorted(self._acc.items())}

    def render(self, iterations: Optional[int] = None) -> str:
        rows = []
        for name, tot, cnt in self.items():
            line = f"{name:<12} {tot * 1e3:9.2f} ms  x{cnt}"
            if iterations:
                line += (f"  ({tot * 1e3 / max(iterations, 1):.2f} "
                         f"ms/iter over {iterations} iter)")
            rows.append(line)
        return "\n".join(rows) or "(no phase spans recorded)"


@contextlib.contextmanager
def collect_phase_totals() -> Iterator[PhaseTotals]:
    """Aggregate every :func:`phase` span inside the block into a
    :class:`PhaseTotals` (opt-in; collectors STACK — a nested block or
    a live telemetry session each get the same spans)."""
    col = PhaseTotals()
    add_phase_collector(col)
    try:
        yield col
    finally:
        remove_phase_collector(col)
