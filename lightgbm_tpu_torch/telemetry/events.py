"""Structured run-event log: append-only JSONL, one record per
operational event (a copy of ``lightgbm_tpu/telemetry/events.py``).

Analog of the reference's per-iteration logger stream (gbdt.cpp's
"Iteration:%d, ..." lines) made machine-readable: a training run writes
a header record (config fingerprint, driver, feature flags, versions)
and typed records for eval-point iterations, checkpoint write/restore,
preemption, nan-guard trips, device-loss retries, serving
swap/rollback, ingest passes, and warning/fatal log lines. ``python -m
lightgbm_tpu_torch monitor`` renders a log into a
phase/throughput/faults report. :data:`EVENT_TYPES` is the JAX
package's table unchanged, so each package's :func:`check_records`
accepts the other's logs.

Sync discipline: records are emitted ONLY at existing host sync points
(engine.train's eval-cadence sync, checkpoint boundaries, fault
handlers) — every number in an ``iteration`` record was already on the
host when the record is written, so a captured run stays one graph
replay an iteration with zero added device syncs.

Durability: appends go through ``resilience.atomic_io.
atomic_append_line`` (O_APPEND + single write — no torn lines); a
SIGKILL can truncate only the final record, which readers skip. On
``resume=auto`` the restored run *splices* the log: iteration/checkpoint
records beyond the restore point are dropped (they will be re-emitted
bit-identically by the resumed run) and the header is re-emitted with
the same config fingerprint, so a spliced log reads exactly like an
uninterrupted run's log plus its fault history.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..resilience.atomic_io import atomic_append_line, atomic_write_text

__all__ = ["EventLog", "EVENT_TYPES", "check_records", "read_events",
           "set_active", "active", "record_log", "record_serving"]

# Required payload fields per event type (beyond the envelope: every
# record carries ``event``, ``ts``, ``seq``). `monitor --check`
# validates against this table.
EVENT_TYPES: Dict[str, tuple] = {
    "run_header": ("fingerprint", "driver", "versions"),
    "iteration": ("iter", "ms_per_tree", "metrics", "phase_s"),
    "checkpoint": ("action", "iter", "path"),
    "preemption": ("signum", "iter"),
    "nan_guard": ("iter", "policy"),
    "resume": ("iter", "path"),
    # elastic resilience: a resume re-sharded checkpoint state onto a
    # different topology; the supervisor retried/degraded after a
    # device loss. Fault records — the resume splice keeps them.
    "reshard": ("iter", "from", "to"),
    "degraded": ("iter", "attempt", "action"),
    "early_stop": ("iter", "best_iter"),
    "log": ("level", "msg"),
    "serving": ("action", "model"),
    "train_end": ("iter", "trees", "wall_s"),
    "cost_model": ("label", "flops", "bytes_accessed"),
    "perf_gate": ("status", "checked", "failed"),
    # out-of-core ingest (data/ingest.py): one record per completed
    # pass; shard writes are individually atomic so the log is
    # observability, not recovery state
    "ingest": ("action", "rows", "shards"),
}


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL event log. A non-parsing FINAL line is an
    interrupted run's torn tail and is skipped; a non-parsing interior
    line is corruption and raises."""
    records: List[Dict[str, Any]] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return []
    for i, ln in enumerate(lines):
        if not ln.strip():
            continue
        try:
            records.append(json.loads(ln))
        except ValueError:
            if i == len(lines) - 1:
                break  # torn tail from a killed writer
            raise ValueError(f"{path}:{i + 1}: corrupt event record")
    return records


def check_records(records: List[Dict[str, Any]]) -> List[str]:
    """Schema self-check (`monitor --check`): returns a list of
    problems, empty when the log is well-formed."""
    errors: List[str] = []
    last_seq = -1
    last_iter: Optional[int] = None
    header_fps = set()
    for i, rec in enumerate(records):
        where = f"record {i}"
        ev = rec.get("event")
        if ev not in EVENT_TYPES:
            errors.append(f"{where}: unknown event type {ev!r}")
            continue
        for key in ("ts", "seq") + EVENT_TYPES[ev]:
            if key not in rec:
                errors.append(f"{where} ({ev}): missing field {key!r}")
        seq = rec.get("seq", -1)
        if isinstance(seq, int):
            if seq <= last_seq:
                errors.append(f"{where} ({ev}): seq {seq} not "
                              f"increasing (prev {last_seq})")
            last_seq = seq
        if ev == "run_header":
            header_fps.add(rec.get("fingerprint"))
            last_iter = None  # resumed segment restarts the iter chain
        elif ev == "iteration":
            it = rec.get("iter")
            if isinstance(it, int) and last_iter is not None \
                    and it <= last_iter:
                errors.append(f"{where}: iteration {it} after "
                              f"{last_iter} (duplicate or out of order)")
            if isinstance(it, int):
                last_iter = it
    if not records:
        errors.append("empty event log")
    elif records[0].get("event") != "run_header":
        errors.append("first record is not a run_header")
    if len(header_fps) > 1:
        errors.append(f"run_header fingerprints disagree: "
                      f"{sorted(map(str, header_fps))}")
    return errors


class EventLog:
    """Append-only JSONL writer bound to one path.

    Thread-safe: the sequence counter and append are under one lock
    (the exporter's HTTP threads never write, but log.py routing can
    fire from any thread)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._lock = threading.Lock()
        self._closed = False
        # continue the sequence across resume: a spliced log keeps its
        # monotone seq so `check_records` can order segments
        self._seq = max((r.get("seq", -1) for r in read_events(self.path)
                         if isinstance(r.get("seq"), int)), default=-1)

    def append(self, event: str, **fields: Any) -> Dict[str, Any]:
        if event not in EVENT_TYPES:
            raise ValueError(f"unknown event type {event!r}")
        with self._lock:
            if self._closed:
                return {}
            self._seq += 1
            rec = {"event": event, "ts": round(time.time(), 6),
                   "seq": self._seq}
            rec.update(fields)
            atomic_append_line(self.path,
                               json.dumps(rec, sort_keys=True))
        return rec

    def records(self) -> List[Dict[str, Any]]:
        return read_events(self.path)

    def tail(self, n: int = 50) -> List[Dict[str, Any]]:
        return self.records()[-max(int(n), 0):]

    def splice_to_iteration(self, iteration: int) -> int:
        """Resume splice: atomically rewrite the log without the
        iteration/checkpoint-write records BEYOND the restore point —
        the resumed run re-emits those bit-identically, so keeping them
        would duplicate the chain. Fault records (preemption,
        nan_guard, log) stay: they are history, not progress. Returns
        the number of records dropped."""
        with self._lock:
            records = read_events(self.path)
            keep = []
            for rec in records:
                ev = rec.get("event")
                it = rec.get("iter")
                beyond = isinstance(it, int) and it > iteration
                if ev == "iteration" and beyond:
                    continue
                if ev == "checkpoint" and rec.get("action") == "write" \
                        and beyond:
                    continue
                if ev == "train_end":
                    continue  # the resumed run owns the final record
                keep.append(rec)
            if len(keep) != len(records):
                atomic_write_text(
                    self.path,
                    "".join(json.dumps(r, sort_keys=True) + "\n"
                            for r in keep))
            return len(records) - len(keep)

    def close(self) -> None:
        with self._lock:
            self._closed = True


# ----------------------------------------------------------------------
# Active-run registration: log.py routes warning/fatal records here and
# serving routes swap/rollback, without either importing engine state.

_ACTIVE: Optional[EventLog] = None
_ROUTING = threading.local()


def set_active(log: Optional[EventLog]) -> None:
    global _ACTIVE
    _ACTIVE = log


def active() -> Optional[EventLog]:
    return _ACTIVE


def _route(event: str, **fields: Any) -> None:
    """Best-effort append to the active run's log. Reentrancy-guarded:
    an append failure that logged a warning must not recurse."""
    log = _ACTIVE
    if log is None or getattr(_ROUTING, "busy", False):
        return
    _ROUTING.busy = True
    try:
        log.append(event, **fields)
    except Exception:
        pass  # observability must never take down training
    finally:
        _ROUTING.busy = False


def record_log(level: str, msg: str) -> None:
    """log.py's single choke point: warning/fatal lines of an active
    run land in its event log verbatim (no second formatting path)."""
    _route("log", level=level, msg=msg)


def record_serving(action: str, model: str,
                   version: Optional[int] = None) -> None:
    """Serving swap/rollback events (model registry movements)."""
    _route("serving", action=action, model=model, version=version)
