"""``python -m lightgbm_tpu_torch monitor <run_dir|events.jsonl>`` —
render a run-event log into a phase/throughput/faults report,
``--check`` its schema, or ``--perf`` the run's profiler captures (a
port of ``lightgbm_tpu/telemetry/monitor.py``).

The offline half of the telemetry subsystem: the event log
(telemetry/events.py) is what a run leaves behind; this turns it back
into the operational picture — what the run was (header), how fast it
went (ms/tree trajectory, per-phase seconds from
``PhaseTotals.per_iteration``), and what went wrong (preemptions,
nan-guard trips, rollbacks, device-loss retries, routed warnings).
``--check`` validates every record against the schema table
(``events.EVENT_TYPES``) and the ordering invariants (monotone seq, no
duplicate iteration records, consistent header fingerprints). The
schema is the JAX package's, so either package's logs read here.
``--perf`` reads the summary (``summary.json``) that the ``/trace``
endpoint saves beside each capture's Chrome trace.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

from .events import check_records, read_events
from .exporter import SUMMARY_FILE

__all__ = ["monitor_main", "find_event_logs", "render_report",
           "find_captures", "render_perf"]


def find_event_logs(target: str) -> List[str]:
    """A file is used as-is; a directory is scanned for
    ``*.events.jsonl`` (the ``event_log=auto`` naming) and
    ``events.jsonl``."""
    if os.path.isfile(target):
        return [target]
    if os.path.isdir(target):
        hits = sorted(glob.glob(os.path.join(target, "*.events.jsonl")))
        plain = os.path.join(target, "events.jsonl")
        if os.path.isfile(plain):
            hits.append(plain)
        return hits
    return []


def _topo_str(t: Any) -> str:
    """Compact one-line form of a checkpoint topology descriptor."""
    if not isinstance(t, dict):
        return str(t)
    merge = t.get("dp_hist_merge") or ""
    return (f"{t.get('tree_learner', '?')}x{t.get('num_shards', '?')}"
            + (f"/{merge}" if merge else "")
            + f" ({t.get('num_devices', '?')} dev)")


def render_report(path: str, records: List[Dict[str, Any]]) -> str:
    out: List[str] = [f"== {path} ({len(records)} records) =="]
    headers = [r for r in records if r["event"] == "run_header"]
    iters = [r for r in records if r["event"] == "iteration"]
    if headers:
        h = headers[-1]
        ver = h.get("versions", {})
        out.append(
            f"run: {h.get('objective', '?')} driver={h.get('driver')} "
            f"mode={h.get('parallel_mode')}x{h.get('num_shards')} "
            f"class_batch={h.get('class_batch')} "
            f"eval_period={h.get('eval_period')}")
        out.append(
            f"fingerprint: {h.get('fingerprint')}  ("
            + ", ".join(f"{k} {v}" for k, v in sorted(ver.items()))
            + ")")
        if len(headers) > 1:
            out.append(f"segments: {len(headers)} "
                       "(resumed run, spliced log)")
    if iters:
        last = iters[-1]
        ms = [r.get("ms_per_tree", 0.0) for r in iters
              if r.get("ms_per_tree")]
        out.append(f"progress: {last.get('iter')} iterations over "
                   f"{len(iters)} eval points; ms/tree last="
                   f"{(ms[-1] if ms else 0):.2f} "
                   f"mean={(sum(ms) / len(ms) if ms else 0):.2f}")
        if last.get("metrics"):
            out.append("metrics @ last eval: " + "  ".join(
                f"{k}={v:.6g}" for k, v in
                sorted(last["metrics"].items())))
        # per-phase seconds: mean s_per_iter across eval points
        phases: Dict[str, List[float]] = {}
        for r in iters:
            for name, d in (r.get("phase_s") or {}).items():
                phases.setdefault(name, []).append(
                    float(d.get("s_per_iter", 0.0)))
        if phases:
            out.append("phase seconds/iter (mean over eval points):")
            for name in sorted(phases):
                vals = phases[name]
                out.append(f"  {name:<12} "
                           f"{sum(vals) / len(vals) * 1e3:9.2f} ms/iter")
    faults: List[str] = []
    for r in records:
        ev = r["event"]
        if ev == "preemption":
            faults.append(f"preemption (signal {r.get('signum')}) at "
                          f"iteration {r.get('iter')}")
        elif ev == "nan_guard":
            faults.append(f"nan_guard {r.get('action', '?')} at "
                          f"iteration {r.get('iter')}")
        elif ev == "checkpoint" and r.get("action") == "restore":
            faults.append(f"checkpoint restore to iteration "
                          f"{r.get('iter')}")
        elif ev == "checkpoint" and r.get("ok") is False:
            faults.append(f"checkpoint {r.get('action', 'write')} "
                          f"FAILED at iteration {r.get('iter')} "
                          "(run continued)")
        elif ev == "resume":
            faults.append(f"resumed at iteration {r.get('iter')} from "
                          f"{os.path.basename(str(r.get('path')))}")
        elif ev == "reshard":
            faults.append(
                f"resharded at iteration {r.get('iter')}: "
                f"{_topo_str(r.get('from'))} -> "
                f"{_topo_str(r.get('to'))}")
        elif ev == "degraded":
            faults.append(
                f"device loss at iteration {r.get('iter')}: "
                f"{r.get('action')} (attempt {r.get('attempt')})")
        elif ev == "log" and r.get("level") == "warning":
            faults.append(f"warning: {str(r.get('msg'))[:90]}")
    writes = sum(1 for r in records if r["event"] == "checkpoint"
                 and r.get("action") == "write")
    out.append(f"checkpoints: {writes} written")
    out.append("faults: " + (f"{len(faults)}" if faults else "none"))
    out.extend(f"  - {f}" for f in faults)
    ends = [r for r in records if r["event"] == "train_end"]
    if ends:
        e = ends[-1]
        out.append(f"ended: iteration {e.get('iter')}, "
                   f"{e.get('trees')} trees, "
                   f"wall {e.get('wall_s'):.1f}s")
    else:
        out.append("ended: NO train_end record (run killed or still "
                   "running)")
    return "\n".join(out)


def find_captures(target: str) -> List[str]:
    """Profiler capture dirs of a run: ``<run_dir>/traces/capture_NNNN``
    (where the telemetry server lands them), or ``target`` itself when
    it directly holds ``capture_*`` dirs or is a single capture dir
    (one with a ``summary.json``)."""
    if not os.path.isdir(target):
        return []
    for root in (os.path.join(target, "traces"), target):
        caps = sorted(c for c in glob.glob(os.path.join(root, "capture_*"))
                      if os.path.isdir(c))
        if caps:
            return caps
    if os.path.isfile(os.path.join(target, SUMMARY_FILE)):
        return [target]
    return []


def render_perf(capture: str,
                records: Optional[List[Dict[str, Any]]] = None) -> str:
    """``monitor --perf``: one capture's summary (device ms per kernel,
    busy share, device ms per phase), crossed against the event log's
    measured ms/tree when one is available.

    The comparison divides the capture's device ms by the boosting
    iterations it saw (its ``boost_iter`` ranges) and sets that against
    the log's UNPROFILED ms/tree mean: a ratio below 1 is host time the
    device never saw."""
    out: List[str] = [f"-- capture {capture} --"]
    try:
        with open(os.path.join(capture, SUMMARY_FILE), "r",
                  encoding="utf-8") as f:
            s = json.load(f)
    except (OSError, ValueError) as e:
        return "\n".join(out + [f"  unreadable summary: {e}"])
    out.append(f"  window {s.get('window_ms', 0):.1f} ms: device busy "
               f"{s.get('device_busy_ms', 0):.2f} ms (share "
               f"{s.get('device_busy_share', 0):.3f}), "
               f"{s.get('steps', 0)} iterations, "
               f"{s.get('graph_launches', 0)} graph replays")
    kernels = s.get("kernels") or {}
    if kernels:
        out.append("  device ms by kernel (top 10):")
        for name, k in list(kernels.items())[:10]:
            out.append(f"    {k['ms']:10.3f} ms  x{k['n']:<6} "
                       f"{name[:80]}")
    phases = s.get("phase_device_ms") or {}
    if phases:
        out.append("  device ms by phase: " + "  ".join(
            f"{p}={v:.3f}" for p, v in sorted(phases.items())))
    steps = int(s.get("steps") or 0)
    dev_ms = sum(k["ms"] for k in kernels.values())
    ms = [r.get("ms_per_tree", 0.0) for r in (records or [])
          if r.get("event") == "iteration" and r.get("ms_per_tree")]
    if steps > 0 and dev_ms > 0 and ms:
        per_iter = dev_ms / steps
        mean_ms = sum(ms) / len(ms)
        out.append(
            f"  device {per_iter:.2f} ms/iter vs event-log ms/tree mean "
            f"{mean_ms:.2f} (ratio {per_iter / mean_ms:.3f}; <1 means "
            "host-side time the device never saw)")
    elif steps > 0 and dev_ms > 0:
        out.append(f"  device {dev_ms / steps:.2f} ms/iter (no event log "
                   "to compare against)")
    return "\n".join(out)


def monitor_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch monitor",
        description="Render a telemetry event log into a "
                    "phase/throughput/faults report.")
    ap.add_argument("target", nargs="?", default=".",
                    help="run directory or events.jsonl file "
                         "(default: cwd)")
    ap.add_argument("--check", action="store_true",
                    help="events-schema self-check: validate every "
                         "record and the ordering invariants; rc=1 on "
                         "any problem")
    ap.add_argument("--perf", action="store_true",
                    help="render the run's profiler captures "
                         "(<run_dir>/traces/capture_*) and compare their "
                         "device ms per iteration against the event "
                         "log's measured ms/tree")
    ns = ap.parse_args(argv)
    paths = find_event_logs(ns.target)
    if ns.perf:
        captures = find_captures(ns.target if os.path.isdir(ns.target)
                                 else os.path.dirname(ns.target) or ".")
        if not captures:
            print(f"no profiler captures under {ns.target!r} — "
                  "capture one via GET /trace?duration_ms=...")
            return 1
        records: List[Dict[str, Any]] = []
        for path in paths:
            try:
                records.extend(read_events(path))
            except ValueError:
                pass  # --perf only borrows ms/tree; --check owns schema
        for cap in captures:
            print(render_perf(cap, records))
            print()
        return 0
    if not paths:
        print(f"no event logs found under {ns.target!r} "
              "(looked for *.events.jsonl / events.jsonl)")
        return 1
    rc = 0
    for path in paths:
        try:
            records = read_events(path)
        except ValueError as e:
            print(f"{path}: CORRUPT — {e}")
            rc = 1
            continue
        if ns.check:
            problems = check_records(records)
            if problems:
                rc = 1
                print(f"{path}: {len(problems)} problem(s)")
                for p in problems:
                    print(f"  - {p}")
            else:
                print(f"{path}: OK ({len(records)} records)")
        else:
            print(render_report(path, records))
            print()
    return rc
