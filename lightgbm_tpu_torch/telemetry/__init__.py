"""Runtime telemetry subsystem (a port of ``lightgbm_tpu/telemetry``):
metrics registry, run-event log, device accounting, live introspection.

Analog of the reference's operational instrumentation
(``Common::Timer``/``FunctionTimer``, common.h:973,1037, plus the
per-iteration logger stream) for long training runs on the card:

- :mod:`~lightgbm_tpu_torch.telemetry.core` — Counter/Gauge/
  RingHistogram + labelled families and the Prometheus text render,
  shared with serving;
- :mod:`~lightgbm_tpu_torch.telemetry.events` — append-only JSONL
  run-event log with typed records, written only at existing sync
  points (the JAX package's schema, so either package reads the
  other's logs);
- :mod:`~lightgbm_tpu_torch.telemetry.device` — device-memory
  watermarks, graph-capture counters, collective gauges (no
  readbacks);
- :mod:`~lightgbm_tpu_torch.telemetry.exporter` — the opt-in
  ``telemetry_port`` HTTP server (/metrics /events /healthz /trace,
  the last a ``torch.profiler`` capture) and the SIGUSR1 dump handler;
- :mod:`~lightgbm_tpu_torch.telemetry.monitor` — ``python -m
  lightgbm_tpu_torch monitor <run_dir>``: render an event log into a
  report, ``--check`` its schema, ``--perf`` the captures;
- :mod:`~lightgbm_tpu_torch.telemetry.costmodel` and
  :mod:`~lightgbm_tpu_torch.telemetry.perf` — the captured step's cost
  report and the card's peaks; the tolerance-band gate library.

:class:`TelemetrySession` composes these for ``engine.train``: the
engine calls the ``on_*`` hooks exclusively from host code that has
already synced (the eval-cadence sync block, checkpoint writes, fault
handlers), so a telemetry-enabled run issues exactly the same device
syncs as a bare one and trains the same trees.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from .. import log, profiler
from . import events as _events
from .core import Counter, Gauge, MetricsRegistry, RingHistogram
from .device import CollectiveWatch, DeviceWatch
from .events import EventLog
from .exporter import IntrospectionServer, install_sigusr1

__all__ = ["Counter", "Gauge", "RingHistogram", "MetricsRegistry",
           "EventLog", "IntrospectionServer", "TelemetrySession",
           "active_session"]

_SESSION: Optional["TelemetrySession"] = None


def active_session() -> Optional["TelemetrySession"]:
    """The TelemetrySession of the currently-running train(), if any
    (how a test or sidecar discovers the bound port)."""
    return _SESSION


class TelemetrySession:
    """One training run's telemetry: registry + event log + device
    watches + optional HTTP exporter, created by ``engine.train`` when
    ``telemetry_port``/``event_log`` ask for it.

    The cost-model gauges keep the JAX package's names and contract: a
    scrape of ``train_fused_flops_per_iter``/``_bytes_per_iter`` arms a
    flag, and the next sync point builds the captured step's
    :class:`~.costmodel.CostReport` on the training thread (and logs a
    ``cost_model`` record). No compiler prices a torch step, so both
    read 0, and ``train_achieved_tflops``/``train_mfu`` stay unset."""

    def __init__(self, event_log_path: Optional[str] = None,
                 port: Optional[int] = None):
        self.registry = MetricsRegistry()
        self.events: Optional[EventLog] = (
            EventLog(event_log_path) if event_log_path else None)
        self.port: Optional[int] = None
        self._want_port = port
        self.server: Optional[IntrospectionServer] = None
        self.device = DeviceWatch(self.registry)
        self.collectives = CollectiveWatch(self.registry,
                                           self._trees_built)
        self.phase_totals = profiler.PhaseTotals()
        self._booster = None
        self._restore_sig = lambda: None
        self._started = False
        # progress state, all host-side
        self._iter = 0
        self._t0 = time.monotonic()
        self._last_sync_t = self._t0
        self._last_sync_iter = 0
        self._last_phase: Dict[str, Tuple[float, int]] = {}
        self._c_iters = self.registry.counter(
            "train_iterations_total", "Boosting iterations completed")
        self._c_trees = self.registry.counter(
            "train_trees_total", "Trees materialized or pending")
        self._g_ms_tree = self.registry.gauge(
            "train_ms_per_tree",
            "Wall ms per tree over the last sync window")
        self._g_iter = self.registry.gauge(
            "train_iteration", "Current iteration (1-based, completed)")
        self._g_metric = self.registry.gauge(
            "train_eval_metric", "Last evaluated metric values",
            labels=("data", "metric"))
        self._g_phase = self.registry.gauge(
            "train_phase_seconds_total",
            "Host wall seconds per training phase (phases.py names)",
            labels=("phase",))
        self.registry.gauge(
            "train_host_syncs_total",
            "Booster host syncs (device ring drains)",
            fn=self._host_syncs)
        self._c_nan = self.registry.counter(
            "train_nan_guard_total", "Nan-guard incidents")
        self._c_ckpt = self.registry.counter(
            "train_checkpoints_total", "Checkpoint writes/restores",
            labels=("action",))
        self.registry.gauge("train_uptime_seconds",
                            "Seconds since telemetry start",
                            fn=lambda: time.monotonic() - self._t0)
        self._perf_want = False
        self._cost_cache: Any = None      # None | False | CostReport
        self.registry.gauge(
            "train_fused_flops_per_iter",
            "Flops of one captured step (0: no compiler prices it)",
            fn=lambda: self._cost_field("flops"))
        self.registry.gauge(
            "train_fused_bytes_per_iter",
            "Bytes accessed by one captured step (0: no compiler "
            "prices it)",
            fn=lambda: self._cost_field("bytes_accessed"))
        self.registry.gauge(
            "train_achieved_tflops",
            "Achieved TFLOP/s: captured-step flops x iteration rate")
        self.registry.gauge(
            "train_mfu",
            "Achieved TFLOP/s vs the card's peak (known cards only)")

    @classmethod
    def from_config(cls, cfg, params: Dict[str, Any]
                    ) -> Optional["TelemetrySession"]:
        """None unless telemetry_port or event_log enables the
        subsystem (param first; the env var covers unmodified
        entry points)."""
        port = int(cfg.telemetry_port)
        if port < 0:
            env = os.environ.get("LIGHTGBM_TPU_TELEMETRY_PORT")
            if env is not None and env.strip() != "":
                try:
                    port = int(env)
                except ValueError:
                    log.warning("ignoring non-integer "
                                f"LIGHTGBM_TPU_TELEMETRY_PORT={env!r}")
        path = str(cfg.event_log).strip()
        if path == "auto":
            path = str(cfg.output_model) + ".events.jsonl"
        if port < 0 and not path:
            return None
        return cls(event_log_path=path or None,
                   port=port if port >= 0 else None)

    # -- helpers -------------------------------------------------------
    def _gb(self):
        b = self._booster() if self._booster is not None else None
        return getattr(b, "_gbdt", None) if b is not None else None

    def _trees_built(self) -> int:
        gb = self._gb()
        return len(gb.models) if gb is not None else 0

    def _host_syncs(self) -> int:
        gb = self._gb()
        return int(getattr(gb, "host_sync_count", 0)) if gb else 0

    def _cost_field(self, attr: str) -> float:
        """Gauge fn: read the cached CostReport, arming the want-flag on
        a miss (the next on_sync builds it; scrapes never do)."""
        rep = self._cost_cache
        if rep is None:
            self._perf_want = True
        return float(getattr(rep, attr, 0.0) or 0.0) if rep else 0.0

    def _build_perf(self) -> None:
        """The captured step's CostReport (training thread, at a sync
        point), and its ``cost_model`` record."""
        from .costmodel import step_cost_report
        rep = step_cost_report(self._gb())
        self._cost_cache = rep if rep is not None else False
        if rep is not None and self.events is not None:
            self.events.append(
                "cost_model", label=rep.label, flops=rep.flops,
                bytes_accessed=rep.bytes_accessed,
                peak_bytes=rep.peak_bytes, n_ops=rep.n_ops)

    # -- lifecycle (engine.train) --------------------------------------
    def begin_run(self, booster, cfg, params: Dict[str, Any],
                  fingerprint: Optional[str],
                  resumed_from: Optional[Tuple[str, int]] = None) -> None:
        """Start watches/exporter and write the run header. On resume,
        splice the existing log to the restored iteration first so the
        re-emitted records chain without duplicates."""
        global _SESSION
        # weak: the session is a reference cycle (its gauges' callbacks
        # close over it) and is freed only by the cyclic collector; a
        # strong reference would keep the booster's device memory and
        # CUDA graphs alive with it, to be destroyed whenever that
        # collector runs, even inside another run's graph capture
        self._booster = weakref.ref(booster)
        booster._ensure_gbdt()
        gb = self._gb()
        self.device.attach(gb)
        self._iter = self._last_sync_iter = booster.current_iteration()
        self._last_sync_t = time.monotonic()
        if self.events is not None:
            if resumed_from is not None:
                self.events.splice_to_iteration(resumed_from[1])
            self.events.append("run_header", **self._header(
                gb, cfg, fingerprint))
            if resumed_from is not None:
                self.events.append("resume", iter=resumed_from[1],
                                   path=resumed_from[0])
            _events.set_active(self.events)
        profiler.add_phase_collector(self.phase_totals)
        self.device.sample()
        if self._want_port is not None:
            capture_root = None
            if self.events is not None and self.events.path:
                capture_root = os.path.join(
                    os.path.dirname(os.path.abspath(self.events.path))
                    or ".", "traces")
            self.server = IntrospectionServer(
                self.registry, event_log=self.events,
                health_fn=self._health,
                port=int(self._want_port),
                capture_root=capture_root)
            try:
                self.port = self.server.start()
            except OSError as e:
                # fail open: a taken port (another run, a stale
                # sidecar) must not kill a healthy training job — the
                # exporter is observability, not a dependency
                log.warning(
                    f"telemetry: cannot bind exporter port "
                    f"{self._want_port} ({e}); continuing without "
                    "live introspection")
                self.server = None
                self.port = None
            else:
                log.info("telemetry: serving "
                         f"http://127.0.0.1:{self.port} "
                         "(/metrics /events /healthz /trace)")
        self._restore_sig = install_sigusr1(self.dump_to_log)
        self._started = True
        _SESSION = self

    def _header(self, gb, cfg, fingerprint) -> Dict[str, Any]:
        import numpy as np
        import torch

        from .. import __version__ as _ver
        dev = gb.device
        return {
            "fingerprint": fingerprint,
            # the JAX package's driver names, so monitor reports compare
            "driver": "fused" if gb.fused_train_ok else "legacy",
            "versions": {"lightgbm_tpu_torch": _ver,
                         "torch": torch.__version__,
                         "numpy": np.__version__},
            "tree_learner": str(cfg.tree_learner),
            "parallel_mode": "serial",
            "num_shards": 1,
            "dp_hist_merge": "",
            "class_batch": bool(gb.class_batch_ok),
            "num_class": int(gb.K),
            "objective": str(cfg.objective),
            "num_leaves": int(cfg.num_leaves),
            "eval_period": int(cfg.eval_period),
            "devices": [f"cuda:{dev.index}" if dev.type == "cuda"
                        else "cpu"],
        }

    def _health(self) -> Dict[str, Any]:
        return {"iteration": self._iter, "trees": self._trees_built(),
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "host_syncs": self._host_syncs()}

    # -- engine hooks (sync points only) -------------------------------
    def on_sync(self, iteration: int,
                evals: Optional[List[tuple]] = None) -> None:
        """Eval-cadence sync point: everything recorded here is already
        on the host (the booster just drained its ring)."""
        now = time.monotonic()
        gb = self._gb()
        k = int(getattr(gb, "K", 1)) if gb is not None else 1
        d_iter = max(iteration - self._last_sync_iter, 0)
        ms_tree = ((now - self._last_sync_t) * 1e3 / (d_iter * k)
                   if d_iter > 0 else 0.0)
        metrics = {f"{name}:{metric}": float(value)
                   for name, metric, value, _ in (evals or [])}
        phase_s: Dict[str, Dict[str, float]] = {}
        for name, tot, cnt in self.phase_totals.items():
            p_tot, p_cnt = self._last_phase.get(name, (0.0, 0))
            if d_iter > 0:
                phase_s[name] = {
                    "s_per_iter": (tot - p_tot) / d_iter,
                    "spans_per_iter": (cnt - p_cnt) / d_iter}
            self._last_phase[name] = (tot, cnt)
            self._g_phase.labels(name).set(tot)
        self._c_iters.inc(d_iter)
        self._c_trees.inc(d_iter * k)
        self._g_iter.set(iteration)
        if d_iter > 0:
            self._g_ms_tree.set(ms_tree)
        if self._perf_want and self._cost_cache is None:
            self._build_perf()
        for name, metric, value, _ in (evals or []):
            self._g_metric.labels(name, metric).set(value)
        self.device.sample()
        self._iter = iteration
        self._last_sync_iter = iteration
        self._last_sync_t = now
        if self.events is not None and d_iter > 0:
            self.events.append("iteration", iter=iteration,
                               ms_per_tree=round(ms_tree, 3),
                               metrics=metrics, phase_s=phase_s,
                               host_syncs=self._host_syncs())

    def on_checkpoint(self, action: str, iteration: int,
                      path: str, ok: bool = True) -> None:
        self._c_ckpt.labels(action if ok else f"{action}_failed").inc()
        if self.events is not None:
            rec = {"action": action, "iter": iteration, "path": path}
            if not ok:
                rec["ok"] = False
            self.events.append("checkpoint", **rec)

    def on_reshard(self, iteration: int, from_topo: Dict[str, Any],
                   to_topo: Dict[str, Any]) -> None:
        """A resume restored checkpoint state written under another
        topology (called right after begin_run, already synced)."""
        if self.events is not None:
            self.events.append("reshard", iter=iteration,
                               **{"from": from_topo, "to": to_topo})

    def on_preemption(self, signum: int, iteration: int) -> None:
        if self.events is not None:
            self.events.append("preemption", signum=int(signum),
                               iter=iteration)

    def on_nan_guard(self, iteration: int, policy: str,
                     action: str) -> None:
        self._c_nan.inc()
        if self.events is not None:
            self.events.append("nan_guard", iter=iteration,
                               policy=policy, action=action)

    def on_early_stop(self, iteration: int, best_iter: int) -> None:
        if self.events is not None:
            self.events.append("early_stop", iter=iteration,
                               best_iter=best_iter)

    def dump_to_log(self) -> None:
        """SIGUSR1: one human-readable state dump through log.info."""
        snap = self._health()
        log.info(f"telemetry dump: iteration={snap['iteration']} "
                 f"trees={snap['trees']} uptime={snap['uptime_s']}s "
                 f"host_syncs={snap['host_syncs']}")
        log.info("telemetry phase totals:\n"
                 + self.phase_totals.render(self._iter or None))

    def close(self, ended: bool) -> None:
        """Tear down in reverse order. ``ended`` False (an exception is
        unwinding) suppresses train_end so the fault record written by
        the handler stays the log's last word."""
        global _SESSION
        if _SESSION is self:
            _SESSION = None
        _events.set_active(None)
        self._restore_sig()
        self._restore_sig = lambda: None
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self._started:
            profiler.remove_phase_collector(self.phase_totals)
            self._started = False
        if self.events is not None:
            if ended:
                self.events.append(
                    "train_end", iter=self._iter,
                    trees=self._trees_built(),
                    wall_s=round(time.monotonic() - self._t0, 3))
            self.events.close()
