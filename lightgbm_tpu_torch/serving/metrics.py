"""Serving observability: lock-cheap counters + ring-buffer latency
histograms, rendered in the Prometheus text exposition format.

No reference analog — LightGBM stops at the C API boundary
(src/c_api.cpp) and ships no service layer; the field set follows what
the micro-batching scheduler needs to be tuned in production: queue-wait
vs compute split (is latency admission or the kernel?), batch-size
distribution (is coalescing happening?), and per-model request/error
counts (is a deploy failing?).

A copy of ``lightgbm_tpu/serving/metrics.py``. The primitives
(Counter, RingHistogram) and the text renderer live in
``telemetry/core.py``; this module keeps the serving-specific field set
and its exact render bytes (pinned by tests). A ``PredictionServer``
mounts this set onto its :class:`~lightgbm_tpu_torch.telemetry.core.
MetricsRegistry` as a collector, so ``/metrics`` is one registry
render.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from ..telemetry.core import (Counter, RingHistogram, render_counter,
                              render_summary)

__all__ = ["Counter", "RingHistogram", "ServingMetrics"]


class ServingMetrics:
    """The metric set of the serving subsystem, one instance per server.

    Exported families (``render()``, Prometheus text format):

    ========================================  =============================
    field                                     meaning
    ========================================  =============================
    serve_requests_total{model=}              requests accepted per model
    serve_errors_total{model=}                requests that raised
    serve_overload_total                      fast-failed at admission
    serve_rows_total                          rows predicted (pre-padding)
    serve_batches_total                       kernel calls issued
    serve_batch_rows{quantile=} / _mean       coalesced batch size
    serve_queue_wait_seconds{quantile=}       enqueue -> batch start
    serve_compute_seconds{quantile=}          kernel call duration
    serve_rows_per_s                          window throughput gauge
    serve_swaps_total / serve_rollbacks_total registry movements
    serve_uptime_seconds                      since metrics creation
    serve_request_wait_seconds{quantile=}     per-REQUEST enqueue wait
    serve_row_wait_p99                        row-weighted wait p99
    serve_budget_rejected_total{model=}       QPS-budget admission fails
    ========================================  =============================

    ``serve_queue_wait_seconds`` observes once per BATCH (the oldest
    request's wait) — under a coalesced burst that under-weights the
    many requests that joined late. ``serve_request_wait_seconds``
    observes every request, and ``serve_row_wait_p99`` weights each
    request's wait by its row count, so a 1000-row straggler moves the
    tail the way 1000 single-row stragglers would.
    """

    def __init__(self, hist_size: int = 4096):
        self._lock = threading.Lock()        # label-map creation only
        self.requests_total: Dict[str, Counter] = {}
        self.errors_total: Dict[str, Counter] = {}
        self.overload_total = Counter()
        self.rows_total = Counter()
        self.batches_total = Counter()
        self.swaps_total = Counter()
        self.rollbacks_total = Counter()
        self.budget_rejected_total: Dict[str, Counter] = {}
        self.batch_rows = RingHistogram(hist_size)
        self.queue_wait_s = RingHistogram(hist_size)
        self.compute_s = RingHistogram(hist_size)
        self.request_wait_s = RingHistogram(hist_size)
        # paired rings (same observe cadence): each request's wait next
        # to its row count, so the row-weighted percentile can be
        # recomputed over the retained window at render time
        self._req_wait = RingHistogram(hist_size)
        self._req_rows = RingHistogram(hist_size)
        # (monotonic_ts, rows) per batch: windowed rows/s gauge
        self._thru = RingHistogram(hist_size)
        self._thru_ts = RingHistogram(hist_size)
        self._t0 = time.monotonic()

    # -- recording hooks (called by batcher/registry/server) -----------
    def _labelled(self, family: Dict[str, Counter], model: str) -> Counter:
        c = family.get(model)
        if c is None:
            with self._lock:
                c = family.setdefault(model, Counter())
        return c

    def on_request(self, model: str, rows: int):
        self._labelled(self.requests_total, model).inc()

    def on_error(self, model: str):
        self._labelled(self.errors_total, model).inc()

    def on_overload(self):
        self.overload_total.inc()

    def on_batch(self, rows: int, queue_wait_s: float, compute_s: float):
        now = time.monotonic()
        self.batches_total.inc()
        self.rows_total.inc(rows)
        self.batch_rows.observe(float(rows))
        self.queue_wait_s.observe(queue_wait_s)
        self.compute_s.observe(compute_s)
        self._thru.observe(float(rows))
        self._thru_ts.observe(now)

    def on_request_wait(self, wait_s: float, rows: int):
        """Per-request wait at batch start (one call per request of the
        batch, row count attached for the weighted tail)."""
        self.request_wait_s.observe(wait_s)
        self._req_wait.observe(wait_s)
        self._req_rows.observe(float(rows))

    def on_budget_rejected(self, model: str):
        self._labelled(self.budget_rejected_total, model).inc()

    def row_wait_p99(self) -> float:
        """Row-weighted p99 of request wait over the retained window:
        the wait below which 99% of ROWS (not requests) started."""
        w = self._req_wait.window()
        r = self._req_rows.window()
        m = min(w.size, r.size)      # rings race by at most one slot
        if m == 0:
            return 0.0
        w, r = w[:m], r[:m]
        order = w.argsort()
        w, r = w[order], r[order]
        cum = r.cumsum()
        total = cum[-1]
        if total <= 0:
            return float(w[-1])
        idx = int((cum >= 0.99 * total).argmax())
        return float(w[idx])

    def mean_batch_rows(self) -> float:
        return self.batch_rows.summary()[2]

    def rows_per_s(self) -> float:
        """Throughput over the retained batch window."""
        ts = self._thru_ts.window()
        if ts.size < 2:
            return 0.0
        span = float(ts.max() - ts.min())
        if span <= 0:
            return 0.0
        return float(self._thru.window().sum()) / span

    # -- export --------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition (text/plain; version=0.0.4)."""
        out: List[str] = []

        render_counter(out, "serve_requests_total",
                       "Accepted predict requests",
                       [(f'{{model="{m}"}}', c.value)
                        for m, c in sorted(self.requests_total.items())] or
                       [("", 0)])
        render_counter(out, "serve_errors_total", "Requests that raised",
                       [(f'{{model="{m}"}}', c.value)
                        for m, c in sorted(self.errors_total.items())] or
                       [("", 0)])
        render_counter(out, "serve_overload_total",
                       "Requests fast-failed at admission control",
                       [("", self.overload_total.value)])
        render_counter(out, "serve_rows_total",
                       "Rows predicted (pre-padding)",
                       [("", self.rows_total.value)])
        render_counter(out, "serve_batches_total", "Coalesced kernel calls",
                       [("", self.batches_total.value)])
        render_counter(out, "serve_swaps_total", "Model hot-swaps",
                       [("", self.swaps_total.value)])
        render_counter(out, "serve_rollbacks_total", "Model rollbacks",
                       [("", self.rollbacks_total.value)])
        render_summary(out, "serve_batch_rows", "Rows per coalesced batch",
                       self.batch_rows)
        render_summary(out, "serve_queue_wait_seconds",
                       "Enqueue to batch start", self.queue_wait_s)
        render_summary(out, "serve_compute_seconds",
                       "Kernel call duration", self.compute_s)
        out.append("# HELP serve_rows_per_s Window throughput")
        out.append("# TYPE serve_rows_per_s gauge")
        out.append(f"serve_rows_per_s {self.rows_per_s():.9g}")
        out.append("# HELP serve_uptime_seconds Seconds since start")
        out.append("# TYPE serve_uptime_seconds gauge")
        out.append(
            f"serve_uptime_seconds {time.monotonic() - self._t0:.3f}")
        render_summary(out, "serve_request_wait_seconds",
                       "Per-request enqueue to batch start",
                       self.request_wait_s)
        out.append("# HELP serve_row_wait_p99 Row-weighted wait p99")
        out.append("# TYPE serve_row_wait_p99 gauge")
        out.append(f"serve_row_wait_p99 {self.row_wait_p99():.9g}")
        render_counter(out, "serve_budget_rejected_total",
                       "Requests rejected by per-model QPS budgets",
                       [(f'{{model="{m}"}}', c.value)
                        for m, c in
                        sorted(self.budget_rejected_total.items())] or
                       [("", 0)])
        return "\n".join(out) + "\n"
