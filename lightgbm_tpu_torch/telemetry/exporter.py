"""Opt-in live introspection during training (a port of
``lightgbm_tpu/telemetry/exporter.py``).

A long training run on the card is a black box between eval points;
this module makes it a server. ``engine.train`` starts one when
``telemetry_port`` is set (param or ``LIGHTGBM_TPU_TELEMETRY_PORT``;
port 0 picks a free port), serving:

- ``GET /metrics``  — Prometheus text render of the run's registry.
- ``GET /events?n=`` — tail of the run-event log as JSONL.
- ``GET /healthz``  — run liveness: current iteration, trees, syncs,
  and ``capturing`` while a ``/trace`` window is open.
- ``GET /trace?duration_ms=`` — an on-demand ``torch.profiler`` capture
  (CPU and, once CUDA is initialised, CUDA activities, every thread) of
  the next N ms. The response carries :func:`summarize_trace`'s summary
  of the exported Chrome trace — device ms per kernel name, the
  device's busy ms and busy share of the window, and device ms per
  phase (the phase range around each kernel's launch, the rest in an
  explicit ``unknown`` bucket) — plus the capture dir. Captures land as
  numbered ``capture_NNNN`` dirs (``trace.json`` + ``summary.json``)
  under one tracked root with keep-last-N retention. A profiler that
  fails to start or stop, or a CUDA capture that recorded launches but
  no device activity, answers 500 — never a 200 naming a dangling dir
  or a CPU-only trace. One capture at a time (409 otherwise).
- ``SIGUSR1`` — dump the run's state + phase totals through
  ``log.info``.

Stdlib-only HTTP, the same ThreadingHTTPServer shape as
``serving/server.py``. Scrapes read host-side state exclusively
(counters, gauges, the event log file) — a scrape never adds a device
sync to the training loop.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from .. import profiler
from ..phases import KNOWN_PHASES
from .core import MetricsRegistry
from .events import EventLog

__all__ = ["IntrospectionServer", "CaptureError", "install_sigusr1",
           "summarize_trace", "SUMMARY_FILE", "UNKNOWN"]

_MAX_TRACE_MS = 60_000
SUMMARY_FILE = "summary.json"
UNKNOWN = "unknown"
# device-timeline categories of a kineto Chrome trace, the host API
# calls that carry a correlation id, and those of them that put work on
# the device
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_WORK_APIS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
              "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
_STEP_PREFIX = "boost_iter#"


class CaptureError(RuntimeError):
    """A profiler capture failed (the profiler did not start or stop, or
    recorded CUDA launches and no device activity) — distinct from the
    409 capture-already-running RuntimeError so the handler answers 500
    with the failure."""


def summarize_trace(path: str,
                    window_ms: Optional[float] = None) -> Dict[str, Any]:
    """Summarize a ``torch.profiler`` Chrome trace: device ms and launch
    count per kernel name, the device's busy ms (the union of kernel,
    memcpy and memset intervals) and its share of ``window_ms`` (by
    default the trace's own span), and device ms per phase.

    A kernel's phase is the innermost ``phases.py`` range that encloses
    the host call that launched it (matched by the launch's correlation
    id) on the launching thread; a kernel of a ``CUDAGraph.replay()``
    carries the replay's ``cudaGraphLaunch`` correlation, so it takes
    the phase around the replay, if any. Kernels with no enclosing
    phase land in ``unknown``."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) \
        else data
    device, launches, ranges = [], {}, {}
    host_ranges: Dict[str, int] = {}
    steps = graph_launches = work_calls = 0
    t_lo, t_hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts = float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0))
        t_lo, t_hi = min(t_lo, ts), max(t_hi, end)
        name = str(e.get("name", ""))
        if cat in _DEVICE_CATS:
            device.append((ts, end, cat, name,
                           (e.get("args") or {}).get("correlation")))
        elif cat in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ((e.get("pid"), e.get("tid")), ts, name)
            if name.startswith("cudaGraphLaunch"):
                graph_launches += 1
            if name.startswith(_WORK_APIS):
                work_calls += 1
        elif cat == "user_annotation":
            if name in KNOWN_PHASES:
                ranges.setdefault((e.get("pid"), e.get("tid")),
                                  []).append((ts, end, name))
                host_ranges[name] = host_ranges.get(name, 0) + 1
            elif name.startswith(_STEP_PREFIX):
                steps += 1
    # per thread: ranges by start, with the running max of their ends,
    # so an enclosing-range lookup walks back only while one can still
    # cover the launch
    index = {}
    for key, rs in ranges.items():
        rs.sort()
        ends, hi = [], float("-inf")
        for _, end, _ in rs:
            hi = max(hi, end)
            ends.append(hi)
        index[key] = ([r[0] for r in rs], ends, rs)

    def phase_of(corr) -> str:
        hit = launches.get(corr)
        if hit is None or hit[0] not in index:
            return UNKNOWN
        (starts, max_end, rs), t = index[hit[0]], hit[1]
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and max_end[i] >= t:
            if rs[i][1] >= t:
                return rs[i][2]
            i -= 1
        return UNKNOWN

    kernels: Dict[str, Dict[str, float]] = {}
    phase_ms: Dict[str, float] = {}
    graph_kernels = 0
    for ts, end, cat, name, corr in device:
        if cat != "kernel":
            continue
        ms = (end - ts) / 1e3
        k = kernels.setdefault(name, {"ms": 0.0, "n": 0})
        k["ms"] += ms
        k["n"] += 1
        ph = phase_of(corr)
        phase_ms[ph] = phase_ms.get(ph, 0.0) + ms
        hit = launches.get(corr)
        if hit is not None and hit[2].startswith("cudaGraphLaunch"):
            graph_kernels += 1
    busy_us, cur_lo, cur_hi = 0.0, None, None
    for ts, end, *_ in sorted(device):
        if cur_hi is None or ts > cur_hi:
            if cur_hi is not None:
                busy_us += cur_hi - cur_lo
            cur_lo, cur_hi = ts, end
        else:
            cur_hi = max(cur_hi, end)
    if cur_hi is not None:
        busy_us += cur_hi - cur_lo
    if window_ms is None:
        window_ms = max(t_hi - t_lo, 0.0) / 1e3 if device or launches \
            else 0.0
    busy_ms = busy_us / 1e3
    return {
        "window_ms": round(float(window_ms), 3),
        "device_busy_ms": round(busy_ms, 3),
        "device_busy_share": (round(busy_ms / window_ms, 4)
                              if window_ms > 0 else 0.0),
        "kernels": {n: {"ms": round(v["ms"], 3), "n": int(v["n"])}
                    for n, v in sorted(kernels.items(),
                                       key=lambda kv: -kv[1]["ms"])},
        "phase_device_ms": {p: round(v, 3)
                            for p, v in sorted(phase_ms.items())},
        "host_phase_ranges": dict(sorted(host_ranges.items())),
        "steps": steps,
        "device_events": len(device),
        "cuda_launches": work_calls,
        "graph_launches": graph_launches,
        "graph_kernels": graph_kernels,
    }


class IntrospectionServer:
    """Background HTTP server over one registry + event log."""

    def __init__(self, registry: MetricsRegistry,
                 event_log: Optional[EventLog] = None,
                 health_fn: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 capture_root: Optional[str] = None,
                 keep_captures: int = 4):
        self.registry = registry
        self.event_log = event_log
        self.health_fn = health_fn
        self.host, self.port = host, int(port)
        # profiler captures nest under one tracked root as
        # capture_NNNN dirs with keep-last-N retention; the telemetry
        # session points this at <run dir>/traces so monitor --perf
        # finds them next to the event log
        self.capture_root = capture_root
        self.keep_captures = max(1, int(keep_captures))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._trace_lock = threading.Lock()
        self._capture_seq = 0
        # True while a /trace window is open (the profiler started and
        # not yet stopped): work the process launches now is traced
        self.capturing = False

    def start(self) -> int:
        """Bind + serve from a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port
        app = self

        class Handler(_Handler):
            server_app = app

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 32

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        # tight poll: shutdown() blocks a serve_forever poll period, and
        # the default 0.5 s would bill every telemetry session close
        # (train return) half a second of wall clock
        self._thread = threading.Thread(
            target=lambda: self._serve(self._httpd),
            name="telemetry-http", daemon=True)
        self._thread.start()
        return self.port

    @staticmethod
    def _serve(httpd: ThreadingHTTPServer) -> None:
        try:
            httpd.serve_forever(poll_interval=0.05)
        except Exception:  # noqa: BLE001 — the server must die quietly
            pass

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _capture_dir(self) -> str:
        if self.capture_root is None:
            self.capture_root = tempfile.mkdtemp(
                prefix="lgbtpu_traces_")
        os.makedirs(self.capture_root, exist_ok=True)
        self._capture_seq += 1
        d = os.path.join(self.capture_root,
                         f"capture_{self._capture_seq:04d}")
        os.makedirs(d, exist_ok=True)
        return d

    def _prune_captures(self) -> None:
        try:
            caps = sorted(e for e in os.listdir(self.capture_root)
                          if e.startswith("capture_"))
        except OSError:
            return
        for stale in caps[:-self.keep_captures]:
            shutil.rmtree(os.path.join(self.capture_root, stale),
                          ignore_errors=True)

    def capture_trace(self, duration_ms: int) -> dict:
        """Synchronous ``torch.profiler`` capture of the next N ms,
        summarized before answering."""
        duration_ms = max(1, min(int(duration_ms), _MAX_TRACE_MS))
        if not self._trace_lock.acquire(blocking=False):
            raise RuntimeError("a trace capture is already running")
        try:
            log_dir = self._capture_dir()
            t0 = time.perf_counter()
            try:
                prof = profiler.start_profile()
            except Exception as e:  # noqa: BLE001
                shutil.rmtree(log_dir, ignore_errors=True)
                raise CaptureError(f"profiler start failed: "
                                   f"{type(e).__name__}: {e}") from e
            t1 = time.perf_counter()
            self.capturing = True
            try:
                time.sleep(duration_ms / 1e3)
            finally:
                t2 = time.perf_counter()
                try:
                    path = profiler.stop_profile(prof, log_dir)
                except Exception as e:  # noqa: BLE001
                    # a 200 naming this dir would hand the caller a
                    # capture that was never serialized
                    shutil.rmtree(log_dir, ignore_errors=True)
                    raise CaptureError(
                        f"profiler stop failed: {type(e).__name__}: {e}"
                    ) from e
                finally:
                    self.capturing = False
            self._prune_captures()
            resp = {"log_dir": log_dir, "duration_ms": duration_ms,
                    "profiler_start_ms": round((t1 - t0) * 1e3, 3),
                    "profiler_stop_ms": round(
                        (time.perf_counter() - t2) * 1e3, 3)}
            try:
                summary = summarize_trace(path,
                                          window_ms=(t2 - t1) * 1e3)
            except (OSError, ValueError) as e:
                # the capture is still on disk and usable offline
                resp["parse_error"] = f"{type(e).__name__}: {e}"
                return resp
            if summary["cuda_launches"] and not summary["device_events"]:
                # work went to the device in the window and the trace
                # holds none of it: CUPTI did not record
                shutil.rmtree(log_dir, ignore_errors=True)
                raise CaptureError(
                    f"the capture recorded {summary['cuda_launches']} "
                    "CUDA launches and no device activity (CUPTI "
                    "tracing is not working)")
            with open(os.path.join(log_dir, SUMMARY_FILE), "w",
                      encoding="utf-8") as f:
                json.dump(summary, f, sort_keys=True)
            resp.update(summary)
            return resp
        finally:
            self._trace_lock.release()


class _Handler(BaseHTTPRequestHandler):
    server_app: IntrospectionServer = None  # bound per-server subclass
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through our logger
        from .. import log
        log.debug(f"telemetry: {self.address_string()} {fmt % args}")

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802 (http.server API)
        app = self.server_app
        parsed = urlparse(self.path)
        path = parsed.path.rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(200, app.registry.render().encode(),
                           "text/plain; version=0.0.4")
            elif path == "/healthz":
                health = {"status": "ok", "capturing": app.capturing}
                if app.health_fn is not None:
                    health.update(app.health_fn() or {})
                self._send_json(200, health)
            elif path == "/events":
                if app.event_log is None:
                    self._send_json(404, {"error": "no event log active"})
                    return
                q = parse_qs(parsed.query)
                n = int((q.get("n") or ["50"])[0])
                body = "".join(json.dumps(r, sort_keys=True) + "\n"
                               for r in app.event_log.tail(n))
                self._send(200, body.encode(), "application/x-ndjson")
            elif path == "/trace":
                q = parse_qs(parsed.query)
                ms = int((q.get("duration_ms") or ["1000"])[0])
                self._send_json(200, app.capture_trace(ms))
            else:
                self._send_json(404, {"error": f"unknown path {path}"})
        except CaptureError as e:
            self._send_json(500, {"error": str(e)})
        except RuntimeError as e:
            self._send_json(409, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — a scrape must not kill
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})


def install_sigusr1(dump_fn: Callable[[], None]):
    """Install a SIGUSR1 dump handler; returns a restore() callable.

    Signals can only be installed from the main thread — elsewhere
    (e.g. a test driving train() from a worker thread) this is a no-op
    whose restore() does nothing, matching PreemptionGuard's posture.
    """
    if threading.current_thread() is not threading.main_thread() \
            or not hasattr(signal, "SIGUSR1") or os.name == "nt":
        return lambda: None

    def _handler(signum, frame):
        try:
            dump_fn()
        except Exception:
            pass  # a dump must never take down training

    prev = signal.signal(signal.SIGUSR1, _handler)

    def restore():
        try:
            signal.signal(signal.SIGUSR1, prev)
        except (ValueError, TypeError):
            pass

    return restore
