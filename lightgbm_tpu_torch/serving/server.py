"""Async prediction server over the micro-batcher, replica fleet and
model registry (port of ``lightgbm_tpu/serving/server.py``; the JAX
package's CLI ``serve`` task waits for the port's CLI).

Stdlib-only, selector-based: ONE event-loop thread owns every socket
(accept, parse, write), and a ``/predict`` body is handed to the
per-model :class:`~.batcher.MicroBatcher` (or the active version's
:class:`~.replica.ReplicaSet`) via ``submit_async`` — the response is
written when the batch completion fires, so a thousand in-flight
requests cost a thousand small buffers, not a thousand parked threads.
The event loop never touches the device: the batcher thread runs the
predict, including its copy back to the host (an implicit sync).

Request routing:

- model has a replica fleet (``replicas=N``): the request goes straight
  to the least-loaded replica's batcher — per-device queues, one
  in-flight kernel per device, results tagged with the fleet's pinned
  ModelVersion.
- otherwise: the classic per-model batcher whose ``predict_fn`` is
  ``registry.predict`` (resolves the active version once per BATCH —
  the whole-model guarantee under hot-swap).
- per-model QPS budgets (``qps_budget=``) gate admission before either
  queue: 429 with ``status="budget_exceeded"``, so one tenant's burst
  cannot occupy another's batcher capacity.

Endpoints (unchanged contract):

- ``POST /predict[?model=name]`` — body either JSON
  ``{"data": [[...], ...]}`` (``"rows"`` accepted as an alias) or a raw
  ``.npy`` matrix (``Content-Type: application/x-npy`` or
  ``application/octet-stream``). JSON in -> JSON
  ``{"predictions": ..., "model": ..., "version": ...}`` out; npy in ->
  npy float64 out with the model identity in ``X-Model-Name`` /
  ``X-Model-Version`` headers (bit-exact round-trip). Overload ->
  ``429`` + ``Retry-After`` with ``{"status": "overloaded",
  "retriable": true}``; budget -> ``429`` with
  ``{"status": "budget_exceeded", "retriable": true}``.
- ``GET /models`` — active versions (now incl. compiled/replica
  state); ``POST /models/swap`` ``{"name", "file"}`` hot-swaps (load +
  full-ladder warm off-path on a helper thread, then atomic publish);
  ``POST /models/rollback`` ``{"name"?}`` republishes the previous
  version. Control ops never run on the event loop.
- ``GET /healthz/alive`` — 200 while the process serves HTTP at all
  (liveness); ``GET /healthz`` / ``GET /healthz/ready`` — 200 once a
  model serves AND the server is not draining, 503 otherwise.
- ``GET /metrics`` — Prometheus text (field reference: metrics.py).

Graceful drain: ``drain()`` flips readiness, stops accepting connections, finishes queued
batcher work (``MicroBatcher.close(drain=True)``, replica fleets
included), flushes the responses those completions produce, then
returns — a rolling restart loses no accepted request.
"""

from __future__ import annotations

import io
import json
import selectors
import socket
import threading
from collections import deque
from http.client import responses as _REASONS
from typing import Dict, List, Optional, Tuple, Union
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..telemetry.core import MetricsRegistry
from .batcher import MicroBatcher, Overloaded
from .metrics import ServingMetrics
from .registry import ModelRegistry
from .replica import BudgetExceeded, QpsBudget

__all__ = ["PredictionServer"]

_NPY_TYPES = ("application/x-npy", "application/octet-stream")
_MAX_HEADER = 64 * 1024
_MAX_BODY = 1 << 30


class _Conn:
    """One client connection's state, owned by the event loop."""

    __slots__ = ("sock", "inbuf", "outbuf", "busy", "close_after",
                 "open")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.busy = False          # a request is in flight; don't parse
        self.close_after = False
        self.open = True


_Resp = Tuple[int, bytes, str, Optional[dict]]


class PredictionServer:
    """Own the registry, the per-model batchers/replica fleets and the
    async HTTP front end.

    ``start()`` binds (port 0 picks a free port) and runs the event
    loop from a daemon thread; ``serve_forever()`` runs it on the
    calling thread.

    ``replicas=N`` + ``compiled_predict=True`` configure the registry
    so every subsequently registered model is tensorized
    (``codegen.CompiledEnsemble``) and fanned out across devices;
    ``qps_budget`` is a per-model requests/s cap (one float applied to
    every model, or a ``{name: qps}`` dict). Models load onto
    ``device_type`` (default ``"cuda"``, which raises without a GPU;
    ``"cpu"`` serves on the host) unless a ``registry`` is passed.
    """

    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 host: str = "127.0.0.1", port: int = 8080,
                 max_batch_rows: int = 1024, max_wait_us: int = 2000,
                 max_queue_rows: Optional[int] = None,
                 min_bucket: int = 16,
                 metrics: Optional[ServingMetrics] = None,
                 telemetry: Optional[MetricsRegistry] = None,
                 replicas: int = 0, compiled_predict: bool = False,
                 qps_budget: Union[None, float, Dict[str, float]] = None,
                 replica_devices=None, device_type: str = "cuda"):
        self.metrics = metrics or ServingMetrics()
        self.registry = registry or ModelRegistry(metrics=self.metrics,
                                                  device_type=device_type)
        if registry is not None and registry.metrics is not self.metrics:
            registry.metrics = self.metrics
        # the unified registry (telemetry/core.py): serving's families
        # mount as a collector, so /metrics here is one registry render
        # — identical bytes when no other families are registered
        self.telemetry = telemetry or MetricsRegistry()
        self.telemetry.register_collector("serving", self.metrics.render)
        self.host, self.port = host, int(port)
        self._batcher_opts = dict(max_batch_rows=int(max_batch_rows),
                                  max_wait_us=int(max_wait_us),
                                  max_queue_rows=max_queue_rows,
                                  min_bucket=int(min_bucket))
        self._batchers: Dict[str, MicroBatcher] = {}
        self._block = threading.Lock()
        self._stop_lock = threading.Lock()
        self.draining = False
        self._fleet = int(replicas) > 0 or bool(compiled_predict)
        # every rung the bucket ladder can produce is warmed off-path
        # at register time (registry._load), at ANY rung, on ANY
        # replica
        self.registry.configure_serving(
            warm_ladder=self._ladder(),
            compiled_predict=(bool(compiled_predict)
                              if self._fleet else None),
            replicas=int(replicas) if replicas else None,
            devices=replica_devices,
            batcher_opts=self._batcher_opts if self._fleet else None)
        if isinstance(qps_budget, dict):
            self._budgets: Dict[str, QpsBudget] = {
                m: QpsBudget(q) for m, q in qps_budget.items()}
            self._default_qps = None
        else:
            self._budgets = {}
            self._default_qps = (float(qps_budget)
                                 if qps_budget is not None else None)
        # event-loop state
        self._sel: Optional[selectors.BaseSelector] = None
        self._listen: Optional[socket.socket] = None
        self._wake_r: Optional[socket.socket] = None
        self._wake_w: Optional[socket.socket] = None
        self._conns: Dict[socket.socket, _Conn] = {}
        self._completions: deque = deque()
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _ladder(self) -> List[int]:
        """Every batch shape ``bucket_rows`` can emit below the cap."""
        rungs: List[int] = []
        b = max(int(self._batcher_opts["min_bucket"]), 1)
        mx = int(self._batcher_opts["max_batch_rows"])
        while b < mx:
            rungs.append(b)
            b <<= 1
        rungs.append(mx)
        return rungs

    # -- predict plumbing ---------------------------------------------
    def _batcher(self, name: str) -> MicroBatcher:
        b = self._batchers.get(name)
        if b is None:
            with self._block:
                b = self._batchers.get(name)
                if b is None:
                    b = MicroBatcher(
                        lambda X, _n=name: self.registry.predict(X, _n),
                        metrics=self.metrics, model=name,
                        **self._batcher_opts)
                    self._batchers[name] = b
        return b

    def _budget(self, name: str) -> Optional[QpsBudget]:
        q = self._budgets.get(name)
        if q is None and self._default_qps is not None:
            with self._block:
                q = self._budgets.setdefault(
                    name, QpsBudget(self._default_qps))
        return q

    def _admit(self, name: str):
        q = self._budget(name)
        if q is not None and not q.try_admit():
            self.metrics.on_budget_rejected(name)
            raise BudgetExceeded(name, q.qps)

    def _replica_set(self, name: str):
        try:
            return self.registry.resolve(name).replicas
        except LookupError:
            return None   # the batcher path surfaces the LookupError

    def predict(self, X, model: Optional[str] = None):
        """(result, ModelVersion) through the replica fleet when the
        active version has one, else the per-model micro-batcher."""
        name = model or self.registry.default_name
        if name is None:
            raise LookupError("no model registered")
        self._admit(name)
        rs = self._replica_set(name)
        if rs is not None:
            return rs.submit_tagged(X)
        return self._batcher(name).submit_tagged(X)

    def predict_async(self, X, model: Optional[str],
                      callback) -> None:
        """``callback(result, error, version)`` fires off-loop when the
        batch lands; admission errors raise synchronously."""
        name = model or self.registry.default_name
        if name is None:
            raise LookupError("no model registered")
        self._admit(name)
        rs = self._replica_set(name)
        if rs is not None:
            rs.submit_async(X, callback)
        else:
            self._batcher(name).submit_async(X, callback)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> int:
        """Bind + run the event loop from a daemon thread; returns the
        bound port."""
        self._bind()
        self._thread = threading.Thread(
            target=self._run_loop, name="serving-http", daemon=True)
        self._thread.start()
        return self.port

    def serve_forever(self):
        self._bind()
        try:
            self._run_loop()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def _bind(self):
        if self._listen is not None:
            return
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(128)
        s.setblocking(False)
        self.port = s.getsockname()[1]
        self._listen = s
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(s, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")

    def _wakeup(self):
        w = self._wake_w
        if w is not None:
            try:
                w.send(b"x")
            except OSError:
                pass

    def stop(self):
        """Idempotent shutdown: stop accepting, drain batcher work
        (replica fleets included), flush the responses it produced,
        then exit the loop. Safe to call concurrently and from any
        thread — including the loop thread via ``serve_forever``'s
        ``finally``."""
        with self._stop_lock:
            batchers = list(self._batchers.values())
            self._batchers = {}
            thread, self._thread = self._thread, None
            fleet, self._fleet = self._fleet, False
        for b in batchers:
            # drain=True: queued requests are answered before the
            # worker exits — accepted work is never dropped
            b.close(drain=True)
        if fleet:
            self.registry.close()   # replica batchers drain the same way
        self._shutdown.set()
        self._wakeup()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10)
        # the loop tears its own sockets down on exit (_teardown); the
        # serve_forever path reaches here after that already happened

    def drain(self) -> None:
        """Graceful drain (SIGTERM path): flip readiness so load
        balancers route away, then stop — finishing in-flight batcher
        work before returning."""
        self.draining = True
        self.stop()

    # -- event loop ----------------------------------------------------
    def _run_loop(self):
        sel = self._sel
        try:
            while not self._shutdown.is_set():
                for key, mask in sel.select(timeout=0.5):
                    data = key.data
                    if data == "accept":
                        self._accept()
                    elif data == "wake":
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                    else:
                        if mask & selectors.EVENT_READ:
                            self._on_read(data)
                        if data.open and mask & selectors.EVENT_WRITE:
                            self._on_write(data)
                self._flush_completions()
        finally:
            self._teardown()

    def _teardown(self):
        # answer whatever completed during the drain, then close
        self._flush_completions()
        for conn in list(self._conns.values()):
            if conn.outbuf and conn.open:
                try:
                    conn.sock.settimeout(2.0)
                    conn.sock.sendall(bytes(conn.outbuf))
                except OSError:
                    pass
            self._close_conn(conn)
        for s in (self._listen, self._wake_r, self._wake_w):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._listen = self._wake_r = self._wake_w = None
        if self._sel is not None:
            self._sel.close()
            self._sel = None

    def _accept(self):
        while True:
            try:
                sock, _addr = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)

    def _close_conn(self, conn: _Conn):
        if not conn.open:
            return
        conn.open = False
        self._conns.pop(conn.sock, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _interest(self, conn: _Conn):
        if not conn.open:
            return
        ev = selectors.EVENT_READ
        if conn.outbuf:
            ev |= selectors.EVENT_WRITE
        try:
            self._sel.modify(conn.sock, ev, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _on_read(self, conn: _Conn):
        try:
            chunk = conn.sock.recv(65536)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        if not chunk:
            self._close_conn(conn)
            return
        conn.inbuf += chunk
        if not conn.busy:
            self._try_parse(conn)

    def _on_write(self, conn: _Conn):
        try:
            n = conn.sock.send(bytes(conn.outbuf))
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        del conn.outbuf[:n]
        if not conn.outbuf:
            if conn.close_after:
                self._close_conn(conn)
                return
            self._interest(conn)
            if conn.busy:
                conn.busy = False
                self._try_parse(conn)   # a pipelined request may wait

    # -- HTTP parsing / dispatch --------------------------------------
    def _try_parse(self, conn: _Conn):
        while conn.open and not conn.busy:
            head_end = conn.inbuf.find(b"\r\n\r\n")
            if head_end < 0:
                if len(conn.inbuf) > _MAX_HEADER:
                    self._queue_resp(conn, (431, json.dumps(
                        {"error": "headers too large"}).encode(),
                        "application/json", None), close=True)
                return
            head = bytes(conn.inbuf[:head_end]).decode(
                "latin-1").split("\r\n")
            try:
                method, target, version = head[0].split(" ", 2)
            except ValueError:
                self._queue_resp(conn, (400, json.dumps(
                    {"error": "malformed request line"}).encode(),
                    "application/json", None), close=True)
                return
            headers = {}
            for ln in head[1:]:
                k, _, v = ln.partition(":")
                headers[k.strip().lower()] = v.strip()
            try:
                clen = int(headers.get("content-length") or 0)
            except ValueError:
                clen = 0
            if clen < 0 or clen > _MAX_BODY:
                self._queue_resp(conn, (413, json.dumps(
                    {"error": "body too large"}).encode(),
                    "application/json", None), close=True)
                return
            if len(conn.inbuf) < head_end + 4 + clen:
                return                      # body still in flight
            body = bytes(conn.inbuf[head_end + 4:head_end + 4 + clen])
            del conn.inbuf[:head_end + 4 + clen]
            conn.close_after = (
                headers.get("connection", "").lower() == "close"
                or version == "HTTP/1.0")
            conn.busy = True
            self._dispatch(conn, method, target, headers, body)

    def _dispatch(self, conn: _Conn, method: str, target: str,
                  headers: dict, body: bytes):
        parts = urlsplit(target)
        path = parts.path.rstrip("/") or "/"
        if method == "GET":
            self._queue_resp(conn, self._guard(
                lambda: self._handle_get(path)))
        elif method == "POST":
            if path == "/predict":
                resp = self._guard(lambda: self._start_predict(
                    conn, parts.query, headers, body))
                if resp is not None:        # admission failed in-line
                    self._queue_resp(conn, resp)
            elif path in ("/models/swap", "/models/rollback"):
                # control ops block (load + full-ladder warm): never on
                # the event loop
                op = (self._do_swap if path == "/models/swap"
                      else self._do_rollback)
                threading.Thread(
                    target=lambda: self._complete(conn, self._guard(
                        lambda: op(body))),
                    name="serve-control", daemon=True).start()
            else:
                self._queue_resp(conn, (404, json.dumps(
                    {"error": f"unknown path {path}"}).encode(),
                    "application/json", None))
        else:
            self._queue_resp(conn, (405, json.dumps(
                {"error": f"method {method} not allowed"}).encode(),
                "application/json", None))

    def _guard(self, fn) -> Optional[_Resp]:
        """Run ``fn`` under the endpoint error mapping; ``fn`` returns
        a response tuple or None (async completion pending)."""
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — mapped below
            return self._error_resp(e)

    def _error_resp(self, e: BaseException) -> _Resp:
        if isinstance(e, Overloaded):
            return (429, json.dumps(
                {"status": "overloaded", "retriable": True,
                 "error": str(e)}).encode(),
                "application/json", {"Retry-After": "1"})
        if isinstance(e, BudgetExceeded):
            return (429, json.dumps(
                {"status": "budget_exceeded", "retriable": True,
                 "error": str(e)}).encode(),
                "application/json", {"Retry-After": "1"})
        if isinstance(e, (ValueError, TypeError, KeyError, LookupError,
                          json.JSONDecodeError)):
            return (400, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode(),
                "application/json", None)
        return (500, json.dumps(
            {"error": f"{type(e).__name__}: {e}"}).encode(),
            "application/json", None)

    # -- GET endpoints -------------------------------------------------
    def _handle_get(self, path: str) -> _Resp:
        if path == "/healthz/alive":
            # liveness: the process answers HTTP — even while draining
            return (200, json.dumps({"status": "alive"}).encode(),
                    "application/json", None)
        if path in ("/healthz", "/healthz/ready"):
            if self.draining:
                return (503, json.dumps(
                    {"status": "draining"}).encode(),
                    "application/json", None)
            try:
                mv = self.registry.resolve()
                return (200, json.dumps(
                    {"status": "ok", "model": mv.name,
                     "version": mv.version}).encode(),
                    "application/json", None)
            except LookupError:
                return (503, json.dumps(
                    {"status": "no model registered"}).encode(),
                    "application/json", None)
        if path == "/metrics":
            return (200, self.telemetry.render().encode(),
                    "text/plain; version=0.0.4", None)
        if path == "/models":
            return (200, json.dumps(
                {"models": self.registry.models(),
                 "default": self.registry.default_name}).encode(),
                "application/json", None)
        return (404, json.dumps(
            {"error": f"unknown path {path}"}).encode(),
            "application/json", None)

    # -- POST endpoints ------------------------------------------------
    def _start_predict(self, conn: _Conn, query: str, headers: dict,
                       body: bytes) -> Optional[_Resp]:
        q = parse_qs(query)
        model = (q.get("model") or [None])[0]
        ctype = (headers.get("content-type") or "").split(";")[0]
        is_npy = ctype in _NPY_TYPES or body[:6] == b"\x93NUMPY"
        if is_npy:
            X = np.load(io.BytesIO(body), allow_pickle=False)
        else:
            req = json.loads(body.decode() or "{}")
            model = req.get("model", model)
            data = req.get("data", req.get("rows"))
            if data is None:
                raise ValueError('JSON body needs "data" (or "rows"): '
                                 'a row or list of rows')
            X = np.asarray(data, np.float64)

        def on_done(result, error, mv):
            if error is not None:
                self._complete(conn, self._error_resp(error))
                return
            self._complete(conn, self._guard(
                lambda: self._format_predict(result, mv, is_npy)))

        self.predict_async(X, model, on_done)
        return None                  # response comes via _complete

    def _format_predict(self, result, mv, is_npy: bool) -> _Resp:
        result = np.asarray(result, np.float64)
        if is_npy:
            buf = io.BytesIO()
            np.save(buf, result, allow_pickle=False)
            return (200, buf.getvalue(), "application/x-npy",
                    {"X-Model-Name": mv.name,
                     "X-Model-Version": mv.version})
        return (200, json.dumps(
            {"predictions": result.tolist(), "model": mv.name,
             "version": mv.version}).encode(),
            "application/json", None)

    def _do_swap(self, body: bytes) -> _Resp:
        req = json.loads(body.decode() or "{}")
        name = req.get("name") or self.registry.default_name or "default"
        source = req.get("file") or req.get("path")
        if not source:
            raise ValueError('swap needs "file": path to a model file')
        mv = self.registry.swap(name, source)
        return (200, json.dumps(
            {"status": "swapped", **mv.describe()}).encode(),
            "application/json", None)

    def _do_rollback(self, body: bytes) -> _Resp:
        req = json.loads(body.decode() or "{}")
        mv = self.registry.rollback(req.get("name"))
        return (200, json.dumps(
            {"status": "rolled back", **mv.describe()}).encode(),
            "application/json", None)

    # -- response plumbing ---------------------------------------------
    def _complete(self, conn: _Conn, resp: _Resp):
        """Queue a response from ANY thread; the loop writes it."""
        self._completions.append((conn, resp))
        self._wakeup()

    def _flush_completions(self):
        while True:
            try:
                conn, resp = self._completions.popleft()
            except IndexError:
                return
            if conn.open:
                self._queue_resp(conn, resp)

    def _queue_resp(self, conn: _Conn, resp: _Resp,
                    close: bool = False):
        code, body, ctype, headers = resp
        if close:
            conn.close_after = True
        reason = _REASONS.get(code, "")
        lines = [f"HTTP/1.1 {code} {reason}",
                 f"Content-Type: {ctype}",
                 f"Content-Length: {len(body)}"]
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        lines.append("Connection: close" if conn.close_after
                     else "Connection: keep-alive")
        conn.outbuf += ("\r\n".join(lines) + "\r\n\r\n").encode(
            "latin-1")
        conn.outbuf += body
        self._interest(conn)
        # opportunistic immediate write (loop thread): most responses
        # fit the socket buffer, saving one selector round-trip
        self._on_write(conn)
