"""Micro-batching scheduler: coalesce concurrent predict requests into
one kernel call (a copy of ``lightgbm_tpu/serving/batcher.py``).

The per-call fixed cost of a prediction (HTTP handling, Python dispatch,
device launches) dwarfs the marginal per-row cost —
the same amortize-fixed-cost argument the batched GPU tree-walk
literature makes for trees (PAPERS.md: "GPU-acceleration for
Large-scale Tree Boosting") applied to *request aggregation*: N
concurrent 16-row requests as one 16N-row kernel call run at nearly the
cost of one.

Scheduling contract:

- A batch closes when the queue holds ``max_batch_rows`` rows, or
  ``max_wait_us`` after its OLDEST pending request arrived, whichever
  comes first. A lone request therefore waits out the deadline — tune
  ``max_wait_us`` down for latency-sensitive single-stream traffic.
- Requests are never split across batches; a request larger than
  ``max_batch_rows`` becomes its own (bucket-padded) oversized batch.
- Batches are padded up a fixed power-of-two bucket ladder before the
  kernel call, so the device path sees at most
  ``log2(max_batch_rows) + 1`` distinct shapes, each warmed off the
  serving path, whatever the request mix (tree walks are row-independent, so padding rows
  never changes real rows' results; pad rows are sliced off before
  scatter).
- Admission control: the queue is bounded at ``max_queue_rows``. A
  request that would overflow it fast-fails with :class:`Overloaded`
  (retriable) instead of queuing unbounded latency — the caller (or the
  HTTP layer, as 429 + Retry-After) decides whether to retry.

Whole-model guarantee: the batcher issues ONE ``predict_fn`` call per
batch, and ``predict_fn`` (``ModelRegistry.predict`` in the server)
resolves the active model exactly once per call — so every request's
result comes from exactly one model version, never a mix, even while a
hot-swap lands mid-burst (see ``registry.py`` and the
``PredictSession`` snapshot contract in ``engine.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .metrics import ServingMetrics

__all__ = ["MicroBatcher", "Overloaded", "bucket_rows"]


class Overloaded(RuntimeError):
    """Admission-control fast-fail; the request was NOT enqueued.

    ``retriable`` is True by definition: nothing about the request was
    wrong, the queue was full — retry after backoff.
    """

    retriable = True

    def __init__(self, queued_rows: int, max_queue_rows: int):
        super().__init__(
            f"serving queue full ({queued_rows}/{max_queue_rows} rows); "
            "retriable")
        self.queued_rows = queued_rows
        self.max_queue_rows = max_queue_rows


def bucket_rows(n: int, min_bucket: int, max_batch_rows: int) -> int:
    """Pad target for an ``n``-row batch: next power of two in
    ``[min_bucket, max_batch_rows]``; oversized batches (a single
    request above ``max_batch_rows``) pad to the next power of two so
    even they reuse ladder shapes."""
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return b if n > max_batch_rows else min(b, int(max_batch_rows))


class _Pending:
    __slots__ = ("X", "done", "result", "error", "tag", "t_enqueue",
                 "abandoned", "callback")

    def __init__(self, X: np.ndarray):
        self.X = X
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.tag = None
        self.t_enqueue = time.monotonic()
        self.abandoned = False
        self.callback = None

    def fire(self):
        self.done.set()
        cb = self.callback
        if cb is not None:
            cb(self.result, self.error, self.tag)


class MicroBatcher:
    """Coalesce concurrent ``submit()`` calls into batched
    ``predict_fn`` calls.

    ``predict_fn(X) -> result`` or ``(result, tag)``: called with a
    2-D float64 matrix whose row count is a ladder bucket; must return
    per-row results (1-D, or 2-D with rows first). ``tag`` (e.g. the
    serving model version) is handed back to every request of the
    batch.
    """

    def __init__(self, predict_fn: Callable, *,
                 max_batch_rows: int = 1024,
                 max_wait_us: int = 2000,
                 max_queue_rows: Optional[int] = None,
                 min_bucket: int = 16,
                 metrics: Optional[ServingMetrics] = None,
                 model: str = "default"):
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        if max_wait_us < 0:
            raise ValueError("max_wait_us must be >= 0")
        self._predict = predict_fn
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_s = max_wait_us / 1e6
        self.max_queue_rows = int(max_queue_rows
                                  if max_queue_rows is not None
                                  else 8 * max_batch_rows)
        self.min_bucket = int(min_bucket)
        self.metrics = metrics or ServingMetrics()
        self.model = model
        self._cond = threading.Condition()
        self._queue: List[_Pending] = []
        self._queued_rows = 0
        self._closed = False
        self._worker = threading.Thread(target=self._loop,
                                        name=f"batcher[{model}]",
                                        daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------
    def submit(self, X, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the batched prediction for ``X`` is ready.

        Raises :class:`Overloaded` (without enqueueing) when admission
        control rejects, ``TimeoutError`` past ``timeout``, or whatever
        the model raised for this batch.
        """
        res, _tag = self.submit_tagged(X, timeout=timeout)
        return res

    def submit_tagged(self, X, timeout: Optional[float] = None
                      ) -> Tuple[np.ndarray, object]:
        """`submit`, also returning the batch's model tag (version)."""
        p = self._enqueue(X)
        if not p.done.wait(timeout):
            # unregister the abandoned promise: if it is still queued,
            # remove it (its rows must stop counting against admission
            # control); if a worker already took the batch, mark it so
            # _run_batch won't fill a slot nobody reads
            with self._cond:
                p.abandoned = True
                if p in self._queue:
                    self._queue.remove(p)
                    self._queued_rows -= len(p.X)
            raise TimeoutError("prediction did not complete in time")
        if p.error is not None:
            raise p.error
        return p.result, p.tag

    def submit_async(self, X, callback: Callable) -> None:
        """Enqueue ``X`` and return immediately; ``callback(result,
        error, tag)`` fires exactly once, on the batcher worker thread,
        when the batch lands. The async front-end's entry point: no
        thread parks per request. Admission failures (:class:
        `Overloaded`, closed, bad shape) still raise synchronously —
        the caller holds the connection and maps them itself.
        """
        self._enqueue(X, callback)

    def _enqueue(self, X, callback: Optional[Callable] = None
                 ) -> _Pending:
        X = np.ascontiguousarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError("submit expects a nonempty 1-D row or "
                             "2-D [rows, features] matrix")
        p = _Pending(X)
        p.callback = callback   # attach BEFORE the worker can see it
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._queued_rows + len(X) > self.max_queue_rows:
                self.metrics.on_overload()
                raise Overloaded(self._queued_rows, self.max_queue_rows)
            self._queue.append(p)
            self._queued_rows += len(X)
            self._cond.notify_all()
        self.metrics.on_request(self.model, len(X))
        return p

    def load(self) -> int:
        """Rows queued right now — the replica router's depth signal."""
        with self._cond:
            return self._queued_rows

    def close(self, drain: bool = True):
        """Stop the worker; ``drain`` runs queued requests first, else
        they fail with a closed error."""
        with self._cond:
            self._closed = True
            if not drain:
                for p in self._queue:
                    p.error = RuntimeError("batcher closed")
                    p.fire()
                self._queue.clear()
                self._queued_rows = 0
            self._cond.notify_all()
        self._worker.join(timeout=30)

    # -- worker side ---------------------------------------------------
    def _take_batch(self) -> List[_Pending]:
        """Pop whole requests up to ``max_batch_rows`` (at least one)."""
        batch: List[_Pending] = []
        rows = 0
        while self._queue:
            nxt = self._queue[0]
            if batch and rows + len(nxt.X) > self.max_batch_rows:
                break
            batch.append(self._queue.pop(0))
            rows += len(nxt.X)
        self._queued_rows -= rows
        return batch

    def _loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                # deadline anchored at the OLDEST pending request
                deadline = self._queue[0].t_enqueue + self.max_wait_s
                while (self._queued_rows < self.max_batch_rows
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    if not self._queue:   # drained by close(drain=False)
                        break
                if not self._queue:
                    continue
                batch = self._take_batch()
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Pending]):
        t0 = time.monotonic()
        rows = sum(len(p.X) for p in batch)
        X = batch[0].X if len(batch) == 1 else np.concatenate(
            [p.X for p in batch])
        target = bucket_rows(rows, self.min_bucket, self.max_batch_rows)
        if target > rows:
            X = np.concatenate(
                [X, np.zeros((target - rows, X.shape[1]), X.dtype)])
        try:
            out = self._predict(X)
            tag = None
            if isinstance(out, tuple):
                out, tag = out
            out = np.asarray(out)
            if out.shape[0] != len(X):
                raise RuntimeError(
                    f"predict_fn returned {out.shape[0]} rows for a "
                    f"{len(X)}-row batch")
        except BaseException as e:  # noqa: BLE001 — forwarded per request
            for p in batch:
                self.metrics.on_error(self.model)
                p.error = e
                p.fire()
            return
        compute_s = time.monotonic() - t0
        self.metrics.on_batch(rows, t0 - batch[0].t_enqueue, compute_s)
        for p in batch:
            # each request's own wait, row-weighted — the per-batch
            # observation above only sees the oldest request, which
            # under-weights coalesced bursts
            self.metrics.on_request_wait(t0 - p.t_enqueue, len(p.X))
        off = 0
        for p in batch:
            if not p.abandoned:   # timed-out caller left; don't fill
                p.result = out[off:off + len(p.X)]
                p.tag = tag
            off += len(p.X)
            p.fire()
