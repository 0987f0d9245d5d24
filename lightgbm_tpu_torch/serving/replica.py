"""Sharded replica fleet: one tensorized ensemble, N device-resident
copies, least-queue-depth routing — plus per-model QPS budgets (port of
``lightgbm_tpu/serving/replica.py``).

The tensorized ensemble (``codegen.CompiledEnsemble``) makes a model's
serving state a handful of dense tensors, so replicating it across
devices is one copy per table, not a process per copy. Each replica owns its OWN :class:`~.batcher.MicroBatcher` (its
queue IS the device's queue — one in-flight kernel per device, no
cross-device convoy), and the router picks the replica with the fewest
queued rows at submit time. That is the power-of-one-choice degenerate
case of least-loaded routing: with a handful of replicas, scanning all
queue depths is cheaper than maintaining anything smarter.

Version affinity: a ``ReplicaSet`` is constructed FOR one
:class:`~.registry.ModelVersion` and every replica's ``predict_fn``
tags results with that version — a request routed anywhere in the set
can never observe a different version. Hot-swap publishes a whole new
set (built and warmed off-path by the registry) in the same atomic
snapshot as the version itself.

Admission has two independent gates:

- per-replica queue bounds (``Overloaded``, inherited from the
  batcher) — protects the DEVICE;
- per-model token-bucket QPS budgets (:class:`QpsBudget`,
  :class:`BudgetExceeded`) — protects the TENANT mix: one model's
  burst cannot starve the others' batcher capacity. The HTTP layer
  maps both to 429, distinguished by ``status``.

Runbook — draining one device's replica (e.g. before a host swap)::

    rs = registry.resolve("m").replicas
    rs.drain_replica(i)     # router skips it; queued work finishes
    ...maintenance...
    rs.restore_replica(i)   # fresh batcher, back in rotation
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..config import resolve_device
from .batcher import MicroBatcher, Overloaded
from .metrics import ServingMetrics

__all__ = ["ReplicaSet", "QpsBudget", "BudgetExceeded", "default_devices"]


def default_devices(device_type: str = "cuda") -> List[torch.device]:
    """Every visible GPU (raises without one), or ``[cpu]`` for
    ``device_type="cpu"``. Devices are named by index: the CUDA current
    device is thread-local, and replicas predict from batcher threads."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    resolve_device(device_type)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class BudgetExceeded(RuntimeError):
    """Per-model QPS budget exhausted; the request was NOT enqueued.

    Retriable by definition (nothing about the request was wrong) —
    the HTTP layer answers 429 + Retry-After with
    ``status="budget_exceeded"`` so clients can tell tenant throttling
    from queue overload.
    """

    retriable = True

    def __init__(self, model: str, qps: float):
        super().__init__(
            f"model {model!r} exceeded its {qps:g} req/s budget; "
            "retriable")
        self.model = model
        self.qps = qps


class QpsBudget:
    """Token bucket: ``qps`` tokens/s refill, ``burst`` capacity
    (default ``max(qps, 1)`` — a one-second burst). Thread-safe;
    ``try_admit`` never blocks."""

    def __init__(self, qps: float, burst: Optional[float] = None):
        if qps <= 0:
            raise ValueError("qps budget must be > 0")
        self.qps = float(qps)
        self.burst = float(burst) if burst is not None else max(
            self.qps, 1.0)
        self._tokens = self.burst
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def try_admit(self, tokens: float = 1.0) -> bool:
        now = time.monotonic()
        with self._lock:
            self._tokens = min(
                self.burst, self._tokens + (now - self._t_last) * self.qps)
            self._t_last = now
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True
            return False


class _Replica:
    __slots__ = ("index", "device", "batcher", "draining")

    def __init__(self, index: int, device, batcher: MicroBatcher):
        self.index = index
        self.device = device
        self.batcher = batcher
        self.draining = False


class ReplicaSet:
    """N device-resident copies of one compiled model version behind a
    least-queue-depth router.

    ``compiled`` is a :class:`~lightgbm_tpu_torch.codegen.
    CompiledEnsemble`; ``tag`` is handed back with every result (the
    registry passes the owning ``ModelVersion``). ``devices`` defaults
    to every visible GPU (:func:`default_devices`); with more replicas
    than devices they wrap round-robin, so ``replicas=2`` on one card
    runs two replicas on it.
    """

    def __init__(self, compiled, tag=None, *, replicas: int = 1,
                 devices: Optional[Sequence] = None,
                 metrics: Optional[ServingMetrics] = None,
                 model: str = "default", **batcher_opts):
        if replicas < 1:
            raise ValueError("a ReplicaSet needs >= 1 replicas")
        if devices is None:
            devices = default_devices()
        self.compiled = compiled
        self.tag = tag
        self.model = model
        self.metrics = metrics or ServingMetrics()
        self._batcher_opts = dict(batcher_opts)
        self._lock = threading.Lock()
        self._closed = False
        self.replicas: List[_Replica] = [
            self._spawn(i, devices[i % len(devices)])
            for i in range(int(replicas))]

    def _spawn(self, index: int, device) -> _Replica:
        def predict_fn(X, _d=device):
            return self.compiled.predict(X, device=_d), self.tag

        b = MicroBatcher(predict_fn, metrics=self.metrics,
                         model=self.model, **self._batcher_opts)
        return _Replica(index, device, b)

    # -- routing -------------------------------------------------------
    def pick(self) -> _Replica:
        """Replica with the fewest queued rows among those in
        rotation."""
        best = None
        best_load = None
        for r in self.replicas:
            if r.draining:
                continue
            load = r.batcher.load()
            if best is None or load < best_load:
                best, best_load = r, load
        if best is None:
            raise Overloaded(0, 0)   # every replica draining: retriable
        return best

    def submit(self, X, timeout: Optional[float] = None) -> np.ndarray:
        return self.pick().batcher.submit(X, timeout=timeout)

    def submit_tagged(self, X, timeout: Optional[float] = None
                      ) -> Tuple[np.ndarray, object]:
        return self.pick().batcher.submit_tagged(X, timeout=timeout)

    def submit_async(self, X, callback: Callable) -> None:
        self.pick().batcher.submit_async(X, callback)

    def loads(self) -> List[int]:
        return [r.batcher.load() for r in self.replicas]

    # -- lifecycle -----------------------------------------------------
    def warm(self, rungs: Sequence[int]) -> "ReplicaSet":
        """Run every ladder rung on every replica's device (tables are
        placed per device, so one replica's warmth does not transfer)."""
        for r in self.replicas:
            self.compiled.warm(rungs, device=r.device)
        return self

    def drain_replica(self, index: int):
        """Take one replica out of rotation and finish its queued work
        (the device-maintenance runbook step). Refuses to drain the
        last live replica — that is a model drain, not a device
        drain."""
        with self._lock:
            live = [r for r in self.replicas if not r.draining]
            r = self.replicas[index]
            if not r.draining and len(live) <= 1:
                raise RuntimeError(
                    "refusing to drain the last live replica; "
                    "swap or unregister the model instead")
            r.draining = True
        r.batcher.close(drain=True)

    def restore_replica(self, index: int):
        """Return a drained replica to rotation with a fresh batcher
        (its device tables are still resident — restore is instant)."""
        with self._lock:
            old = self.replicas[index]
            if not old.draining:
                return
            self.replicas[index] = self._spawn(old.index, old.device)

    def close(self, drain: bool = True):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            reps = list(self.replicas)
        for r in reps:
            if not r.draining:
                r.batcher.close(drain=drain)

    def describe(self) -> dict:
        return {"replicas": len(self.replicas),
                "devices": [str(r.device) for r in self.replicas],
                "draining": [r.index for r in self.replicas
                             if r.draining],
                "loads": self.loads()}
