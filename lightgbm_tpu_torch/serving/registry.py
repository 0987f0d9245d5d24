"""Named + versioned model registry with atomic hot-swap and one-step
rollback (port of ``lightgbm_tpu/serving/registry.py``).

Deploy contract (the reason this exists — LightGBM's C API loads a
model once per handle and has no swap story):

1. ``swap()`` loads the incoming model on the registry's device and
   ``warmup()``s its :class:`~lightgbm_tpu_torch.engine.PredictSession`
   entirely OFF the serving path — device ensemble packed, every ladder
   rung run once — while live traffic keeps reading the old version
   untouched.
2. Only then is the active slot CAS'd: publishing is a single
   reference assignment (atomic under the GIL), so a reader holding
   yesterday's reference finishes on yesterday's model and the next
   ``resolve()`` sees the new one. No request ever observes a cold or
   half-loaded model.
3. The replaced version stays in the history ring; ``rollback()``
   republishes it with the same single-assignment CAS (its session
   caches are still warm, so rollback is instant).

Whole-model guarantee: ``predict()`` resolves the active
:class:`ModelVersion` exactly once and serves the entire call from that
snapshot's session — combined with the ``PredictSession`` snapshot
contract (engine.py) a result can never mix trees of two versions. The
micro-batcher calls ``predict()`` once per coalesced batch, extending
the guarantee to every request in the batch.

Registered models are SERVING-ONLY: training, ``rollback_one_iter`` or
leaf surgery on a registered Booster is outside the contract (swap in a
new version instead — that is the point of the registry).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import resolve_device
from .metrics import ServingMetrics

__all__ = ["ModelRegistry", "ModelVersion"]


class ModelVersion:
    """One immutable (booster, warmed session[, compiled, replicas])
    snapshot. The registry hands these out by reference; holders may
    predict on them at any time, even after the version was
    superseded. ``compiled`` / ``replicas`` are populated off-path by
    ``_load`` when serving is configured — publishing the version
    publishes all three in the same single reference store."""

    __slots__ = ("name", "version", "source", "booster", "session",
                 "loaded_at", "num_features", "compiled", "replicas",
                 "compiled_fallback")

    def __init__(self, name: str, version: int, source: str,
                 booster, session):
        self.name = name
        self.version = version
        self.source = source
        self.booster = booster
        self.session = session
        self.loaded_at = time.time()
        self.num_features = booster.num_feature()
        self.compiled = None          # codegen.CompiledEnsemble | None
        self.replicas = None          # replica.ReplicaSet | None
        self.compiled_fallback = None  # why compiled is None (str)

    def close_replicas(self, drain: bool = True):
        """Retire this version's replica fleet (history eviction /
        unregister); the session path stays usable."""
        rs, self.replicas = self.replicas, None
        if rs is not None:
            rs.close(drain=drain)

    def describe(self) -> dict:
        d = {"name": self.name, "version": self.version,
             "source": self.source, "loaded_at": self.loaded_at,
             "num_features": self.num_features,
             "num_trees": self.booster.num_trees()}
        if self.compiled is not None:
            d["compiled"] = self.compiled.describe()
        elif self.compiled_fallback is not None:
            d["compiled_fallback"] = self.compiled_fallback
        if self.replicas is not None:
            d["replicas"] = self.replicas.describe()
        return d


class ModelRegistry:
    """Thread-safe model store: writers serialize on a lock, readers
    are lock-free (one attribute load resolves the active version).

    Model files load onto ``device_type`` (default ``"cuda"``, which
    raises without a GPU; ``"cpu"`` serves on the host)."""

    def __init__(self, *, warmup_rows: int = 256, history: int = 4,
                 metrics: Optional[ServingMetrics] = None,
                 compiled_predict: bool = False, replicas: int = 0,
                 device_type: str = "cuda"):
        self.device_type = device_type
        self.warmup_rows = int(warmup_rows)
        self.history = int(history)
        self.metrics = metrics or ServingMetrics()
        self.compiled_predict = bool(compiled_predict)
        self.replicas = int(replicas)
        self.warm_ladder: Optional[List[int]] = None
        self.replica_devices = None
        self.replica_batcher_opts: Dict[str, object] = {}
        self._lock = threading.Lock()          # writers only
        self._active: Dict[str, ModelVersion] = {}
        self._history: Dict[str, List[ModelVersion]] = {}
        self._next_version: Dict[str, int] = {}
        self._default: Optional[str] = None

    def configure_serving(self, *, compiled_predict: Optional[bool] = None,
                          replicas: Optional[int] = None,
                          warm_ladder: Optional[List[int]] = None,
                          devices=None,
                          batcher_opts: Optional[Dict] = None):
        """Set the serving shape applied to every subsequent ``_load``
        (already-published versions are not rebuilt — swap to apply).

        ``warm_ladder`` is the full batch-bucket ladder; every rung is
        run once per replica OFF the serving path, so no live request
        is the first at its shape on its device."""
        if compiled_predict is not None:
            self.compiled_predict = bool(compiled_predict)
        if replicas is not None:
            self.replicas = int(replicas)
        if warm_ladder is not None:
            self.warm_ladder = [int(r) for r in warm_ladder]
        if devices is not None:
            self.replica_devices = list(devices)
        if batcher_opts is not None:
            self.replica_batcher_opts = dict(batcher_opts)

    # -- loading / swapping -------------------------------------------
    def _load(self, name: str, source, **session_kwargs) -> ModelVersion:
        """Build + warm a ModelVersion OFF the serving path."""
        from ..engine import Booster
        if isinstance(source, Booster):
            booster, src = source, "<booster>"
        elif isinstance(source, (str, os.PathLike)):
            resolve_device(self.device_type)   # raises without a GPU
            booster = Booster(model_file=str(source),
                              params={"device_type": self.device_type})
            src = str(source)
        else:
            raise TypeError("model source must be a Booster or a model "
                            f"file path, got {type(source).__name__}")
        session = booster.predict_session(**session_kwargs)
        # warm the WHOLE batch ladder, not just one rung
        ladder = self.warm_ladder or [self.warmup_rows]
        if self.warmup_rows > 0:
            for rows in sorted(set(ladder)):
                session.warmup(rows)
        with self._lock:
            v = self._next_version.get(name, 0) + 1
            self._next_version[name] = v
        mv = ModelVersion(name, v, src, booster, session)
        if self.compiled_predict or self.replicas > 0:
            from ..codegen import CompiledEnsemble
            try:
                mv.compiled = CompiledEnsemble(booster,
                                               **session_kwargs)
            except (ValueError, TypeError) as e:
                # named fallback, same discipline as fused_split=auto:
                # the session path serves, /models says why
                mv.compiled_fallback = str(e)
        if mv.compiled is not None:
            if self.replicas > 0:
                from .replica import ReplicaSet, default_devices
                mv.replicas = ReplicaSet(
                    mv.compiled, mv, replicas=self.replicas,
                    devices=(self.replica_devices
                             or default_devices(self.device_type)),
                    metrics=self.metrics, model=name,
                    **self.replica_batcher_opts)
                if self.warmup_rows > 0:
                    mv.replicas.warm(ladder)
            elif self.warmup_rows > 0:
                mv.compiled.warm(sorted(set(ladder)))
        return mv

    def register(self, name: str, source,
                 **session_kwargs) -> ModelVersion:
        """Load, warm, then atomically publish ``source`` as the active
        version of ``name``. The first registered name becomes the
        default model."""
        mv = self._load(name, source, **session_kwargs)
        evicted: List[ModelVersion] = []
        with self._lock:
            old = self._active.get(name)
            if old is not None:
                hist = self._history.setdefault(name, [])
                hist.append(old)
                evicted = hist[:-self.history]
                del hist[:-self.history]
                self.metrics.swaps_total.inc()
                from ..telemetry.events import record_serving
                record_serving("swap", name, mv.version)
            # the publish: one reference store, atomic under the GIL —
            # in-flight readers keep `old`, new resolves see `mv`.
            # `mv` already carries its compiled program and warmed
            # replica fleet, so (version, compiled, replicas) is ONE
            # atomic snapshot
            self._active[name] = mv
            if self._default is None:
                self._default = name
        for ev in evicted:
            # aged past the rollback ring: its replica batchers are
            # unreachable — retire them (outside the lock; drain)
            ev.close_replicas()
        return mv

    # a swap IS a register on an existing name; the alias keeps the
    # deploy runbook's vocabulary honest
    swap = register

    def rollback(self, name: Optional[str] = None) -> ModelVersion:
        """One-step rollback: republish the previous version of
        ``name`` (still warm — its session caches survived the swap)."""
        name = name or self._default
        with self._lock:
            hist = self._history.get(name or "")
            if not hist:
                raise LookupError(f"no previous version of {name!r} "
                                  "to roll back to")
            mv = hist.pop()
            self._active[name] = mv
            self.metrics.rollbacks_total.inc()
            from ..telemetry.events import record_serving
            record_serving("rollback", name, mv.version)
        return mv

    def unregister(self, name: str):
        with self._lock:
            dropped = [self._active.pop(name, None)]
            dropped += self._history.pop(name, [])
            if self._default == name:
                self._default = next(iter(self._active), None)
        for mv in dropped:
            if mv is not None:
                mv.close_replicas()

    def close(self):
        """Retire every version's replica fleet (server shutdown)."""
        with self._lock:
            all_mv = list(self._active.values())
            for hist in self._history.values():
                all_mv += hist
        for mv in all_mv:
            mv.close_replicas()

    # -- serving side (lock-free) -------------------------------------
    def resolve(self, name: Optional[str] = None) -> ModelVersion:
        """Active version snapshot — ONE dict read, no lock. Everything
        reachable from the returned object is immutable."""
        mv = self._active.get(name or self._default or "")
        if mv is None:
            raise LookupError(f"no model registered as "
                              f"{name or self._default!r}")
        return mv

    def predict(self, X, name: Optional[str] = None
                ) -> Tuple[np.ndarray, ModelVersion]:
        """Predict entirely on one resolved version; returns
        ``(result, version)`` so callers (the batcher) can tag results
        with the model that produced them. Prefers the tensorized
        program when the version carries one (bit-identical by the
        CompiledEnsemble contract; replicated routing lives in the
        server, which talks to ``mv.replicas`` directly)."""
        mv = self.resolve(name)
        if mv.compiled is not None:
            return mv.compiled.predict(X), mv
        return mv.session.predict(X), mv

    # -- introspection -------------------------------------------------
    def models(self) -> List[dict]:
        with self._lock:
            out = []
            for name, mv in sorted(self._active.items()):
                d = mv.describe()
                d["default"] = name == self._default
                hist = self._history.get(name)
                d["rollback_to"] = hist[-1].version if hist else None
                out.append(d)
            return out

    @property
    def default_name(self) -> Optional[str]:
        return self._default
