"""Device-side accounting with zero device readbacks (a port of
``lightgbm_tpu/telemetry/device.py``).

Three gauge groups, all host-side:

- **Device memory watermarks** — ``torch.cuda.memory_stats(i)``
  (``allocated_bytes.all.current`` / ``.peak``, the caching
  allocator's own bookkeeping) for each CUDA device, labelled
  ``cuda:<i>``, once CUDA is initialised in the process. Reading the
  allocator's counters touches no device queue, so sampling at sync
  points or scrape time never syncs. The CPU has no allocator
  statistics and gives no sample: a CPU run's families carry no
  series.
- **Graph captures** — the families keep the JAX package's names,
  ``xla_compiles_total`` and ``xla_compile_seconds_total``, so one
  dashboard reads both packages; in the port they count the captured
  step's CUDA-graph captures (``GBDT._capture``) and their seconds.
  Steady-state training holds them flat: one capture a GOSS phase.
- **Collective traffic** — ``train_collective_hist_bytes_per_tree`` and
  ``_total``. The port trains ``tree_learner=serial`` only (its
  ``parallel/`` is not ported), so both read 0.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict

from .core import MetricsRegistry

__all__ = ["DeviceWatch", "CollectiveWatch", "device_memory_bytes"]


def device_memory_bytes() -> Dict[str, Dict[str, int]]:
    """{"cuda:<i>": {"bytes_in_use": n, "peak_bytes_in_use": n}} from
    the caching allocator of every CUDA device, or {} when CUDA is not
    initialised (a CPU run; this never initialises CUDA)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0))}
    return out


class DeviceWatch:
    """Device-memory gauges + graph-capture counters on a registry.

    ``sample()`` refreshes the in-use numbers and accumulates the peak
    watermark; it runs at engine sync points, never on the dispatch
    path. ``attach(gbdt)`` binds the booster whose
    captures the counters read, from its count at attach time; weakly,
    so that the counters read 0 once that booster is gone."""

    def __init__(self, registry: MetricsRegistry):
        self._lock = threading.Lock()
        self._peaks: Dict[str, int] = {}
        self._gb = None
        self._base = (0, 0.0)
        self._in_use = registry.gauge(
            "device_hbm_bytes_in_use",
            "Per-device bytes allocated (torch.cuda.memory_stats)",
            labels=("device",))
        self._peak = registry.gauge(
            "device_hbm_bytes_peak",
            "Per-device peak bytes allocated (allocator watermark, or "
            "max over samples)", labels=("device",))
        registry.gauge("xla_compiles_total",
                       "CUDA-graph captures of the training step since "
                       "telemetry start (steady state must hold this "
                       "flat)",
                       fn=lambda: self._captures()[0])
        registry.gauge("xla_compile_seconds_total",
                       "Seconds spent in CUDA-graph captures",
                       fn=lambda: self._captures()[1])

    def _raw(self):
        gb = self._gb() if self._gb is not None else None
        if gb is None:
            # never bound, or the booster is gone: no captures to count
            return self._base
        return (int(getattr(gb, "capture_count", 0)),
                float(getattr(gb, "capture_seconds", None) or 0.0))

    def _captures(self):
        n, s = self._raw()
        return n - self._base[0], s - self._base[1]

    def attach(self, gbdt) -> None:
        with self._lock:
            # weak, as the session holds its booster
            self._gb = weakref.ref(gbdt)
            self._base = self._raw()

    def sample(self) -> Dict[str, Dict[str, int]]:
        mem = device_memory_bytes()
        with self._lock:
            for label, stats in mem.items():
                peak = max(self._peaks.get(label, 0),
                           stats["peak_bytes_in_use"],
                           stats["bytes_in_use"])
                self._peaks[label] = peak
                self._in_use.labels(label).set(stats["bytes_in_use"])
                self._peak.labels(label).set(peak)
        return mem


class CollectiveWatch:
    """Collective-traffic gauges: per-tree histogram-merge bytes x trees
    built. Every run of the port is serial (no cross-device merge), so
    the per-tree bytes are 0; the families exist so a dashboard built
    for the JAX package finds them."""

    def __init__(self, registry: MetricsRegistry,
                 trees_fn: Callable[[], int]):
        self._trees_fn = trees_fn
        registry.gauge(
            "train_collective_hist_bytes_per_tree",
            "Per-device histogram-merge bytes for one tree (0: serial)",
            fn=self._bytes_per_tree)
        registry.gauge(
            "train_collective_hist_bytes_total",
            "Per-device histogram-merge bytes so far (per-tree bytes x "
            "trees built)",
            fn=lambda: self._bytes_per_tree() * self._trees_fn())

    def _bytes_per_tree(self) -> int:
        return 0
