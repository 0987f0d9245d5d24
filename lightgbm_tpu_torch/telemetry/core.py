"""Generic metric primitives + registry, copied from
``lightgbm_tpu/telemetry/core.py`` (it imports numpy only).

No reference analog — LightGBM's operational visibility stops at the
logger and the TIMETAG timers (common.h:973,1037). The primitives the
serving layer needs, rendered in one registry:

- :class:`Counter` — monotonic, one uncontended ``threading.Lock`` per
  increment (~100 ns): CPython attribute ``+=`` is NOT atomic
  (LOAD/ADD/STORE can interleave at the bytecode boundary), so the lock
  is the cheapest *correct* primitive; reads are single attribute loads
  and need none.
- :class:`Gauge` — last-write-wins value, or a zero-storage callback
  gauge (``Gauge(fn=...)``) evaluated only at scrape time.
- :class:`RingHistogram` — fixed-size ring of observations; percentiles
  are computed only at scrape time over the last ``size`` observations,
  so the hot path never sorts and memory never grows with traffic.
- :class:`MetricsRegistry` — named families (optionally labelled),
  rendered in the Prometheus text exposition format
  (text/plain; version=0.0.4). External metric sets that keep their own
  storage (ServingMetrics) mount via :meth:`~MetricsRegistry.
  register_collector`, which appends their rendered text verbatim — the
  serving families' bytes are pinned by tests and must not be
  re-rendered through a second formatter.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "RingHistogram", "MetricsRegistry",
           "render_counter", "render_summary"]


class Counter:
    """Monotonic counter with optional labelled children."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value  # single attribute load: atomic under the GIL


class Gauge:
    """Last-write-wins value, or a callback evaluated at scrape time.

    Callback gauges (``Gauge(fn=...)``) store nothing and cost nothing
    until a scrape asks; a callback that raises reads as 0.0 rather
    than failing the whole ``/metrics`` render mid-run.
    """

    __slots__ = ("_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._value = 0.0
        self._fn = fn

    def set(self, value: float):
        self._value = float(value)  # single store: atomic under the GIL

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return 0.0
        return self._value


class RingHistogram:
    """Fixed-size ring of float observations (latencies, batch sizes).

    ``observe`` is O(1); quantiles/mean are computed at scrape time over
    the retained window (the last ``size`` observations), which is the
    operationally useful view — a dashboard wants *recent* p99, not the
    all-time one that a cumulative histogram would smear.
    """

    __slots__ = ("_lock", "_buf", "_n")

    def __init__(self, size: int = 4096):
        self._lock = threading.Lock()
        self._buf = np.zeros(int(size), np.float64)
        self._n = 0

    def observe(self, value: float):
        with self._lock:
            self._buf[self._n % len(self._buf)] = value
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def window(self) -> np.ndarray:
        """Copy of the retained observations (unordered)."""
        with self._lock:
            return self._buf[: min(self._n, len(self._buf))].copy()

    def summary(self, qs: Iterable[float] = (0.5, 0.95, 0.99)
                ) -> Tuple[Dict[float, float], int, float]:
        """({quantile: value}, total_count, window_mean)."""
        w = self.window()
        if w.size == 0:
            return {q: 0.0 for q in qs}, self._n, 0.0
        return ({q: float(np.percentile(w, 100.0 * q)) for q in qs},
                self._n, float(w.mean()))


# ----------------------------------------------------------------------
# Prometheus text rendering — the exact byte format the serving layer
# has always emitted (tests pin it); both render paths share these.

def render_counter(out: List[str], name: str, help_: str,
                   pairs: Iterable[Tuple[str, int]]) -> None:
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} counter")
    for labels, v in pairs:
        out.append(f"{name}{labels} {v}")


def render_summary(out: List[str], name: str, help_: str,
                   hist: RingHistogram, scale: float = 1.0) -> None:
    qs, cnt, mean = hist.summary()
    out.append(f"# HELP {name} {help_}")
    out.append(f"# TYPE {name} summary")
    for q, v in qs.items():
        out.append(f'{name}{{quantile="{q:g}"}} {v * scale:.9g}')
    out.append(f"{name}_count {cnt}")
    out.append(f"{name}_mean {mean * scale:.9g}")


def _label_str(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in zip(names, values))
    return "{" + inner + "}"


class _Family:
    """One named metric family: unlabelled (a single child under the
    empty label set) or labelled (children created on first use, like
    ServingMetrics' per-model counter maps)."""

    __slots__ = ("kind", "name", "help", "label_names", "_children",
                 "_lock", "_make", "_scale")

    def __init__(self, kind: str, name: str, help_: str,
                 label_names: Tuple[str, ...], make):
        self.kind = kind
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        self._make = make
        self._scale = 1.0

    def labels(self, *values: str):
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make())
        return child

    def child_items(self) -> List[Tuple[str, object]]:
        with self._lock:
            items = sorted(self._children.items())
        return [(_label_str(self.label_names, k), c) for k, c in items]


class MetricsRegistry:
    """Named metric families + external collectors, one Prometheus
    render. Training creates one per run (telemetry session); serving
    creates one per server and mounts its ServingMetrics as a
    collector, so ``/metrics`` on either side is a single
    ``registry.render()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: List[_Family] = []
        self._by_name: Dict[str, _Family] = {}
        self._collectors: List[Tuple[str, Callable[[], str]]] = []

    # -- family constructors (idempotent by name) ----------------------
    def _family(self, kind: str, name: str, help_: str,
                labels: Tuple[str, ...], make) -> _Family:
        with self._lock:
            fam = self._by_name.get(name)
            if fam is None:
                fam = _Family(kind, name, help_, labels, make)
                self._families.append(fam)
                self._by_name[name] = fam
            elif fam.kind != kind or fam.label_names != labels:
                raise ValueError(f"metric {name!r} re-registered with a "
                                 f"different kind or label set")
        return fam

    def counter(self, name: str, help_: str,
                labels: Tuple[str, ...] = ()) -> object:
        fam = self._family("counter", name, help_, tuple(labels), Counter)
        return fam if labels else fam.labels()

    def gauge(self, name: str, help_: str, labels: Tuple[str, ...] = (),
              fn: Optional[Callable[[], float]] = None) -> object:
        make = (lambda: Gauge(fn)) if fn is not None else Gauge
        fam = self._family("gauge", name, help_, tuple(labels), make)
        return fam if labels else fam.labels()

    def summary(self, name: str, help_: str, size: int = 4096,
                scale: float = 1.0) -> RingHistogram:
        make = lambda: RingHistogram(size)  # noqa: E731
        fam = self._family("summary", name, help_, (), make)
        fam._scale = scale  # type: ignore[attr-defined]
        return fam.labels()

    # -- external metric sets (serving) --------------------------------
    def register_collector(self, name: str,
                           fn: Callable[[], str]) -> None:
        """Mount an external render (replaces an existing collector of
        the same name — server restarts re-register, never stack)."""
        with self._lock:
            self._collectors = [(n, f) for n, f in self._collectors
                                if n != name]
            self._collectors.append((name, fn))

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors = [(n, f) for n, f in self._collectors
                                if n != name]

    # -- export --------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition (text/plain; version=0.0.4)."""
        out: List[str] = []
        with self._lock:
            families = list(self._families)
            collectors = list(self._collectors)
        for fam in families:
            children = fam.child_items()
            if fam.kind == "counter":
                render_counter(out, fam.name, fam.help,
                               [(ls, c.value) for ls, c in children]
                               or [("", 0)])
            elif fam.kind == "gauge":
                out.append(f"# HELP {fam.name} {fam.help}")
                out.append(f"# TYPE {fam.name} gauge")
                for ls, c in (children or [("", Gauge())]):
                    out.append(f"{fam.name}{ls} {c.value:.9g}")
            else:  # summary
                scale = getattr(fam, "_scale", 1.0)
                for ls, hist in children:
                    render_summary(out, fam.name, fam.help, hist, scale)
        text = "\n".join(out) + "\n" if out else ""
        for _, fn in collectors:
            try:
                text += fn()
            except Exception:
                pass  # a dead collector must not fail the scrape
        return text

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict view of every family (SIGUSR1 dump, /healthz)."""
        snap: Dict[str, object] = {}
        with self._lock:
            families = list(self._families)
        for fam in families:
            if fam.kind == "summary":
                for _, hist in fam.child_items():
                    qs, cnt, mean = hist.summary()
                    snap[fam.name] = {"count": cnt, "mean": mean,
                                      "quantiles": {f"{q:g}": v
                                                    for q, v in qs.items()}}
            else:
                vals = {ls or "": c.value for ls, c in fam.child_items()}
                snap[fam.name] = (vals.get("", 0) if list(vals) == [""]
                                  else vals)
        return snap

