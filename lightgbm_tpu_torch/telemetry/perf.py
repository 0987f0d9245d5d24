"""Perf-regression gate: tolerance-band comparison against a committed
baseline (a copy of ``lightgbm_tpu/telemetry/perf.py``; the pure gate
library, with a host signature that names torch, CUDA and the device).

This module is the pure comparison layer, so the tolerance semantics
are unit-testable without training anything:

- ``time`` metrics (ms/tree): only growth is a regression — a faster
  run than baseline passes and is the cue to re-bless.
- ``throughput`` metrics (rows/s, TFLOP/s): only shrinkage regresses.
- ``static`` metrics (a captured program's launch count, bytes): drift
  in EITHER direction fails — these numbers are deterministic for a
  fixed config, so any change means the program changed and must be
  blessed deliberately.

A metric present in the baseline but missing from the current run
fails (a silently vanished metric is a hole in the gate, not a pass);
metrics the runner deliberately skipped (timing on a loaded host) are
reported as ``skip`` without failing; metrics new in the current run
warn until the baseline adds them.

Timing comparisons are only meaningful on an otherwise-idle machine:
:func:`host_quiet` (1-minute loadavg vs core count) is how a collector
decides, and the baseline records its host signature so a baseline
from a different machine degrades timing failures to warnings instead
of gating on apples-vs-oranges.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Tolerance", "Check", "GateResult", "compare", "host_quiet",
           "host_signature", "load_baseline", "save_baseline",
           "DEFAULT_TOLERANCES", "BASELINE_NAME"]

BASELINE_NAME = "PERF_BASELINE.json"


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """One metric's allowed band relative to baseline ``b``:

    - ``time``:       pass while ``cur <= b * ratio``
    - ``throughput``: pass while ``cur >= b / ratio``
    - ``static``:     pass while ``b / ratio <= cur <= b * ratio``
    """
    kind: str           # "time" | "throughput" | "static"
    ratio: float        # >= 1; 1.25 == 25% band

    def __post_init__(self):
        if self.kind not in ("time", "throughput", "static"):
            raise ValueError(f"unknown tolerance kind {self.kind!r}")
        if not self.ratio >= 1.0:
            raise ValueError(f"tolerance ratio must be >= 1, "
                             f"got {self.ratio}")

    def check(self, current: float, baseline: float
              ) -> Tuple[bool, str]:
        """(ok, detail) for one comparison."""
        if baseline == 0:
            ok = current == 0 if self.kind == "static" else True
            return ok, f"baseline 0, current {current:g}"
        rel = current / baseline
        band = (f"{rel:.3f}x baseline "
                f"(band {1 / self.ratio:.3f}..{self.ratio:.3f})")
        if self.kind == "time":
            return rel <= self.ratio, band
        if self.kind == "throughput":
            return rel >= 1.0 / self.ratio, band
        return 1.0 / self.ratio <= rel <= self.ratio, band


# Metric-name tolerance table of the JAX package's gate, kept
# name-for-name so one baseline format serves both packages. Static
# cost-model numbers get tight bands (they only move when the program
# moves); wall-clock gets a wide one (CI hosts are noisy).
DEFAULT_TOLERANCES: Dict[str, Tolerance] = {
    "ms_per_tree": Tolerance("time", 1.6),
    "predict_ms": Tolerance("time", 1.6),
    "hist_flops_xla": Tolerance("static", 1.25),
    "hist_bytes_xla": Tolerance("static", 1.25),
    # the analytical cross-check: the priced flops over the
    # hand-derived count must stay within 2x in BOTH directions, else
    # one of the two models is wrong
    "hist_flops_xla_ratio": Tolerance("static", 2.0),
    "cost_fused_step_flops": Tolerance("static", 1.25),
    "cost_fused_step_bytes": Tolerance("static", 1.25),
    "cost_fused_step_peak_bytes": Tolerance("static", 1.5),
    "cost_fused_step_n_ops": Tolerance("static", 1.25),
    "cost_predict_flops": Tolerance("static", 1.25),
    "cost_predict_bytes": Tolerance("static", 1.25),
    # out-of-core probe: wall-clock/throughput on shared CI
    # hosts, so the bands are wide; overlap_fraction is host-scheduling
    # dependent and only gates a total collapse
    "ingest_rows_per_s": Tolerance("throughput", 2.5),
    "ingest_chunked_ms_per_tree": Tolerance("time", 2.5),
    "ingest_resident_ms_per_tree": Tolerance("time", 2.5),
    "ingest_prefetch_overlap": Tolerance("throughput", 10.0),
    # fused build+split pass: the byte counts are pure functions of
    # the probe lattice — any drift means the cost model changed; the
    # scan wall-clock gets the usual noisy-CI band
    "hist_bytes_twopass": Tolerance("static", 1.1),
    "hist_bytes_fused": Tolerance("static", 1.1),
    "hist_fused_bytes_reduction": Tolerance("static", 1.1),
    "split_scan_ms": Tolerance("time", 2.5),
    # serving fleet: rows/s + tail latency through the async
    # front end on a loaded CI host — wide bands; the tensorized
    # program's price is static like every other compiled program
    "serve_rows_per_s": Tolerance("throughput", 2.5),
    "serve_p99_ms": Tolerance("time", 2.5),
    "compiled_predict_speedup": Tolerance("throughput", 2.5),
    "cost_compiled_predict_flops": Tolerance("static", 1.25),
    "cost_compiled_predict_bytes": Tolerance("static", 1.25),
}
_DEFAULT = Tolerance("static", 1.5)


@dataclasses.dataclass
class Check:
    metric: str
    status: str                 # pass | fail | missing | skip | new
    current: Optional[float]
    baseline: Optional[float]
    detail: str = ""

    @property
    def failed(self) -> bool:
        return self.status in ("fail", "missing")


@dataclasses.dataclass
class GateResult:
    checks: List[Check]

    @property
    def ok(self) -> bool:
        return not any(c.failed for c in self.checks)

    @property
    def failed(self) -> List[str]:
        return [c.metric for c in self.checks if c.failed]

    def render(self) -> str:
        rows = []
        for c in sorted(self.checks, key=lambda c: c.metric):
            cur = "-" if c.current is None else f"{c.current:g}"
            base = "-" if c.baseline is None else f"{c.baseline:g}"
            rows.append(f"  {c.status.upper():<7} {c.metric:<28} "
                        f"cur={cur:<14} base={base:<14} {c.detail}")
        verdict = "PASS" if self.ok else \
            f"FAIL ({', '.join(self.failed)})"
        return "\n".join(rows + [f"perf gate: {verdict}"])


def compare(current: Dict[str, float], baseline: Dict[str, float],
            tolerances: Optional[Dict[str, Tolerance]] = None,
            skipped: Iterable[str] = ()) -> GateResult:
    """Compare a collected metric dict against the baseline's.

    ``skipped`` names metrics the collector deliberately did not
    measure this run (e.g. timing on a loaded host): those report
    ``skip`` instead of ``missing`` and never fail the gate.
    """
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(tolerances or {})
    skipped = set(skipped)
    checks: List[Check] = []
    for name, base in sorted(baseline.items()):
        if name in skipped:
            checks.append(Check(name, "skip", None, base,
                                "not measured this run"))
            continue
        if name not in current:
            checks.append(Check(name, "missing", None, base,
                                "metric vanished from the run"))
            continue
        cur = float(current[name])
        t = tol.get(name, _DEFAULT)
        ok, detail = t.check(cur, float(base))
        checks.append(Check(name, "pass" if ok else "fail",
                            cur, float(base), f"[{t.kind}] {detail}"))
    for name in sorted(set(current) - set(baseline)):
        checks.append(Check(name, "new", float(current[name]), None,
                            "not in baseline (bless via --update)"))
    return GateResult(checks)


def host_quiet(max_load_frac: float = 0.75) -> bool:
    """True when the 1-minute loadavg leaves headroom for a timing
    measurement (below ``max_load_frac`` of the core count). Platforms
    without getloadavg report quiet — better a noisy measurement than
    a permanently skipped gate."""
    try:
        load1 = os.getloadavg()[0]
    except (AttributeError, OSError):
        return True
    cores = os.cpu_count() or 1
    return load1 < cores * max_load_frac


def host_signature() -> Dict[str, Any]:
    """What timing numbers are comparable across: machine + core count
    + python/torch surface + the device. Stored in the baseline; a
    mismatch degrades timing failures to warnings."""
    import torch
    device = (torch.cuda.get_device_name(0)
              if torch.cuda.is_available() else "cpu")
    return {
        "machine": platform.machine(),
        "cpu_count": os.cpu_count() or 1,
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "device": device,
    }


def load_baseline(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        obj = json.load(f)
    if not isinstance(obj, dict) or "metrics" not in obj:
        raise ValueError(f"{path}: not a perf baseline "
                         "(want {'metrics': {...}, ...})")
    return obj


def save_baseline(path: str, metrics: Dict[str, float],
                  meta: Optional[Dict[str, Any]] = None) -> None:
    obj = {
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "host": host_signature(),
        "meta": meta or {},
        "metrics": {k: metrics[k] for k in sorted(metrics)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")
