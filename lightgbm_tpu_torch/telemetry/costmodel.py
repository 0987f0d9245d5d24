"""The captured step's cost report and the card's peaks (the parts of
``lightgbm_tpu/telemetry/costmodel.py`` that have a torch analog).

The JAX module prices XLA's compiled programs (``cost_analysis`` /
``memory_analysis``) and maps their instructions to phases. No compiler
prices a PyTorch step, so the port keeps:

- :func:`chip_peaks` — the card's dense bf16 tensor-core TFLOP/s and
  HBM GB/s from NVIDIA's data sheet, keyed by
  ``torch.cuda.get_device_name()``; the H100 SXM 80GB only, other cards
  (and the CPU) give None. No TPU figure is carried.
- the arithmetic helpers, unchanged: :func:`analytical_hist_counts`,
  :func:`analytical_build_split_counts`, :func:`roofline_utilization`,
  :func:`kernel_roofline_fields`;
- :class:`CostReport` of the captured step (:func:`step_cost_report`):
  ``n_ops`` is the hand-written kernels' launches recorded into the
  step's CUDA graph (``GBDT._graph_launches``), ``peak_bytes``
  ``torch.cuda.max_memory_allocated``, and ``flops`` and
  ``bytes_accessed`` 0. So the session's ``train_fused_*`` gauges read
  0 and ``train_achieved_tflops`` / ``train_mfu`` stay unset.

Not carried: ``hist_xla_cost``, ``fused_compiled``,
``instruction_phase_map``, ``booster_phase_maps`` and
``staged_cost_reports`` — they read XLA's compiled programs, which the
port has none of.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

__all__ = ["GPU_PEAKS", "HIST_CH", "CostReport", "chip_peaks",
           "analytical_hist_counts", "analytical_build_split_counts",
           "fused_candidate_bytes", "roofline_utilization",
           "kernel_roofline_fields", "step_cost_report"]

# dense bf16 tensor-core TFLOP/s and HBM GB/s by device name (NVIDIA's
# H100 data sheet, SXM part, without sparsity, at its 700 W limit); used
# only to put measured timings in context
GPU_PEAKS = {"NVIDIA H100 80GB HBM3": (989.0, 3350.0)}

# histogram channels: (grad, hess, count)
HIST_CH = 3
# the port's B2 writes one best-split record of this many f32 lanes a
# slot (ops/cuda_histogram.py _REC)
_REC_LANES = 16


def chip_peaks() -> Optional[Tuple[str, float, float]]:
    """(device name, peak TFLOP/s, peak HBM GB/s) of the current CUDA
    device when the table knows it; None elsewhere (other cards, the
    CPU, CUDA not initialised — this never initialises it)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    kind = torch.cuda.get_device_name()
    peaks = GPU_PEAKS.get(kind)
    return None if peaks is None else (kind, *peaks)


# ----------------------------------------------------------------------
# Analytical histogram-kernel counts

def analytical_hist_counts(R: int, F: int, B: int,
                           L: int) -> Tuple[float, float]:
    """(flops, bytes) of one histogram build as hand-derived: FLOPs
    count the one-hot matmul formulation (2·R·(F·B)·(L·CH)); bytes count
    the irreducible streams (bins uint8 + gh f32 in, hist f32 out)."""
    flops = 2.0 * R * (F * B) * (L * HIST_CH)
    bytes_ = R * F + R * HIST_CH * 4 + F * B * L * HIST_CH * 4
    return flops, bytes_


def fused_candidate_bytes(L: int) -> int:
    """Bytes of a fused build+split pass's candidate-record output: one
    record of ``_REC_LANES`` f32 a slot, as the port's B2 writes it."""
    return L * _REC_LANES * 4


def analytical_build_split_counts(R: int, F: int, B: int, L: int, *,
                                  fused: bool,
                                  emit_hist: bool = False
                                  ) -> Tuple[float, float]:
    """(flops, bytes) of one full BUILD+SPLIT pass — histogram plus the
    best-split gain scan.

    Two-pass: the [F, B, L, CH] f32 histogram goes to HBM once
    (`analytical_hist_counts` prices the write) and the split scan reads
    it back — one extra lattice-sized stream. Fused: the lattice never
    round-trips; the only extra traffic is the candidate records
    (:func:`fused_candidate_bytes`), with the lattice write retained only
    in ``emit_hist`` mode. These are the pass's least bytes: the port's
    B2 still stores its histogram between the accumulation and the
    epilogue kernel. The scan's flops are counted once as 8 ops a
    cell."""
    flops, hist_bytes = analytical_hist_counts(R, F, B, L)
    lattice = F * B * L * HIST_CH * 4
    flops += 8.0 * F * B * L * HIST_CH
    if not fused:
        return flops, hist_bytes + lattice
    bytes_ = (hist_bytes - lattice) + fused_candidate_bytes(L)
    if emit_hist:
        bytes_ += lattice
    return flops, bytes_


def roofline_utilization(tflops: float, gbps: float) -> Dict[str, Any]:
    """MFU / HBM utilization against the card's peaks, when known."""
    peaks = chip_peaks()
    if peaks is None:
        return {}
    kind, pf, pb = peaks
    return {"hist_mfu": round(tflops / pf, 4),
            "hist_hbm_util": round(gbps / pb, 4),
            "chip": kind}


def kernel_roofline_fields(platform: str, t_hist_s: float,
                           R: int, F: int, B: int, L: int) -> dict:
    """Derived FLOP/s + HBM bandwidth for one histogram build, and on
    the card (``platform`` ``"cuda"``) their shares of its peaks. On
    the CPU the same fields are emitted, the peak comparison omitted."""
    flops, bytes_ = analytical_hist_counts(R, F, B, L)
    out = {"hist_tflops": round(flops / t_hist_s / 1e12, 3),
           "hist_hbm_gbps": round(bytes_ / t_hist_s / 1e9, 2)}
    if platform == "cuda":
        out.update(roofline_utilization(out["hist_tflops"],
                                        out["hist_hbm_gbps"]))
    return out


# ----------------------------------------------------------------------
# CostReport of the captured step

@dataclasses.dataclass
class CostReport:
    """One program, priced (the JAX package's fields; see the module
    docstring for what the port fills)."""
    label: str
    flops: float
    transcendentals: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    peak_bytes: int
    generated_code_bytes: int
    n_ops: int
    phase_ops: Dict[str, int]
    phase_bytes: Dict[str, int]

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in ("flops", "transcendentals", "bytes_accessed"):
            d[k] = round(float(d[k]), 1)
        return d


def step_cost_report(gbdt) -> Optional[CostReport]:
    """The captured step's :class:`CostReport`, or None when the booster
    has captured no graph (the eager loop, the CPU). Reads host
    bookkeeping only (the recorded launches, the allocator's peak), so
    it adds no device sync."""
    import torch
    launches = getattr(gbdt, "_graph_launches", None)
    if not launches or getattr(gbdt, "_graph", None) is None:
        return None
    return CostReport(
        label="fused_step", flops=0.0, transcendentals=0.0,
        bytes_accessed=0.0, argument_bytes=0, output_bytes=0,
        temp_bytes=0,
        peak_bytes=int(torch.cuda.max_memory_allocated(gbdt.device)),
        generated_code_bytes=0, n_ops=int(sum(launches.values())),
        phase_ops={}, phase_bytes={})
