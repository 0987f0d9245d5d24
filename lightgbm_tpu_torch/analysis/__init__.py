"""Trace doctor: static analysis over the op traces of the port's hot
path (the port of ``lightgbm_tpu/analysis/``).

The JAX doctor walks jaxprs and compiled HLO. The port's step is a CUDA
graph captured from eager PyTorch, so its counterpart of a jaxpr is the
op trace of the eager step body (:mod:`.op_trace`: every aten op with
its tensors' shapes, dtypes and devices, the profiler phase open at the
time and the port function that issued it; beside it the kernel
launches and the collectives of the live ``CommReport``). The passes:

- :mod:`.op_lint`: the op lint (TD001, TD002, TD102, TD003, TD005),
  the deferred-guard check (TD006) and the collective-phase check
  (TD103);
- :mod:`.capture_guard`: graph captures and kernel-library loads in a
  scope against a bound, and the batcher's shapes against its ladder
  (TD201);
- :mod:`.doctor`: the passes over the canonical entry points, and the
  fused build+split contract (TD007).

``scripts/torch_lint_traces.py`` runs the doctor as the CI gate, and
``python -m lightgbm_tpu_torch trace-doctor`` exposes it to users.

Rule ids are the JAX package's wherever the hazard is the same, so a
finding reads the same in both packages:

=========================  ============================================
JAX rule                   the port's rule (same id)
=========================  ============================================
TD001 dense closure        a tensor made from host data inside the step
constant; TD101 oversized  body (``aten.lift_fresh``, or a CPU -> CUDA
lowered constant           ``_to_copy``/``copy_``) of at least 1 MiB
                           (the JAX ``DEFAULT_CONST_BYTES``). A capture
                           bakes it in, so every replay sees the
                           capture's values. This is TD001; TD101 has no
                           separate level in the port (there is no
                           lowering) and is folded into TD001.
TD002 host callback;       TD002: a host sync in the step
TD102 host transfer        (``aten._local_scalar_dense``, an op whose
                           output size depends on the data such as
                           ``nonzero``, or a CUDA -> CPU copy; on the
                           card, a sync that
                           ``set_sync_debug_mode("error")`` refused).
                           TD102: any other host <-> card copy. A gloo
                           group's staging of a CUDA collective through
                           the host (``Comm._to_host``/``_to_device``)
                           is one TD102 warning with its bytes; the
                           debug mode is lifted for those copies alone.
TD003 f64 widening         an op that casts to, or computes in, float64.
                           Two uses are deliberate and waived by name,
                           each with its reason (``op_lint.F64_WAIVERS``;
                           reported as info, ``waived=True``): the
                           step's flat output packed in f64
                           (``GBDT._flatten``) and the f64 predict sums.
TD004 CPU donation         not carried: PyTorch has no buffer donation.
TD005 class-unrolled       more than ``max_build_programs`` ``build``
build                      spans in one step (``PhaseTotals.count``): a
                           class-batched multiclass step enters it once,
                           a per-class step K times.
TD006 eager guard flag     the step's flat output (``GBDT._layout``)
                           must carry the no-split flag and the finite
                           flag, and the body must make no host sync: a
                           flag read eagerly is a sync.
TD103 out-of-phase         a ``CommReport`` record of at least 4,096
collective                 bytes made during a tree build whose phase is
                           not in ``phases.COLLECTIVE_PHASES``.
TD201 recompile bound      :class:`CaptureGuard`: the step's CUDA-graph
                           captures (``GBDT.capture_count``) plus the
                           kernel library's loads in a scope; for the
                           batcher, the distinct batch shapes its
                           ``predict_fn`` sees after a mixed burst,
                           against ``log2(max_batch_rows) + 1``.
TD007 fused-split lattice  an op output or allocation shaped
                           ``[.., F, B, 3]`` between B2's inputs and its
                           records; the two-pass arm is the negative
                           control. The CPU's plain B2 builds the
                           lattice by design (info); on the card the
                           port's B2 passes it through HBM, reported as
                           a warning (ROADMAP B.5).
=========================  ============================================

TD000 (info) marks a target that does not apply to a config or a
process. The JAX package's ``CompiledEnsemble.compiled_signatures()``
and ``lower_serving()`` have no counterpart while the port's walk is
eager: the serving target checks ``describe()``'s warmed rungs instead.
"""

from .report import Finding, TraceReport, merge_errors  # noqa: F401
from .op_trace import OpRecord, OpTrace, TensorMeta, record  # noqa: F401
from .op_lint import (lint_collectives, lint_deferred_guard,  # noqa: F401
                      lint_ops, count_deferred_flags, F64_WAIVERS)
from .capture_guard import (CaptureGuard, CaptureError,  # noqa: F401
                            ShapeRecorder)
from .doctor import (run_doctor, doctor_main,  # noqa: F401
                     doctor_fused_split, CANONICAL_CONFIGS)

__all__ = [
    "Finding", "TraceReport", "merge_errors",
    "OpRecord", "OpTrace", "TensorMeta", "record",
    "lint_ops", "lint_deferred_guard", "lint_collectives",
    "count_deferred_flags", "F64_WAIVERS",
    "CaptureGuard", "CaptureError", "ShapeRecorder",
    "run_doctor", "doctor_main", "doctor_fused_split",
    "CANONICAL_CONFIGS",
]
