"""The op lint: hazards of an eager body that a CUDA-graph capture bakes
in or that stall the dispatch-ahead loop (the port of
``lightgbm_tpu/analysis/jaxpr_lint.py`` and ``hlo_lint.py``).

It reads an :class:`~.op_trace.OpTrace`. Each finding names its op
path as ``site/op``: the port's function that issued the op, then the
aten op (``boosting.gbdt._flatten/_to_copy``); ops of one rule at one
site are one finding, with their count.

- **TD001 tensor from host data**: a tensor made from host data inside
  the body (``aten.lift_fresh``, or a CPU -> CUDA ``_to_copy``/
  ``copy_``) of at least ``max_const_bytes`` (1 MiB, the JAX
  ``DEFAULT_CONST_BYTES``). A capture bakes such data into the graph,
  so every replay sees the capture's values; pass it in a static
  buffer. (The JAX TD101, a lowered constant, has no separate level in
  the port: the port has no lowering, and TD001 covers the class.)
- **TD002 host sync**: ``aten._local_scalar_dense`` (``.item()``,
  ``bool()``, ``float()`` of a tensor), an op whose output size depends
  on the data (``nonzero``, ``masked_select``, ``unique``, ...), a
  CUDA -> CPU copy, or a sync the card's debug mode refused.
- **TD102 host transfer**: any other host <-> card copy in the body.

  A gloo group stages a collective of a CUDA tensor through the host
  (``Comm._to_host``/``_to_device``); those copies are one TD102
  ``warn``, "gloo staging", with their count and bytes: each is a host
  sync, by design of that backend (NCCL moves CUDA tensors on the card).
- **TD003 float64**: an op that casts to, or computes in, float64. The
  deliberate uses are waived by name (:data:`F64_WAIVERS`): the step's
  flat output and the predict sums, and under the data plan the winner
  merge's record. The collective layer (``parallel.comms``) moves the
  dtype its caller hands it: an op there that only carries an f64 input
  on is the caller's use, and only one that makes f64 fires.
- **TD005 class-unrolled build**: more entries into the ``build``
  phase than ``max_build_programs``.

:func:`lint_deferred_guard` is TD006 (the step's deferred flags) and
:func:`lint_collectives` TD103 (an out-of-phase collective).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..phases import BUILD, COLLECTIVE_PHASES
from .report import TraceReport

__all__ = ["lint_ops", "lint_deferred_guard", "lint_collectives",
           "count_deferred_flags", "host_syncs", "DEFAULT_CONST_BYTES",
           "DEFAULT_MIN_COLLECTIVE_BYTES", "SYNC_OPS", "F64_WAIVERS",
           "DEFAULT_ALLOW"]

DEFAULT_CONST_BYTES = 1 << 20            # 1 MiB (jaxpr_lint.py:70)
DEFAULT_MIN_COLLECTIVE_BYTES = 4096      # hlo_lint.py:41

# aten ops that read a device value on the host, or whose output size
# depends on the data (and so on a value the host must read)
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "_unique",
    "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive", "equal", "is_nonzero"})
_LIFT_OPS = frozenset({"lift_fresh", "lift_fresh_copy"})
_COPY_OPS = frozenset({"_to_copy", "copy_", "to", "_copy_from"})
_NARROW_FLOATS = ("float32", "bfloat16", "float16")

# The two deliberate float64 uses: (allowlist entries, reason).
F64_WAIVERS: Dict[str, Tuple[Tuple[Tuple[str, str], ...], str]] = {
    "step_flat_output": (
        (("TD003", "*:boosting.gbdt._flatten/*"),
         ("TD003", "*:boosting.gbdt._step_impl/copy_")),
        "the step's flat output is packed in f64 (GBDT._flatten, copied "
        "into the step's static output): its ints, bools and bitset "
        "words are exact in f64, so one tensor carries an iteration to "
        "the host in one copy"),
    "predict_f64_sums": (
        (("TD003", "*:ops.predict_ensemble.*"),),
        "the predict walk sums in f64, within 1e-12 of the JAX host "
        "path (ROADMAP C, deliberate deviations)"),
    # found by the doctor under the data plan (only a rank of a group
    # runs it): the same packing as the step's output, for a collective
    "winner_record": (
        (("TD003", "*:boosting.tree_builder._sync_best/*"),),
        "the data plan's winner merge packs a best split's fields in "
        "f64 for one masked-sum all-reduce (tree_builder._sync_best): "
        "ints, bools, f32 and bitset words are exact in f64"),
}
DEFAULT_ALLOW: Tuple[Tuple[str, str], ...] = tuple(
    w for ws, _ in F64_WAIVERS.values() for w in ws)


def _fmt_shape(meta) -> str:
    return f"{meta.dtype} {meta.shape}"


_COMMS_SITE = "parallel.comms."


def host_syncs(trace) -> List:
    """The ops of ``trace`` that read device data on the host (TD002),
    less a gloo group's staging copies (reported apart)."""
    out = []
    for op in trace.ops:
        if trace.is_staging(op):
            continue
        if op.name in SYNC_OPS:
            out.append(op)
        elif (op.name in _COPY_OPS and op.outputs
              and any(m.device == "cuda" for m in op.inputs)
              and op.outputs[0].device == "cpu"):
            out.append(op)
    return out


class _Grouped:
    """Findings of one rule at one op path, reported once with a count."""

    def __init__(self):
        self.by: Dict[Tuple[str, str], list] = {}

    def add(self, rule: str, path: str, meta=None) -> None:
        self.by.setdefault((rule, path), []).append(meta)

    def items(self):
        for (rule, path), metas in self.by.items():
            metas = [m for m in metas if m is not None]
            big = max(metas, key=lambda m: m.nbytes) if metas else None
            yield rule, path, len(self.by[(rule, path)]), big


def lint_ops(trace, *, label: str,
             max_const_bytes: int = DEFAULT_CONST_BYTES,
             max_build_programs: Optional[int] = None,
             allow: Sequence[Tuple[str, str]] = (),
             waivers: bool = True) -> TraceReport:
    """Lint one :class:`~.op_trace.OpTrace`: TD001, TD002, TD102, TD003
    and (with ``max_build_programs``) TD005. ``allow`` adds waivers to
    the named f64 ones (:data:`DEFAULT_ALLOW`), which ``waivers=False``
    drops."""
    rep = TraceReport(label=label)
    g = _Grouped()
    f64_ops: Dict[str, set] = {}        # TD003 is grouped by site
    f64_widen: Dict[str, bool] = {}
    syncs = {id(op) for op in host_syncs(trace)}
    staged = [0, 0]                     # gloo staging copies, bytes
    for op in trace.ops:
        path = f"{op.site}/{op.name}"
        if trace.is_staging(op) and op.name in _COPY_OPS and op.outputs:
            staged[0] += 1
            staged[1] += op.outputs[0].nbytes
            continue
        if id(op) in syncs:
            g.add("TD002", path, op.inputs[0] if op.inputs else None)
            continue
        out = op.outputs[0] if op.outputs else None
        if op.name in _LIFT_OPS and out is not None:
            if out.nbytes >= max_const_bytes:
                g.add("TD001", path, out)
        elif (op.name in _COPY_OPS and out is not None
              and out.device == "cuda"
              and any(m.device == "cpu" for m in op.inputs)):
            g.add("TD001" if out.nbytes >= max_const_bytes else "TD102",
                  path, out)
        f64 = [m for m in op.outputs if m.dtype == "float64"]
        if f64 and op.site.startswith(_COMMS_SITE) and any(
                m.dtype == "float64" for m in op.inputs):
            continue                    # carried on for its caller
        if f64:
            widen = any(m.dtype in _NARROW_FLOATS for m in op.inputs)
            f64_ops.setdefault(op.site, set()).add(op.name)
            f64_widen[op.site] = f64_widen.get(op.site, False) or widen
            g.add("TD003", op.site, f64[0])
    for rule, path, n, big in g.items():
        nb = big.nbytes if big is not None else 0
        what = f"{n} op(s)" + (f", largest {_fmt_shape(big)}" if big else "")
        if rule == "TD001":
            rep.add(rule, "error", path,
                    f"tensor made from host data inside the body ({what}); "
                    "a capture bakes it in, so every replay sees the "
                    "capture's values: pass it in a static buffer",
                    nbytes=nb)
        elif rule == "TD002":
            rep.add(rule, "error", path,
                    f"host sync inside the body ({what}): the host waits "
                    "for the card, and a capture cannot hold it")
        elif rule == "TD102":
            rep.add(rule, "error", path,
                    f"host <-> card copy inside the body ({what})",
                    nbytes=nb)
        else:
            rep.add(rule, "error",
                    f"{path}/{'+'.join(sorted(f64_ops[path]))}",
                    ("dtype widening to float64" if f64_widen[path]
                     else "float64 compute")
                    + f" inside the body ({what}); the port's numerics "
                    "are f32/bf16/int8 by design")
    if staged[0]:
        rep.add("TD102", "warn", "parallel.comms/gloo-staging",
                f"gloo stages the collectives of CUDA tensors through the "
                f"host: {staged[0]} copies, {staged[1]} B; each is a host "
                "sync (the card's sync debug mode is lifted for them "
                "alone); NCCL moves CUDA tensors on the card",
                nbytes=staged[1])
    if trace.sync_error:
        rep.add("TD002", "error", "sync_debug_mode",
                f"the card refused a host sync: {trace.sync_error}")
    if max_build_programs is not None:
        n = trace.phase_totals.count(BUILD)
        if n > max_build_programs:
            rep.add("TD005", "error", BUILD,
                    f"class-unrolled build: {n} entries into the build "
                    f"phase in one step (budget {max_build_programs}); "
                    "per-class tree builds should batch over the class "
                    "axis into ONE build (class_batch=auto), not loop "
                    "for k in range(num_class)")
    allow = tuple(allow) + (DEFAULT_ALLOW if waivers else ())
    rep.apply_allowlist(allow)
    if waivers:
        for f in rep.findings:
            for entries, reason in F64_WAIVERS.values():
                if f.waived and any(f.rule == rule and _match(f, pat)
                                    for rule, pat in entries):
                    f.message += f"; waived: {reason}"
                    break
    return rep


def _match(f, pat: str) -> bool:
    from fnmatch import fnmatch
    return (fnmatch(f.key(), pat) or fnmatch(f.op_path, pat)
            or fnmatch(f.label, pat))


def count_deferred_flags(layout) -> int:
    """The flags in a step's flat-output layout (``GBDT._layout``, a
    list of (shape, dtype)): the bool entries of rank 0 or 1, the
    no-split flag ``grew`` [K] and the finite flag (the tree fields'
    bools carry a node axis)."""
    import torch
    return sum(1 for shape, dt in layout
               if dt == torch.bool and len(shape) <= 1)


def lint_deferred_guard(layout, *, label: str, expect_flags: int = 2,
                        trace=None,
                        allow: Sequence[Tuple[str, str]] = ()
                        ) -> TraceReport:
    """TD006: the step's deferred flags must reach its flat output.

    The no-split flag and the NaN guard's finite flag each ride the
    step's output (``GBDT._flatten``), read together at the ring's one
    transfer in ``sync``. A guard that reads its flag eagerly
    (``bool(ok)`` in the body) drops it from the output and makes a host
    sync an iteration; with ``trace``, the body's host syncs (TD002's)
    fail this rule too."""
    rep = TraceReport(label=label)
    n = count_deferred_flags(layout) if layout is not None else 0
    if n < expect_flags:
        rep.add("TD006", "error", "deferred_flags",
                f"{n} flag(s) in the step's flat output, expected "
                f">= {expect_flags} (no-split stop + nan_guard finite "
                "flag); a guard checked eagerly inside the body drops its "
                "flag from the output and forces a host sync per "
                "iteration")
    if trace is not None:
        syncs = host_syncs(trace)
        if syncs or trace.sync_error:
            rep.add("TD006", "error", "eager_flag",
                    f"{len(syncs) + bool(trace.sync_error)} host read(s) "
                    "inside the step body: a flag read eagerly is a sync")
    return rep.apply_allowlist(allow)


def lint_collectives(collectives, *, label: str,
                     allowed_phases: Optional[frozenset] = None,
                     within: Optional[str] = BUILD,
                     min_collective_bytes: int = DEFAULT_MIN_COLLECTIVE_BYTES,
                     allow: Sequence[Tuple[str, str]] = ()) -> TraceReport:
    """TD103: a collective of at least ``min_collective_bytes`` run
    inside the ``within`` phase (a tree build; None: anywhere) whose
    phase tag is none of ``allowed_phases`` (default
    ``phases.COLLECTIVE_PHASES``). The collective record attributes
    traffic by these tags; an untagged collective is traffic the audit
    cannot see. Smaller ones report as info. ``allowed_phases=
    frozenset()`` with ``within=None`` asserts that no collective runs
    at all (the predict walk)."""
    rep = TraceReport(label=label)
    if allowed_phases is None:
        allowed_phases = COLLECTIVE_PHASES
    for op in collectives:
        spans = op.span.split("/") if op.span else []
        if within is not None and within not in spans:
            continue
        if op.phase in allowed_phases:
            continue
        sev = "error" if op.out_bytes >= min_collective_bytes else "info"
        rep.add("TD103", sev, f"{op.span or '-'}/{op.phase or 'untagged'}",
                f"{op.kind} {op.dtype} {op.shape} outside the allowed "
                f"phases ({'/'.join(sorted(allowed_phases)) or 'none'}); "
                "untagged collectives are invisible to the comms audit",
                nbytes=op.out_bytes)
    return rep.apply_allowlist(allow)
