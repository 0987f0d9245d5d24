"""The trace doctor: every pass over the canonical entry points (the
port of ``lightgbm_tpu/analysis/doctor.py``).

Entry points, per canonical config:

- **step**: trains a tiny booster with the step pinned on, then runs
  the step body (``GBDT._step_impl``, what the CUDA graph holds) once
  more under the op recorder, on the booster's own static buffers, and
  puts the scores and the step's output back afterwards. The op lint
  sees host data, host syncs, host copies, float64 and the build
  entries; TD006 reads the step's flat-output layout.
- **tree builder**: one eager iteration of a ``tree_learner=data``
  booster, when this process is a rank of a group started by
  ``lightgbm_tpu_torch.launch``; its collectives must carry the
  ``hist_merge``/``winner_sync`` phases inside a build (TD103).
- **predict ensemble**: ``ops.predict_ensemble.walk`` over the packed
  trained ensemble: no collective, no host work.
- **serving batcher**: a mixed-size burst through ``MicroBatcher`` over
  the walk; the batch shapes must stay on the power-of-two ladder
  (``log2(max_batch_rows) + 1`` shapes, TD201), and the walk of one
  bucket lints clean.
- **serving compiled**: ``codegen.CompiledEnsemble`` warmed over the
  ladder. The walk is eager, so there are no compiled signatures to
  count: ``describe()["warmed_rungs"]`` must equal the ladder, a burst
  must place nothing new and upload no table, and the walk
  (``_tensor_leaves``) must make no host sync and no collective.
- **fused split**: B2's contract that only candidate records leave the
  kernel (TD007), with the two-pass arm as the detector's negative
  control.

Every target runs on the card by default (``device="cuda"``) and on the
CPU only when asked; a target whose kernel cannot launch raises.
``scripts/torch_lint_traces.py`` runs the battery as the CI gate;
``python -m lightgbm_tpu_torch trace-doctor`` is the user-facing form;
``tests/test_torch_analysis.py`` runs a subset.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .capture_guard import ShapeRecorder
from .op_lint import (lint_collectives, lint_deferred_guard, lint_ops)
from .op_trace import record
from .report import TraceReport, merge_errors

__all__ = ["CANONICAL_CONFIGS", "PARALLEL_MODES", "make_booster",
           "doctor_fused_step", "doctor_tree_builder", "doctor_predict",
           "doctor_batcher", "doctor_serving", "doctor_fused_split",
           "run_doctor", "doctor_main"]

# name -> (train-param overrides, dataset kwargs); doctor.py:59-80
CANONICAL_CONFIGS: Dict[str, Tuple[dict, dict]] = {
    "plain": ({}, {}),
    "efb": ({"enable_bundle": True}, {}),
    "quantized": ({"use_quantized_grad": True,
                   "num_grad_quant_bins": 4}, {}),
    "categorical": ({}, {"categorical_feature": [0]}),
    # class-batched multiclass: the step must enter ONE build (TD005),
    # not num_class of them
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "metric": "multi_logloss", "num_leaves": 5}, {}),
    # armed NaN guard over the bagging config: the finite flag must stay
    # a deferred output of the step (TD006), not an eager host check
    "nan_guard": ({"nan_guard": "rollback", "bagging_fraction": 0.8,
                   "bagging_freq": 2, "bagging_seed": 7}, {}),
    # the telemetry stack armed (event log, live endpoints, armed
    # guard): the sync-free step must survive observation.
    # event_log="auto" is rerouted to a scratch dir by make_booster
    "telemetry": ({"nan_guard": "rollback", "event_log": "auto",
                   "telemetry_port": 0}, {}),
}
PARALLEL_MODES = ("serial", "data")

_BASE_PARAMS = dict(objective="binary", metric="auc", num_leaves=7,
                    learning_rate=0.2, min_data_in_leaf=5, verbosity=-1)

# the pointer a TD007 finding on the card's B2 carries
_B5 = "ROADMAP B.5"


@contextlib.contextmanager
def _pin_fused(on: bool):
    prev = os.environ.get("LIGHTGBM_TPU_FUSED_TRAIN")
    os.environ["LIGHTGBM_TPU_FUSED_TRAIN"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("LIGHTGBM_TPU_FUSED_TRAIN", None)
        else:
            os.environ["LIGHTGBM_TPU_FUSED_TRAIN"] = prev


def _synth(config: str, *, n: int = 160, f: int = 8, seed: int = 0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    if config == "categorical":
        X[:, 0] = rng.randint(0, 5, size=n)
    if config == "efb":
        # mutually-exclusive sparse pair so a bundle actually forms
        on = rng.rand(n) < 0.5
        X[:, -2] = np.where(on, X[:, -2], 0.0)
        X[:, -1] = np.where(on, 0.0, X[:, -1])
    if config == "multiclass":
        y = (X[:, :3] + 0.5 * rng.normal(size=(n, 3))).argmax(1) \
            .astype(np.float32)
    else:
        y = (X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
             + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _in_group() -> bool:
    from ..parallel.distributed import world_size
    return world_size() > 1


def _live_comm():
    """The default group's Comm when this process is a rank, else None."""
    if not _in_group():
        return None
    from ..parallel.distributed import default_comm
    return default_comm()


def make_booster(config: str = "plain", mode: str = "serial", *,
                 rounds: int = 2, n: int = 160, f: int = 8,
                 fused: bool = True, device: str = "cuda"):
    """Train the tiny canonical booster for one (config, mode) cell on
    ``device``."""
    import lightgbm_tpu_torch as lgt
    overrides, ds_kw = CANONICAL_CONFIGS[config]
    X, y = _synth(config, n=n, f=f)
    params = dict(_BASE_PARAMS, **overrides, tree_learner=mode,
                  device_type=device)
    if params.get("event_log"):
        # telemetry cell: keep the event log (and auto's output_model
        # anchor) out of the caller's cwd
        import tempfile
        scratch = tempfile.mkdtemp(prefix="lgbtpu_doctor_")
        params["event_log"] = os.path.join(scratch,
                                           "doctor.events.jsonl")
    with _pin_fused(fused):
        ds = lgt.Dataset(X, label=y, params=dict(params), **ds_kw)
        return lgt.train(params, ds, num_boost_round=rounds)


def _step_trace(gb, device):
    """One run of the step body under the recorder, on the booster's own
    static buffers; the scores and the step's output are put back, so
    the booster trains on as if it had not run."""
    import torch
    saved = [t.clone() for t in (gb.scores, *gb.valid_scores,
                                 gb._step_out)]
    try:
        return record(gb._step_impl, gb._goss_on(gb.iter_), device=device,
                      comm=_live_comm())
    finally:
        with torch.no_grad():
            for dst, src in zip((gb.scores, *gb.valid_scores,
                                 gb._step_out), saved):
                dst.copy_(src)


def doctor_fused_step(bst, *, label: str = "fused_step",
                      deferred_guard: Optional[bool] = None,
                      out: Optional[dict] = None,
                      allow: Sequence[Tuple[str, str]] = ()
                      ) -> List[TraceReport]:
    """Lint the step of a trained booster, on its own device. Returns
    an info report when the step's gate pins the eager loop for this
    config (the eager loop's phases run op by op from the host; the
    builder and predict targets cover them). TD006 is checked when the
    NaN guard is armed, or when ``deferred_guard`` says so. ``out``,
    when given, receives the step's :class:`~.op_trace.OpTrace` under
    ``"trace"``."""
    gb = bst._gbdt
    with _pin_fused(True):
        reason = gb._fused_gate_reason()
    if reason or gb._step_out is None:
        rep = TraceReport(label=label)
        rep.add("TD000", "info", "fused_gate",
                "the step is unavailable for this config: "
                f"{reason or 'it has not run yet'}")
        return [rep]
    device = gb.device.type
    trace = _step_trace(gb, device)
    # TD005 budget: one build a step when single-class or class-batched;
    # a per-class config (linear / forced / CEGB) loops, and is skipped
    budget = 1 if (gb.K == 1 or gb.class_batch_ok) else None
    reports = [lint_ops(trace, label=f"{label}/ops",
                        max_build_programs=budget, allow=allow),
               lint_collectives(trace.collectives,
                                label=f"{label}/collectives", allow=allow)]
    if deferred_guard or (deferred_guard is None
                          and gb._nan_guard != "off"):
        reports.append(lint_deferred_guard(
            gb._layout, label=f"{label}/guard", expect_flags=2,
            trace=trace, allow=allow))
    if out is not None:
        out["trace"] = trace
    return reports


def doctor_tree_builder(*, label: str = "tree_builder",
                        device: str = "cuda",
                        allow: Sequence[Tuple[str, str]] = ()
                        ) -> List[TraceReport]:
    """Lint one eager iteration of a ``tree_learner=data`` booster over
    this process's group: its ops, and its collectives' phases inside
    the build. A process that is not a rank of a launched group reports
    info, as the JAX doctor does on a single-device host."""
    if not _in_group():
        rep = TraceReport(label=label)
        rep.add("TD000", "info", "group",
                "not a rank of a group started by lightgbm_tpu_torch."
                "launch: the data-parallel build is not lintable")
        return [rep]
    bst = make_booster("plain", "data", device=device, fused=False)
    gb = bst._gbdt
    comm = gb.plan.comm
    trace = record(gb._train_one_iter_eager, device=device, comm=comm)
    return [lint_ops(trace, label=f"{label}/ops", allow=allow),
            lint_collectives(trace.collectives,
                             label=f"{label}/collectives", allow=allow)]


def _packed(bst, device):
    from ..ops.predict_ensemble import pack_ensemble
    return pack_ensemble(bst._all_trees(), device)


def _walk_reports(label, fn, *args, device, allow, **kwargs):
    trace = record(fn, *args, device=device, comm=_live_comm(), **kwargs)
    return [lint_ops(trace, label=f"{label}/ops", allow=allow),
            lint_collectives(trace.collectives, label=f"{label}/collectives",
                             allowed_phases=frozenset(), within=None,
                             allow=allow)]


def doctor_predict(bst, *, label: str = "predict_ensemble",
                   rows: int = 16, device: Optional[str] = None,
                   allow: Sequence[Tuple[str, str]] = ()
                   ) -> List[TraceReport]:
    """Lint the packed-ensemble walk: no collectives, no host work, no
    tensor made from host data (the ensemble is an argument)."""
    import torch
    from ..ops.predict_ensemble import walk
    device = device or bst._predict_device().type
    ens = _packed(bst, device)
    X = torch.zeros((rows, bst.num_feature()), dtype=torch.float64,
                    device=device)
    return _walk_reports(label, walk, ens, X, device=device, allow=allow)


def doctor_batcher(bst, *, label: str = "serving_batcher",
                   max_batch_rows: int = 64, min_bucket: int = 8,
                   burst: Sequence[int] = (3, 5, 8, 13, 21, 40, 64,
                                           7, 9, 33),
                   device: Optional[str] = None,
                   allow: Sequence[Tuple[str, str]] = ()
                   ) -> List[TraceReport]:
    """A mixed-size burst through the micro-batcher over the walk: the
    ladder bounds the batch shapes the walk sees (TD201), and the walk
    of one bucket lints clean."""
    import torch
    from ..ops.predict_ensemble import walk
    from ..serving.batcher import MicroBatcher
    device = device or bst._predict_device().type
    ens = _packed(bst, device)
    F = bst.num_feature()

    def predict_fn(Xb):
        out = walk(ens, torch.from_numpy(np.asarray(Xb, np.float64))
                   .to(device))
        return out.sum(1).cpu().numpy()

    shapes = ShapeRecorder(predict_fn)
    mb = MicroBatcher(shapes, max_batch_rows=max_batch_rows,
                      max_wait_us=100, min_bucket=min_bucket)
    try:
        for n in burst:
            mb.submit(np.zeros((n, F), np.float64))
    finally:
        mb.close()
    rep = TraceReport(label=label)
    bound = int(math.log2(max_batch_rows)) + 1
    if shapes.signatures > bound:
        rep.add("TD201", "error", "bucket_ladder",
                f"{shapes.signatures} batch shapes after a mixed burst; "
                f"the power-of-two ladder bounds the batcher to {bound}")
    X = torch.zeros((min_bucket, F), dtype=torch.float64, device=device)
    return [rep.apply_allowlist(allow)] + _walk_reports(
        label, walk, ens, X, device=device, allow=allow)


def doctor_serving(bst, *, label: str = "serving_compiled",
                   max_batch_rows: int = 64, min_bucket: int = 8,
                   burst: Sequence[int] = (3, 8, 21, 64, 9),
                   device: Optional[str] = None,
                   allow: Sequence[Tuple[str, str]] = ()
                   ) -> List[TraceReport]:
    """Lint the tensorized compiled-ensemble serving path. Nothing
    compiles in the port, so after ``warm`` over the ladder the doctor
    checks that ``describe()`` lists exactly the ladder's rungs, that a
    burst places nothing new and uploads no table (TD201: the registry
    publishes a version only after ``warm``), and that the walk makes no
    host sync (TD002) and no collective (TD103)."""
    import torch
    from ..codegen import CompiledEnsemble, _tensor_leaves

    rep = TraceReport(label=label)
    try:
        ce = CompiledEnsemble(bst)
    except (ValueError, TypeError) as e:
        rep.add("TD000", "info", "tensorize",
                f"ensemble not tensorizable: {e}")
        return [rep]
    device = device or ce.default_device.type
    rungs = []
    r = min_bucket
    while r < max_batch_rows:
        rungs.append(r)
        r *= 2
    rungs.append(max_batch_rows)
    ce.warm(rungs, device=device)
    warmed = ce.describe()["warmed_rungs"]
    if warmed != rungs:
        rep.add("TD201", "error", "warmed_rungs",
                f"describe() lists rungs {warmed} after warming the "
                f"ladder {rungs}")
    placed = dict(ce._placed)
    tables = ce.tables_for(device)
    shapes = {tuple(t.shape) for t in tables[0]}
    F = ce.num_features
    # a predict call brings its result to the host: no sync debug mode
    burst_trace = record(
        lambda: [ce.predict(np.zeros((n, F)), device=device)
                 for n in burst], device=device, sync_debug=False)
    if ce._placed.keys() != placed.keys() or any(
            ce._placed[k] is not v for k, v in placed.items()):
        rep.add("TD201", "error", "placement",
                "a burst after warm placed tables anew")
    uploads = [op for op in burst_trace.ops
               if op.name in ("_to_copy", "copy_") and op.outputs
               and op.outputs[0].device != "cpu"
               and any(m.device == "cpu" for m in op.inputs)
               and op.outputs[0].shape in shapes]
    if uploads:
        rep.add("TD201", "error", "table_upload",
                f"a burst after warm uploaded {len(uploads)} table(s) to "
                "the device")
    tb, _ = tables
    Xd = torch.zeros((min_bucket, F), dtype=torch.float32, device=device)
    return [rep.apply_allowlist(allow)] + _walk_reports(
        label, _tensor_leaves, tb, Xd, depth=ce.depth, device=device,
        allow=allow)


def _lattice_hits(trace, F: int, B: int):
    """(op, shape) of every op output shaped [.., F, B, 3]."""
    hits = []
    for op in trace.ops:
        for m in op.outputs:
            if len(m.shape) >= 3 and tuple(m.shape[-3:]) == (F, B, 3):
                hits.append((op.name, m.shape))
    return hits


def doctor_fused_split(*, label: str = "fused_split", device: str = "cuda",
                       R: int = 256, F: int = 16, B: int = 12,
                       out: Optional[dict] = None,
                       allow: Sequence[Tuple[str, str]] = ()
                       ) -> List[TraceReport]:
    """B2's contract (TD007): between its inputs and its candidate
    records no ``[.., F, B, 3]`` histogram lattice may be materialized,
    only the records leave the kernel. ``B`` is off the power-of-two
    grid, as in the JAX doctor. The two-pass arm (B1, then
    ``find_best_splits``) is the negative control: the detector must
    find the lattice there, else the rule itself is broken (an error).

    On the CPU, B2's plain version builds the lattice by design, so the
    fused arm reports info. On the card, the port's B2 writes the
    lattice to HBM through B1's accumulation and its epilogue reads it
    back (``ops/cuda_histogram.py`` ``fused_build_best_splits``): the
    doctor reports that as a warning, with its shape and a pointer to
    ROADMAP B.5, where the kernel's redesign is queued. ``out``, when
    given, receives the two arms' traces under ``"fused"`` and
    ``"two_pass"``."""
    import torch

    from ..boosting.tree_builder import build_tree
    from ..ops.split import SplitParams

    dev = torch.device(device)
    rng = np.random.RandomState(2)
    bins = torch.from_numpy(rng.randint(0, B, size=(R, F))
                            .astype(np.uint8)).to(dev)
    gh = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32)) \
        .to(dev)
    rl0 = torch.zeros((R,), dtype=torch.int32, device=dev)
    meta = (torch.full((F,), B, dtype=torch.int32, device=dev),
            torch.full((F,), -1, dtype=torch.int32, device=dev),
            torch.zeros((F,), dtype=torch.bool, device=dev),
            torch.ones((F,), dtype=torch.bool, device=dev))
    kw = dict(num_leaves=7, leaf_batch=2, max_depth=-1, num_bins=B,
              hist_dtype="float32", hist_sub=False, has_cat=False,
              split_params=SplitParams(min_data_in_leaf=5,
                                       min_sum_hessian_in_leaf=1e-3))
    fused = record(build_tree, bins, gh, rl0, *meta, fused_split=True,
                   device=device, **kw)
    two = record(build_tree, bins, gh, rl0, *meta, device=device, **kw)
    rep = TraceReport(label=label)
    hits = _lattice_hits(fused, F, B)
    if hits:
        ops = "+".join(sorted({op for op, _ in hits}))
        shapes = ", ".join(str(s) for s in sorted({s for _, s in hits}))
        if dev.type == "cpu":
            rep.add("TD000", "info", ops,
                    f"histogram lattice {shapes} in the fused arm "
                    f"({len(hits)} op(s)): B2's plain version (CPU "
                    "tensors) builds it by design")
        else:
            rep.add("TD007", "warn", ops,
                    f"histogram lattice {shapes} materialized in the "
                    f"fused build+split ({len(hits)} op(s)): the port's "
                    "B2 passes it through HBM between its accumulation "
                    "and its epilogue, where only candidate records "
                    f"should leave the kernel ({_B5})")
    if not _lattice_hits(two, F, B):
        rep.add("TD007", "error", "negative_control",
                "two-pass arm shows no histogram lattice: the detector "
                "is broken, not the kernel")
    if out is not None:
        out.update(fused=fused, two_pass=two)
    return [rep.apply_allowlist(allow)]


def run_doctor(configs: Optional[Sequence[str]] = None,
               modes: Optional[Sequence[str]] = None, *,
               device: str = "cuda",
               allow: Sequence[Tuple[str, str]] = (),
               verbose: bool = False) -> List[TraceReport]:
    """The full battery on ``device``: per (config, mode) cell the step,
    plus the mode-independent builder, predict, batcher, serving and
    fused-split targets once. A ``data`` cell outside a launched group
    reports info once."""
    reports: List[TraceReport] = []
    configs = list(configs or CANONICAL_CONFIGS)
    modes = list(modes or PARALLEL_MODES)
    first_bst = None
    for mode in modes:
        if mode == "data" and not _in_group():
            rep = TraceReport(label="fused_step[*/data]")
            rep.add("TD000", "info", "group",
                    "not a rank of a group started by lightgbm_tpu_torch."
                    "launch: the data cells are not lintable")
            reports.append(rep)
            continue
        for cfg in configs:
            cell = f"{cfg}/{mode}"
            bst = make_booster(cfg, mode, device=device)
            if first_bst is None and mode == "serial":
                first_bst = bst
            reports += doctor_fused_step(bst, label=f"fused_step[{cell}]",
                                         allow=allow)
    if "data" in modes:
        reports += doctor_tree_builder(device=device, allow=allow)
    reports += doctor_fused_split(device=device, allow=allow)
    if first_bst is not None:
        reports += doctor_predict(first_bst, allow=allow)
        reports += doctor_batcher(first_bst, allow=allow)
        reports += doctor_serving(first_bst, allow=allow)
    return reports


def doctor_main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI driver (``python -m lightgbm_tpu_torch trace-doctor``). Exit 0
    when every report is clean, 1 otherwise."""
    import argparse
    p = argparse.ArgumentParser(
        prog="lightgbm_tpu_torch trace-doctor",
        description="static analysis over the hot path's op traces "
                    "(op lint, collective phases, capture bounds)")
    p.add_argument("--config", action="append", dest="configs",
                   choices=sorted(CANONICAL_CONFIGS),
                   help="canonical config(s); default: all")
    p.add_argument("--mode", action="append", dest="modes",
                   choices=PARALLEL_MODES,
                   help="tree-learner mode(s); default: all")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the targets run (default: the card)")
    p.add_argument("--allow", action="append", default=[],
                   metavar="RULE:PATTERN",
                   help="waive findings, e.g. TD103:'*root_sums*'")
    p.add_argument("-v", "--verbose", action="store_true")
    ns = p.parse_args(argv)
    allow = tuple(a.split(":", 1) for a in ns.allow)
    reports = run_doctor(ns.configs, ns.modes, device=ns.device,
                         allow=allow)
    for r in reports:
        print(r.render(verbose=ns.verbose))
    errs = merge_errors(reports)
    print(f"trace-doctor: {len(reports)} report(s), "
          f"{len(errs)} error(s)")
    return 1 if errs else 0
