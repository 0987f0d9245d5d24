"""The port's trace doctor (``lightgbm_tpu_torch/analysis/``) on the CPU,
against the JAX package's (``lightgbm_tpu/analysis/``).

Mirrors ``tests/test_trace_doctor.py`` (less TD004, which the port does
not carry, and the ``jax.experimental`` cases): each rule fires on a
seeded violation and stays silent on the clean form; the capture guard
and the batcher's ladder bound; the doctor's targets lint clean at HEAD.
Across the packages: the reports render byte-equal; the same seeded
hazard fires the same rule id in both and both clean forms lint clean;
TD005 counts one build for a class-batched step and K for a per-class
step, TD006 two flags, TD007's negative control fires in both; the
port's canonical boosters grow the JAX
package's trees (the contract of ``tests/test_torch_train.py``: equal
structure, leaves within rtol 1e-5).
"""

import contextlib
import functools
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import profiler
from lightgbm_tpu_torch.analysis import (CaptureError, CaptureGuard,
                                         Finding, ShapeRecorder,
                                         TraceReport, count_deferred_flags,
                                         lint_collectives,
                                         lint_deferred_guard, lint_ops,
                                         merge_errors, record)
from lightgbm_tpu_torch.analysis import doctor as PD
from lightgbm_tpu_torch.parallel.comms import CollectiveOp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _rules(rep):
    return sorted({f.rule for f in rep.errors})


def _lint_script():
    spec = importlib.util.spec_from_file_location(
        "torch_lint_traces", os.path.join(REPO, "scripts",
                                          "torch_lint_traces.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- report

def test_finding_rejects_unknown_severity():
    with pytest.raises(ValueError):
        Finding(rule="TD001", severity="fatal", label="l", op_path="p",
                message="m")


def test_allowlist_waives_but_keeps_finding():
    rep = TraceReport(label="prog")
    rep.add("TD103", "error", "some/iota/op", "untagged collective")
    rep.add("TD103", "error", "other/op", "untagged collective")
    rep.apply_allowlist([("TD103", "*iota*")])
    assert len(rep.findings) == 2
    assert [f.waived for f in rep.findings] == [True, False]
    assert len(rep.errors) == 1          # only the unwaived one gates
    assert not rep.ok
    rep.apply_allowlist([("TD103", "prog:*")])   # label-anchored waiver
    assert rep.ok
    assert merge_errors([rep]) == []


def test_report_renders_byte_equal_to_jax():
    """The same findings, waivers included, render to the same bytes in
    both packages."""
    from lightgbm_tpu.analysis.report import TraceReport as JReport
    reps = []
    for cls in (JReport, TraceReport):
        r = cls(label="fused_step[plain/serial]/ops")
        r.add("TD001", "error", "const[0]", "dense closure constant",
              nbytes=2 << 20)
        r.add("TD003", "error", "boosting.gbdt._flatten/_to_copy",
              "dtype widening to float64")
        r.add("TD103", "info", "build/root_sums", "small collective",
              nbytes=96)
        r.add("TD000", "info", "fused_gate", "not applicable")
        r.apply_allowlist([("TD003", "*_flatten*")])
        reps.append(r)
    j, p = reps
    for verbose in (False, True):
        assert p.render(verbose=verbose) == j.render(verbose=verbose)
    assert [f.key() for f in p.findings] == [f.key() for f in j.findings]
    assert [(f.severity, f.waived) for f in p.findings] == \
        [(f.severity, f.waived) for f in j.findings]


# ------------------------------------------------------------- op rules

def test_td001_host_data_fires_and_argument_form_is_clean():
    big = np.ones((512, 1024), np.float32)           # 2 MiB
    x = torch.ones(1024)
    bad = lint_ops(record(lambda v: (v[None, :] * torch.tensor(big)).sum(),
                          x, device="cpu"), label="host_data")
    assert _rules(bad) == ["TD001"]
    assert bad.errors[0].nbytes == big.nbytes
    good = lint_ops(record(lambda v, b: (v[None, :] * b).sum(), x,
                           torch.from_numpy(big), device="cpu"),
                    label="argument")
    assert good.ok


def test_td002_host_sync_fires_and_deferred_form_is_clean():
    def reads(x):
        return x * 2 if bool((x > 0).all()) else x

    def defers(x):
        return torch.where((x > 0).all(), x * 2, x)
    x = torch.ones(16)
    bad = lint_ops(record(reads, x, device="cpu"), label="reads")
    assert _rules(bad) == ["TD002"]
    assert "_local_scalar_dense" in bad.errors[0].op_path
    assert lint_ops(record(defers, x, device="cpu"), label="defers").ok
    # a data-dependent output size is a sync too
    nz = lint_ops(record(lambda v: v.nonzero(), x, device="cpu"),
                  label="nonzero")
    assert _rules(nz) == ["TD002"]


def test_td003_f64_widening_fires_only_under_widening():
    x = torch.ones(4)
    rep = lint_ops(record(lambda v: v.to(torch.float64) + 1.0, x,
                          device="cpu"), label="widen")
    assert _rules(rep) == ["TD003"]
    assert "widening" in rep.errors[0].message
    assert lint_ops(record(lambda v: v.to(torch.bfloat16), x,
                           device="cpu"), label="narrow").ok


def test_td003_named_waivers_are_info():
    """The step's flat output and the predict sums are waived by name
    (info, waived=True, the reason in the message); a caller's own f64
    op is not."""
    from lightgbm_tpu_torch.analysis.op_lint import F64_WAIVERS
    bst = PD.make_booster("plain", device="cpu")
    rep = PD.doctor_fused_step(bst)[0]
    td3 = [f for f in rep.findings if f.rule == "TD003"]
    assert td3 and all(f.waived and f.severity == "info" for f in td3)
    reason = F64_WAIVERS["step_flat_output"][1]
    assert all(reason in f.message for f in td3)
    unwaived = lint_ops(record(lambda v: v.double(), torch.ones(3),
                               device="cpu"), label="x", waivers=False)
    assert _rules(unwaived) == ["TD003"]


def test_td005_counts_build_entries():
    def step(gh, per_class):
        outs = []
        for k in range(gh.shape[0] if per_class else 1):
            with profiler.phase("build"):
                outs.append(gh.sum())
        return outs
    gh = torch.ones((3, 8))
    one = record(step, gh, False, device="cpu")
    three = record(step, gh, True, device="cpu")
    assert one.phase_totals.count("build") == 1
    assert three.phase_totals.count("build") == 3
    assert lint_ops(one, label="batched", max_build_programs=1).ok
    assert _rules(lint_ops(three, label="unrolled",
                           max_build_programs=1)) == ["TD005"]


def _comms_trace(gloo, site, name, src, dst, nbytes=8 << 20,
                 dtype="float32", out_dtype=None):
    """An OpTrace of one op issued by the collective layer."""
    from lightgbm_tpu_torch.analysis.op_trace import (OpRecord, OpTrace,
                                                      TensorMeta)
    shape = (nbytes // 4,)
    rec = OpRecord(f"aten.{name}.default",
                   (TensorMeta(shape, dtype, src, nbytes),),
                   (TensorMeta(shape, out_dtype or dtype, dst, nbytes),),
                   ("build",), site)
    return OpTrace(device="cuda", ops=[rec], staging=gloo)


@pytest.mark.parametrize("gloo", [True, False])
def test_gloo_staging_is_named_and_nothing_else_of_comms_is_skipped(gloo):
    """A gloo group's staging copies are one TD102 warning with their
    bytes; the same copies on another backend, and a sync, a host copy
    or an f64 cast made anywhere else in the collective layer, fire."""
    from lightgbm_tpu_torch.analysis.op_lint import host_syncs
    down = _comms_trace(gloo, "parallel.comms._to_host", "_to_copy",
                        "cuda", "cpu")
    up = _comms_trace(gloo, "parallel.comms._to_device", "_to_copy",
                      "cpu", "cuda")
    down.ops += up.ops
    rep = lint_ops(down, label="plan")
    if gloo:
        assert rep.ok and not host_syncs(down)
        [f] = rep.findings
        assert (f.rule, f.severity, f.nbytes) == ("TD102", "warn", 16 << 20)
        assert "gloo" in f.message and "2 copies" in f.message
    else:
        assert _rules(rep) == ["TD001", "TD002"]
        assert len(host_syncs(down)) == 1
    for site, name, src, dst, out_dtype, rule in (
            ("parallel.comms.all_reduce", "_local_scalar_dense", "cuda",
             "cpu", None, "TD002"),
            ("parallel.comms.all_gather", "_to_copy", "cuda", "cpu",
             None, "TD002"),
            ("parallel.comms.broadcast", "_to_copy", "cpu", "cuda",
             None, "TD001"),
            ("parallel.comms.all_reduce", "_to_copy", "cuda", "cuda",
             "float64", "TD003")):
        tr = _comms_trace(gloo, site, name, src, dst, out_dtype=out_dtype)
        assert _rules(lint_ops(tr, label="plan", waivers=False)) == [rule]
    # an f64 tensor its caller hands the layer is the caller's use
    carried = _comms_trace(gloo, "parallel.comms.all_reduce", "clone",
                           "cuda", "cuda", dtype="float64")
    assert lint_ops(carried, label="plan", waivers=False).ok


def test_td103_lints_collective_records():
    def op(phase, span, nbytes):
        return CollectiveOp("all-reduce", "float32", (nbytes // 4,),
                            nbytes, phase, span=span)
    ops = [op("hist_merge", "build/hist_merge", 1 << 20),   # tagged
           op("winner_sync", "build/winner_sync", 1 << 16),
           op("", "build", 1 << 20),                        # untagged
           op("root_sums", "build", 96),                    # small
           op("", "eval", 1 << 20)]                         # not a build
    rep = lint_collectives(ops, label="plan")
    assert [(f.rule, f.severity) for f in rep.findings] == \
        [("TD103", "error"), ("TD103", "info")]
    assert rep.errors[0].nbytes == 1 << 20
    none = lint_collectives(ops[:1], label="walk",
                            allowed_phases=frozenset(), within=None)
    assert _rules(none) == ["TD103"]


# --------------------------------------------------------- capture guard

class _FakeGBDT:
    capture_count = 0


def test_capture_guard_trips_on_recapture():
    g = _FakeGBDT()
    with pytest.raises(CaptureError) as ei:
        with CaptureGuard(max_captures=0, boosters=[g], label="steady"):
            g.capture_count += 2
    assert [f.rule for f in ei.value.report.errors] == ["TD201"]
    with CaptureGuard(max_captures=1, boosters=[g]) as ok:
        g.capture_count += 1
    assert ok.captures == 1 and ok.report.ok


def test_capture_guard_counts_library_loads(monkeypatch):
    from lightgbm_tpu_torch.ops import cuda_histogram as CH
    guard = CaptureGuard(max_captures=0, label="load", strict=False)
    with guard:
        monkeypatch.setattr(CH, "LIBRARY_LOADS", CH.LIBRARY_LOADS + 1)
    assert guard.loads == 1 and not guard.report.ok


def test_capture_guard_does_not_mask_inner_errors():
    g = _FakeGBDT()
    with pytest.raises(ValueError, match="inner"):
        with CaptureGuard(max_captures=0, boosters=[g], label="masked"):
            g.capture_count += 5
            raise ValueError("inner")


def test_step_holds_its_graphs_over_20_iterations():
    """Steady state captures nothing: on the CPU the step runs its body
    eagerly and never captures, so 20 further iterations keep the
    count (the card's capture and replay are held by chip_smoke.py)."""
    bst = PD.make_booster("plain", device="cpu")
    with _pin_fused(True):
        with CaptureGuard(max_captures=0, boosters=[bst]) as g:
            for _ in range(20):
                bst.update()
            bst._gbdt.sync()
    assert g.captures == 0 and bst.current_iteration() == 22


def test_batcher_ladder_bounds_batch_shapes():
    from lightgbm_tpu_torch.serving.batcher import MicroBatcher
    fn = ShapeRecorder(lambda Xb: Xb.sum(axis=1))
    mb = MicroBatcher(fn, max_batch_rows=64, max_wait_us=100, min_bucket=8)
    try:
        for n in (1, 3, 5, 8, 9, 13, 17, 21, 33, 40, 64, 2, 7, 50):
            assert mb.submit(np.zeros((n, 4), np.float64)).shape == (n,)
    finally:
        mb.close()
    assert 1 <= fn.signatures <= 7               # log2(64) + 1


# ------------------------------------------------------- doctor targets

def test_run_doctor_is_clean_on_cpu():
    """Every serial cell, the fused-split contract, the predict walk,
    the batcher and the compiled serving path lint clean at HEAD."""
    reports = PD.run_doctor(modes=["serial"], device="cpu")
    errs = merge_errors(reports)
    assert not errs, "\n".join(r.render(verbose=True) for r in reports)
    labels = {r.label for r in reports}
    assert {f"fused_step[{c}/serial]/ops"
            for c in PD.CANONICAL_CONFIGS} <= labels
    # every waiver is one of the two named f64 uses
    from lightgbm_tpu_torch.analysis.op_lint import F64_WAIVERS
    named = [F64_WAIVERS[k][1] for k in ("step_flat_output",
                                         "predict_f64_sums")]
    waived = [f for r in reports for f in r.findings if f.waived]
    assert waived and all(f.severity == "info" for f in waived)
    assert all(any(n in f.message for n in named) for f in waived)


def test_fused_split_negative_control_fires():
    out = {}
    rep = PD.doctor_fused_split(device="cpu", out=out)[0]
    assert rep.ok
    assert [f.rule for f in rep.findings] == ["TD000"]  # plain B2, CPU
    assert PD._lattice_hits(out["two_pass"], 16, 12)


def test_doctor_leaves_the_booster_as_it_was():
    """The step's body runs once more under the recorder, and the
    booster trains on bit-identically to one the doctor never saw."""
    a = PD.make_booster("nan_guard", device="cpu")
    b = PD.make_booster("nan_guard", device="cpu")
    out = {}
    reps = PD.doctor_fused_step(a, out=out)
    assert not merge_errors(reps)
    assert out["trace"].phase_totals.count("build") == 1
    with _pin_fused(True):
        for bst in (a, b):
            for _ in range(3):
                bst.update()
    assert a.model_to_string() == b.model_to_string()


def test_trace_doctor_cli(capsys):
    from lightgbm_tpu_torch.cli import main
    assert main(["trace-doctor", "--device", "cpu", "--config", "plain",
                 "--mode", "serial"]) == 0
    assert "trace-doctor:" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="benchmark"):
        main(["perf-gate"])


def test_profiler_phase_asserts_membership_and_tracks_spans():
    """``profiler.phase`` refuses a name outside ``phases.py`` (as the
    JAX package's does), and the stack of open spans, which the recorder
    and the collective record read, unwinds on exit and on error."""
    from lightgbm_tpu_torch.phases import KNOWN_PHASES
    assert "build" in KNOWN_PHASES
    with profiler.phase("build"):
        with profiler.phase("hist_merge"):
            assert profiler.open_phases() == ("build", "hist_merge")
    assert profiler.open_phases() == ()
    with pytest.raises(ValueError, match="phases.py"):
        with profiler.phase("not_a_phase"):
            pass
    with pytest.raises(KeyError):
        with profiler.phase("update"):
            raise KeyError("inside")
    assert profiler.open_phases() == ()


@pytest.mark.parametrize("seed", ["closure-const", "recompile-blowout",
                                  "class-unroll", "nan-guard-sync"])
def test_lint_traces_seed_is_detected(seed):
    mod = _lint_script()
    assert merge_errors(mod._SEEDS[seed]("cpu"))


# ------------------------------------------------------- across packages

def _jax_rules(rep):
    return sorted({f.rule for f in rep.errors})


@pytest.mark.parametrize("rule", ["TD001", "TD002", "TD003", "TD006",
                                  "TD201"])
def test_seeded_hazard_fires_the_same_rule_in_both(rule):
    """The same hazard, seeded in each package's form, fires the same
    rule id in both; both clean forms lint clean."""
    from lightgbm_tpu.analysis import (RecompileGuard, lint_deferred_guard
                                       as jguard, lint_jaxpr)
    x = np.ones(1024, np.float32)
    if rule == "TD001":
        big = np.random.RandomState(0).rand(512, 1024).astype(np.float32)
        jb = lint_jaxpr(jax.make_jaxpr(lambda v: (v[None, :] * big).sum())
                        (x), label="j")
        jg = lint_jaxpr(jax.make_jaxpr(lambda v, b: (v[None, :] * b).sum())
                        (x, big), label="j")
        pb = lint_ops(record(lambda v: (v[None, :] * torch.tensor(big))
                             .sum(), torch.from_numpy(x), device="cpu"),
                      label="p")
        pg = lint_ops(record(lambda v, b: (v[None, :] * b).sum(),
                             torch.from_numpy(x), torch.from_numpy(big),
                             device="cpu"), label="p")
        assert jb.errors[0].nbytes == pb.errors[0].nbytes == big.nbytes
    elif rule == "TD002":
        def jcb(v):
            jax.debug.print("v0={a}", a=v[0])
            return v * 2
        jb = lint_jaxpr(jax.make_jaxpr(jcb)(x), label="j")
        jg = lint_jaxpr(jax.make_jaxpr(lambda v: v * 2)(x), label="j")
        pb = lint_ops(record(lambda v: v * float(v[0]), torch.from_numpy(x),
                             device="cpu"), label="p")
        pg = lint_ops(record(lambda v: v * v[0], torch.from_numpy(x),
                             device="cpu"), label="p")
    elif rule == "TD003":
        with jax.enable_x64(True):
            jb = lint_jaxpr(jax.make_jaxpr(
                lambda v: v.astype(jnp.float64) + 1.0)(x), label="j")
        jg = lint_jaxpr(jax.make_jaxpr(lambda v: v.astype(jnp.bfloat16))
                        (x), label="j")
        pb = lint_ops(record(lambda v: v.double() + 1.0,
                             torch.from_numpy(x), device="cpu"), label="p")
        pg = lint_ops(record(lambda v: v.bfloat16(), torch.from_numpy(x),
                             device="cpu"), label="p")
    elif rule == "TD006":
        def jstep(s, g):
            new = s - 0.1 * g
            _ = jnp.all(jnp.isfinite(new))     # never an output
            return new

        def jclean(s, g):
            new = s - 0.1 * g
            return new, jnp.all(jnp.isfinite(new)), jnp.any(new > 0)
        s2 = np.ones((2, 64), np.float32)
        jb = jguard(jax.make_jaxpr(jstep)(s2, s2), label="j")
        jg = jguard(jax.make_jaxpr(jclean)(s2, s2), label="j")
        pb = _lint_script()._SEEDS["nan-guard-sync"]("cpu")[0]
        t = torch.ones((2, 64))

        def pclean(s, g):
            new = s - 0.1 * g
            return new, torch.isfinite(new).all(), (new > 0).any()
        tr = record(pclean, t, t, device="cpu")
        pg = lint_deferred_guard([((2, 64), torch.float32),
                                  ((1,), torch.bool), ((), torch.bool)],
                                 label="p", trace=tr)
    else:
        f = jax.jit(lambda v: v * 2.0)
        with RecompileGuard(max_compiles=2, label="j", strict=False) as g:
            for n in (8, 16, 24, 32, 40):
                f(jnp.ones(n, jnp.float32)).block_until_ready()
        jb = g.report
        with RecompileGuard(max_compiles=0, label="j", strict=False) as g:
            for _ in range(3):
                f(jnp.ones(8, jnp.float32)).block_until_ready()
        jg = g.report
        pb = _lint_script()._SEEDS["recompile-blowout"]("cpu")[0]
        fake = _FakeGBDT()
        with CaptureGuard(max_captures=0, boosters=[fake],
                          strict=False) as pgd:
            pass
        pg = pgd.report
    assert _jax_rules(jb) == _rules(pb) == [rule]
    assert jg.ok and pg.ok


_TD103_RANK = textwrap.dedent('''
    import json, sys
    import torch
    sys.path.insert(0, sys.argv[1])
    from lightgbm_tpu_torch import profiler
    from lightgbm_tpu_torch.analysis import lint_collectives, record
    from lightgbm_tpu_torch.parallel.distributed import (default_comm,
                                                         init_distributed)
    init_distributed(device_type="cpu")
    comm = default_comm()

    def body(x, phase):
        with profiler.phase("build"):
            if phase:
                with profiler.phase(phase):
                    return comm.all_reduce(x, "sum", phase=phase)
            return comm.all_reduce(x, "sum")
    out = {}
    for name, phase in (("untagged", ""), ("tagged", "hist_merge")):
        tr = record(body, torch.ones(1 << 18), phase, device="cpu",
                    comm=comm)
        rep = lint_collectives(tr.collectives, label=name)
        out[name] = sorted({f.rule for f in rep.errors})
    if comm.rank == 0:
        print("TD103=" + json.dumps(out), flush=True)
''')


def test_td103_same_rule_in_both(tmp_path):
    """An untagged 1 MiB all-reduce inside a build fires TD103 in both
    packages (the JAX one on its 8-device mesh, the port's under a
    2-rank gloo group started by the launcher); the hist_merge-tagged
    one is clean in both."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from lightgbm_tpu.analysis import lint_hlo, lower_hlo
    n = len(jax.devices())
    assert n >= 2
    mesh = Mesh(jax.devices(), ("d",))
    jax_rules = {}
    for name, tag in (("untagged", None), ("tagged", "hist_merge")):
        def body(v, tag=tag):
            if tag is None:
                return jax.lax.psum(v, "d")
            with jax.named_scope(tag):
                return jax.lax.psum(v, "d")
        f = shard_map(body, mesh=mesh, in_specs=P("d"), out_specs=P())
        rep = lint_hlo(lower_hlo(f, jnp.ones((n, 1 << 14), jnp.float32)),
                       label=name)
        jax_rules[name] = _jax_rules(rep)
    script = tmp_path / "rank.py"
    script.write_text(_TD103_RANK)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.launch",
                        "-n", "2", "--cpu", str(script), REPO], env=env,
                       cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("TD103=")]
    port_rules = json.loads(line[-1].split("=", 1)[1])
    assert port_rules == jax_rules == {"untagged": ["TD103"],
                                       "tagged": []}


def test_td007_detector_in_both():
    """TD007's detector over each package's fused-split target: the JAX
    package's fused program (its Pallas kernels in interpret mode)
    stages no lattice and its two-pass negative control does; the
    port's two-pass arm shows the lattice too (its fused arm, B2's
    plain version on the CPU, builds it by design: info). Neither
    report has an error, so both negative controls fired."""
    from lightgbm_tpu.analysis.doctor import doctor_fused_split as jfs
    j = jfs()
    assert not merge_errors(j) and not j[0].findings
    out = {}
    p = PD.doctor_fused_split(device="cpu", out=out)
    assert not merge_errors(p)
    assert PD._lattice_hits(out["two_pass"], 16, 12)


@functools.lru_cache(maxsize=None)
def _jax_canonical(config):
    import lightgbm_tpu.analysis.doctor as JD
    return JD.make_booster(config, "serial")


def _jax_booster(params, X, y, rounds=2):
    import lightgbm_tpu as lgb
    with _pin_fused(True):
        return lgb.train(dict(params, tree_learner="serial"),
                         lgb.Dataset(X, label=y), num_boost_round=rounds)


def test_td005_and_td006_count_alike_in_both():
    """TD005: a class-batched multiclass step enters one build, a
    per-class step K; TD006: the nan_guard step carries two flags. The
    JAX package counts the same in its fused step's jaxpr."""
    from lightgbm_tpu.analysis.doctor import _fused_trace_args
    from lightgbm_tpu.analysis.jaxpr_lint import count_build_loops
    overrides, _ = PD.CANONICAL_CONFIGS["multiclass"]
    X, y = PD._synth("multiclass")
    for cb, want in (("auto", 1), ("off", 3)):
        p = dict(PD._BASE_PARAMS, **overrides, class_batch=cb)
        jb = _jax_booster(p, X, y)
        closed = jax.make_jaxpr(jb._gbdt._fused_step_entry)(
            *_fused_trace_args(jb._gbdt))
        with _pin_fused(True):
            pb = lgt.train(dict(p, device_type="cpu"),
                           lgt.Dataset(X, label=y,
                                       params={"device_type": "cpu"}), 2)
        out = {}
        PD.doctor_fused_step(pb, out=out)
        assert count_build_loops(closed.jaxpr) == want
        assert out["trace"].phase_totals.count("build") == want
    pb = PD.make_booster("nan_guard", device="cpu")
    assert count_deferred_flags(pb._gbdt._layout) == 2
    jg = _jax_canonical("nan_guard")._gbdt
    closed = jax.make_jaxpr(jg._fused_step_entry)(*_fused_trace_args(jg))
    n = sum(1 for v in closed.jaxpr.outvars
            if getattr(v.aval, "shape", None) == ()
            and str(v.aval.dtype) == "bool")
    assert n == 2


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


@pytest.mark.parametrize("config", ["plain", "quantized", "categorical",
                                    "nan_guard", "efb"])
def test_make_booster_matches_jax(config):
    """The port's canonical booster grows the JAX make_booster's trees:
    equal structure, leaf values within rtol 1e-5 (the contract of
    tests/test_torch_train.py)."""
    jt = _jax_canonical(config)._all_trees()
    pt = PD.make_booster(config, device="cpu")._trees
    assert len(jt) == len(pt) == 2
    for a, b in zip(jt, pt):
        assert _tree_key(a) == _tree_key(b)
        assert a.cat_threshold == b.cat_threshold
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-7)
