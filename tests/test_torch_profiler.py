"""PyTorch port, the profiler and the pure half of the performance
observability on the CPU (mirrors the pure part of
``tests/test_perf_observability.py``):

- ``profiler.phase``: canonical names only, totals from two threads,
  ranges from another thread in a capture;
- ``summarize_trace`` over a synthetic Chrome trace: device ms per
  kernel, the busy union, phases through launch correlation (innermost
  range, per thread, graph replays and orphans in ``unknown``);
- the ``/trace`` capture: retention, start and stop failures (500,
  nothing left behind), a CUDA capture with no device activity (500),
  a real capture on the CPU through the endpoint;
- ``monitor --perf`` over a saved summary; the perf gate's tolerance
  semantics and baseline round trip; the cost model's arithmetic;
- the tables copied from the JAX package equal the JAX package's.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu import phases as jax_phases
from lightgbm_tpu.telemetry import costmodel as jax_costmodel
from lightgbm_tpu.telemetry import events as jax_events
from lightgbm_tpu.telemetry import perf as jax_perf
from lightgbm_tpu_torch import phases, profiler
from lightgbm_tpu_torch.telemetry import costmodel, events, perf
from lightgbm_tpu_torch.telemetry.core import MetricsRegistry
from lightgbm_tpu_torch.telemetry.exporter import (SUMMARY_FILE, UNKNOWN,
                                                   CaptureError,
                                                   IntrospectionServer,
                                                   summarize_trace)
from lightgbm_tpu_torch.telemetry.monitor import (find_captures,
                                                  monitor_main, render_perf)


# ----------------------------------------------------------------------
# profiler.phase and PhaseTotals

def test_phase_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown profiler phase"):
        with profiler.phase("histogram"):
            pass


def test_phase_totals_two_threads():
    """+= on the accumulator is a read-modify-write; without the lock
    two recording threads silently lose spans."""
    col = profiler.PhaseTotals()
    n, dt = 20_000, 0.001

    def hammer():
        for _ in range(n):
            col._record("build", dt)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert col.count("build") == 2 * n
    assert col.total_s("build") == pytest.approx(2 * n * dt)
    per = col.per_iteration(4)["build"]
    assert per["spans_per_iter"] == n / 2


def test_phase_spans_from_two_threads():
    """The real phase() entry point records into stacked collectors from
    concurrent threads without dropping spans."""
    with profiler.collect_phase_totals() as outer:
        with profiler.collect_phase_totals() as col:
            def work():
                for _ in range(50):
                    with profiler.phase("build"):
                        pass

            threads = [threading.Thread(target=work) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    assert col.count("build") == 100 and outer.count("build") == 100
    assert "build" in col.render(2)


def test_capture_sees_another_threads_ranges(tmp_path):
    """A capture started on one thread (the exporter's) records the phase
    ranges another thread (the training loop) opens while it runs."""
    prof = profiler.start_profile(cuda=False)
    try:
        def work():
            for name in ("grads", "build", "build", "update"):
                with profiler.phase(name):
                    torch.ones(8).sum()
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        path = profiler.stop_profile(prof, str(tmp_path))
    s = summarize_trace(path)
    assert s["host_phase_ranges"] == {"build": 2, "grads": 1, "update": 1}
    assert s["cuda_launches"] == 0 and s["kernels"] == {}


# ----------------------------------------------------------------------
# summarize_trace over a synthetic kineto trace (times in us)

def _x(cat, name, ts, dur, pid, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _synthetic_trace(path):
    A, B, dev = 10, 20, 7
    ev = [
        _x("user_annotation", "boost_iter#0", 0, 399, 1, A),
        _x("user_annotation", "boost_iter#1", 400, 600, 1, A),
        _x("user_annotation", "build", 100, 100, 1, A),
        _x("user_annotation", "update", 250, 50, 1, A),
        _x("user_annotation", "eval", 400, 200, 1, A),
        _x("user_annotation", "sampling", 450, 30, 1, A),   # inside eval
        _x("user_annotation", "build", 0, 1000, 1, B),      # other thread
        _x("user_annotation", "not_a_phase", 340, 20, 1, A),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 2, 1, A, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 260, 2, 1, A, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 460, 2, 1, A, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 500, 2, 1, A, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 350, 2, 1, A, 5),
        _x("cuda_runtime", "cudaGraphLaunch", 700, 5, 1, A, 6),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 2, 1, B, 7),
        _x("kernel", "kA", 120, 30, 0, dev, 1),
        _x("kernel", "kB", 270, 10, 0, dev, 2),
        _x("kernel", "kA", 470, 20, 0, dev, 3),
        _x("kernel", "kC", 505, 40, 0, dev, 4),
        _x("kernel", "kB", 360, 5, 0, dev, 5),
        _x("kernel", "kG1", 710, 20, 0, dev, 6),          # graph replay
        _x("kernel", "kG2", 725, 20, 0, dev + 1, 6),      # overlaps kG1
        _x("kernel", "kA", 60, 10, 0, dev, 7),
        _x("gpu_memcpy", "Memcpy HtoD", 800, 50, 0, dev, 8),
        _x("kernel", "kX", 900, 1, 0, dev, 99),           # no launch
        {"ph": "s", "cat": "ac2g", "id": 1, "ts": 110, "pid": 1, "tid": A},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "deviceProperties": []}, f)
    return path


def test_summarize_trace_attribution(tmp_path):
    s = summarize_trace(_synthetic_trace(str(tmp_path / "t.json")),
                        window_ms=1.0)
    ms = {k: v["ms"] for k, v in s["kernels"].items()}
    assert ms == pytest.approx({"kA": 0.06, "kB": 0.015, "kC": 0.04,
                                "kG1": 0.02, "kG2": 0.02, "kX": 0.001})
    assert s["kernels"]["kA"]["n"] == 3
    assert list(s["kernels"])[0] == "kA"           # by device ms
    # build: kA from thread A's range and thread B's own launch; the
    # inner sampling range wins over eval; after it ends, eval again
    assert s["phase_device_ms"] == pytest.approx(
        {"build": 0.04, "update": 0.01, "sampling": 0.02, "eval": 0.04,
         UNKNOWN: 0.046})
    # the union: kG1/kG2 overlap (35 us, not 40); the memcpy is busy
    assert s["device_busy_ms"] == pytest.approx(0.201)
    assert s["device_busy_share"] == pytest.approx(0.201)
    assert s["steps"] == 2
    assert s["host_phase_ranges"] == {"build": 2, "eval": 1,
                                      "sampling": 1, "update": 1}
    assert (s["cuda_launches"], s["graph_launches"], s["graph_kernels"],
            s["device_events"]) == (7, 1, 2, 10)


def test_summarize_trace_default_window(tmp_path):
    s = summarize_trace(_synthetic_trace(str(tmp_path / "t.json")))
    assert s["window_ms"] == pytest.approx(1.0)      # 0 .. 1000 us


# ----------------------------------------------------------------------
# exporter: capture retention, failures, the endpoint

def _fake_profiler(monkeypatch, trace_events=(), stop_error=None,
                   start_error=None, on_stop=lambda: None):
    def start(cuda=None):
        if start_error is not None:
            raise start_error
        return "prof"

    def stop(prof, log_dir):
        on_stop()
        if stop_error is not None:
            raise stop_error
        path = os.path.join(log_dir, profiler.TRACE_FILE)
        with open(path, "w") as f:
            json.dump({"traceEvents": list(trace_events)}, f)
        return path
    monkeypatch.setattr(profiler, "start_profile", start)
    monkeypatch.setattr(profiler, "stop_profile", stop)


def test_capture_retention(tmp_path, monkeypatch):
    srv = IntrospectionServer(MetricsRegistry(), capture_root=str(tmp_path),
                              keep_captures=2)
    seen = []
    _fake_profiler(monkeypatch, on_stop=lambda: seen.append(srv.capturing))
    for _ in range(4):
        resp = srv.capture_trace(duration_ms=1)
        assert os.path.isfile(os.path.join(resp["log_dir"], SUMMARY_FILE))
    assert sorted(os.listdir(tmp_path)) == ["capture_0003", "capture_0004"]
    # the window is open until the profiler stops, closed after
    assert seen == [True] * 4 and not srv.capturing


@pytest.mark.parametrize("where", ["start", "stop"])
def test_capture_failure_cleans_up(tmp_path, monkeypatch, where):
    err = RuntimeError("profiler exploded")
    _fake_profiler(monkeypatch, **{f"{where}_error": err})
    srv = IntrospectionServer(MetricsRegistry(), capture_root=str(tmp_path))
    with pytest.raises(CaptureError, match="profiler exploded"):
        srv.capture_trace(duration_ms=1)
    assert os.listdir(tmp_path) == []       # no dangling capture dir
    assert not srv.capturing
    _fake_profiler(monkeypatch)             # the lock was released
    assert "log_dir" in srv.capture_trace(duration_ms=1)


def test_cuda_capture_without_device_activity_fails(tmp_path, monkeypatch):
    """Launches recorded and no kernel: CUPTI did not trace, so the
    capture is an error, never a CPU-only trace under a 200."""
    _fake_profiler(monkeypatch, trace_events=[
        _x("cuda_runtime", "cudaGraphLaunch", 10, 5, 1, 1, 3)])
    srv = IntrospectionServer(MetricsRegistry(), capture_root=str(tmp_path))
    port = srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/trace?duration_ms=1", timeout=10)
        assert exc.value.code == 500
        assert "no device activity" in json.load(exc.value)["error"]
        assert os.listdir(tmp_path) == []
        srv._trace_lock.acquire()           # a capture already running
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/trace?duration_ms=1",
                    timeout=10)
            assert exc.value.code == 409
        finally:
            srv._trace_lock.release()
    finally:
        srv.stop()


def test_trace_endpoint_real_capture(tmp_path):
    """A real torch.profiler capture through the endpoint on the CPU:
    200, the summary in the body and beside the trace."""
    srv = IntrospectionServer(MetricsRegistry(), capture_root=str(tmp_path))
    port = srv.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/trace?duration_ms=1",
                timeout=60) as r:
            body = json.load(r)
    finally:
        srv.stop()
    assert body["duration_ms"] == 1 and body["window_ms"] > 0
    assert body["kernels"] == {} and body["device_busy_ms"] == 0.0
    assert body["profiler_start_ms"] >= 0 and body["profiler_stop_ms"] >= 0
    cap = body["log_dir"]
    assert os.path.isfile(os.path.join(cap, profiler.TRACE_FILE))
    with open(os.path.join(cap, SUMMARY_FILE)) as f:
        assert json.load(f)["window_ms"] == body["window_ms"]


# ----------------------------------------------------------------------
# monitor --perf

def _fake_run_dir(tmp_path):
    cap = tmp_path / "traces" / "capture_0001"
    cap.mkdir(parents=True)
    summarize = summarize_trace(_synthetic_trace(str(cap / "trace.json")),
                                window_ms=1.0)
    (cap / SUMMARY_FILE).write_text(json.dumps(summarize))
    recs = [
        {"event": "run_header", "ts": 1.0, "seq": 0, "fingerprint": "f",
         "driver": "fused", "versions": {}},
        {"event": "iteration", "ts": 2.0, "seq": 1, "iter": 2,
         "ms_per_tree": 1.0, "metrics": {}, "phase_s": {}},
    ]
    (tmp_path / "run.events.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    return tmp_path


def test_find_captures(tmp_path):
    assert find_captures(str(tmp_path)) == []
    run = _fake_run_dir(tmp_path)
    caps = find_captures(str(run))
    assert len(caps) == 1 and caps[0].endswith("capture_0001")
    assert find_captures(caps[0]) == [caps[0]]


def test_render_perf_compares_against_event_log(tmp_path):
    run = _fake_run_dir(tmp_path)
    cap = find_captures(str(run))[0]
    recs = [json.loads(ln) for ln in
            (run / "run.events.jsonl").read_text().splitlines()]
    out = render_perf(cap, recs)
    # 0.156 ms of kernels over the capture's 2 iterations vs 1.0 ms/tree
    assert "device 0.08 ms/iter vs event-log ms/tree mean 1.00" in out
    assert "ratio 0.078" in out
    assert "share 0.201" in out and "kA" in out


def test_monitor_perf_cli(tmp_path, capsys):
    run = _fake_run_dir(tmp_path)
    assert monitor_main(["--perf", str(run)]) == 0
    out = capsys.readouterr().out
    assert "capture_0001" in out and "device ms by phase" in out
    bare = tmp_path / "empty"
    bare.mkdir()
    assert monitor_main(["--perf", str(bare)]) == 1


# ----------------------------------------------------------------------
# perf gate: tolerance semantics + baseline round trip

def test_tolerance_kinds():
    t = perf.Tolerance("time", 1.5)
    assert t.check(1.4, 1.0)[0] and not t.check(1.6, 1.0)[0]
    assert t.check(0.1, 1.0)[0]  # faster never regresses
    t = perf.Tolerance("throughput", 1.5)
    assert t.check(0.7, 1.0)[0] and not t.check(0.6, 1.0)[0]
    assert t.check(99.0, 1.0)[0]
    t = perf.Tolerance("static", 2.0)
    assert t.check(1.9, 1.0)[0] and t.check(0.51, 1.0)[0]
    assert not t.check(2.1, 1.0)[0] and not t.check(0.4, 1.0)[0]
    assert perf.Tolerance("static", 1.5).check(0.0, 0.0)[0]
    with pytest.raises(ValueError):
        perf.Tolerance("speed", 1.5)
    with pytest.raises(ValueError):
        perf.Tolerance("time", 0.5)


def test_compare_matches_jax():
    base = {"ms_per_tree": 10.0, "cost_fused_step_flops": 1000.0,
            "gone": 5.0, "timing_skipped": 3.0}
    cur = {"ms_per_tree": 11.0, "cost_fused_step_flops": 2000.0,
           "fresh": 1.0}
    res = perf.compare(cur, base, skipped=["timing_skipped"])
    by = {c.metric: c.status for c in res.checks}
    assert by == {"ms_per_tree": "pass", "cost_fused_step_flops": "fail",
                  "gone": "missing", "timing_skipped": "skip",
                  "fresh": "new"}
    assert not res.ok and set(res.failed) == {"cost_fused_step_flops",
                                              "gone"}
    assert "FAIL" in res.render()
    want = jax_perf.compare(cur, base, skipped=["timing_skipped"])
    assert [(c.metric, c.status, c.detail) for c in res.checks] == \
        [(c.metric, c.status, c.detail) for c in want.checks]
    assert perf.compare({"a": 1.0}, {"a": 1.0}).ok


def test_baseline_round_trip(tmp_path):
    path = str(tmp_path / "PERF_BASELINE.json")
    metrics = {"ms_per_tree": 12.5, "cost_fused_step_n_ops": 357.0}
    perf.save_baseline(path, metrics, meta={"note": "test"})
    obj = perf.load_baseline(path)
    assert obj["metrics"] == metrics and obj["meta"]["note"] == "test"
    assert obj["host"]["cpu_count"] == os.cpu_count()
    assert obj["host"]["torch"] == torch.__version__
    assert perf.compare(metrics, obj["metrics"]).ok
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"not_metrics": 1}))
    with pytest.raises(ValueError):
        perf.load_baseline(str(bad))


# ----------------------------------------------------------------------
# cost model

def test_costmodel_arithmetic_and_cpu_report():
    for R, F, B, L in ((4096, 8, 16, 7), (10_500_000, 28, 63, 42)):
        assert costmodel.analytical_hist_counts(R, F, B, L) == \
            jax_costmodel.analytical_hist_counts(R, F, B, L)
        assert costmodel.analytical_build_split_counts(
            R, F, B, L, fused=False) == \
            jax_costmodel.analytical_build_split_counts(R, F, B, L,
                                                        fused=False)
        two = costmodel.analytical_build_split_counts(R, F, B, L,
                                                      fused=False)
        one = costmodel.analytical_build_split_counts(R, F, B, L,
                                                      fused=True)
        assert one[0] == two[0] and one[1] < two[1]
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    assert costmodel.chip_peaks() is None
    f = costmodel.kernel_roofline_fields("cpu", 1e-3, 4096, 8, 16, 7)
    assert set(f) == {"hist_tflops", "hist_hbm_gbps"}
    X = torch.randn(300, 4).numpy()
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 4, "device_type": "cpu",
         "verbosity": -1}
    bst = lgt.train(p, lgt.Dataset(X, label=y, params=p), 2)
    assert costmodel.step_cost_report(bst._gbdt) is None   # no graph


def test_copied_tables_equal_jax():
    assert phases.KNOWN_PHASES == jax_phases.KNOWN_PHASES
    assert events.EVENT_TYPES == jax_events.EVENT_TYPES
    assert {k: (t.kind, t.ratio)
            for k, t in perf.DEFAULT_TOLERANCES.items()} == \
        {k: (t.kind, t.ratio)
         for k, t in jax_perf.DEFAULT_TOLERANCES.items()}
