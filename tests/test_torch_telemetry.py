"""PyTorch port, run telemetry on the CPU, against the JAX package
(mirrors ``tests/test_telemetry.py``):

- fault C8: ``telemetry_port`` (and ``LIGHTGBM_TPU_TELEMETRY_PORT``)
  binds the exporter during ``train`` and shuts it down after;
- the run-event log of one run in both packages: the same event
  sequence, metrics within 1e-6, and each package's ``check_records``
  accepts the other's log; every metric family a JAX scrape shows is in
  the port's scrape;
- telemetry changes nothing it watches: trees bit-identical and host
  syncs equal with and without it, on both training loops;
- the run-log records outside the eval cadence: resume splices the
  log, ``nan_guard=raise`` is the last word, preemption, the
  supervisor's ``degraded``, serving ``swap``/``rollback``, the
  ingest's ``ingest`` and routed warnings;
- a finished run's session holds no booster (fault C10);
- the event log's own contract (append, torn tail, schema check,
  splice), the endpoints, the device gauges, and ``python -m
  lightgbm_tpu_torch monitor`` (report and ``--check``).

Every scrape runs from a callback on the training thread, so no test
waits on a clock.
"""

import http.client
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.telemetry import active_session as jax_active_session
from lightgbm_tpu.telemetry.events import check_records as jax_check
from lightgbm_tpu_torch import log
from lightgbm_tpu_torch.resilience import (DeviceLossError,
                                           NumericDivergenceError,
                                           TrainingPreempted,
                                           supervised_train)
from lightgbm_tpu_torch.telemetry import active_session
from lightgbm_tpu_torch.telemetry.core import MetricsRegistry
from lightgbm_tpu_torch.telemetry.events import (EventLog, check_records,
                                                 read_events, set_active)
from lightgbm_tpu_torch.telemetry.exporter import IntrospectionServer
from lightgbm_tpu_torch.telemetry.monitor import monitor_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rng, n=2000, f=5):
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 7,
          "learning_rate": 0.2, "min_data_in_leaf": 5, "verbosity": -1,
          "eval_period": 2, "is_provide_training_metric": True,
          "output_model": "m.txt"}
CPU = {"device_type": "cpu"}


def _train(rounds=4, extra=None, callbacks=None, mod=lgt, seed=3):
    X, y = _data(np.random.RandomState(seed))
    params = dict(PARAMS, **(extra or {}))
    if mod is lgt:
        params.update(CPU)
    # a no-op after-callback is an eval consumer (needs_eval defaults
    # True), so sync points carry metric values for the event log
    cbs = callbacks if callbacks is not None else [lambda env: None]
    return mod.train(params, mod.Dataset(X, label=y), num_boost_round=rounds,
                     callbacks=cbs)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def _trees(bst):
    # the model text less its parameters block, which names the options
    return bst.model_to_string().split("end of trees")[0]


def _families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


@pytest.mark.parametrize("extra", [{"telemetry_port": 0},
                                   {"event_log": "ev.jsonl"}])
def test_session_releases_the_booster(tmp_path, monkeypatch, extra):
    """The session is a reference cycle (its gauges' callbacks close
    over it). It must not hold the booster: a booster the caller drops
    is freed at once, not by a later run of the cyclic collector, which
    on the card could destroy its CUDA graphs inside another run's
    graph capture (fault C10)."""
    import gc
    import weakref
    monkeypatch.chdir(tmp_path)
    gc.disable()
    try:
        bst = _train(rounds=2, extra=extra)
        gone_b, gone_g = weakref.ref(bst), weakref.ref(bst._gbdt)
        del bst
        assert gone_b() is None and gone_g() is None
    finally:
        gc.enable()


# ----------------------------------------------------------- fault C8
def test_telemetry_port_serves_during_train(tmp_path, monkeypatch):
    """Fault C8: the port accepted telemetry_port and bound nothing.
    Now a scrape from a callback inside train answers on every endpoint,
    and the port is closed after train returns."""
    monkeypatch.chdir(tmp_path)
    seen = {}

    def scrape(env):
        tele = active_session()
        assert tele is not None and tele.server is not None
        seen["port"] = tele.server.port
        seen["metrics"] = _get(tele.server.port, "/metrics")
        seen["health"] = _get(tele.server.port, "/healthz")
        seen["events"] = _get(tele.server.port, "/events")
    bst = _train(extra={"telemetry_port": 0, "eval_period": 1},
                 callbacks=[scrape])
    assert bst.num_trees() == 4
    st, body = seen["metrics"]
    assert st == 200 and "train_iterations_total 4" in body
    st, body = seen["health"]
    assert st == 200 and json.loads(body)["iteration"] == 4
    assert seen["events"][0] == 404          # no event log configured
    assert active_session() is None
    with pytest.raises(OSError):              # server gone after close
        _get(seen["port"], "/metrics")


def test_telemetry_port_env_spelling(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_TELEMETRY_PORT", "0")
    ports = []

    def scrape(env):
        tele = active_session()
        ports.append(tele.server.port)
        assert _get(tele.server.port, "/healthz")[0] == 200
    _train(rounds=2, callbacks=[scrape])
    assert ports and ports[0] > 0
    assert active_session() is None


# -------------------------------------------- one run in both packages
def test_event_log_and_families_match_jax(tmp_path, monkeypatch):
    """The same run in both packages with event_log and telemetry_port:
    the event types and iterations are equal in order, the iteration
    metrics agree within 1e-6, each package's check_records accepts the
    other's log, and every family of the JAX scrape is in the port's.
    The scrape runs at the last sync point, after which no sync arms the
    cost model's record."""
    monkeypatch.chdir(tmp_path)
    texts = {}

    def scraper(mod_session, key):
        def scrape(env):
            if env.iteration == 5:
                texts[key] = _get(mod_session().server.port, "/metrics")[1]
        return scrape
    logs = {}
    for key, mod, sess in (("jax", lgb, jax_active_session),
                           ("port", lgt, active_session)):
        logs[key] = f"{key}.events.jsonl"
        _train(rounds=6, mod=mod,
               extra={"event_log": logs[key], "telemetry_port": 0},
               callbacks=[scraper(sess, key)])
    rj, rp = (read_events(logs[k]) for k in ("jax", "port"))
    assert [(r["event"], r.get("iter")) for r in rp] == \
        [(r["event"], r.get("iter")) for r in rj]
    assert [r["iter"] for r in rp if r["event"] == "iteration"] == [2, 4, 6]
    for a, b in zip(rj, rp):
        if a["event"] == "iteration":
            assert set(a["metrics"]) == set(b["metrics"])
            for k, v in a["metrics"].items():
                assert b["metrics"][k] == pytest.approx(v, abs=1e-6)
            assert b["ms_per_tree"] > 0
    assert check_records(rj) == [] and check_records(rp) == []
    assert jax_check(rp) == []
    h = rp[0]
    assert h["versions"]["lightgbm_tpu_torch"] == lgt.__version__
    assert h["devices"] == ["cpu"] and h["driver"] == "legacy"
    assert rp[-1]["event"] == "train_end" and rp[-1]["trees"] == 6
    missing = _families(texts["jax"]) - _families(texts["port"])
    assert not missing, missing


@pytest.mark.parametrize("fused", [False, True])
def test_telemetry_changes_no_tree_nor_sync(tmp_path, monkeypatch, fused):
    """A telemetry-enabled run (exporter, event log, scrapes) trains the
    bare run's trees with the bare run's host syncs, on the eager loop
    and on the step."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1" if fused else "0")

    def scrape(env):
        tele = active_session()
        _get(tele.server.port, "/metrics")
        _get(tele.server.port, "/events?n=3")
    bare = _train(rounds=5)
    tele = _train(rounds=5, callbacks=[scrape],
                  extra={"telemetry_port": 0, "event_log": "auto"})
    assert bare._gbdt.fused_train_ok == fused
    assert _trees(tele) == _trees(bare)
    assert tele._gbdt.host_sync_count == bare._gbdt.host_sync_count
    recs = read_events("m.txt.events.jsonl")
    assert recs[0]["driver"] == ("fused" if fused else "legacy")
    phases = set().union(*(r["phase_s"] for r in recs
                           if r["event"] == "iteration"))
    assert {"grads", "sampling", "build", "update", "eval"} <= phases


# ------------------------------------------------------ run-log records
def test_resume_splices_event_log(tmp_path, monkeypatch):
    """A faulted run resumed in place splices its log: iterations
    [2,4,6,8] once, one train_end, one fingerprint across the two
    headers, and the fault history kept."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ITER", "3")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ONCE",
                       str(tmp_path / "poison.marker"))
    extra = {"event_log": "run.events.jsonl", "resume": "auto",
             "snapshot_freq": 2, "snapshot_keep": 50, "nan_guard": "raise"}
    with pytest.raises(NumericDivergenceError):
        _train(rounds=8, extra=extra)
    recs = read_events("run.events.jsonl")
    assert recs[-1]["event"] == "nan_guard"   # no train_end after fault
    _train(rounds=8, extra=extra)
    recs = read_events("run.events.jsonl")
    assert check_records(recs) == [] and jax_check(recs) == []
    headers = [r for r in recs if r["event"] == "run_header"]
    assert len(headers) == 2
    assert len({h["fingerprint"] for h in headers}) == 1
    assert [r["iter"] for r in recs if r["event"] == "iteration"] == \
        [2, 4, 6, 8]
    assert sum(1 for r in recs if r["event"] == "train_end") == 1
    assert any(r["event"] == "resume" for r in recs)
    assert any(r["event"] == "nan_guard" for r in recs)
    assert any(r["event"] == "checkpoint" and r["action"] == "write"
               for r in recs)
    assert recs[-1]["event"] == "train_end" and recs[-1]["iter"] == 8
    assert active_session() is None


def test_reshard_record_after_a_jax_checkpoint(tmp_path, monkeypatch):
    """A JAX run (on the suite's 8 virtual devices) checkpoints and logs;
    the port resumes its checkpoint on one device and splices its log:
    one chain of iterations, the resume and the topology move recorded,
    and both packages' check_records accept the spliced log."""
    monkeypatch.chdir(tmp_path)
    extra = {"resume": "auto", "snapshot_freq": 2, "snapshot_keep": 50,
             "event_log": "run.events.jsonl"}
    _train(rounds=6, mod=lgb, extra=dict(extra, tree_learner="serial"))
    os.unlink("m.txt.ckpt_iter_6")        # the JAX run is cut back to 4
    bst = _train(rounds=6, extra=extra)
    assert bst.current_iteration() == 6
    recs = read_events("run.events.jsonl")
    assert check_records(recs) == [] and jax_check(recs) == []
    assert [r["iter"] for r in recs if r["event"] == "iteration"] == \
        [2, 4, 6]
    heads = [i for i, r in enumerate(recs) if r["event"] == "run_header"]
    assert [recs[i]["versions"].get("lightgbm_tpu_torch") is not None
            for i in heads] == [False, True]
    i = heads[1]
    assert [r["event"] for r in recs[i:i + 3]] == ["run_header", "resume",
                                                  "reshard"]
    move = recs[i + 2]
    assert move["iter"] == 4 and move["from"]["num_devices"] == 8
    assert move["to"]["num_devices"] == 1


def test_nan_guard_raise_last_record(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ITER", "3")
    with pytest.raises(NumericDivergenceError):
        _train(rounds=6, extra={"event_log": "run.events.jsonl",
                                "nan_guard": "raise"})
    recs = read_events("run.events.jsonl")
    assert recs[-1]["event"] == "nan_guard"
    assert recs[-1]["policy"] == "raise" and recs[-1]["action"] == "raise"
    assert not any(r["event"] == "train_end" for r in recs)
    assert active_session() is None


def test_preemption_record(tmp_path, monkeypatch):
    """SIGTERM after iteration 3 under resume: the final checkpoint's
    write record, then the preemption record, ends the log."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_KILL_ITER", "3")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_KILL_SIGNAL", "TERM")
    with pytest.raises(TrainingPreempted):
        _train(rounds=6, extra={"event_log": "run.events.jsonl",
                                "resume": "auto"})
    recs = read_events("run.events.jsonl")
    assert [(r["event"], r.get("action"), r["iter"]) for r in recs[-2:]] \
        == [("checkpoint", "write", 3), ("preemption", None, 3)]
    assert check_records(recs) == []


def test_degraded_records(tmp_path):
    """The supervisor appends a degraded record at each transition: a
    retry, then a give-up once the retries are spent."""
    path = str(tmp_path / "run.events.jsonl")
    params = {"event_log": path, "resume": "auto"}

    def lost(params, train_set, rounds, **kw):
        raise DeviceLossError(4, "injected")
    with pytest.raises(DeviceLossError):
        supervised_train(lost, params, None, 5, max_retries=1,
                         sleep=lambda s: None)
    recs = read_events(path)
    assert [(r["event"], r["action"], r["attempt"], r["iter"])
            for r in recs] == [("degraded", "retry", 1, 4),
                               ("degraded", "give_up", 2, 4)]


def test_serving_ingest_and_warning_records(tmp_path):
    """With a run log active: serving swap/rollback, the ingest's
    completion and warnings land in it; fatal too; nothing without one."""
    from lightgbm_tpu_torch.data.ingest import ingest
    from lightgbm_tpu_torch.serving.registry import ModelRegistry
    X, y = _data(np.random.RandomState(0), n=400)
    bst = lgt.train(dict(PARAMS, **CPU), lgt.Dataset(X, label=y), 2)
    files = []
    for i in (1, 2):
        files.append(str(tmp_path / f"m{i}.txt"))
        bst.save_model(files[-1], num_iteration=i)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    path = str(tmp_path / "r.events.jsonl")
    ev = EventLog(path)
    try:
        set_active(ev)
        reg = ModelRegistry(warmup_rows=8, device_type="cpu")
        reg.register("m", files[0])
        reg.swap("m", files[1])
        reg.rollback("m")
        ingest(str(tmp_path / "X.npy"), str(tmp_path / "sh"),
               params=CPU, label=str(tmp_path / "y.npy"), verbose=False)
        log.warning("something odd")
        with pytest.raises(RuntimeError):
            log.fatal("boom")
    finally:
        set_active(None)
    log.warning("not recorded")               # no active run: a no-op
    recs = read_events(path)
    assert [(r["event"], r.get("action") or r.get("level"))
            for r in recs] == [("serving", "swap"), ("serving", "rollback"),
                               ("ingest", "complete"), ("log", "warning"),
                               ("log", "fatal")]
    assert recs[0]["version"] == 2 and recs[1]["version"] == 1
    assert recs[2]["rows"] == 400 and recs[2]["shards"] == 1
    assert "something odd" in recs[3]["msg"]


# ------------------------------------------------------------ event log
def test_event_log_append_read_tail_check(tmp_path):
    p = str(tmp_path / "r.events.jsonl")
    ev = EventLog(p)
    ev.append("run_header", fingerprint="abc", driver="fused",
              versions={})
    for i in (2, 4):
        ev.append("iteration", iter=i, ms_per_tree=1.0, metrics={},
                  phase_s={})
    ev.append("train_end", iter=4, trees=4, wall_s=0.1)
    recs = read_events(p)
    assert [r["seq"] for r in recs] == [0, 1, 2, 3]
    assert check_records(recs) == []
    assert [r["iter"] for r in ev.tail(2)] == [4, 4]
    assert EventLog(p).append("log", level="warning", msg="x")["seq"] == 4
    with pytest.raises(ValueError):
        ev.append("wat")


def test_event_log_torn_tail_and_corruption(tmp_path):
    p = str(tmp_path / "r.events.jsonl")
    ev = EventLog(p)
    ev.append("run_header", fingerprint="abc", driver="f", versions={})
    ev.append("iteration", iter=2, ms_per_tree=1.0, metrics={},
              phase_s={})
    with open(p, "a") as f:
        f.write('{"event": "iteration", "it')     # SIGKILL mid-write
    assert len(read_events(p)) == 2               # torn FINAL line skipped
    with open(p, "a") as f:                       # interior damage raises
        f.write('\n{"event": "train_end", "ts": 0, "seq": 9, '
                '"iter": 2, "trees": 2, "wall_s": 0.1}\n')
    with pytest.raises(ValueError):
        read_events(p)


@pytest.mark.parametrize("case, needle", [
    ("no_header", "run_header"), ("seq", "seq"), ("unknown", "wat")])
def test_check_records_flags_schema_violations(case, needle):
    base = {"ts": 0.0}
    head = dict(base, event="run_header", seq=0, fingerprint="a",
                driver="f", versions={})
    it = dict(base, event="iteration", seq=0, iter=2, ms_per_tree=1.0,
              metrics={}, phase_s={})
    recs = {"no_header": [it], "seq": [head, it],
            "unknown": [head, dict(base, event="wat", seq=1)]}[case]
    assert any(needle in e for e in check_records(recs))
    assert check_records(recs) == jax_check(recs)


def test_event_log_splice(tmp_path):
    p = str(tmp_path / "r.events.jsonl")
    ev = EventLog(p)
    ev.append("run_header", fingerprint="abc", driver="f", versions={})
    ev.append("iteration", iter=2, ms_per_tree=1.0, metrics={},
              phase_s={})
    ev.append("checkpoint", action="write", iter=2, path="c2")
    ev.append("nan_guard", iter=3, policy="rollback", action="rollback")
    ev.append("iteration", iter=4, ms_per_tree=1.0, metrics={},
              phase_s={})
    ev.append("checkpoint", action="write", iter=4, path="c4")
    ev.append("train_end", iter=4, trees=4, wall_s=0.1)
    assert ev.splice_to_iteration(2) == 3
    assert [(r["event"], r.get("iter")) for r in read_events(p)] == [
        ("run_header", None), ("iteration", 2), ("checkpoint", 2),
        ("nan_guard", 3)]


# ------------------------------------------------- endpoints and gauges
def test_introspection_server_endpoints(tmp_path):
    reg = MetricsRegistry()
    reg.counter("t_ops_total", "ops").inc(7)
    ev = EventLog(str(tmp_path / "r.events.jsonl"))
    ev.append("run_header", fingerprint="abc", driver="f", versions={})
    ev.append("iteration", iter=2, ms_per_tree=1.0, metrics={},
              phase_s={})
    srv = IntrospectionServer(reg, event_log=ev,
                              health_fn=lambda: {"iteration": 2})
    port = srv.start()
    try:
        st, body = _get(port, "/metrics")
        assert st == 200 and "t_ops_total 7" in body
        st, body = _get(port, "/healthz")
        assert st == 200 and json.loads(body) == {
            "status": "ok", "capturing": False, "iteration": 2}
        st, body = _get(port, "/events?n=1")
        assert st == 200 and json.loads(body.strip())["event"] == \
            "iteration"
        assert _get(port, "/nope")[0] == 404
    finally:
        srv.stop()


def test_device_gauges_on_the_cpu():
    """The CPU has no allocator statistics: no memory sample, the
    families still registered; no capture, no collective bytes."""
    from lightgbm_tpu_torch.telemetry.device import (CollectiveWatch,
                                                     DeviceWatch,
                                                     device_memory_bytes)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    assert device_memory_bytes() == {}
    reg = MetricsRegistry()
    watch = DeviceWatch(reg)
    CollectiveWatch(reg, trees_fn=lambda: 3)
    watch.attach(type("Gb", (), {"capture_count": 2,
                                 "capture_seconds": 1.5})())
    assert watch.sample() == {}
    text = reg.render()
    assert "xla_compiles_total 0" in text
    assert "train_collective_hist_bytes_total 0" in text
    assert {"device_hbm_bytes_in_use", "device_hbm_bytes_peak"} <= \
        _families(text)


# ---------------------------------------------------------- monitor CLI
def test_monitor_cli_report_and_check(tmp_path, monkeypatch):
    """A real run's log through ``python -m lightgbm_tpu_torch
    monitor``: the report, then --check; a schema violation fails it."""
    monkeypatch.chdir(tmp_path)
    _train(rounds=4, extra={"event_log": "run.events.jsonl"})

    def monitor(*args):
        return subprocess.run(
            [sys.executable, "-m", "lightgbm_tpu_torch", "monitor", *args],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
    r = monitor(str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "driver=legacy" in r.stdout
    assert "lightgbm_tpu_torch" in r.stdout
    assert "progress: 4 iterations over 2 eval points" in r.stdout
    assert "ended: iteration 4, 4 trees" in r.stdout
    p = str(tmp_path / "run.events.jsonl")
    r = monitor("--check", p)
    assert r.returncode == 0 and "OK (4 records)" in r.stdout
    with open(p, "a") as f:
        f.write(json.dumps({"event": "wat", "ts": 0.0, "seq": 99}) + "\n")
    assert monitor_main(["--check", p]) == 1
    assert monitor_main([str(tmp_path / "missing")]) == 1
