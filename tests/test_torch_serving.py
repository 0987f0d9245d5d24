"""PyTorch port, the serving layer on the CPU (``device_type="cpu"``):
the cases of ``tests/test_serving.py`` (less its two CLI tests; the
port has no CLI yet) and ``tests/test_replica_fleet.py`` — micro-batch
coalescing, deadline flush, the bucket ladder, admission control,
registry hot-swap/rollback with whole-model results under concurrent
load, the PredictSession snapshot under version movement, the HTTP
front end (npy bit-equal and JSON exactly equal after the repr round
trip, against the port's own ``PredictSession``), graceful drain,
replica routing and QPS budgets — plus the default device, which
raises where torch sees no GPU.

Where a test needs the batcher to hold a request, it waits on an event
that the model stub sets once the worker is inside the model, never on
a sleep; the only wall-clock waits are the submit timeouts under test
and the token bucket's refill.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.serving import (BudgetExceeded, MicroBatcher,
                                        ModelRegistry, Overloaded,
                                        PredictionServer, QpsBudget,
                                        ReplicaSet, ServingMetrics,
                                        bucket_rows)

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}


def _train(rng, n=1200, f=6, iters=8, shift=0.0):
    X = np.round(rng.normal(size=(n, f)) * 8) / 8.0
    y = (X[:, 0] + 0.5 * X[:, 1] + shift * X[:, 2] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1, **CPU}
    return X, lgt.train(p, lgt.Dataset(X, label=y, params=p), iters)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two model versions (the second trained on a shifted label) as
    files, and the first's booster."""
    td = tmp_path_factory.mktemp("serving")
    rng = np.random.RandomState(0)
    X, b1 = _train(rng)
    _, b2 = _train(rng, shift=2.0)
    f1, f2 = str(td / "v1.txt"), str(td / "v2.txt")
    b1.save_model(f1)
    b2.save_model(f2)
    return X, b1, f1, f2


def _session(path, **kw):
    return lgt.Booster(model_file=path, params=CPU).predict_session(**kw)


def _wait(cond, what, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


class _Gate:
    """A predict stub's gate: ``entered`` is set once the batcher worker
    holds a batch inside the model; the batch finishes on ``open()``."""

    def __init__(self, fn):
        self.fn = fn
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, X, *a):
        self.entered.set()
        self.release.wait(10)
        return self.fn(X, *a)

    def open(self):
        self.release.set()


# ---------------------------------------------------------------- ladder
def test_bucket_ladder():
    assert bucket_rows(1, 16, 1024) == 16
    assert bucket_rows(16, 16, 1024) == 16
    assert bucket_rows(17, 16, 1024) == 32
    assert bucket_rows(1000, 16, 1024) == 1024
    # an oversized single request still lands on a power of two
    assert bucket_rows(1500, 16, 1024) == 2048
    ladder = {bucket_rows(n, 16, 1024) for n in range(1, 1025)}
    assert ladder == {16, 32, 64, 128, 256, 512, 1024}


# ------------------------------------------------------- batcher behavior
def test_coalescing_scatter_and_shape_bound():
    """Concurrent submits coalesce into fewer model calls; every request
    gets exactly its own rows back; every call's shape sits on the
    bucket ladder."""
    seen_shapes = []
    gate = _Gate(lambda X: (torch.from_numpy(X).sum(dim=1) * 2.0).numpy())

    def predict_fn(X):
        seen_shapes.append(X.shape)
        return gate(X)

    m = ServingMetrics()
    b = MicroBatcher(predict_fn, max_batch_rows=256, max_wait_us=30_000,
                     min_bucket=16, metrics=m)
    rng = np.random.RandomState(0)
    results, done = {}, threading.Event()
    # hold the worker in the model so the other 47 requests queue up
    # behind the first and must coalesce
    Xs = [rng.normal(size=(1 + i % 7, 4)) for i in range(48)]

    def on_done(i):
        def cb(res, err, tag):
            results[i] = (res, err)
            if len(results) == len(Xs):
                done.set()
        return cb

    b.submit_async(Xs[0], on_done(0))
    assert gate.entered.wait(10)
    for i in range(1, len(Xs)):
        b.submit_async(Xs[i], on_done(i))
    gate.open()
    assert done.wait(30)
    b.close()
    for i, X in enumerate(Xs):
        res, err = results[i]
        assert err is None
        np.testing.assert_allclose(res, X.sum(axis=1) * 2.0, rtol=1e-12)
    assert m.batches_total.value < 48
    assert m.mean_batch_rows() > 1.0
    assert m.rows_total.value == sum(len(x) for x in Xs)
    assert {s[0] for s in seen_shapes} <= {16, 32, 64, 128, 256}


def test_deadline_flush_single_request():
    """A lone request must not wait past ~max_wait_us for company."""
    b = MicroBatcher(lambda X: X[:, 0], max_batch_rows=4096,
                     max_wait_us=20_000)
    t0 = time.monotonic()
    out = b.submit(np.ones((3, 2)), timeout=10)
    dt = time.monotonic() - t0
    b.close()
    np.testing.assert_array_equal(out, [1.0, 1.0, 1.0])
    assert dt < 5.0, f"deadline flush did not fire ({dt:.3f}s)"


def test_overload_fast_fail():
    """A full queue rejects immediately with a retriable Overloaded
    instead of queuing unbounded latency; draining recovers."""
    gate = _Gate(lambda X: X[:, 0])
    m = ServingMetrics()
    b = MicroBatcher(gate, max_batch_rows=4, max_wait_us=0,
                     max_queue_rows=8, metrics=m)
    outs, all_done = [], threading.Event()

    def cb(res, err, tag):
        outs.append((res, err))
        if len(outs) == 3:
            all_done.set()

    b.submit_async(np.ones((4, 2)), cb)     # the worker takes this one
    assert gate.entered.wait(10)
    b.submit_async(np.ones((4, 2)), cb)     # queued: 4 of 8 rows
    b.submit_async(np.ones((4, 2)), cb)     # queued: 8 of 8 rows
    t0 = time.monotonic()
    with pytest.raises(Overloaded) as e:
        b.submit(np.ones((4, 2)))
    assert e.value.retriable
    assert time.monotonic() - t0 < 1.0, "overload must fail FAST"
    gate.open()
    assert all_done.wait(30)
    b.close()
    assert m.overload_total.value == 1
    for res, err in outs:
        assert err is None
        np.testing.assert_array_equal(res, np.ones(4))


def test_timeout_unregisters_abandoned_request():
    """A timed-out submit must unregister its promise: rows of a
    still-queued request stop counting against admission control, an
    in-flight request's result slot is never filled for a caller that
    left, and the batcher keeps serving afterwards."""
    gate = _Gate(lambda X: X[:, 0])
    b = MicroBatcher(gate, max_batch_rows=4, max_wait_us=0,
                     max_queue_rows=8)
    # in-flight abandonment: the worker takes this batch and blocks in
    # the model; the caller gives up waiting
    with pytest.raises(TimeoutError):
        b.submit(np.ones((4, 2)), timeout=0.5)
    assert gate.entered.is_set()
    # queued abandonment: the worker is still blocked, so this request
    # never leaves the queue before its deadline
    with pytest.raises(TimeoutError):
        b.submit(np.ones((4, 2)), timeout=0.2)
    with b._cond:
        assert b._queue == []
        assert b._queued_rows == 0, \
            "abandoned rows still count against admission control"
    gate.open()
    # the freed capacity is usable again — this would Overload (8-row
    # cap) if the two abandoned 4-row requests still counted
    out = b.submit(np.ones((8, 2)), timeout=30)
    np.testing.assert_array_equal(out, np.ones(8))
    b.close()


def test_batch_error_propagates_to_every_request():
    def boom(X):
        raise ValueError("model exploded")

    m = ServingMetrics()
    b = MicroBatcher(boom, max_wait_us=0, metrics=m)
    with pytest.raises(ValueError, match="model exploded"):
        b.submit(np.ones((2, 2)), timeout=10)
    b.close()
    assert m.errors_total["default"].value == 1


# ------------------------------------------------------------- registry
def test_default_device_raises_without_gpu(files):
    """ModelRegistry()/PredictionServer() load model files onto
    device_type="cuda" by default: where torch sees no GPU, loading
    raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    _, _, f1, _ = files
    with pytest.raises(RuntimeError, match="device_type"):
        ModelRegistry().register("m", f1)
    srv = PredictionServer(port=0)
    with pytest.raises(RuntimeError, match="device_type"):
        srv.registry.register("m", f1)
    assert srv.registry.default_name is None
    srv.stop()


def test_registry_swap_rollback_and_warmup(files):
    X, _, f1, f2 = files
    reg = ModelRegistry(warmup_rows=64, device_type="cpu")
    mv1 = reg.register("m", f1)
    assert mv1.version == 1 and reg.default_name == "m"
    # warmup really built the session caches off the serving path
    assert mv1.session._snapshot[3], "warmup left an empty window"
    assert mv1.booster._pack is not None
    assert str(mv1.booster._predict_device()) == "cpu"

    exp1 = mv1.session.predict(X)
    mv2 = reg.swap("m", f2)
    assert mv2.version == 2
    got, served = reg.predict(X)
    assert served is mv2
    exp2 = mv2.session.predict(X)
    np.testing.assert_array_equal(got, exp2)
    assert not np.allclose(exp1, exp2)

    # a holder of the OLD version keeps predicting on it (atomic swap
    # never invalidates in-flight readers)
    np.testing.assert_array_equal(mv1.session.predict(X), exp1)

    back = reg.rollback("m")
    assert back is mv1
    np.testing.assert_array_equal(reg.predict(X)[0], exp1)
    with pytest.raises(LookupError):
        reg.rollback("m")   # one-step history was consumed
    listing = reg.models()
    assert listing[0]["name"] == "m" and listing[0]["version"] == 1
    with pytest.raises(LookupError):
        reg.resolve("nope")


def test_hot_swap_under_concurrent_load_never_mixes(files):
    """Mid-burst hot-swap: zero failed requests, and every result is
    bit-identical to a WHOLE version's prediction — never a mix."""
    X, _, f1, f2 = files
    reg = ModelRegistry(warmup_rows=32, device_type="cpu")
    reg.register("m", f1)
    Xq = np.ascontiguousarray(X[:16], np.float64)
    exp = {1: reg.resolve("m").session.predict(Xq),
           2: _session(f2).predict(Xq)}
    assert not np.allclose(exp[1], exp[2])

    batcher = MicroBatcher(lambda Z: reg.predict(Z, "m"),
                           max_batch_rows=128, max_wait_us=2000)
    errors, tags_seen = [], set()
    first = threading.Barrier(5)
    deadline = time.monotonic() + 60

    def client():
        try:
            out, mv = batcher.submit_tagged(Xq, timeout=30)
            tags_seen.add(mv.version)
            first.wait(30)               # every client served v1 once
            while True:
                assert any(np.array_equal(out, e) for e in exp.values()), \
                    "result matches no whole version: mixed!"
                if mv.version == 2 or time.monotonic() > deadline:
                    return
                out, mv = batcher.submit_tagged(Xq, timeout=30)
                tags_seen.add(mv.version)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    first.wait(30)
    reg.swap("m", f2)                      # lands mid-burst
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    batcher.close()
    assert not errors, errors
    assert tags_seen == {1, 2}
    reg.rollback("m")
    np.testing.assert_array_equal(reg.predict(Xq)[0], exp[1])


# ------------------------------------------------------- predict session
def test_predict_session_snapshot_under_version_movement(files):
    """The engine contract the batcher relies on: predicts racing model
    reloads always return a WHOLE version's result (k or k+1
    iterations), never a mixed window."""
    X, b1, _, _ = files
    Xq = np.ascontiguousarray(X[:64], np.float64)
    text_a = b1.model_to_string(num_iteration=5)
    text_b = b1.model_to_string(num_iteration=6)
    bst = lgt.Booster(model_str=text_a, params=CPU)
    sess = bst.predict_session()
    exp_a = sess.predict(Xq)
    exp_b = lgt.Booster(model_str=text_b, params=CPU).predict(Xq)
    assert not np.allclose(exp_a, exp_b)

    stop = threading.Event()
    errors, moves = [], [0]

    def mover():
        while not stop.is_set():
            bst.model_from_string(text_b)
            time.sleep(0)                  # let the readers in
            bst.model_from_string(text_a)
            moves[0] += 1

    def reader():
        try:
            for _ in range(30):
                out = sess.predict(Xq)
                assert (np.array_equal(out, exp_a)
                        or np.array_equal(out, exp_b)), \
                    "mixed-version prediction observed"
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    mt = threading.Thread(target=mover)
    rts = [threading.Thread(target=reader) for _ in range(3)]
    mt.start()
    for t in rts:
        t.start()
    for t in rts:
        t.join(timeout=60)
    stop.set()
    mt.join(timeout=60)
    assert not mt.is_alive() and not any(t.is_alive() for t in rts)
    assert not errors, errors[:3]
    assert moves[0] > 0


# ------------------------------------------------------------- HTTP layer
@pytest.fixture()
def served(files, tmp_path):
    X, bst, f1, _ = files
    srv = PredictionServer(port=0, max_wait_us=1000, max_batch_rows=256,
                           device_type="cpu")
    srv.registry.register("default", f1)
    port = srv.start()
    yield X, bst, srv, f"http://127.0.0.1:{port}", tmp_path
    srv.stop()


def _post(url, data, ctype="application/json"):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=30)


def _npy(X):
    buf = io.BytesIO()
    np.save(buf, X)
    return buf.getvalue()


def test_http_predict_json_and_npy_bit_parity(served, files):
    X, bst, srv, base, _ = served
    Xq = np.ascontiguousarray(X[:32], np.float64)
    expect = _session(files[2]).predict(Xq)

    # JSON round trip (repr'd doubles re-parse exactly)
    r = json.loads(_post(base + "/predict", json.dumps(
        {"data": Xq.tolist()}).encode()).read())
    assert r["model"] == "default" and r["version"] == 1
    np.testing.assert_array_equal(np.asarray(r["predictions"]), expect)

    # raw-npy round trip: BIT parity with PredictSession.predict
    resp = _post(base + "/predict", _npy(Xq), "application/x-npy")
    assert resp.headers["X-Model-Name"] == "default"
    got = np.load(io.BytesIO(resp.read()))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, expect)

    # healthz + models + metrics
    h = json.loads(urllib.request.urlopen(base + "/healthz",
                                          timeout=10).read())
    assert h == {"status": "ok", "model": "default", "version": 1}
    models = json.loads(urllib.request.urlopen(base + "/models",
                                               timeout=10).read())
    assert models["models"][0]["num_trees"] == bst.num_trees()
    metrics = urllib.request.urlopen(base + "/metrics",
                                     timeout=10).read().decode()
    assert 'serve_requests_total{model="default"}' in metrics
    assert "serve_batch_rows" in metrics
    assert "serve_queue_wait_seconds" in metrics

    # bad input -> 400, unknown path -> 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/predict", b'{"nope": 1}')
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/bogus", timeout=10)
    assert e.value.code == 404


def test_http_compiled_fleet_npy_bit_parity(files):
    """The tensorized fleet (two replicas on one device) answers npy
    bit-equal to the session on grid-quantized features."""
    X, _, f1, _ = files
    srv = PredictionServer(port=0, max_wait_us=500, max_batch_rows=64,
                           compiled_predict=True, replicas=2,
                           device_type="cpu")
    try:
        mv = srv.registry.register("default", f1)
        assert mv.compiled is not None and len(mv.replicas.replicas) == 2
        assert mv.compiled.describe()["warmed_rungs"] == [16, 32, 64]
        port = srv.start()
        Xq = np.ascontiguousarray(X[:40], np.float64)
        got = np.load(io.BytesIO(_post(
            f"http://127.0.0.1:{port}/predict", _npy(Xq),
            "application/x-npy").read()))
        np.testing.assert_array_equal(got, _session(f1).predict(Xq))
    finally:
        srv.stop()


def test_http_swap_rollback_endpoints(served, files):
    X, bst, srv, base, _ = served
    f2 = files[3]
    Xq = np.ascontiguousarray(X[:16], np.float64)
    before = srv.registry.predict(Xq)[0]

    r = json.loads(_post(base + "/models/swap", json.dumps(
        {"name": "default", "file": f2}).encode()).read())
    assert r["status"] == "swapped" and r["version"] == 2
    after = srv.registry.predict(Xq)[0]
    assert not np.allclose(before, after)

    r = json.loads(_post(base + "/models/rollback", b"{}").read())
    assert r["status"] == "rolled back" and r["version"] == 1
    np.testing.assert_array_equal(srv.registry.predict(Xq)[0], before)
    metrics = urllib.request.urlopen(base + "/metrics",
                                     timeout=10).read().decode()
    assert "serve_swaps_total 1" in metrics
    assert "serve_rollbacks_total 1" in metrics


def test_http_overload_maps_to_429(served):
    X, bst, srv, base, _ = served
    real = srv.registry.predict
    gate = _Gate(real)
    srv.registry.predict = gate              # instance-level shadow
    srv._batcher_opts.update(max_queue_rows=4, max_wait_us=0)
    srv._batchers.clear()                    # rebuild with tiny queue
    body = _npy(np.ascontiguousarray(X[:4], np.float64))
    codes = []

    def client():
        try:
            codes.append(_post(base + "/predict", body,
                               "application/x-npy").status)
        except urllib.error.HTTPError as e:
            codes.append(e.code)

    threads = [threading.Thread(target=client) for _ in range(3)]
    threads[0].start()
    assert gate.entered.wait(10)             # the worker holds request 1
    threads[1].start()
    _wait(lambda: srv._batchers["default"].load() == 4, "request 2 queued")
    threads[2].start()                       # 4 + 4 rows > 4: rejected
    threads[2].join(timeout=30)
    gate.open()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    srv.registry.predict = real
    assert sorted(codes) == [200, 200, 429], codes


# ----------------------------------------------------- graceful drain
def test_healthz_alive_ready_split(served):
    """Liveness vs readiness: /healthz/alive answers 200 whenever the
    process serves HTTP; /healthz (and its /ready alias) flips to 503
    the moment the server starts draining."""
    X, bst, srv, base, _ = served
    alive = json.loads(urllib.request.urlopen(
        base + "/healthz/alive", timeout=10).read())
    assert alive == {"status": "alive"}
    ready = json.loads(urllib.request.urlopen(
        base + "/healthz/ready", timeout=10).read())
    assert ready["status"] == "ok"

    srv.draining = True          # draining: alive stays up, ready drops
    alive = json.loads(urllib.request.urlopen(
        base + "/healthz/alive", timeout=10).read())
    assert alive == {"status": "alive"}
    for path in ("/healthz", "/healthz/ready"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + path, timeout=10)
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "draining"
    srv.draining = False


def test_drain_finishes_inflight_work(served, files):
    """drain() must answer requests already accepted into the batcher
    before returning — and stop() must be idempotent afterwards."""
    X, bst, srv, base, _ = served
    Xq = np.ascontiguousarray(X[:8], np.float64)
    expect = _session(files[2]).predict(Xq)
    gate = _Gate(srv.registry.predict)
    srv.registry.predict = gate
    results = []
    t = threading.Thread(
        target=lambda: results.append(srv.predict(Xq)[0]))
    t.start()
    assert gate.entered.wait(10)  # the request is in the model
    dt = threading.Thread(target=srv.drain)
    dt.start()
    gate.open()                   # the model recovers; drain completes
    dt.join(timeout=15)
    t.join(timeout=15)
    assert not dt.is_alive() and not t.is_alive()
    assert srv.draining
    np.testing.assert_array_equal(results[0], expect)
    srv.stop()                    # second stop: clean no-op


# ------------------------------------------------------- replica fleet
class _StubCompiled:
    """CompiledEnsemble stand-in: deterministic, gated so a replica can
    be held busy while the router is probed; ``entered`` is set once a
    batcher worker holds a batch in ``predict``."""

    num_features = 4

    def __init__(self):
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()

    def predict(self, X, device=None):
        self.entered.set()
        self.gate.wait(10)
        return np.asarray(X, np.float64)[:, 0]


def test_least_queue_routing_and_drain_runbook():
    stub = _StubCompiled()
    rs = ReplicaSet(stub, replicas=2, devices=[torch.device("cpu")],
                    max_batch_rows=64, max_wait_us=0, min_bucket=8)
    try:
        # hold replica 0: one request in the model, one queued behind it
        stub.gate.clear()
        done = threading.Event()
        b0 = rs.replicas[0].batcher
        b0.submit_async(np.ones((4, 4)), lambda *a: None)
        assert stub.entered.wait(10)
        b0.submit_async(np.ones((4, 4)), lambda *a: done.set())
        assert b0.load() == 4        # the worker is held: still queued
        assert rs.pick() is rs.replicas[1]
        stub.gate.set()
        assert done.wait(10)

        # runbook: drain replica 0, route around it, restore it
        rs.drain_replica(0)
        assert rs.pick() is rs.replicas[1]
        with pytest.raises(RuntimeError):
            rs.drain_replica(1)      # never drain the last live replica
        rs.restore_replica(0)
        out, tag = rs.submit_tagged(np.ones((3, 4)))
        np.testing.assert_array_equal(out, [1.0, 1.0, 1.0])
        assert tag is rs.tag
        assert [str(d) for d in rs.describe()["devices"]] == ["cpu", "cpu"]
    finally:
        stub.gate.set()
        rs.close()


def test_qps_budget_token_bucket():
    q = QpsBudget(qps=5, burst=2)
    assert q.try_admit()
    assert q.try_admit()
    assert not q.try_admit()         # bucket empty, no refill yet
    time.sleep(0.3)                  # ~1.5 tokens back at 5/s
    assert q.try_admit()


def test_hot_swap_whole_version_across_replicas(files):
    """Mid-burst swap with a 2-replica compiled fleet: every result
    matches exactly one WHOLE version — no request ever sees a mix,
    no matter which replica served it. Also exercises the per-request
    wait hook behind serve_row_wait_p99."""
    X, _, f1, f2 = files
    srv = PredictionServer(max_batch_rows=64, min_bucket=16,
                           max_wait_us=500, compiled_predict=True,
                           replicas=2, device_type="cpu")
    try:
        srv.registry.register("m", f1)
        Xq = np.ascontiguousarray(X[:8])
        exp1 = _session(f1).predict(Xq)
        exp2 = _session(f2).predict(Xq)
        assert not np.allclose(exp1, exp2)   # swap must be observable
        errors, mixed, versions = [], [], set()
        started = threading.Barrier(7)
        stop = threading.Event()

        def client():
            first = True
            while not stop.is_set():
                try:
                    out, ver = srv.predict(Xq, "m")
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))
                    return
                versions.add(ver.version)
                if np.array_equal(out, exp1) == np.array_equal(out, exp2):
                    mixed.append(np.asarray(out))
                if first:
                    first = False
                    started.wait(30)

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        started.wait(30)                     # every client served v1
        srv.registry.register("m", f2)       # hot swap mid-burst
        _wait(lambda: 2 in versions, "a v2 result")
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert not errors
        assert not mixed, f"mixed-version results: {mixed[:2]}"
        assert versions == {1, 2}            # the swap landed mid-burst
        assert srv.metrics.request_wait_s.count > 0
        assert srv.metrics.row_wait_p99() >= 0.0
        assert "serve_row_wait_p99" in srv.metrics.render()
    finally:
        srv.stop()


def test_qps_budget_rejects_through_server(files):
    """Admission fires before the batcher or fleet sees the request:
    BudgetExceeded is retriable and counted per model."""
    X, _, f1, _ = files
    srv = PredictionServer(max_batch_rows=32, min_bucket=16,
                           max_wait_us=0, qps_budget=2.0,
                           device_type="cpu")
    try:
        srv.registry.register("m", f1)
        Xq = np.ascontiguousarray(X[:4])
        admitted = rejected = 0
        for _ in range(8):
            try:
                srv.predict(Xq, "m")
                admitted += 1
            except BudgetExceeded as e:
                assert e.retriable
                rejected += 1
        assert admitted >= 1 and rejected >= 1
        assert srv.metrics.budget_rejected_total["m"].value == rejected
        assert "serve_budget_rejected_total" in srv.metrics.render()
    finally:
        srv.stop()
