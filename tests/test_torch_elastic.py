"""PyTorch port, elastic full-state checkpoints on the CPU (mirrors
``tests/test_elastic.py``): a plan's checkpoint restored onto another
world size, and the supervisor's shrink to the serial learner.

Two ranks under gloo, started by the launcher in one group for the
module (``test_torch_parallel.RankGroup``, with a timeout of its own
that kills the group's session), train the JAX test's config (bagging
plus quantized gradients) with ``boost_from_average=false`` (a plan's
automatic init score is the mean of the ranks', not the serial run's)
and ``fused_split=off`` (a plan's split search is the two-pass one).
Under that config a data-parallel model is the serial model byte for
byte, so a run restored onto another topology must end with the same
model text and eval history as an uninterrupted run there:

- ``rs-serial``: the ranks checkpoint under reduce-scatter; this
  process deletes every checkpoint past iteration 4 and resumes
  serially;
- ``serial-rs`` and ``ar-rs``: the ranks train serially (or under
  allreduce), rank 0 deletes past 4, and both resume under
  reduce-scatter;
- a same-topology resume records no ``reshard``, a changed one does;
- only rank 0 writes checkpoints and snapshots, and a failed write on
  rank 0 leaves the ranks in step;
- the serial baseline against the JAX package's serial model;
- ``on_device_loss=degrade`` under ``LIGHTGBM_TPU_CHAOS_DEVLOSS_MODE=
  mesh``: a retry, then ``shrink_to_serial`` (every rank leaves the
  group and resumes alone), ending with the serial baseline's trees; with
  ``pre_partition=true`` the supervisor gives up instead.
"""

import os
import signal
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import RankGroup  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DATA_SRC = textwrap.dedent('''
    import json
    import os

    import numpy as np

    def make_data(seed=0, n=800, f=10):
        rng = np.random.RandomState(seed)

        def one(n):
            X = rng.normal(size=(n, f)).astype(np.float32)
            y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
                 + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
            return X, y
        X, y = one(n)
        Xv, yv = one(max(200, n // 3))
        return X, y, Xv, yv

    PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 7,
              "learning_rate": 0.2, "min_data_in_leaf": 5, "verbosity": -1,
              "bagging_fraction": 0.8, "bagging_freq": 2, "bagging_seed": 7,
              "use_quantized_grad": True, "num_grad_quant_bins": 4,
              "eval_period": 3, "snapshot_freq": 2, "snapshot_keep": 50,
              "resume": "auto", "device_type": "cpu",
              "boost_from_average": False, "fused_split": "off"}
    SERIAL = {"tree_learner": "serial"}
    RS = {"tree_learner": "data", "dp_hist_merge": "reduce_scatter"}
    AR = {"tree_learner": "data", "dp_hist_merge": "allreduce"}
    ROUNDS = 9

    def run(lgt, d, extra, rounds=ROUNDS, data=None, log=None):
        """(model text, eval history) of a run writing under ``d``."""
        X, y, Xv, yv = data if data is not None else make_data()
        p = dict(PARAMS, output_model=os.path.join(d, "m.txt"), **extra)
        if log is not None:
            p["event_log"] = os.path.join(d, log)
        tr = lgt.Dataset(X, label=y, params=p)
        va = lgt.Dataset(Xv, label=yv, reference=tr)
        hist = {}
        b = lgt.train(p, tr, rounds, valid_sets=[va],
                      callbacks=[lgt.record_evaluation(hist)])
        return b.model_to_string(), hist

    def ckpts(d):
        return sorted((f for f in os.listdir(d) if ".ckpt_iter_" in f),
                      key=lambda f: int(f.rsplit("_", 1)[1]))

    def drop_after(d, it=4):
        """Interrupt retroactively: delete every checkpoint past ``it``."""
        for f in ckpts(d):
            if int(f.rsplit("_", 1)[1]) > it:
                os.unlink(os.path.join(d, f))

    def trees(text):
        """The trees section less its tree_sizes line."""
        txt = text.split("parameters:")[0]
        return "\\n".join(ln for ln in txt.splitlines()
                         if not ln.startswith("tree_sizes="))

    def events(path):
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
''')
exec(_DATA_SRC)

_RANKS_SRC = _DATA_SRC + textwrap.dedent('''
    import pickle
    import sys

    import torch

    sys.path.insert(0, sys.argv[2])
    torch.set_num_threads(1)
    os.environ.pop("LIGHTGBM_TPU_FUSED_TRAIN", None)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.parallel import distributed as pdist
    from lightgbm_tpu_torch.resilience import (DeviceLossError,
                                               read_checkpoint)
    from lightgbm_tpu_torch.resilience import checkpoint as ck

    pdist.init_distributed()
    me = pdist.rank()
    root = sys.argv[1]
    out = {}
    log = f"run{me}.events.jsonl"

    def arm(name):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        return d

    def barrier():
        torch.distributed.barrier()

    # only rank 0 writes: count every checkpoint and snapshot write
    writes = {"ckpt": 0, "snapshot": 0}
    _write, _save = ck.write_checkpoint, lgt.Booster.save_model

    def counted_write(*a, **k):
        writes["ckpt"] += 1
        return _write(*a, **k)

    def counted_save(self, *a, **k):
        writes["snapshot"] += 1
        return _save(self, *a, **k)
    import lightgbm_tpu_torch.resilience as res_pkg
    res_pkg.write_checkpoint = counted_write
    lgt.Booster.save_model = counted_save

    # the uninterrupted reduce-scatter run: the new topology's reference
    out["rs_full"] = run(lgt, arm("rs_full"), dict(RS, resume="off"))
    # rs -> serial: this process's test resumes it serially
    writes.update(ckpt=0, snapshot=0)
    d = arm("rs_serial")
    out["rs_serial_a"] = run(lgt, d, RS, log=log)
    out["writes"] = dict(writes)
    out["files"] = sorted(os.listdir(d))
    barrier()
    if me == 0:
        state, _, _ = read_checkpoint(os.path.join(d, ckpts(d)[-1]))
        out["topology"] = state["topology"]
        drop_after(d)
    barrier()
    # serial -> rs, allreduce -> rs, rs -> rs
    for name, a, b in (("serial_rs", SERIAL, RS), ("ar_rs", AR, RS),
                       ("rs_rs", RS, RS)):
        d = arm(name)
        out[name + "_a"] = run(lgt, d, a, log=log)
        barrier()
        if me == 0:
            drop_after(d)
        barrier()
        out[name] = run(lgt, d, b, log=log)
        out[name + "_events"] = events(os.path.join(d, log))
    # rank 0's checkpoint write fails twice (ENOSPC at iterations 2 and
    # 4, so the boundary at 6 is skipped): every rank takes its outcome
    fails = {"left": 2 if me == 0 else 0}

    def failing_write(*a, **k):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise OSError(28, "No space left on device")
        return counted_write(*a, **k)
    res_pkg.write_checkpoint = failing_write
    d = arm("ckpt_fail")
    out["ckpt_fail"] = run(lgt, d, RS)
    out["ckpt_fail_files"] = ckpts(d)
    res_pkg.write_checkpoint = counted_write
    barrier()
    # pre_partition=true: a persistent loss cannot shrink
    os.environ["LIGHTGBM_TPU_CHAOS_DEVLOSS_ITER"] = "4"
    os.environ["LIGHTGBM_TPU_CHAOS_DEVLOSS_MODE"] = "mesh"
    X, y, Xv, yv = make_data()
    half = (X[me * 400:(me + 1) * 400], y[me * 400:(me + 1) * 400],
            Xv[me * 133:(me + 1) * 133], yv[me * 133:(me + 1) * 133])
    d = arm("give_up")
    try:
        run(lgt, d, dict(RS, pre_partition=True, on_device_loss="degrade"),
            data=half, log=log)
        out["give_up"] = "trained"
    except DeviceLossError as e:
        out["give_up"] = str(e)
    out["give_up_events"] = events(os.path.join(d, log))
    barrier()
    # the shrink: last, since every rank leaves the group
    d = arm("shrink")
    writes.update(ckpt=0, snapshot=0)
    out["shrink"] = run(lgt, d, dict(RS, on_device_loss="degrade"),
                        log=log)
    out["shrink_events"] = events(os.path.join(d, log))
    out["shrink_world"] = pdist.world_size()
    out["shrink_writes"] = dict(writes)
    with open(os.path.join(root, f"rank{me}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g = RankGroup(tmp_path_factory.mktemp("elastic_ranks"), _RANKS_SRC)
    yield g
    if g.p.poll() is None:
        os.killpg(g.p.pid, signal.SIGKILL)
        g.p.communicate()


_SERIAL = {}


def _serial_baseline(tmp_path_factory):
    """The uninterrupted serial run (cached)."""
    if "run" not in _SERIAL:
        import lightgbm_tpu_torch as lgt
        d = str(tmp_path_factory.mktemp("serial_full"))
        _SERIAL["run"] = run(lgt, d, dict(SERIAL, resume="off"))
    return _SERIAL["run"]


def _res(ranks, key):
    return [r[key] for r in ranks.results()]


def test_fingerprint_ignores_topology():
    """Topology knobs decide where a run executes, not what it
    computes: they stay out of the model fingerprint."""
    from lightgbm_tpu_torch.resilience import config_fingerprint
    fp = config_fingerprint(dict(PARAMS, **SERIAL))
    for topo in (RS, AR, {"tree_learner": "data", "num_machines": 2},
                 {"tree_learner": "voting", "device_type": "cuda"}):
        assert config_fingerprint(dict(PARAMS, **topo)) == fp, topo
    assert config_fingerprint(dict(PARAMS, learning_rate=0.05)) != fp


def test_topology_descriptor_records_the_world_size(ranks):
    """A plan's checkpoint records its mode, merge and world size."""
    topo = ranks.results()[0]["topology"]
    assert topo == {"tree_learner": "data", "parallel_mode": "data",
                    "num_shards": 2, "num_devices": 1,
                    "dp_hist_merge": "reduce_scatter", "num_machines": 2}


def test_topology_descriptor_serial():
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.resilience import topology_descriptor
    X, y, _, _ = make_data(n=300)
    b = lgt.train(dict(PARAMS, **SERIAL, resume="off", snapshot_freq=0),
                  lgt.Dataset(X, label=y), 2)
    assert topology_descriptor(b._gbdt) == {
        "tree_learner": "serial", "parallel_mode": "serial",
        "num_shards": 1, "num_devices": 1, "dp_hist_merge": "",
        "num_machines": 1}


def test_only_rank_zero_writes(ranks):
    """Both ranks capture every checkpoint (its rows are gathered) and
    train the same model; only rank 0 writes the files."""
    w0, w1 = _res(ranks, "writes")
    assert w0 == {"ckpt": 4, "snapshot": 4} and w1 == {"ckpt": 0,
                                                        "snapshot": 0}
    (a0, h0), (a1, h1) = _res(ranks, "rs_serial_a")
    assert (trees(a0), h0) == (trees(a1), h1)
    files = ranks.results()[0]["files"]
    assert [f for f in files if ".ckpt_iter_" in f] == [
        f"m.txt.ckpt_iter_{i}" for i in (2, 4, 6, 8)]


def test_serial_baseline_matches_jax(tmp_path, tmp_path_factory):
    """The elastic cells' serial baseline against the JAX package's
    serial model on the same data and ``PARAMS`` (``tests/test_elastic.py``'s
    config; the JAX package's two-pass scatter arm, as the port's
    ``fused_split=off``), under ``test_torch_quantized.py``'s contract:
    equal tree structure, leaves within 1e-5 relative (and 1e-5 of the
    tree's largest leaf), and the valid AUC history within 1e-6."""
    import lightgbm_tpu as lgb
    text, hist = _serial_baseline(tmp_path_factory)
    jp = {k: v for k, v in PARAMS.items() if k != "device_type"}
    jp.update(SERIAL, hist_impl="scatter", resume="off",
              output_model=str(tmp_path / "m.txt"))
    X, y, Xv, yv = make_data()
    ds = lgb.Dataset(X, label=y)
    jhist = {}
    jb = lgb.train(jp, ds, ROUNDS,
                   valid_sets=[lgb.Dataset(Xv, label=yv, reference=ds)],
                   callbacks=[lgb.record_evaluation(jhist)])

    def lines(t):
        out = {}
        for ln in trees(t).splitlines():
            k = ln.split("=")[0]
            if k in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_value"):
                out.setdefault(k, []).append(ln.split("=", 1)[1])
        return out
    got, want = lines(text), lines(jb.model_to_string())
    assert len(got["leaf_value"]) == ROUNDS
    for k in ("split_feature", "threshold", "decision_type", "left_child",
              "right_child"):
        assert got[k] == want[k], k
    for a, b in zip(got["leaf_value"], want["leaf_value"]):
        a, b = (np.asarray(v.split(), float) for v in (a, b))
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    assert list(hist) == list(jhist)
    for name in hist:
        np.testing.assert_allclose(hist[name]["auc"], jhist[name]["auc"],
                                   rtol=0, atol=1e-6)


def test_failed_write_on_rank_zero_keeps_the_ranks_paired(ranks):
    """Only rank 0 writes, so only it can fail (ENOSPC, twice): every
    rank takes rank 0's outcome, backs off alike (both skip the boundary
    after the second failure, and with it the capture's gathers) and
    ends with the uninterrupted run's trees and eval history."""
    want_text, want_hist = ranks.results()[0]["rs_full"]
    for r in ranks.results():
        text, hist = r["ckpt_fail"]
        assert trees(text) == trees(want_text)
        assert hist == want_hist
    assert ranks.results()[0]["ckpt_fail_files"] == ["m.txt.ckpt_iter_8"]


@pytest.mark.parametrize("arm", ["rs-serial", "serial-rs", "ar-rs"])
def test_elastic_resume_bit_identical(ranks, tmp_path_factory, arm):
    """A checkpoint of one topology restored onto another ends with the
    uninterrupted run's trees and eval history at the new topology, and
    the event log records the reshard."""
    import lightgbm_tpu_torch as lgt
    if arm == "rs-serial":
        d = str(ranks.tmp / "rs_serial")
        # rank 0's event log: the fingerprint rank 0 wrote (the log path
        # is a parameter of the model fingerprint, as in the JAX package)
        text, hist = run(lgt, d, SERIAL, log="run0.events.jsonl")
        want_text, want_hist = _serial_baseline(tmp_path_factory)
        evs = events(os.path.join(d, "run0.events.jsonl"))
        frm, to = "data", "serial"
    else:
        key = arm.replace("-", "_")
        (text, hist), (other, other_hist) = _res(ranks, key)
        assert (trees(text), hist) == (trees(other), other_hist)
        want_text, want_hist = ranks.results()[0]["rs_full"]
        evs = ranks.results()[0][key + "_events"]
        frm, to = ("serial" if arm == "serial-rs" else "data"), "data"
    assert trees(text) == trees(want_text)
    assert hist == want_hist
    reshards = [r for r in evs if r["event"] == "reshard"]
    assert len(reshards) == 1
    assert reshards[0]["from"]["tree_learner"] == frm
    assert reshards[0]["to"]["tree_learner"] == to
    assert reshards[0]["from"] != reshards[0]["to"]


@pytest.mark.parametrize("topology", ["serial", "data"])
def test_same_topology_resume_emits_no_reshard(ranks, tmp_path,
                                               tmp_path_factory, topology):
    if topology == "data":
        (text, _), _ = _res(ranks, "rs_rs")
        assert trees(text) == trees(ranks.results()[0]["rs_full"][0])
        evs = ranks.results()[0]["rs_rs_events"]
    else:
        import lightgbm_tpu_torch as lgt
        run(lgt, str(tmp_path), SERIAL, log="run.events.jsonl")
        drop_after(str(tmp_path))
        text, _ = run(lgt, str(tmp_path), SERIAL, log="run.events.jsonl")
        assert trees(text) == trees(_serial_baseline(tmp_path_factory)[0])
        evs = events(str(tmp_path / "run.events.jsonl"))
    assert [r for r in evs if r["event"] == "resume"]
    assert not [r for r in evs if r["event"] == "reshard"]


def test_supervised_shrink_to_serial(ranks, tmp_path_factory):
    """A device loss that persists under the data-parallel plan (chaos
    mode=mesh fires only while a plan is active): a retry on the same
    topology, then shrink_to_serial. Every rank leaves the group and
    resumes serially from the newest checkpoint, ending with the serial
    baseline's trees; only the former rank 0 writes after the shrink."""
    want_text, _ = _serial_baseline(tmp_path_factory)
    res = ranks.results()
    for r in res:
        text, _ = r["shrink"]
        assert trees(text) == trees(want_text)
        degraded = [(e["attempt"], e["action"]) for e in r["shrink_events"]
                    if e["event"] == "degraded"]
        assert degraded == [(1, "retry"), (2, "shrink_to_serial")]
        resh = [e for e in r["shrink_events"] if e["event"] == "reshard"]
        assert resh and resh[-1]["to"]["tree_learner"] == "serial"
        assert r["shrink_world"] == 1
    assert res[1]["shrink_writes"] == {"ckpt": 0, "snapshot": 0}
    assert res[0]["shrink_writes"]["ckpt"] > 0


def test_pre_partitioned_run_gives_up(ranks):
    """With pre_partition=true a rank lacks the other ranks' rows: the
    second loss gives up at once, saying why, as a give_up record."""
    for r in ranks.results():
        assert "pre_partition=true" in r["give_up"]
        assert "cannot shrink" in r["give_up"]
        degraded = [(e["attempt"], e["action"])
                    for e in r["give_up_events"]
                    if e["event"] == "degraded"]
        assert degraded == [(1, "retry"), (2, "give_up")]


def test_resume_rejects_different_dataset(tmp_path):
    """The global row count recorded in a checkpoint guards against
    resuming another run's state."""
    import lightgbm_tpu_torch as lgt
    d = str(tmp_path)
    run(lgt, d, SERIAL, rounds=4, data=make_data(n=400))
    with pytest.raises(ValueError, match="different dataset"):
        run(lgt, d, SERIAL, rounds=4, data=make_data(n=500))
