"""PyTorch port, distributed training end to end on the CPU (mirrors
``tests/test_distributed.py``): 2 ranks under gloo, started by the
launcher (``lightgbm_tpu_torch/launch.py -n 2 --cpu``), in one group for
the
whole module, joined with a timeout of their own (the launcher's
session is killed on expiry, so a hung rank fails a test here, not the
suite).

Through ``train``, each rank holding its ``np.array_split`` block of
the rows (``pre_partition=false``; every rank bins the same data, so
the bin mappers equal the serial run's):

- quantized ``tree_learner=data`` under both merges, with and without
  bagging: model text byte-equal to the port's serial model (the
  bagging masks, the stochastic rounding's draws and the int8 scales
  are the serial run's, over the global rows; the serial run takes the
  two-pass arm, ``fused_split=off``, as a plan does);
- float: reduce-scatter byte-equal to allreduce, both with the serial
  trees' structure and leaves within rtol 1e-6;
- ``tree_learner=feature``: byte-equal to serial; voting with
  ``2 * top_k >= F``: the data-parallel trees, leaves within rtol 1e-6;
- every rank's model and valid metrics identical, and early stopping
  at the same iteration on both ranks;
- the collective record (``CommReport``) and the telemetry's run header
  and collective gauges of a 2-rank run;
- no parallel parameter is accepted and ignored;
- GOSS, DART, RF, lambdarank, ``rank_xendcg`` and position-bias
  lambdarank with ``bagging_by_query`` (each rank its whole queries,
  ``pre_partition=true``), a custom objective and ``init_model`` under
  allreduce, reduce-scatter, voting and feature: quantized, the port's
  serial model byte for byte; the custom objective sees this rank's
  rows; a float reduce-scatter model of each against the JAX package's
  serial model (ranking: its valid NDCG and position-bias factors too);
- what a plan still refuses raises with the JAX package's reason.

The serial references run in this process while the ranks train. The
runs set ``boost_from_average=false``: a parallel run's automatic init
score is the mean of the ranks' (the reference's GlobalSyncUpByMean),
which is not the serial run's; ``test_init_score_is_the_ranks_mean``
holds that rule. Also here: the launcher and ``parallel/distributed.py``
units (machines, hostfile, ssh commands, fail-fast, the collective
timeout, ``sync_bin_mappers``, ``global_mean_init_scores``, the
replica check).
"""

import os
import pickle
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import RankGroup  # noqa: E402

_DATA_SRC = textwrap.dedent('''
    import numpy as np

    def make_data():
        rng = np.random.RandomState(7)
        X = rng.normal(size=(3000, 8))
        X[rng.rand(3000, 8) < 0.03] = np.nan
        y = (np.nan_to_num(X[:, 0]) + X[:, 1] * X[:, 2]
             + 0.5 * rng.normal(size=3000) > 0).astype(float)
        return X[:2400], y[:2400], X[2400:], y[2400:]

    BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
            "learning_rate": 0.3, "verbosity": -1, "device_type": "cpu",
            "boost_from_average": False, "metric": ["auc", "binary_logloss"]}
    Q = {"use_quantized_grad": True}
    BAG = {"bagging_freq": 1, "bagging_fraction": 0.7, "bagging_seed": 3}
    # arm -> (params, rounds)
    ARMS = {
        "q_allreduce": ({"tree_learner": "data",
                         "dp_hist_merge": "allreduce", **Q}, 3),
        "q_reduce_scatter": ({"tree_learner": "data",
                              "dp_hist_merge": "reduce_scatter", **Q}, 3),
        "qbag_reduce_scatter": ({"tree_learner": "data", **Q, **BAG}, 3),
        "f_allreduce": ({"tree_learner": "data",
                         "dp_hist_merge": "allreduce"}, 3),
        "f_reduce_scatter": ({"tree_learner": "data"}, 3),
        "feature": ({"tree_learner": "feature"}, 3),
        "voting_full": ({"tree_learner": "voting", "top_k": 4,
                         "dp_hist_merge": "allreduce"}, 3),
        "voting_small": ({"tree_learner": "voting", "top_k": 1}, 3),
        "early": ({"tree_learner": "data", "learning_rate": 1.0,
                   "min_data_in_leaf": 2}, 40),
        "pre_partition": ({"tree_learner": "data",
                           "pre_partition": True}, 2),
        "shard_storage_data": ({"tree_learner": "data",
                                "feature_shard_storage": True}, 1),
        "shard_storage_feature": ({"tree_learner": "feature",
                                   "feature_shard_storage": True}, 1),
        "telemetry": ({"tree_learner": "data", "telemetry_port": 0,
                       "eval_period": 2}, 4),
        "contri_serial": ({"tree_learner": "data",
                           "feature_contri": [1.0] * 8}, 1),
    }

    # the boosting modes, ranking, custom objectives and continued
    # training under each plan: mode -> (params, rounds); quantized, so
    # a plan's model is the serial run's byte for byte
    LEARNERS = {
        "ar": {"tree_learner": "data", "dp_hist_merge": "allreduce"},
        "rs": {"tree_learner": "data", "dp_hist_merge": "reduce_scatter"},
        "voting": {"tree_learner": "voting"},
        "feature": {"tree_learner": "feature"},
    }
    RANK = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [5],
            "bagging_by_query": True, "bagging_freq": 1,
            "bagging_fraction": 0.7, "pre_partition": True}
    MODES = {
        "goss": ({"data_sample_strategy": "goss", "learning_rate": 0.5,
                  **Q}, 4),
        "dart": ({"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0,
                  **Q}, 4),
        "rf": ({"boosting": "rf", "bagging_freq": 1,
                "bagging_fraction": 0.6, **Q}, 3),
        "lambdarank": ({**RANK, **Q}, 3),
        "rank_xendcg": ({**RANK, "objective": "rank_xendcg", **Q}, 3),
        "position_bias": ({**RANK, **Q}, 3),
        "custom": ({"objective": "custom", "metric": "auc", **Q}, 3),
        "init_model": (dict(Q), 3),
    }
    RANKING_MODES = ("lambdarank", "rank_xendcg", "position_bias")

    def make_rank_data():
        """Queries of 5-29 documents, 6 integer features (every value
        on both halves: each rank's mapper fit is the serial one)."""
        rng = np.random.RandomState(5)

        def part(nq):
            sizes = rng.randint(5, 30, size=nq)
            nr = int(sizes.sum())
            X = rng.randint(0, 20, size=(nr, 6)).astype(float)
            rel = X[:, 0] + 0.6 * X[:, 1] + rng.normal(scale=3, size=nr)
            y = np.digitize(rel, np.quantile(rel, [0.4, 0.7, 0.85, 0.95]))
            return X, y.astype(float), sizes
        return part(120), part(40)

    def query_block(part, r, world=2):
        """Rank r's whole queries of ``part``, or all of them (None)."""
        X, y, sizes = part
        if r is None:
            return X, y, sizes
        qb = np.concatenate([[0], np.cumsum(sizes)])
        qs = np.array_split(np.arange(len(sizes)), world)[r]
        lo, hi = qb[qs[0]], qb[qs[-1] + 1]
        return X[lo:hi], y[lo:hi], sizes[qs]

    def positions(sizes):
        """10 position ids: each document's slot in its query, mod 10."""
        return np.concatenate([np.arange(s) % 10 for s in sizes])

    def logloss(preds, ds):
        pr = 1.0 / (1.0 + np.exp(-preds))
        return pr - ds.get_label(), pr * (1.0 - pr)

    def mode_datasets(lgt, mode, p, r, bin_mappers=None):
        """(train, valid) of a mode's run on rank r (None: all rows)."""
        if mode in RANKING_MODES:
            tr_part, va_part = make_rank_data()
            X, y, g = query_block(tr_part, r)
            Xv, yv, gv = query_block(va_part, r)
            pos = positions(g) if mode == "position_bias" else None
            tr = lgt.Dataset(X, label=y, group=g, params=p,
                             bin_mappers=bin_mappers, position=pos)
            return tr, lgt.Dataset(Xv, label=yv, group=gv, reference=tr)
        X, y, Xv, yv = make_data()
        keep = mode == "init_model"
        tr = lgt.Dataset(X, label=y, params=p, free_raw_data=not keep,
                         bin_mappers=bin_mappers)
        return tr, lgt.Dataset(Xv, label=yv, reference=tr,
                               free_raw_data=not keep)

    def base_model(lgt):
        """The init model of ``init_model``: 2 float serial trees."""
        X, y, _, _ = make_data()
        p = dict(BASE, tree_learner="serial")
        return lgt.train(p, lgt.Dataset(X, label=y, params=p), 2)

    # what a plan refuses, with the JAX package's reason
    REFUSED = {
        "out_of_core": {"tree_learner": "data", "out_of_core": "on"},
        "linear_tree": {"tree_learner": "data", "linear_tree": True},
        "forced_voting": {"tree_learner": "voting", "forced": True},
        "forced_feature": {"tree_learner": "feature", "forced": True},
        "dart_shard_storage": {"tree_learner": "feature", "boosting": "dart",
                               "feature_shard_storage": True},
        "rank_auto_partition": {"tree_learner": "data",
                                "objective": "lambdarank"},
    }
''')
exec(_DATA_SRC)

_RANKS_SRC = _DATA_SRC + textwrap.dedent('''
    import json
    import os
    import pickle
    import sys
    import time
    import urllib.request

    import torch

    sys.path.insert(0, sys.argv[2])
    torch.set_num_threads(1)
    # the plan, not the suite's pin, decides the loop
    os.environ.pop("LIGHTGBM_TPU_FUSED_TRAIN", None)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import log
    from lightgbm_tpu_torch.parallel import distributed as pdist
    from lightgbm_tpu_torch.parallel.comms import hist_bytes_per_tree
    from lightgbm_tpu_torch.telemetry import active_session

    pdist.init_distributed()
    me = pdist.rank()
    warned = []
    _warn = log.warning
    log.warning = lambda m: (warned.append(m), _warn(m))
    X, y, Xv, yv = make_data()
    out = {}
    for name, (extra, rounds) in ARMS.items():
        p = dict(BASE, **extra)
        if name == "telemetry":
            p["event_log"] = f"{sys.argv[1]}/tele{me}.events.jsonl"
        warned.clear()
        ev, seen = {}, {}

        def scrape(env):
            if env.iteration == rounds - 1 and name == "telemetry":
                port = active_session().server.port
                seen["metrics"] = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics").read().decode()
        cbs = [lgt.record_evaluation(ev), scrape]
        if name == "early":
            cbs.append(lgt.early_stopping(3, verbose=False))
        try:
            tr = lgt.Dataset(X, label=y, params=p)
            va = lgt.Dataset(Xv, label=yv, reference=tr)
            b = lgt.train(p, tr, rounds, valid_sets=[va], callbacks=cbs)
        except (NotImplementedError, ValueError) as e:
            out[name] = {"error": f"{type(e).__name__}: {e}",
                         "warned": list(warned)}
            continue
        gb = b._gbdt
        rep = gb.plan.comm.report if gb.plan is not None else None
        out[name] = {
            "model": b.model_to_string().split("end of trees")[0],
            "evals": ev, "best_iteration": b.best_iteration,
            "num_trees": b.num_trees(), "warned": list(warned),
            "num_data": tr.num_data, "valid_num_data": va.num_data,
            "plan": None if gb.plan is None else (
                gb.plan.parallel_mode, gb.plan.hist_merge),
            "reasons": (gb.fused_train_reason, gb.fused_split_reason,
                        gb.class_batch_reason),
            "hist_bytes": None if rep is None else rep.hist_result_bytes,
            "hist_kinds": None if rep is None else sorted(
                {o.kind for o in rep.hist_ops}),
            "trees": None if rep is None else rep.trees,
            "per_tree": None if rep is None else hist_bytes_per_tree(
                rep, p["num_leaves"], 16),
            "metrics": seen.get("metrics"),
        }
    # the boosting modes, ranking, custom objectives and continued
    # training under every plan
    base = base_model(lgt)
    if me == 0:
        base.save_model(f"{sys.argv[1]}/base.txt")
    for mode, (extra, rounds) in MODES.items():
        # the quantized arms under every learner, and a float arm under
        # reduce-scatter (the JAX package's serial contracts are float)
        for lname, lp in [*LEARNERS.items(), ("rs_float", LEARNERS["rs"])]:
            p = dict(BASE, **lp, **extra)
            if lname == "rs_float":
                del p["use_quantized_grad"]
            tr, va = mode_datasets(lgt, mode, p,
                                   None if lname == "feature" else me)
            ev, seen, kw = {}, {}, {}
            if mode == "custom":
                def fobj(preds, ds):
                    seen["rows"] = (len(preds), ds.num_data)
                    return logloss(preds, ds)
                kw["fobj"] = fobj
            elif mode == "init_model":
                kw["init_model"] = base
            b = lgt.train(p, tr, rounds, valid_sets=[va],
                          callbacks=[lgt.record_evaluation(ev)], **kw)
            out[f"{mode}/{lname}"] = {
                "model": b.model_to_string().split("end of trees")[0],
                "evals": ev, "seen": seen, "num_data": tr.num_data,
                "plan": b._gbdt.plan.parallel_mode,
                "mappers": [m.state_arrays() for m in tr.bin_mappers],
                "pos_biases": getattr(b._gbdt.objective, "pos_biases",
                                      None)}
    for name, extra in REFUSED.items():
        p = dict(BASE, **extra)
        if p.pop("forced", False):
            p["forcedsplits_filename"] = f"{sys.argv[1]}/forced.json"
            with open(p["forcedsplits_filename"], "w") as fh:
                json.dump({"feature": 0, "threshold": 0.0}, fh)
        try:
            if name == "rank_auto_partition":
                tr_part, _ = make_rank_data()
                Xr, yr, gr = tr_part
                tr = lgt.Dataset(Xr, label=yr, group=gr, params=p)
            else:
                tr = lgt.Dataset(X, label=y, params=p)
            lgt.train(p, tr, 1)
            out["refused/" + name] = "trained"
        except (NotImplementedError, ValueError) as e:
            out["refused/" + name] = f"{type(e).__name__}: {e}"
    # the host protocols
    from lightgbm_tpu_torch.binning import BinMapper
    part = X[me * 1200:(me + 1) * 1200]
    local = [BinMapper.from_values(part[:, f]) for f in range(8)]
    synced = pdist.sync_bin_mappers(local)
    out["_mappers"] = {"local": [m.state_arrays() for m in local],
                       "synced": [m.state_arrays() for m in synced]}
    out["_init_mean"] = pdist.global_mean_init_scores(
        np.asarray([1.0 + me, 3.0 * me]))
    ref = lgt.Dataset(X[:200], label=y[:200], params={
        "device_type": "cpu", "tree_learner": "serial"}).construct()
    ds = lgt.Dataset(X[me * 100:(me + 1) * 100], label=y[:100],
                     reference=ref).construct()
    try:
        pdist.check_replicas_identical([ds])
        out["_replicas"] = "passed"
    except ValueError as e:
        out["_replicas"] = str(e)
    p = dict(BASE, tree_learner="data")
    b = lgt.train(dict(p, boost_from_average=True),
                  lgt.Dataset(X, label=y, params=p), 1)
    out["_init_score"] = (float(b._gbdt._init_scores[0]),
                          float(np.mean(y[me * 1200:(me + 1) * 1200])))
    with open(f"{sys.argv[1]}/rank{me}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    # a hung peer: rank 1 stays alive without joining, rank 0's
    # collective on a group with a 3 s timeout must raise instead of
    # waiting forever
    import datetime
    from lightgbm_tpu_torch.parallel.comms import Comm
    tg = torch.distributed.new_group(
        [0, 1], timeout=datetime.timedelta(seconds=3))
    if me == 1:
        time.sleep(4.5)
        os._exit(0)
    t0 = time.monotonic()
    try:
        Comm(tg).all_reduce(torch.ones(4))
        msg = "returned"
    except RuntimeError:
        msg = f"raised after {time.monotonic() - t0:.3f} s"
    with open(f"{sys.argv[1]}/timeout.txt", "w") as fh:
        fh.write(msg)
    os._exit(0)          # no wait on the broken group's teardown
''')


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g = RankGroup(tmp_path_factory.mktemp("train_ranks"), _RANKS_SRC)
    yield g
    if g.p.poll() is None:
        os.killpg(g.p.pid, signal.SIGKILL)
        g.p.communicate()


_SERIAL = {}


def _serial(key, extra, rounds=3):
    """The port's serial model text and valid metrics (cached)."""
    if key not in _SERIAL:
        import lightgbm_tpu_torch as lgt
        X, y, Xv, yv = make_data()
        p = dict(BASE, tree_learner="serial", **extra)
        ev = {}
        tr = lgt.Dataset(X, label=y, params=p)
        b = lgt.train(p, tr, rounds,
                      valid_sets=[lgt.Dataset(Xv, label=yv, reference=tr)],
                      callbacks=[lgt.record_evaluation(ev)])
        _SERIAL[key] = (b.model_to_string().split("end of trees")[0], ev)
    return _SERIAL[key]


def _res(ranks, arm):
    r0, r1 = (ranks.results()[r][arm] for r in range(2))
    return r0, r1


def _trees(text):
    """The per-tree (split_feature, threshold, leaf_value) lines."""
    out = {}
    for ln in text.splitlines():
        k = ln.split("=")[0]
        if k in ("split_feature", "threshold", "leaf_value",
                 "decision_type", "left_child", "right_child"):
            out.setdefault(k, []).append(ln.split("=", 1)[1])
    return out


@pytest.mark.parametrize("arm,serial", [
    ("q_allreduce", "q"), ("q_reduce_scatter", "q"),
    ("qbag_reduce_scatter", "qbag"), ("feature", "f")])
def test_parallel_model_is_the_serial_model(ranks, arm, serial):
    extra = {"q": dict(Q, fused_split="off"),
             "qbag": dict(Q, **BAG, fused_split="off"), "f": {}}[serial]
    text, ev = _serial(serial, extra)
    r0, r1 = _res(ranks, arm)
    assert r0["model"] == r1["model"] and r0["evals"] == r1["evals"]
    assert r0["model"] == text
    assert r0["evals"] == ev
    assert r0["num_data"] == (2400 if arm == "feature" else 1200)


_MODE_SERIAL = {}


def _serial_mode(ranks, mode, lname):
    """The port's serial model text and valid metrics of a mode (cached),
    on the bin mappers the plan's Datasets fit (a ranking rank fits its
    own queries' rows under pre_partition=true)."""
    key = (mode, mode in RANKING_MODES and lname == "feature")
    if key not in _MODE_SERIAL:
        import lightgbm_tpu_torch as lgt
        from lightgbm_tpu_torch.binning import BinMapper
        extra, rounds = MODES[mode]
        p = dict(BASE, **extra, tree_learner="serial", fused_split="off")
        maps = [BinMapper.from_state_arrays(*a) for a in
                _res(ranks, f"{mode}/{lname}")[0]["mappers"]]
        tr, va = mode_datasets(lgt, mode, p, None, bin_mappers=maps)
        ev, kw = {}, {}
        if mode == "custom":
            kw["fobj"] = logloss
        elif mode == "init_model":
            kw["init_model"] = base_model(lgt)
        b = lgt.train(p, tr, rounds, valid_sets=[va],
                      callbacks=[lgt.record_evaluation(ev)], **kw)
        _MODE_SERIAL[key] = (b.model_to_string().split("end of trees")[0],
                             ev)
    return _MODE_SERIAL[key]


@pytest.mark.parametrize("learner", list(LEARNERS))
@pytest.mark.parametrize("mode", list(MODES))
def test_mode_under_plan_is_the_serial_model(ranks, mode, learner):
    """GOSS (the global top-k and draws), DART (the same drops on every
    rank, replayed over its rows), RF (bagging over the global rows),
    lambdarank, rank_xendcg (its draw's lanes in the global lattice) and
    position-bias lambdarank (one bias state), each with
    bagging_by_query (whole queries a rank, pre_partition=true, the draw
    over the global queries), a custom
    objective (this rank's rows) and init_model (this rank's base
    scores) under each plan: the quantized data, voting and feature
    models are the serial model byte for byte (voting merges its elected
    columns and the root's sums in int32). Both ranks' models and
    metrics are equal; the gathered metrics are the serial run's (NDCG
    within 1e-6)."""
    r0, r1 = _res(ranks, f"{mode}/{learner}")
    assert r0["model"] == r1["model"] and r0["evals"] == r1["evals"]
    assert r0["plan"] == LEARNERS[learner]["tree_learner"]
    text, ev = _serial_mode(ranks, mode, learner)
    assert r0["model"] == text
    for name, metrics in ev["valid_0"].items():
        np.testing.assert_allclose(r0["evals"]["valid_0"][name], metrics,
                                   rtol=0, atol=1e-6)


def test_custom_objective_sees_this_ranks_rows(ranks):
    """Under a row-sharded plan the custom objective receives this
    rank's rows and their scores, never the gathered rows; under the
    feature plan every rank holds every row."""
    for r in ranks.results():
        for lname in LEARNERS:
            got = r[f"custom/{lname}"]
            n = 2400 if lname == "feature" else 1200
            assert got["seen"]["rows"] == (n, n) == (got["num_data"],) * 2


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_under_plan_matches_jax_serial(ranks, mode):
    """The float reduce-scatter plan's model against the JAX package's
    serial model on the same numpy data, under each mode's serial test
    contract (``test_torch_goss.py``, ``test_torch_boosting_modes.py``,
    ``test_torch_ranking.py``, ``test_torch_custom_objective.py``,
    ``test_torch_continued.py``, all float): equal tree structure,
    leaves within rtol 1e-5 (ranking: the structure, the gathered valid
    NDCG within 1e-6 and the position-bias factors within 1e-5)."""
    import lightgbm_tpu as lgb
    extra, rounds = MODES[mode]
    jp = dict(BASE, **extra, tree_learner="serial", hist_impl="scatter",
              fused_split="off")
    for k in ("device_type", "pre_partition", "use_quantized_grad"):
        jp.pop(k, None)
    kw, jrec = {}, {}
    if mode in RANKING_MODES:
        (X, y, g), (Xv, yv, gv) = make_rank_data()
        ds = lgb.Dataset(X, label=y, group=g, params=jp, position=(
            positions(g) if mode == "position_bias" else None))
        kw["valid_sets"] = [lgb.Dataset(Xv, label=yv, group=gv,
                                        reference=ds)]
        kw["callbacks"] = [lgb.record_evaluation(jrec)]
    else:
        X, y, _, _ = make_data()
        ds = lgb.Dataset(X, label=y, params=jp,
                         free_raw_data=mode != "init_model")
    if mode == "custom":
        kw["fobj"] = logloss
    elif mode == "init_model":
        kw["init_model"] = lgb.Booster(
            model_file=str(ranks.tmp / "base.txt"))
    jb = lgb.train(jp, ds, rounds, **kw)
    r0 = _res(ranks, f"{mode}/rs_float")[0]
    got = _trees(r0["model"])
    want = _trees(jb.model_to_string())
    for k in ("split_feature", "threshold", "decision_type", "left_child",
              "right_child"):
        assert got[k] == want[k], k
    if mode in RANKING_MODES:
        np.testing.assert_allclose(r0["evals"]["valid_0"]["ndcg@5"],
                                   jrec["valid_0"]["ndcg@5"], rtol=0,
                                   atol=1e-6)
    if mode == "position_bias":
        np.testing.assert_allclose(
            r0["pos_biases"].numpy(),
            np.asarray(jb._gbdt.objective.pos_biases), rtol=0, atol=1e-5)
    if mode not in RANKING_MODES:
        for a, b in zip(got["leaf_value"], want["leaf_value"]):
            a, b = (np.asarray(v.split(), float) for v in (a, b))
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("name,reason", [
    ("out_of_core", "NotImplementedError: out-of-core training: parallel "
                    "plans place the full device matrix"),
    ("linear_tree", "NotImplementedError: linear_tree requires single-host "
                    "training"),
    ("forced_voting", "NotImplementedError: forced splits support the "
                      "serial/data tree learners"),
    ("forced_feature", "NotImplementedError: forced splits support the "
                       "serial/data tree learners"),
    ("dart_shard_storage", "NotImplementedError: boosting=dart is "
                           "incompatible with feature_shard_storage"),
    ("rank_auto_partition", "NotImplementedError: multi-host "
                            "auto-partition does not support query/group "
                            "data; pre-partition queries per host and set "
                            "pre_partition=true"),
    ("cegb", "NotImplementedError: CEGB is single-device only")])
def test_plan_refusals_carry_jax_reasons(ranks, name, reason):
    """What a plan still refuses is what the JAX package refuses, with
    its reason; CEGB never reaches a plan (it forces the serial learner
    with the JAX warning), and build_tree refuses it under one."""
    if name == "cegb":
        from lightgbm_tpu_torch.boosting.tree_builder import build_tree
        from lightgbm_tpu_torch.ops.split import SplitParams

        class TwoRanks:
            rank, world_size = 0, 2
        R, F = 256, 3
        z = torch.zeros
        with pytest.raises(NotImplementedError) as ei:
            build_tree(
                z((R, F), dtype=torch.uint8), z((R, 3)),
                z(R, dtype=torch.int32),
                torch.full((F,), 4, dtype=torch.int32),
                torch.full((F,), -1, dtype=torch.int32),
                z(F, dtype=torch.bool), torch.ones(F, dtype=torch.bool),
                num_leaves=4, num_bins=4, leaf_batch=1, max_depth=-1,
                split_params=SplitParams(), comm=TwoRanks(),
                parallel_mode="data",
                cegb=(1.0, 0.1, None, None, z(F, dtype=torch.bool), None))
        got = f"NotImplementedError: {ei.value}"
    else:
        got = ranks.results()[0]["refused/" + name]
    assert got.startswith(reason), got


def test_float_merges(ranks):
    """reduce-scatter's model is allreduce's, byte for byte; both hold
    the serial trees' structure, leaves within rtol 1e-6 (the merged
    float sums add two halves where the serial run sums all rows)."""
    ar, _ = _res(ranks, "f_allreduce")
    rs, rs1 = _res(ranks, "f_reduce_scatter")
    assert rs["model"] == ar["model"] == rs1["model"]
    assert rs["plan"] == ("data", "reduce_scatter")
    text, _ = _serial("f", {})
    _same_structure(rs["model"], text, 1e-6)


def _same_structure(got, want, rtol):
    got, want = _trees(got), _trees(want)
    for k in ("split_feature", "threshold", "decision_type",
              "left_child", "right_child"):
        assert got[k] == want[k], k
    for a, b in zip(got["leaf_value"], want["leaf_value"]):
        np.testing.assert_allclose(np.asarray(a.split(), float),
                                   np.asarray(b.split(), float), rtol=rtol)


def test_voting(ranks):
    """Voting with 2 * top_k >= F elects every column: the data-parallel
    trees (its subtraction cache holds each rank's local sums, so a
    sibling's f32 sums add in another order: leaves within rtol 1e-6);
    top_k=1 elects 2 of 8 and still learns."""
    full, _ = _res(ranks, "voting_full")
    ar, _ = _res(ranks, "f_allreduce")
    _same_structure(full["model"], ar["model"], 1e-6)
    small, small1 = _res(ranks, "voting_small")
    assert small["model"] == small1["model"]
    assert small["hist_bytes"] < full["hist_bytes"]
    assert small["evals"]["valid_0"]["auc"][-1] > 0.8


def test_metrics_and_early_stopping_agree(ranks):
    r0, r1 = _res(ranks, "early")
    assert r0["evals"] == r1["evals"]
    assert 1 <= r0["best_iteration"] == r1["best_iteration"] < 40
    assert r0["num_trees"] == r1["num_trees"] < 40
    assert r0["valid_num_data"] == 300


def test_serial_only_options_force_serial(ranks):
    """feature_contri pins the serial learner with the JAX warning: every
    rank keeps every row and trains the same serial model."""
    a, b = _res(ranks, "contri_serial")
    assert ("CEGB/feature_contri require the serial tree learner; "
            "forcing tree_learner=serial") in a["warned"]
    assert a["plan"] is None and a["num_data"] == 2400
    assert a["model"] == b["model"]


def test_eager_loop_reasons(ranks):
    r0, _ = _res(ranks, "f_allreduce")
    assert r0["reasons"] == ("multi-process meshes place per-host blocks",
                             "parallel plans merge full histograms",
                             "single model per iteration")


def test_collective_record(ranks):
    """At world 2 reduce-scatter materializes half of allreduce's
    histogram bytes (F = 8 splits evenly), the feature learner issues no
    histogram collective, and the measured bytes per tree equal
    ``hist_bytes_per_tree``'s count."""
    ar, _ = _res(ranks, "f_allreduce")
    rs, _ = _res(ranks, "f_reduce_scatter")
    assert ar["hist_kinds"] == ["all-reduce"]
    assert rs["hist_kinds"] == ["reduce-scatter"]
    assert rs["hist_bytes"] * 2 == ar["hist_bytes"]
    q, _ = _res(ranks, "q_allreduce")
    assert q["hist_bytes"] == ar["hist_bytes"]         # int32 sums
    feat, _ = _res(ranks, "feature")
    assert feat["hist_bytes"] == 0 and feat["hist_kinds"] == []
    for arm in ("f_allreduce", "f_reduce_scatter", "voting_small"):
        r, _ = _res(ranks, arm)
        assert r["trees"] == 3
        assert r["hist_bytes"] == 3 * r["per_tree"], arm


def test_telemetry_run_header_and_gauges(ranks):
    """A 2-rank telemetry run: the run header names the world size, the
    plan, the merge and the backend; the collective gauges read the
    live record."""
    from lightgbm_tpu_torch.telemetry.events import (check_records,
                                                     read_events)
    res = ranks.results()
    for me in range(2):
        recs = read_events(str(ranks.tmp / f"tele{me}.events.jsonl"))
        assert check_records(recs) == []
        h = recs[0]
        assert (h["world_size"], h["rank"], h["num_shards"]) == (2, me, 2)
        assert (h["parallel_mode"], h["dp_hist_merge"], h["backend"]) == (
            "data", "reduce_scatter", "gloo")
        assert h["driver"] == "legacy" and not h["staged_collectives"]
        r = res[me]["telemetry"]
        gauges = {ln.split()[0]: float(ln.split()[1])
                  for ln in r["metrics"].splitlines()
                  if ln.startswith("train_collective_hist_bytes")}
        assert gauges["train_collective_hist_bytes_per_tree"] == \
            r["per_tree"] > 0
        assert gauges["train_collective_hist_bytes_total"] == \
            r["hist_bytes"]


# ------------------------------- no parallel parameter is ignored
def _init_calls(monkeypatch):
    import torch.distributed as dist

    from lightgbm_tpu_torch.parallel import distributed as pdist
    calls = {}
    monkeypatch.setattr(pdist, "_initialized", False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.update(kw))
    return calls


@pytest.mark.parametrize("param", ["top_k", "feature_shard_storage",
                                   "dp_hist_merge", "pre_partition",
                                   "num_machines", "machines"])
def test_no_parallel_parameter_is_ignored(ranks, monkeypatch, tmp_path,
                                          param):
    """Each parameter changes what the run does (its trees, its
    collective record, its partition, its process group) or draws the
    JAX package's warning or error."""
    if param == "top_k":
        a, _ = _res(ranks, "voting_small")
        b, _ = _res(ranks, "voting_full")
        assert a["model"] != b["model"]
        assert a["hist_bytes"] < b["hist_bytes"]
    elif param == "feature_shard_storage":
        d, _ = _res(ranks, "shard_storage_data")
        assert ("feature_shard_storage only applies with "
                "tree_learner=feature; ignoring") in d["warned"]
        f, _ = _res(ranks, "shard_storage_feature")
        assert f["error"].startswith("NotImplementedError: "
                                     "feature_shard_storage is single-host")
        import lightgbm_tpu_torch as lgt
        from lightgbm_tpu_torch import log
        seen = []
        monkeypatch.setattr(log, "warning", seen.append)
        X, y, _, _ = make_data()
        p = dict(BASE, feature_shard_storage=True)
        lgt.train(p, lgt.Dataset(X[:300], label=y[:300], params=p), 1)
        assert any("feature_shard_storage needs tree_learner=feature"
                   in m for m in seen)
    elif param == "dp_hist_merge":
        a, _ = _res(ranks, "f_allreduce")
        b, _ = _res(ranks, "f_reduce_scatter")
        assert (a["plan"], a["hist_kinds"]) == (("data", "allreduce"),
                                                ["all-reduce"])
        assert (b["plan"], b["hist_kinds"]) == (("data", "reduce_scatter"),
                                                ["reduce-scatter"])
        with pytest.raises(ValueError, match="dp_hist_merge"):
            from lightgbm_tpu_torch.parallel import resolve_hist_merge
            resolve_hist_merge("ring", 2)
    elif param == "pre_partition":
        a, _ = _res(ranks, "pre_partition")
        b, _ = _res(ranks, "f_reduce_scatter")
        assert (a["num_data"], b["num_data"]) == (2400, 1200)
    else:
        from lightgbm_tpu_torch import Config
        from lightgbm_tpu_torch.parallel import distributed as pdist
        calls = _init_calls(monkeypatch)
        monkeypatch.setenv("LIGHTGBM_TPU_RANK", "1")
        if param == "num_machines":
            assert not pdist.maybe_init_distributed(Config({}))
            assert calls == {}
            mlist = tmp_path / "mlist.txt"
            mlist.write_text("host-a:1234\nhost-b:1234\n")
            cfg = Config({"num_machines": 2,
                          "machine_list_filename": str(mlist),
                          "device_type": "cpu"})
        else:
            cfg = Config({"num_machines": 2, "device_type": "cpu",
                          "machines": "10.0.0.5:12400,10.0.0.6:12400"})
        assert pdist.maybe_init_distributed(cfg) is True
        first = "host-a:1234" if param == "num_machines" \
            else "10.0.0.5:12400"
        assert calls["init_method"] == f"tcp://{first}"
        assert (calls["world_size"], calls["rank"]) == (2, 1)
        assert calls["backend"] == "gloo"


# ------------------------------- distributed.py and the launcher
def test_init_score_is_the_ranks_mean(ranks):
    """boost_from_average under a row-sharded plan: the mean of the
    ranks' automatic init scores (GlobalSyncUpByMean)."""
    res = ranks.results()
    locals_ = [np.log(m / (1 - m)) for _, m in
               (res[r]["_init_score"] for r in range(2))]
    for r in range(2):
        assert res[r]["_init_score"][0] == pytest.approx(
            np.mean(locals_), rel=1e-12)
    np.testing.assert_array_equal(res[0]["_init_mean"], [1.5, 1.5])


def test_sync_bin_mappers_bit_exact(ranks):
    """Every rank ends with the same mappers, each feature block that of
    its owner's local fit, bit for bit (bounds f64, ids int64)."""
    res = ranks.results()
    s0, s1 = (res[r]["_mappers"]["synced"] for r in range(2))
    for f, (a, b) in enumerate(zip(s0, s1)):
        owner = 0 if f < 4 else 1
        want = res[owner]["_mappers"]["local"][f]
        for x, y_, w in zip(a, b, want):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y_))
            np.testing.assert_array_equal(np.asarray(x), np.asarray(w))


def test_replica_check_raises_on_different_copies(ranks):
    assert "requires IDENTICAL full data" in ranks.results()[0]["_replicas"]


def test_single_process_protocols_are_identities():
    from lightgbm_tpu_torch.parallel import distributed as pdist
    ms = [object(), object()]
    assert pdist.sync_bin_mappers(ms) is ms
    a = np.asarray([1.0, 3.0])
    assert pdist.global_mean_init_scores(a) is a
    pdist.check_replicas_identical([])
    assert pdist.feature_blocks(5, 2)[1].tolist() == [3, 4]


def test_launcher_fail_fast(tmp_path):
    from lightgbm_tpu_torch.launch import launch
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    assert launch([str(bad)], num_processes=2) == 3


def test_collective_timeout_fails_the_group(ranks):
    """A rank whose peer never joins its collective raises after the
    group's timeout instead of waiting forever (the rank program's last
    step: rank 1 sleeps past it, rank 0 all-reduces on a group with a
    3 s timeout)."""
    ranks.results()
    msg = (ranks.tmp / "timeout.txt").read_text()
    assert msg.startswith("raised after"), msg
    assert 2.5 < float(msg.split()[2]) < 30


def test_parse_hostfile(tmp_path):
    from lightgbm_tpu_torch.launch import parse_hostfile
    hf = tmp_path / "hosts.txt"
    hf.write_text("# cluster A\n10.0.0.1 slots=2\n\n"
                  "10.0.0.2   # head node comment\nlocalhost slots=3\n")
    assert parse_hostfile(str(hf)) == [
        ("10.0.0.1", 2), ("10.0.0.2", 1), ("localhost", 3)]
    bad = tmp_path / "bad.txt"
    bad.write_text("10.0.0.1 cpus=4\n")
    with pytest.raises(ValueError, match="unrecognized token"):
        parse_hostfile(str(bad))
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError, match="no hosts"):
        parse_hostfile(str(empty))


def test_launch_hosts_builds_ssh_and_local_commands():
    """Remote ranks wrap in ssh with the rank env exported; local ranks
    spawn directly; ranks number across hosts in hostfile order."""
    from lightgbm_tpu_torch import launch as L
    spawned = []

    class FakeProc:
        def __init__(self, cmd, env=None):
            spawned.append((cmd, env))

        def poll(self):
            return 0

        def kill(self):
            pass

        def wait(self):
            return 0

        def send_signal(self, sig):
            pass

    rc = L.launch_hosts(
        ["train.py", "--foo"], [("10.0.0.1", 2), ("localhost", 1)],
        port=4001, ssh="ssh", python_exe="python3", _popen=FakeProc)
    assert rc == 0 and len(spawned) == 3
    for rank, (cmd, env) in enumerate(spawned[:2]):
        assert cmd[:4] == ["ssh", "-tt", "-o", "BatchMode=yes"]
        assert cmd[4] == "10.0.0.1"
        assert f"LIGHTGBM_TPU_RANK={rank}" in cmd[5]
        assert "LIGHTGBM_TPU_COORDINATOR=10.0.0.1:4001" in cmd[5]
        assert "LIGHTGBM_TPU_NUM_PROCESSES=3" in cmd[5]
        assert cmd[5].endswith("python3 train.py --foo")
    cmd, env = spawned[2]
    assert cmd == ["python3", "train.py", "--foo"]
    assert env["LIGHTGBM_TPU_RANK"] == "2"
    with pytest.raises(ValueError, match="routable"):
        L.launch_hosts(["t.py"], [("localhost", 1), ("10.0.0.9", 1)],
                       _popen=FakeProc)


def test_launcher_main_cpu_flag(monkeypatch):
    from lightgbm_tpu_torch import launch as L
    got = {}
    monkeypatch.setattr(L, "launch", lambda argv, n, coord, cpu=False:
                        got.update(argv=argv, n=n, cpu=cpu) or 0)
    assert L.main(["-n", "2", "--cpu", "s.py", "a"]) == 0
    assert got == {"argv": ["s.py", "a"], "n": 2, "cpu": True}
