"""PyTorch port, the ranking objectives on the CPU: ``lambdarank`` and
``rank_xendcg`` (``lightgbm_tpu_torch/ranking.py``) against the JAX
package's (``lightgbm_tpu/ranking.py``), on queries made from a seeded
numpy RNG (~2,000 rows in 60 queries of 1-80 documents, with a
one-document query, a query whose labels are all 0 and one whose labels
are all equal):

- ``get_gradients`` within 1e-5 of each array's largest magnitude (the
  two packages' ``exp``/``log2`` and sum orders differ in the last bits),
  with and without ``lambdarank_norm``, with a truncation below the
  widest query, with weights, at iteration 0's all-tied scores and at
  random scores; ``rank_xendcg``'s draws bit-equal;
- the bucketed lattice against the port's own single ``[Q, S_max]``
  lattice, within 1e-6 relative;
- 10 rounds of ``train``, eager and through the step: tree structures
  equal and valid NDCG within 1e-6 (at ``hist_dtype=float32``: a
  gradient an ulp apart can round to another bf16 addend);
- position-bias factors within 1e-5, ``bagging_by_query`` masks equal,
  and the Dataset's ``group``/``position``/``init_score`` fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import ranking as jax_ranking
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu_torch import convert, ranking
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import threefry

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
        "min_data_in_leaf": 10, "learning_rate": 0.2, "verbosity": -1,
        "metric": "ndcg", "eval_at": [3, 10], "hist_dtype": "float32"}


def _queries(rng, nq=60, f=6):
    sizes = rng.randint(1, 81, size=nq)
    sizes[3] = 1                                   # a one-document query
    n = int(sizes.sum())
    X = rng.normal(size=(n, f))
    y = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1]
                         + rng.normal(scale=0.7, size=n) + 1), 0, 4)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    y[qb[5]:qb[6]] = 0              # all labels 0: inverse_max_dcg 0
    y[qb[6]:qb[7]] = 2              # all labels equal: no pair
    return X, y, sizes


def _objectives(name, extra, y, sizes, weight=None):
    p = {"objective": name, **extra}
    qb = np.concatenate([[0], np.cumsum(sizes)])
    cls = {"lambdarank": (jax_ranking.LambdaRank, ranking.LambdaRank),
           "rank_xendcg": (jax_ranking.RankXENDCG, ranking.RankXENDCG)}
    jo = cls[name][0](JaxConfig(p))
    jo.init(y, weight, qb)
    to = cls[name][1](Config(p))
    to.init(y, weight, qb)
    return jo, to


GRAD_CASES = {
    "lambdarank": ("lambdarank", {}),
    "no_norm": ("lambdarank", {"lambdarank_norm": False}),
    "truncated": ("lambdarank", {"lambdarank_truncation_level": 12}),
    "sigmoid_gain": ("lambdarank", {"sigmoid": 1.5,
                                    "label_gain": [0, 1, 3, 7, 15, 40]}),
    "rank_xendcg": ("rank_xendcg", {}),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradients_match_jax(rng, case, weighted):
    name, extra = GRAD_CASES[case]
    _, y, sizes = _queries(rng)
    n = len(y)
    R = n + 37                                     # padded rows score 0
    w = rng.uniform(0.5, 2.0, size=n) if weighted else None
    jo, to = _objectives(name, extra, y, sizes, w)
    if name == "lambdarank":
        assert to.inverse_max_dcg[5] == 0.0
    lab = np.pad(y, (0, R - n)).astype(np.float32)
    wp = None if w is None else np.pad(w, (0, R - n)).astype(np.float32)
    # iteration 0: every score equal, one long tie a query
    for it, score in ((0, np.full(R, 0.3, np.float32)),
                      (3, rng.normal(size=R).astype(np.float32))):
        jg, jh = jo.get_gradients(
            jnp.asarray(score), jnp.asarray(lab),
            None if wp is None else jnp.asarray(wp),
            it=jnp.asarray(it, jnp.int32))
        tg, th = to.get_gradients(
            torch.from_numpy(score), torch.from_numpy(lab),
            None if wp is None else torch.from_numpy(wp),
            it=torch.tensor(it))
        for j, t in ((np.asarray(jg), tg.numpy()), (np.asarray(jh),
                                                    th.numpy())):
            scale = np.abs(j).max()
            assert scale > 0
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * scale)
            assert (t[n:] == 0).all()


@pytest.mark.parametrize("it", [0, 7])
def test_xendcg_draws_bit_equal(rng, it):
    _, y, sizes = _queries(rng)
    shape = (len(sizes), int(sizes.max()))
    want = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(5),
                                                 jnp.asarray(it, jnp.int32)),
                              shape)
    got = threefry.uniform(threefry.fold_in(threefry.prng_key(5),
                                            torch.tensor(it)), shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_bucketed_lattice_matches_single_lattice(rng, name):
    _, y, sizes = _queries(rng)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    n = len(y)
    _, bucketed = _objectives(name, {}, y, sizes)
    _, single = _objectives(name, {}, y, sizes)
    single.chunks = ranking.bucket_plan(qb, single=True)
    assert len(single.chunks) == 1
    assert single.chunks[0].rows.shape == (len(sizes), sizes.max())
    # a small budget cuts the buckets into chunks of a few queries
    _, chunked = _objectives(name, {}, y, sizes)
    chunked.chunks = ranking.bucket_plan(qb, budget=64 * 64 * 4 * 3)
    widths = sorted({c.rows.shape[1] for c in bucketed.chunks})
    assert widths[0] == 16 and widths[-1] == sizes.max()
    assert all(w in (16, 32, 64, sizes.max()) for w in widths)
    assert len(chunked.chunks) > len(bucketed.chunks)
    for c in chunked.chunks:
        assert c.rows.shape[0] * c.rows.shape[1] ** 2 * 4 \
            <= 64 * 64 * 4 * 3 or c.rows.shape[0] == 1
    score = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    lab = torch.from_numpy(y.astype(np.float32))
    it = torch.tensor(2)
    ref = single.get_gradients(score, lab, None, it=it)
    for obj in (bucketed, chunked):
        got = obj.get_gradients(score, lab, None, it=it)
        for a, b in zip(got, ref):
            scale = b.abs().max().item()
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * scale)


def _train_pair(rng, extra, rounds=10, position=False, fused=False,
                monkeypatch=None):
    X, y, sizes = _queries(rng)
    Xv, yv, sv = _queries(rng, nq=20)
    pos = (np.concatenate([np.arange(s) % 10 for s in sizes])
           if position else None)
    p = {**BASE, **extra}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, group=sizes, position=pos, params=jp)
    jva = lgb.Dataset(Xv, label=yv, group=sv, reference=jtr)
    jrec = {}
    jb = lgb.train(jp, jtr, rounds, valid_sets=[jva], valid_names=["v"],
                   callbacks=[lgb.record_evaluation(jrec)])
    tp = {**p, **CPU}
    tr = lgt.Dataset(X, label=y, group=sizes, position=pos, params=tp,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    va = lgt.Dataset(Xv, label=yv, group=sv, reference=tr)
    trec = {}
    if fused:
        monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1")
    tb = lgt.train(tp, tr, rounds, valid_sets=[va], valid_names=["v"],
                   callbacks=[lgt.record_evaluation(trec)])
    return jb, jrec, tb, trec


def _same_trees(jb, tb):
    jt, tt = jb._gbdt.models, tb._trees
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert a.num_leaves == b.num_leaves
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_bin, b.threshold_bin)
        np.testing.assert_array_equal(a.left_child, b.left_child)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_ranking_train_matches_jax(rng, monkeypatch, name, fused):
    jb, jrec, tb, trec = _train_pair(rng, {"objective": name},
                                     fused=fused, monkeypatch=monkeypatch)
    assert tb._gbdt.fused_train_ok == fused
    _same_trees(jb, tb)
    for m in ("ndcg@3", "ndcg@10"):
        np.testing.assert_allclose(trec["v"][m], jrec["v"][m], rtol=0,
                                   atol=1e-6)
    assert trec["v"]["ndcg@10"][-1] > trec["v"]["ndcg@10"][0]


def test_position_bias_matches_jax(rng, monkeypatch):
    # the step is allowed, and the position bias alone pins the eager loop
    jb, jrec, tb, trec = _train_pair(
        rng, {"objective": "lambdarank",
              "lambdarank_position_bias_regularization": 0.5},
        rounds=5, position=True, fused=True, monkeypatch=monkeypatch)
    g = tb._gbdt
    assert g.fused_train_reason == \
        "position-bias estimation updates host state"
    got = g.objective.pos_biases.numpy()
    want = np.asarray(jb._gbdt.objective.pos_biases)
    assert got.shape == (10,) and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    _same_trees(jb, tb)


def test_bagging_by_query_masks_match_jax(rng):
    X, y, sizes = _queries(rng)
    p = {**BASE, "objective": "lambdarank", "bagging_freq": 2,
         "bagging_fraction": 0.5, "bagging_by_query": True}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, group=sizes, params=jp)
    jb = lgb.Booster(params=jp, train_set=jtr)
    jb._ensure_gbdt()
    tb = lgt.Booster(params={**p, **CPU},
                     train_set=lgt.Dataset(X, label=y, group=sizes,
                                           params={**p, **CPU}))
    tb._ensure_gbdt()
    qb = np.concatenate([[0], np.cumsum(sizes)])
    n = len(y)
    for it in range(6):
        want = np.asarray(jb._gbdt._host_bag_mask(it))
        got = tb._gbdt._host_bag_mask(it)
        if it % 2:
            assert got is None
            continue
        np.testing.assert_array_equal(got[:n], want[:n].astype(np.uint8))
        # whole queries in or out
        per_q = np.add.reduceat(got[:n].astype(int), qb[:-1])
        assert set(np.unique(per_q / sizes)) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="query/group"):
        lgt.train({**p, **CPU, "objective": "regression", "metric": "l2"},
                  lgt.Dataset(X, label=y, params=CPU), 1)


def test_dataset_group_position_init_score_fields(rng):
    X, y, sizes = _queries(rng, nq=12)
    n = len(y)
    pos = rng.randint(0, 5, size=n)
    isc = rng.normal(size=n)
    ds = lgt.Dataset(X, label=y, group=sizes, params=CPU)
    ds.set_field("position", pos)
    ds.set_field("init_score", isc)
    np.testing.assert_array_equal(ds.get_group(), sizes)
    np.testing.assert_array_equal(ds.position, pos)
    np.testing.assert_array_equal(ds.get_init_score(), isc)
    np.testing.assert_array_equal(ds.query_boundaries(),
                                  np.concatenate([[0], np.cumsum(sizes)]))
    ds.construct()
    jds = lgb.Dataset(X, label=y, group=sizes, position=pos,
                      init_score=isc).construct()
    idx = np.concatenate([np.arange(0, 30), np.arange(50, 90)])
    sub, jsub = ds.subset(idx), jds.subset(idx)
    np.testing.assert_array_equal(sub.get_group(), jsub.get_group())
    np.testing.assert_array_equal(sub.position, pos[idx])
    np.testing.assert_array_equal(sub.get_init_score(), isc[idx])
    np.testing.assert_array_equal(sub.bins.numpy(), ds.bins.numpy()[idx])
    assert sub.num_data == len(idx) and sub.get_group().sum() == len(idx)
    ds.set_field("group", None)
    assert ds.query_boundaries() is None
    with pytest.raises(ValueError, match="Unknown field"):
        ds.set_field("nope", 1)
    with pytest.raises(ValueError, match="group"):
        lgt.Dataset(X, label=y, group=sizes[:-1], params=CPU).construct()
    with pytest.raises(ValueError, match="query"):
        lgt.train({**BASE, **CPU, "objective": "lambdarank"},
                  lgt.Dataset(X, label=y, params=CPU), 1)
