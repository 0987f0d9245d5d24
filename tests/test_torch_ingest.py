"""PyTorch port, out-of-core data on the CPU, against the JAX package
(mirrors ``tests/test_ingest.py``):

- fault C7: ``out_of_core=on`` trains chunked, and raises the JAX
  package's ``ValueError`` and reason for a run the chunked builder
  cannot grow (the port used to train resident, silently);
- B1's carried accumulator: ``init`` seeds the sums, exact in int32;
- the sketch laws, and the sketch-fitted mappers equal to the JAX
  package's;
- ``.lgbtpu`` shards: the port's ingest writes the JAX package's bytes,
  shards of either package train in the other with bins equal to the
  JAX Dataset's, corruption is detected, a re-run rewrites only the
  missing shard;
- chunked training against the JAX package's chunked training at
  ``hist_subtraction=false``: float trees, leaf values and predictions
  bit-identical; quantized with bagging, tree structure identical and
  leaf values within 1e-5 relative (the JAX package's split scan
  contracts the int32 descale into FMAs on the CPU, the port rounds
  each op: the gap of ``tests/test_torch_quantized.py``). Across many
  chunks the port's chunked trees are bit-identical to its resident
  two-pass trees;
- the capacity degrade, the prefetcher and the CLI's ``ingest``.
"""

import glob
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.data.ingest import ingest as jax_ingest
from lightgbm_tpu_torch.data import prefetch as port_prefetch
from lightgbm_tpu_torch.data.chunked import ArraySource
from lightgbm_tpu_torch.data.ingest import ingest
from lightgbm_tpu_torch.data.prefetch import ChunkPrefetcher, chunk_rows_for
from lightgbm_tpu_torch.data.shardfile import (ShardFormatError,
                                               open_shard_dir, verify_shard)
from lightgbm_tpu_torch.data.sketch import FeatureSketch, SketchSet
from lightgbm_tpu_torch.ops.cuda_histogram import build_histograms_cuda
from lightgbm_tpu_torch.ops.histogram import build_histograms

CPU = {"device_type": "cpu"}
PARITY = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              min_data_in_leaf=5, verbosity=-1, hist_subtraction=False,
              deterministic=True)
CHUNKED = dict(out_of_core="on", chunk_budget_mb=0.05)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(params):
    """The JAX side of a case: serial, its scatter histograms (the path
    its chunked builder pins)."""
    return dict(params, tree_learner="serial", hist_impl="scatter")


def _parity_data(rng, R=1200, F=8):
    X = rng.normal(size=(R, F))
    X[:, 2] = rng.randint(0, 6, size=R)      # categorical
    X[rng.rand(R) < 0.05, 4] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.2 * X[:, 2] > 0).astype(np.float64)
    return X, y


def _train(mod, params, X, y, rounds=4):
    p = dict(params, **CPU) if mod is lgt else _jax(params)
    return mod.train(dict(p), mod.Dataset(X, label=y, params=dict(p)),
                     num_boost_round=rounds)


def _trees(bst):
    return bst.model_to_string().split("end of trees")[0].split(
        "Tree=", 1)[1]


def _tree_fields(bst, names):
    out = []
    for line in _trees(bst).splitlines():
        key = line.split("=", 1)[0]
        if key in names:
            out.append((key, tuple(float(v) for v in
                                   line.split("=", 1)[1].split())))
    return out


# ---------------------------------------------------------------------
# fault C7: out_of_core was accepted and ignored


def test_out_of_core_on_trains_chunked(rng, monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_FUSED_TRAIN", raising=False)
    X, y = _parity_data(rng, R=600)
    bst = _train(lgt, dict(PARITY, **CHUNKED), X, y, rounds=2)
    gb = bst._gbdt
    assert gb.chunked
    assert gb.train_dd.bins is None            # no resident matrix
    assert not gb.train_set.bins.is_cuda
    assert gb.fused_train_reason == "out-of-core chunk sweeps are " \
                                    "host-driven"


@pytest.mark.parametrize("bad", [
    {"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0]},
    {"linear_tree": True},
    {"extra_trees": True},
])
def test_out_of_core_gate_raises_jax_reason(rng, bad):
    X, y = _parity_data(rng, R=400)
    p = dict(PARITY, **CHUNKED, **bad)
    with pytest.raises(ValueError, match="out_of_core=on") as want:
        _train(lgb, p, X, y, rounds=1)
    with pytest.raises(ValueError, match="out_of_core=on") as got:
        _train(lgt, p, X, y, rounds=1)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------
# B1's carried accumulator (its plain version on the CPU)


@pytest.mark.parametrize("quant", [False, True])
def test_b1_init_carries_the_accumulator(rng, quant):
    R, F, B, L = 700, 5, 16, 4
    bins = torch.from_numpy(rng.randint(0, B, size=(R, F)).astype(np.uint8))
    rl = torch.from_numpy(rng.randint(-1, 3, size=R).astype(np.int32))
    ids = torch.tensor([0, 2, 1, -2], dtype=torch.int32)
    if quant:
        gh = torch.from_numpy(rng.randint(-8, 8, size=(R, 3))
                              .astype(np.int8))
    else:
        gh = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    kw = dict(num_bins=B, hist_dtype="float32")
    whole = build_histograms(bins, gh, rl, ids, **kw)
    first = build_histograms_cuda(bins[:300], gh[:300], rl[:300], ids, **kw)
    carried = build_histograms_cuda(bins[300:], gh[300:], rl[300:], ids,
                                    init=first, **kw)
    rest = build_histograms(bins[300:], gh[300:], rl[300:], ids, **kw)
    assert carried.dtype == (torch.int32 if quant else torch.float32)
    # init plus the chunk's own sums, in that order
    torch.testing.assert_close(carried, first + rest, rtol=0, atol=0)
    if quant:
        assert torch.equal(carried, whole)
    else:
        torch.testing.assert_close(carried, whole, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# sketches


def _mapper_state(m):
    ub = m.bin_upper_bound
    cats = getattr(m, "categories", None)
    return (m.bin_type, m.num_bin, m.missing_type, m.most_freq_bin,
            None if ub is None else np.asarray(ub).tobytes(),
            None if cats is None else np.asarray(cats).tobytes())


def test_sketch_merge_laws_and_mappers_match_jax(rng):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data.sketch import SketchSet as JSketchSet
    from lightgbm_tpu_torch.config import Config
    cols = [rng.normal(size=400) for _ in range(3)]
    cols[1][::7] = np.nan

    def sk(col):
        return FeatureSketch(capacity=64).update(col)

    def state(s):
        return (s.level, s.n_nan, s.values.tobytes(), s.counts.tobytes())
    want = state(sk(cols[0]).merge(sk(cols[1])).merge(sk(cols[2])))
    assert state(sk(cols[0]).merge(sk(cols[1]).merge(sk(cols[2])))) == want
    assert state(sk(cols[2]).merge(sk(cols[1])).merge(sk(cols[0]))) == want
    assert state(sk(np.concatenate(cols))) == want
    # overflowed and exact sketches fit the JAX package's mappers
    X = rng.normal(size=(3000, 4))
    X[::9, 1] = np.nan
    X[:, 2] = rng.randint(0, 12, size=3000)
    for cap in (64, 1 << 16):
        ours, theirs = (S(4, capacity=cap, cat_idx={2})
                        for S in (SketchSet, JSketchSet))
        for lo in range(0, 3000, 700):
            ours.update(X[lo:lo + 700])
            theirs.update(X[lo:lo + 700])
        got = ours.fit_mappers(Config({"max_bin": 63}))
        ref = theirs.fit_mappers(JConfig({"max_bin": 63}))
        assert [_mapper_state(m) for m in got] == \
            [_mapper_state(m) for m in ref]


# ---------------------------------------------------------------------
# shards


def _ingest_both(rng, tmp_path, R=2000, F=5, rows_per_shard=600):
    X = rng.normal(size=(R, F))
    X[::7, 1] = np.nan
    y = (X[:, 0] > 0).astype(np.float64)
    xp, yp = str(tmp_path / "X.npy"), str(tmp_path / "y.npy")
    np.save(xp, X)
    np.save(yp, y)
    p = {"max_bin": 63, "ingest_rows_per_shard": rows_per_shard}
    ours = str(tmp_path / "port")
    theirs = str(tmp_path / "jax")
    summary = ingest(xp, ours, params=dict(p, **CPU), label=yp,
                     verbose=False)
    jax_ingest(xp, theirs, params=p, label=yp, verbose=False)
    return X, y, xp, yp, ours, theirs, summary


def test_shards_are_the_jax_bytes_and_train_in_both(rng, tmp_path):
    X, y, _, _, ours, theirs, summary = _ingest_both(rng, tmp_path)
    assert summary["num_shards"] == 4
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    for n in names:
        with open(os.path.join(ours, n), "rb") as a, \
                open(os.path.join(theirs, n), "rb") as b:
            assert a.read() == b.read(), n
    tp = dict(PARITY, chunk_budget_mb=0.05, max_bin=63)
    # either package's shards, read by the other: bins equal to the JAX
    # Dataset's of the same shards
    ref = lgb.Dataset(theirs, params=dict(tp)).construct()
    got = lgt.Dataset(theirs, params=dict(tp, **CPU)).construct()
    assert np.array_equal(got.bins.numpy(), np.asarray(ref.bins))
    np.testing.assert_array_equal(got.get_label(), y)
    # shard-backed under out_of_core=auto: streamed, trees equal to the
    # JAX package's from its own shards
    bt = lgt.train(dict(tp, **CPU), lgt.Dataset(ours, params=dict(
        tp, **CPU)), 3)
    bj = lgb.train(_jax(tp), lgb.Dataset(theirs, params=dict(tp)), 3)
    assert bt._gbdt.chunked and bj._gbdt.chunked
    assert _trees(bt) == _trees(bj)
    np.testing.assert_array_equal(bt.predict(X), bj.predict(X))


def test_shard_corruption_and_ingest_retry(rng, tmp_path):
    X, y, xp, yp, ours, _, _ = _ingest_both(rng, tmp_path)
    readers, h0 = open_shard_dir(ours)
    assert h0["total_rows"] == len(X)
    mappers = readers[0].mappers()
    want = np.stack([mappers[f].values_to_bins(X[:600, f])
                     for f in h0["used_features"]], axis=1)
    np.testing.assert_array_equal(np.asarray(readers[0].read_rows(0, 600)),
                                  want)
    for r in readers:
        r.close()
    shards = sorted(glob.glob(os.path.join(ours, "*.lgbtpu")))
    os.unlink(shards[1])
    keep = {p: os.path.getmtime(p) for p in shards if p != shards[1]}
    again = ingest(xp, ours, params={"max_bin": 63, **CPU,
                                     "ingest_rows_per_shard": 600},
                   label=yp, verbose=False)
    assert again["shards_written"] == 1
    assert again["shards_reused"] == len(shards) - 1
    assert all(os.path.getmtime(p) == t for p, t in keep.items())
    with open(shards[2], "r+b") as f:
        f.seek(200)
        f.write(b"\x00\xff\x00\xff")
    assert not verify_shard(shards[2])
    with pytest.raises(ShardFormatError):
        lgt.Dataset(ours, params=dict(CPU)).construct()


def test_cli_ingest_writes_shards(rng, tmp_path, capsys):
    from lightgbm_tpu_torch.cli import main
    X = rng.normal(size=(500, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    csv = tmp_path / "d.csv"
    np.savetxt(csv, np.column_stack([y, X]), delimiter=",", fmt="%.6f")
    out = tmp_path / "sh"
    assert main(["ingest", f"data={csv}", f"out={out}", "device_type=cpu",
                 "ingest_rows_per_shard=200"]) == 0
    assert "3 shards" in capsys.readouterr().out
    ds = lgt.Dataset(str(out), params=dict(CPU)).construct()
    ref = lgt.Dataset(str(csv), params=dict(CPU)).construct()
    assert np.array_equal(ds.bins.numpy(), ref.bins.numpy())


# ---------------------------------------------------------------------
# chunked training against the JAX package's


def test_chunked_float_bit_identical_to_jax(rng):
    X, y = _parity_data(rng)
    p = dict(PARITY, **CHUNKED, bagging_fraction=0.7, bagging_freq=1,
             bagging_seed=7)
    ours, theirs = _train(lgt, p, X, y), _train(lgb, p, X, y)
    assert ours._gbdt.chunked and theirs._gbdt.chunked
    assert _trees(ours) == _trees(theirs)
    np.testing.assert_array_equal(ours.predict(X, raw_score=True),
                                  theirs.predict(X, raw_score=True))


def test_chunked_quantized_bagging_matches_jax(rng):
    X, y = _parity_data(rng)
    p = dict(PARITY, **CHUNKED, use_quantized_grad=True,
             bagging_fraction=0.7, bagging_freq=1, bagging_seed=7,
             min_gain_to_split=1e-3)
    ours, theirs = _train(lgt, p, X, y), _train(lgb, p, X, y)
    assert ours._gbdt.chunked
    structure = ("num_leaves", "split_feature", "threshold",
                 "decision_type", "left_child", "right_child",
                 "leaf_count", "internal_count")
    assert _tree_fields(ours, structure) == _tree_fields(theirs, structure)
    for (k, a), (_, b) in zip(_tree_fields(ours, ("leaf_value",)),
                              _tree_fields(theirs, ("leaf_value",))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("extra", [
    {},
    {"use_quantized_grad": True, "bagging_fraction": 0.7,
     "bagging_freq": 1, "bagging_seed": 7, "hist_subtraction": True},
], ids=["float", "quantized_hist_sub"])
def test_many_chunks_equal_resident(rng, monkeypatch, extra):
    """Five chunks of 256 rows a sweep: the carried accumulator gives
    the port's resident two-pass trees bit for bit."""
    X, y = _parity_data(rng)
    p = dict(PARITY, fused_split="off", **extra)
    ref = _train(lgt, p, X, y)
    monkeypatch.setattr(port_prefetch, "chunk_rows_for", lambda *a: 256)
    bst = _train(lgt, dict(p, **CHUNKED), X, y)
    assert bst._gbdt._prefetcher.num_chunks == 5
    assert _trees(bst) == _trees(ref)


def test_capacity_overflow_degrades_to_chunked(rng, monkeypatch):
    X, y = _parity_data(rng, R=800)
    ref = _train(lgt, PARITY, X, y, rounds=3)
    monkeypatch.setenv("LIGHTGBM_TPU_DEVICE_MEM_GB", "0.000001")
    bst = _train(lgt, PARITY, X, y, rounds=3)
    assert bst._gbdt.chunked
    np.testing.assert_array_equal(bst.predict(X), ref.predict(X))
    with pytest.raises(MemoryError):
        _train(lgt, dict(PARITY, out_of_core="off"), X, y, rounds=1)


# ---------------------------------------------------------------------
# geometry and the prefetcher


def test_chunk_rows_match_jax():
    from lightgbm_tpu.data.prefetch import chunk_rows_for as jax_rows
    for args in [(100_000, 28, 1, 0.05, 64), (100_000, 28, 1, 4.0, 256),
                 (10_500_000, 28, 1, 64.0, 16384), (100, 4, 1, 1e9, 64)]:
        assert chunk_rows_for(*args) == jax_rows(*args)
        c = chunk_rows_for(*args)
        assert c % args[4] == 0


def test_prefetcher_sweeps_every_row(rng):
    bins = rng.randint(0, 16, size=(777, 3)).astype(np.uint8)
    pref = ChunkPrefetcher(ArraySource(bins), chunk_rows=256)
    try:
        for _ in range(2):        # a second sweep starts from row 0 again
            got = [(off, c.numpy().copy()) for off, c in pref.chunks()]
            assert [o for o, _ in got] == [0, 256, 512, 768]
            np.testing.assert_array_equal(
                np.concatenate([c for _, c in got])[:777], bins)
            assert got[-1][1].shape == (256, 3)
            assert not got[-1][1][777 - 768:].any()   # zero-padded tail
        assert pref.stats.chunks == 8
        assert pref.stats.bytes == 8 * 256 * 3
        assert 0.0 <= pref.stats.overlap_fraction() <= 1.0
    finally:
        pref.close()
