"""PyTorch port, the parallel learners at the tree-builder level against
the JAX package's plans (mirrors ``tests/test_parallel.py`` and
``tests/test_reduce_scatter.py``), and the collective layer's record.

The JAX side runs in this process, each plan on 2 of the 8 virtual CPU
devices (``DataParallelPlan(devices=jax.devices()[:2])`` and its
siblings). The port's side runs as 2 pure-torch ranks under gloo, in
one group for the whole module: ``python -m lightgbm_tpu_torch.launch
-n 2 --cpu`` runs a rank program that builds every case and writes its
results (the launcher runs as its file, importing only the standard
library); rank r holds rows ``[r * R/2, (r + 1) * R/2)``, the block the
JAX ``shard_rows`` gives device r (all rows for the feature learner).
The group is joined with a timeout of its own and killed on expiry, so
a hung rank fails these tests, not the suite.

Contract: the JAX plan's tree on the same seeded inputs, at
``hist_dtype=float32``: split features, threshold bins, default
directions, categorical flags, bitsets, children, leaf maps and
``row_leaf`` equal; leaves and node values within rtol 1e-5. With 2
ranks every merged cell is one f32 add on both sides, so the merged
sums agree, but the split scan's cumulative bin sums run in another
order in XLA than in the port: on these inputs the two packages' SERIAL
builders already part by 1.6e-6 relative at the leaves, and the plans
by at most 2.7e-6, so the serial builders' contract (rtol 1e-5) is the
one that holds. Both ranks hold the same tree, bit for bit. Under EFB the
most-frequent bin is rebuilt as a difference of sums, which the
packages also order differently: there the serial EFB contract of
``tests/test_torch_efb.py`` (rtol 1e-5 with atol 1e-5 of the largest
leaf) applies, and it is the tolerance used throughout.

Cases: data with ``allreduce`` and ``reduce_scatter``, feature, voting
at ``top_k=3`` under ``reduce_scatter`` (the elected columns' scatter),
and EFB bundles under ``reduce_scatter`` (the bundle-axis scatter); the
shared matrix has NaN bins and one-hot categorical columns. Quantized
learners are held to the serial model end to end
(``tests/test_torch_distributed.py``). The ranks build while this process
compiles the JAX plans.
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

# the inputs, made from a seed with numpy on both sides
_DATA_SRC = textwrap.dedent('''
    import numpy as np

    R, F, B = 1024, 13, 32
    CAT = (5, 6)        # one-hot categorical columns (4 bins)
    NAN = (3, 4)        # columns whose last bin is the NaN bin

    def case_inputs(name):
        rng = np.random.RandomState(11)
        bins = rng.randint(0, B, size=(R, F)).astype(np.uint8)
        for f in CAT:
            bins[:, f] = rng.randint(0, 4, size=R)
        g = rng.normal(size=R).astype(np.float32)
        h = rng.uniform(0.5, 1.5, size=R).astype(np.float32)
        gh = np.stack([g, h, np.ones(R, np.float32)], 1)
        nbpf = np.full(F, B, np.int32)
        nbpf[list(CAT)] = 4
        nan = np.full(F, -1, np.int32)
        nan[list(NAN)] = B - 1
        cat = np.zeros(F, bool)
        cat[list(CAT)] = True
        meta = (nbpf, nan, cat, np.ones(F, bool))
        return bins, gh, meta

    def exclusive_X(n=1024, F=12):
        rng = np.random.RandomState(5)
        X = np.zeros((n, F))
        perm = rng.permutation(n)
        for f in range(F):
            rows = perm[f * (n // F):(f + 1) * (n // F)]
            X[rows, f] = rng.normal(size=len(rows)) + 1.0
        y = (X[:, 0] - X[:, 1] + 0.3 * X[:, 2] > 0.2).astype(float)
        return X, y

    # name -> (parallel_mode, hist_merge, top_k)
    CASES = {
        "data/allreduce": ("data", "allreduce", 20),
        "data/reduce_scatter": ("data", "reduce_scatter", 20),
        "feature": ("feature", "", 20),
        "voting/reduce_scatter": ("voting", "reduce_scatter", 3),
        "efb/reduce_scatter": ("data", "reduce_scatter", 20),
    }
    KW = dict(num_leaves=15, leaf_batch=4, max_depth=-1,
              hist_dtype="float32")
''')
exec(_DATA_SRC)

_RANKS_SRC = _DATA_SRC + textwrap.dedent('''
    import pickle
    import sys

    import torch

    sys.path.insert(0, sys.argv[2])
    torch.set_num_threads(1)
    from lightgbm_tpu_torch import Dataset
    from lightgbm_tpu_torch.boosting.tree_builder import build_tree
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.parallel import init_distributed
    from lightgbm_tpu_torch.parallel.comms import Comm, hist_bytes_per_tree

    init_distributed()
    SP = SplitParams(min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3)
    out = {}
    for name, (mode, hm, top_k) in CASES.items():
        comm = Comm(None, label=name)
        kw = dict(KW, split_params=SP, comm=comm, parallel_mode=mode,
                  hist_merge=hm, top_k=top_k)
        if name.startswith("efb"):
            X, y = exclusive_X()
            ds = Dataset(X, label=y, params={
                "device_type": "cpu", "tree_learner": "serial",
                "verbosity": -1}).construct()
            bp = ds.bundle_plan
            bins = ds.bins.numpy()
            rng = np.random.RandomState(2)
            n = bins.shape[0]
            gh = np.stack([rng.normal(size=n), rng.uniform(0.5, 1.5, n),
                           np.ones(n)], 1).astype(np.float32)
            meta = (ds.per_feature_num_bins(), ds.per_feature_nan_bins(),
                    ds.per_feature_is_categorical(),
                    np.ones(len(ds.used_features), bool))
            kw.update(bundle_meta=tuple(torch.from_numpy(
                np.asarray(a, np.int32)) for a in (
                    bp.feat_bundle, bp.feat_offset, bp.feat_mfb)),
                bundle_bins=int(bp.max_bundle_bins))
            nb = int(ds.max_num_bin)
        else:
            bins, gh, meta = case_inputs(name)
            nb = B
        n = bins.shape[0]
        rows = (slice(0, n) if mode == "feature" else
                slice(comm.rank * n // 2, (comm.rank + 1) * n // 2))
        t, rl, _ = build_tree(
            torch.from_numpy(bins[rows]), torch.from_numpy(gh[rows]),
            torch.zeros(rows.stop - rows.start, dtype=torch.int32),
            *(torch.from_numpy(np.asarray(m)) for m in meta),
            num_bins=nb, **kw)
        rep = comm.report
        out[name] = dict(
            tree={f: getattr(t, f).numpy() for f in t._fields},
            row_leaf=rl.numpy(), rows=(rows.start, rows.stop),
            hist_bytes=rep.hist_result_bytes,
            hist_kinds=sorted({o.kind for o in rep.hist_ops}),
            winner_syncs=sum(o.is_winner_sync for o in rep.ops),
            per_tree=hist_bytes_per_tree(rep, KW["num_leaves"],
                                         KW["leaf_batch"]))
    with open(f"{sys.argv[1]}/rank{comm.rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
''')

GROUP_TIMEOUT_S = 240


class RankGroup:
    """``program`` run as ``n`` CPU ranks under the port's launcher, in
    a session of its own; :meth:`wait` joins it, and kills the whole
    session once ``timeout`` seconds have passed since the start. The
    launcher runs as the file ``lightgbm_tpu_torch/launch.py`` (its
    ``main``, as ``python -m lightgbm_tpu_torch.launch`` runs it): it
    imports only the standard library, so the group pays for no import
    of the package outside its ranks."""

    def __init__(self, tmp_path, program: str, n: int = 2,
                 timeout: float = GROUP_TIMEOUT_S, extra_env=None):
        import time
        script = tmp_path / "ranks.py"
        script.write_text(program)
        env = dict(os.environ, LIGHTGBM_TPU_DIST_TIMEOUT_S="60")
        env.update(extra_env or {})
        self.tmp, self.n = tmp_path, n
        self.deadline = time.monotonic() + timeout
        self.p = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "lightgbm_tpu_torch",
                                          "launch.py"), "-n",
             str(n), "--cpu", str(script), str(tmp_path), ROOT],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, start_new_session=True)
        self.rc = self.out = self._res = None

    def wait(self):
        """(exit code, output); fails the test on a hang."""
        import time
        if self.rc is None:
            try:
                out, _ = self.p.communicate(
                    timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                os.killpg(self.p.pid, signal.SIGKILL)
                out, _ = self.p.communicate()
                self.rc, self.out = -9, out.decode()
                pytest.fail("rank group hung past its timeout: "
                            + self.out[-2000:])
            self.rc, self.out = self.p.returncode, out.decode()
        return self.rc, self.out

    def results(self):
        """Every rank's pickled results, in rank order."""
        if self._res is None:
            rc, out = self.wait()
            assert rc == 0, out[-3000:]
            self._res = []
            for r in range(self.n):
                with open(self.tmp / f"rank{r}.pkl", "rb") as fh:
                    self._res.append(pickle.load(fh))
        return self._res


@pytest.fixture(scope="module")
def port_ranks(tmp_path_factory):
    g = RankGroup(tmp_path_factory.mktemp("ranks"), _RANKS_SRC)
    yield g
    if g.p.poll() is None:
        os.killpg(g.p.pid, signal.SIGKILL)
        g.p.communicate()


def _jax_tree(name):
    import jax
    import jax.numpy as jnp

    from lightgbm_tpu.ops.split import SplitParams
    from lightgbm_tpu.parallel.data_parallel import (DataParallelPlan,
                                                     FeatureParallelPlan,
                                                     VotingParallelPlan)
    mode, hm, top_k = CASES[name]
    devs = jax.devices()[:2]
    plan = {"data": lambda: DataParallelPlan(devs, hist_merge=hm),
            "voting": lambda: VotingParallelPlan(devs, top_k=top_k,
                                                 hist_merge=hm),
            "feature": lambda: FeatureParallelPlan(devs)}[mode]()
    kw = dict(KW, split_params=SplitParams(min_data_in_leaf=5,
                                           min_sum_hessian_in_leaf=1e-3),
              hist_impl="scatter")
    if name.startswith("efb"):
        import lightgbm_tpu as lgb
        X, y = exclusive_X()
        ds = lgb.Dataset(X, label=y, params={"verbosity": -1}).construct()
        bp = ds.bundle_plan
        bins = np.asarray(ds.bins)
        rng = np.random.RandomState(2)
        n = bins.shape[0]
        gh = np.stack([rng.normal(size=n), rng.uniform(0.5, 1.5, n),
                       np.ones(n)], 1).astype(np.float32)
        meta = (ds.per_feature_num_bins(), ds.per_feature_nan_bins(),
                ds.per_feature_is_categorical(),
                np.ones(len(ds.used_features), bool))
        kw.update(bundle_meta=tuple(jnp.asarray(a, jnp.int32) for a in (
            bp.feat_bundle, bp.feat_offset, bp.feat_mfb)),
            bundle_bins=int(bp.max_bundle_bins))
        nb = int(ds.max_num_bin)
    else:
        bins, gh, meta = case_inputs(name)
        nb = B
    n = bins.shape[0]
    t, rl, _ = plan.build_tree(
        plan.shard_bins(bins), plan.shard_rows(gh),
        plan.shard_rows(np.zeros(n, np.int32)),
        *(jnp.asarray(m) for m in meta), num_bins=nb,
        block_rows=n // 2, **kw)
    return jax.device_get(t), np.asarray(rl)


_EXACT = ("split_feature", "threshold_bin", "default_left", "is_cat",
          "left_child", "right_child", "leaf2node", "num_leaves",
          "num_nodes")


@pytest.mark.parametrize("name", list(CASES))
def test_plan_tree_matches_jax_plan(port_ranks, name):
    jt, jrl = _jax_tree(name)
    r0, r1 = (port_ranks.results()[r][name] for r in range(2))
    for fld in r0["tree"]:
        np.testing.assert_array_equal(r0["tree"][fld], r1["tree"][fld],
                                      err_msg=f"ranks differ on {fld}")
    assert int(jt.num_leaves) > 4
    for fld in _EXACT:
        np.testing.assert_array_equal(
            r0["tree"][fld], np.asarray(getattr(jt, fld)),
            err_msg=f"{name}: {fld}")
    bits = np.asarray(jt.cat_bitset).astype(np.int64)
    np.testing.assert_array_equal(r0["tree"]["cat_bitset"], bits)
    for fld in ("leaf_values", "node_value", "node_count", "node_hess"):
        want = np.asarray(getattr(jt, fld))
        np.testing.assert_allclose(
            r0["tree"][fld], want, rtol=1e-5,
            atol=1e-5 * np.abs(want).max(), err_msg=f"{name}: {fld}")
    for r in (r0, r1):
        lo, hi = r["rows"]
        np.testing.assert_array_equal(r["row_leaf"], jrl[lo:hi])


# ------------------------------------------------ the collective record
def test_collective_record(port_ranks):
    """Histogram traffic by learner: reduce-scatter materializes half of
    allreduce's merged columns per rank at world 2 (F = 13 pads to 14:
    7 of 13 columns), the feature learner merges no histogram at all
    and syncs winners instead, and the bytes of one tree equal
    ``hist_bytes_per_tree``'s count from the shapes of its first round
    (the builder runs every round, as the JAX count assumes)."""
    r = port_ranks.results()[0]
    ar, rs = r["data/allreduce"], r["data/reduce_scatter"]
    assert ar["hist_kinds"] == ["all-reduce"]
    assert rs["hist_kinds"] == ["reduce-scatter"]
    assert rs["hist_bytes"] * F == ar["hist_bytes"] * 7
    assert ar["winner_syncs"] == 0 and rs["winner_syncs"] > 0
    feat = r["feature"]
    assert feat["hist_bytes"] == 0 and feat["hist_kinds"] == []
    assert feat["winner_syncs"] > 0
    for name in CASES:
        assert r[name]["per_tree"] == r[name]["hist_bytes"], name
    # voting merges only the 2 * top_k = 6 elected columns, 3 a rank
    vr = r["voting/reduce_scatter"]
    assert vr["hist_kinds"] == ["reduce-scatter"]
    assert 0 < vr["hist_bytes"] < rs["hist_bytes"]


def test_hist_merge_resolution(monkeypatch):
    from lightgbm_tpu_torch.parallel.data_parallel import resolve_hist_merge
    assert resolve_hist_merge("auto", 2) == "reduce_scatter"
    assert resolve_hist_merge("auto", 1) == "allreduce"
    assert resolve_hist_merge("allreduce", 2) == "allreduce"
    with pytest.raises(ValueError):
        resolve_hist_merge("ring", 2)
    monkeypatch.setenv("LIGHTGBM_TPU_DP_HIST_MERGE", "allreduce")
    assert resolve_hist_merge("auto", 2) == "allreduce"


def test_report_accounting():
    """The report's methods on hand-made records (the JAX report's
    rules: wire bytes under ring algorithms, the full-histogram
    all-reduce filter, the per-plan table)."""
    from lightgbm_tpu_torch.parallel.comms import (CollectiveOp, CommReport,
                                                   render_table)
    ops = [CollectiveOp("all-reduce", "float32", (8, 4, 2, 3), 768,
                        "hist_merge", 1, -1),
           CollectiveOp("reduce-scatter", "float32", (4, 4, 2, 3), 384,
                        "hist_merge", 1, 0),
           CollectiveOp("all-reduce", "float32", (8,), 32, "winner_sync",
                        1, 0)]
    rep = CommReport("x", 2, ops)
    assert rep.count() == 3 and rep.count("all-reduce") == 2
    assert rep.bytes_by_kind() == {"all-reduce": 800,
                                   "reduce-scatter": 384}
    assert rep.hist_result_bytes == 1152
    assert rep.hist_wire_bytes == 768 + 384
    assert rep.full_hist_allreduces(100) == [ops[0]]
    table = render_table({"data/rs": rep})
    assert "data/rs" in table and "reduce-scatter" in table
