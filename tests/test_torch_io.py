"""PyTorch port, file inputs, the binary Dataset cache and the CLI on the
CPU, against the JAX package (``lightgbm_tpu.io``, ``Dataset`` and
``cli``) on files written from a seeded numpy RNG:

- ``io.load_data_file``: CSV with a header, named label/weight/ignore
  columns and ``.weight``/``.init``/``.query``/``.position`` sidecars;
  ragged TSV with ``NA``/``null``/empty tokens; LibSVM with a width
  hint, and with a token that is not ``idx:value``; space-delimited; the matrix, label, sidecars and names bit-equal
  to the JAX parse (its C parser where it builds, else its Python one);
- a ``Dataset`` from a file: bins equal to the JAX ``Dataset``'s, a
  LibSVM valid file narrower than its train set padded with zeros, and
  a malformed ``.lgbtpu`` shard refused as the JAX package refuses it;
- the binary cache in both directions (the port loads the JAX package's
  file and the JAX package loads the port's), with EFB bundles and
  pandas categories: bins, mappers, bundle plan and
  ``pandas_categorical`` equal;
- ``add_features_from`` (bins and de-duplicated names equal to the JAX
  package's), ``Sequence`` input (bins equal, and a valid Sequence
  encoded into its bundled train set's layout);
- ``Booster.predict`` on a file path, equal to the matrix's;
- the CLI: ``run`` with train, predict, save_binary, refit and
  convert_model in process (trees equal to the JAX CLI's; the model text
  equal to an in-process ``train`` on a Dataset of the same file; the
  tree built from the ``.bin`` equal to the CSV's), two
  ``python -m lightgbm_tpu_torch`` subprocesses (train; ``serve``
  answering ``/predict`` with the model's predictions and draining on
  SIGTERM), and the ``convert_model`` C compiled with gcc, its raw
  scores within 1e-12 of ``predict``.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import cli as jcli
from lightgbm_tpu import io as jio
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import io as tio
from lightgbm_tpu_torch.config import Config as TConfig

CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "leaf_batch": 4, "max_bin": 16,
        "min_data_in_leaf": 10, "learning_rate": 0.2, "verbosity": -1,
        "tree_learner": "serial", "hist_impl": "scatter"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64),
                                                 b.view(np.int64))


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def _write_csv(path, rng, n=600):
    """y, w, id and five features, one of them with NaN, in repr
    precision, with a header."""
    X = rng.normal(size=(n, 5)) * 10.0 ** rng.randint(-3, 4, size=(n, 5))
    X[rng.rand(n) < 0.1, 2] = np.nan
    y = (X[:, 0] > 0).astype(float)
    w = rng.uniform(0.5, 2.0, n)
    with open(path, "w") as f:
        f.write("y,w,id,a,b,c,d,e\n")
        for i in range(n):
            vals = [float(y[i]), float(w[i]), float(i)] + X[i].tolist()
            f.write(",".join("" if v != v else repr(v) for v in vals) + "\n")
    return X, y, w


def _write_libsvm(path, rng, n=300, width=12, label=True):
    rows = []
    for _ in range(n):
        idx = np.sort(rng.choice(width, rng.randint(1, 5), replace=False))
        toks = [f"{i}:{rng.normal():.6g}" for i in idx]
        lab = f"{float(rng.randint(0, 2))}" if label else "0"
        rows.append(" ".join([lab] + toks))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def _files(tmp, rng):
    """(path, params) of each parse case."""
    csv = tmp / "a.csv"
    _write_csv(csv, rng)
    n = 600
    np.savetxt(str(csv) + ".init", rng.normal(size=n))
    with open(str(csv) + ".query", "w") as f:
        f.write("\n".join(["200", "250", "150"]) + "\n")
    with open(str(csv) + ".position", "w") as f:
        f.write("\n".join(str(i % 7) for i in range(n)) + "\n")
    tsv = tmp / "b.tsv"
    tsv.write_text("1\t2.5\tNA\t4\n0\t\t3e-2\n1\tnull\t5\t6\t-7.25\n"
                   "0\tNaN\tNone\tna\n")
    np.savetxt(str(tsv) + ".weight", [1.0, 2.0, 0.5, 3.0], header="weight",
               comments="")
    svm = tmp / "c.svm"
    _write_libsvm(svm, rng)
    irregular = tmp / "e.svm"        # a token without ':' is skipped
    irregular.write_text("1 0:1.5 3:2.25\n0 2:-1e-3 qid\n1\t1:7\n"
                         "0 5:nan 2:0\n")
    txt = tmp / "d.txt"
    txt.write_text("1 2 3\n4  5 6\n7 8\n")
    return {
        "csv_header_columns": (csv, {"header": True,
                                     "label_column": "name:y",
                                     "weight_column": "name:w",
                                     "ignore_column": "name:id"}),
        "csv_indices": (csv, {"header": True, "weight_column": "0",
                              "ignore_column": "1"}),
        "tsv_ragged_na": (tsv, {}),
        "libsvm": (svm, {}),
        "libsvm_hint": (svm, {"_hint": 20}),
        "libsvm_irregular": (irregular, {}),
        "space": (txt, {}),
    }


@pytest.mark.parametrize("case", ["csv_header_columns", "csv_indices",
                                  "tsv_ragged_na", "libsvm", "libsvm_hint",
                                  "libsvm_irregular", "space"])
def test_parse_bit_equal_to_jax(tmp_path, rng, case):
    path, params = _files(tmp_path, rng)[case]
    params = dict(params)
    hint = params.pop("_hint", 0)
    want = jio.load_data_file(str(path), JConfig(params),
                              num_features_hint=hint)
    got = tio.load_data_file(str(path), TConfig(params),
                             num_features_hint=hint)
    assert _bits_equal(got.X, want.X)
    assert got.feature_names == want.feature_names
    for fld in ("label", "weight", "group", "init_score"):
        a, b = getattr(got, fld), getattr(want, fld)
        assert (a is None) == (b is None), fld
        if a is not None:
            assert _bits_equal(a, b), fld
    if want.position is None:
        assert got.position is None
    else:
        assert got.position.tolist() == want.position.tolist()


def test_parse_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2\n3,abc\n")
    for mod in (jio, tio):
        with pytest.raises(ValueError, match="abc"):
            mod.load_data_file(str(bad))
    with pytest.raises(FileNotFoundError):
        tio.load_data_file(str(tmp_path / "missing.csv"))


def test_dataset_from_files(tmp_path, rng):
    csv = tmp_path / "t.csv"
    _write_csv(csv, rng)
    p = {**BASE, "header": True, "weight_column": "0", "ignore_column": "1"}
    jd = lgb.Dataset(str(csv), params=p).construct()
    td = lgt.Dataset(str(csv), params={**p, **CPU}).construct()
    assert np.array_equal(td.bins.numpy(), jd.bins)
    assert td.feature_name == jd.feature_name == ["a", "b", "c", "d", "e"]
    assert _bits_equal(td.weight, jd.weight)
    # a LibSVM valid file narrower than its train set is zero-padded
    tr, va = tmp_path / "tr.svm", tmp_path / "va.svm"
    _write_libsvm(tr, rng, width=12)
    _write_libsvm(va, rng, width=7)
    q = {**BASE, "enable_bundle": False}
    jt = lgb.Dataset(str(tr), params=q).construct()
    jv = lgb.Dataset(str(va), reference=jt, params=q).construct()
    tt = lgt.Dataset(str(tr), params={**q, **CPU}).construct()
    tv = lgt.Dataset(str(va), reference=tt, params={**q, **CPU}).construct()
    assert tv.num_total_features == jv.num_total_features
    assert np.array_equal(tv.bins.numpy(), jv.bins)
    # an .lgbtpu shard path goes to the shard reader, which refuses a
    # malformed shard as the JAX package's does
    from lightgbm_tpu.data.shardfile import ShardFormatError as JaxShardError
    from lightgbm_tpu_torch.data.shardfile import ShardFormatError
    shard = tmp_path / "shard-00000-of-00001.lgbtpu"
    shard.write_bytes(b"\0")
    with pytest.raises(JaxShardError):
        lgb.Dataset(str(shard)).construct()
    with pytest.raises(ShardFormatError):
        lgt.Dataset(str(shard), params=CPU).construct()


def _cat_frame(rng, n=800):
    import pandas as pd
    c = pd.Categorical(rng.choice(["u", "v", "w", "x", "y"], n),
                       categories=["y", "x", "w", "v", "u"])
    X = np.zeros((n, 8))
    X[np.arange(n), rng.randint(0, 8, n)] = rng.normal(size=n)
    df = pd.DataFrame(X, columns=[f"s{i}" for i in range(8)])
    df.insert(0, "cat", c)
    df["x"] = rng.normal(size=n)
    y = (df["x"] + (np.asarray(c.codes) % 2) > 0.5).astype(float).values
    return df, y


def _assert_same_cache(port_ds, jax_ds):
    assert np.array_equal(port_ds.bins.cpu().numpy().astype(np.int64),
                          np.asarray(jax_ds.bins).astype(np.int64))
    assert port_ds.feature_name == list(jax_ds.feature_name)
    assert np.array_equal(port_ds.used_features, jax_ds.used_features)
    assert port_ds.max_num_bin == jax_ds.max_num_bin
    for a, b in zip(port_ds.bin_mappers, jax_ds.bin_mappers):
        for x, y in zip(a.state_arrays(), b.state_arrays()):
            assert np.array_equal(x, y)
    pa, pb = port_ds.bundle_plan, jax_ds.bundle_plan
    assert (pa is None) == (pb is None)
    if pa is not None:
        for x, y in zip(pa.state_arrays(), pb.state_arrays()):
            assert np.array_equal(x, y)
    assert json.dumps(port_ds.pandas_categorical) == json.dumps(
        jax_ds.pandas_categorical)
    assert _bits_equal(port_ds.label, jax_ds.label)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binary_cache_both_directions(tmp_path, rng, writer):
    """EFB bundles the 8 exclusive columns; the category column carries
    pandas_categorical; each package loads the other's file."""
    df, y = _cat_frame(rng)
    w = rng.uniform(0.5, 2.0, len(y))
    path = str(tmp_path / "train.bin")
    jd = lgb.Dataset(df, label=y, weight=w, params=BASE).construct()
    td = lgt.Dataset(df, label=y, weight=w,
                     params={**BASE, **CPU}).construct()
    assert jd.bundle_plan is not None and td.pandas_categorical
    _assert_same_cache(td, jd)
    if writer == "port":
        td.save_binary(path)
        _assert_same_cache(td, lgb.Dataset(path).construct())
    else:
        jd.save_binary(path)
        loaded = lgt.Dataset(path, params=CPU).construct()
        _assert_same_cache(loaded, jd)
        assert loaded.bins.dtype == td.bins.dtype
        # the cache trains the same trees as the frame
        p = {**BASE, **CPU, "objective": "binary"}
        a = lgt.train(p, lgt.Dataset(path, params=p), 3)
        b = lgt.train(p, lgt.Dataset(df, label=y, weight=w, params=p), 3)
        assert [_tree_key(t) for t in a._trees] == \
            [_tree_key(t) for t in b._trees]


def test_add_features_from(rng):
    X1, X2 = rng.normal(size=(1500, 3)), rng.normal(size=(1500, 2))
    X2[:, 1] = rng.permutation(1500)         # > 256 bins: widens to int16
    y = rng.normal(size=1500)
    p = {**BASE, "enable_bundle": False}
    q = {**p, "max_bin": 511}
    j1 = lgb.Dataset(X1, label=y, feature_name=["a", "b", "c"], params=p)
    j2 = lgb.Dataset(X2, label=y, feature_name=["b", "b_1"], params=q)
    t1 = lgt.Dataset(X1, label=y, feature_name=["a", "b", "c"],
                     params={**p, **CPU})
    t2 = lgt.Dataset(X2, label=y, feature_name=["b", "b_1"],
                     params={**q, **CPU})
    j1.construct().add_features_from(j2.construct())
    t1.construct().add_features_from(t2.construct())
    assert t1.feature_name == j1.feature_name == ["a", "b", "c", "b_1",
                                                  "b_1_1"]
    assert t1.bins.dtype == torch.int16
    assert np.array_equal(t1.bins.numpy(), j1.bins)
    assert np.array_equal(t1.used_features, j1.used_features)
    assert t1.num_total_features == 5 and t1.max_num_bin == j1.max_num_bin


class _Rows(lgt.Sequence):
    batch_size = 97

    def __init__(self, X):
        self.X = X

    def __getitem__(self, idx):
        return self.X[idx]

    def __len__(self):
        return len(self.X)


class _JRows(lgb.Sequence):
    batch_size = 97

    def __init__(self, X):
        self.X = X

    def __getitem__(self, idx):
        return self.X[idx]

    def __len__(self):
        return len(self.X)


def test_sequence_inputs(rng):
    X = rng.normal(size=(700, 6))
    X[:, 5] = np.where(rng.rand(700) < 0.3, X[:, 5], 0.0)
    y = rng.normal(size=700)
    p = {**BASE, "bin_construct_sample_cnt": 300}
    jd = lgb.Dataset([_JRows(X[:350]), _JRows(X[350:])], label=y,
                     params=p).construct()
    td = lgt.Dataset([_Rows(X[:350]), _Rows(X[350:])], label=y,
                     params={**p, **CPU}).construct()
    assert td.bundle_plan is None
    assert np.array_equal(td.bins.numpy(), jd.bins)
    # a valid Sequence against a bundled train set: its bundle layout
    Xs = np.zeros((500, 8))
    Xs[np.arange(500), rng.randint(0, 8, 500)] = rng.normal(size=500)
    jtr = lgb.Dataset(Xs, label=y[:500], params=BASE).construct()
    ttr = lgt.Dataset(Xs, label=y[:500], params={**BASE, **CPU}).construct()
    assert ttr.bundle_plan is not None
    jv = lgb.Dataset(_JRows(Xs[:200]), label=y[:200], reference=jtr,
                     params=BASE).construct()
    tv = lgt.Dataset(_Rows(Xs[:200]), label=y[:200], reference=ttr,
                     params={**BASE, **CPU}).construct()
    assert np.array_equal(tv.bins.numpy(), jv.bins)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's and the JAX package's CLI trained on one CSV with a
    header (3 trees, in process), and the files they wrote."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(5)
    n = 1500
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + X[:, 1] ** 2 + rng.normal(size=n) > 1).astype(float)
    with open(d / "train.csv", "w") as f:
        f.write("label," + ",".join(f"f{i}" for i in range(6)) + "\n")
        np.savetxt(f, np.column_stack([y, X]), fmt="%.10g", delimiter=",")
    conf = d / "train.conf"
    conf.write_text(
        "task = train\ndata = train.csv\nheader = true\n"
        "objective = binary\nnum_leaves = 15\nleaf_batch = 4\n"
        "max_bin = 16\nmin_data_in_leaf = 10\nlearning_rate = 0.2\n"
        "tree_learner = serial\nhist_impl = scatter\n"
        "metric_freq = 0\nverbosity = -1  # quiet\n")
    argv = [f"config={conf}", "num_trees=3"]
    assert jcli.run(jcli._parse_argv(
        argv + [f"output_model={d / 'jax.txt'}"])) == 0
    port_argv = argv + ["device_type=cpu", f"output_model={d / 'port.txt'}"]
    assert tcli.run(tcli._parse_argv(port_argv)) == 0
    return d, conf, X, port_argv


def test_cli_train_matches_jax_and_in_process(cli_run):
    d, conf, X, port_argv = cli_run
    port = lgt.Booster(model_file=str(d / "port.txt"), params=CPU)
    jax = lgb.Booster(model_file=str(d / "jax.txt"))
    assert [_tree_key(t) for t in port._trees] == \
        [_tree_key(t) for t in jax._trees]
    np.testing.assert_allclose(port.predict(X), jax.predict(X), rtol=1e-5)
    # the same parameters in process give the same model text
    params = tcli._parse_argv(port_argv)
    params.pop("_conf_dir")
    ep = {k: v for k, v in params.items()
          if lgt.Config.canonical_name(k) not in tcli._ENGINE_DROP}
    bst = lgt.train(ep, lgt.Dataset(str(d / "train.csv"), params=ep), 3)
    assert bst.model_to_string() == (d / "port.txt").read_text()


def test_cli_predict_save_binary_refit_convert(cli_run):
    d, conf, X, _ = cli_run
    common = [f"config={conf}", "device_type=cpu",
              f"input_model={d / 'port.txt'}"]
    assert tcli.run(tcli._parse_argv(
        common + ["task=predict", f"output_result={d / 'pred.txt'}"])) == 0
    bst = lgt.Booster(model_file=str(d / "port.txt"),
                      params={**CPU, "header": True})
    want = bst.predict(X)
    assert _bits_equal(np.loadtxt(d / "pred.txt"), want)
    assert _bits_equal(bst.predict(str(d / "train.csv")), want)
    # save_binary: the tree from the .bin equals the CSV's
    assert tcli.run(tcli._parse_argv(common + ["task=save_binary"])) == 0
    p = {**BASE, **CPU, "objective": "binary", "header": True}
    a = lgt.train(p, lgt.Dataset(str(d / "train.csv.bin"), params=p), 1)
    b = lgt.train(p, lgt.Dataset(str(d / "train.csv"), params=p), 1)
    assert a.model_to_string() == b.model_to_string()
    # refit on the file: the Booster.refit of its matrix
    assert tcli.run(tcli._parse_argv(
        common + ["task=refit", f"output_model={d / 'refit.txt'}"])) == 0
    y = np.loadtxt(d / "train.csv", delimiter=",", skiprows=1)[:, 0]
    ref = bst.refit(X, y)
    got = lgt.Booster(model_file=str(d / "refit.txt"), params=CPU)
    assert _bits_equal(got.predict(X), ref.predict(X))


@pytest.mark.skipif(shutil.which("gcc") is None, reason="needs gcc")
def test_convert_model_c_matches_predict(cli_run):
    d, conf, X, _ = cli_run
    assert tcli.run(tcli._parse_argv(
        [f"config={conf}", "device_type=cpu", "task=convert_model",
         f"input_model={d / 'port.txt'}",
         f"convert_model={d / 'model.c'}"])) == 0
    main = (d / "model.c").read_text() + r"""
#include <stdio.h>
int main(void) {
  double f[6], out[NUM_CLASS];
  while (scanf("%lf %lf %lf %lf %lf %lf", f, f + 1, f + 2, f + 3, f + 4,
               f + 5) == 6) {
    PredictRaw(f, out);
    printf("%.17g\n", out[0]);
  }
  return 0;
}
"""
    (d / "main.c").write_text(main)
    subprocess.run(["gcc", "-O2", "-o", str(d / "pred"), str(d / "main.c"),
                    "-lm"], check=True, timeout=120)
    rows = X[:1000]
    r = subprocess.run([str(d / "pred")], check=True, capture_output=True,
                       text=True, timeout=60, input="\n".join(
                           " ".join(repr(v) for v in row)
                           for row in rows.tolist()))
    c = np.array([float(v) for v in r.stdout.split()])
    bst = lgt.Booster(model_file=str(d / "port.txt"), params=CPU)
    np.testing.assert_allclose(c, bst.predict(rows, raw_score=True),
                               rtol=0, atol=1e-12)


def test_cli_module_subprocess(cli_run, tmp_path):
    """``python -m lightgbm_tpu_torch`` with device_type=cpu in argv: the
    model of the in-process run."""
    d, conf, _, _ = cli_run
    out = tmp_path / "m.txt"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", f"config={conf}",
         "num_trees=3", "device_type=cpu", f"output_model={out}"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    port = (d / "port.txt").read_text()
    # the texts differ only in the output_model parameter
    assert out.read_text().replace(str(out), str(d / "port.txt")) == port


def test_cli_serve_subprocess(cli_run):
    """``python -m lightgbm_tpu_torch serve``: the port's server answers
    /predict with the model's predictions, and SIGTERM drains it to a
    clean exit."""
    import signal
    import urllib.request
    d, conf, X, _ = cli_run
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "lightgbm_tpu_torch", "serve",
         f"model={d / 'port.txt'}", "port=0", "device_type=cpu",
         "warmup_rows=16"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("serving on http://"):
                port = int(line.split(":")[2].split()[0])
                break
        assert port, proc.stderr.read()[-2000:]
        body = json.dumps({"rows": X[:8].tolist()}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = np.asarray(json.loads(resp.read())["predictions"])
        bst = lgt.Booster(model_file=str(d / "port.txt"), params=CPU)
        np.testing.assert_allclose(got, bst.predict(X[:8]), rtol=0,
                                   atol=1e-12)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
