"""PyTorch port, end to end on the CPU: lightgbm_tpu_torch.train against
lightgbm_tpu.train on the same data and bin mappers (carried over by
lightgbm_tpu_torch.convert). Tree structures are equal, raw predictions
within 1e-5 and AUC within 1e-4; a JAX-trained model predicts in the
port within 1e-6; the port imports neither jax nor lightgbm_tpu; its
entry points refuse to fall back to the CPU."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import convert

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 15,
          "leaf_batch": 4, "max_bin": 16, "min_data_in_leaf": 10,
          "learning_rate": 0.2, "verbosity": -1}


def _data(rng, n=4000, f=8):
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (X[:, 0] * 1.5 - np.nan_to_num(X[:, 1]) ** 2 * 0.7
         + rng.normal(scale=0.5, size=n) > 0).astype(float)
    return X[:3000], y[:3000], X[3000:], y[3000:]


def _tree_key(t):
    return (t.num_leaves, tuple(t.split_feature), tuple(t.threshold_bin),
            tuple(t.decision_type), tuple(t.left_child),
            tuple(t.right_child))


def _jax_train(X, y, Xv, yv, rounds, w=None, wv=None, **extra):
    rec = {}
    p = {**PARAMS, **extra, "tree_learner": "serial",
         "hist_impl": "scatter"}
    tr = lgb.Dataset(X, label=y, weight=w, params=p)
    va = lgb.Dataset(Xv, label=yv, weight=wv, reference=tr)
    bst = lgb.train(p, tr, rounds, valid_sets=[va], valid_names=["v"],
                    callbacks=[lgb.record_evaluation(rec)])
    return bst, tr, rec


CONFIGS = {
    "plain": {},
    # path smoothing's outputs differ from XLA's (FMA-contracted) by an
    # ulp; min_gain_to_split screens out the noise-level near ties
    "monotone_smooth": {"monotone_constraints": [1, 0, 0, -1, 0, 0, 0, 0],
                        "monotone_penalty": 0.5, "path_smooth": 1.0,
                        "max_depth": 4, "min_gain_to_split": 0.05},
    "regularised": {"lambda_l1": 0.1, "lambda_l2": 1.0,
                    "max_delta_step": 0.5, "min_gain_to_split": 0.01,
                    "feature_fraction": 0.7},
    "categorical_weighted": {"categorical_feature": "5",
                             "is_unbalance": True},
}


@pytest.mark.parametrize("fused_split", ["auto", "off"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_train_matches_jax(rng, config, fused_split):
    X, y, Xv, yv = _data(rng)
    extra = CONFIGS[config]
    w = wv = None
    if config == "categorical_weighted":
        X[:, 5] = rng.randint(0, 4, size=len(X))    # one-hot categorical
        Xv[:, 5] = rng.randint(0, 4, size=len(Xv))
        w = rng.uniform(0.5, 2.0, size=len(X))
        wv = rng.uniform(0.5, 2.0, size=len(Xv))
    jb, jtr, jrec = _jax_train(X, y, Xv, yv, 5, w=w, wv=wv, **extra)
    p = {**PARAMS, **extra, **CPU, "fused_split": fused_split}
    tr = lgt.Dataset(X, label=y, weight=w, params=p,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    va = lgt.Dataset(Xv, label=yv, weight=wv, reference=tr)
    trec = {}
    tb = lgt.train(p, tr, 5, valid_sets=[va], valid_names=["v"],
                   callbacks=[lgt.record_evaluation(trec)])
    assert tb._gbdt.fused_split_ok == (fused_split == "auto")
    jt, tt = jb._all_trees(), tb._trees
    assert len(jt) == len(tt) == 5
    for a, b in zip(jt, tt):
        assert _tree_key(a) == _tree_key(b)
        assert a.cat_threshold == b.cat_threshold
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-7)
    if config == "categorical_weighted":
        assert any(t.num_cat > 0 for t in tt)
    np.testing.assert_allclose(tb.predict(Xv, raw_score=True),
                               jb.predict(Xv, raw_score=True), atol=1e-5)
    np.testing.assert_allclose(trec["v"]["auc"], jrec["v"]["auc"],
                               atol=1e-4)
    assert trec["v"]["auc"][-1] > 0.85


def test_jax_model_predicts_in_port(rng):
    X, y, Xv, yv = _data(rng)
    jb, _, _ = _jax_train(X, y, Xv, yv, 4)
    port = convert.booster_from_model_string(jb.model_to_string(),
                                             params=CPU)
    for raw in (True, False):
        np.testing.assert_allclose(port.predict(Xv, raw_score=raw),
                                   jb.predict(Xv, raw_score=raw), atol=1e-6)
    np.testing.assert_allclose(port.predict(Xv, num_iteration=2),
                               jb.predict(Xv, num_iteration=2), atol=1e-6)


def test_save_load_round_trip(rng, tmp_path):
    X, y, Xv, yv = _data(rng)
    bst = lgt.train({**PARAMS, **CPU}, lgt.Dataset(X, label=y), 4)
    pred = bst.predict(Xv)
    path = tmp_path / "model.txt"
    bst.save_model(str(path))
    again = lgt.Booster(model_file=str(path), params=CPU)
    assert np.array_equal(again.predict(Xv), pred)
    assert again.num_trees() == bst.num_trees() == 4
    # the JAX package reads the port's model text too
    jax_bst = lgb.Booster(model_file=str(path))
    np.testing.assert_allclose(jax_bst.predict(Xv), pred, atol=1e-6)


def test_eval_period_defers_syncs(rng):
    """Trees stay on the device between eval points: one tree transfer
    and one score read per eval point."""
    X, y, Xv, yv = _data(rng)
    rec = {}
    tr = lgt.Dataset(X, label=y, params=CPU)
    bst = lgt.train({**PARAMS, **CPU, "eval_period": 3}, tr, 6,
                    valid_sets=[lgt.Dataset(Xv, label=yv, reference=tr)],
                    valid_names=["v"],
                    callbacks=[lgt.record_evaluation(rec)])
    assert len(rec["v"]["auc"]) == 2
    assert bst._gbdt.host_sync_count == 4
    assert bst.num_trees() == 6


def test_early_stopping(rng):
    X, y, Xv, yv = _data(rng)
    tr = lgt.Dataset(X, label=y, params=CPU)
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    bst = lgt.train({**PARAMS, **CPU, "learning_rate": 0.6,
                     "early_stopping_round": 2, "metric": "binary_logloss"},
                    tr, 50, valid_sets=[va], valid_names=["v"])
    assert 0 < bst.best_iteration < 50
    assert "binary_logloss" in bst.best_score["v"]


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert, "
            "lightgbm_tpu_torch.ops.cuda_histogram, "
            "lightgbm_tpu_torch.codegen, lightgbm_tpu_torch.serving, "
            "lightgbm_tpu_torch.data, lightgbm_tpu_torch.resilience, "
            "lightgbm_tpu_torch.cli, lightgbm_tpu_torch.profiler, "
            "lightgbm_tpu_torch.telemetry.monitor, "
            "lightgbm_tpu_torch.telemetry.costmodel, "
            "lightgbm_tpu_torch.telemetry.perf; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'lightgbm_tpu' "
            "or m.startswith('lightgbm_tpu.')]; "
            "assert not bad, bad; print('clean')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_default_device_raises_without_gpu(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    X, y, _, _ = _data(rng)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lgt.train(dict(PARAMS), lgt.Dataset(X, label=y), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lgt.Dataset(X, label=y).construct()
    text = lgt.train({**PARAMS, **CPU}, lgt.Dataset(X, label=y),
                     1).model_to_string()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lgt.Booster(model_str=text).predict(X)


@pytest.mark.parametrize("extra", [
    {"tree_learner": "voting"},
    {"tree_learner": "feature"},
    {"tree_learner": "data"},
    {"num_machines": 2},
])
def test_unported_options_raise(rng, extra):
    X, y, _, _ = _data(rng)
    with pytest.raises(NotImplementedError):
        lgt.train({**PARAMS, **CPU, **extra}, lgt.Dataset(X, label=y), 1)


@pytest.fixture(scope="module")
def hist_impl_reference():
    X, y, _, _ = _data(np.random.RandomState(5))
    return X, y, lgt.train({**PARAMS, **CPU}, lgt.Dataset(X, label=y),
                           3).model_to_string().split("end of trees")[0]


@pytest.mark.parametrize("impl", ["auto", "scatter", "matmul", "pallas"])
def test_hist_impl_trains_the_same_trees(hist_impl_reference, impl):
    """Fault C9, settled as a deliberate deviation: the port has one
    histogram kernel a device, so every hist_impl of the JAX package
    trains the default's trees, bit for bit."""
    X, y, want = hist_impl_reference
    p = {**PARAMS, **CPU, "hist_impl": impl}
    got = lgt.train(p, lgt.Dataset(X, label=y, params=p), 3)
    assert got.model_to_string().split("end of trees")[0] == want


def test_fused_gate_reasons(rng, monkeypatch):
    X, y, _, _ = _data(rng)

    def reason(**extra):
        b = lgt.Booster(params={**PARAMS, **CPU, **extra},
                        train_set=lgt.Dataset(X, label=y))
        b._ensure_gbdt()
        return b._gbdt.fused_split_reason
    assert reason() == ""
    assert reason(fused_split="off") == "fused_split=off"
    monkeypatch.setenv("LIGHTGBM_TPU_FUSED_SPLIT", "0")
    assert reason() == "LIGHTGBM_TPU_FUSED_SPLIT=0"


LR_SCHEDULE = [0.1, 0.09, 0.08, 0.07, 0.06]


def _trees_text(text):
    """A model text's trees: everything before its parameters."""
    return text.split("parameters:")[0]


def test_reset_parameter_matches_jax(rng):
    """The reset_parameter callback's learning-rate schedule trains the
    JAX package's model text, with each tree's own shrinkage."""
    X = rng.normal(size=(2000, 5))
    y = (X[:, 0] + X[:, 1] ** 2 + rng.normal(scale=0.5, size=2000)
         > 1).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    jp = {**p, "tree_learner": "serial", "hist_impl": "scatter"}
    jtr = lgb.Dataset(X, label=y, params=jp)
    jb = lgb.train(jp, jtr, 5,
                   callbacks=[lgb.reset_parameter(learning_rate=LR_SCHEDULE)])
    tp = {**p, **CPU}
    tr = lgt.Dataset(X, label=y, params=tp,
                     bin_mappers=convert.bin_mappers_from_state(
                         m.state_arrays() for m in jtr.bin_mappers))
    tb = lgt.train(tp, tr, 5,
                   callbacks=[lgt.reset_parameter(learning_rate=LR_SCHEDULE)])
    text = tb.model_to_string()
    assert [line for line in text.splitlines()
            if line.startswith("shrinkage=")] == [
        f"shrinkage={lr:g}" for lr in LR_SCHEDULE]
    assert _trees_text(text) == _trees_text(jb.model_to_string())
    assert tb._gbdt.shrinkage == 0.06


def test_reset_parameter_refuses_baked_parameters(rng):
    """A parameter fixed when the Booster was built raises and names
    itself; nothing is applied, and training goes on."""
    X, y, _, _ = _data(rng)
    bst = lgt.Booster(params={**PARAMS, **CPU},
                      train_set=lgt.Dataset(X, label=y, params=CPU))
    bst.update()
    for change in ({"num_leaves": 7}, {"bagging_fraction": 0.5},
                   {"feature_fraction": 0.5, "learning_rate": 0.3}):
        name = sorted(k for k in change if k != "learning_rate")[0]
        with pytest.raises(NotImplementedError, match=name):
            bst.reset_parameter(change)
    assert bst.config.num_leaves == 15 and bst._gbdt.shrinkage == 0.2
    bst.reset_parameter({"eta": 0.05, "num_leaves": 15})   # alias, no change
    bst.update()
    assert bst._gbdt.shrinkage == 0.05
    assert [t.shrinkage for t in bst._trees] == [0.2, 0.05]
