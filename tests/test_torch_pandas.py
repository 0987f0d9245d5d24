"""PyTorch port, pandas and pyarrow input on the CPU, against the JAX
package (the pandas cases of ``tests/test_predict_extras.py`` and the
Arrow case of ``tests/test_io.py``); faults C4 and C5:

- a DataFrame with a ``category`` column (integer levels in a
  non-sorted category order) trains it as a categorical feature on its
  codes: predictions within 1e-6 of the JAX package's, and
  ``pandas_categorical`` equal in the model text (before the fix the
  port binned the raw values as one numeric feature and wrote ``null``);
- ``predict`` aligns a frame to the model's category lists, also after a
  save and reload; an unseen category predicts as missing;
- a valid set aligns to its train set's lists (the valid l2 equals the
  JAX package's);
- a categorical frame against a model or train set built without pandas,
  and a column that is not int, float, bool or category, raise as the
  JAX package does;
- a pyarrow Table's feature names are its ``column_names``, also after a
  save and reload, and ``predict`` takes the Table (fault C5: the port
  took the columns' data as names).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

pd = pytest.importorskip("pandas")

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "regression", "num_leaves": 15, "leaf_batch": 4,
          "min_data_in_leaf": 5, "min_data_per_group": 5,
          "verbosity": -1, "tree_learner": "serial",
          "hist_impl": "scatter"}
LEVELS = np.array([10, 20, 30, 40, 50, 60])
ORDER = [40, 30, 60, 20, 10, 50]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed=0, n=2000):
    rng = np.random.RandomState(seed)
    c = rng.randint(0, 6, size=n)
    means = np.asarray([3.0, -2.0, 0.5, 1.5, -1.0, 2.2])
    df = pd.DataFrame({
        "c": pd.Categorical(LEVELS[c], categories=ORDER),
        "x": rng.normal(size=n),
        "flag": rng.rand(n) > 0.5,
        "count": rng.randint(0, 100, size=n),
    })
    y = means[c] + 0.3 * df["x"].to_numpy() + rng.normal(size=n) * 0.1
    return df, y


@pytest.fixture(scope="module")
def models():
    df, y = _frame()
    jb = lgb.train(PARAMS, lgb.Dataset(df, label=y), 5)
    tb = lgt.train({**PARAMS, **CPU}, lgt.Dataset(df, label=y, params=CPU),
                   5)
    return df, y, jb, tb


def test_category_column_trains_as_categorical(models):
    """Fault C4."""
    df, y, jb, tb = models
    assert any(t.num_cat > 0 for t in tb._trees)
    np.testing.assert_allclose(tb.predict(df), jb.predict(df), rtol=0,
                               atol=1e-6)
    line = [ln for ln in tb.model_to_string().splitlines()
            if ln.startswith("pandas_categorical:")]
    want = [ln for ln in jb.model_to_string().splitlines()
            if ln.startswith("pandas_categorical:")]
    assert line == want == ["pandas_categorical:[[40, 30, 60, 20, 10, 50]]"]


def test_predict_aligns_categories(models):
    df, y, jb, tb = models
    p1 = tb.predict(df)
    df2 = df.copy()
    df2["c"] = pd.Categorical(np.asarray(df["c"]), categories=LEVELS[::-1])
    assert np.array_equal(tb.predict(df2), p1)
    reloaded = lgt.Booster(model_str=tb.model_to_string(), params=CPU)
    assert reloaded._pandas_categorical == [ORDER]
    assert np.array_equal(reloaded.predict(df2), p1)
    # an unseen category is missing: the prediction of a NaN code
    df3 = df.iloc[:50].copy()
    df3["c"] = pd.Categorical([70] * 50)
    X3 = df3.astype({"c": float}).to_numpy(np.float64)
    X3[:, 0] = np.nan
    assert np.array_equal(tb.predict(df3), tb.predict(X3))
    # the JAX package on the port's model text: the same alignment (the
    # two packages' own trees may take an exact subset/complement tie of
    # a categorical split the other way, ROADMAP C, which moves only the
    # rows outside both sides, such as these)
    same = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(tb.predict(df3), same.predict(df3), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tb.predict(df2), same.predict(df2), rtol=0,
                               atol=1e-12)


def test_valid_set_aligns_to_train():
    df, y = _frame(1)
    dv = df.iloc[1500:].copy()
    # the valid frame declares only the levels it holds, in its own order
    dv["c"] = pd.Categorical(np.asarray(dv["c"]))
    res = []
    for pkg, extra in ((lgb, {}), (lgt, CPU)):
        tr = pkg.Dataset(df.iloc[:1500], label=y[:1500], params=extra)
        va = pkg.Dataset(dv, label=y[1500:], reference=tr)
        evals = {}
        pkg.train({**PARAMS, **extra}, tr, 5, valid_sets=[va],
                  callbacks=[pkg.record_evaluation(evals)])
        res.append(evals["valid_0"]["l2"])
        if pkg is lgt:
            assert va.pandas_categorical == [ORDER]
    np.testing.assert_allclose(res[1], res[0], rtol=1e-6)
    assert res[1][-1] < np.var(y[1500:]) * 0.5


def test_mismatches_raise():
    df, y = _frame(2, n=300)
    X = df.astype({"c": float}).to_numpy(np.float64)
    bst = lgt.train({**PARAMS, **CPU}, lgt.Dataset(X, label=y, params=CPU),
                    2)
    for pkg in (lgb, lgt):
        with pytest.raises(ValueError, match="do not match"):
            if pkg is lgt:
                bst.predict(df)
            else:
                lgb.Booster(model_str=bst.model_to_string()).predict(df)
    tr = lgt.Dataset(X, label=y, params=CPU)
    with pytest.raises(ValueError, match="do not match"):
        lgt.Dataset(df, label=y, reference=tr).construct()
    bad = df.copy()
    bad["oops"] = ["text"] * len(bad)
    for pkg in (lgb, lgt):
        with pytest.raises(ValueError, match="int, float or bool"):
            pkg.Dataset(bad, label=y, params=CPU if pkg is lgt
                        else {}).construct()


def test_arrow_table_names(tmp_path):
    """Fault C5."""
    pa = pytest.importorskip("pyarrow")
    rng = np.random.RandomState(4)
    X = rng.normal(size=(600, 3))
    y = X[:, 0] - X[:, 1] + 0.1 * rng.normal(size=600)
    table = pa.table({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2]})
    p = {**PARAMS, **CPU}
    bst = lgt.train(p, lgt.Dataset(table, label=y, params=p), 2)
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    assert lgt.Booster(model_file=path, params=CPU).feature_name() == \
        ["a", "b", "c"]
    jb = lgb.train(PARAMS, lgb.Dataset(table, label=y), 2)
    assert jb.feature_name() == bst.feature_name()
    assert np.array_equal(bst.predict(table), bst.predict(X))
    np.testing.assert_allclose(bst.predict(table), jb.predict(table),
                               rtol=0, atol=1e-6)
