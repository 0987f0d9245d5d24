"""Batched prediction over raw feature matrices, in plain PyTorch.

Port of ``lightgbm_tpu/ops/predict_ensemble.py`` (``pack_ensemble``, the
depth-clamped ``_walk`` and ``predict_raw_device_early_stop``): the whole
ensemble is packed into ``[T, nodes]`` SoA tensors once per model state,
and all rows of all trees walk in lock-step, one vectorized gather +
compare over the ``[rows, trees]`` lattice per level. The walk runs
exactly ``max depth`` levels (known on the host at pack time), so it
needs no host sync. ``walk_leaves`` is the walk; ``pred_leaf`` reads its
leaf indices and the scores gather leaf values from them.

Unlike the JAX walk (float32, because TPUs have no f64) features,
thresholds and leaf values stay float64, so the device walk makes the
same decisions as the host ``Tree.predict`` and a model predicts the
same on every device. The early-stop sums therefore run in f64 too, as
the JAX package's host path does (its device path sums in f32).

Rows go through in chunks of ``max(1024, 2^22 / T)``, as the JAX
package's ``Booster._predict_raw_scores`` chunks them: the ``[rows,
trees]`` lattice never exceeds 2^22 cells (about 20 live int64/f64
temporaries of it per level, ~0.7 GB).

Linear-leaf trees (``linear_tree``): a leaf's output is
``leaf_const + sum(coeff * x[feature])`` over its features, in float64,
and its constant ``leaf_value`` where any of those features is NaN
(``Tree.predict``, tree.cpp:120-149). The pack carries each leaf's
constant, features and coefficients, and :func:`walk` adds that gather
after the leaf walk, on the device (:func:`linear_outputs`); the
training loop computes its score deltas with the same function. The
JAX package sends such models to its host path.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

__all__ = ["PackedEnsemble", "pack_ensemble", "walk_leaves", "predict_leaf",
           "predict_raw", "predict_raw_early_stop", "linear_tables",
           "linear_outputs"]


class PackedEnsemble(NamedTuple):
    split_feature: torch.Tensor   # [T, N] int64
    threshold: torch.Tensor       # [T, N] float64
    decision_type: torch.Tensor   # [T, N] int64
    left_child: torch.Tensor      # [T, N] int64
    right_child: torch.Tensor     # [T, N] int64
    leaf_value: torch.Tensor      # [T, L] float64
    cat_bound: torch.Tensor       # [T, C+1] int64
    cat_words: torch.Tensor       # [T, W] int64
    num_leaves: torch.Tensor      # [T] int64
    is_linear: torch.Tensor       # [T] bool
    leaf_const: torch.Tensor      # [T, L] float64
    leaf_feat: torch.Tensor       # [T, L, D] int64, -1 past a leaf's own
    leaf_coeff: torch.Tensor      # [T, L, D] float64
    max_depth: int                # max root-to-leaf depth (host int)
    linear_width: int             # D, or 0 when no tree is linear

    def trees(self, lo: int, hi: int) -> "PackedEnsemble":
        """Trees ``lo:hi`` (views; the depth clamp stays the whole
        ensemble's, which only adds no-op levels)."""
        return PackedEnsemble(*(a[lo:hi] for a in self[:-2]),
                              self.max_depth, self.linear_width)


def _tree_depth(t) -> int:
    """Max root-to-leaf edge count (children follow their parent in this
    writer's numbering, so one forward pass suffices)."""
    ni = t.num_leaves - 1
    if ni <= 0:
        return 0
    nd = np.zeros(ni, np.int64)
    mx = 1
    for n in range(ni):
        d = int(nd[n]) + 1
        for c in (int(t.left_child[n]), int(t.right_child[n])):
            if c >= 0:
                nd[c] = max(int(nd[c]), d)
            elif d > mx:
                mx = d
    return max(mx, int(nd.max()) + 1)


def linear_tables(trees: List, L: int):
    """The linear leaves of host Trees as padded numpy tables: is_linear
    [T], leaf_const [T, L], leaf_feat [T, L, D] (-1 pad) and leaf_coeff
    [T, L, D], and D: the most features a leaf has (at least 1 when a
    tree is linear, 0 when none is)."""
    T = len(trees)
    lin = [t for t in trees if getattr(t, "is_linear", False)]
    D = max([len(fs) for t in lin for fs in t.leaf_features] + [0])
    D = max(D, 1) if lin else 0
    isl = np.zeros(T, bool)
    lconst = np.zeros((T, L), np.float64)
    lfeat = np.full((T, L, max(D, 1)), -1, np.int64)
    lcoef = np.zeros((T, L, max(D, 1)), np.float64)
    for i, t in enumerate(trees):
        if not getattr(t, "is_linear", False):
            continue
        isl[i] = True
        lconst[i, :t.num_leaves] = t.leaf_const[:t.num_leaves]
        for s in range(t.num_leaves):
            fs = t.leaf_features[s]
            lfeat[i, s, :len(fs)] = fs
            lcoef[i, s, :len(fs)] = t.leaf_coeff[s]
    return isl, lconst, lfeat, lcoef, D


def pack_ensemble(trees: List, device) -> PackedEnsemble:
    """Host Trees -> padded device SoA (one-time per model version)."""
    T = len(trees)
    N = max(max(t.num_leaves - 1, 1) for t in trees)
    L = max(t.num_leaves for t in trees)
    C = max(t.num_cat for t in trees) + 1
    W = max(max(len(t.cat_threshold), 1) for t in trees)
    sf = np.zeros((T, N), np.int64)
    thr = np.zeros((T, N), np.float64)
    dt = np.zeros((T, N), np.int64)
    lc = np.full((T, N), -1, np.int64)
    rc = np.full((T, N), -1, np.int64)
    lv = np.zeros((T, L), np.float64)
    cb = np.zeros((T, C + 1), np.int64)
    cw = np.zeros((T, W), np.int64)
    nl = np.zeros(T, np.int64)
    depth = 0
    for i, t in enumerate(trees):
        ni = t.num_leaves - 1
        nl[i] = t.num_leaves
        depth = max(depth, _tree_depth(t))
        lv[i, :t.num_leaves] = t.leaf_value
        if ni <= 0:
            continue
        sf[i, :ni] = t.split_feature
        thr[i, :ni] = t.threshold
        dt[i, :ni] = t.decision_type
        lc[i, :ni] = t.left_child
        rc[i, :ni] = t.right_child
        cb[i, :len(t.cat_boundaries)] = t.cat_boundaries
        if t.cat_threshold:
            cw[i, :len(t.cat_threshold)] = t.cat_threshold
    isl, lconst, lfeat, lcoef, D = linear_tables(trees, L)
    dev = torch.device(device)
    return PackedEnsemble(
        *(torch.from_numpy(a).to(dev)
          for a in (sf, thr, dt, lc, rc, lv, cb, cw, nl, isl, lconst, lfeat,
                    lcoef)), depth, D)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[t, idx[r, t]] for all (r, t): a [T, M], idx [n, T]."""
    return torch.gather(a, 1, idx.T.contiguous()).T


def walk_leaves(ens: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """[n, T] int64 leaf index of every (row, tree) for raw features X
    [n, F] float64 (NaN ok). Decisions follow tree.h NumericalDecision /
    CategoricalDecision incl. missing types (bits 2-3) and default_left
    (bit 1)."""
    n = X.shape[0]
    T, N = ens.split_feature.shape
    Wc = ens.cat_words.shape[1]
    node = torch.zeros((n, T), dtype=torch.int64, device=X.device)
    single = (ens.num_leaves <= 1)[None, :]
    node = torch.where(single, -1, node)                 # ~0: leaf 0
    for _ in range(ens.max_depth):
        nodec = node.clamp(0, N - 1)
        feat = _take(ens.split_feature, nodec)
        v = torch.gather(X, 1, feat.clamp(0, X.shape[1] - 1))
        dt = _take(ens.decision_type, nodec)
        thr = _take(ens.threshold, nodec)
        is_cat = (dt & 1) != 0
        nan = torch.isnan(v)
        mt = (dt >> 2) & 3
        vz = torch.where(nan & (mt != 2), 0.0, v)
        gl_num = vz <= thr
        defl = (dt & 2) != 0
        miss = (nan & (mt == 2)) | ((vz.abs() <= 1e-35) & (mt == 1))
        gl_num = torch.where(miss, defl, gl_num)
        cat_idx = thr.to(torch.int64).clamp(0, ens.cat_bound.shape[1] - 2)
        lo = _take(ens.cat_bound, cat_idx)
        hi = _take(ens.cat_bound, cat_idx + 1)
        cval = torch.where(nan | (v < 0), -1.0, v).to(torch.int64)
        word = (lo + (cval >> 5)).clamp(0, Wc - 1)
        wv = _take(ens.cat_words, word)
        in_set = ((wv >> (cval & 31)) & 1) == 1
        gl_cat = (cval >= 0) & (lo + (cval >> 5) < hi) & in_set
        go_left = torch.where(is_cat, gl_cat, gl_num)
        nxt = torch.where(go_left, _take(ens.left_child, nodec),
                          _take(ens.right_child, nodec))
        node = torch.where(node >= 0, nxt, node)
    return (~node).clamp(0, ens.leaf_value.shape[1] - 1)


def linear_outputs(X: torch.Tensor, leaves: torch.Tensor,
                   leaf_value: torch.Tensor, leaf_const: torch.Tensor,
                   leaf_feat: torch.Tensor, leaf_coeff: torch.Tensor
                   ) -> torch.Tensor:
    """[n, T] float64 outputs of linear leaves: row r in tree t's leaf
    ``leaves[r, t]`` gives ``leaf_const + sum_d coeff_d * X[r, feat_d]``
    (the sum over the leaf's features in order, then the constant, as
    ``Tree.predict`` computes ``const + vals @ coeff``), or its
    ``leaf_value`` where one of those features is NaN. X [n, F] (float32
    values widen exactly), leaves [n, T] int64, tables [T, L] and
    [T, L, D] as :func:`linear_tables` lays them out."""
    n, T = leaves.shape
    L, D = leaf_const.shape[1], leaf_feat.shape[2]
    cell = (torch.arange(T, device=X.device)[None, :] * L + leaves)
    feat = leaf_feat.reshape(T * L, D)[cell]                 # [n, T, D]
    coef = leaf_coeff.reshape(T * L, D)[cell]
    used = feat >= 0
    x = torch.gather(X, 1, feat.clamp(min=0).reshape(n, T * D)).reshape(
        n, T, D).to(torch.float64)
    nan = (torch.isnan(x) & used).any(dim=2)
    dot = torch.zeros((n, T), dtype=torch.float64, device=X.device)
    for d in range(D):
        dot = dot + torch.where(used[..., d], coef[..., d] * x[..., d], 0.0)
    lin = leaf_const.reshape(-1)[cell] + dot
    return torch.where(nan, leaf_value.reshape(-1)[cell], lin)


def walk(ens: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """[n, T] float64 per-tree outputs: the leaf walk, then one gather of
    the leaf values (and, for linear trees, of their linear models)."""
    leaves = walk_leaves(ens, X)
    vals = _take(ens.leaf_value, leaves)
    if ens.linear_width == 0:
        return vals
    lin = linear_outputs(X, leaves, ens.leaf_value, ens.leaf_const,
                         ens.leaf_feat, ens.leaf_coeff)
    return torch.where(ens.is_linear[None, :], lin, vals)


def _row_chunks(n: int, T: int, D: int = 0):
    """Row slices whose [rows, trees] lattice stays within 2^22 cells,
    and within 2^22 / D a linear leaf's [rows, trees, D] gathers."""
    step = max(1024, (1 << 22) // max(T * max(D, 1), 1))
    return (slice(s, s + step) for s in range(0, n, step))


def predict_leaf(ens: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """[n, T] int32 leaf indices (``pred_leaf``)."""
    out = torch.empty((X.shape[0], ens.num_leaves.shape[0]),
                      dtype=torch.int32, device=X.device)
    for rows in _row_chunks(X.shape[0], out.shape[1]):
        out[rows] = walk_leaves(ens, X[rows]).to(torch.int32)
    return out


def predict_raw(ens: PackedEnsemble, X: torch.Tensor,
                tree_class: np.ndarray, K: int) -> torch.Tensor:
    """[n, K] float64 raw scores: per-class sums of the tree outputs
    (``tree_class`` [T] gives each tree's class). Each row's sums add the
    trees one by one in tree order, as the JAX package's host and native
    paths do (and ``CompiledEnsemble.predict``), so the scores are the
    same bits on every device and every call."""
    out = torch.zeros((X.shape[0], K), dtype=torch.float64,
                      device=X.device)
    for rows in _row_chunks(X.shape[0], len(tree_class), ens.linear_width):
        _accumulate(out[rows], walk(ens, X[rows]), tree_class)
    return out


def _accumulate(acc: torch.Tensor, vals: torch.Tensor,
                tree_class: np.ndarray) -> None:
    """acc[:, class of tree i] += vals[:, i], in tree order, in place."""
    for i, k in enumerate(tree_class.tolist()):
        acc[:, k] += vals[:, i]


def predict_raw_early_stop(ens: PackedEnsemble, X: torch.Tensor,
                           tree_class: np.ndarray, K: int, freq: int,
                           margin: float) -> torch.Tensor:
    """[n, K] float64 raw scores with prediction early stopping
    (PredictionEarlyStopInstance, prediction_early_stop.cpp:91, driven
    by GBDT::PredictRaw's round counter, gbdt_prediction.cpp:13-31).

    Trees go in chunks of ``freq`` iterations (``freq * K`` trees, whole
    iterations from the window's start). After each chunk the rows whose
    margin cleared ``margin`` freeze: they take no further additions and
    leave the walk. The margin is ``2|raw|`` for K == 1 and top1 - top2
    otherwise. The sums add tree by tree in tree order, as the JAX
    package's host path does (``engine.py:597``), so the freeze
    decisions match it."""
    n = X.shape[0]
    T = len(tree_class)
    raw = torch.zeros((n, K), dtype=torch.float64, device=X.device)
    active = torch.arange(n, device=X.device)
    step = freq * K
    for c0 in range(0, T, step):
        if active.numel() == 0:
            break
        sub = ens.trees(c0, c0 + step)
        ra = raw[active]
        Xa = X[active]
        for rows in _row_chunks(Xa.shape[0], sub.num_leaves.shape[0],
                                sub.linear_width):
            _accumulate(ra[rows], walk(sub, Xa[rows]),
                        tree_class[c0:c0 + step])
        raw[active] = ra
        if c0 + step >= T:
            break
        if K == 1:
            m = 2.0 * ra[:, 0].abs()
        else:
            top2 = torch.topk(ra, 2, dim=1).values
            m = top2[:, 0] - top2[:, 1]
        active = active[m <= margin]
    return raw
