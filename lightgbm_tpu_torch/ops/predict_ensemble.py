"""Batched prediction over raw feature matrices, in plain PyTorch.

Port of ``lightgbm_tpu/ops/predict_ensemble.py`` (``pack_ensemble`` and
the depth-clamped ``_walk``): the whole ensemble is packed into
``[T, nodes]`` SoA tensors once per model state, and all rows of all
trees walk in lock-step, one vectorized gather + compare over the
``[rows, trees]`` lattice per level. The walk runs exactly ``max depth``
levels (known on the host at pack time), so it needs no host sync.

Unlike the JAX walk (float32, because TPUs have no f64) features,
thresholds and leaf values stay float64, so the device walk makes the
same decisions as the host ``Tree.predict`` and a model predicts the
same on every device.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

__all__ = ["PackedEnsemble", "pack_ensemble", "predict_raw"]


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
    max_depth: int                # max root-to-leaf depth (host int)


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
    dev = torch.device(device)
    return PackedEnsemble(
        *(torch.from_numpy(a).to(dev)
          for a in (sf, thr, dt, lc, rc, lv, cb, cw, nl)), depth)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[t, idx[r, t]] for all (r, t): a [T, M], idx [n, T]."""
    return torch.gather(a, 1, idx.T.contiguous()).T


def walk(ens: PackedEnsemble, X: torch.Tensor) -> torch.Tensor:
    """[n, T] per-tree outputs for raw features X [n, F] float64 (NaN
    ok). Decisions follow tree.h NumericalDecision / CategoricalDecision
    incl. missing types (bits 2-3) and default_left (bit 1)."""
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
    leaf = (~node).clamp(0, ens.leaf_value.shape[1] - 1)
    return _take(ens.leaf_value, leaf)


def predict_raw(ens: PackedEnsemble, X: torch.Tensor,
                tree_class: np.ndarray, K: int,
                chunk_rows: int = 1 << 16) -> torch.Tensor:
    """[n, K] float64 raw scores: per-class sums of the tree outputs
    (``tree_class`` [T] gives each tree's class). The sums are plain
    reductions, not atomics, so a model predicts bit-identically on
    every call."""
    cols = [torch.from_numpy(np.nonzero(tree_class == k)[0]).to(X.device)
            for k in range(K)]
    out = torch.zeros((X.shape[0], K), dtype=torch.float64,
                      device=X.device)
    for s in range(0, X.shape[0], chunk_rows):
        per_tree = walk(ens, X[s:s + chunk_rows])
        for k in range(K):
            out[s:s + chunk_rows, k] = per_tree[:, cols[k]].sum(dim=1)
    return out
