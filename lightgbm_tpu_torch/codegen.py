"""Model code generation: C emission and the ensemble tensorizer.

Port of ``lightgbm_tpu/codegen.py``. Both lower a whole trained
ensemble into one program:

- ``model_to_c`` (``:111``) — the reference's ``GBDT::SaveModelToIfElse``
  (``src/boosting/gbdt_model_text.cpp:286``, ``Tree::ToIfElse``): a
  self-contained C file with one nested if-else function per tree plus
  an aggregate ``PredictRaw``, for the CLI's ``task=convert_model``. It
  is host text generation and is copied as it is.
- The tensorizer (``:160-526``): every tree is packed into dense
  ``[n_trees, max_nodes]`` node tables (feature, threshold, packed
  children, decision bits) and the whole ensemble walks as one
  depth-clamped gather loop vectorized over ``[batch, n_trees]`` (the
  GPU-predict layout of arXiv 1806.11248: level-synchronous traversal,
  no per-tree dispatch).

The walk keeps the JAX tensorizer's **float32** semantics (features cast
to f32, f32 thresholds and leaf values), so its leaf indices are
bit-equal to the JAX ``CompiledEnsemble``'s. ``predict`` reduces the
leaf values on the host in float64 in tree order, reproducing the JAX
``CompiledEnsemble.predict`` bit for bit. The walk is eager PyTorch: a
Python loop of exactly ``depth`` levels, ~60 small launches a level, so
a small batch is bound by launch overhead.

Missing-value and categorical decision semantics match the
decision_type bit layout used everywhere else (bit0 cat, bit1
default_left, bits 2-3 missing type): ``tree.h`` NumericalDecision /
CategoricalDecision.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .ops.predict_ensemble import _tree_depth

__all__ = ["model_to_c", "tensorize_ensemble", "TensorizedTables",
           "CompiledEnsemble"]


def _tree_fn(tree, i: int) -> str:
    lines = [f"static double PredictTree{i}(const double* f) {{"]

    def emit(node: int, depth: int):
        pad = "  " * (depth + 1)
        if node < 0:
            lines.append(f"{pad}return {float(tree.leaf_value[~node])!r};")
            return
        fidx = int(tree.split_feature[node])
        dt = int(tree.decision_type[node])
        if dt & 1:  # categorical: membership in the split's value set
            cat_idx = int(tree.threshold[node])
            lo = tree.cat_boundaries[cat_idx]
            hi = tree.cat_boundaries[cat_idx + 1]
            cats = [c for c in range((hi - lo) * 32)
                    if (tree.cat_threshold[lo + c // 32] >> (c % 32)) & 1]
            cond = " || ".join(f"(int)f[{fidx}] == {c}" for c in cats)
            lines.append(f"{pad}if (!isnan(f[{fidx}]) && f[{fidx}] >= 0 "
                         f"&& ({cond})) {{")
        else:
            thr = float(tree.threshold[node])
            mt = (dt >> 2) & 3
            defl = bool(dt & 2)
            if mt == 2:  # NaN-aware: missing follows default_left
                nan_br = "isnan(f[%d])" % fidx
                cond = (f"({nan_br} ? 1 : f[{fidx}] <= {thr!r})" if defl
                        else f"(!{nan_br} && f[{fidx}] <= {thr!r})")
                lines.append(f"{pad}if {cond} {{")
            elif mt == 1:
                # Zero-as-missing: NaN folds to 0.0 and |v| <= 1e-35
                # routes to the DEFAULT side (tree.h:359), not through
                # the threshold compare
                zv = (f"(isnan(f[{fidx}]) ? 0.0 : f[{fidx}])")
                miss = f"(fabs({zv}) <= 1e-35)"
                cond = (f"({miss} ? 1 : {zv} <= {thr!r})" if defl
                        else f"(!{miss} && {zv} <= {thr!r})")
                lines.append(f"{pad}if {cond} {{")
            else:  # None: NaN treated as 0.0
                lines.append(
                    f"{pad}if ((isnan(f[{fidx}]) ? 0.0 : f[{fidx}])"
                    f" <= {thr!r}) {{")
        emit(int(tree.left_child[node]), depth + 1)
        lines.append(f"{pad}}} else {{")
        emit(int(tree.right_child[node]), depth + 1)
        lines.append(f"{pad}}}")

    if tree.num_leaves == 1:
        lines.append(f"  return {float(tree.leaf_value[0])!r};")
    else:
        # emit() recursion depth equals TREE depth — measure it
        # (wide-but-shallow trees are fine at any leaf count)
        import sys
        depth, stack = 0, [(0, 1)]
        while stack:
            nd, d = stack.pop()
            if nd < 0:
                depth = max(depth, d)
                continue
            stack.append((int(tree.left_child[nd]), d + 1))
            stack.append((int(tree.right_child[nd]), d + 1))
        if depth > sys.getrecursionlimit() // 4:
            raise ValueError(
                f"tree too deep for if-else codegen (depth {depth})")
        emit(0, 0)
    lines.append("}")
    return "\n".join(lines)


def model_to_c(trees: List, num_class: int = 1,
               objective: str = "regression",
               average_output: bool = False) -> str:
    """Standalone C translation unit for the ensemble.

    Exposes ``void PredictRaw(const double* features, double* out)``
    (raw scores, ``out[num_class]``) — sigmoid/softmax conversion is the
    caller's job, like the reference's generated code.
    """
    K = max(1, num_class)
    parts = [
        "/* generated by lightgbm_tpu_torch (convert_model; analog of",
        "   gbdt_model_text.cpp ModelToIfElse) */",
        "#include <math.h>",
        f"#define NUM_CLASS {K}",
        f"#define NUM_TREES {len(trees)}",
        f"/* objective: {objective} */",
        "",
    ]
    for i, t in enumerate(trees):
        if getattr(t, "is_linear", False):
            raise ValueError("convert_model does not support linear trees")
        parts.append(_tree_fn(t, i))
        parts.append("")
    calls = "\n".join(
        f"  out[{i % K}] += PredictTree{i}(features);"
        for i in range(len(trees)))
    avg = ""
    if average_output and trees:
        # RF mode: raw scores are running AVERAGES (rf.hpp)
        per_class = max(1, len(trees) // K)
        avg = (f"  for (k = 0; k < NUM_CLASS; ++k) "
               f"out[k] /= {per_class}.0;")
    parts += [
        "void PredictRaw(const double* features, double* out) {",
        "  int k;",
        "  for (k = 0; k < NUM_CLASS; ++k) out[k] = 0.0;",
        calls,
        avg,
        "}",
        "",
    ]
    return "\n".join(parts)


class TensorizedTables(NamedTuple):
    """Dense SoA node tables of a whole ensemble (host numpy; the
    :class:`CompiledEnsemble` places them per device).

    ``children`` packs both child references of a node into one int32:
    ``(left & 0xffff) << 16 | (right & 0xffff)``. References use the
    writer's numbering (child >= 0 internal node, child < 0 means
    ``~leaf_index``), so each half is a SIGNED 16-bit field — unpacking
    with arithmetic shifts (``>> 16`` / ``<< 16 >> 16``) sign-extends
    negative leaf refs. One gather per step fetches both children.
    """

    feature: np.ndarray     # [T, N] int32 split feature per node
    threshold: np.ndarray   # [T, N] f32 (cat splits: cat split index)
    decision: np.ndarray    # [T, N] int32 decision_type bits
    children: np.ndarray    # [T, N] int32 packed left/right
    init_node: np.ndarray   # [T] int32 root (or ~0 for stump trees)
    leaf_value: np.ndarray  # [T, L] f32
    cat_bound: np.ndarray   # [T, C+1] int32 cat split word bounds
    cat_words: np.ndarray   # [T, W] int32 bitset words (uint32 bits)


def tensorize_ensemble(trees: List) -> "tuple[TensorizedTables, int]":
    """Host Trees -> dense tables + static max depth.

    Raises ``ValueError`` for models the dense layout cannot represent
    (linear-leaf trees; > 32767 internal nodes / 32768 leaves per tree —
    the packed int16 child fields' range).
    """
    if not trees:
        raise ValueError("tensorize_ensemble needs a nonempty ensemble")
    for t in trees:
        if getattr(t, "is_linear", False):
            raise ValueError("linear-leaf trees are not tensorizable "
                             "(leaf outputs depend on raw features)")
        if t.num_leaves > (1 << 15):
            raise ValueError(
                f"tree with {t.num_leaves} leaves exceeds the packed "
                "int16 child range (32768)")
    T = len(trees)
    N = max(max(t.num_leaves - 1, 1) for t in trees)
    L = max(t.num_leaves for t in trees)
    C = max(t.num_cat for t in trees) + 1
    W = max(max(len(t.cat_threshold), 1) for t in trees)

    sf = np.zeros((T, N), np.int32)
    thr = np.zeros((T, N), np.float32)
    dt = np.zeros((T, N), np.int32)
    ch = np.zeros((T, N), np.int32)
    init = np.zeros(T, np.int32)
    lv = np.zeros((T, L), np.float32)
    cb = np.zeros((T, C + 1), np.int32)
    cw = np.zeros((T, W), np.int64)
    depth = 1
    for i, t in enumerate(trees):
        ni = t.num_leaves - 1
        lv[i, :t.num_leaves] = t.leaf_value
        if ni <= 0:
            init[i] = -1           # stump: start AT leaf 0 (~0)
            continue
        depth = max(depth, _tree_depth(t))
        sf[i, :ni] = t.split_feature
        thr[i, :ni] = t.threshold
        dt[i, :ni] = t.decision_type
        lc = np.asarray(t.left_child, np.int32)
        rc = np.asarray(t.right_child, np.int32)
        ch[i, :ni] = ((lc & 0xffff) << 16) | (rc & 0xffff)
        cb[i, :len(t.cat_boundaries)] = t.cat_boundaries
        if t.cat_threshold:
            cw[i, :len(t.cat_threshold)] = t.cat_threshold
    # bitset words are uint32 BIT PATTERNS; reinterpret, never convert
    cw32 = cw.astype(np.uint32).view(np.int32)
    return (TensorizedTables(sf, thr, dt, ch, init, lv, cb, cw32),
            int(depth))


def _tensor_leaves(tables: TensorizedTables, X: torch.Tensor, *,
                   depth: int) -> torch.Tensor:
    """[n, T] int32 leaf indices for X [n, F] f32 — the branchless walk.

    Exactly ``depth`` levels (the ensemble's max root-to-leaf depth,
    fixed at tensorize time): every level is pure gathers and selects
    over the ``[batch, trees]`` lattice, no convergence check, no host
    round-trip. Lanes that reached a leaf hold their (negative) node id.
    All arithmetic stays in int32/f32 as in the JAX walk; only the
    gather offsets are int64, the index type of PyTorch's gathers.
    """
    n, F = X.shape
    T, N = tables.feature.shape
    L = tables.leaf_value.shape[1]
    Cb = tables.cat_bound.shape[1]
    W = tables.cat_words.shape[1]
    dev = X.device
    # flattened tables + per-tree offsets: one 1-D take per field
    # fetches the [n, T] lattice
    tree = torch.arange(T, dtype=torch.int64, device=dev)[None, :]
    offs, cat_offs, word_offs = tree * N, tree * Cb, tree * W
    feat_f = tables.feature.reshape(-1)
    thr_f = tables.threshold.reshape(-1)
    dec_f = tables.decision.reshape(-1)
    ch_f = tables.children.reshape(-1)
    cb_f = tables.cat_bound.reshape(-1)
    cw_f = tables.cat_words.reshape(-1)
    node = tables.init_node[None, :].expand(n, T)
    for _ in range(depth):
        at_leaf = node < 0
        idx = node.clamp(0, N - 1) + offs
        feat = feat_f[idx]
        v = torch.gather(X, 1, feat.clamp(0, F - 1).long())
        dt = dec_f[idx]
        thr = thr_f[idx]
        is_cat = (dt & 1) != 0
        nan = torch.isnan(v)
        mt = (dt >> 2) & 3
        vz = torch.where(nan & (mt != 2), 0.0, v)
        gl_num = vz <= thr
        defl = (dt & 2) != 0
        # missing -> default side: NaN under MissingType::NaN, and
        # |v| <= 1e-35 (incl. NaN folded to 0) under MissingType::Zero
        # (tree.h:359; zeros must NOT take the threshold compare)
        miss = (nan & (mt == 2)) | ((vz.abs() <= 1e-35) & (mt == 1))
        gl_num = torch.where(miss, defl, gl_num)
        # categorical: threshold holds the cat split index
        cat_idx = thr.to(torch.int32).clamp(0, Cb - 2) + cat_offs
        lo = cb_f[cat_idx]
        hi = cb_f[cat_idx + 1]
        cval = torch.where(nan | (v < 0), -1.0, v).to(torch.int32)
        word = (lo + (cval >> 5)).clamp(0, W - 1) + word_offs
        # int32 bit patterns: the shift is arithmetic, but bit c of the
        # word lands in bit 0 whatever the sign
        in_set = ((cw_f[word] >> (cval & 31)) & 1) == 1
        gl_cat = (cval >= 0) & (lo + (cval >> 5) < hi) & in_set
        go_left = torch.where(is_cat, gl_cat, gl_num)
        ch = ch_f[idx]
        # packed signed-int16 halves: arithmetic shifts sign-extend
        nxt = torch.where(go_left, ch >> 16, (ch << 16) >> 16)
        node = torch.where(at_leaf, node, nxt)
    return (~node).clamp(0, L - 1)


def _tensor_values(tables: TensorizedTables, X: torch.Tensor, *,
                   depth: int) -> torch.Tensor:
    """[n, T] f32 per-tree leaf values (one gather after the walk)."""
    T = tables.feature.shape[0]
    L = tables.leaf_value.shape[1]
    leaf = _tensor_leaves(tables, X, depth=depth)
    offs = torch.arange(T, dtype=torch.int64, device=X.device)[None, :] * L
    return tables.leaf_value.reshape(-1)[leaf + offs]


def _tensor_reduced(tables: TensorizedTables, X: torch.Tensor,
                    cols: Sequence[torch.Tensor], *,
                    depth: int) -> torch.Tensor:
    """[n, K] f32 raw class sums reduced on the device: one f32 sum over
    each class's trees (``cols[k]`` their indices). A plain reduction,
    not a matmul, so TF32 cannot reach it. The exact serving path
    (``CompiledEnsemble.predict``) reduces on the host in f64 instead."""
    vals = _tensor_values(tables, X, depth=depth)
    return torch.stack([vals[:, c].sum(dim=1) for c in cols], dim=1)


class CompiledEnsemble:
    """One whole ensemble as dense tables and one branchless walk.

    Built from a Booster (same tree-window kwargs as
    :class:`~lightgbm_tpu_torch.engine.PredictSession`); raises
    ``ValueError`` for windows the dense layout cannot express
    (``pred_contrib``, early stopping, linear trees) so callers can
    gate and fall back to the session path with a named reason.

    Output modes:

    - ``predict(X)`` — the serving path. The device walks all trees and
      returns leaf indices; the per-class reduction runs on the host in
      float64 IN TREE ORDER, then shares the Booster's
      ``_finalize_scores`` — bit-equal to the JAX
      ``CompiledEnsemble.predict``.
    - ``predict(X)`` with ``pred_leaf=True`` at construction — [n, T]
      leaf indices.
    - ``predict_device(X)`` — raw class sums reduced on the device in
      f32 (no host readback of per-tree values).

    Tables are placed per device (``tables_for``), so each replica's
    copy lives on its own device; ``device=None`` is the Booster's
    predict device, resolved once here. Nothing compiles: ``warm``
    places the tables and runs every ladder rung once off the serving
    path, and ``describe()`` lists the warmed rungs.
    """

    def __init__(self, booster, *, start_iteration: int = 0,
                 num_iteration: Optional[int] = None,
                 raw_score: bool = False, pred_leaf: bool = False,
                 **kwargs):
        if kwargs.pop("pred_contrib", False):
            raise ValueError("pred_contrib is not tensorizable "
                             "(TreeSHAP walks all paths)")
        if booster._early_stop_config(kwargs) is not None:
            raise ValueError("pred_early_stop is not tensorizable "
                             "(chunked early exit; use the session)")
        booster._sync_trees()
        K = max(1, booster._num_class)
        trees = booster._all_trees()
        lo, hi = booster._window(start_iteration, num_iteration, len(trees))
        use = trees[lo:hi]
        tables, depth = tensorize_ensemble(use)
        self.booster = booster
        self.model_version = booster._model_version
        self.default_device = booster._predict_device()
        self.num_features = booster._max_feature_idx + 1
        self.num_class = K
        self.num_trees = len(use)
        self.depth = depth
        self.raw_score = bool(raw_score)
        self.pred_leaf = bool(pred_leaf)
        self._use = use
        self._tables_np = tables
        # f64 leaf tables for the exact host reduction (tree order)
        self._leaf64 = [np.asarray(t.leaf_value, np.float64) for t in use]
        self._cls_np = np.asarray([(lo + i) % K for i in range(len(use))],
                                  np.int32)
        self._place_lock = threading.Lock()
        self._placed: dict = {}
        self._warmed: set = set()

    # -- device placement ---------------------------------------------
    def _device(self, device) -> torch.device:
        return self.default_device if device is None else torch.device(
            device)

    def tables_for(self, device=None):
        """``(tables, class columns)`` as tensors placed (and cached) on
        ``device`` — each replica's copy lives on its own device."""
        key = str(self._device(device))
        got = self._placed.get(key)
        if got is None:
            with self._place_lock:
                got = self._placed.get(key)
                if got is None:
                    dev = self._device(device)
                    tb = TensorizedTables(*(torch.from_numpy(a).to(dev)
                                            for a in self._tables_np))
                    cols = [torch.from_numpy(
                        np.nonzero(self._cls_np == k)[0]).to(dev)
                        for k in range(self.num_class)]
                    got = (tb, cols)
                    self._placed[key] = got
        return got

    def _as_f32_matrix(self, X, device=None) -> torch.Tensor:
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[1] != self.num_features:
            raise ValueError(
                f"CompiledEnsemble expects [rows, {self.num_features}] "
                f"features, got {X.shape}")
        return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
            self._device(device))

    def _check_version(self):
        if self.booster._model_version != self.model_version:
            raise RuntimeError(
                "model version moved under a CompiledEnsemble — "
                "registered models are serving-only; swap in a new "
                "version instead of training in place")

    # -- prediction ----------------------------------------------------
    def predict_leaf(self, X, device=None) -> np.ndarray:
        """[n, T] int32 leaf indices (``pred_leaf`` output)."""
        self._check_version()
        tb, _ = self.tables_for(device)
        Xd = self._as_f32_matrix(X, device)
        return _tensor_leaves(tb, Xd, depth=self.depth).cpu().numpy()

    def predict(self, X, device=None) -> np.ndarray:
        """The exact serving path: device walk + host f64 reduction in
        tree order + shared finalize."""
        if self.pred_leaf:
            return self.predict_leaf(X, device)
        leaf = self.predict_leaf(X, device)
        raw = np.zeros((leaf.shape[0], self.num_class))
        cls = self._cls_np
        for i, lv in enumerate(self._leaf64):
            raw[:, cls[i]] += lv[leaf[:, i]]
        return self.booster._finalize_scores(
            raw, self._use, self.num_class, self.raw_score)

    def predict_device(self, X, device=None) -> np.ndarray:
        """Raw sums reduced on the device (f32 accumulation), finalized
        on the host."""
        self._check_version()
        tb, cols = self.tables_for(device)
        Xd = self._as_f32_matrix(X, device)
        raw = _tensor_reduced(tb, Xd, cols, depth=self.depth)
        return self.booster._finalize_scores(
            raw.cpu().numpy().astype(np.float64), self._use,
            self.num_class, self.raw_score)

    # -- warmup / introspection ---------------------------------------
    def warm(self, rungs: Sequence[int], device=None) -> "CompiledEnsemble":
        """Place the tables and run every batch-ladder rung once, off
        the serving path."""
        for r in sorted(set(int(r) for r in rungs)):
            self.predict(np.zeros((r, self.num_features)), device=device)
            self._warmed.add(r)
        return self

    def describe(self) -> dict:
        return {"num_trees": self.num_trees, "depth": self.depth,
                "num_class": self.num_class,
                "max_nodes": int(self._tables_np.feature.shape[1]),
                "warmed_rungs": sorted(self._warmed),
                "placed_devices": len(self._placed)}
