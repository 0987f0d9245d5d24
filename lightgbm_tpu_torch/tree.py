"""Host-side tree model + LightGBM-v4-compatible text serialization.

Analog of the reference ``include/LightGBM/tree.h`` / ``src/io/tree.cpp``
(SoA node arrays, text round-trip at tree.cpp:339,697) and the per-tree
blocks of ``src/boosting/gbdt_model_text.cpp``.

The on-device tree (boosting/tree_builder.TreeArrays) uses flat node ids;
this module renumbers into the reference's scheme — internal nodes by split
order, leaves by leaf slot, children encoded as ``node_idx`` or ``~leaf_idx``
— so saved models are loadable by stock LightGBM tooling and vice versa.

decision_type bit layout (tree.h): bit0 = categorical, bit1 = default_left,
bits 2-3 = missing_type (0 none / 1 zero / 2 nan).
"""

from __future__ import annotations

import numpy as np
from typing import Dict, List

from .binning import MISSING_ZERO, MISSING_NAN

__all__ = ["Tree"]

_CAT_BIT = 1
_DEFAULT_LEFT_BIT = 2
_MISSING_SHIFT = 2  # bits 2-3 after the two flags


def _missing_from_decision(dt: int) -> int:
    return (dt >> _MISSING_SHIFT) & 3


class Tree:
    """One decision tree in reference numbering (host, NumPy)."""

    def __init__(self, num_leaves: int):
        self.num_leaves = num_leaves
        n_int = max(num_leaves - 1, 0)
        self.split_feature = np.zeros(n_int, np.int32)
        self.threshold = np.zeros(n_int, np.float64)      # real-valued
        self.threshold_bin = np.zeros(n_int, np.int32)    # for binned predict
        self.decision_type = np.zeros(n_int, np.int32)
        self.split_gain = np.zeros(n_int, np.float64)
        self.left_child = np.zeros(n_int, np.int32)
        self.right_child = np.zeros(n_int, np.int32)
        self.internal_value = np.zeros(n_int, np.float64)
        self.internal_weight = np.zeros(n_int, np.float64)
        self.internal_count = np.zeros(n_int, np.int64)
        self.leaf_value = np.zeros(num_leaves, np.float64)
        self.leaf_weight = np.zeros(num_leaves, np.float64)
        self.leaf_count = np.zeros(num_leaves, np.int64)
        self.shrinkage = 1.0
        # categorical split storage (tree.h cat_boundaries_/cat_threshold_)
        self.num_cat = 0
        self.cat_boundaries = [0]
        self.cat_threshold: List[int] = []
        # bin-space subsets per cat split (in-session binned replay only)
        self.cat_bitset_bins: List[np.ndarray] = []
        # linear-tree leaves (tree.h leaf_const_/leaf_coeff_/leaf_features_)
        self.is_linear = False
        self.leaf_const = np.zeros(num_leaves, np.float64)
        self.leaf_features: List[List[int]] = [[] for _ in range(num_leaves)]
        self.leaf_coeff: List[List[float]] = [[] for _ in range(num_leaves)]

    # ------------------------------------------------------------------
    @classmethod
    def from_device(cls, t, bin_mappers, used_features,
                    shrinkage: float) -> "Tree":
        """Convert a tree_builder.TreeArrays pytree (host numpy'd)."""
        num_leaves = int(t.num_leaves)
        num_nodes = int(t.num_nodes)
        tree = cls(num_leaves)
        tree.shrinkage = shrinkage

        sf = np.asarray(t.split_feature)[:num_nodes]
        internal_nodes = np.nonzero(sf >= 0)[0]
        # split order == creation order of children (node ids are assigned
        # monotonically per split)
        lc = np.asarray(t.left_child)[:num_nodes]
        order = np.argsort(lc[internal_nodes], kind="stable")
        internal_nodes = internal_nodes[order]
        int_idx = {int(n): i for i, n in enumerate(internal_nodes)}

        leaf2node = np.asarray(t.leaf2node)[:num_leaves]
        leaf_idx = {int(n): s for s, n in enumerate(leaf2node)}

        if num_leaves == 1:
            tree.leaf_value[0] = float(np.asarray(t.node_value)[0]) * shrinkage
            tree.leaf_weight[0] = float(np.asarray(t.node_hess)[0])
            tree.leaf_count[0] = int(np.asarray(t.node_count)[0])
            return tree

        thrb = np.asarray(t.threshold_bin)
        dl = np.asarray(t.default_left)
        cat = np.asarray(t.is_cat)
        bitset = np.asarray(t.cat_bitset)
        rc = np.asarray(t.right_child)
        gain = np.asarray(t.gain)
        val = np.asarray(t.node_value)
        cnt = np.asarray(t.node_count)
        hes = np.asarray(t.node_hess)

        for i, n in enumerate(internal_nodes):
            f_local = int(sf[n])
            f_global = int(used_features[f_local])
            mapper = bin_mappers[f_global]
            tree.split_feature[i] = f_global
            tree.threshold_bin[i] = int(thrb[n])
            dt = 0
            if cat[n]:
                dt |= _CAT_BIT
                tree.threshold[i] = tree.num_cat  # index into cat storage
                # decode the bin-space subset, map bins -> category values
                words = bitset[n].astype(np.uint32)
                bin_ids = [w * 32 + b for w in range(len(words))
                           for b in range(32) if (int(words[w]) >> b) & 1]
                tree._append_cat_bitset(
                    [int(mapper.categories[bi]) for bi in bin_ids])
                tree.cat_bitset_bins.append(words)
            else:
                dt |= (mapper.missing_type & 3) << _MISSING_SHIFT
                if dl[n]:
                    dt |= _DEFAULT_LEFT_BIT
                tree.threshold[i] = mapper.bin_to_threshold_value(
                    int(thrb[n]))
            tree.decision_type[i] = dt
            tree.split_gain[i] = float(gain[n])
            tree.internal_value[i] = float(val[n]) * shrinkage
            tree.internal_weight[i] = float(hes[n])
            tree.internal_count[i] = int(cnt[n])
            for child_arr, out in ((lc, tree.left_child),
                                   (rc, tree.right_child)):
                c = int(child_arr[n])
                out[i] = int_idx[c] if c in int_idx else ~leaf_idx[c]

        for s in range(num_leaves):
            n = int(leaf2node[s])
            tree.leaf_value[s] = float(val[n]) * shrinkage
            tree.leaf_weight[s] = float(hes[n])
            tree.leaf_count[s] = int(cnt[n])
        return tree

    @classmethod
    def from_device_batch(cls, host_trees, bin_mappers, used_features,
                          shrinkage: float):
        """Convert one iteration's K device-built trees (already pulled
        to host — the fused trainer's sync() fetches the whole pending
        ring in ONE device transfer, then decodes here) into ``Tree``
        models. The per-tree decode is host-only numpy; keeping it out
        of the training inner loop is what lets the fused step run
        sync-free between eval points."""
        return [cls.from_device(t, bin_mappers, used_features, shrinkage)
                for t in host_trees]

    def _append_cat_bitset(self, categories: List[int]):
        """Append one categorical split's bitset (tree.cpp cat storage)."""
        maxc = max(categories)
        nwords = maxc // 32 + 1
        words = [0] * nwords
        for c in categories:
            words[c // 32] |= (1 << (c % 32))
        self.cat_threshold.extend(words)
        self.cat_boundaries.append(len(self.cat_threshold))
        self.num_cat += 1

    # ------------------------------------------------------------------
    def _traverse(self, X: np.ndarray) -> np.ndarray:
        """Vectorized raw-feature traversal (tree.h Predict decision path);
        returns the leaf index per row. Decision semantics live in
        _go_left_all (shared with SHAP)."""
        n = X.shape[0]
        if self.num_leaves == 1:
            return np.zeros(n, np.int32)
        gl = self._go_left_all(X)          # [n, NI]
        node = np.zeros(n, np.int32)       # >=0: internal idx; <0: ~leaf
        active = np.ones(n, bool)
        out = np.zeros(n, np.int32)
        rows = np.arange(n)
        for _ in range(self.num_leaves):   # depth bound
            if not active.any():
                break
            idx = node[active]
            go_left = gl[rows[active], idx]
            nxt = np.where(go_left, self.left_child[idx],
                           self.right_child[idx])
            node[active] = nxt
            leaf_now = nxt < 0
            act_idx = np.nonzero(active)[0]
            done = act_idx[leaf_now]
            out[done] = ~nxt[leaf_now]
            active[done] = False
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaves = self._traverse(X)
        if not self.is_linear:
            return self.leaf_value[leaves]
        # linear leaves: const + coeff . x, NaN in any leaf feature falls
        # back to the piecewise-constant output (tree.cpp:133-149)
        out = np.empty(len(leaves), np.float64)
        for s in range(self.num_leaves):
            rows = np.nonzero(leaves == s)[0]
            if len(rows) == 0:
                continue
            feats = self.leaf_features[s]
            if not feats:
                out[rows] = self.leaf_const[s]
                continue
            vals = X[np.ix_(rows, feats)]
            nan = np.isnan(vals).any(axis=1)
            lin = self.leaf_const[s] + vals @ np.asarray(self.leaf_coeff[s])
            out[rows] = np.where(nan, self.leaf_value[s], lin)
        return out

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        return self._traverse(X)

    # ------------------------------------------------------------------
    def _traverse_binned(self, bins: np.ndarray, used_features: np.ndarray,
                         nan_bins: np.ndarray) -> np.ndarray:
        """Leaf index per BINNED row (threshold_bin comparison — the same
        decisions the on-device builder made). Only valid for trees built
        in-session (threshold_bin populated); used by rollback/refit score
        replay without needing the raw feature matrix.

        bins: [R, F_local] over used features; used_features maps local ->
        global; nan_bins: [F_local] nan bin per local feature (-1 none).
        """
        global_to_local = {int(g): i for i, g in enumerate(used_features)}
        n = bins.shape[0]
        if self.num_leaves == 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)
        active = np.ones(n, bool)
        out = np.zeros(n, np.int32)
        feat_local = np.asarray(
            [global_to_local[int(f)] for f in self.split_feature], np.int32)
        for _ in range(self.num_leaves):
            if not active.any():
                break
            idx = node[active]
            fl = feat_local[idx]
            v = bins[active, fl]
            dt = self.decision_type[idx]
            is_cat = (dt & _CAT_BIT) != 0
            thr = self.threshold_bin[idx]
            nb = nan_bins[fl]
            isnan = (v == nb) & (nb >= 0)
            go_left = np.where(is_cat, v == thr, v <= thr)
            defl = (dt & _DEFAULT_LEFT_BIT) != 0
            go_left = np.where(isnan & ~is_cat, defl, go_left)
            nxt = np.where(go_left, self.left_child[idx],
                           self.right_child[idx])
            node[active] = nxt
            leaf_now = nxt < 0
            act_idx = np.nonzero(active)[0]
            done = act_idx[leaf_now]
            out[done] = ~nxt[leaf_now]
            active[done] = False
        return out

    def predict_binned(self, bins: np.ndarray, used_features: np.ndarray,
                       nan_bins: np.ndarray) -> np.ndarray:
        return self.leaf_value[
            self._traverse_binned(bins, used_features, nan_bins)]

    # ------------------------------------------------------------------
    def to_text(self, tree_id: int) -> str:
        """One ``Tree=<id>`` block (gbdt_model_text.cpp:311 format)."""
        def join(a, fmt="{}"):
            if fmt == "{!r}":  # full-precision float round-trip
                return " ".join(repr(float(x)) for x in a)
            return " ".join(fmt.format(x) for x in a)

        lines = [f"Tree={tree_id}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={self.num_cat}"]
        if self.num_leaves > 1:
            lines += [
                "split_feature=" + join(self.split_feature),
                "split_gain=" + join(self.split_gain, "{:g}"),
                "threshold=" + join(self.threshold, "{!r}").replace(
                    "inf", "1.7976931348623157e+308"),
                "decision_type=" + join(self.decision_type),
                "left_child=" + join(self.left_child),
                "right_child=" + join(self.right_child),
                "leaf_value=" + join(self.leaf_value, "{!r}"),
                "leaf_weight=" + join(self.leaf_weight, "{!r}"),
                "leaf_count=" + join(self.leaf_count),
                "internal_value=" + join(self.internal_value, "{!r}"),
                "internal_weight=" + join(self.internal_weight, "{!r}"),
                "internal_count=" + join(self.internal_count),
            ]
            if self.num_cat > 0:
                lines += ["cat_boundaries=" + join(self.cat_boundaries),
                          "cat_threshold=" + join(self.cat_threshold)]
        else:
            lines += ["leaf_value=" + join(self.leaf_value, "{!r}")]
        lines += [f"is_linear={int(self.is_linear)}"]
        if self.is_linear:
            # tree.cpp ToString linear block: per-leaf const, feature
            # count, then flattened features / coefficients
            lines += [
                "leaf_const=" + join(self.leaf_const, "{!r}"),
                "num_features=" + " ".join(
                    str(len(c)) for c in self.leaf_coeff),
                "leaf_features=" + " ".join(
                    " ".join(str(f) for f in fs)
                    for fs in self.leaf_features if fs),
                "leaf_coeff=" + " ".join(
                    " ".join(repr(float(c)) for c in cs)
                    for cs in self.leaf_coeff if cs),
            ]
        lines += [f"shrinkage={self.shrinkage:g}", ""]
        return "\n".join(lines)

    @classmethod
    def from_text(cls, block: str) -> "Tree":
        """Parse one Tree block (tree.cpp:697 Tree(const char*) analog)."""
        kv: Dict[str, str] = {}
        for line in block.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        num_leaves = int(kv["num_leaves"])
        tree = cls(num_leaves)

        def arr(key, dtype, n):
            if key not in kv or not kv[key]:
                return np.zeros(n, dtype)
            return np.asarray(kv[key].split(), dtype=dtype)

        tree.leaf_value = arr("leaf_value", np.float64, num_leaves)
        if num_leaves > 1:
            n_int = num_leaves - 1
            tree.split_feature = arr("split_feature", np.int32, n_int)
            tree.split_gain = arr("split_gain", np.float64, n_int)
            tree.threshold = arr("threshold", np.float64, n_int)
            tree.decision_type = arr("decision_type", np.int32, n_int)
            tree.left_child = arr("left_child", np.int32, n_int)
            tree.right_child = arr("right_child", np.int32, n_int)
            tree.leaf_weight = arr("leaf_weight", np.float64, num_leaves)
            tree.leaf_count = arr("leaf_count", np.int64, num_leaves)
            tree.internal_value = arr("internal_value", np.float64, n_int)
            tree.internal_weight = arr("internal_weight", np.float64, n_int)
            tree.internal_count = arr("internal_count", np.int64, n_int)
            tree.num_cat = int(kv.get("num_cat", "0"))
            if tree.num_cat > 0:
                tree.cat_boundaries = [int(x) for x in
                                       kv["cat_boundaries"].split()]
                tree.cat_threshold = [int(x) for x in
                                      kv["cat_threshold"].split()]
        if kv.get("is_linear", "0") == "1":
            tree.is_linear = True
            tree.leaf_const = arr("leaf_const", np.float64, num_leaves)
            nf = arr("num_features", np.int64, num_leaves)
            feats = [int(x) for x in kv.get("leaf_features", "").split()]
            coefs = [float(x) for x in kv.get("leaf_coeff", "").split()]
            pos = 0
            for s in range(num_leaves):
                n = int(nf[s])
                tree.leaf_features[s] = feats[pos:pos + n]
                tree.leaf_coeff[s] = coefs[pos:pos + n]
                pos += n
        tree.shrinkage = float(kv.get("shrinkage", "1"))
        return tree

    # ------------------------------------------------------------------
    # SHAP contributions (tree.h:141 PredictContrib — the TreeExplainer
    # path-integration algorithm of Lundberg et al., as in tree.cpp
    # TreeSHAP; recursion over the node arrays with EXTEND/UNWIND over
    # the unique feature path)
    def expected_value(self) -> float:
        total = self.leaf_count.sum()
        if total <= 0:
            return float(self.leaf_value.mean())
        return float((self.leaf_value * self.leaf_count).sum() / total)

    def _node_weight(self, node: int) -> float:
        """Row count reaching a node (internal idx >=0, leaf via ~idx)."""
        if node >= 0:
            return float(self.internal_count[node])
        return float(self.leaf_count[~node])

    def predict_contrib_reference(self, X: np.ndarray) -> np.ndarray:
        """Per-row recursive TreeSHAP — the direct transcription of the
        reference algorithm (tree.cpp TreeSHAP). Kept as the slow oracle
        for the vectorized path below; use predict_contrib."""
        n, F = X.shape
        out = np.zeros((n, F + 1))
        out[:, -1] = self.expected_value()
        if self.num_leaves == 1:
            return out
        gl = self._go_left_all(X)
        for r in range(n):
            self._tree_shap(gl[r], out[r], 0, 1.0, 1.0, -1, [])
        return out

    # -- vectorized TreeSHAP ------------------------------------------
    # The recursion above walks EXTEND/UNWIND per (row, node). The
    # vectorized form exploits two structural facts:
    # (1) at a leaf, the EXTEND polynomial is a symmetric function of the
    #     path's UNIQUE features with merged fractions (duplicate feature
    #     occurrences multiply: one = AND of direction matches, zero =
    #     product of cover ratios) — extend order never matters;
    # (2) per row, one_fraction is BINARY, so the whole row dependence is
    #     a [rows, leaves, slots] 0/1 tensor of "did this row follow the
    #     path at every node of this feature".
    # So: precompute per-leaf path slot tables once per tree (host), then
    # run the EXTEND scan and the per-slot UNWIND totals as NumPy array
    # programs over (rows x leaves x slots) — Python loop counts are
    # O(depth) and O(depth) instead of O(rows * nodes * depth^2).
    def _path_data(self):
        if getattr(self, "_paths_cache", None) is not None:
            return self._paths_cache
        L = self.num_leaves
        raw_paths = [None] * L  # leaf slot -> (nodes, dirs)
        stack = [(0, [], [])]
        while stack:
            node, nodes, dirs = stack.pop()
            if node < 0:
                raw_paths[~node] = (nodes, dirs)
                continue
            stack.append((int(self.left_child[node]), nodes + [node],
                          dirs + [1]))
            stack.append((int(self.right_child[node]), nodes + [node],
                          dirs + [0]))
        P = max(len(p[0]) for p in raw_paths)
        slot_lists = []
        for nodes, dirs in raw_paths:
            feats = {}
            for p, (nd, dr) in enumerate(zip(nodes, dirs)):
                feats.setdefault(int(self.split_feature[nd]), []).append(p)
            slot_lists.append(list(feats.items()))
        D = max(len(s) for s in slot_lists)

        path_node = np.full((L, P), -1, np.int32)
        path_dir = np.zeros((L, P), np.int8)
        path_slot = np.full((L, P), -1, np.int32)
        slot_feat = np.full((L, D), -1, np.int32)
        slot_zero = np.ones((L, D), np.float64)
        d_len = np.zeros(L, np.int32)
        for l, ((nodes, dirs), slots) in enumerate(zip(raw_paths,
                                                       slot_lists)):
            path_node[l, :len(nodes)] = nodes
            path_dir[l, :len(dirs)] = dirs
            d_len[l] = len(slots)
            for s, (f, occs) in enumerate(slots):
                slot_feat[l, s] = f
                for p in occs:
                    path_slot[l, p] = s
                    nd = nodes[p]
                    child = (int(self.left_child[nd]) if dirs[p]
                             else int(self.right_child[nd]))
                    w = self._node_weight(nd)
                    slot_zero[l, s] *= (self._node_weight(child) / w
                                        if w > 0 else 0.0)
        # mismatch-count map [L, P, D]: path position -> slot one-hot
        slot_map = np.zeros((L, P, D), np.float64)
        for l in range(L):
            for p in range(P):
                if path_slot[l, p] >= 0:
                    slot_map[l, p, path_slot[l, p]] = 1.0
        # scatter groups: feature id -> (leaf idx array, slot idx array)
        groups = {}
        for l in range(L):
            for s in range(int(d_len[l])):
                ls, ss = groups.setdefault(int(slot_feat[l, s]), ([], []))
                ls.append(l)
                ss.append(s)
        groups = {f: (np.asarray(ls, np.intp), np.asarray(ss, np.intp))
                  for f, (ls, ss) in groups.items()}
        self._paths_cache = (path_node, path_dir, slot_map, slot_feat,
                             slot_zero, d_len, groups)
        return self._paths_cache

    def _go_left_all(self, X: np.ndarray) -> np.ndarray:
        """[n, num_internal] decision per row per internal node (the same
        semantics as _decision, batched)."""
        n = X.shape[0]
        ni = self.num_leaves - 1
        v = X[:, self.split_feature]                     # [n, NI]
        dt = self.decision_type
        is_cat = (dt & _CAT_BIT) != 0
        out = np.zeros((n, ni), bool)
        num = ~is_cat
        if num.any():
            vn = v[:, num]
            nan = np.isnan(vn)
            mt = _missing_from_decision(dt[num])
            vn = np.where(nan & (mt != MISSING_NAN), 0.0, vn)
            gl = vn <= self.threshold[num]
            defl = (dt[num] & _DEFAULT_LEFT_BIT) != 0
            # missing routes to the DEFAULT side: NaN under
            # MissingType::NaN, and |v| <= kZeroThreshold (1e-35,
            # incl. NaN folded to 0 above) under MissingType::Zero —
            # tree.h:359 NumericalDecision (a zero must NOT fall
            # through to the threshold compare)
            miss = ((nan & (mt == MISSING_NAN))
                    | ((np.abs(vn) <= 1e-35) & (mt == MISSING_ZERO)))
            out[:, num] = np.where(miss, defl, gl)
        for j in np.nonzero(is_cat)[0]:
            cat_idx = int(self.threshold[j])
            lo = self.cat_boundaries[cat_idx]
            hi = self.cat_boundaries[cat_idx + 1]
            words = np.asarray(self.cat_threshold[lo:hi], np.int64)
            vv = v[:, j]
            valid = ~np.isnan(vv) & (vv >= 0)
            c = np.where(valid, vv, 0).astype(np.int64)
            w = c >> 5
            ok = w < (hi - lo)
            bits = (words[np.clip(w, 0, max(hi - lo - 1, 0))]
                    >> (c & 31)) & 1
            out[:, j] = valid & ok & bits.astype(bool)
        return out

    def predict_contrib(self, X: np.ndarray,
                        row_chunk: int = 0) -> np.ndarray:
        """[n, num_features + 1] SHAP values (last column = expected
        value); vectorized TreeSHAP (see block comment above)."""
        if self.is_linear:
            raise NotImplementedError(
                "SHAP contributions are not supported for linear trees "
                "(matches the reference's restriction)")
        n, F = X.shape
        phi = np.zeros((n, F + 1))
        phi[:, -1] = self.expected_value()
        if self.num_leaves == 1:
            return phi
        (path_node, path_dir, slot_map, slot_feat, slot_zero, d_len,
         groups) = self._path_data()
        L, P = path_node.shape
        D = slot_feat.shape[1]
        go_left = self._go_left_all(X)                   # [n, NI]
        if row_chunk <= 0:
            row_chunk = max(1, (1 << 24) // max(L * (D + 1), 1))

        karr = d_len.astype(np.float64)[None, :, None]   # [1, L, 1]
        kp1 = karr + 1.0
        valid_slot = (np.arange(D)[None, :] < d_len[:, None])  # [L, D]
        w_idx = np.arange(D + 1, dtype=np.float64)
        leaf_val = self.leaf_value[None, :, None]        # [1, L, 1]

        for lo_r in range(0, n, row_chunk):
            sl = slice(lo_r, min(lo_r + row_chunk, n))
            c = sl.stop - sl.start
            # match per path position; padding positions always match
            m = go_left[sl][:, np.clip(path_node, 0, None)] \
                == (path_dir[None, :, :] != 0)           # [c, L, P]
            mism = (~m & (path_node >= 0)[None]).astype(np.float64)
            one = (np.einsum("clp,lpd->cld", mism, slot_map) == 0) \
                .astype(np.float64)                      # [c, L, D]
            # EXTEND: pw[p] <- zero*pw[p]*(m-p)/(m+1) + one*pw[p-1]*p/(m+1)
            pw = np.zeros((c, L, D + 1))
            pw[..., 0] = 1.0
            for step in range(1, D + 1):
                vmask = valid_slot[:, step - 1][None, :, None]  # [1, L, 1]
                o = one[:, :, step - 1][:, :, None]
                z = slot_zero[:, step - 1][None, :, None]
                shifted = np.concatenate(
                    [np.zeros((c, L, 1)), pw[..., :-1]], axis=2)
                new = (z * pw * np.maximum(step - w_idx, 0.0)
                       + o * shifted * w_idx) / (step + 1.0)
                pw = np.where(vmask, new, pw)
            # UNWIND totals per excluded slot i (vectorized over i)
            tmp = np.take_along_axis(
                pw, d_len[None, :, None].astype(np.intp), axis=2)
            tmp = np.broadcast_to(tmp, (c, L, D)).copy()
            total = np.zeros((c, L, D))
            one_b = one != 0
            with np.errstate(divide="ignore", invalid="ignore"):
                for j in range(D - 1, -1, -1):
                    active = (j < d_len)[None, :, None]
                    pwj = pw[:, :, j:j + 1]
                    t = tmp * kp1 / (j + 1.0)
                    total1 = total + t
                    tmp1 = pwj - t * slot_zero[None] * (karr - j) / kp1
                    total0 = total + pwj * kp1 / (slot_zero[None]
                                                  * (karr - j))
                    total = np.where(
                        active, np.where(one_b, total1, total0), total)
                    tmp = np.where(active & one_b, tmp1, tmp)
            contrib = np.where(
                valid_slot[None], total * (one - slot_zero[None]) * leaf_val,
                0.0)                                     # [c, L, D]
            for f, (ls, ss) in groups.items():
                phi[sl, f] += contrib[:, ls, ss].sum(axis=1)
        return phi

    def _tree_shap(self, gl_row, phi, node, p_zero, p_one, p_feat, path):
        # gl_row: [num_internal] bool — this row's decisions, precomputed
        # by _go_left_all so the missing/categorical semantics live in
        # exactly one place
        # path: list of [feat, zero_frac, one_frac, pweight]; elements are
        # deep-copied — EXTEND mutates weights and the hot/cold branches
        # must not see each other's updates
        path = [list(p) for p in path] + \
            [[p_feat, p_zero, p_one, 1.0 if len(path) == 0 else 0.0]]
        # EXTEND
        for i in range(len(path) - 2, -1, -1):
            path[i + 1][3] += p_one * path[i][3] * (i + 1) / len(path)
            path[i][3] = p_zero * path[i][3] * (len(path) - 1 - i) \
                / len(path)
        if node < 0:  # leaf
            leaf_val = self.leaf_value[~node]
            for i in range(1, len(path)):
                # UNWIND sum of pweights excluding element i
                total = 0.0
                onew, zerow = path[i][2], path[i][1]
                pw = list(p[3] for p in path)
                k = len(path) - 1
                tmp = pw[k]
                for j in range(k - 1, -1, -1):
                    if onew != 0:
                        t = tmp * (k + 1) / ((j + 1) * onew)
                        total += t
                        tmp = pw[j] - t * zerow * (k - j) / (k + 1)
                    else:
                        total += pw[j] / (zerow * (k - j) / (k + 1))
                phi[path[i][0]] += total * (onew - zerow) * leaf_val
            return
        hot, cold = ((self.left_child[node], self.right_child[node])
                     if gl_row[node]
                     else (self.right_child[node], self.left_child[node]))
        w = self._node_weight(node)
        hot_zero = self._node_weight(hot) / w if w > 0 else 0.0
        cold_zero = self._node_weight(cold) / w if w > 0 else 0.0
        f = int(self.split_feature[node])
        # if f already on path, unwind its previous occurrence
        incoming_zero, incoming_one = 1.0, 1.0
        prev = next((i for i in range(len(path))
                     if path[i][0] == f), None)
        if prev is not None:
            incoming_zero, incoming_one = path[prev][1], path[prev][2]
            path = self._unwind(path, prev)
        self._tree_shap(gl_row, phi, hot, incoming_zero * hot_zero,
                        incoming_one, f, path)
        self._tree_shap(gl_row, phi, cold, incoming_zero * cold_zero,
                        0.0, f, path)

    @staticmethod
    def _unwind(path, i):
        path = [list(p) for p in path]
        k = len(path) - 1
        onew, zerow = path[i][2], path[i][1]
        tmp = path[k][3]
        for j in range(k - 1, -1, -1):
            if onew != 0:
                t = tmp * (k + 1) / ((j + 1) * onew)
                tmp = path[j][3] - t * zerow * (k - j) / (k + 1)
                path[j][3] = t
            else:
                path[j][3] = path[j][3] * (k + 1) / (zerow * (k - j))
        for j in range(i, k):
            path[j][0] = path[j + 1][0]
            path[j][1] = path[j + 1][1]
            path[j][2] = path[j + 1][2]
        return path[:-1]

    # ------------------------------------------------------------------
    def to_json(self) -> Dict:
        """Tree dict in the reference's DumpModel schema
        (tree.cpp:411 ToJSON / NodeToJSON) — nested tree_structure with
        split/leaf records."""
        out = {
            "num_leaves": int(self.num_leaves),
            "num_cat": int(self.num_cat),
            "shrinkage": float(self.shrinkage),
            "tree_features": sorted(
                {int(f) for f in self.split_feature}),
        }
        if self.num_leaves == 1:
            out["tree_structure"] = {
                "leaf_value": float(self.leaf_value[0]),
                "leaf_count": int(self.leaf_count[0]),
            }
            return out

        def make_node(idx: int):
            if idx < 0:
                s = ~idx
                rec = {
                    "leaf_index": int(s),
                    "leaf_value": float(self.leaf_value[s]),
                    "leaf_weight": float(self.leaf_weight[s]),
                    "leaf_count": int(self.leaf_count[s]),
                }
                if self.is_linear:  # LinearModelToJSON (tree.cpp:446)
                    rec["leaf_const"] = float(self.leaf_const[s])
                    rec["leaf_features"] = [int(f) for f
                                            in self.leaf_features[s]]
                    rec["leaf_coeff"] = [float(c) for c
                                         in self.leaf_coeff[s]]
                return rec
            dt = int(self.decision_type[idx])
            rec = {
                "split_index": int(idx),
                "split_feature": int(self.split_feature[idx]),
                "split_gain": float(self.split_gain[idx]),
            }
            if dt & _CAT_BIT:
                cat_idx = int(self.threshold[idx])
                lo = self.cat_boundaries[cat_idx]
                hi = self.cat_boundaries[cat_idx + 1]
                cats = [c for c in range((hi - lo) * 32)
                        if (self.cat_threshold[lo + c // 32]
                            >> (c % 32)) & 1]
                rec["threshold"] = "||".join(str(c) for c in cats)
                rec["decision_type"] = "=="
            else:
                rec["threshold"] = float(self.threshold[idx])
                rec["decision_type"] = "<="
            rec["default_left"] = bool(dt & _DEFAULT_LEFT_BIT)
            rec["missing_type"] = \
                ("None", "Zero", "NaN", "NaN")[_missing_from_decision(dt)]
            rec["internal_value"] = float(self.internal_value[idx])
            rec["internal_weight"] = float(self.internal_weight[idx])
            rec["internal_count"] = int(self.internal_count[idx])
            return rec

        # explicit-stack tree walk: leaf-wise trees can be chain-shaped
        # (depth ~ num_leaves), far past Python's recursion limit
        root = make_node(0)
        stack = [(root, 0)]
        while stack:
            rec, idx = stack.pop()
            for key, child in (("left_child", int(self.left_child[idx])),
                               ("right_child", int(self.right_child[idx]))):
                crec = make_node(child)
                rec[key] = crec
                if child >= 0:
                    stack.append((crec, child))
        out["tree_structure"] = root
        return out

    def scale(self, factor: float):
        """Shrinkage(rate) (tree.h): rescale every output in place —
        DART normalization and rollback arithmetic."""
        self.leaf_value *= factor
        self.internal_value *= factor
        if self.is_linear:
            self.leaf_const *= factor
            self.leaf_coeff = [[c * factor for c in cs]
                               for cs in self.leaf_coeff]
        self.shrinkage *= factor
        return self

    def num_nodes(self) -> int:
        return 2 * self.num_leaves - 1

    def feature_importance_split(self, num_features: int) -> np.ndarray:
        out = np.zeros(num_features)
        np.add.at(out, self.split_feature, 1.0)
        return out

    def feature_importance_gain(self, num_features: int) -> np.ndarray:
        out = np.zeros(num_features)
        np.add.at(out, self.split_feature, self.split_gain)
        return out
