"""Tree traversal over binned rows, in plain PyTorch.

Port of ``lightgbm_tpu/ops/predict.py``: every row walks a device tree
(``TreeArrays`` numbering: ``split_feature`` is -1 at leaves, children
are node ids) in lock-step, one gather + compare per level, for a fixed
number of levels so the walk needs no host sync.
"""

from __future__ import annotations

import torch

__all__ = ["row_feature_gather", "predict_bins_leaf", "predict_bins_value"]


def row_feature_gather(bins: torch.Tensor, feat: torch.Tensor
                       ) -> torch.Tensor:
    """bins[r, feat[r]] as int32."""
    return torch.gather(bins, 1, feat.to(torch.int64)[:, None])[:, 0] \
        .to(torch.int32)


def predict_bins_leaf(tree, nan_bin_pf: torch.Tensor, bins: torch.Tensor,
                      max_levels: int) -> torch.Tensor:
    """[R] node id of the leaf each binned row lands in
    (NumericalDecision / CategoricalDecision of tree.h)."""
    R = bins.shape[0]
    BW = tree.cat_bitset.shape[1]
    node = torch.zeros(R, dtype=torch.int64, device=bins.device)
    for _ in range(max_levels):
        feat = tree.split_feature[node]
        internal = feat >= 0
        featc = feat.clamp(min=0)
        binv = row_feature_gather(bins, featc)
        thr = tree.threshold_bin[node]
        nb = nan_bin_pf[featc]
        isnan = (binv == nb) & (nb >= 0)
        cat = tree.is_cat[node]
        word = (binv >> 5).clamp(0, BW - 1).to(torch.int64)
        wval = tree.cat_bitset[node].gather(1, word[:, None])[:, 0]
        in_set = ((wval >> (binv & 31).to(torch.int64)) & 1) == 1
        go_left = torch.where(cat, in_set, binv <= thr)
        go_left = torch.where(isnan & ~cat, tree.default_left[node],
                              go_left)
        nxt = torch.where(go_left, tree.left_child[node],
                          tree.right_child[node]).to(torch.int64)
        node = torch.where(internal, nxt, node)
    return node


def predict_bins_value(tree, nan_bin_pf: torch.Tensor, bins: torch.Tensor,
                       max_levels: int) -> torch.Tensor:
    """[R] unshrunk leaf output of one device tree."""
    return tree.node_value[predict_bins_leaf(tree, nan_bin_pf, bins,
                                             max_levels)]
