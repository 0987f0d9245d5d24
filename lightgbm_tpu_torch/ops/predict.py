"""Tree traversal over binned rows, in plain PyTorch.

Port of ``lightgbm_tpu/ops/predict.py``: every row walks a device tree
(``TreeArrays`` numbering: ``split_feature`` is -1 at leaves, children
are node ids) in lock-step, one gather + compare per level, for a fixed
number of levels so the walk needs no host sync. On an EFB-bundled
matrix (``bundle_meta``) each row's bin is decoded from its feature's
bundle column (``efb.decode_feature_bins``), as the JAX walk does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..efb import decode_feature_bins

__all__ = ["row_feature_gather", "feature_bins", "predict_bins_leaf",
           "predict_bins_value"]


def row_feature_gather(bins: torch.Tensor, feat: torch.Tensor
                       ) -> torch.Tensor:
    """bins[r, feat[..., r]] as int32 (``feat`` [R], or [K, R] for K
    feature picks a row)."""
    R, C = bins.shape
    cell = (torch.arange(R, dtype=torch.int64, device=bins.device) * C
            + feat.long())
    return bins.reshape(-1)[cell].to(torch.int32)


def feature_bins(bins: torch.Tensor, feat: torch.Tensor, bundle_meta=None,
                 num_bins_pf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row r's bin of feature feat[..., r] as int32: a column gather, or
    on a bundled matrix (``bundle_meta`` = (bundle, offset, most-frequent
    bin) per feature) the decode of the feature's bundle column."""
    if bundle_meta is None:
        return row_feature_gather(bins, feat)
    b_gof, b_off, b_mfb = bundle_meta
    fl = feat.long()
    raw = row_feature_gather(bins, b_gof[fl])
    return decode_feature_bins(raw, b_off[fl], num_bins_pf[fl], b_mfb[fl],
                               xp=torch).to(torch.int32)


def predict_bins_leaf(tree, nan_bin_pf: torch.Tensor, bins: torch.Tensor,
                      max_levels: int, bundle_meta=None,
                      num_bins_pf: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """[R] node id of the leaf each binned row lands in
    (NumericalDecision / CategoricalDecision of tree.h); ``bundle_meta``
    and ``num_bins_pf`` for a bundled matrix."""
    R = bins.shape[0]
    BW = tree.cat_bitset.shape[1]
    node = torch.zeros(R, dtype=torch.int64, device=bins.device)
    for _ in range(max_levels):
        feat = tree.split_feature[node]
        internal = feat >= 0
        featc = feat.clamp(min=0)
        binv = feature_bins(bins, featc, bundle_meta, num_bins_pf)
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
                       max_levels: int, bundle_meta=None,
                       num_bins_pf: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """[R] unshrunk leaf output of one device tree."""
    return tree.node_value[predict_bins_leaf(tree, nan_bin_pf, bins,
                                             max_levels, bundle_meta,
                                             num_bins_pf)]
