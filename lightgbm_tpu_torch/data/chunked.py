"""Out-of-core leaf-wise tree growth over a streamed bin matrix (the port
of ``lightgbm_tpu/data/chunked.py``).

The resident builder (``boosting/tree_builder._grow``) reads the whole
``[R, F]`` bin matrix from the device. When that matrix must not live
there (``out_of_core=on``, a shard dataset, or a working set over the
device's capacity), this module grows the SAME tree from a stream of
fixed-size row chunks:

- the per-row state the rounds mutate, ``row_leaf`` [R] int32 and
  ``gh`` [R, 3], stays on the device (16 bytes a row; it is the [R, F]
  bin matrix that is too large, not these);
- each round re-streams the chunks (:class:`~.prefetch.ChunkPrefetcher`)
  and, per chunk, relabels the chunk's rows against the round's pending
  splits and adds their histogram to a carried accumulator: kernel B1
  (``ops.cuda_histogram.build_histograms_cuda``) with ``init``, the sums
  of the chunks before it. On the CPU the same call takes B1's plain
  version, which adds ``init`` first and then the chunk's block sums;
- the split search and the tree's bookkeeping between sweeps mirror the
  round body of ``tree_builder._grow`` for one class on its two-pass
  arm (B2 is never launched here: the JAX package's fused gate says
  "chunked rounds accumulate histograms across chunks").

With ``hist_subtraction`` (the default) each round streams only the W
smaller children, chosen from the cached split sums' count channel as
the JAX chunked builder chooses them, and derives the others from a
per-leaf raw parent cache ([L+1, F, B, 3] on the device); it is exact in
int32 (quantized) and rounds in f32. ``hist_subtraction=false`` rebuilds
every child, which is what the bit-identity tests pin.

Scope (``GBDT._chunked_gate_reason``): the serial simple round body —
bagging and GOSS, quantized gradients, categoricals (one-hot and sorted
subsets), feature_fraction, feature_contri and valid sets. EFB, linear
trees, CEGB, forced splits, monotone and interaction constraints,
per-node sampling and extra-trees keep the resident path.

Rounds stop once no leaf has a finite cached gain (one host read of a
flag a round, as the JAX chunked builder does); a skipped round would
have been a masked no-op. Nothing else reads the card from the host:
scalars are written with ``fill_`` (a host scalar assigned into a CUDA
tensor is a synchronous copy).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..boosting.tree_builder import TreeArrays, max_rounds_for
from ..ops import cuda_histogram as CH
from ..ops.histogram import HIST_CH
from ..ops.predict import row_feature_gather
from ..ops.split import NEG_INF, SplitParams, find_best_splits, leaf_output

__all__ = ["ArraySource", "ShardSource", "ChunkedTreeBuilder"]


# ----------------------------------------------------------------------
# chunk sources: host-side providers of binned rows by global row range


class ArraySource:
    """A host-resident bin matrix as a chunk source (in-memory data that
    trains chunked). A pinned host tensor stays reachable as ``tensor``:
    the prefetcher copies its chunks to the card straight from it."""

    def __init__(self, bins):
        self.tensor = None
        if isinstance(bins, torch.Tensor):
            bins = bins.cpu()
            if bins.is_pinned():
                self.tensor = bins
            bins = bins.numpy()
        self.bins = np.asarray(bins)

    @property
    def num_rows(self) -> int:
        return int(self.bins.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.bins.shape[1])

    def read_rows(self, lo: int, hi: int) -> np.ndarray:
        return self.bins[lo:hi]

    def close(self) -> None:
        pass


class ShardSource:
    """A ``.lgbtpu`` shard directory as one contiguous global row
    stream (mmap-backed; a read only touches the pages it spans)."""

    def __init__(self, readers):
        self.readers = sorted(readers, key=lambda r: r.row0)
        if not self.readers:
            raise ValueError("ShardSource needs at least one shard")

    @property
    def num_rows(self) -> int:
        last = self.readers[-1]
        return int(last.row0 + last.num_rows)

    @property
    def num_features(self) -> int:
        return int(self.readers[0].bins.shape[1])

    def read_rows(self, lo: int, hi: int) -> np.ndarray:
        parts = []
        for r in self.readers:
            a, b = max(lo, r.row0), min(hi, r.row0 + r.num_rows)
            if a < b:
                parts.append(r.read_rows(a - r.row0, b - r.row0))
        if not parts:
            raise ValueError(f"row range [{lo}, {hi}) outside shards")
        out = parts[0] if len(parts) == 1 else np.concatenate(parts)
        if out.shape[0] != hi - lo:
            raise ValueError(
                f"shard set has a gap inside row range [{lo}, {hi})")
        return out

    def close(self) -> None:
        for r in self.readers:
            r.close()


# ----------------------------------------------------------------------
# the chunked builder


class ChunkedTreeBuilder:
    """Leaf-wise growth of one tree a call, the round body around a
    chunk sweep. Built once per booster."""

    def __init__(self, *, num_bins_pf, nan_bin_pf, is_cat_pf,
                 num_leaves: int, leaf_batch: int, max_depth: int,
                 num_bins: int, split_params: SplitParams,
                 hist_dtype: str = "bfloat16", hist_sub: bool = True,
                 has_cat: bool = True,
                 cat_sorted_mask: Optional[torch.Tensor] = None,
                 max_sorted_bins: Optional[int] = None):
        self.num_bins_pf = num_bins_pf
        self.nan_bin_pf = nan_bin_pf
        self.is_cat_pf = is_cat_pf
        self.sp = split_params
        self.L = int(num_leaves)
        self.W = max(1, min(int(leaf_batch), self.L - 1))
        self.N1 = 2 * self.L
        self.B = int(num_bins)
        self.F = int(num_bins_pf.shape[0])
        self.BW = (self.B + 31) // 32
        self.max_depth = int(max_depth)
        self.hist_dtype = hist_dtype
        self.hist_sub = bool(hist_sub)
        self.has_cat = bool(has_cat)
        self.sorted_kw = ({} if cat_sorted_mask is None else
                          dict(cat_sorted_mask=cat_sorted_mask,
                               max_sorted_bins=max_sorted_bins))
        self.rounds_bound = max_rounds_for(self.L, self.W)

    # -------------------------- shared pieces -------------------------

    def _relabel(self, bmat, rl, pend):
        """The resident builder's partition update (``relabel`` of
        ``tree_builder._grow``) over any row window."""
        (p_active, p_feat, p_thr, p_dl, p_cat, p_right, p_bits) = pend
        DL = self.L
        rlc = torch.where(rl < 0, DL, rl).long()
        active = p_active[rlc]
        feat = p_feat[rlc]
        binv = row_feature_gather(bmat, feat)
        thr = p_thr[rlc]
        nb = self.nan_bin_pf[feat.long()]
        isnan = (binv == nb) & (nb >= 0)
        go_left = binv <= thr
        if self.has_cat:
            cat_row = p_cat[rlc]
            word = (binv >> 5).clamp(0, self.BW - 1).long()
            wval = p_bits.view(-1)[rlc * self.BW + word]
            in_set = ((wval >> (binv & 31).long()) & 1) == 1
            go_left = torch.where(cat_row, in_set, go_left)
            isnan = isnan & ~cat_row
        go_left = torch.where(isnan, p_dl[rlc], go_left)
        return torch.where(active & ~go_left, p_right[rlc], rl)

    def _sweep(self, pref, row_leaf, gh, slots, pend):
        """One pass over the chunks: relabel each chunk's rows (when a
        round's splits are pending) and add its histogram of ``slots``
        to the carried accumulator. Returns the [S, F, B, 3] sums."""
        acc = None
        for off, cb in pref.chunks():
            C = cb.shape[0]
            rl_c = row_leaf[off:off + C]
            if pend is not None:
                rl_c = self._relabel(cb, rl_c, pend)
                row_leaf[off:off + C] = rl_c
            acc = CH.build_histograms_cuda(
                cb, gh[off:off + C], rl_c.contiguous(), slots,
                num_bins=self.B, hist_dtype=self.hist_dtype, init=acc)
        return acc

    def _best(self, hist, slot_depth, slot_valid, slots_c, t, fmask,
              gain_scale):
        """``best_for`` of ``tree_builder._grow`` (one class, no
        constraints)."""
        S = hist.shape[0]
        parent_out = t.node_value[t.leaf2node[slots_c].long()]
        bs = find_best_splits(
            hist, self.num_bins_pf, self.nan_bin_pf, self.is_cat_pf,
            self.sp, feature_mask=fmask[None, :].expand(S, self.F),
            parent_output=parent_out, slot_depth=slot_depth,
            gain_scale=gain_scale, **self.sorted_kw)
        g = bs["gain"]
        if self.max_depth > 0:
            g = torch.where(slot_depth < self.max_depth, g, NEG_INF)
        bs["gain"] = torch.where(slot_valid, g, NEG_INF)
        return bs

    # -------------------------- the build -----------------------------

    def build(self, pref, gh, row_leaf0, feature_mask, *,
              quant_scales: Optional[torch.Tensor] = None,
              gain_scale: Optional[torch.Tensor] = None,
              valid_bins: Tuple[torch.Tensor, ...] = (),
              valid_row_leaf0: Tuple[torch.Tensor, ...] = ()):
        """Grow one tree from the prefetcher's chunk stream: gh [Rp, 3]
        f32 (or int8 with ``quant_scales`` [2]) and row_leaf0 [Rp] over
        the prefetcher's padded rows. Same result as
        ``tree_builder.build_tree``: ``(TreeArrays, row_leaf,
        valid_row_leafs)``."""
        L, W, B, F, BW, N1 = self.L, self.W, self.B, self.F, self.BW, self.N1
        L1 = L + 1
        DL, DN = L, N1 - 1
        sp = self.sp
        dev = gh.device
        if gh.shape[0] != pref.padded_rows or \
                row_leaf0.shape[0] != pref.padded_rows:
            raise ValueError(
                f"gh/row_leaf have {gh.shape[0]} rows but the chunk "
                f"stream covers {pref.padded_rows}")
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        quant = gh.dtype == torch.int8

        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=dev)

        def finish(h):
            """Raw sums -> f32 split-finding space (descale int32)."""
            if not quant:
                return h
            dq = torch.cat([quant_scales.to(f32).reshape(2),
                            torch.ones(1, dtype=f32, device=dev)])
            return h.to(f32) * dq

        row_leaf = row_leaf0.to(i32).clone()
        vrl = [v.to(i32) for v in valid_row_leaf0]
        t = TreeArrays(
            split_feature=full((N1,), -1, i32),
            threshold_bin=full((N1,), 0, i32),
            default_left=full((N1,), False, torch.bool),
            is_cat=full((N1,), False, torch.bool),
            left_child=full((N1,), -1, i32),
            right_child=full((N1,), -1, i32),
            gain=full((N1,), 0.0, f32),
            node_value=full((N1,), 0.0, f32),
            node_count=full((N1,), 0.0, f32),
            node_hess=full((N1,), 0.0, f32),
            cat_bitset=full((N1, BW), 0, i64),
            leaf2node=full((L1,), DN, i32),
            leaf_values=full((L1,), 0.0, f32),
            num_leaves=full((), 1, i32),
            num_nodes=full((), 1, i32))
        t.leaf2node[:1].fill_(0)
        c_gain = full((L1,), NEG_INF, f32)
        c_feat = full((L1,), 0, i32)
        c_thr = full((L1,), 0, i32)
        c_dl = full((L1,), False, torch.bool)
        c_cat = full((L1,), False, torch.bool)
        c_left = full((L1, HIST_CH), 0.0, f32)
        c_right = full((L1, HIST_CH), 0.0, f32)
        c_bits = full((L1, BW), 0, i64)
        c_lout = full((L1,), 0.0, f32)
        c_rout = full((L1,), 0.0, f32)
        leaf_depth = full((L1,), 0, i32)

        # ---------------- root ----------------
        root_slots = full((2 * W,), -2, i32)
        root_slots[:1].fill_(0)
        hraw0 = self._sweep(pref, row_leaf, gh, root_slots, None)
        hist_cache = None
        if self.hist_sub:
            hist_cache = torch.zeros((L1,) + tuple(hraw0.shape[1:]),
                                     dtype=hraw0.dtype, device=dev)
            hist_cache[0] = hraw0[0]
        h0 = finish(hraw0)
        root_sums = h0[0, 0].sum(dim=0)
        root_val = leaf_output(root_sums[0], root_sums[1], sp.lambda_l1,
                               sp.lambda_l2, sp.max_delta_step)
        t.node_value[0] = root_val
        t.node_count[0] = root_sums[2]
        t.node_hess[0] = root_sums[1]
        t.leaf_values[0] = root_val
        valid0 = torch.zeros(2 * W, dtype=torch.bool, device=dev)
        valid0[:1].fill_(True)
        bs0 = self._best(h0, full((2 * W,), 0, i32), valid0,
                         root_slots.clamp(min=0).long(), t, feature_mask,
                         gain_scale)
        c_gain[0] = bs0["gain"][0]
        c_feat[0] = bs0["feature"][0]
        c_thr[0] = bs0["threshold"][0]
        c_dl[0] = bs0["default_left"][0]
        c_cat[0] = bs0["is_cat_split"][0]
        c_left[0] = bs0["left_sum"][0]
        c_right[0] = bs0["right_sum"][0]
        c_bits[0] = bs0["cat_bitset"][0]
        c_lout[0] = bs0["left_out"][0]
        c_rout[0] = bs0["right_out"][0]

        iw = torch.arange(W, dtype=i32, device=dev)
        for r in range(self.rounds_bound):
            # a round with no leaf budget or no finite cached gain would
            # be a masked no-op: one host read a round
            if not bool((t.num_leaves < L)
                        & torch.isfinite(c_gain[:L]).any()):
                break
            cur, nodes = t.num_leaves, t.num_nodes
            # -- 1. pop the top-W cached splits (ties to the lower slot)
            srt = torch.sort(c_gain[:L], descending=True, stable=True)
            gains = srt.values[:W]
            sel = srt.indices[:W].to(i32)
            valid = torch.isfinite(gains) & (iw < (L - cur))
            sel_s = torch.where(valid, sel, DL)
            sl = sel_s.long()
            sfeat, sthr, sdl, scat = c_feat[sl], c_thr[sl], c_dl[sl], c_cat[sl]
            sgain, slsum, srsum = c_gain[sl], c_left[sl], c_right[sl]
            sbits, lval, rval = c_bits[sl], c_lout[sl], c_rout[sl]
            vi = valid.to(i32)
            n_valid = vi.sum(dtype=i32)
            pos = torch.cumsum(vi, 0, dtype=i32) - 1
            right_slot = torch.where(valid, cur + pos, DL).to(i32)
            ln = torch.where(valid, nodes + 2 * pos, DN).to(i32)
            rn = torch.where(valid, nodes + 2 * pos + 1, DN).to(i32)
            rsl = right_slot.long()
            parent = torch.where(valid, t.leaf2node[sl], DN).long()
            lnl, rnl = ln.long(), rn.long()

            # -- 2. record the splits in the node arrays
            t.split_feature[parent] = sfeat
            t.threshold_bin[parent] = sthr
            t.default_left[parent] = sdl
            t.is_cat[parent] = scat
            t.left_child[parent] = ln
            t.right_child[parent] = rn
            t.gain[parent] = sgain
            t.node_value[lnl] = lval
            t.node_value[rnl] = rval
            t.node_count[lnl] = slsum[:, 2]
            t.node_count[rnl] = srsum[:, 2]
            t.node_hess[lnl] = slsum[:, 1]
            t.node_hess[rnl] = srsum[:, 1]
            t.cat_bitset[parent] = sbits
            t.leaf2node[sl] = ln
            t.leaf2node[rsl] = rn
            t.leaf_values[sl] = lval
            t.leaf_values[rsl] = rval
            t = t._replace(num_leaves=cur + n_valid,
                           num_nodes=nodes + 2 * n_valid)
            new_depth = leaf_depth[sl] + 1
            leaf_depth[sl] = new_depth
            leaf_depth[rsl] = new_depth

            # -- 3. the round's pending splits, per leaf
            p_active = torch.zeros(L1, dtype=torch.bool, device=dev)
            p_active[sl] = valid
            p_active[DL:].fill_(False)
            p_feat = full((L1,), 0, i32)
            p_feat[sl] = sfeat
            p_thr = full((L1,), 0, i32)
            p_thr[sl] = sthr
            p_dl = torch.zeros(L1, dtype=torch.bool, device=dev)
            p_dl[sl] = sdl
            p_right = full((L1,), 0, i32)
            p_right[sl] = right_slot
            p_cat = torch.zeros(L1, dtype=torch.bool, device=dev)
            p_cat[sl] = scat
            p_bits = full((L1, BW), 0, i64)
            p_bits[sl] = sbits
            pend = (p_active, p_feat, p_thr, p_dl, p_cat, p_right, p_bits)
            vrl = [self._relabel(vb, v, pend)
                   for vb, v in zip(valid_bins, vrl)]

            # -- 4. children histograms (relabelling the train rows
            #    chunk by chunk) and best splits
            slots2w = torch.cat([torch.where(valid, sel_s, -2),
                                 torch.where(valid, right_slot, -2)]
                                ).to(i32)
            slots2w_c = torch.where(slots2w >= 0, slots2w, DL).long()
            depth2w = leaf_depth[slots2w_c]
            valid2w = torch.cat([valid, valid])
            if self.hist_sub:
                sil = slsum[:, 2] <= srsum[:, 2]
                small = torch.where(valid, torch.where(sil, sel_s,
                                                       right_slot),
                                    -2).to(i32)
                hsmall = self._sweep(pref, row_leaf, gh, small, pend)
                hbig = hist_cache[sel_s.clamp(0, L).long()] - hsmall
                s4 = sil[:, None, None, None]
                left_raw = torch.where(s4, hsmall, hbig)
                right_raw = torch.where(s4, hbig, hsmall)
                hist_cache[torch.where(valid, sel_s, DL).long()] = left_raw
                hist_cache[torch.where(valid, right_slot, DL).long()] = \
                    right_raw
                hist2w = torch.cat([left_raw, right_raw])
            else:
                hist2w = self._sweep(pref, row_leaf, gh, slots2w, pend)
            bs = self._best(finish(hist2w), depth2w, valid2w, slots2w_c, t,
                            feature_mask, gain_scale)
            c_gain[slots2w_c] = bs["gain"]
            c_gain[DL:].fill_(NEG_INF)
            c_feat[slots2w_c] = bs["feature"]
            c_thr[slots2w_c] = bs["threshold"]
            c_dl[slots2w_c] = bs["default_left"]
            c_cat[slots2w_c] = bs["is_cat_split"]
            c_left[slots2w_c] = bs["left_sum"]
            c_right[slots2w_c] = bs["right_sum"]
            c_bits[slots2w_c] = bs["cat_bitset"]
            c_lout[slots2w_c] = bs["left_out"]
            c_rout[slots2w_c] = bs["right_out"]
        return t, row_leaf, tuple(vrl)
