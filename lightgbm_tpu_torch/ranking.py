"""Ranking objectives: LambdaRank and XE-NDCG.

Port of ``lightgbm_tpu/ranking.py`` (the reference's
``rank_objective.hpp``: ``LambdarankNDCG``, ``RankXENDCG``). The
per-query arithmetic is the JAX package's, line for line; only the
padding differs.

The JAX package pads every query to the widest, one ``[Q, S_max]``
lattice with ``[Q, S_max, S_max]`` pairwise temporaries. At MS LTR's
shape (18,919 queries, the widest 1,251 documents) one f32 temporary of
that lattice would take 118 GB. The port buckets the queries by padded
length instead (:func:`bucket_plan`): powers of two from 16 up, the
widest bucket cut at the widest query. Each bucket is a static
``[Q_b, S_b]`` lattice, cut into chunks of at most
:data:`LATTICE_BUDGET_BYTES` per ``[Q_c, S_b, S_b]`` f32 temporary.
Padded lanes carry zero weight and score ``-inf``, so they sort after
every real document and no real document's rank changes.

The plan is built once, in ``init`` (host index arrays) and ``bind``
(their device copies). Every shape is static and ``get_gradients`` reads
no device value on the host, so the training step's CUDA graph holds it.
The iteration number arrives as a 0-d device tensor (``it``);
``rank_xendcg`` draws the JAX package's ``uniform(fold_in(key, it),
[Q, S_max])`` array with ``ops/threefry.py`` and gathers each bucket's
lanes from it, so its draws are bit-equal.

Position bias (unbiased lambdarank, ``rank_objective.hpp:296-334``)
updates ``pos_biases`` after every gradient call. Its segment sums are
deterministic on the card: the rows are sorted by position id once, and
each position's sum is the difference of a float64 cumulative sum at
its boundaries.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .objectives import Objective
from .ops import threefry

__all__ = ["LambdaRank", "RankXENDCG", "LATTICE_BUDGET_BYTES",
           "bucket_plan"]

# the largest [Q_c, S_b, S_b] f32 temporary of one chunk
LATTICE_BUDGET_BYTES = 1 << 28
_MIN_WIDTH = 16


class Chunk(NamedTuple):
    """One static lattice: rows [Q_c, S_b] (-1 at padded lanes; the
    dummy row R once bound to a device), their mask, the queries' ids
    [Q_c], and each lane's flat index into the [Q, S_max] draw of
    ``rank_xendcg``."""
    rows: np.ndarray
    mask: np.ndarray
    query: np.ndarray
    lanes: np.ndarray


def bucket_plan(query_boundaries: np.ndarray,
                budget: int = LATTICE_BUDGET_BYTES,
                single: bool = False, s_max: Optional[int] = None,
                query_offset: int = 0) -> List[Chunk]:
    """The chunks of the bucketed query lattice. A query of ``n``
    documents goes to the bucket of width ``min(S_max, max(16,
    2^ceil(log2 n)))``; each bucket is cut into chunks whose
    ``[Q_c, S_b, S_b]`` f32 temporaries stay within ``budget`` bytes
    (at least one query a chunk). ``single`` gives the JAX package's one
    ``[Q, S_max]`` lattice. Empty queries enter no chunk. A rank of a
    row-sharded plan passes the global widest query ``s_max`` and its
    first query's global index ``query_offset``, so that its widths and
    its lanes into the ``[Q, S_max]`` draw are the serial run's."""
    qb = np.asarray(query_boundaries, np.int64)
    sizes = np.diff(qb)
    if s_max is None:
        s_max = int(sizes.max()) if len(sizes) else 0
    if single:
        widths = np.full(len(sizes), s_max, np.int64)
    else:
        p2 = 1 << np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64)
        widths = np.minimum(np.maximum(p2, _MIN_WIDTH), s_max)
    out = []
    for w in np.unique(widths[sizes > 0]):
        qs = np.nonzero((widths == w) & (sizes > 0))[0]
        per = max(1, budget // (int(w) * int(w) * 4))
        for c0 in range(0, len(qs), per):
            q = qs[c0:c0 + per]
            lane = np.arange(int(w))[None, :]
            mask = lane < sizes[q][:, None]
            rows = np.where(mask, qb[q][:, None] + lane, -1)
            lanes = np.where(mask, (q[:, None] + query_offset) * s_max
                             + lane, 0)
            out.append(Chunk(rows.astype(np.int64), mask, q.astype(np.int64),
                             lanes.astype(np.int64)))
    return out


class _RankingBase(Objective):
    is_ranking = True
    # under a row-sharded plan: the Comm and (this rank's first query,
    # global query count, global widest query); None when alone
    _comm = None
    _layout = None

    def set_global_layout(self, query_boundaries, comm) -> None:
        """Under a row-sharded plan, before :meth:`init`: each rank holds
        whole queries and computes its own queries' gradients
        (gbdt.py:415-441); the lattice widths, ``rank_xendcg``'s draw and
        the position-bias sums read the global layout gathered here."""
        if query_boundaries is None:
            return
        sizes = np.diff(np.asarray(query_boundaries, np.int64))
        allv = comm.gather_rows(np.asarray(
            [[len(sizes), int(sizes.max()) if len(sizes) else 0]],
            np.int64))
        self._comm = comm
        self._layout = (int(allv[:comm.rank, 0].sum()),
                        int(allv[:, 0].sum()), int(allv[:, 1].max()))

    def init(self, label, weight, query_boundaries=None, position=None):
        if query_boundaries is None:
            raise ValueError(
                f"{self.name} objective requires query/group information")
        super().init(label, weight, query_boundaries)
        qb = np.asarray(query_boundaries, np.int64)
        self.num_queries = len(qb) - 1
        self.max_query = int(np.diff(qb).max()) if self.num_queries else 0
        q_off = 0
        if self._layout is not None:
            q_off, self.num_queries, self.max_query = self._layout
        # num_queries and max_query are the global lattice's (the draw's
        # shape); the chunks hold this rank's queries
        self.chunks = bucket_plan(qb, s_max=self.max_query,
                                  query_offset=q_off)
        self._dev = None
        # unbiased lambdarank positions (Metadata::positions): factorize
        # arbitrary ids/names into [n] int32 indices + the id table
        if position is not None:
            position = np.asarray(position).reshape(-1)
            if len(position) != len(label):
                raise ValueError(
                    f"positions has {len(position)} entries but the "
                    f"dataset has {len(label)} rows (Metadata positions "
                    "size check)")
            self.position_ids, pos_idx = np.unique(
                position, return_inverse=True)
            if self._comm is not None:
                # one position table over every rank's rows
                host = self._comm.host
                seen = [None] * host.world_size
                host._dist.all_gather_object(seen, self.position_ids,
                                             group=host.group)
                self.position_ids = np.unique(np.concatenate(seen))
                pos_idx = np.searchsorted(self.position_ids, position)
            self.positions = pos_idx.astype(np.int32)
            self.num_position_ids = int(len(self.position_ids))
        else:
            self.position_ids = None
            self.positions = None
            self.num_position_ids = 0

    def bind(self, device: torch.device, num_rows: int) -> None:
        """Move the plan to ``device`` for scores of ``num_rows`` padded
        rows: padded lanes read the dummy row ``num_rows``."""
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self._num_rows = num_rows
        self._dev = [Chunk(put(np.where(c.mask, c.rows, num_rows)),
                           put(c.mask), put(c.query), put(c.lanes))
                     for c in self.chunks]
        self._device = device

    def _chunks(self, score: torch.Tensor) -> List[Chunk]:
        if (self._dev is None or self._device != score.device
                or self._num_rows != score.shape[0]):
            self.bind(score.device, score.shape[0])
        return self._dev

    @staticmethod
    def _lanes(v: torch.Tensor, c: Chunk, fill) -> torch.Tensor:
        """v [R] gathered at the chunk's rows, ``fill`` at padded lanes."""
        got = v[c.rows.clamp(max=v.shape[0] - 1)]
        return torch.where(c.mask, got, fill)

    @staticmethod
    def scatter_from_queries(parts, num_rows: int, dtype, device):
        """Chunk values [Q_c, S_b] -> [R]; each row appears in exactly
        one query lane, padded lanes land on the dropped dummy row."""
        out = torch.zeros(num_rows + 1, dtype=dtype, device=device)
        for c, v in parts:
            out.scatter_(0, c.rows.reshape(-1), v.reshape(-1))
        return out[:num_rows]


class LambdaRank(_RankingBase):
    """LambdaMART gradients with NDCG deltas
    (rank_objective.hpp LambdarankNDCG)."""

    name = "lambdarank"

    def init(self, label, weight, query_boundaries=None, position=None):
        super().init(label, weight, query_boundaries, position)
        cfg = self.cfg
        # position-bias factors (rank_objective.hpp:30-68: pos_biases_,
        # learning_rate_, position_bias_regularization_)
        if self.num_position_ids:
            self._pb_lr = float(cfg.learning_rate)
            self._pb_reg = float(
                cfg.lambdarank_position_bias_regularization)
        max_label = int(np.max(label)) if len(label) else 0
        lg = list(cfg.label_gain)
        if not lg:
            # default label gain: 2^i - 1 (config.h label_gain default)
            lg = [(1 << i) - 1 for i in range(max(max_label + 1, 2))]
        if max_label >= len(lg):
            raise ValueError("label_gain table shorter than max label")
        self.label_gain = np.asarray(lg, dtype=np.float64)
        self.trunc = int(cfg.lambdarank_truncation_level)
        self.norm = bool(cfg.lambdarank_norm)
        self.sig = float(cfg.sigmoid)
        # per-query inverse max DCG at truncation (DCGCalculator
        # analog), in float64 on the host as the JAX package computes it
        qb = np.asarray(query_boundaries)
        inv = np.zeros(len(qb) - 1)
        for q in range(len(qb) - 1):
            lab = label[qb[q]:qb[q + 1]]
            gains = self.label_gain[lab.astype(np.int64)]
            top = np.sort(gains)[::-1][: self.trunc]
            dcg = np.sum(top / np.log2(np.arange(2, 2 + len(top))))
            inv[q] = 1.0 / dcg if dcg > 0 else 0.0
        self.inverse_max_dcg = inv

    def bind(self, device, num_rows):
        super().bind(device, num_rows)
        self._inv = torch.from_numpy(
            self.inverse_max_dcg.astype(np.float32)).to(device)
        self._lg = torch.from_numpy(
            self.label_gain.astype(np.float32)).to(device)
        if self.num_position_ids:
            P = self.num_position_ids
            self.pos_biases = torch.zeros(P, dtype=torch.float32,
                                          device=device)
            self._pos = torch.from_numpy(np.concatenate(
                [self.positions, np.zeros(num_rows - len(self.positions),
                                          np.int32)])).to(device).long()
            # rows sorted by position id once; a position's sum is the
            # difference of the f64 cumulative sum at its boundaries
            order = np.argsort(self.positions, kind="stable")
            counts = np.bincount(self.positions, minlength=P)
            self._pos_order = torch.from_numpy(order).to(device)
            self._pos_ends = torch.from_numpy(np.cumsum(counts)).to(device)
            if self._comm is not None:
                # the instance counts of the regularization are global
                counts = self._comm.gather_rows(counts[None]).sum(0)
            self._pos_count = torch.from_numpy(
                counts.astype(np.float32)).to(device)

    def _per_chunk(self, s, y, mask, inv):
        """The JAX per_query body over a chunk of queries: s, y, mask
        [Q_c, S], inv [Q_c] -> g, h [Q_c, S]."""
        sig, trunc = self.sig, self.trunc
        Q, S = s.shape
        # rank of each doc by score desc (padded lanes sink to the end);
        # ties keep lane order, as the reference's stable sort
        order = torch.argsort(-torch.where(mask, s, float("-inf")), dim=1,
                              stable=True)
        rank = torch.empty_like(order).scatter_(1, order, torch.arange(
            S, device=s.device).expand(Q, S))
        gain = torch.where(mask, self._lg[y.clamp(min=0).long()], 0.0)
        disc = torch.where((rank < trunc) & mask,
                           1.0 / torch.log2(2.0 + rank.to(s.dtype)), 0.0)
        # pair (i, j): considered when y_i > y_j and at least one of the
        # two sits inside the truncation window
        dy = y[:, :, None] - y[:, None, :]
        top = rank < trunc
        pair = (dy > 0) & mask[:, :, None] & mask[:, None, :]
        pair &= top[:, :, None] | top[:, None, :]
        dgain = gain[:, :, None] - gain[:, None, :]
        ddisc = disc[:, :, None] - disc[:, None, :]
        delta = torch.abs(dgain * ddisc) * inv[:, None, None]
        ds = s[:, :, None] - s[:, None, :]
        rho = 1.0 / (1.0 + torch.exp(sig * ds))     # P(j beats i)
        lam = sig * rho * delta                     # |lambda| toward i up
        hes = sig * sig * rho * (1.0 - rho) * delta
        lam = torch.where(pair, lam, 0.0)
        hes = torch.where(pair, hes, 0.0)
        g = -lam.sum(dim=2) + lam.sum(dim=1)        # i gains, j loses
        h = hes.sum(dim=2) + hes.sum(dim=1)
        if self.norm:
            sum_lam = lam.sum(dim=(1, 2))[:, None]
            nf = torch.where(sum_lam > 0,
                             torch.log2(1.0 + sum_lam) / sum_lam, 1.0)
            g, h = g * nf, h * nf
        return g, h

    def get_gradients(self, score, label, weight, it=None):
        R = score.shape[0]
        label_i = label.to(torch.int32)
        gp, hp = [], []
        for c in self._chunks(score):
            s = self._lanes(score, c, float("-inf"))
            y = self._lanes(label_i, c, -1)
            if self.num_position_ids:
                # score_adjusted = score + pos_biases[position]
                # (rank_objective.hpp:69-75)
                pos = self._lanes(self._pos, c, 0)
                s = torch.where(c.mask, s + self.pos_biases[pos], s)
            g, h = self._per_chunk(s, y, c.mask, self._inv[c.query])
            gp.append((c, g))
            hp.append((c, h))
        g = self.scatter_from_queries(gp, R, score.dtype, score.device)
        h = self.scatter_from_queries(hp, R, score.dtype, score.device)
        if weight is not None:
            g, h = g * weight, h * weight
        if self.num_position_ids:
            self._update_position_bias(g, h)
        return g, h

    def _segment_sums(self, v: torch.Tensor) -> torch.Tensor:
        """[P] sums of v's real rows per position id, in an order fixed
        by the data (a float64 cumulative sum over the rows sorted by
        position, read at each position's end)."""
        cs = torch.cumsum(v[self._pos_order].to(torch.float64), 0)
        cs = torch.cat([cs.new_zeros(1), cs])
        ends = cs[self._pos_ends]
        sums = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
        if self._comm is not None:
            # every rank's rows, summed in float64: the bias factors
            # stay one state across the ranks
            sums = self._comm.all_reduce(sums, "sum",
                                         phase="position_bias")
        return sums.to(torch.float32)

    def _update_position_bias(self, g, h):
        """Newton-Raphson step on the per-position bias factors
        (UpdatePositionBiasFactors, rank_objective.hpp:296-334):
        d(utility)/d(bias_p) = -sum of lambdas at position p, minus L2
        regularization scaled by the instance count. Runs once per
        iteration, in the eager loop."""
        count = self._pos_count
        first = -self._segment_sums(g) - self.pos_biases * self._pb_reg \
            * count
        second = -self._segment_sums(h) - self._pb_reg * count
        self.pos_biases = self.pos_biases + (
            self._pb_lr * first / (torch.abs(second) + 0.001))


class RankXENDCG(_RankingBase):
    """Cross-entropy NDCG surrogate (rank_objective.hpp RankXENDCG)."""

    name = "rank_xendcg"

    def init(self, label, weight, query_boundaries=None, position=None):
        # positions are accepted but bias factors stay zero: the
        # reference learns them for lambdarank only
        # (rank_objective.hpp:98)
        super().init(label, weight, query_boundaries, position)
        self.seed = int(self.cfg.objective_seed)

    def bind(self, device, num_rows):
        super().bind(device, num_rows)
        self._key = threefry.prng_key(self.seed, device)

    def get_gradients(self, score, label, weight, it=None):
        R = score.shape[0]
        chunks = self._chunks(score)
        key = threefry.fold_in(self._key, 0 if it is None else it)
        # the JAX package's [Q, S_max] draw, each chunk's lanes gathered
        gam_all = threefry.uniform(
            key, (self.num_queries, self.max_query)).reshape(-1)
        gp, hp = [], []
        for c in chunks:
            mask = c.mask
            s = self._lanes(score, c, float("-inf"))
            y = self._lanes(label, c, 0.0)
            gamma = gam_all[c.lanes]
            rho = torch.softmax(torch.where(mask, s, float("-inf")), dim=1)
            rho = torch.where(mask, rho, 0.0)
            phi = torch.where(mask, torch.exp2(y) - gamma, 0.0)
            denom = torch.clamp_min(phi.sum(dim=1, keepdim=True), 1e-20)
            p = phi / denom
            g = rho - p
            h = torch.clamp_min(rho * (1.0 - rho), 1e-16)
            gp.append((c, torch.where(mask, g, 0.0)))
            hp.append((c, torch.where(mask, h, 0.0)))
        g = self.scatter_from_queries(gp, R, score.dtype, score.device)
        h = self.scatter_from_queries(hp, R, score.dtype, score.device)
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h
