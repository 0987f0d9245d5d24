"""The collective layer of the parallel learners, with a record of every
call (the port of ``lightgbm_tpu/parallel/comms.py``).

The JAX package finds its collectives by walking the compiled HLO of a
tree program. The port has no compiler, so the other way round: every
collective the learners issue goes through :class:`Comm`, which runs it
on ``torch.distributed`` and appends one :class:`CollectiveOp` (kind,
dtype, shape, result bytes, phase, tree, round) to a live
:class:`CommReport`. The report has the JAX report's fields and methods
(``count``, ``bytes_by_kind``, ``hist_ops``, ``hist_result_bytes``,
``hist_wire_bytes``, ``full_hist_allreduces``); histogram traffic is
what ``ops.histogram.merge_histograms`` issues under the ``hist_merge``
phase, the winner merge of the builder's ``_sync_best`` is
``winner_sync``.

Backend (:func:`pick_backend`): NCCL where each rank has a card of its
own; gloo on the CPU, and gloo where ranks share one card (NCCL refuses
two ranks on one device). gloo's support of CUDA tensors is partial
(no reduce-scatter, no all-gather), so the layer stages every gloo
collective of a CUDA tensor through a host buffer on purpose: the
tensor is copied to the host, reduced there, and copied back, and the
bytes and host milliseconds of those copies are counted
(``staged_bytes``, ``staged_ms``). A failed collective raises; no path
falls back to training alone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from ..phases import HIST_MERGE, WINNER_SYNC

__all__ = ["CollectiveOp", "CommReport", "Comm", "pick_backend",
           "hist_bytes_per_tree", "render_table"]


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective call."""
    kind: str                       # all-reduce | reduce-scatter | ...
    dtype: str
    shape: tuple                    # the input's shape on this rank
    out_bytes: int                  # bytes of the call's RESULT per rank
    phase: str                      # hist_merge | winner_sync | ...
    tree: int = 0                   # trees begun on this Comm before it
    round: int = -1                 # builder round (-1: the root)

    @property
    def is_hist(self) -> bool:
        return self.phase == HIST_MERGE

    @property
    def is_winner_sync(self) -> bool:
        return self.phase == WINNER_SYNC

    def wire_bytes(self, n: int) -> int:
        """Per-rank wire-traffic estimate under ring algorithms (the JAX
        report's rule): all-reduce 2(n-1)/n x payload, reduce-scatter
        and all-gather (n-1)/n x payload (a reduce-scatter's RESULT is
        payload/n)."""
        if n <= 1:
            return 0
        if self.kind == "all-reduce":
            return int(2 * (n - 1) / n * self.out_bytes)
        if self.kind == "reduce-scatter":
            return int((n - 1) * self.out_bytes)
        if self.kind == "all-gather":
            return int((n - 1) / n * self.out_bytes)
        return self.out_bytes


@dataclasses.dataclass
class CommReport:
    """The collectives one :class:`Comm` ran, with per-kind accounting
    and the host staging of a gloo group's CUDA tensors."""
    label: str
    n_devices: int
    ops: List[CollectiveOp] = dataclasses.field(default_factory=list)
    staged_bytes: int = 0
    staged_ms: float = 0.0
    trees: int = 0

    def count(self, kind: Optional[str] = None) -> int:
        return sum(1 for o in self.ops if kind is None or o.kind == kind)

    def bytes_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            out[o.kind] = out.get(o.kind, 0) + o.out_bytes
        return out

    @property
    def hist_ops(self) -> List[CollectiveOp]:
        return [o for o in self.ops if o.is_hist]

    @property
    def hist_result_bytes(self) -> int:
        """Per-rank bytes of merged histogram materialized: the 1/n
        economics of reduce-scatter show here directly."""
        return sum(o.out_bytes for o in self.hist_ops)

    @property
    def hist_wire_bytes(self) -> int:
        return sum(o.wire_bytes(self.n_devices) for o in self.hist_ops)

    def full_hist_allreduces(self, min_bytes: int) -> List[CollectiveOp]:
        """All-reduce calls carrying a full-histogram-sized payload
        (>= min_bytes: pass one slot's F*B*3*itemsize)."""
        return [o for o in self.ops
                if o.kind == "all-reduce" and o.out_bytes >= min_bytes]

    def hist_bytes_per_tree_measured(self) -> float:
        """Histogram result bytes per tree begun, as measured."""
        return self.hist_result_bytes / max(1, self.trees)


def hist_bytes_per_tree(report: CommReport, num_leaves: int,
                        leaf_batch: int) -> int:
    """Per-rank histogram-merge bytes of one FULL tree, counted from the
    shapes of the first tree in ``report``: its root merge once, plus
    its first round's merges times the round bound (``max_rounds_for``:
    the port's builder runs every round, a round without a split as a
    masked no-op with the same collectives). The JAX package counts the
    same way from its compiled program, which holds the loop once."""
    from ..boosting.tree_builder import max_rounds_for
    ops = [o for o in report.hist_ops if o.tree == 1]
    if not ops:
        return 0
    rounds = max_rounds_for(num_leaves, max(1, min(leaf_batch,
                                                   num_leaves - 1)))
    root = sum(o.out_bytes for o in ops if o.round < 0)
    loop = sum(o.out_bytes for o in ops if o.round == 0)
    return root + rounds * loop


def render_table(reports: Dict[str, CommReport]) -> str:
    """Per-plan collective table (the JAX package's layout)."""
    rows = [f"{'plan':<22} {'collectives':>11} {'hist ops':>8} "
            f"{'hist kinds':<24} {'hist KiB/rank':>13} "
            f"{'wire KiB/rank':>13}"]
    for name, r in reports.items():
        kinds = ",".join(sorted({o.kind for o in r.hist_ops})) or "-"
        rows.append(
            f"{name:<22} {r.count():>11} {len(r.hist_ops):>8} "
            f"{kinds:<24} {r.hist_result_bytes / 1024:>13.1f} "
            f"{r.hist_wire_bytes / 1024:>13.1f}")
    return "\n".join(rows)


def pick_backend(device_type: str, world_size: int) -> str:
    """The process group's backend: ``nccl`` when the ranks run on CUDA
    with a card each, else ``gloo`` (the CPU, or ranks sharing cards)."""
    if device_type == "cuda" and torch.cuda.is_available():
        if torch.cuda.device_count() >= world_size:
            return "nccl"
    return "gloo"


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class Comm:
    """A process group and its :class:`CommReport`.

    ``group`` None is the default group. Every method is a collective:
    every rank calls it in the same order with tensors of the same
    shape. Bools travel as uint8. ``phase`` names the caller's purpose
    (the report's attribution)."""

    def __init__(self, group=None, label: str = "plan"):
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "the parallel learners need an initialized "
                "torch.distributed process group: run under "
                "`python -m lightgbm_tpu_torch.launch` or call "
                "lightgbm_tpu_torch.parallel.init_distributed()")
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.report = CommReport(label=label, n_devices=self.world_size)
        self.round = -1
        self._host: Optional["Comm"] = None

    @property
    def host(self) -> "Comm":
        """A gloo Comm over the same ranks for host arrays (this one,
        unless the backend is NCCL, which moves CUDA tensors only)."""
        if self.backend == "gloo":
            return self
        if self._host is None:
            ranks = (None if self.group is None else
                     self._dist.get_process_group_ranks(self.group))
            self._host = Comm(self._dist.new_group(ranks, backend="gloo"),
                              label=self.report.label + "/host")
        return self._host

    # -- bookkeeping ---------------------------------------------------
    def begin_tree(self) -> None:
        """A tree build starts: its root's collectives are round -1."""
        self.report.trees += 1
        self.round = -1

    def _record(self, kind: str, t: torch.Tensor, out_bytes: int,
                phase: str) -> None:
        self.report.ops.append(CollectiveOp(
            kind=kind, dtype=str(t.dtype).replace("torch.", ""),
            shape=tuple(t.shape), out_bytes=int(out_bytes), phase=phase,
            tree=self.report.trees, round=self.round))

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        h = t.detach().to("cpu")
        self.report.staged_ms += (time.perf_counter() - t0) * 1e3
        self.report.staged_bytes += t.numel() * t.element_size()
        return h

    def _to_device(self, h: torch.Tensor, like: torch.Tensor
                   ) -> torch.Tensor:
        t0 = time.perf_counter()
        out = h.to(like.device)
        torch.cuda.synchronize(like.device)
        self.report.staged_ms += (time.perf_counter() - t0) * 1e3
        self.report.staged_bytes += h.numel() * h.element_size()
        return out

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.uint8) if t.dtype == torch.bool else t

    # -- collectives ---------------------------------------------------
    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   phase: str = "") -> torch.Tensor:
        """The reduction of ``t`` over ranks (``sum``, ``max``, ``min``);
        a new tensor of ``t``'s shape and dtype."""
        d = self._dist
        red = getattr(d.ReduceOp, _REDUCE_OPS[op])
        w = self._wire(t)
        buf = (self._to_host(w) if self._staged(w)
               else w.clone()).contiguous()
        if self.world_size > 1:
            d.all_reduce(buf, op=red, group=self.group)
        if self._staged(w):
            buf = self._to_device(buf, w)
        self._record("all-reduce", t, buf.numel() * buf.element_size(),
                     phase)
        return buf.to(torch.bool) if t.dtype == torch.bool else buf

    def reduce_scatter(self, t: torch.Tensor, dim: int = 1,
                       phase: str = "") -> torch.Tensor:
        """The sum of ``t`` over ranks, of which this rank receives only
        its block of axis ``dim`` (padded with zeros to a multiple of the
        world size): block r of ``[r * n/W, (r + 1) * n/W)``, as
        ``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``."""
        W = self.world_size
        n = t.shape[dim]
        n_pad = -(-n // W) * W
        if n_pad != n:
            pad = [0, 0] * (t.dim() - 1 - dim) + [0, n_pad - n]
            t = torch.nn.functional.pad(t, pad)
        blk = n_pad // W
        src = t.movedim(dim, 0).contiguous()
        staged = self._staged(src)
        buf = self._to_host(src) if staged else src
        out = torch.empty((blk,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                          device=buf.device)
        if W > 1:
            # torch 2.13 renames reduce_scatter_tensor; same arguments
            rs = getattr(self._dist, "reduce_scatter_single", None) \
                or self._dist.reduce_scatter_tensor
            rs(out, buf, group=self.group)
        else:
            out.copy_(buf)
        if staged:
            out = self._to_device(out, src)
        self._record("reduce-scatter", t, out.numel() * out.element_size(),
                     phase)
        return out.movedim(0, dim).contiguous()

    def all_gather(self, t: torch.Tensor, phase: str = "") -> torch.Tensor:
        """[W, *t.shape]: every rank's ``t``, in rank order."""
        w = self._wire(t).contiguous()
        staged = self._staged(w)
        buf = self._to_host(w) if staged else w
        flat = buf.reshape(-1)
        out = torch.empty(self.world_size * flat.numel(), dtype=buf.dtype,
                          device=buf.device)
        if self.world_size > 1:
            self._dist.all_gather_into_tensor(out, flat, group=self.group)
        else:
            out.copy_(flat)
        out = out.view((self.world_size,) + tuple(buf.shape))
        if staged:
            out = self._to_device(out, w)
        self._record("all-gather", t, out.numel() * out.element_size(),
                     phase)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def broadcast(self, t: torch.Tensor, src: int = 0,
                  phase: str = "") -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (a new tensor)."""
        w = self._wire(t)
        staged = self._staged(w)
        buf = (self._to_host(w) if staged else w.clone()).contiguous()
        if self.world_size > 1:
            self._dist.broadcast(buf, src=src, group=self.group)
        if staged:
            buf = self._to_device(buf, w)
        self._record("broadcast", t, buf.numel() * buf.element_size(),
                     phase)
        return buf.to(torch.bool) if t.dtype == torch.bool else buf

    def gather_rows(self, a, phase: str = "host"):
        """Every rank's host array ``a`` (row counts may differ),
        concatenated along axis 0 in rank order."""
        import numpy as np
        if self.backend != "gloo":
            return self.host.gather_rows(a, phase)
        a = np.ascontiguousarray(a)
        n = torch.tensor([a.shape[0]], dtype=torch.int64)
        counts = self.all_gather(n, phase=phase).reshape(-1).tolist()
        width = int(np.prod(a.shape[1:], dtype=np.int64)) * a.itemsize
        buf = torch.zeros((max(counts), width), dtype=torch.uint8)
        buf[:a.shape[0]] = torch.from_numpy(
            a.reshape(-1).view(np.uint8).reshape(a.shape[0], width).copy())
        got = self.all_gather(buf, phase=phase).numpy()
        parts = [got[r, :c].reshape(-1).view(a.dtype)
                 .reshape((c,) + a.shape[1:])
                 for r, c in enumerate(counts)]
        return np.concatenate(parts, axis=0)
