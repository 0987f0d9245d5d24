"""Double-buffered host-to-device chunk staging for out-of-core training
(the port of ``lightgbm_tpu/data/prefetch.py``).

The chunked tree builder (:mod:`.chunked`) consumes the binned row
stream once per leaf-growth round. Each sweep walks the fixed chunk
sequence ``[0, C), [C, 2C), ...``. On the card the prefetcher holds two
pinned host buffers and two device buffers of ``[C, F]`` bins: while
kernel B1 sums chunk k (on the current stream), a worker thread reads
chunk k+1 from its source (the host matrix, or a shard's mmap) into the
other pinned buffer and enqueues its host-to-device copy on a stream of
its own. The current stream waits for that copy's event before the
chunk's kernels; a device buffer is overwritten only after an event
recorded behind the kernels that read it, and a pinned buffer only
after its previous copy's event. No step syncs the host with the card.

A source that holds its rows in pinned host memory (the out-of-core
Dataset's own host bins, :class:`~.chunked.ArraySource`) skips the
staging copy: its chunks go to the device straight from their rows, by
DMA. Any other source (a shard's mmap) is staged through the pinned
buffers.

The device footprint is the two chunk buffers, whatever the dataset's
size: that is what ``chunk_budget_mb`` budgets (two ``[C, F]`` buffers
in the budget, as in the JAX package).

Overlap accounting (:class:`PrefetchStats`): on the card, events time
each chunk's copy on the copy stream (``copy_ms``) and how long the
current stream stood waiting for it (``stall_ms``);
``overlap_fraction = 1 - stall_ms / copy_ms`` is the share of the
copies hidden behind the kernels. On the CPU the chunks are host
tensors and the JAX package's host measure applies: the time the
consumer blocked (``wait_s``) against the staging thread's time
(``stage_s``).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np
import torch

from .. import phases
from ..profiler import phase

__all__ = ["ChunkPrefetcher", "PrefetchStats", "chunk_rows_for"]


def chunk_rows_for(num_rows: int, num_features: int, itemsize: int,
                   budget_mb: float, block_rows: int) -> int:
    """Chunk size from the staging budget: two in-flight ``[C, F]``
    bin buffers must fit in ``budget_mb``. C is rounded DOWN to a
    multiple of ``block_rows`` (the JAX package's row block), as the
    JAX package sizes its chunks, so that both packages cut the rows
    alike."""
    block = max(1, int(block_rows))
    budget = int(float(budget_mb) * (1 << 20))
    c = budget // max(1, 2 * int(num_features) * int(itemsize))
    c = max(block, (c // block) * block)
    # no point chunking finer than the block-padded dataset
    r_pad = -(-max(1, int(num_rows)) // block) * block
    return int(min(c, r_pad))


class PrefetchStats:
    """Cumulative staging counters across sweeps (one prefetcher serves
    every round of every tree)."""

    __slots__ = ("wait_s", "stage_s", "chunks", "bytes", "copy_ms",
                 "stall_ms")

    def __init__(self):
        self.wait_s = 0.0
        self.stage_s = 0.0
        self.chunks = 0
        self.bytes = 0
        self.copy_ms = 0.0
        self.stall_ms = 0.0

    def overlap_fraction(self) -> float:
        if self.copy_ms > 0.0:
            frac = 1.0 - self.stall_ms / self.copy_ms
        elif self.stage_s > 0.0:
            frac = 1.0 - self.wait_s / self.stage_s
        else:
            return 1.0
        return float(min(1.0, max(0.0, frac)))


class ChunkPrefetcher:
    """Sweep a chunk source (:class:`~.chunked.ArraySource`,
    :class:`~.chunked.ShardSource`) as fixed-shape chunks on
    ``device``, staging one chunk ahead on a worker thread.

    Every chunk has the shape ``[chunk_rows, F]`` (the tail is
    zero-padded; padded rows carry ``row_leaf == -1`` on the consumer
    side, so they add nothing)."""

    def __init__(self, source, chunk_rows: int,
                 device: torch.device = torch.device("cpu")):
        self.source = source
        self.chunk_rows = int(chunk_rows)
        if self.chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        self.device = torch.device(device)
        self.num_chunks = max(
            1, -(-int(source.num_rows) // self.chunk_rows))
        self.padded_rows = self.num_chunks * self.chunk_rows
        self.stats = PrefetchStats()
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="lgbt-prefetch")
        self._cuda = self.device.type == "cuda"
        probe = np.asarray(source.read_rows(0, 1))
        self._row_bytes = int(source.num_features) * probe.dtype.itemsize
        tensor = getattr(source, "tensor", None)
        self._direct = (self._cuda and tensor is not None
                        and tensor.is_pinned())
        if self._cuda:
            shape = (self.chunk_rows, int(source.num_features))
            dt = torch.from_numpy(probe[:0]).dtype
            if not self._direct:
                self._pinned = [torch.empty(shape, dtype=dt).pin_memory()
                                for _ in range(2)]
            self._dev = [torch.empty(shape, dtype=dt, device=self.device)
                         for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._consumed = [torch.cuda.Event() for _ in range(2)]
            # (copy start, copy end, stall start, stall end) per chunk,
            # read once the events have completed
            self._timing: List[tuple] = []
        # staging slots alternate across sweeps, and the next sweep's
        # first chunk is staged as soon as a sweep's last one is handed
        # out, so it overlaps the last chunk's kernels too
        self._slot = 0
        self._ahead = None

    def _span(self, k: int):
        lo = k * self.chunk_rows
        return lo, min(lo + self.chunk_rows, int(self.source.num_rows))

    def _read(self, k: int, out: np.ndarray = None) -> np.ndarray:
        lo, hi = self._span(k)
        X = np.asarray(self.source.read_rows(lo, hi))
        if out is None:
            out = np.zeros((self.chunk_rows, X.shape[1]), X.dtype)
        out[:hi - lo] = X
        out[hi - lo:] = 0
        return out

    def _stage(self, k: int):
        """Worker thread: chunk k into a staging slot; returns the CPU
        chunk, or on the card the slot whose copy is enqueued."""
        t0 = time.perf_counter()
        with phase(phases.PREFETCH):
            out = self._stage_chunk(k)
        self.stats.stage_s += time.perf_counter() - t0
        return out

    def _stage_chunk(self, k: int):
        """The body of :meth:`_stage` (its ``prefetch`` span)."""
        if not self._cuda:
            return torch.from_numpy(self._read(k))
        slot, self._slot = self._slot, self._slot ^ 1
        lo, hi = self._span(k)
        if self._direct:
            src = self.source.tensor[lo:hi]
        else:
            # the pinned buffer's previous copy must have left it
            self._copied[slot].synchronize()
            self._read(k, self._pinned[slot].numpy())
            src = self._pinned[slot]
        dst = self._dev[slot][:src.shape[0]]
        timing = tuple(torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._copy_stream):
            # the kernels that read this device buffer are done
            self._copy_stream.wait_event(self._consumed[slot])
            timing[0].record(self._copy_stream)
            dst.copy_(src, non_blocking=True)
            if self._direct and hi - lo < self.chunk_rows:
                self._dev[slot][hi - lo:].zero_()   # the padded tail
            timing[1].record(self._copy_stream)
            self._copied[slot].record(self._copy_stream)
        return slot, timing

    def _collect(self, block: bool = False) -> None:
        """Fold the timings of completed chunks into the stats."""
        keep = []
        for ev in self._timing:
            if block or ev[3].query():
                ev[3].synchronize()
                self.stats.copy_ms += ev[0].elapsed_time(ev[1])
                self.stats.stall_ms += ev[2].elapsed_time(ev[3])
            else:
                keep.append(ev)
        self._timing = keep

    def chunks(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """One sequential sweep: yields ``(row_offset, chunk_bins)`` with
        the next chunk's staging already in flight. On the card the
        chunk is a device buffer that the next-but-one chunk reuses."""
        if self._cuda:
            self._collect()
            main = torch.cuda.current_stream(self.device)
        fut = self._ahead or self._pool.submit(self._stage, 0)
        self._ahead = None
        for k in range(self.num_chunks):
            t0 = time.perf_counter()
            got = fut.result()
            self.stats.wait_s += time.perf_counter() - t0
            self.stats.chunks += 1
            self.stats.bytes += self.chunk_rows * self._row_bytes
            if k + 1 < self.num_chunks:
                fut = self._pool.submit(self._stage, k + 1)
            if not self._cuda:
                yield k * self.chunk_rows, got
                continue
            slot, (c0, c1) = got
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record(main)
            main.wait_event(self._copied[slot])
            s1.record(main)
            self._timing.append((c0, c1, s0, s1))
            yield k * self.chunk_rows, self._dev[slot]
            # behind the kernels the consumer enqueued on this chunk
            self._consumed[slot].record(main)
        self._ahead = self._pool.submit(self._stage, 0)

    def sync_stats(self) -> PrefetchStats:
        """The stats with every chunk's timing folded in (waits for the
        card)."""
        if self._cuda:
            self._collect(block=True)
        return self.stats

    def close(self) -> None:
        self._ahead = None
        self._pool.shutdown(wait=True)
