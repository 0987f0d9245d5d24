"""Histogram construction, plain PyTorch version (kernel B1's contract).

Port of the ``build_histograms`` contract of
``lightgbm_tpu/ops/histogram.py:239``, serial (no ``axis_name``), as one
torch function: accumulate per-(leaf slot, feature, bin) sums of
(grad, hess, count). It is the reference the CUDA kernel
(``ops/cuda_histogram.py``) is held against and the path every CPU
tensor takes.

Semantics kept from the JAX package's scatter path:
- f32 ``gh``: each addend is rounded to ``hist_dtype`` (bf16 by default,
  round-to-nearest-even) and summed in f32; ``hist_dtype="float32"``
  sums the addends as they are.
- int8 ``gh`` (quantized grid values): exact int32 sums.
- ``row_gather`` [R] int32 indexes ``bins`` rows per stream position
  (``gh``/``row_leaf`` arrive already compacted); ``num_rows`` bounds
  the live prefix of the stream. It may be a device scalar: rows past
  it are masked on the device, with no host sync.
- ``init`` seeds the accumulator.
- Rows whose ``row_leaf`` matches no entry of ``leaf_ids`` (dead rows
  are -1, pad slots -2) contribute nothing.

Rows are summed in blocks of ``block_rows``: within a block by one
``index_add_`` in row order (on the CPU, the order of the JAX scatter
path, so streams up to one block long give bit-equal sums), then the
block partials in block order. Blocking keeps each f32 accumulation
chain short: at 10.5M rows a single chain per cell drifts by hundreds
of ulps.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["build_histograms", "merge_histograms", "HIST_CH"]

# channels per histogram cell: (sum_grad, sum_hess, count)
HIST_CH = 3

_HIST_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_histograms(bins: torch.Tensor, gh: torch.Tensor,
                     row_leaf: torch.Tensor, leaf_ids: torch.Tensor, *,
                     num_bins: int, hist_dtype: str = "bfloat16",
                     row_gather: Optional[torch.Tensor] = None,
                     num_rows=None, init: Optional[torch.Tensor] = None,
                     block_rows: int = 1 << 16) -> torch.Tensor:
    """[L, F, B, 3] sums (float32; int32 when ``gh`` is int8)."""
    R = gh.shape[0]
    F = bins.shape[1]
    L = leaf_ids.shape[0]
    B = int(num_bins)
    dev = gh.device
    quant = gh.dtype == torch.int8
    acc_dt = torch.int32 if quant else torch.float32
    if init is not None:
        acc = torch.cat([
            init.to(acc_dt).reshape(L * F * B, HIST_CH),
            torch.zeros((F * B, HIST_CH), dtype=acc_dt, device=dev)])
    else:
        acc = torch.zeros(((L + 1) * F * B, HIST_CH), dtype=acc_dt,
                          device=dev)
    if not quant:
        if hist_dtype not in _HIST_DTYPES:
            raise ValueError(f"unsupported hist_dtype {hist_dtype!r}")
        cdt = _HIST_DTYPES[hist_dtype]
    ids = leaf_ids.to(torch.int32)
    iota_f = torch.arange(F, dtype=torch.int64, device=dev)
    iota_c = torch.arange(HIST_CH, dtype=torch.int64, device=dev)
    for s in range(0, R, block_rows):
        e = min(R, s + block_rows)
        rl = row_leaf[s:e].to(torch.int32)
        eq = rl[:, None] == ids[None, :]
        hit = eq.any(dim=1)
        if num_rows is not None:
            live = torch.arange(s, e, device=dev) < num_rows
            hit = hit & live
        # first matching slot (ids are distinct); L is the spill slot
        li = torch.where(hit, eq.to(torch.uint8).argmax(dim=1),
                         torch.full_like(rl, L, dtype=torch.int64))
        if row_gather is not None:
            src = row_gather[s:e].to(torch.int64)
            if num_rows is not None:
                src = torch.where(hit, src, torch.zeros_like(src))
            bb = bins.index_select(0, src)
        else:
            bb = bins[s:e]
        flat = ((li[:, None] * F + iota_f[None, :]) * B
                + bb.to(torch.int64))                          # [blk, F]
        g = gh[s:e]
        vals = g.to(torch.int32) if quant else g.to(cdt).to(torch.float32)
        vals = vals[:, None, :].expand(e - s, F, HIST_CH)
        # one scalar index per (row, feature, channel): a 1-D index_add_
        # adds in index order, as the row-wise one does, at a fraction
        # of its cost on the CPU
        cell = (flat[:, :, None] * HIST_CH + iota_c).reshape(-1)
        part = torch.zeros_like(acc)
        part.view(-1).index_add_(0, cell, vals.reshape(-1))
        acc += part
    return acc[:L * F * B].reshape(L, F, B, HIST_CH)


def merge_histograms(hist: torch.Tensor, comm, merge="allreduce"
                     ) -> torch.Tensor:
    """Cross-rank merge of ``[S, F, B, 3]`` histograms (the port of
    ``lightgbm_tpu/ops/histogram.py:63``, the reference's
    ``Network::ReduceScatter``, data_parallel_tree_learner.cpp:284),
    through the collective layer ``comm`` (``parallel/comms.py``) under
    the ``hist_merge`` phase, so its report attributes the bytes:

    - ``False`` / ``"none"`` / ``comm`` None: no collective;
    - ``True`` / ``"allreduce"``: every rank receives the full sum;
    - ``"reduce_scatter"``: rank r receives only its block
      ``[r * F_pad/W, (r + 1) * F_pad/W)`` of the feature-slot axis
      (dim 1, zero-padded to a multiple of the world size W).

    f32 sums of two ranks are one add, so both merges give every cell
    the bits of the JAX ``psum``/``psum_scatter``; int32 (quantized)
    sums are exact."""
    if comm is None or merge in (False, "none", None):
        return hist
    from .. import profiler
    from ..phases import HIST_MERGE
    with profiler.phase(HIST_MERGE):
        if merge == "reduce_scatter":
            return comm.reduce_scatter(hist, dim=1, phase=HIST_MERGE)
        return comm.all_reduce(hist, "sum", phase=HIST_MERGE)
