#!/usr/bin/env python3
"""Rows per folded leaf on a CUDA GPU: the tree builder's count against
the calls it could be.

Each round of ``_grow`` (``lightgbm_tpu_torch/boosting/tree_builder.py``)
counts the rows of every (class, leaf) to pick the smaller child. This
script times, by CUDA events, that count at the Higgs shape (10.5M rows,
one class) and the Covertype class-batched shape (7 x 581,120 rows),
with the rows spread over 2, 22, 64 and 255 leaves of 256 slots a
class: ``_leaf_counts`` (``torch.histc`` over int32 ids), ``histc`` over
int64 and f32 ids, ``scatter_add_`` of int32 ones, and
``torch.bincount`` (which copies the ids' maximum to the host). Every
count is checked against ``bincount``; ``_leaf_counts`` is also run
under ``torch.cuda.set_sync_debug_mode("error")`` and inside a captured
CUDA graph. Usage, from the repository root on a GPU host:

    python scripts/torch_leaf_counts.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def cuda_ms(fn, reps=20):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main():
    import torch

    from lightgbm_tpu_torch.boosting.tree_builder import _leaf_counts
    if not torch.cuda.is_available():
        print("torch_leaf_counts.py: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    L1 = 256
    for name, K, R in (("higgs", 1, 10_500_096), ("covtype", 7, 581_120)):
        n = K * L1
        gen = torch.Generator(device=dev).manual_seed(0)
        for leaves in (2, 22, 64, 255):
            rl = torch.randint(0, leaves, (K, R), generator=gen, device=dev,
                               dtype=torch.int32)
            ids = (rl + torch.arange(K, device=dev, dtype=torch.int32)[:, None]
                   * L1).reshape(-1)
            want = torch.bincount(ids, minlength=n)
            i64, f32 = ids.long(), ids.float()
            ones = torch.ones(K * R, dtype=torch.int32, device=dev)

            def scatter():
                out = torch.zeros(n, dtype=torch.int32, device=dev)
                return out.scatter_add_(0, i64, ones)
            calls = {
                "_leaf_counts (histc int32)": lambda: _leaf_counts(ids, n),
                "histc int64": lambda: torch.histc(i64, bins=n, min=0,
                                                   max=n),
                "histc f32": lambda: torch.histc(f32, bins=n, min=0, max=n),
                "scatter_add_ int32": scatter,
                "bincount (syncs)": lambda: torch.bincount(ids, minlength=n),
            }
            row = []
            for label, fn in calls.items():
                if not torch.equal(fn().long(), want):
                    raise AssertionError(f"{label} miscounts")
                row.append(f"{label} {cuda_ms(fn):.4f}")
            print(f"{name} {K * R} rows over {leaves} leaves a class, ms: "
                  + "; ".join(row), flush=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _leaf_counts(ids, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _leaf_counts(ids, n)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out.long(), want):
        raise AssertionError("the captured count differs")
    print("_leaf_counts: no host sync; captured and replayed, exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
