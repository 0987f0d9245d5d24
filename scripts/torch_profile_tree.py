#!/usr/bin/env python3
"""Where a tree's time goes in lightgbm_tpu_torch on a CUDA GPU.

Trains the Higgs-shaped model of chip_smoke.py (28 features, max_bin 63,
255 leaves, leaf_batch 21) on synthetic rows, warms up three trees,
times three more with no host sync between them, then traces two trees
with torch.profiler and prints the device time by kernel, the device
busy share of the traced window and the number of PyTorch ops launched
per tree. Usage, from the repository root on a GPU host:

    python scripts/torch_profile_tree.py [rows]        # default 10.5M
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch as lgt
    from chip_smoke import PARAMS, make_higgs_like
    if not torch.cuda.is_available():
        print("torch_profile_tree.py: no CUDA device visible",
              file=sys.stderr)
        return 2
    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 10_500_000
    X, y = make_higgs_like(rows)
    bst = lgt.Booster(params=dict(PARAMS),
                      train_set=lgt.Dataset(X, label=y,
                                            params=dict(PARAMS)))
    for _ in range(3):
        bst.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        bst.update(defer=i < 2)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"{torch.cuda.get_device_name(0)}; {rows} rows: {ms:.1f} ms/tree "
          "untraced (3 trees, one host sync)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            bst.update(defer=i < 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device time = the kernels' own events (aten rows repeat it)
    dev_us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    n_ops = sum(1 for e in prof.events() if e.key.startswith("aten::")
                and e.cpu_parent is None)
    print(f"traced 2 trees: wall {wall * 1e3:.1f} ms (the tracer slows the "
          f"host); device time {dev_us / 2e3:.1f} ms/tree = busy share "
          f"{dev_us / 2e3 / ms:.3f} of the untraced ms/tree; "
          f"{n_ops / 2:.0f} top-level aten ops/tree")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
