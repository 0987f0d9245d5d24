#!/usr/bin/env python3
"""Where an iteration's time goes in lightgbm_tpu_torch on a CUDA GPU.

Trains the Higgs-shaped binary model of chip_smoke.py (28 features,
max_bin 63, 255 leaves, leaf_batch 21) or, with ``--covtype``, its
Covertype-shaped 7-class model (54 features, max_bin 255, 255 leaves,
leaf_batch 21; ``--per-class`` for class_batch=off) on synthetic rows,
warms up three iterations, times three more with no host sync between
them, then traces two iterations with torch.profiler and prints the
device time by kernel, the device busy share (device time over the
untraced ms/iteration) and the number of top-level PyTorch ops the host
launches per iteration. By default training runs the captured step
(one CUDA-graph replay an iteration; the first warm-up iteration runs
eagerly and captures); ``--eager`` runs the eager loop
(fused_train=false) instead. Usage, from the repository root on a GPU
host:

    python scripts/torch_profile_tree.py [--eager] [rows]   # 10.5M
    python scripts/torch_profile_tree.py --covtype [--per-class] \
        [--eager] [rows]
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
    from chip_smoke import (COVTYPE_ROWS, MC_PARAMS, PARAMS,
                            make_covtype_like, make_higgs_like)
    if not torch.cuda.is_available():
        print("torch_profile_tree.py: no CUDA device visible",
              file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    covtype = "--covtype" in sys.argv
    if covtype:
        params = dict(MC_PARAMS, class_batch="off" if "--per-class"
                      in sys.argv else "auto")
        rows = int(args[0]) if args else COVTYPE_ROWS
        X, y = make_covtype_like(rows)
    else:
        params = dict(PARAMS)
        rows = int(args[0]) if args else 10_500_000
        X, y = make_higgs_like(rows)
    eager = "--eager" in sys.argv
    params["fused_train"] = not eager
    bst = lgt.Booster(params=params,
                      train_set=lgt.Dataset(X, label=y, params=params))
    for _ in range(3):
        bst.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        bst.update(defer=i < 2)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    what = (f"covtype class_batch={params['class_batch']}" if covtype
            else "higgs")
    arm = "eager loop" if eager else "captured step"
    gbdt = bst._gbdt
    if gbdt.fused_train_ok == eager or (gbdt._graph is None) != eager:
        raise AssertionError(f"expected the {arm}: "
                             f"{gbdt.fused_train_reason!r}")
    print(f"{torch.cuda.get_device_name(0)}; {what}, {rows} rows, {arm}: "
          f"{ms:.1f} ms/iteration untraced (3 iterations, one host sync)"
          + ("" if eager else
             f"; capture {gbdt.capture_seconds:.2f} s"))
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
    n_kern = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if dev_us <= 0:
        raise AssertionError("the trace holds no device time")
    print(f"traced 2 iterations: wall {wall * 1e3:.1f} ms (the tracer slows "
          f"the host); device time {dev_us / 2e3:.1f} ms/iteration = busy "
          f"share {dev_us / 2e3 / ms:.3f} of the untraced ms/iteration; "
          f"{n_ops / 2:.0f} top-level aten ops/iteration launched by the "
          f"host; {n_kern / 2:.0f} kernels/iteration")
    print(ka.table(sort_by="self_cuda_time_total", row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
