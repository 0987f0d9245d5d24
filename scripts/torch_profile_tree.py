#!/usr/bin/env python3
"""Where an iteration's time goes in lightgbm_tpu_torch on a CUDA GPU.

Trains the Higgs-shaped binary model of chip_smoke.py (28 features,
max_bin 63, 255 leaves, leaf_batch 21; ``--quant`` with
use_quantized_grad, ``--goss`` with GOSS at top_rate 0.2, other_rate
0.1) or, with ``--covtype``, its Covertype-shaped 7-class model (54
features, max_bin 255, 255 leaves, leaf_batch 21; ``--per-class`` for
class_batch=off; ``--quant`` too; ``--efb`` at default parameters, EFB
bundling its one-hot columns; ``--cat`` in Covertype's own 12-column
form with its two categorical columns) or, with ``--year``, its
YearPredictionMSD-shaped regression model (463,715 rows x 90 features,
max_bin 255, 255 leaves, objective regression) or, with ``--rank``,
its MS LTR-shaped lambdarank model (2,270,296 rows x 137 features in
18,919 queries, max_bin 255, 255 leaves; ``--xendcg`` for
rank_xendcg) on synthetic rows; ``--dart`` and ``--rf`` train the
Higgs-shaped model with boosting=dart at its defaults or boosting=rf
(bagging 0.632 every iteration, feature_fraction 0.8), which run the
eager loop;
warms up three iterations (GOSS: up to two past its start iteration
10, so every timed and traced iteration samples), times three more
with no host sync between them, then traces two iterations with
torch.profiler and prints the
device time by kernel, the device busy share (device time over the
untraced ms/iteration) and the number of top-level PyTorch ops the host
launches per iteration. By default training runs the captured step
(one CUDA-graph replay an iteration; the first warm-up iteration runs
eagerly and captures); ``--eager`` runs the eager loop
(fused_train=false) instead. With ``--quant`` or ``--goss`` it then
times, by CUDA events over the trained booster's own gradients, the
plain-PyTorch pieces that JAX computes outside its kernels: the
threefry draws, GOSS's stable sort and whole sample, the quantization,
and the renewal's per-leaf sums. Usage, from the repository root on a
GPU host:

    python scripts/torch_profile_tree.py [--eager] [--quant|--goss] \
        [rows]                                              # 10.5M
    python scripts/torch_profile_tree.py --covtype|--efb|--cat \
        [--per-class] [--quant] [--eager] [rows]
    python scripts/torch_profile_tree.py --year [--eager] [rows]
    python scripts/torch_profile_tree.py --rank [--xendcg] [--eager]
    python scripts/torch_profile_tree.py --dart|--rf [rows]
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
    from chip_smoke import (CAT_COLUMNS, COVTYPE_ROWS, DART_PARAMS,
                            EFB_PARAMS, GOSS, MC_PARAMS, PARAMS, QUANT,
                            RANK_PARAMS, RF_PARAMS, YEAR_PARAMS,
                            YEAR_TRAIN, covtype_12, make_covtype_like,
                            make_higgs_like, make_mslr_like, make_year_like)
    if not torch.cuda.is_available():
        print("torch_profile_tree.py: no CUDA device visible",
              file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    efb, cat = "--efb" in sys.argv, "--cat" in sys.argv
    covtype = "--covtype" in sys.argv or efb or cat
    year, rank = "--year" in sys.argv, "--rank" in sys.argv
    mode = ("dart" if "--dart" in sys.argv
            else "rf" if "--rf" in sys.argv else None)
    quant, goss = "--quant" in sys.argv, "--goss" in sys.argv
    ds_kw = {}
    if covtype:
        params = dict(EFB_PARAMS if efb or cat else MC_PARAMS,
                      class_batch="off" if "--per-class" in sys.argv
                      else "auto")
        rows = int(args[0]) if args else COVTYPE_ROWS
        X, y = make_covtype_like(rows)
        if cat:
            X = covtype_12(X)
            ds_kw = dict(categorical_feature=CAT_COLUMNS)
    elif year:
        params = dict(YEAR_PARAMS)
        rows = int(args[0]) if args else YEAR_TRAIN
        X, y = make_year_like(rows)
    elif rank:
        params = dict(RANK_PARAMS)
        if "--xendcg" in sys.argv:
            params["objective"] = "rank_xendcg"
        X, y, sizes, _, _, _ = make_mslr_like()
        rows = len(y)
        ds_kw = dict(group=sizes)
    else:
        params = dict({"dart": DART_PARAMS, "rf": RF_PARAMS}.get(
            mode, PARAMS), **(GOSS if goss else {}))
        rows = int(args[0]) if args else 10_500_000
        X, y = make_higgs_like(rows)
    if quant:
        params.update(QUANT)
    # DART and RF override the iteration loop: always the eager loop
    eager = "--eager" in sys.argv or mode is not None
    params["fused_train"] = not eager
    bst = lgt.Booster(params=params,
                      train_set=lgt.Dataset(X, label=y, params=params,
                                            **ds_kw))
    warm = int(1.0 / params["learning_rate"]) + 2 if goss else 3
    for _ in range(warm):
        bst.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        bst.update(defer=i < 2)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    what = (f"covtype class_batch={params['class_batch']}" if covtype
            else "year regression" if year
            else f"mslr {params['objective']}" if rank else "higgs")
    what += f" {mode}" if mode else ""
    what += " EFB" if efb else " categorical" if cat else ""
    what += " quantized" if quant else ""
    what += " goss" if goss else ""
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
    if quant or goss:
        time_sampling(gbdt, quant, goss)
    return 0


def time_sampling(gbdt, quant, goss):
    """Device ms (CUDA events, 10 calls each) of the plain-PyTorch
    pieces of sampling and quantization, on the booster's gradients at
    its current scores."""
    import torch

    from chip_smoke import cuda_ms
    from lightgbm_tpu_torch.boosting.gbdt import _leaf_sums
    from lightgbm_tpu_torch.ops import threefry
    g, h = gbdt._grads(gbdt.scores)
    K, R = g.shape
    n = gbdt.train_dd.num_data
    key = threefry.fold_in(threefry.prng_key(1, g.device), 5)
    out = {}
    if goss:
        real = gbdt.train_dd.row_leaf0 >= 0
        score = torch.where(real, torch.abs(g * h).sum(0), float("-inf"))
        out["goss threefry draw [R]"] = cuda_ms(
            lambda: threefry.uniform(key, (R,)), 10)
        out["goss stable sort [R]"] = cuda_ms(
            lambda: torch.sort(score, descending=True, stable=True), 10)
        out["goss sample (_goss_impl)"] = cuda_ms(
            lambda: gbdt._goss_impl(g, h, key), 10)
    if quant:
        out["quant threefry draws 2x[K, n]"] = cuda_ms(
            lambda: [threefry.uniform(threefry.fold_in(key, s), (K, n))
                     for s in (0, 1)], 10)
        out["quantization (_quantize_impl)"] = cuda_ms(
            lambda: gbdt._quantize_impl(g, h, key), 10)
        gen = torch.Generator(device=g.device).manual_seed(0)
        L1 = gbdt.config.num_leaves + 1
        rl = torch.randint(0, L1 - 1, (K, R), generator=gen,
                           device=g.device, dtype=torch.int32)
        out[f"renewal leaf sums, 2x[K, R] over {L1 - 1} leaves"] = cuda_ms(
            lambda: (_leaf_sums(rl, g, L1), _leaf_sums(rl, h, L1)), 10)
    for k, v in out.items():
        print(f"device ms {k}: {v:.3f} (K={K}, R={R}, n={n})")


if __name__ == "__main__":
    sys.exit(main())
