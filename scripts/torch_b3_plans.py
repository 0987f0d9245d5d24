#!/usr/bin/env python3
"""Kernel B3 (``build_root_histograms_classes``) under other tile plans.

At the Covertype-shaped root of chip_smoke.py (581,012 rows padded to a
multiple of 256, 54 features, 7 classes, B = 253) this times B3 under
its default plan and under plans of a fixed block width (8 or 16 warps)
with 256- and 512-row register chains (S = 16 and 32 steps), so that
each chain length is compared at one block shape. For each plan and
addend type (bf16-rounded, f32, int8) it prints the mean time of 10
launches (CUDA events), the kernel's max abs error per channel against
a float64 sum on the card, and the M-tiles the kernel counted. int8 must
equal the plain version; bf16 and f32 must agree with it within rtol
1e-4 of each channel's scale.

Usage, from the repository root on a GPU host:

    python scripts/torch_b3_plans.py
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# (label, warps, steps); warps None is the default plan's choice
PLANS = [("default", None, 16), ("8 warps, S=16", 8, 16),
         ("8 warps, S=32", 8, 32), ("16 warps, S=16", 16, 16),
         ("16 warps, S=32", 16, 32)]


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_b3_plans.py: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_histogram as CH
    X, y = cs.make_covtype_like(cs.COVTYPE_ROWS)
    ds = lgt.Dataset(X, label=y, params=dict(cs.MC_PARAMS)).construct()
    n, F = ds.bins.shape
    R = -(-n // 256) * 256
    dev = ds.bins.device
    bins = torch.zeros((R, F), dtype=torch.uint8, device=dev)
    bins[:n] = ds.bins
    rl0 = torch.full((R,), -1, dtype=torch.int32, device=dev)
    rl0[:n] = 0
    B, K = ds.max_num_bin, cs.NUM_CLASS
    gh_f = cs.mc_gradients(torch.from_numpy(y).to(dev), R)
    qg, qh, _ = cs.quantize(gh_f[..., 0], gh_f[..., 1])
    gh_q = torch.stack([qg, qh, gh_f[..., 2].to(torch.int8)], 2).contiguous()
    print(f"{torch.cuda.get_device_name(0)}; B3 at R={R} F={F} K={K} B={B}",
          flush=True)
    cases = []
    for label, gh, hd in (("bf16", gh_f, "bfloat16"),
                          ("f32", gh_f, "float32"),
                          ("int8", gh_q, "int8")):
        kw = dict(num_bins=B,
                  hist_dtype="bfloat16" if hd == "int8" else hd)
        plain = CH.build_root_histograms_classes_plain(bins, gh, rl0, **kw)
        ex = cs.f64_root_sums(bins, gh, rl0 == 0, B, kw["hist_dtype"])
        cases.append((label, gh, hd, kw, plain, ex))

    for name, warps, steps in PLANS:
        for label, gh, hd, kw, plain, ex in cases:
            plan = CH.class_mma_plan(F, K, B, R, hd, warps=warps,
                                     steps=steps)
            tiles = torch.zeros(F, dtype=torch.int64, device=dev)

            def run(m=None):
                return CH.build_root_histograms_classes(
                    bins, gh, rl0, plan=plan, mtiles=m, **kw)
            got = run(tiles)
            if label == "int8":
                if not torch.equal(got, plain):
                    raise AssertionError(f"{name} int8: not exact")
            else:
                cs.check_close(f"{name} {label}", got, plain, 1e-4)
            if not torch.equal(run(), got):
                raise AssertionError(f"{name} {label}: two launches differ")
            err = (got.double() - ex).abs().amax(dim=(0, 1, 2))
            ms = cs.cuda_ms(run, 10)
            print(f"[{name}] {label:4s} {ms:.3f} ms; max abs err vs the f64 "
                  f"sum g/h/count "
                  + "/".join(f"{float(v):.4g}" for v in err)
                  + f"; M-tiles {int(tiles.sum())}; plan fc={plan['fc']} "
                  f"threads={plan['threads']} per_sm={plan['per_sm']} "
                  f"tile_rows={plan['tile_rows']} "
                  f"n_chunks={plan['n_chunks']} smem={plan['smem']}",
                  flush=True)
    scale = cases[0][5].abs().amax(dim=(0, 1, 2))
    print("channel scale g/h/count "
          + "/".join(f"{float(v):.4g}" for v in scale), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
