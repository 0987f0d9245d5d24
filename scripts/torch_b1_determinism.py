#!/usr/bin/env python3
"""Are B1's launches bit-identical at the Allstate-shaped bundle calls?
A repeated-launch check, stage by stage, on a CUDA GPU.

Builds chip_smoke.py's ``[sparse]`` Dataset on the card (the
Allstate-shaped one-hot CSR, 2^20 rows x 2,048 columns in 128 EFB
bundles of up to 49 bins), then, for each of three gradient sets
(binary gradients at the boost-from-average score, whose hessian is one
constant; L2 gradients, h = 1; and per-row random g and h in [0.05, 1)),
for the root call (42 slots, slot 0 live) and the compacted child call
(21 slots), at bf16-rounded and at f32 addends:

- launches B1 through its wrapper ``--reps`` times and compares each
  histogram bit for bit (as int32 words) with the first;
- launches B1's eight kernels ``--reps`` times more with its scratch
  (the slot-ordered records, the metadata and the item and fold
  partials) kept and filled with 0xFF bytes first, so that a read of an
  unwritten word shows as NaN or -1, and compares every stage with the
  first launch's;
- prints, for a launch that differs, the stage where it first differs,
  the number of words, the (slot, feature, bin, channel) of the first
  few and the largest difference.

Exits 1 if any launch differs, 0 otherwise.

Usage, from the repository root on a GPU host:

    python scripts/torch_b1_determinism.py [--reps N] [--rows R]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def random_gradients(y_dev):
    """Per-row random g ~ N(0, 1) and h in [0.05, 1)."""
    import torch
    gen = torch.Generator(device=y_dev.device).manual_seed(5)
    g = torch.randn(y_dev.shape, generator=gen, device=y_dev.device)
    h = 0.05 + 0.95 * torch.rand(y_dev.shape, generator=gen,
                                 device=y_dev.device)
    return g, h


def launch_kept(CH, bins, gh, rl, ids, B, hd, row_gather, num_rows):
    """B1's launch as ``_launch_hist`` makes it, with its scratch
    returned and filled with 0xFF bytes before the launch."""
    import torch
    dev = gh.device
    R, F, L = gh.shape[0], bins.shape[1], ids.shape[0]
    n_sm, smem_max, smem_sm = CH._device_props(dev)
    plan = CH.slot_hist_plan(F, L, B, R, 4, smem_max, smem_sm, n_sm)
    nr = CH._num_rows_tensor(num_rows, dev)
    records = torch.full((plan["record_bytes"] // 4,), -1,
                         dtype=torch.int32, device=dev)
    meta = torch.full((plan["meta_ints"],), -1, dtype=torch.int32,
                      device=dev)
    partial = torch.full((plan["partial_bytes"] // 4,), -1,
                         dtype=torch.int32, device=dev)
    out = torch.full((L, F, B, 3), -1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = CH.load_library().lgbt_hist(
        bins.data_ptr(), bins.element_size(), gh.data_ptr(), 0,
        rl.data_ptr(), ids.data_ptr(), CH._ptr(row_gather), CH._ptr(nr),
        records.data_ptr(), meta.data_ptr(), partial.data_ptr(),
        out.data_ptr(), F, L, R, B, int(hd == "bfloat16"), plan["fc"],
        plan["n_ftiles"], plan["bin_tile"], plan["warps"],
        plan["rows_per_item"], plan["n_items"], plan["n_segs"],
        plan["pre_warps"], plan["chunk_rows"], plan["n_wchunks"],
        plan["smem"], stream)
    CH._check(err, "histogram accumulation")
    return dict(meta=meta, records=records, partial=partial, out=out)


def describe(name, a, b, shape=None):
    """Where int32 words a and b differ: a line of text."""
    import torch
    ne = (a != b).nonzero().flatten()
    fa = a[ne[:5]].view(torch.float32).tolist()
    fb = b[ne[:5]].view(torch.float32).tolist()
    where = ne[:5].tolist()
    if shape is not None:
        import numpy as np
        where = [tuple(int(v) for v in np.unravel_index(i, shape))
                 for i in where]
    d = (a[ne].view(torch.float32).double()
         - b[ne].view(torch.float32).double()).abs()
    return (f"{name}: {len(ne)} words differ; first at {where}, "
            f"first {fa} vs {fb}; largest |diff| as f32 "
            f"{float(d.max()) if len(d) else 0:.6g}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", type=int, default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as C
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_histogram as CH
    if not torch.cuda.is_available():
        print("torch_b1_determinism.py: no CUDA device visible",
              file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    X, y = C.make_allstate_like(args.rows or C.ALLSTATE_ROWS)
    ds = lgt.Dataset(X, label=y,
                     params=dict(C.SPARSE_ALLSTATE_PARAMS)).construct()
    del X
    B = ds.bundle_plan.max_bundle_bins
    y_dev = torch.from_numpy(y.astype(np.float32)).to("cuda")
    print(f"bins {tuple(ds.bins.shape)} {ds.bins.dtype}, B={B}", flush=True)
    bad = 0
    for gname, gfn in (("boost_from_average", C.gradients),
                       ("l2", C.l2_gradients),
                       ("random", random_gradients)):
        g, h = gfn(y_dev)
        print(f"[{gname}] g in [{float(g.min()):.4g}, {float(g.max()):.4g}]"
              f", h in [{float(h.min()):.4g}, {float(h.max()):.4g}], "
              f"finite {bool(torch.isfinite(g).all() and torch.isfinite(h).all())}",
              flush=True)
        gh_f, _, rl0, root_ids, c_idx, rl_c, n_small, small = \
            C.higgs_streams(ds, y_dev, gfn)
        calls = {
            "root": ((ds.bins, gh_f, rl0, root_ids), {}),
            "child": ((ds.bins, gh_f[c_idx.long()].contiguous(), rl_c,
                       small), dict(row_gather=c_idx, num_rows=n_small)),
        }
        for cname, (cargs, kw) in calls.items():
            for hd in ("bfloat16", "float32"):
                L = cargs[3].shape[0]
                shape = (L, ds.bins.shape[1], B, 3)
                first = CH.build_histograms_cuda(*cargs, num_bins=B,
                                                 hist_dtype=hd, **kw)
                first_w = first.view(torch.int32).flatten()
                n_diff = 0
                for i in range(args.reps):
                    # an allocation between launches moves the scratch
                    junk = torch.empty(((i % 7) + 1) << 20, device="cuda")
                    k = CH.build_histograms_cuda(*cargs, num_bins=B,
                                                 hist_dtype=hd, **kw)
                    kw_ = k.view(torch.int32).flatten()
                    if not torch.equal(kw_, first_w):
                        n_diff += 1
                        if n_diff <= 3:
                            print("  " + describe(
                                f"[{gname}] {cname} {hd} wrapper launch "
                                f"{i + 1}", kw_, first_w, shape), flush=True)
                    del junk, k
                kept0 = launch_kept(CH, *cargs, B, hd, kw.get("row_gather"),
                                    kw.get("num_rows"))
                kept_nan = int((~torch.isfinite(kept0["out"].view(
                    torch.float32))).sum())
                k_diff = 0
                for i in range(args.reps):
                    kept = launch_kept(CH, *cargs, B, hd,
                                       kw.get("row_gather"),
                                       kw.get("num_rows"))
                    for stage in ("meta", "records", "partial", "out"):
                        if not torch.equal(kept[stage], kept0[stage]):
                            k_diff += 1
                            if k_diff <= 3:
                                print("  " + describe(
                                    f"[{gname}] {cname} {hd} kept launch "
                                    f"{i + 1}, stage {stage}",
                                    kept[stage].flatten(),
                                    kept0[stage].flatten(),
                                    shape if stage == "out" else None),
                                    flush=True)
                            break
                    del kept
                same_as_wrapper = torch.equal(kept0["out"].flatten(),
                                              first_w)
                print(f"[{gname}] {cname:5s} {hd:8s} L={L}: wrapper "
                      f"launches differing from the first {n_diff}/"
                      f"{args.reps}; kept-scratch launches differing "
                      f"{k_diff}/{args.reps}; non-finite words of the "
                      f"0xFF-filled launch {kept_nan}; kept == wrapper "
                      f"{same_as_wrapper}", flush=True)
                bad += n_diff + k_diff + kept_nan + (not same_as_wrapper)
                del kept0, first
                torch.cuda.empty_cache()
    print(f"[done] {'all launches bit-identical' if not bad else 'DIFFER'}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
