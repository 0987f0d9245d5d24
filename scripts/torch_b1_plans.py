#!/usr/bin/env python3
"""B1's slot-segmented accumulation under other plans, and where its
time goes, on a CUDA GPU.

Builds chip_smoke.py's three calls of B1/B2 (the Higgs-shaped root and
compacted child call at 10.5M rows, and the class-batched Covertype call
over 147 folded slots), then for each call:

- prints the default plan (``slot_hist_plan``);
- times B1 (bf16-rounded addends, CUDA events, mean of 10 launches)
  under the default plan and under other block widths (``warps=``) and
  rows per work item (``rows=``), each checked against the default
  plan's histogram (rtol 1e-4 of each channel's scale);
- times the default plan with f32 and with int8 addends as well;
- traces two launches of the default plan with torch.profiler and
  prints the device time of each of its kernels per launch.

With ``--wide`` the calls are the Higgs root and child calls at
``max_bin=1023`` (int16 bins, B = 1,021) instead, and the other plans
are bin tiles of 64, 128 and 256 bins (``bin_tile=``) at the block
widths that fit.

Usage, from the repository root on a GPU host:

    python scripts/torch_b1_plans.py [--wide] [higgs_rows]  # default 10.5M
"""

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_histogram as CH
    if not torch.cuda.is_available():
        print("torch_b1_plans.py: no CUDA device visible", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if a != "--wide"]
    wide = "--wide" in sys.argv[1:]
    rows = int(args[0]) if args else C.HIGGS_ROWS
    print(torch.cuda.get_device_name(0), flush=True)
    calls = []
    X, y = C.make_higgs_like(rows)
    params = dict(C.PARAMS, max_bin=C.WIDE_BINS) if wide else dict(C.PARAMS)
    ds = lgt.Dataset(X, label=y, params=params).construct()
    gh_f, gh_q, rl0, root_ids, c_idx, rl_c, n_small, small = \
        C.higgs_streams(ds, torch.from_numpy(y).to("cuda"))
    del X, y
    calls.append(("higgs root", ds, (ds.bins, gh_f, rl0, root_ids), {},
                  gh_q))
    ci = c_idx.long()
    calls.append(("higgs child", ds,
                  (ds.bins, gh_f[ci].contiguous(), rl_c, small),
                  dict(row_gather=c_idx, num_rows=n_small),
                  gh_q[ci].contiguous()))
    if not wide:
        Xc, yc = C.make_covtype_like(C.COVTYPE_ROWS)
        dc = lgt.Dataset(Xc, label=yc, params=dict(C.MC_PARAMS)).construct()
        g_mc, q_mc, _, rl_mc, ids_mc, gat_mc, n_mc = C.mc_stream(
            dc, torch.from_numpy(yc).to("cuda"))
        calls.append(("covtype class-batched", dc, (dc.bins, g_mc, rl_mc,
                                                    ids_mc),
                      dict(row_gather=gat_mc, num_rows=n_mc), q_mc))
    for name, d, args, kw, gh_int8 in calls:
        bins, gh, rl, ids = args
        F, L, R, B = bins.shape[1], ids.shape[0], gh.shape[0], d.max_num_bin
        nr = int(kw["num_rows"]) if "num_rows" in kw else R
        base = CH.slot_hist_plan(F, L, B, R)

        def run(plan):
            return CH._launch_hist(*args, B, "bfloat16", kw.get("row_gather"),
                                   kw.get("num_rows"), plan=plan)
        ref = run(base)
        print(f"[{name}] R={R} live={nr} L={L} F={F} B={B}; default plan "
              f"{base}", flush=True)
        plans = [("default", base)]
        if wide:
            for bt in (64, 128, 256):
                for w in (2, 4, 8):
                    try:
                        plans.append((f"tile={bt} warps={w}",
                                      CH.slot_hist_plan(F, L, B, R, warps=w,
                                                        bin_tile=bt)))
                    except ValueError:    # does not fit shared memory
                        pass
        for w in (1, 2, 4, 16):
            if w != base["warps"]:
                try:
                    plans.append((f"warps={w}",
                                  CH.slot_hist_plan(F, L, B, R, warps=w)))
                except ValueError:        # does not fit shared memory
                    pass
        S = base["rows_per_item"]
        plans += [(f"rows={r}", CH.slot_hist_plan(F, L, B, R, rows=r))
                  for r in (S // 4, S // 2, 2 * S)
                  if r >= 32 * base["warps"]]
        for label, plan in plans:
            out = run(plan)
            torch.cuda.synchronize()
            err = C.check_close(f"{name} {label}", out, ref, 1e-4)
            ms = C.cuda_ms(lambda: run(plan), 10)
            print(f"[{name}] {label:12s} warps={plan['warps']} "
                  f"bin_tile={plan['bin_tile']} x {plan['n_btiles']} "
                  f"S={plan['rows_per_item']} items<={plan['n_items']}: "
                  f"{ms:.3f} ms; max abs diff from the default "
                  f"{err:.3g}", flush=True)
        for label, a2, hd in (("f32", args, "float32"),
                              ("int8", (bins, gh_int8, rl, ids), "bfloat16")):
            ms = C.cuda_ms(lambda: CH._launch_hist(
                *a2, B, hd, kw.get("row_gather"), kw.get("num_rows"),
                plan=base), 10)
            print(f"[{name}] default plan, {label} addends: {ms:.3f} ms",
                  flush=True)
        run(base)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                run(base)
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.self_device_time_total
        total = sum(per.values())
        print(f"[{name}] device time per launch by kernel (default plan), "
              f"total {total / 2e3:.3f} ms:", flush=True)
        for k, v in sorted(per.items(), key=lambda kv: -kv[1]):
            m = re.search(r"(\w+_kernel)", k)
            short = m.group(1) if m else k[:60]
            print(f"    {v / 2e3:8.3f} ms  {short}", flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
