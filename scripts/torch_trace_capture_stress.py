#!/usr/bin/env python3
"""Do profiler windows opened from the telemetry server's thread ever
make a CUDA-graph capture of the training step fail? A repeated check
on a CUDA GPU.

Each round runs, in the order chip_smoke.py runs them:

- ``tele``: chip_smoke.py's ``[telemetry]`` runs of the Higgs-shaped
  model (12 captured iterations each): bare, with telemetry (scrapes at
  each sync), traced (a 1 ms and a 300 ms ``/trace`` window taken by a
  helper thread through the server), bare again, then 3 eager
  iterations at ``fused_split=off`` with an event log;
- ``kernels``: chip_smoke.py's ``[B3]`` and ``[mc-stream]`` checks at
  the Covertype-shaped root (no graph capture);
- ``mc``: the Covertype-shaped multiclass model on 2^16 rows, one
  iteration through the captured step, class-batched, per class and
  quantized (the card arms of ``[mc-parity]``);
- ``overlap``: the class-batched multiclass run with ``telemetry_port=0``
  and 3 iterations, a helper thread asking for ``/trace?duration_ms=50``
  as soon as the server is up, so that the window opens while iteration
  0 runs and captures.

Every training is caught: a failure is counted under its stage and the
round goes on. Prints one JSON line of runs and failures by stage (with
the first error of each), the status of every ``/trace`` answer (with
the error of each that was not 200) and the threads alive after each
round, and exits 1 if any run failed.

Usage, from the repository root on a GPU host:

    python scripts/torch_trace_capture_stress.py [--rounds N]
"""

import argparse
import json
import os
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--higgs-rows", type=int, default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as S
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import cuda_histogram as CH
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import split as SP
    from lightgbm_tpu_torch.telemetry import active_session
    CH.load_library()
    n_h = a.higgs_rows or S.HIGGS_ROWS
    X, y = S.make_higgs_like(n_h + S.VALID_ROWS)
    tr = lgt.Dataset(X[:n_h], label=y[:n_h], params=dict(S.PARAMS))
    va = lgt.Dataset(X[n_h:], label=y[n_h:], reference=tr)
    tr.construct()
    va.construct()
    Xc_all, yc_all = S.make_covtype_like(S.COVTYPE_ROWS)
    Xc, yc = Xc_all[:1 << 16], yc_all[:1 << 16]
    ds_c = lgt.Dataset(Xc_all, label=yc_all,
                       params=dict(S.MC_PARAMS)).construct()
    yc_dev = torch.from_numpy(yc_all).to("cuda")
    out_dir = os.path.join(ROOT, "build", "trace_capture_stress")
    os.makedirs(out_dir, exist_ok=True)
    runs, fails, first = {}, {}, {}

    def attempt(stage, fn):
        runs[stage] = runs.get(stage, 0) + 1
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — counted, not fatal
            fails[stage] = fails.get(stage, 0) + 1
            first.setdefault(stage, f"{type(e).__name__}: {e}"[:400])
            traceback.print_exc()
            torch.cuda.synchronize()

    def tele():
        base = dict(S.PARAMS, eval_period=2)
        attempt("tele bare", lambda: S.telemetry_run(lgt, CH, tr, va, base))
        for key, trace in (("telemetry", False), ("traced", True)):
            p = dict(base, telemetry_port=0, event_log=os.path.join(
                out_dir, f"{key}.events.jsonl"))

            def run(p=p, trace=trace):
                r = S.telemetry_run(lgt, CH, tr, va, p, trace=trace)
                for k in ("first", "trace"):
                    if k in r:
                        traces.append(answer(k, r[k][0], r[k][1]))
            attempt(f"tele {key}", run)
        attempt("tele bare again",
                lambda: S.telemetry_run(lgt, CH, tr, va, base))
        p = dict(S.PARAMS, fused_split="off", fused_train=False,
                 eval_period=1,
                 event_log=os.path.join(out_dir, "eager.events.jsonl"))
        attempt("tele eager", lambda: lgt.train(p, tr, 3))

    def kernels():
        # the running maxima that [B1]/[B2] seed in chip_smoke.py
        res = {"B1": {"max_abs_err": 0.0}, "B2": {"max_abs_err": 0.0},
               "B3": {}}
        attempt("kernels", lambda: (
            S.phase_b3(ds_c, yc_dev, CH, H, res),
            S.phase_mc_stream(ds_c, yc_dev, CH, H, SP, res)))

    def mc():
        for name, extra in (("batched", {}),
                            ("per-class", {"class_batch": "off"}),
                            ("quantized", S.QUANT)):
            p = dict(S.MC_PARAMS, **extra)
            attempt(f"mc {name}", lambda p=p: lgt.train(
                p, lgt.Dataset(Xc, label=yc, params=p), 1))

    def overlap():
        p = dict(S.MC_PARAMS, telemetry_port=0)

        def tracer():
            t_end = time.perf_counter() + 60
            while time.perf_counter() < t_end:
                sess = active_session()
                if sess is not None and sess.port is not None:
                    st, body = S.http_get(sess.port,
                                          "/trace?duration_ms=50")
                    traces.append(answer("overlap", st, body))
                    return
                time.sleep(0.001)

        def run():
            th = threading.Thread(target=tracer, daemon=True)
            th.start()
            try:
                lgt.train(p, lgt.Dataset(Xc, label=yc, params=p), 3)
            finally:
                th.join(timeout=60)
        attempt("overlap", run)

    def answer(what, st, body):
        if st == 200:
            return [what, st]
        try:
            body = json.loads(body)
        except (TypeError, ValueError):
            pass
        if isinstance(body, dict):
            body = body.get("error", body)
        return [what, st, str(body)[:300]]

    t0 = time.perf_counter()
    traces = []
    for r in range(a.rounds):
        tele()
        kernels()
        mc()
        overlap()
        S.log(f"round {r + 1}/{a.rounds} at {time.perf_counter() - t0:.1f} "
              f"s: failures {fails}; traces {traces[-4:]}; threads "
              f"{sorted(t.name for t in threading.enumerate())}, native "
              f"{len(os.listdir('/proc/self/task'))}")
    S.log(json.dumps({"rounds": a.rounds, "runs": runs, "failures": fails,
                      "first_error": first, "traces": traces,
                      "seconds": round(time.perf_counter() - t0, 1),
                      "device": torch.cuda.get_device_name(0)}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
