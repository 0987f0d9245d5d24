#!/usr/bin/env python
"""CI gate: the trace-doctor battery over the canonical configs, for
lightgbm_tpu_torch.

Runs the doctor's passes (``lightgbm_tpu_torch/analysis/``) over the
port's hot-path entry points: the step (its op trace), the
data-parallel tree builder, the packed-ensemble predict walk, the
serving micro-batcher and the compiled-ensemble serving path, and B2's
fused build+split contract (TD007). Every canonical config cell (plain
/ EFB / quantized / categorical / multiclass / nan_guard / telemetry)
runs serially in this process; the ``data`` cells run in a world of 2
ranks started by ``python -m lightgbm_tpu_torch.launch -n 2``. The
telemetry cell trains with the observation stack armed (event log and
live endpoints) and must lint like the others. Exit 0 when every report
is clean, 1 when any error-severity finding survives (a rank's failure
is the launcher's exit code).

Self-test modes (``--seed <class>``) inject one regression of each rule
class the port carries and run the matching pass over it; the gate must
exit NON-zero, proving the rule still fires:

- ``closure-const``: a body that makes a 2 MiB tensor from host data
  (TD001, the class of the JAX fused step's ~300 MB embedded dataset);
- ``phase-collective``: an untagged 1 MiB ``all_reduce`` inside a build
  under a 2-rank gloo group (TD103);
- ``recompile-blowout``: batch shapes off the power-of-two ladder, and
  on the card a step that re-captures its graph every iteration
  (TD201);
- ``class-unroll``: a step entering the ``build`` phase once per class
  (TD005, the class_batch knob's regression class);
- ``nan-guard-sync``: a step that reads its finite flag with ``.item()``
  instead of returning it in its output (TD006).

``cpu-donation`` (TD004) is absent: PyTorch has no buffer donation, so
the port carries no TD004.

Run: python scripts/torch_lint_traces.py [--fast] [--seed CLASS]
     [--device cpu]
(the card by default; ``--device cpu`` runs every target on the host.
``--fast`` lints one config cell, serially: the pre-push smoke form.)
"""

import argparse
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

SEED_CLASSES = ("closure-const", "phase-collective", "recompile-blowout",
                "class-unroll", "nan-guard-sync")
DATA_RANKS = 2


def _seed_closure_const(device) -> list:
    import numpy as np
    import torch
    from lightgbm_tpu_torch.analysis import lint_ops, record
    host = np.ones((512, 1024), np.float32)            # 2 MiB

    def body(x):
        return (x[None, :] * torch.tensor(host, device=device)).sum()
    trace = record(body, torch.ones(1024, device=device), device=device)
    return [lint_ops(trace, label="seed/closure_const")]


def _seed_phase_collective(device) -> list:
    """Run on each rank of a 2-rank gloo group (the launcher starts
    this script with ``--rank-seed``)."""
    import torch
    from lightgbm_tpu_torch import profiler
    from lightgbm_tpu_torch.analysis import lint_collectives, record
    from lightgbm_tpu_torch.parallel.distributed import (default_comm,
                                                         init_distributed)
    init_distributed(device_type="cpu")
    comm = default_comm()

    def body(x):
        with profiler.phase("build"):
            return comm.all_reduce(x, "sum")           # no phase tag
    trace = record(body, torch.ones(1 << 18), device="cpu", comm=comm)
    return [lint_collectives(trace.collectives,
                             label="seed/phase_collective")]


def _seed_recompile_blowout(device) -> list:
    import numpy as np
    from lightgbm_tpu_torch.analysis import TraceReport
    from lightgbm_tpu_torch.analysis.capture_guard import (CaptureGuard,
                                                           ShapeRecorder)
    fn = ShapeRecorder(lambda X: X.sum(1))
    for n in (8, 16, 24, 32, 40):                       # every shape novel
        fn(np.zeros((n, 4)))
    rep = TraceReport(label="seed/recompile_blowout")
    if fn.signatures > 2:
        rep.add("TD201", "error", "bucket_ladder",
                f"{fn.signatures} batch shapes against a ladder of 2")
    reports = [rep]
    if device == "cuda":
        from lightgbm_tpu_torch.analysis.doctor import make_booster
        bst = make_booster("plain", device=device)
        gb = bst._gbdt
        with CaptureGuard(max_captures=0, boosters=[bst],
                          label="seed/recapture", strict=False) as g:
            for _ in range(3):
                gb._graphs.clear()       # the step captures again
                bst.update()
            gb.sync()
        reports.append(g.report)
    return reports


def _seed_class_unroll(device) -> list:
    """The regression the class-batched build removed: the step enters
    the ``build`` phase once per class (K = 3), linted with the
    class-batched budget of ONE build a step."""
    import torch
    from lightgbm_tpu_torch import profiler
    from lightgbm_tpu_torch.analysis import lint_ops, record

    def step(gh):                       # gh [K, R]: per-class grads
        outs = []
        for k in range(gh.shape[0]):    # the K-unrolled anti-pattern
            with profiler.phase("build"):
                outs.append(gh[k].cumsum(0)[-1])
        return torch.stack(outs)
    trace = record(step, torch.ones((3, 64), device=device),
                   device=device)
    return [lint_ops(trace, label="seed/class_unroll",
                     max_build_programs=1)]


def _seed_nan_guard_sync(device) -> list:
    """The eager-guard regression TD006 exists for: a step that reads
    its finite flag on the host (a sync an iteration) and so returns
    only data: no flag reaches its output."""
    import torch
    from lightgbm_tpu_torch.analysis import lint_deferred_guard, record

    def step(scores, g):
        new_scores = scores - 0.1 * g
        if not torch.isfinite(new_scores).all().item():   # the sync
            raise FloatingPointError("diverged")
        return new_scores
    trace = record(step, torch.ones((2, 64), device=device),
                   torch.ones((2, 64), device=device), device=device)
    layout = [((2, 64), torch.float32)]     # the step's output: data only
    return [lint_deferred_guard(layout, label="seed/nan_guard_sync",
                                expect_flags=2, trace=trace)]


_SEEDS = {
    "closure-const": _seed_closure_const,
    "phase-collective": _seed_phase_collective,
    "recompile-blowout": _seed_recompile_blowout,
    "class-unroll": _seed_class_unroll,
    "nan-guard-sync": _seed_nan_guard_sync,
}


def _report(reports, tag, verbose=True) -> int:
    from lightgbm_tpu_torch.analysis import merge_errors
    for r in reports:
        print(r.render(verbose=verbose))
    errs = merge_errors(reports)
    print(f"{tag}: {len(reports)} report(s), {len(errs)} error(s)",
          flush=True)
    return 1 if errs else 0


def _launch(argv, device) -> int:
    """This script, with ``argv``, on each rank of a launched world."""
    cmd = [sys.executable, "-m", "lightgbm_tpu_torch.launch", "-n",
           str(DATA_RANKS)] + (["--cpu"] if device == "cpu" else []) \
        + [os.path.abspath(__file__)] + argv
    env = dict(os.environ)
    env["PYTHONPATH"] = (REPO_ROOT + os.pathsep
                         + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    return subprocess.run(cmd, env=env).returncode


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", choices=SEED_CLASSES,
                   help="inject one deliberate regression and verify "
                        "the matching rule fires (self-test; the run "
                        "exits non-zero when the rule works; "
                        "cpu-donation is not carried: PyTorch has no "
                        "buffer donation)")
    p.add_argument("--fast", action="store_true",
                   help="one config cell, serially")
    p.add_argument("--config", action="append", dest="configs")
    p.add_argument("--mode", action="append", dest="modes",
                   choices=("serial", "data"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the targets run (default: the card)")
    p.add_argument("--rank-seed", choices=SEED_CLASSES,
                   help=argparse.SUPPRESS)
    p.add_argument("--rank-data", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("-v", "--verbose", action="store_true")
    ns = p.parse_args(argv)

    import torch
    torch.set_num_threads(2)

    if ns.rank_seed:                # one rank of a seeded world
        return _report(_SEEDS[ns.rank_seed](ns.device),
                       f"rank seed {ns.rank_seed}")
    if ns.seed == "phase-collective":
        rc = _launch(["--rank-seed", ns.seed, "--device", ns.device],
                     ns.device)
    elif ns.seed:
        rc = _report(_SEEDS[ns.seed](ns.device), f"seed {ns.seed}")
    if ns.seed:
        if rc:
            print(f"seeded regression '{ns.seed}' DETECTED (exit {rc}) "
                  "— the rule works", file=sys.stderr)
            return 1
        print(f"seeded regression '{ns.seed}' NOT detected — "
              "the rule is broken", file=sys.stderr)
        return 2

    from lightgbm_tpu_torch.analysis import run_doctor
    configs = ns.configs or (["plain"] if ns.fast else None)
    modes = ns.modes or (["serial"] if ns.fast else ["serial", "data"])
    if ns.rank_data:                # one rank of the data world
        from lightgbm_tpu_torch.parallel.distributed import init_distributed
        init_distributed(device_type=ns.device)
        return _report(run_doctor(configs, ["data"], device=ns.device),
                       "torch_lint_traces data rank", ns.verbose)
    rc = 0
    if "serial" in modes:
        rc = _report(run_doctor(configs, ["serial"], device=ns.device),
                     "torch_lint_traces serial", ns.verbose)
    if "data" in modes:
        extra = sum((["--config", c] for c in (ns.configs or [])), [])
        rc_d = _launch(["--rank-data", "--device", ns.device] + extra
                       + (["-v"] if ns.verbose else []), ns.device)
        print(f"torch_lint_traces data: {DATA_RANKS} ranks, launcher exit "
              f"{rc_d}", flush=True)
        rc = rc or rc_d
    if rc:
        print("TRACE LINT FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
