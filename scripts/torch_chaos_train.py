#!/usr/bin/env python
"""Fault-injection harness for lightgbm_tpu_torch: kill training, corrupt
checkpoints, poison gradients, and assert bit-identical recovery or a
clean rejection.

Every flow compares against an UNINTERRUPTED baseline run of the same
cell (param set) on deterministic synthetic data:

- **kill-at-k**: a subprocess trains with ``resume=auto`` and dies at
  iteration k (SIGKILL: instant death; SIGTERM: the preemption guard
  drains the pending ring and writes a final checkpoint). A resume run
  in the same directory must produce a byte-identical model file. k
  sweeps across eval-period and snapshot boundaries.
- **corrupt**: the newest checkpoint of an interrupted run is truncated
  or bit-flipped; the resume run must reject it by checksum, fall back
  to the previous valid one, and still finish byte-identical. With
  EVERY checkpoint corrupted the run must start fresh, and still finish
  byte-identical (never a crash, never a silently wrong model).
- **poison**: a NaN is written into the scores at an arbitrary
  iteration. ``nan_guard=raise`` must fail the run with
  ``NumericDivergenceError``; ``nan_guard=rollback`` (with a transient
  fault) must roll back to the last checkpoint, re-run, and finish
  byte-identical to the clean baseline.
- **event-splice**: a run with the event log armed is SIGKILLed and
  resumed; the resumed run must splice the log
  (``telemetry/events.py``): iteration records identical to an
  uninterrupted baseline's (no duplicated, no skipped eval point), a
  re-emitted run header carrying the same config fingerprint, and a log
  that passes the ``monitor --check`` schema self-check.
- **ingest** (``--ingest``): the shard writer is SIGKILLed right after
  its Nth shard lands (``LIGHTGBM_TPU_CHAOS_KILL_SHARD``). Everything
  left in the output directory must be checksum-valid, and the retry
  must re-ingest ONLY the missing shards (survivors keep their mtimes).
  Same contract after deleting one shard and bit-flipping another. A
  model trained from the repaired directory must be bit-identical to
  one trained from an uninterrupted ingest of the same source.
- **elastic** (``--elastic``): SIGKILL a run on topology A, resume the
  same directory on topology B (another world size, serial <-> data,
  allreduce <-> reduce_scatter) and compare against an uninterrupted
  baseline run entirely at B. Quantized cells must match tree for tree
  bit-identically (``-0.0`` leaf values normalized); the float cell must
  match the final eval metric within FLOAT_TOL. The resumed event log
  must carry a ``reshard`` record.

Where the JAX harness (``scripts/chaos_train.py``) runs a cell on a mesh
of 8 virtual devices in one process, this one runs a world of ranks
started by ``python -m lightgbm_tpu_torch.launch -n W`` (W = 2 for the
``mesh-*`` cells; ``--cpu`` under ``--device cpu``), every rank
receiving the fault's environment. A rank's death is read from the
launcher, which returns the first non-zero exit code of its ranks and
stops the others (``launch._wait_fail_fast``): a SIGKILLed rank gives
-9, which the launcher's ``SystemExit`` turns into exit status 247. The
elastic matrix's 8/4-device meshes become worlds of 4 and 2 ranks.
``elastic/8rs-serial8`` (a serial learner on an 8-device host) has no
counterpart: a world of ranks that each train serially is not one run.
The elastic cells set ``boost_from_average=false`` (a world's automatic
init score is the mean of its ranks', not the serial run's) and
``fused_split=off`` (the data plan's two-pass arm on both sides). Each
rank logs its events to a file of its own (``run{rank}.events.jsonl``,
rank 0 when serial), since the config fingerprint includes the log's
path; the checks read rank 0's.

After a cell's baseline its three groups of flows (kill and corrupt;
poison; event-splice) run concurrently, each in directories of its own;
they share nothing but the baseline's payload.

Cells cover the step and the eager loop, serial and a 2-rank world
(both ``dp_hist_merge`` modes), with bagging and quantized gradients,
the RNG-stream-sensitive configs. Every child trains on ``--device``
(default ``cuda``); no cell of the card moves to the CPU.

Run: python scripts/torch_chaos_train.py [--fast] [--cell NAME ...]
     python scripts/torch_chaos_train.py --elastic [--fast]
     python scripts/torch_chaos_train.py --ingest [--fast]
     python -m lightgbm_tpu_torch chaos [--fast] [--device cpu]
Exit 0 when every assertion holds, 1 otherwise (the CI gate contract,
alongside scripts/torch_lint_traces.py).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROUNDS = 9
EVAL_PERIOD = 3
SNAPSHOT_FREQ = 2
MESH_RANKS = 2

_BASE = dict(objective="binary", metric="auc", num_leaves=7,
             learning_rate=0.2, min_data_in_leaf=5, verbosity=-1,
             bagging_fraction=0.8, bagging_freq=2, bagging_seed=7,
             use_quantized_grad=True, num_grad_quant_bins=4,
             eval_period=EVAL_PERIOD, snapshot_freq=SNAPSHOT_FREQ,
             snapshot_keep=50, resume="auto")

# name -> (param overrides, step on/off)
CELLS = {
    "fused/serial": ({}, True),
    "legacy/serial": ({}, False),
    "fused/mesh-rs": ({"tree_learner": "data",
                       "dp_hist_merge": "reduce_scatter"}, True),
    "fused/mesh-ar": ({"tree_learner": "data",
                       "dp_hist_merge": "allreduce"}, True),
    "legacy/mesh-rs": ({"tree_learner": "data",
                        "dp_hist_merge": "reduce_scatter"}, False),
}

# kill points straddling the cadence: 2 = snapshot boundary, 3 = eval
# boundary, 5 = neither, 6 = both, 9 = final iteration
KILLS_FULL = (2, 3, 5, 6, 9)
KILLS_FAST = (3, 5)

# -- elastic cells: kill at topology A, resume at topology B -----------
_RS = {"tree_learner": "data", "dp_hist_merge": "reduce_scatter"}
_AR = {"tree_learner": "data", "dp_hist_merge": "allreduce"}
_SERIAL: dict = {}
_ELASTIC_BASE = {"boost_from_average": False, "fused_split": "off"}

# name -> (params_A, ranks_A, params_B, ranks_B, base overrides); one
# rank is a serial process, more are a world started by the launcher
ELASTIC_CELLS = {
    "elastic/4rs-2rs": (_RS, 4, _RS, 2, {}),
    "elastic/4ar-serial1": (_AR, 4, _SERIAL, 1, {}),
    "elastic/2rs-4ar": (_RS, 2, _AR, 4, {}),
    "elastic/serial1-4rs": (_SERIAL, 1, _RS, 4, {}),
    # float histogram merge: not integer-exact across topology, so the
    # contract drops to eval-metric parity within FLOAT_TOL
    "elastic/float-4ar-serial1": (_AR, 4, _SERIAL, 1,
                                  {"use_quantized_grad": False}),
}
ELASTIC_FAST = ("elastic/4rs-2rs", "elastic/4ar-serial1")
ELASTIC_KILL = 5        # mid-run, off both cadence boundaries
FLOAT_TOL = 5e-3        # |auc_resumed - auc_baseline| bound, float cell

# -- ingest crash cell: kill the shard writer mid-pass -----------------
INGEST_ROWS, INGEST_FEATS = 6000, 6
INGEST_SHARD_ROWS = 1500           # -> 4 shards
INGEST_KILL_AFTER = 2              # die right after shard 2 lands

_CHILD = '''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.parallel import distributed as pdist
from lightgbm_tpu_torch.resilience import (NumericDivergenceError,
                                           TrainingPreempted)

params = json.loads(os.environ["CHAOS_PARAMS"])
rounds = int(os.environ["CHAOS_ROUNDS"])
if os.environ.get("LIGHTGBM_TPU_COORDINATOR"):
    pdist.init_distributed()
me = pdist.rank()
if params.get("event_log"):
    params["event_log"] = params["event_log"].format(rank=me)

rng = np.random.RandomState(7)
X = rng.randn(640, 10).astype(np.float32)
y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
     + 0.4 * rng.randn(640) > 0).astype(np.float32)
Xv = rng.randn(256, 10).astype(np.float32)
yv = (Xv[:, 0] + 0.5 * Xv[:, 1] * Xv[:, 2]
      + 0.4 * rng.randn(256) > 0).astype(np.float32)

hist = {}
dtr = lgt.Dataset(X, label=y, params=dict(params))
dva = lgt.Dataset(Xv, label=yv, reference=dtr)
try:
    bst = lgt.train(params, dtr, num_boost_round=rounds,
                    valid_sets=[dva],
                    callbacks=[lgt.record_evaluation(hist)])
except TrainingPreempted as e:
    if me == 0:
        print("CHAOS=" + json.dumps({"preempted": True,
                                     "iteration": e.iteration}))
    sys.exit(0)
except NumericDivergenceError as e:
    if me == 0:
        print("CHAOS=" + json.dumps({"diverged": True,
                                     "iteration": e.iteration}))
    sys.exit(3)
if me != 0:
    sys.exit(0)
bst.save_model(params["output_model"])
import hashlib
import re
sha = hashlib.sha256(
    open(params["output_model"], "rb").read()).hexdigest()
# topology-invariant tree digest: the trees section only (the params
# echo names the topology), without the tree_sizes= byte counts and
# with -0.0 leaf values normalized (a sign of zero is numerically
# identical)
trees = bst.model_to_string().split("parameters:")[0]
trees = "\\n".join(ln for ln in trees.splitlines()
                   if not ln.startswith("tree_sizes="))
trees = re.sub(r"-0\\.0(?![0-9])", "0.0", trees)
from lightgbm_tpu_torch.ops import cuda_histogram as CH
print("CHAOS=" + json.dumps({
    "model_sha": sha, "num_trees": bst.num_trees(),
    "launches": dict(CH.LAUNCHES),
    "trees_sha": hashlib.sha256(trees.encode()).hexdigest(),
    "eval_hist": {k: {m: list(v) for m, v in d.items()}
                  for k, d in hist.items()}}))
'''

_INGEST_CHILD = '''
import json, os
import lightgbm_tpu_torch  # noqa: F401
from lightgbm_tpu_torch.data.ingest import ingest

params = json.loads(os.environ["CHAOS_PARAMS"])
summary = ingest(os.environ["CHAOS_INGEST_X"],
                 os.environ["CHAOS_INGEST_OUT"], params=params,
                 label=os.environ["CHAOS_INGEST_Y"], verbose=False)
print("CHAOS=" + json.dumps({k: summary[k] for k in
                             ("num_shards", "shards_written",
                              "shards_reused", "total_rows")}))
'''

EVENTS = "run0.events.jsonl"        # rank 0's (or the serial run's) log


def _payload(stdout: str):
    """The last ``CHAOS=`` payload of a child's output, or None."""
    payload = None
    for ln in stdout.splitlines():
        if ln.startswith("CHAOS="):
            payload = json.loads(ln.split("=", 1)[1])
    return payload


def killed_rc(ranks: int) -> int:
    """The exit status of a SIGKILLed run of ``ranks`` processes: the
    child's -9, or the launcher's ``SystemExit(-9)`` (247)."""
    return -signal.SIGKILL if ranks == 1 else (-signal.SIGKILL) & 0xFF


class Chaos:
    def __init__(self, fast: bool = False, device: str = "cuda"):
        self.fast = fast
        self.device = device
        self.failures = []
        self.passes = 0
        self.root = tempfile.mkdtemp(prefix="torch_chaos_train.")
        self._child = None
        # kernel launches of the finished children (rank 0's), by wrapper
        self.launches: dict = {}
        self._lock = threading.Lock()      # a cell's flows run in threads

    def _child_path(self):
        if self._child is None:
            self._child = os.path.join(self.root, "_child.py")
            with open(self._child, "w") as f:
                f.write(_CHILD)
        return self._child

    def _env(self, cell, params, extra=None):
        fused = CELLS[cell][1] if cell in CELLS else True
        env = dict(os.environ)
        env["PYTHONPATH"] = (REPO_ROOT + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        env["LIGHTGBM_TPU_FUSED_TRAIN"] = "1" if fused else "0"
        env["CHAOS_PARAMS"] = json.dumps(params)
        env["CHAOS_ROUNDS"] = str(ROUNDS)
        env.update(extra or {})
        return env

    @staticmethod
    def _ranks(cell) -> int:
        return MESH_RANKS if "mesh" in cell else 1

    def _run_child(self, cell, params, workdir, extra=None,
                   timeout=600.0, ranks=None):
        """Run one training child (a world of ``ranks`` processes through
        the launcher when more than one); returns (payload|None,
        returncode)."""
        ranks = self._ranks(cell) if ranks is None else ranks
        params = dict(params, device_type=self.device)
        cmd = [sys.executable, self._child_path()]
        if ranks > 1:
            cmd = ([sys.executable, "-m", "lightgbm_tpu_torch.launch", "-n",
                    str(ranks)] + (["--cpu"] if self.device == "cpu"
                                   else []) + cmd[1:])
        r = subprocess.run(cmd, cwd=workdir,
                           env=self._env(cell, params, extra),
                           capture_output=True, text=True, timeout=timeout)
        payload = _payload(r.stdout)
        if payload is None and r.returncode == 0:
            print(r.stderr[-2000:], file=sys.stderr)
        with self._lock:
            for k, n in (payload or {}).get("launches", {}).items():
                self.launches[k] = self.launches.get(k, 0) + n
        return payload, r.returncode

    def check(self, name, ok, detail=""):
        with self._lock:
            if ok:
                self.passes += 1
                print(f"  ok  {name}", flush=True)
            else:
                self.failures.append(name)
                print(f"FAIL  {name}" + (f": {detail}" if detail else ""),
                      flush=True)

    def _params(self, cell):
        overrides, _ = CELLS[cell]
        return dict(_BASE, **overrides, output_model="m.txt")

    # -- flows ---------------------------------------------------------

    def baseline(self, cell):
        d = os.path.join(self.root, cell.replace("/", "_"), "baseline")
        os.makedirs(d, exist_ok=True)
        payload, rc = self._run_child(cell, self._params(cell), d)
        if payload is None or "model_sha" not in payload:
            self.check(f"{cell} baseline", False, f"rc={rc}")
            return None, d
        self.check(f"{cell} baseline", True)
        return payload, d

    def kill_at(self, cell, base, k, sig):
        d = os.path.join(self.root, cell.replace("/", "_"),
                         f"kill{k}_{sig}")
        os.makedirs(d, exist_ok=True)
        params = self._params(cell)
        payload, rc = self._run_child(
            cell, params, d,
            extra={"LIGHTGBM_TPU_CHAOS_KILL_ITER": str(k),
                   "LIGHTGBM_TPU_CHAOS_KILL_SIGNAL": sig})
        if sig == "KILL":
            self.check(f"{cell} kill@{k} SIGKILL death",
                       rc == killed_rc(self._ranks(cell)), f"rc={rc}")
        else:
            # SIGTERM drains + writes a final checkpoint + exits clean
            self.check(f"{cell} kill@{k} SIGTERM graceful",
                       rc == 0 and payload and payload.get("preempted"),
                       f"rc={rc} payload={payload}")
        resumed, rc2 = self._run_child(cell, params, d)
        self.check(
            f"{cell} kill@{k}/{sig} resume bit-identical",
            resumed is not None
            and resumed.get("model_sha") == base["model_sha"]
            and resumed.get("eval_hist") == base["eval_hist"],
            f"rc={rc2}")
        return d

    def corrupt(self, cell, base, kill_dir, mode):
        d = os.path.join(self.root, cell.replace("/", "_"),
                         f"corrupt_{mode}")
        if os.path.exists(d):
            shutil.rmtree(d)
        shutil.copytree(kill_dir, d)
        p = os.path.join(d, "m.txt")
        if os.path.exists(p):
            os.unlink(p)
        ckpts = sorted(
            (f for f in os.listdir(d) if ".ckpt_iter_" in f),
            key=lambda f: int(f.rsplit("_", 1)[1]))
        if not ckpts:
            self.check(f"{cell} corrupt/{mode}", False, "no checkpoints")
            return
        targets = ckpts if mode == "all" else ckpts[-1:]
        for name in targets:
            p = os.path.join(d, name)
            blob = open(p, "rb").read()
            if mode == "truncate":
                open(p, "wb").write(blob[:max(1, len(blob) * 2 // 3)])
            else:                    # bit-flip (and mode == "all")
                b = bytearray(blob)
                b[len(b) // 2] ^= 0xFF
                open(p, "wb").write(bytes(b))
        resumed, rc = self._run_child(cell, self._params(cell), d)
        self.check(
            f"{cell} corrupt/{mode} detected + bit-identical finish",
            resumed is not None
            and resumed.get("model_sha") == base["model_sha"],
            f"rc={rc}")

    def poison(self, cell, base):
        params = dict(self._params(cell), nan_guard="raise")
        d = os.path.join(self.root, cell.replace("/", "_"),
                         "poison_raise")
        os.makedirs(d, exist_ok=True)
        payload, rc = self._run_child(
            cell, params, d,
            extra={"LIGHTGBM_TPU_CHAOS_POISON_ITER": "5"})
        self.check(f"{cell} poison nan_guard=raise rejects",
                   rc == 3 and payload and payload.get("diverged"),
                   f"rc={rc} payload={payload}")

        d2 = os.path.join(self.root, cell.replace("/", "_"),
                          "poison_rollback")
        os.makedirs(d2, exist_ok=True)
        params2 = dict(self._params(cell), nan_guard="rollback")
        marker = os.path.join(d2, "poison.marker")
        payload2, rc2 = self._run_child(
            cell, params2, d2,
            extra={"LIGHTGBM_TPU_CHAOS_POISON_ITER": "5",
                   "LIGHTGBM_TPU_CHAOS_POISON_ONCE": marker})
        # nan_guard/output differ in the echoed params section, so the
        # file sha differs from baseline by design: compare trees +
        # eval history instead
        self.check(
            f"{cell} poison nan_guard=rollback recovers bit-identical",
            payload2 is not None
            and payload2.get("num_trees") == base["num_trees"]
            and payload2.get("eval_hist") == base["eval_hist"],
            f"rc={rc2}")

    def event_splice(self, cell):
        """A SIGKILLed run resumed in place must splice its event log:
        same iteration records as an uninterrupted baseline, one
        fingerprint across the re-emitted run headers, schema-clean
        under the monitor --check validator."""
        if REPO_ROOT not in sys.path:
            sys.path.insert(0, REPO_ROOT)
        from lightgbm_tpu_torch.telemetry.events import (check_records,
                                                         read_events)
        params = dict(self._params(cell),
                      event_log="run{rank}.events.jsonl")
        d0 = os.path.join(self.root, cell.replace("/", "_"), "ev_base")
        os.makedirs(d0, exist_ok=True)
        payload, rc = self._run_child(cell, params, d0)
        ev0 = os.path.join(d0, EVENTS)
        ok0 = payload is not None and os.path.exists(ev0)
        base_recs = read_events(ev0) if ok0 else []
        base_iters = [r["iter"] for r in base_recs
                      if r["event"] == "iteration"]
        self.check(f"{cell} event-log baseline",
                   ok0 and not check_records(base_recs)
                   and bool(base_iters), f"rc={rc}")
        if not ok0:
            return
        d = os.path.join(self.root, cell.replace("/", "_"), "ev_kill")
        os.makedirs(d, exist_ok=True)
        # hard death mid-run (torn tail territory), then resume in place
        self._run_child(cell, params, d,
                        extra={"LIGHTGBM_TPU_CHAOS_KILL_ITER": "5",
                               "LIGHTGBM_TPU_CHAOS_KILL_SIGNAL": "KILL"})
        resumed, rc2 = self._run_child(cell, params, d)
        recs = read_events(os.path.join(d, EVENTS))
        headers = [r for r in recs if r["event"] == "run_header"]
        iters = [r["iter"] for r in recs if r["event"] == "iteration"]
        problems = check_records(recs)
        self.check(
            f"{cell} event-log splice (no dup/skip, one fingerprint)",
            resumed is not None and not problems
            and iters == base_iters and len(headers) >= 2
            and len({h["fingerprint"] for h in headers}) == 1,
            f"rc={rc2} iters={iters} vs base={base_iters} "
            f"headers={len(headers)} problems={problems[:3]}")

    def elastic(self, name):
        """Kill at topology A, resume at topology B; the resumed model
        must match an uninterrupted all-B baseline (trees bit-identical
        for quantized cells, final metric within FLOAT_TOL for float),
        and the resumed event log must carry a ``reshard`` record."""
        if REPO_ROOT not in sys.path:
            sys.path.insert(0, REPO_ROOT)
        from lightgbm_tpu_torch.telemetry.events import read_events
        pa, ranks_a, pb, ranks_b, base_over = ELASTIC_CELLS[name]
        quantized = base_over.get("use_quantized_grad", True)
        base = dict(_BASE, **_ELASTIC_BASE, **base_over,
                    output_model="m.txt",
                    event_log="run{rank}.events.jsonl")
        params_a, params_b = dict(base, **pa), dict(base, **pb)

        d0 = os.path.join(self.root, name.replace("/", "_"), "base")
        os.makedirs(d0, exist_ok=True)
        payload, rc = self._run_child(name, params_b, d0, ranks=ranks_b)
        if payload is None or "trees_sha" not in payload:
            self.check(f"{name} baseline@B", False, f"rc={rc}")
            return
        self.check(f"{name} baseline@B", True)

        d = os.path.join(self.root, name.replace("/", "_"), "kill")
        os.makedirs(d, exist_ok=True)
        _, rc_k = self._run_child(
            name, params_a, d, ranks=ranks_a,
            extra={"LIGHTGBM_TPU_CHAOS_KILL_ITER": str(ELASTIC_KILL),
                   "LIGHTGBM_TPU_CHAOS_KILL_SIGNAL": "KILL"})
        self.check(f"{name} kill@{ELASTIC_KILL}@A SIGKILL death",
                   rc_k == killed_rc(ranks_a), f"rc={rc_k}")
        resumed, rc_r = self._run_child(name, params_b, d, ranks=ranks_b)
        if resumed is None:
            self.check(f"{name} resume@B", False, f"rc={rc_r}")
            return
        self.check_resumed(name, quantized, resumed, payload)
        recs = read_events(os.path.join(d, EVENTS))
        want = (pa, ranks_a) != (pb, ranks_b)
        self.check_reshard(name, recs, want)

    def check_resumed(self, name, quantized, resumed, baseline):
        """The resumed run at B against the all-B baseline."""
        if quantized:
            self.check(
                f"{name} resume@B trees bit-identical + eval parity",
                resumed.get("trees_sha") == baseline["trees_sha"]
                and resumed.get("eval_hist") == baseline["eval_hist"],
                f"trees {resumed.get('trees_sha')} "
                f"vs {baseline['trees_sha']}")
        else:
            h0 = baseline["eval_hist"]["valid_0"]["auc"][-1]
            h1 = resumed["eval_hist"]["valid_0"]["auc"][-1]
            self.check(
                f"{name} resume@B metric parity (|d|<{FLOAT_TOL})",
                resumed.get("num_trees") == baseline["num_trees"]
                and abs(h1 - h0) < FLOAT_TOL,
                f"auc {h1} vs {h0}")

    def check_reshard(self, name, recs, want):
        """The resumed event log carries a ``reshard`` record exactly
        when the topology changed."""
        reshards = [r for r in recs if r.get("event") == "reshard"]
        self.check(
            f"{name} reshard event {'recorded' if want else 'absent'}",
            bool(reshards) == want,
            f"{len(reshards)} reshard records")

    def _run_ingest_child(self, workdir, out_dir, x_path, y_path,
                          params, extra=None):
        """(payload|None, returncode) for one ingest subprocess."""
        child = os.path.join(self.root, "_ingest_child.py")
        if not os.path.exists(child):
            with open(child, "w") as f:
                f.write(_INGEST_CHILD)
        env = dict(os.environ,
                   PYTHONPATH=REPO_ROOT,
                   CHAOS_PARAMS=json.dumps(params),
                   CHAOS_INGEST_OUT=out_dir,
                   CHAOS_INGEST_X=x_path, CHAOS_INGEST_Y=y_path,
                   **(extra or {}))
        r = subprocess.run([sys.executable, child], cwd=workdir,
                           env=env, capture_output=True, text=True,
                           timeout=600.0)
        payload = _payload(r.stdout)
        if payload is None and r.returncode == 0:
            print(r.stderr[-2000:], file=sys.stderr)
        return payload, r.returncode

    def ingest_chaos(self):
        """SIGKILL the shard writer mid-pass; everything that survives
        must be checksum-valid, the retry must rewrite ONLY what is
        missing/invalid, and the repaired directory must train
        bit-identically to an uninterrupted ingest."""
        import glob

        import numpy as np
        if REPO_ROOT not in sys.path:
            sys.path.insert(0, REPO_ROOT)
        from lightgbm_tpu_torch.data.shardfile import verify_shard

        name = "ingest/kill-mid-write"
        print(f"== {name} ==", flush=True)
        d = os.path.join(self.root, "ingest")
        out = os.path.join(d, "shards")
        os.makedirs(out, exist_ok=True)
        rng = np.random.default_rng(13)
        X = rng.normal(size=(INGEST_ROWS, INGEST_FEATS))
        y = (X[:, 0] - X[:, 1] > 0).astype(np.float64)
        x_path, y_path = (os.path.join(d, "X.npy"),
                          os.path.join(d, "y.npy"))
        np.save(x_path, X)
        np.save(y_path, y)
        params = dict(objective="binary", verbosity=-1,
                      ingest_rows_per_shard=INGEST_SHARD_ROWS,
                      device_type=self.device)

        # 1. die right after shard INGEST_KILL_AFTER lands
        _, rc = self._run_ingest_child(
            d, out, x_path, y_path, params,
            extra={"LIGHTGBM_TPU_CHAOS_KILL_SHARD":
                   str(INGEST_KILL_AFTER)})
        self.check(f"{name} SIGKILL death", rc == -signal.SIGKILL,
                   f"rc={rc}")
        survivors = sorted(glob.glob(os.path.join(out, "*.lgbtpu")))
        all_valid = all(verify_shard(p) for p in survivors)
        self.check(
            f"{name} survivors checksum-valid",
            len(survivors) == INGEST_KILL_AFTER and all_valid,
            f"{len(survivors)} shards, valid={all_valid}")
        mtimes = {p: os.path.getmtime(p) for p in survivors}

        # 2. retry re-ingests only the missing shards
        payload, rc = self._run_ingest_child(d, out, x_path, y_path,
                                             params)
        n = payload["num_shards"] if payload else -1
        self.check(
            f"{name} retry rewrites only missing",
            rc == 0 and payload is not None
            and payload["shards_reused"] == INGEST_KILL_AFTER
            and payload["shards_written"] == n - INGEST_KILL_AFTER
            and all(os.path.getmtime(p) == t
                    for p, t in mtimes.items()),
            f"rc={rc} payload={payload}")

        # 3. delete one shard + bit-flip another: retry must detect and
        # rewrite exactly those two
        shards = sorted(glob.glob(os.path.join(out, "*.lgbtpu")))
        if len(shards) >= 4:
            os.unlink(shards[0])
            with open(shards[3], "r+b") as f:
                f.seek(100)
                f.write(b"\xff\xff\xff\xff")
            keep = {p: os.path.getmtime(p) for p in shards[1:3]}
            payload, rc = self._run_ingest_child(d, out, x_path,
                                                 y_path, params)
            self.check(
                f"{name} delete+corrupt repair",
                rc == 0 and payload is not None
                and payload["shards_written"] == 2
                and payload["shards_reused"] == len(shards) - 2
                and all(os.path.getmtime(p) == t
                        for p, t in keep.items()),
                f"rc={rc} payload={payload}")

        # 4. the repaired directory trains bit-identically to a fresh
        # uninterrupted ingest of the same source
        if not self.fast:
            import lightgbm_tpu_torch as lgt
            from lightgbm_tpu_torch.data.ingest import ingest as _ingest
            ref = os.path.join(d, "shards_ref")
            _ingest(x_path, ref, params=params, label=y_path,
                    verbose=False)
            tp = dict(objective="binary", num_leaves=15, verbosity=-1,
                      min_data_in_leaf=5, deterministic=True,
                      chunk_budget_mb=0.05, device_type=self.device)
            m_rep = lgt.train(dict(tp), lgt.Dataset(out,
                                                    params=dict(tp)),
                              num_boost_round=5)
            m_ref = lgt.train(dict(tp), lgt.Dataset(ref,
                                                    params=dict(tp)),
                              num_boost_round=5)
            self.check(
                f"{name} repaired dir trains bit-identical",
                np.array_equal(m_rep.predict(X), m_ref.predict(X)))

    # -- driver --------------------------------------------------------

    def _finish(self) -> int:
        shutil.rmtree(self.root, ignore_errors=True)
        if self.launches:
            print(f"torch_chaos_train: kernel launches of the finished "
                  f"runs {json.dumps(self.launches, sort_keys=True)}")
        print(f"torch_chaos_train: {self.passes} passed, "
              f"{len(self.failures)} failed", flush=True)
        if self.failures:
            for f in self.failures:
                print(f"  FAILED: {f}", file=sys.stderr)
            return 1
        return 0

    def run_ingest(self):
        try:
            self.ingest_chaos()
        finally:
            rc = self._finish()
        return rc

    def run_elastic(self, names):
        try:
            for name in names:
                print(f"== {name} ==", flush=True)
                self.elastic(name)
        finally:
            rc = self._finish()
        return rc

    def run_cell(self, cell, kills):
        print(f"== {cell} ==", flush=True)
        base, _ = self.baseline(cell)
        if base is None:
            return

        def kill_and_corrupt():
            kill_dir = None
            for idx, k in enumerate(kills):
                sig = "TERM" if idx % 2 else "KILL"
                kill_dir = self.kill_at(cell, base, k, sig)
            if kill_dir:
                self.corrupt(cell, base, kill_dir, "bitflip")
                if not self.fast:
                    self.corrupt(cell, base, kill_dir, "truncate")
                    self.corrupt(cell, base, kill_dir, "all")
        with ThreadPoolExecutor(3) as ex:
            flows = [ex.submit(kill_and_corrupt),
                     ex.submit(self.poison, cell, base),
                     ex.submit(self.event_splice, cell)]
        for f in flows:
            f.result()                  # a flow's exception propagates

    def run(self, cells, kills=None):
        if kills is None:
            kills = KILLS_FAST if self.fast else KILLS_FULL
        try:
            for cell in cells:
                self.run_cell(cell, kills)
        finally:
            rc = self._finish()
        return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fast", action="store_true",
                   help="one serial cell, two kill points (pre-push "
                        "smoke form)")
    p.add_argument("--cell", action="append", dest="cells",
                   choices=sorted(CELLS) + sorted(ELASTIC_CELLS),
                   help="cell(s) to run; default: fast=fused/serial, "
                        "full=all")
    p.add_argument("--kills", default=None,
                   help="comma-separated kill iterations (overrides "
                        "the default sweep)")
    p.add_argument("--elastic", action="store_true",
                   help="run the topology-portable resume matrix "
                        "(kill at topology A, resume at B) instead of "
                        "the kill/corrupt/poison flows")
    p.add_argument("--ingest", action="store_true",
                   help="run the out-of-core ingest crash cell "
                        "(SIGKILL mid shard-write, idempotent retry) "
                        "instead of the kill/corrupt/poison flows")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where every child trains (default: the card)")
    ns = p.parse_args(argv)
    chaos = Chaos(fast=ns.fast, device=ns.device)
    if ns.ingest:
        return chaos.run_ingest()
    if ns.elastic:
        names = ([c for c in (ns.cells or []) if c in ELASTIC_CELLS]
                 or list(ELASTIC_FAST if ns.fast else ELASTIC_CELLS))
        return chaos.run_elastic(names)
    cells = ns.cells or (["fused/serial"] if ns.fast else list(CELLS))
    cells = [c for c in cells if c in CELLS]
    kills = (tuple(int(k) for k in ns.kills.split(","))
             if ns.kills else None)
    return chaos.run(cells, kills=kills)


if __name__ == "__main__":
    raise SystemExit(main())
