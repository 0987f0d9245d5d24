"""The port's fault-injection harness (``scripts/torch_chaos_train.py``)
on the CPU: the ``chaos`` subcommand reaches it; its checks fail on
payloads whose trees, eval history or ``reshard`` record differ from
what the flow expects; and one serial cell (a baseline, SIGKILL at
iteration 5 and its resume, the newest checkpoint bit-flipped or
truncated and every checkpoint corrupted, the NaN poison under both
guards, the event-log splice) passes end to end.
"""

import importlib.util
import os
import signal
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(REPO, "scripts", "torch_chaos_train.py")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _harness():
    spec = importlib.util.spec_from_file_location("torch_chaos_train",
                                                  HARNESS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chaos_cli_wiring(capsys):
    """`python -m lightgbm_tpu_torch chaos --help` loads the harness by
    path and reaches its argparse front end."""
    from lightgbm_tpu_torch.cli import main
    with pytest.raises(SystemExit) as ei:
        main(["chaos", "--help"])
    assert ei.value.code == 0
    out = capsys.readouterr().out.lower()
    assert "fault" in out and "--device" in out


def _jax_constants():
    """The JAX harness's module-level literal constants (read, not run:
    it loads the JAX probe helpers at import)."""
    import ast
    tree = ast.parse(open(os.path.join(REPO, "scripts",
                                       "chaos_train.py")).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            try:
                val = ast.literal_eval(node.value)
            except ValueError:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = val
                elif isinstance(tgt, ast.Tuple):
                    out.update((t.id, v) for t, v in zip(tgt.elts, val))
    return out


def test_harness_keeps_the_jax_constants():
    jax_c = _jax_constants()
    mod = _harness()
    for name in ("ROUNDS", "EVAL_PERIOD", "SNAPSHOT_FREQ", "KILLS_FULL",
                 "KILLS_FAST", "FLOAT_TOL", "ELASTIC_KILL", "INGEST_ROWS",
                 "INGEST_FEATS", "INGEST_SHARD_ROWS", "INGEST_KILL_AFTER"):
        assert getattr(mod, name) == jax_c[name], name
    assert set(mod.CELLS) == {"fused/serial", "legacy/serial",
                              "fused/mesh-rs", "fused/mesh-ar",
                              "legacy/mesh-rs"}
    assert mod.ELASTIC_FAST == ("elastic/4rs-2rs", "elastic/4ar-serial1")
    # the one JAX elastic cell without a counterpart (see the docstring)
    assert '"elastic/8rs-serial8"' in open(os.path.join(
        REPO, "scripts", "chaos_train.py")).read()
    assert not any("serial8" in c for c in mod.ELASTIC_CELLS)
    assert mod.killed_rc(1) == -signal.SIGKILL
    assert mod.killed_rc(2) == 247


def test_checks_fail_on_made_up_payloads():
    mod = _harness()
    c = mod.Chaos(device="cpu")
    base = {"trees_sha": "a" * 64, "num_trees": 9, "model_sha": "m",
            "eval_hist": {"valid_0": {"auc": [0.8, 0.9]}}}
    c.check_resumed("same", True, dict(base), base)
    assert c.failures == [] and c.passes == 1
    c.check_resumed("trees", True, dict(base, trees_sha="b" * 64), base)
    c.check_resumed("hist", True, dict(
        base, eval_hist={"valid_0": {"auc": [0.8, 0.91]}}), base)
    # the float cell: the last metric within FLOAT_TOL (5e-3)
    c.check_resumed("float", False, dict(
        base, eval_hist={"valid_0": {"auc": [0.8, 0.902]}}), base)
    c.check_resumed("far", False, dict(
        base, eval_hist={"valid_0": {"auc": [0.8, 0.91]}}), base)
    assert c.failures == [
        "trees resume@B trees bit-identical + eval parity",
        "hist resume@B trees bit-identical + eval parity",
        "far resume@B metric parity (|d|<0.005)"]
    reshard = [{"event": "iteration", "iter": 6},
               {"event": "reshard", "iter": 5}]
    c.check_reshard("missing", reshard[:1], True)
    c.check_reshard("unexpected", reshard, False)
    c.check_reshard("present", reshard, True)
    assert c.failures[3:] == ["missing reshard event recorded",
                              "unexpected reshard event absent"]
    assert c.passes == 3
    assert c._finish() == 1


def test_payload_reads_the_last_line():
    mod = _harness()
    out = 'noise\nCHAOS={"a": 1}\nmore\nCHAOS={"a": 2}\n'
    assert mod._payload(out) == {"a": 2}
    assert mod._payload("nothing") is None


def test_serial_cell_passes_on_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    env.pop("LIGHTGBM_TPU_FUSED_TRAIN", None)
    r = subprocess.run([sys.executable, HARNESS, "--cell", "fused/serial",
                        "--kills", "5", "--device", "cpu"], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "torch_chaos_train: 10 passed, 0 failed" in r.stdout
