"""PyTorch port, fault-tolerant training on the CPU, against the JAX
package (mirrors ``tests/test_resilience.py``, less its mesh,
multi-process and ``chaos`` CLI cases; the port's ``chaos`` harness is
held by ``tests/test_torch_chaos.py``):

- the ``LGTPUCK1`` container: round trip, corruption, atomic writes;
- checkpoints are interchangeable: one written by either package
  resumes in the other, and the trees equal the uninterrupted JAX run's;
- resume is bit-identical (the captured step and the eager loop), falls
  back past a corrupt newest checkpoint, restores the bagging mask
  inside its window and the early-stopping state, starts fresh on a
  fingerprint mismatch, and refuses ``init_model``;
- ``nan_guard``: raise, off, and rollback to a bit-identical model;
- preemption: the guard latches and escalates; SIGTERM mid-run writes a
  checkpoint, and the resumed run is bit-identical;
- the supervisor (``on_device_loss=degrade``, fault C7's second half):
  ``train`` enters it, a device loss restores and retries on the same
  device to a bit-identical model, and a sticky CUDA error is raised
  without a retry.
"""

import os
import signal

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.boosting.gbdt import _device_loss
from lightgbm_tpu_torch.resilience import (CheckpointError, DeviceLossError,
                                           NumericDivergenceError,
                                           PreemptionGuard,
                                           TrainingPreempted,
                                           atomic_write_text,
                                           find_resume_checkpoint,
                                           is_valid_checkpoint,
                                           read_checkpoint, supervised_train,
                                           write_checkpoint)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the same results,
    and far less CPU time when several test workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rng, n=1500, f=10):
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


# bagging + quantized gradients: the config whose resume is RNG-stream
# and device-state sensitive
PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 7,
          "learning_rate": 0.2, "min_data_in_leaf": 5, "verbosity": -1,
          "bagging_fraction": 0.8, "bagging_freq": 2, "bagging_seed": 7,
          "use_quantized_grad": True, "num_grad_quant_bins": 4,
          "eval_period": 3, "snapshot_freq": 3, "snapshot_keep": 50,
          "resume": "auto", "output_model": "m.txt",
          "device_type": "cpu"}


def _train(rounds=10, extra=None, callbacks=None, mod=lgt, params=PARAMS):
    rng = np.random.RandomState(0)
    X, y = _data(rng)
    Xv, yv = _data(rng, n=600)
    ds = mod.Dataset(X, label=y)
    dv = mod.Dataset(Xv, label=yv, reference=ds)
    hist = {}
    cbs = [mod.record_evaluation(hist)] + list(callbacks or [])
    bst = mod.train(dict(params, **(extra or {})), ds,
                    num_boost_round=rounds, valid_sets=[dv], callbacks=cbs)
    return bst, hist


def _ckpts(d="."):
    return sorted((f for f in os.listdir(d) if ".ckpt_iter_" in f),
                  key=lambda f: int(f.rsplit("_", 1)[1]))


def _drop_after(n):
    for f in _ckpts():
        if int(f.rsplit("_", 1)[1]) > n:
            os.unlink(f)


def _trees(bst):
    return bst.model_to_string().split("end of trees")[0].split(
        "Tree=", 1)[1]


@pytest.fixture
def steps(monkeypatch):
    """Both loops: the captured step (fused_train) and the eager loop
    (the conftest default pins the JAX package's to the eager loop)."""
    def use(fused):
        monkeypatch.setenv("LIGHTGBM_TPU_FUSED_TRAIN", "1" if fused else "0")
        return {"fused_train": fused}
    return use


# ------------------------------------------------------------ container
def test_checkpoint_container_roundtrip(tmp_path):
    p = str(tmp_path / "c.ckpt")
    state = {"iteration": 7, "nested": {"a": [1, 2.5, "x"]}}
    arrays = {"scores": np.arange(12, dtype=np.float32).reshape(3, 4),
              "mask": np.array([True, False, True])}
    texts = {"model": "Tree=0\nend of trees\n"}
    write_checkpoint(p, state, arrays, texts)
    assert is_valid_checkpoint(p)
    s, a, t = read_checkpoint(p)
    assert s["iteration"] == 7 and s["nested"]["a"] == [1, 2.5, "x"]
    np.testing.assert_array_equal(a["scores"], arrays["scores"])
    assert a["scores"].dtype == np.float32
    np.testing.assert_array_equal(a["mask"], arrays["mask"])
    assert t["model"] == texts["model"]
    # the JAX package reads the port's container, and the other way
    from lightgbm_tpu.resilience import checkpoint as J
    js, ja, jt = J.read_checkpoint(p)
    assert js == s and jt == t
    q = str(tmp_path / "j.ckpt")
    J.write_checkpoint(q, state, arrays, texts)
    assert open(q, "rb").read() == open(p, "rb").read()


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "header"])
def test_checkpoint_corruption_detected(tmp_path, damage):
    p = str(tmp_path / "c.ckpt")
    write_checkpoint(p, {"iteration": 1},
                     {"x": np.ones(64, np.float64)}, {"m": "t"})
    blob = open(p, "rb").read()
    if damage == "truncate":
        blob = blob[: len(blob) * 2 // 3]
    elif damage == "bitflip":
        b = bytearray(blob)
        b[len(b) // 2] ^= 0x01
        blob = bytes(b)
    else:
        blob = b"XX" + blob[2:]
    open(p, "wb").write(blob)
    assert not is_valid_checkpoint(p)
    with pytest.raises(CheckpointError):
        read_checkpoint(p)


def test_atomic_write_and_scan(tmp_path):
    p = str(tmp_path / "out.txt")
    atomic_write_text(p, "one")
    atomic_write_text(p, "two")
    assert open(p).read() == "two"
    assert os.listdir(tmp_path) == ["out.txt"]
    out = str(tmp_path / "m.txt")
    for it, fp in ((2, "MINE"), (5, "MINE"), (9, "THEIRS")):
        write_checkpoint(f"{out}.ckpt_iter_{it}",
                         {"iteration": it, "config_fingerprint": fp},
                         {"x": np.ones(8)}, {"m": "t"})
    os.mkdir(out + ".ckpt_iter_11")            # unreadable: skipped
    assert find_resume_checkpoint(out, "MINE") == out + ".ckpt_iter_5"
    assert find_resume_checkpoint(out, "THEIRS") == out + ".ckpt_iter_9"
    assert find_resume_checkpoint(out, "NOBODY") is None


# ------------------------------------------ checkpoints across packages
CROSS = {k: v for k, v in PARAMS.items()
         if k not in ("use_quantized_grad", "num_grad_quant_bins",
                      "device_type")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, monkeypatch,
                                                 writer):
    """A run of one package is cut back to its iteration-6 checkpoint
    and finished by the other; the trees equal the uninterrupted JAX
    run's (float gradients: the quantized descale rounds apart)."""
    monkeypatch.chdir(tmp_path)
    jp = dict(CROSS, tree_learner="serial")
    tp = dict(CROSS, device_type="cpu")
    ref, _ = _train(mod=lgb, params=jp)
    want = _trees(ref)
    for f in os.listdir("."):
        os.unlink(f)
    first, second = ((lgb, jp), (lgt, tp)) if writer == "jax" else \
        ((lgt, tp), (lgb, jp))
    bst, _ = _train(mod=first[0], params=first[1])
    assert _trees(bst) == want
    _drop_after(6)
    bst, _ = _train(mod=second[0], params=second[1])
    assert bst.current_iteration() == 10
    assert _trees(bst) == want


# ------------------------------------------------------- resume parity
@pytest.mark.parametrize("fused", [False, True])
def test_resume_bit_identical(tmp_path, steps, fused, monkeypatch):
    extra = steps(fused)
    monkeypatch.chdir(tmp_path)
    bst1, hist1 = _train(extra=extra)
    assert bst1._gbdt.fused_train_ok == fused
    _drop_after(6)
    bst2, hist2 = _train(extra=extra)
    assert bst2.model_to_string() == bst1.model_to_string()
    assert hist2 == hist1


def test_resume_corrupt_falls_back_and_bag_window(tmp_path, steps, monkeypatch):
    """A bit-flipped newest checkpoint is skipped for the previous one;
    a resume inside a bagging_freq window restores the bagging mask."""
    extra = dict(steps(True), snapshot_freq=1, eval_period=2)
    monkeypatch.chdir(tmp_path)
    bst1, hist1 = _train(rounds=8, extra=extra)
    text1 = bst1.model_to_string()
    # iteration 7 is inside a window (bagging_freq=2 redraws on even
    # iterations); the newest, 8, is corrupt
    newest = _ckpts()[-1]
    b = bytearray(open(newest, "rb").read())
    b[len(b) // 2] ^= 0xFF
    open(newest, "wb").write(bytes(b))
    for f in _ckpts()[:-2]:
        os.unlink(f)
    assert not is_valid_checkpoint(newest)
    bst2, hist2 = _train(rounds=8, extra=extra)
    assert bst2.model_to_string() == text1
    assert hist2 == hist1


def test_resume_early_stopping_and_fingerprint(tmp_path, steps, monkeypatch):
    extra = dict(steps(True), snapshot_freq=2, eval_period=2)

    def cbs():
        return [lgt.early_stopping(2, verbose=False)]
    monkeypatch.chdir(tmp_path)
    bst1, hist1 = _train(rounds=30, extra=extra, callbacks=cbs())
    assert bst1.best_iteration < 30
    kept = _ckpts()[0]
    for f in _ckpts():
        if f != kept:
            os.unlink(f)
    bst2, hist2 = _train(rounds=30, extra=extra, callbacks=cbs())
    assert bst2.best_iteration == bst1.best_iteration
    assert bst2.best_score == bst1.best_score
    assert bst2.model_to_string() == bst1.model_to_string()
    assert hist2 == hist1
    # another config's checkpoints are not resumed: a fresh run
    bst3, hist3 = _train(rounds=4, extra=dict(extra, learning_rate=0.05))
    assert len(hist3["valid_0"]["auc"]) == 2
    assert bst3.num_trees() == 4


def test_resume_rejects_init_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    X, y = _data(np.random.RandomState(0))
    base = lgt.train({"objective": "binary", "verbosity": -1,
                      "device_type": "cpu"},
                     lgt.Dataset(X, label=y, free_raw_data=False), 3)
    with pytest.raises(ValueError, match="resume"):
        lgt.train(dict(PARAMS), lgt.Dataset(X, label=y), 3,
                  init_model=base)


def test_snapshot_and_checkpoint_retention(tmp_path, steps, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _train(rounds=8, extra=dict(steps(True), snapshot_freq=1,
                                snapshot_keep=2))
    snaps = sorted(f for f in os.listdir(".") if ".snapshot_iter_" in f)
    assert [int(s.rsplit("_", 1)[1]) for s in snaps] == [7, 8]
    assert len(_ckpts()) == 2
    assert lgt.Booster(model_file=snaps[0]).num_trees() == 7


# -------------------------------------------------- divergence guards
@pytest.mark.parametrize("fused", [False, True])
def test_nan_guard_raise(tmp_path, steps, monkeypatch, fused):
    extra = steps(fused)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ITER", "4")
    with pytest.raises(NumericDivergenceError):
        _train(extra=dict(extra, nan_guard="raise", resume="off"))


def test_nan_guard_off_ignores(tmp_path, steps, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ITER", "4")
    bst, _ = _train(extra=dict(steps(True), resume="off"))
    assert bst.current_iteration() >= 3


@pytest.mark.parametrize("fused", [False, True])
def test_nan_guard_rollback_recovers_bit_identical(tmp_path, steps,
                                                   monkeypatch, fused):
    """A transient NaN at iteration 5 rolls back to the iteration-4
    checkpoint and re-runs; the model and eval history equal a clean
    run's. Through the captured step the restore must write into the
    step's own buffers."""
    extra = dict(steps(fused), nan_guard="rollback", snapshot_freq=2)
    for d in ("clean", "faulty"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "clean")
    bst1, hist1 = _train(extra=extra)
    monkeypatch.chdir(tmp_path / "faulty")
    marker = str(tmp_path / "faulty" / "poison.marker")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ITER", "5")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_POISON_ONCE", marker)
    bst2, hist2 = _train(extra=extra)
    assert os.path.exists(marker)
    assert bst2.model_to_string() == bst1.model_to_string()
    assert hist2 == hist1


# ----------------------------------------------------------- preemption
def test_preemption_guard_latches_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard(enabled=True) as g:
        assert not g.fired
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.fired and g.signum == signal.SIGTERM
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) is prev


def test_preemption_writes_checkpoint_and_resumes(tmp_path, steps,
                                                  monkeypatch):
    """SIGTERM after iteration 5: the guard drains the ring, writes a
    checkpoint at that (non-snapshot) iteration and raises
    TrainingPreempted; the resumed run is bit-identical to a clean
    one."""
    extra = steps(True)
    for d in ("clean", "preempted"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "clean")
    bst1, hist1 = _train(extra=extra)
    monkeypatch.chdir(tmp_path / "preempted")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_KILL_ITER", "5")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_KILL_SIGNAL", "TERM")
    with pytest.raises(TrainingPreempted) as ei:
        _train(extra=extra)
    assert os.path.basename(ei.value.checkpoint_path) == "m.txt.ckpt_iter_5"
    monkeypatch.delenv("LIGHTGBM_TPU_CHAOS_KILL_ITER")
    bst2, hist2 = _train(extra=extra)
    assert bst2.model_to_string() == bst1.model_to_string()
    assert hist2 == hist1


# ----------------------------------------------------------- supervisor
def test_degrade_enters_the_supervisor(tmp_path, monkeypatch):
    """Fault C7's second half: on_device_loss=degrade used to be
    ignored; train now hands the run to supervised_train."""
    import lightgbm_tpu_torch.resilience.supervisor as S
    seen = {}

    def spy(train_fn, params, *a, **kw):
        seen["params"] = dict(params)
        return "supervised"
    monkeypatch.setattr(S, "supervised_train", spy)
    monkeypatch.chdir(tmp_path)
    X, y = _data(np.random.RandomState(0), n=200)
    out = lgt.train({"objective": "binary", "device_type": "cpu",
                     "on_device_loss": "degrade"},
                    lgt.Dataset(X, label=y), 2)
    assert out == "supervised"
    assert seen["params"]["on_device_loss"] == "degrade"


@pytest.mark.parametrize("fused", [False, True])
def test_degrade_retries_on_the_same_device(tmp_path, steps, monkeypatch,
                                            fused):
    extra = dict(steps(fused), on_device_loss="degrade")
    for d in ("clean", "lost"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "clean")
    bst1, hist1 = _train(extra=extra)
    monkeypatch.chdir(tmp_path / "lost")
    marker = str(tmp_path / "lost" / "devloss.marker")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_DEVLOSS_ITER", "7")
    monkeypatch.setenv("LIGHTGBM_TPU_CHAOS_DEVLOSS_ONCE", marker)
    import time as _time
    monkeypatch.setattr(_time, "sleep", lambda s: None)
    bst2, _ = _train(extra=extra)
    assert os.path.exists(marker)
    assert bst2._gbdt.device.type == "cpu"
    assert bst2.model_to_string() == bst1.model_to_string()


def test_cuda_errors_become_device_loss():
    acc = getattr(torch, "AcceleratorError", RuntimeError)
    e = _device_loss(3, acc("CUDA error: an illegal memory access was "
                            "encountered"))
    assert isinstance(e, DeviceLossError) and e.sticky and e.iteration == 3
    e = _device_loss(4, RuntimeError("histogram accumulation launch "
                                     "failed: cudaError_t 719"))
    assert isinstance(e, DeviceLossError)
    assert _device_loss(5, RuntimeError("shape mismatch")) is None
    assert _device_loss(5, NumericDivergenceError(5)) is None


def test_supervisor_ladder(monkeypatch):
    """Retries with backoff on the same device up to max_retries; a
    sticky error is raised at once."""
    calls, sleeps = [], []

    def flaky(params, train_set, rounds, **kw):
        calls.append(dict(params))
        if len(calls) < 3:
            raise DeviceLossError(len(calls), "lost")
        return "ok"
    assert supervised_train(flaky, {"objective": "binary"}, None, 5,
                            sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 1.0]
    assert all(c["on_device_loss"] == "fail" and c["resume"] == "auto"
               and "device_type" not in c for c in calls)

    def sticky(params, train_set, rounds, **kw):
        calls.append(1)
        raise DeviceLossError(2, "illegal memory access", sticky=True)
    calls.clear()
    with pytest.raises(DeviceLossError):
        supervised_train(sticky, {}, None, 5, sleep=sleeps.append)
    assert calls == [1]

    def always(params, train_set, rounds, **kw):
        raise DeviceLossError(1, "lost")
    with pytest.raises(DeviceLossError):
        supervised_train(always, {}, None, 5, max_retries=2,
                         sleep=lambda s: None)
