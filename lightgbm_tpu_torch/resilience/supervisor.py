"""Supervised retry loop for device loss (``on_device_loss=degrade``; a
port of ``lightgbm_tpu/resilience/supervisor.py``).

``engine.train`` delegates here when the config asks for degraded-mode
survival. Each attempt is a full ``train()`` call with
``on_device_loss=fail`` (so the inner run raises the typed
:class:`~lightgbm_tpu_torch.resilience.guards.DeviceLossError` instead
of recursing) and ``resume=auto`` (so it restores the newest
checkpoint).

Retry ladder:

1. A loss: restore the newest checkpoint and retry on the same
   topology after an exponential backoff — a transient fault clears on
   its own. The supervisor never moves a run to the CPU.
2. A repeat loss under a parallel plan (``tree_learner`` data, voting
   or feature in a group of more than one process): shrink to
   ``tree_learner=serial`` (``shrink_to_serial``). With
   ``pre_partition=false`` every rank was handed the whole data, so
   every rank leaves the process group and resumes serially from the
   newest checkpoint (the plan's full state restores onto one rank);
   only the former rank 0 goes on writing checkpoints and snapshots.
   With ``pre_partition=true`` a rank holds only its own rows, so the
   supervisor gives up at once (a ``give_up`` record and an error that
   says why).
3. ``max_retries`` losses: give up and re-raise the last error.
4. A sticky CUDA error (an illegal address, a launch failure) leaves
   the process's CUDA context unusable: every later call on the card
   fails. The supervisor raises it at once, naming the error; a fresh
   process with ``resume=auto`` continues from the newest checkpoint.

Every transition appends a ``degraded`` record (``retry``,
``shrink_to_serial`` or ``give_up``) to the run's event log, when one
is configured, so ``python -m lightgbm_tpu_torch monitor`` renders the
fault history.

This module never imports ``engine``: the engine passes its own
``train`` in as ``train_fn``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ..log import info as log_info, warning as log_warning
from .guards import DeviceLossError

__all__ = ["supervised_train"]


def _event_log_path(params: Dict[str, Any]) -> Optional[str]:
    """The event_log resolution of TelemetrySession.from_config."""
    from ..config import Config
    cfg = Config(dict(params))
    path = str(cfg.event_log).strip()
    if path == "auto":
        path = str(cfg.output_model) + ".events.jsonl"
    return path or None


def _record_degraded(params: Dict[str, Any], iteration: int,
                     attempt: int, action: str, detail: str = "") -> None:
    path = _event_log_path(params)
    if path is None:
        return
    from ..telemetry.events import EventLog
    try:
        EventLog(path).append("degraded", iter=int(iteration),
                              attempt=int(attempt), action=action,
                              detail=detail[:200])
    except (OSError, ValueError) as e:
        # observability never blocks the retry
        log_warning(f"cannot append the degraded record to {path}: {e}")


def _plan_active(params: Dict[str, Any]) -> bool:
    """Whether a run of ``params`` trains under a parallel plan here."""
    from ..config import Config
    from ..parallel.data_parallel import learner_class
    from ..parallel.distributed import world_size
    return learner_class(Config(dict(params)), world_size()) is not None


def supervised_train(train_fn: Callable, params: Dict[str, Any],
                     train_set, num_boost_round: int = 100, *,
                     max_retries: int = 3, backoff_base_s: float = 0.5,
                     sleep: Callable[[float], None] = time.sleep,
                     **kwargs):
    """Run ``train_fn`` under device-loss supervision; returns its
    Booster. ``kwargs`` pass through to every attempt (the shrink
    replaces the train and valid sets by their every-row copies)."""
    from ..config import Config
    params = dict(params)
    params["on_device_loss"] = "fail"   # the inner run raises, we catch
    if str(params.get("resume", "off")) == "off":
        log_warning("on_device_loss=degrade needs checkpoints to "
                    "restore after a loss; forcing resume=auto")
        params["resume"] = "auto"
    if _plan_active(params) and train_set is not None:
        # a shrink rebuilds the Datasets of every row
        for ds in [train_set, *(kwargs.get("valid_sets") or [])]:
            ds.keep_full_rows = True
    attempt = 0
    resume_from = None     # the checkpoint the shrunk attempt restores
    while True:
        try:
            run_params = (params if resume_from is None
                          else dict(params, resume=resume_from))
            resume_from = None
            return train_fn(run_params, train_set, num_boost_round,
                            **kwargs)
        except DeviceLossError as e:
            attempt += 1
            if e.sticky:
                _record_degraded(params, e.iteration, attempt, "give_up",
                                 str(e))
                log_warning(f"device loss left the CUDA context unusable "
                            f"({e.detail}); not retrying in this process")
                raise
            if attempt > max_retries:
                _record_degraded(params, e.iteration, attempt, "give_up",
                                 str(e))
                log_warning(f"device loss: {max_retries} retries "
                            "exhausted; surfacing the error")
                raise
            delay = backoff_base_s * (2 ** (attempt - 1))
            if attempt >= 2 and _plan_active(params):
                if bool(Config(dict(params)).pre_partition):
                    why = ("device loss persisted under a parallel plan "
                           "with pre_partition=true: a rank holds only its "
                           "own rows, so the run cannot shrink to "
                           "tree_learner=serial; giving up")
                    _record_degraded(params, e.iteration, attempt,
                                     "give_up", why)
                    log_warning(why)
                    raise DeviceLossError(e.iteration, detail=why) from e
                # every rank holds the whole data: leave the group and
                # resume alone from rank 0's newest checkpoint (a rank's
                # own parameters, an event log of its own, may not match
                # the fingerprint rank 0 wrote)
                resume_from, train_set, kwargs = _shrink(params, train_set,
                                                         kwargs)
                params["tree_learner"] = "serial"
                action = "shrink_to_serial"
                log_warning(
                    f"device loss persisted ({e}); leaving the process "
                    "group and resuming as tree_learner=serial from the "
                    f"newest checkpoint (attempt {attempt}/{max_retries}, "
                    f"backoff {delay:g}s)")
            else:
                action = "retry"
                log_info(
                    f"device loss ({e}); restoring the newest checkpoint "
                    f"and retrying on the same topology (attempt "
                    f"{attempt}/{max_retries}, backoff {delay:g}s)")
            _record_degraded(params, e.iteration, attempt, action, str(e))
            sleep(delay)


def _shrink(params: Dict[str, Any], train_set, kwargs: Dict[str, Any]):
    """Leave the process group: (rank 0's newest checkpoint, the train
    set of every row, ``kwargs`` with the valid sets of every row)."""
    from ..config import Config
    from ..parallel.distributed import broadcast_object, leave_group
    from .checkpoint import config_fingerprint, find_resume_checkpoint
    path = broadcast_object(find_resume_checkpoint(
        str(Config(dict(params)).output_model), config_fingerprint(params)))
    full = train_set.unpartitioned()
    kwargs = dict(kwargs)
    if kwargs.get("valid_sets"):
        kwargs["valid_sets"] = [
            full if v is train_set else v.unpartitioned(reference=full)
            for v in kwargs["valid_sets"]]
    leave_group()
    return path, full, kwargs
