"""Supervised retry loop for device loss (``on_device_loss=degrade``; a
port of ``lightgbm_tpu/resilience/supervisor.py``).

``engine.train`` delegates here when the config asks for degraded-mode
survival. Each attempt is a full ``train()`` call with
``on_device_loss=fail`` (so the inner run raises the typed
:class:`~lightgbm_tpu_torch.resilience.guards.DeviceLossError` instead
of recursing) and ``resume=auto`` (so it restores the newest
checkpoint).

Retry ladder, on one card:

1. A loss: restore the newest checkpoint and retry on the SAME card
   after an exponential backoff — a transient fault clears on its own.
   The port has no mesh to shrink (the JAX package's second rung,
   ``tree_learner=serial``, is where the port already runs), and the
   supervisor never moves a run to the CPU.
2. ``max_retries`` losses: give up and re-raise the last error.
3. A sticky CUDA error (an illegal address, a launch failure) leaves
   the process's CUDA context unusable: every later call on the card
   fails. The supervisor raises it at once, naming the error; a fresh
   process with ``resume=auto`` continues from the newest checkpoint.

Every transition appends a ``degraded`` record (``retry`` or
``give_up``) to the run's event log, when one is configured, so
``python -m lightgbm_tpu_torch monitor`` renders the fault history.

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


def supervised_train(train_fn: Callable, params: Dict[str, Any],
                     train_set, num_boost_round: int = 100, *,
                     max_retries: int = 3, backoff_base_s: float = 0.5,
                     sleep: Callable[[float], None] = time.sleep,
                     **kwargs):
    """Run ``train_fn`` under device-loss supervision; returns its
    Booster. ``kwargs`` pass through to every attempt unchanged."""
    params = dict(params)
    params["on_device_loss"] = "fail"   # the inner run raises, we catch
    if str(params.get("resume", "off")) == "off":
        log_warning("on_device_loss=degrade needs checkpoints to "
                    "restore after a loss; forcing resume=auto")
        params["resume"] = "auto"
    attempt = 0
    while True:
        try:
            return train_fn(params, train_set, num_boost_round, **kwargs)
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
            _record_degraded(params, e.iteration, attempt, "retry", str(e))
            log_info(
                f"device loss ({e}); restoring the newest checkpoint and "
                f"retrying on the same device (attempt {attempt}/"
                f"{max_retries}, backoff {delay:g}s)")
            sleep(delay)
