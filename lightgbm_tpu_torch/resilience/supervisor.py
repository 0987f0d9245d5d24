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

The JAX package also appends a ``degraded`` record to the run's event
log at each transition; the port's run log (``event_log``) is not
ported yet, so the transitions are logged only.

This module never imports ``engine``: the engine passes its own
``train`` in as ``train_fn``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

from ..log import info as log_info, warning as log_warning
from .guards import DeviceLossError

__all__ = ["supervised_train"]


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
            if e.sticky:
                log_warning(f"device loss left the CUDA context unusable "
                            f"({e.detail}); not retrying in this process")
                raise
            attempt += 1
            if attempt > max_retries:
                log_warning(f"device loss: {max_retries} retries "
                            "exhausted; surfacing the error")
                raise
            delay = backoff_base_s * (2 ** (attempt - 1))
            log_info(
                f"device loss ({e}); restoring the newest checkpoint and "
                f"retrying on the same device (attempt {attempt}/"
                f"{max_retries}, backoff {delay:g}s)")
            sleep(delay)
