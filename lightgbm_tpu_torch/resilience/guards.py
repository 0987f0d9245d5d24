"""Numeric-divergence and device-loss error types (a copy of
``lightgbm_tpu/resilience/guards.py``).

The training step computes a per-iteration finiteness flag over the
gradients, hessians and updated scores on the device, next to the
no-split flag, with no host sync. ``GBDT.sync()`` reads both in its one
transfer and raises :class:`NumericDivergenceError` for the first
non-finite iteration when ``nan_guard`` is armed. The eager loop checks
gradients and hessians before each build (it syncs then).

Policy (``nan_guard``):

- ``off``       — flag computed but ignored
- ``raise``     — surface the error to the caller
- ``rollback``  — ``engine.train`` restores the newest valid checkpoint,
  logs the incident, and re-runs; a repeat divergence past the rollback
  budget (a deterministic fault) re-raises
"""

from __future__ import annotations

__all__ = ["NumericDivergenceError", "DeviceLossError"]


class NumericDivergenceError(RuntimeError):
    """Non-finite gradients/scores detected at ``iteration``."""

    def __init__(self, iteration: int, detail: str = ""):
        msg = (f"non-finite gradients/scores at iteration "
               f"{iteration}" + (f": {detail}" if detail else ""))
        super().__init__(msg)
        self.iteration = int(iteration)


class DeviceLossError(RuntimeError):
    """A CUDA runtime error escaped a boosting step or the sync-point
    transfer (``torch.AcceleratorError``, or a ``RuntimeError`` naming a
    CUDA error). A healthy step never raises one, so ``boosting/gbdt.py``
    turns any such escape into this typed error.
    ``on_device_loss=degrade`` (``resilience/supervisor.py``) catches
    it, restores the newest checkpoint and retries on the same card;
    ``fail`` (default) surfaces it. ``sticky`` marks an error that left
    the CUDA context unusable (an illegal address, a launch failure):
    the process cannot use the card again, so the supervisor raises it
    instead of retrying."""

    def __init__(self, iteration: int, detail: str = "",
                 sticky: bool = False):
        msg = (f"device loss detected at iteration {iteration}"
               + (f": {detail}" if detail else ""))
        super().__init__(msg)
        self.iteration = int(iteration)
        self.detail = detail
        self.sticky = bool(sticky)
