"""Numeric-divergence guard error type (a copy of
``lightgbm_tpu/resilience/guards.py``'s ``NumericDivergenceError``).

The training step computes a per-iteration finiteness flag over the
gradients, hessians and updated scores on the device, next to the
no-split flag, with no host sync. ``GBDT.sync()`` reads both in its one
transfer and raises this error for the first non-finite iteration when
``nan_guard=raise``. The eager loop checks gradients and hessians before
each build (it syncs then). ``nan_guard=rollback`` needs checkpoints,
which the port does not have yet: it is refused at construction.
"""

from __future__ import annotations

__all__ = ["NumericDivergenceError"]


class NumericDivergenceError(RuntimeError):
    """Non-finite gradients/scores detected at ``iteration``."""

    def __init__(self, iteration: int, detail: str = ""):
        msg = (f"non-finite gradients/scores at iteration "
               f"{iteration}" + (f": {detail}" if detail else ""))
        super().__init__(msg)
        self.iteration = int(iteration)
