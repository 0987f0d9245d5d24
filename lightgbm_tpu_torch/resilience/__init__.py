"""Fault tolerance of the port (``lightgbm_tpu/resilience/``):
full-state checkpoints with bit-identical resume (:mod:`.checkpoint`),
the SIGTERM/SIGINT drain (:mod:`.preemption`), the NaN and device-loss
error types (:mod:`.guards`), atomic writes (:mod:`.atomic_io`) and the
``on_device_loss=degrade`` retry loop (:mod:`.supervisor`)."""

from .atomic_io import atomic_write_bytes, atomic_write_text
from .checkpoint import (CheckpointError, capture_training_checkpoint,
                         checkpoint_path, config_fingerprint,
                         find_resume_checkpoint, is_valid_checkpoint,
                         list_numbered, prune_numbered, read_checkpoint,
                         restore_training_checkpoint, topology_descriptor,
                         write_checkpoint, write_training_checkpoint)
from .guards import DeviceLossError, NumericDivergenceError
from .preemption import PreemptionGuard, TrainingPreempted
from .supervisor import supervised_train

__all__ = [
    "atomic_write_bytes", "atomic_write_text",
    "DeviceLossError", "NumericDivergenceError",
    "PreemptionGuard", "TrainingPreempted",
    "CheckpointError", "checkpoint_path", "config_fingerprint",
    "find_resume_checkpoint", "is_valid_checkpoint", "list_numbered",
    "prune_numbered", "read_checkpoint", "topology_descriptor",
    "write_checkpoint", "capture_training_checkpoint",
    "restore_training_checkpoint", "write_training_checkpoint",
    "supervised_train",
]
