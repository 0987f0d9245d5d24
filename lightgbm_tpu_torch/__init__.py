"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX reference (``lightgbm_tpu``), with the
same LightGBM-compatible surface for the slice ported so far:
``Dataset`` -> ``train`` (custom objectives, ``init_model``) or ``cv`` ->
``Booster.predict`` (scores, ``pred_leaf``,
``pred_contrib``, ``pred_early_stop``) -> ``save_model``/
``Booster(model_file=...)``, and the serving path: ``PredictSession``,
``codegen.CompiledEnsemble`` and ``serving.PredictionServer``. Module
names follow the JAX package. The histogram kernels are CUDA C++ for Hopper (``csrc/``),
built at first use; every kernel has a plain PyTorch version beside it,
which CPU tensors take.

Entry points run on ``device_type="cuda"`` by default and raise when no
GPU is visible; ``device_type="cpu"`` runs the plain versions on the
host. This package imports torch and numpy, never jax, and nothing of
``lightgbm_tpu``.
"""

from .binning import BinMapper
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .dataset import Dataset
from .engine import Booster, CVBooster, PredictSession, cv, train
from .log import register_logger
from .tree import Tree

__all__ = ["BinMapper", "Booster", "CVBooster", "Config", "Dataset",
           "EarlyStopException", "PredictSession", "Tree", "cv",
           "early_stopping", "log_evaluation", "record_evaluation",
           "register_logger", "reset_parameter", "train"]

__version__ = "0.1.0"
