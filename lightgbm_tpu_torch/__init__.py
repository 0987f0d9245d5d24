"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX reference (``lightgbm_tpu``), with the
same LightGBM-compatible surface for the slice ported so far:
``Dataset`` (arrays, pandas DataFrames, pyarrow Tables, scipy sparse
matrices, ``Sequence`` objects, CSV/TSV/LibSVM files and the binary
Dataset cache) -> ``train`` (custom objectives, ``init_model``) or
``cv`` -> ``Booster.predict`` (scores, ``pred_leaf``, ``pred_contrib``,
``pred_early_stop``) -> ``save_model``/``Booster(model_file=...)``; the
serving path: ``PredictSession``, ``codegen.CompiledEnsemble`` and
``serving.PredictionServer``; the CLI (``python -m
lightgbm_tpu_torch``); the scikit-learn estimators and the plotting
functions. Module names follow the JAX package. The histogram kernels
are CUDA C++ for Hopper (``csrc/``), built at first use; every kernel
has a plain PyTorch version beside it, which CPU tensors take.

Entry points run on ``device_type="cuda"`` by default and raise when no
GPU is visible; ``device_type="cpu"`` runs the plain versions on the
host. This package imports torch and numpy, never jax, and nothing of
``lightgbm_tpu``. pandas, pyarrow, scipy, matplotlib and graphviz are
imported only by the functions that use them, and scikit-learn only
when an estimator class is first looked up.
"""

import importlib.util

from .binning import BinMapper
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .dataset import Dataset, Sequence
from .engine import Booster, CVBooster, PredictSession, cv, train
from .log import register_logger
from . import plotting
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_split_value_histogram, plot_tree)
from .tree import Tree

_SKLEARN = ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]

__all__ = ["BinMapper", "Booster", "CVBooster", "Config", "Dataset",
           "EarlyStopException", "PredictSession", "Sequence", "Tree", "cv",
           "create_tree_digraph", "early_stopping", "log_evaluation",
           "plot_importance", "plot_metric", "plot_split_value_histogram",
           "plot_tree", "plotting", "record_evaluation", "register_logger",
           "reset_parameter", "train"]
try:  # the estimators are exported where scikit-learn is installed
    if importlib.util.find_spec("sklearn") is not None:
        __all__ += _SKLEARN
except (ImportError, ValueError):
    pass


def __getattr__(name):
    # the estimators need scikit-learn at import: load them on first use
    if name in _SKLEARN:
        try:
            from . import sklearn as _sk
        except ImportError as e:
            raise AttributeError(
                f"{name} needs scikit-learn, which is not installed") from e
        return getattr(_sk, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"
