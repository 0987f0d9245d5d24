"""Logging with levels + redirectable sink.

Analog of the reference logging system (``include/LightGBM/utils/
log.h:78-185``): four levels gated by ``verbosity``, output redirectable
to a user callback / standard logger (``LGBM_RegisterLogCallback`` /
python ``register_logger``, basic.py).

PyTorch port: a copy of ``lightgbm_tpu/log.py``. Warnings and fatals
also land in the active run's event log (``telemetry/events.py``).

Level mapping follows config.h ``verbosity``: <0 fatal-only, 0 warning,
1 info (default), >1 debug.
"""

from __future__ import annotations

import sys
from typing import Any, Optional

__all__ = ["register_logger", "set_verbosity", "debug", "info", "warning",
           "fatal"]

_DEBUG, _INFO, _WARNING, _FATAL = 10, 20, 30, 40


class _State:
    level = _INFO
    logger: Optional[Any] = None
    info_method = "info"
    warning_method = "warning"


def register_logger(logger: Any, info_method_name: str = "info",
                    warning_method_name: str = "warning") -> None:
    """Redirect output to a custom logger (basic.py register_logger)."""
    for m in (info_method_name, warning_method_name):
        if not callable(getattr(logger, m, None)):
            raise TypeError(f"logger has no callable method {m!r}")
    _State.logger = logger
    _State.info_method = info_method_name
    _State.warning_method = warning_method_name


def set_verbosity(verbosity: int) -> None:
    """config.h verbosity -> level filter (log.h ResetLogLevel)."""
    if verbosity < 0:
        _State.level = _FATAL
    elif verbosity == 0:
        _State.level = _WARNING
    elif verbosity == 1:
        _State.level = _INFO
    else:
        _State.level = _DEBUG


def _emit(level: int, msg: str, warn: bool = False) -> None:
    if level < _State.level:
        return
    if _State.logger is not None:
        method = (_State.warning_method if warn else _State.info_method)
        getattr(_State.logger, method)(msg)
    else:
        print(msg, file=sys.stderr if warn else sys.stdout, flush=True)


def _record(level: str, msg: str) -> None:
    """Single choke point routing warnings/fatals into the active run's
    event log (telemetry/events.py). Lazy: telemetry imports this
    module, so the import happens at call time; a run with no active
    EventLog makes this a no-op."""
    from .telemetry.events import record_log
    record_log(level, msg)


def eval_info(msg: str) -> None:
    """Evaluation lines from user-requested callbacks (log_evaluation,
    early_stopping): honor the logger redirection but bypass the
    verbosity filter — the user explicitly asked for them."""
    if _State.logger is not None:
        getattr(_State.logger, _State.info_method)(msg)
    else:
        print(msg, flush=True)


def debug(msg: str) -> None:
    _emit(_DEBUG, f"[LightGBM-TPU] [Debug] {msg}")


def info(msg: str) -> None:
    _emit(_INFO, f"[LightGBM-TPU] [Info] {msg}")


def warning(msg: str) -> None:
    _record("warning", msg)
    _emit(_WARNING, f"[LightGBM-TPU] [Warning] {msg}", warn=True)


def fatal(msg: str) -> None:
    """Log::Fatal throws (log.h:143); always raises regardless of level."""
    _record("fatal", msg)
    raise RuntimeError(f"[LightGBM-TPU] [Fatal] {msg}")
