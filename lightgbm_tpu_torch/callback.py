"""Training callbacks.

Analog of the reference Python callback protocol
(``python-package/lightgbm/callback.py:40-503``): ``CallbackEnv`` tuples,
``EarlyStopException`` control flow, and the four stock callbacks
(early_stopping, log_evaluation, record_evaluation, reset_parameter).

Metric-consumption contract (engine.train reads these attributes to
avoid computing metrics nobody looks at):

- ``needs_eval`` (default True): False on an after-iteration callback
  declares it never reads ``env.evaluation_result_list``; when no
  after-callback needs evals and early stopping is off, engine.train
  skips metric evaluation entirely.
- ``consumes_train_metrics`` (default True): False declares the
  callback ignores training-set entries. ``early_stopping`` sets it —
  train metrics never trigger stopping — so ``is_provide_training_metric``
  with ONLY early stopping active no longer pays a full train-set eval
  every round.

Callbacks observe metrics on engine.train's ``eval_period`` cadence
(config.py): with eval_period=N, after-callbacks fire with evaluation
results every N-th iteration (and the final one); ``env.iteration``
still reports the true iteration index.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List

from . import log

__all__ = ["CallbackEnv", "EarlyStopException", "early_stopping",
           "log_evaluation", "record_evaluation", "reset_parameter"]

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def log_evaluation(period: int = 1, show_stdv: bool = True):
    def _callback(env: CallbackEnv):
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                f"{name}'s {metric}: {value:g}"
                for name, metric, value, _ in env.evaluation_result_list)
            log.eval_info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]):
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv):
        eval_result.clear()
        for name, metric, _, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict()) \
                .setdefault(metric, [])

    def _callback(env: CallbackEnv):
        if not eval_result:
            _init(env)
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result[name][metric].append(value)
    _callback.order = 20

    # full-state checkpoint hooks (resilience/checkpoint.py): the eval
    # history must travel with the checkpoint or a resumed run returns
    # a truncated eval_result dict
    def _get_state():
        return {name: {metric: list(vals)
                       for metric, vals in metrics.items()}
                for name, metrics in eval_result.items()}

    def _set_state(state):
        eval_result.clear()
        for name, metrics in state.items():
            od = collections.OrderedDict()
            for metric, vals in metrics.items():
                od[metric] = list(vals)
            eval_result[name] = od
    _callback.get_state = _get_state
    _callback.set_state = _set_state
    _callback.state_key = "record_evaluation"
    return _callback


def reset_parameter(**kwargs):
    def _callback(env: CallbackEnv):
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to be equal to "
                        "num_boost_round")
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
        if new_params:
            env.model.reset_parameter(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0):
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[list] = []
    cmp_op: List[Callable] = []
    bigger_flags: List[bool] = []   # serializable cmp_op provenance
    enabled = [True]
    first_metric = [""]

    def _make_cmp(bigger: bool) -> Callable:
        if bigger:
            return lambda x, y: x > y + min_delta
        return lambda x, y: x < y - min_delta

    def _init(env: CallbackEnv):
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            if verbose:
                log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            log.eval_info(f"Training until validation scores don't improve for "
                  f"{stopping_rounds} rounds")
        first_metric[0] = env.evaluation_result_list[0][1]
        for name, metric, _, bigger in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            bigger_flags.append(bool(bigger))
            best_score.append(float("-inf") if bigger else float("inf"))
            cmp_op.append(_make_cmp(bigger))

    def _final_iteration_check(env, eval_name_splitted, i):
        if env.iteration == env.end_iteration - 1:
            if verbose:
                log.eval_info("Did not meet early stopping. Best iteration is:\n"
                      f"[{best_iter[i] + 1}]\t"
                      + "\t".join(f"{n}'s {m}: {v:g}"
                                  for n, m, v, _ in best_score_list[i]))
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv):
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i, (name, metric, value, _) in \
                enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](value, best_score[i]):
                best_score[i] = value
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and first_metric[0] != metric:
                continue
            if name == "training":
                continue  # train metrics don't trigger early stopping
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.eval_info("Early stopping, best iteration is:\n"
                          f"[{best_iter[i] + 1}]\t"
                          + "\t".join(f"{n}'s {m}: {v:g}"
                                      for n, m, v, _ in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, metric, i)
    _callback.order = 30
    # stopping never triggers on training metrics (the name ==
    # "training" skip above), so engine.train may skip the train-set
    # eval when early stopping is the only metric consumer
    _callback.consumes_train_metrics = False

    # full-state checkpoint hooks: without them a resumed run restarts
    # the patience window and stops at a different iteration than the
    # uninterrupted one
    def _get_state():
        return {
            "initialized": bool(best_score),
            "enabled": enabled[0],
            "first_metric": first_metric[0],
            "bigger_flags": list(bigger_flags),
            "best_score": list(best_score),
            "best_iter": list(best_iter),
            "best_score_list": [
                None if bsl is None else [list(e) for e in bsl]
                for bsl in best_score_list],
        }

    def _set_state(state):
        del best_score[:], best_iter[:], best_score_list[:]
        del cmp_op[:], bigger_flags[:]
        enabled[0] = state["enabled"]
        first_metric[0] = state["first_metric"]
        if not state["initialized"]:
            return
        bigger_flags.extend(bool(b) for b in state["bigger_flags"])
        best_score.extend(state["best_score"])
        best_iter.extend(int(i) for i in state["best_iter"])
        best_score_list.extend(
            None if bsl is None else [tuple(e) for e in bsl]
            for bsl in state["best_score_list"])
        cmp_op.extend(_make_cmp(b) for b in bigger_flags)
    _callback.get_state = _get_state
    _callback.set_state = _set_state
    _callback.state_key = "early_stopping"
    return _callback
