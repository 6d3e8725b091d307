"""Training callbacks (reference: python-package/lightgbm/callback.py).

The port of lightgbm_tpu's ``callback.py``: each callback receives a
``CallbackEnv`` before or after every iteration (``before_iteration``),
in ``order``; ``early_stopping`` raises ``EarlyStopException``
(reference: callback.py:146-241, engine.py:244-272). The stateful
callbacks keep ``ckpt_key`` and ``get_state``/``set_state``, the hooks a
checkpoint captures them through; ``checkpoint`` writes atomic training
checkpoints (``checkpoint.py``) that ``train(resume_from=...)`` resumes.
"""

from __future__ import annotations

import collections
from typing import Callable, List

from .utils import log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    """reference: callback.py:14-24."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """reference: callback.py:52-73."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            log.info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


log_evaluation = print_evaluation


def record_evaluation(eval_result: dict) -> Callable:
    """reference: callback.py:75-104. An empty dict gets a list for each
    (dataset, metric) at the first evaluation; a dict that already holds
    results is appended to, as in the JAX package."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            eval_result.setdefault(item[0], collections.OrderedDict())
            eval_result[item[0]].setdefault(item[1], [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)

    def _get_state():
        return {d: {m: list(v) for m, v in metrics.items()}
                for d, metrics in eval_result.items()}

    def _set_state(state):
        eval_result.clear()
        for d, metrics in state.items():
            eval_result[d] = collections.OrderedDict(
                (m, list(v)) for m, v in metrics.items())
    _callback.order = 20
    _callback.ckpt_key = "record_evaluation"
    _callback.get_state = _get_state
    _callback.set_state = _set_state
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Per-iteration parameter schedules (reference: callback.py:106-144):
    each value a list (indexed by iteration) or a callable iteration ->
    value, applied through ``Booster.reset_parameter`` before the
    iteration."""

    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} has to equal "
                                     f"to 'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """reference: callback.py:146-241."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[list] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(env.params.get(alias, "") == "dart"
                             for alias in ("boosting", "boosting_type",
                                           "boost"))
        if not enabled[0]:
            log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if verbose:
            log.info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")
        first_metric[0] = env.evaluation_result_list[0][1]
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:     # bigger is better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _final_iteration_check(env, i) -> None:
        if env.iteration == env.end_iteration - 1:
            if verbose:
                log.info("Did not meet early stopping. Best iteration is:\n"
                         f"[{best_iter[i] + 1}]\t"
                         + "\t".join(_format_eval_result(x)
                                     for x in best_score_list[i]))
            raise EarlyStopException(best_iter[i], best_score_list[i])

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                # the whole result list at the best iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name = env.evaluation_result_list[i][1]
            if first_metric_only and first_metric[0] != eval_name:
                continue
            if env.evaluation_result_list[i][0] == "training":
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info("Early stopping, best iteration is:\n"
                             f"[{best_iter[i] + 1}]\t"
                             + "\t".join(_format_eval_result(x)
                                         for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            _final_iteration_check(env, i)

    def _get_state():
        # the comparators are closures: keep their directions instead
        return {"best_score": list(best_score), "best_iter": list(best_iter),
                "best_score_list": list(best_score_list),
                "bigger": [op(1.0, 0.0) for op in cmp_op],
                "enabled": enabled[0], "first_metric": first_metric[0]}

    def _set_state(state):
        del best_score[:], best_iter[:], best_score_list[:], cmp_op[:]
        best_score.extend(state["best_score"])
        best_iter.extend(state["best_iter"])
        best_score_list.extend(state["best_score_list"])
        for bigger in state["bigger"]:
            cmp_op.append((lambda x, y: x > y) if bigger
                          else (lambda x, y: x < y))
        enabled[0] = state["enabled"]
        first_metric[0] = state["first_metric"]
    _callback.order = 30
    _callback.ckpt_key = "early_stopping"
    _callback.get_state = _get_state
    _callback.set_state = _set_state
    return _callback


def checkpoint(directory: str, period: int = 1, keep: int = 2) -> Callable:
    """Atomic training checkpoints every ``period`` iterations (see
    ``checkpoint.py`` for the layout and the guarantees). Resume with
    ``train(..., resume_from=directory)``: a run killed at k and resumed
    reproduces the uninterrupted run bit-identically. ``keep`` >= 2 keeps
    a fallback when the newest checkpoint is later found truncated or
    corrupt.

    Runs at order 40, after ``record_evaluation`` (20) and
    ``early_stopping`` (30), so the callback states it captures are
    current through the checkpointed iteration. ``_callback.manager`` is
    the CheckpointManager once the first checkpoint is written."""
    from .checkpoint import CheckpointManager
    state = {"warned": False}

    def _callback(env: CallbackEnv) -> None:
        model = env.model
        boosting = getattr(model, "_boosting", None)
        if boosting is None or not hasattr(boosting, "get_trainer_state"):
            if not state["warned"]:
                state["warned"] = True
                log.warning("checkpoint callback: model does not support "
                            "trainer-state capture (cv / loaded boosters "
                            "are not checkpointable); skipping")
            return
        if period <= 0 or (env.iteration + 1) % period != 0:
            return
        if _callback.manager is None:
            _callback.manager = CheckpointManager(directory, keep=keep,
                                                  config=model.config)
        _callback.manager.save(model, env.iteration + 1)
    _callback.order = 40
    _callback.ckpt_period = period
    _callback.manager = None
    return _callback
