"""Training entry points: ``train()`` and ``cv()``.

The port of lightgbm_tpu's ``engine.py`` (reference:
python-package/lightgbm/engine.py:14-470): parameter munging, validation
sets (with their query groups and init scores), the callback protocol
(``before_iteration`` callbacks, the update, evaluation, the after
callbacks in ``order``), early stopping through ``EarlyStopException``,
``learning_rates`` as a ``reset_parameter`` schedule, custom objectives
(``fobj``, objective ``none``) and metrics (``feval``), continued training
from ``init_model``, and cross-validation with stratified, shuffled or
caller-given (group-aware) folds. The Booster takes the boosting type
``boosting`` names (``models/boosting.create_boosting``), and
``resume_from`` continues from the newest valid checkpoint of a
``callback.checkpoint`` directory bit-identically (``checkpoint.py``;
a pre-partitioned gang resumes from sharded checkpoints, at the world
size they were written at or another), with the fault hooks of
``utils/faults.py`` (kill and hang, rank-targeted or not) at every
iteration's start. Training runs under the distributed supervision of
``distributed.start_health`` (heartbeats and the collective watchdog, by
``heartbeat_interval`` and ``collective_deadline``), and a gang votes on
its model state's integrity every ``integrity_check_period`` iterations,
before the after-iteration callbacks, so no checkpoint is written from
state the gang has voted corrupt. The JAX package's K-block dispatch and
``compile_warmup`` wait for ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback as callback_mod
from .basic import Dataset
from .booster import Booster
from .callback import CallbackEnv, EarlyStopException
from .config import PARAM_ALIASES, Config
from .utils import log


def _resolve_num_boost_round(params: Dict[str, Any],
                             num_boost_round: int) -> int:
    for alias, canonical in PARAM_ALIASES.items():
        if canonical == "num_iterations" and alias in params:
            return int(params.pop(alias))
    return int(params.pop("num_iterations", num_boost_round))


def _load_init_model(init_model, params: Dict[str, Any], train_set: Dataset,
                     valid_sets: List[Dataset]):
    """The init model as a LoadedGBDT (a Booster's text, or a model file),
    its raw scores set as the train and valid sets' init scores
    (reference: engine.py:163-169). None without trees."""
    from .io.model_text import load_model
    if isinstance(init_model, Booster):
        loaded = load_model(init_model.model_to_string(),
                            Config.from_params(params))
    else:
        with open(init_model) as fh:
            loaded = load_model(fh.read(), Config.from_params(params))
    if loaded.num_trees == 0:
        return None
    if train_set.data is None:
        log.fatal("Cannot use init_model with a Dataset whose raw data was "
                  "freed")
    # pandas category columns must map through the init model's category
    # lists, or its trees' thresholds read other codes
    pc = {int(k): list(v) for k, v in
          (loaded.meta.get("pandas_categorical") or {}).items()}
    if pc:
        if train_set._constructed:
            if {int(k): list(v) for k, v in
                    train_set.pandas_categorical.items()} != pc:
                log.fatal("train and init_model pandas categorical columns "
                          "do not match: construct the training Dataset "
                          "from data with the same category lists")
        else:
            train_set.pandas_categorical = pc
    train_set.init_score = loaded.predict_raw(train_set.data)
    for vs in valid_sets:
        if vs is train_set:
            continue
        if vs.data is None:
            log.fatal("Cannot use init_model with a validation Dataset "
                      "whose raw data was freed")
        vs.init_score = loaded.predict_raw(vs.data)
    return loaded


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None,
          verbose_eval="warn", learning_rates=None,
          keep_training_booster: bool = False, callbacks=None,
          resume_from: Optional[str] = None) -> Booster:
    """Train a booster (reference: engine.py:14-278).

    ``fobj(score, train_set) -> (grad, hess)`` replaces the objective
    (which becomes ``none``); ``feval(score, dataset) -> (name, value,
    is_higher_better)`` (or a list of them) adds to the metrics;
    ``init_model`` (a Booster or a model file) continues its model, whose
    trees open the new one; ``evals_result`` records every evaluation
    (``record_evaluation``); ``early_stopping_rounds`` stops when no valid
    metric improved for that many rounds (``best_iteration``,
    ``best_score``); ``learning_rates`` (a list, or a callable iteration
    -> rate) sets the rate before each iteration; ``verbose_eval`` (True
    or a period) logs the evaluations. ``keep_training_booster`` changes
    nothing (the booster always stays trainable), as in the JAX package.

    ``resume_from``: a checkpoint directory written by the
    ``callback.checkpoint`` callback. Training restores the full trainer
    state (trees, score caches, generator and drop state, eval history,
    early-stopping counters) from the newest valid checkpoint and
    continues at the saved iteration, reproducing the uninterrupted run
    bit-identically; a directory with no valid checkpoint trains from
    scratch with a warning. Pass the same params, datasets and callbacks
    as the original run (a params or dataset mismatch is refused)."""
    params = copy.deepcopy(params)
    num_boost_round = _resolve_num_boost_round(params, num_boost_round)
    if fobj is not None:
        params["objective"] = "none"
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    first_metric_only = params.get("first_metric_only", False)
    valid_sets = valid_sets or []
    valid_names = valid_names or []

    loaded = None
    if init_model is not None:
        loaded = _load_init_model(init_model, params, train_set, valid_sets)
    if not train_set._constructed:
        from .utils import profiling
        merged = dict(train_set.params or {})
        merged.update(params)
        train_set.params = merged
        with profiling.timer("construct"):
            train_set.construct()
    booster = Booster(params=params, train_set=train_set)
    boosting = booster._boosting
    if loaded is not None:
        boosting.loaded = loaded
        boosting.loaded_iters = loaded.num_iteration
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            boosting.config.is_provide_training_metric = True
            continue
        if vs.reference is None:
            vs.reference = train_set
        booster.add_valid(vs, valid_names[i] if i < len(valid_names)
                          else f"valid_{i}")

    cbs = set(callbacks or [])
    if verbose_eval is True or (isinstance(verbose_eval, int)
                                and not isinstance(verbose_eval, bool)):
        cbs.add(callback_mod.print_evaluation(
            1 if verbose_eval is True else verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds,
                                            first_metric_only))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))
    if learning_rates is not None:
        cbs.add(callback_mod.reset_parameter(learning_rate=learning_rates))
    cbs_before = sorted((c for c in cbs
                         if getattr(c, "before_iteration", False)),
                        key=lambda c: getattr(c, "order", 0))
    cbs_after = sorted((c for c in cbs
                        if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))
    # the checkpoint callback captures the stateful callbacks' state
    # through the booster (checkpoint.capture_state)
    booster._callbacks = cbs_before + cbs_after

    start_iter = 0
    if resume_from is not None:
        from . import checkpoint as checkpoint_mod
        ckpt = checkpoint_mod.CheckpointManager(
            resume_from).load_latest_valid()
        if ckpt is None:
            log.warning(f"resume_from={resume_from!r}: no valid checkpoint "
                        f"found; training from scratch")
        else:
            cb_states = checkpoint_mod.restore_booster(booster, ckpt)
            start_iter = int(ckpt.state["boosting"]["iter"])
            for cb in booster._callbacks:
                key = getattr(cb, "ckpt_key", None)
                if key in cb_states and hasattr(cb, "set_state"):
                    cb.set_state(cb_states[key])
            log.info(f"resumed from checkpoint {ckpt.path} at iteration "
                     f"{start_iter}")

    from . import distributed, network
    from .utils import faults
    fault_plan = faults.plan_from(booster.config)
    # a dead or hung peer surfaces as the watchdog's diagnosis (or a
    # supervised restart), never an endless collective wait
    health = distributed.start_health(booster.config)
    integ_period = int(booster.config.integrity_check_period or 0)
    integ_on = integ_period > 0 and network.current().world > 1
    boosting = booster._boosting
    try:
        for i in range(start_iter, num_boost_round):
            faults.maybe_kill(fault_plan, i)
            faults.maybe_hang(fault_plan, i)
            for cb in cbs_before:
                cb(CallbackEnv(model=booster, params=params, iteration=i,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=None))
            booster.update(fobj=fobj)
            # the vote runs on every period boundary crossed, before the
            # after-iteration callbacks (the checkpoint among them)
            if integ_on and (i + 1) % integ_period == 0:
                distributed.check_model_integrity(boosting, i)
            evaluation_result_list = []
            if valid_sets or boosting.config.is_provide_training_metric:
                evaluation_result_list = booster.eval_set(feval)
            try:
                for cb in cbs_after:
                    cb(CallbackEnv(model=booster, params=params,
                                   iteration=i, begin_iteration=0,
                                   end_iteration=num_boost_round,
                                   evaluation_result_list=(
                                       evaluation_result_list)))
            except EarlyStopException as es:
                booster.best_iteration = es.best_iteration + 1
                for item in es.best_score:
                    booster.best_score.setdefault(item[0], {})[item[1]] = \
                        item[2]
                break
    except BaseException as e:
        # a dying run flushes its flight recorder (telemetry.py): the ring
        # and this reason are the post-mortem, on disk before the
        # exception unwinds (this booster's recorder, not the module's)
        boosting._flush_flight(
            f"train-error: {type(e).__name__}: {str(e)[:300]}")
        raise
    finally:
        health.stop()
    # clean end: flush only with a durable telemetry directory
    # (telemetry_dir, the supervisor's diagnosis directory,
    # checkpoint_path); an ordinary run leaves no post-mortem files
    fr = boosting._flight
    if fr is not None and fr.directory:
        fr.flush("train-end")
    return booster


class CVBooster:
    """The boosters of the folds (reference: engine.py:281-317): a method
    called on it is called on each and gives the list of their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int,
                  params: Dict[str, Any], seed: int, stratified: bool,
                  shuffle: bool):
    """(train indices, test indices) of each fold (reference:
    engine.py:319-376): the caller's ``folds`` (pairs, or an object with
    ``split``, which gets the query of each row as its groups), else
    stratified by label or plain, shuffled by ``RandomState(seed)``."""
    if not full_data._constructed and "device_type" not in full_data.params:
        # the one parameter of cv's that reaches the full set's
        # construct: the device every fold lives on
        dev = Config.from_params(params).device_type
        full_data.params = dict(full_data.params, device_type=dev)
    full_data.construct()
    num_data = full_data.num_data
    if folds is not None:
        if not hasattr(folds, "__iter__") and hasattr(folds, "split"):
            group = full_data.get_group()
            if group is not None:
                group_idx = np.repeat(np.arange(len(group)), group)
                folds = folds.split(X=np.empty(num_data), groups=group_idx)
            else:
                folds = folds.split(X=np.empty(num_data))
        return list(folds)
    rng = np.random.RandomState(seed)
    idx = np.arange(num_data)
    assignment = np.zeros(num_data, dtype=np.int64)
    if stratified:
        label = full_data.get_label()
        for lv in np.unique(label):
            sel = idx[label == lv]
            if shuffle:
                rng.shuffle(sel)
            assignment[sel] = np.arange(len(sel)) % nfold
    else:
        if shuffle:
            rng.shuffle(idx)
        assignment[idx] = np.arange(num_data) % nfold
    return [(np.nonzero(assignment != f)[0], np.nonzero(assignment == f)[0])
            for f in range(nfold)]


def _agg_cv_result(raw_results):
    """Mean and standard deviation of each metric over the folds
    (reference: engine.py:378-390)."""
    cvmap: Dict[str, List[float]] = {}
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = f"{one_line[0]} {one_line[1]}"
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True, metrics=None,
       fobj=None, feval=None, init_model=None, feature_name="auto",
       categorical_feature="auto", early_stopping_rounds=None,
       fpreproc=None, verbose_eval=None, show_stdv: bool = True,
       seed: int = 0, callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """Cross-validation (reference: engine.py:392-470): one booster a fold,
    trained on ``Dataset.subset`` of its rows (the full set must keep its
    raw data: ``free_raw_data=False``) and evaluated on the rest,
    iteration by iteration; ``{"<set> <metric>-mean": [...],
    "<set> <metric>-stdv": [...]}``, cut at the best iteration by early
    stopping, with ``"cvbooster"`` (a CVBooster) when
    ``return_cvbooster``. ``fpreproc(train, test, params)`` may change
    each fold's sets and parameters. Stratified folds need a binary or
    multiclass objective. As in the JAX package, only the after-iteration
    callbacks run, and ``init_model``, ``feature_name`` and
    ``categorical_feature`` are accepted and not used."""
    params = copy.deepcopy(params)
    num_boost_round = _resolve_num_boost_round(params, num_boost_round)
    if fobj is not None:
        params["objective"] = "none"
    if metrics is not None:
        params["metric"] = metrics
    objective = str(params.get("objective", ""))
    if not (objective == "binary" or objective.startswith("multiclass")):
        stratified = False

    folds = _make_n_folds(train_set, folds, nfold, params, seed, stratified,
                          shuffle)
    fold_data = []
    for train_idx, test_idx in folds:
        tr = train_set.subset(train_idx)
        te = train_set.subset(test_idx)
        if fpreproc is not None:
            tr, te, params = fpreproc(tr, te, params.copy())
        fold_data.append((tr, te))
    cvbooster = CVBooster()
    for tr, te in fold_data:
        b = Booster(params=params, train_set=tr)
        b.add_valid(te, "valid")
        cvbooster._append(b)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds,
                                            verbose=False))
    if verbose_eval:
        cbs.add(callback_mod.print_evaluation(
            1 if verbose_eval is True else int(verbose_eval), show_stdv))
    cbs_after = sorted((c for c in cbs
                        if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))

    results: Dict[str, List[float]] = {}
    for i in range(num_boost_round):
        raw = []
        for b in cvbooster.boosters:
            b.update(fobj=fobj)
            raw.append(b.eval_set(feval) if eval_train_metric
                       else b.eval_valid(feval))
        agg = _agg_cv_result(raw)
        for _, key, mean, _, std in agg:
            results.setdefault(f"{key}-mean", []).append(mean)
            results.setdefault(f"{key}-stdv", []).append(std)
        try:
            for cb in cbs_after:
                cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=agg))
        except EarlyStopException as es:
            cvbooster.best_iteration = es.best_iteration + 1
            for k in list(results):
                results[k] = results[k][:cvbooster.best_iteration]
            break
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return results
