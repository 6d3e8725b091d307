"""scikit-learn estimator API.

Mirrors the reference's sklearn wrapper layer (reference:
python-package/lightgbm/sklearn.py:348-1014 — LGBMModel base plus
LGBMRegressor / LGBMClassifier / LGBMRanker): constructor params map to
booster params, ``fit`` drives ``engine.train`` with eval-set handling and
early stopping, objective/eval callables are adapted from sklearn signatures
to the (grad, hess) / (name, value, is_higher_better) protocol
(reference: sklearn.py:16-152 _ObjectiveFunctionWrapper/_EvalFunctionWrapper).

The port's copy of lightgbm_tpu's ``sklearn.py``. Where scikit-learn is
not importable, small stand-ins take the place of its base classes; the
``BaseEstimator`` stand-in reads the constructor's parameters as
scikit-learn's ``get_params`` does, so an estimator trains with the
parameters it was given either way.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Dataset
from .booster import Booster
from .engine import train as engine_train

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.preprocessing import LabelEncoder
    _SKLEARN = True
except ImportError:
    _SKLEARN = False

    class BaseEstimator:       # minimal stand-ins
        def get_params(self, deep: bool = True) -> Dict[str, Any]:
            import inspect
            sig = inspect.signature(type(self).__init__)
            return {name: getattr(self, name)
                    for name, p in sig.parameters.items()
                    if name != "self" and p.kind not in (
                        p.VAR_KEYWORD, p.VAR_POSITIONAL)}

    class ClassifierMixin:
        pass

    class RegressorMixin:
        pass


class _ObjectiveFunctionWrapper:
    """Adapt sklearn-style fobj(y_true, y_pred[, weight/group]) -> (grad, hess)
    to the engine protocol (reference: sklearn.py:16-89)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds: np.ndarray, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_weight())
        elif argc == 4:
            grad, hess = self.func(labels, preds, dataset.get_weight(),
                                   dataset.get_group())
        else:
            raise TypeError(f"Self-defined objective should have 2-4 arguments, "
                            f"got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """Adapt sklearn-style feval(y_true, y_pred[, weight/group]) ->
    (name, value, is_higher_better) (reference: sklearn.py:91-152)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds: np.ndarray, dataset: Dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        if argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        if argc == 4:
            return self.func(labels, preds, dataset.get_weight(),
                             dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2-4 "
                        f"arguments, got {argc}")


class LGBMModel(BaseEstimator):
    """Base sklearn estimator (reference: sklearn.py:348-817 LGBMModel)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state=None, n_jobs: int = -1,
                 silent: bool = True, importance_type: str = "split",
                 **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        for key, val in kwargs.items():
            setattr(self, key, val)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._best_score: Dict = {}
        self._objective = objective
        self._n_features = 0
        self._classes = None
        self._n_classes = -1

    # --------------------------------------------------------------- params
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = super().get_params(deep=deep)
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, f"_{key}"):
                setattr(self, f"_{key}", value)
            self._other_params[key] = value
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _booster_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        # sklearn names -> booster canonical names
        ren = {"boosting_type": "boosting", "min_split_gain": "min_gain_to_split",
               "min_child_weight": "min_sum_hessian_in_leaf",
               "min_child_samples": "min_data_in_leaf",
               "subsample": "bagging_fraction", "subsample_freq": "bagging_freq",
               "colsample_bytree": "feature_fraction",
               "reg_alpha": "lambda_l1", "reg_lambda": "lambda_l2",
               "subsample_for_bin": "bin_construct_sample_cnt",
               "random_state": "seed", "n_jobs": "num_threads"}
        out = {}
        for key, val in params.items():
            if val is None and key in ("objective", "random_state"):
                continue
            out[ren.get(key, key)] = val
        if out.get("seed") is None:
            out.pop("seed", None)
        num_threads = out.get("num_threads")
        if num_threads is not None and num_threads < 0:
            out["num_threads"] = 0
        if callable(out.get("objective")):
            out.pop("objective")
        elif not out.get("objective"):
            out["objective"] = self._default_objective()
        if self.silent:
            out.setdefault("verbosity", -1)
        return out

    # ------------------------------------------------------------------ fit
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None) -> "LGBMModel":
        params = self._booster_params()
        fobj = None
        if callable(self.objective):
            fobj = _ObjectiveFunctionWrapper(self.objective)
            params["objective"] = "none"
        feval = None
        if callable(eval_metric):
            feval = _EvalFunctionWrapper(eval_metric)
        elif eval_metric:
            params["metric"] = eval_metric if isinstance(eval_metric, list) \
                else [eval_metric]

        X_arr = X
        self._n_features = (X.shape[1] if hasattr(X, "shape")
                            else np.asarray(X).shape[1])
        train_set = Dataset(X_arr, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            free_raw_data=False)
        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    vw = eval_sample_weight[i] if eval_sample_weight else None
                    vg = eval_group[i] if eval_group else None
                    vi = eval_init_score[i] if eval_init_score else None
                    valid_sets.append(Dataset(
                        vx, label=self._prep_eval_label(vy), weight=vw,
                        group=vg, init_score=vi, reference=train_set,
                        params=params, free_raw_data=False))
                valid_names.append(eval_names[i] if eval_names
                                   and i < len(eval_names) else f"valid_{i}")

        self._evals_result = {}
        self._Booster = engine_train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=valid_names,
            fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result,
            verbose_eval=verbose, callbacks=callbacks, init_model=init_model)
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        return self

    def _prep_eval_label(self, y):
        return y

    # -------------------------------------------------------------- predict
    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, **kwargs)

    # ----------------------------------------------------------- properties
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        return self._best_score

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._Booster.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        if self._Booster is None:
            raise _not_fitted_error(self)
        return self._Booster.feature_name()

    @property
    def objective_(self):
        return self.objective or self._default_objective()


def _not_fitted_error(est):
    try:
        from sklearn.exceptions import NotFittedError
        return NotFittedError(f"This {type(est).__name__} instance is not "
                              f"fitted yet.")
    except ImportError:   # pragma: no cover
        return RuntimeError("Estimator not fitted")


class LGBMRegressor(LGBMModel, RegressorMixin):
    """reference: sklearn.py:818-843 LGBMRegressor."""

    def _default_objective(self) -> str:
        return "regression"

    def score(self, X, y, sample_weight=None):
        if _SKLEARN:
            from sklearn.metrics import r2_score
            return r2_score(y, self.predict(X), sample_weight=sample_weight)
        raise RuntimeError("scikit-learn is required for score()")


class LGBMClassifier(LGBMModel, ClassifierMixin):
    """reference: sklearn.py:844-964 LGBMClassifier."""

    def _default_objective(self) -> str:
        return "binary" if self._n_classes <= 2 else "multiclass"

    def fit(self, X, y, sample_weight=None, init_score=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None,
            eval_metric=None, early_stopping_rounds=None, verbose=False,
            feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None) -> "LGBMClassifier":
        self._le = LabelEncoder() if _SKLEARN else None
        if self._le is not None:
            y_enc = self._le.fit_transform(y)
            self._classes = self._le.classes_
        else:
            self._classes, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self._classes)

        params_extra = {}
        if self._n_classes > 2:
            params_extra["num_class"] = self._n_classes
        if self.class_weight is not None:
            # per-row weights from class weights (reference: sklearn.py uses
            # compute_sample_weight)
            if _SKLEARN:
                from sklearn.utils.class_weight import compute_sample_weight
                cw = compute_sample_weight(self.class_weight, y)
                sample_weight = cw if sample_weight is None else \
                    np.asarray(sample_weight) * cw
        self._other_params.update(params_extra)
        for key, val in params_extra.items():
            setattr(self, key, val)
        super().fit(X, y_enc, sample_weight=sample_weight,
                    init_score=init_score, eval_set=eval_set,
                    eval_names=eval_names,
                    eval_sample_weight=eval_sample_weight,
                    eval_init_score=eval_init_score, eval_metric=eval_metric,
                    early_stopping_rounds=early_stopping_rounds,
                    verbose=verbose, feature_name=feature_name,
                    categorical_feature=categorical_feature,
                    callbacks=callbacks, init_model=init_model)
        return self

    def _prep_eval_label(self, y):
        if self._le is not None:
            return self._le.transform(y)
        return np.searchsorted(self._classes, y)

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        result = self.predict_proba(X, raw_score=raw_score,
                                    start_iteration=start_iteration,
                                    num_iteration=num_iteration,
                                    pred_leaf=pred_leaf,
                                    pred_contrib=pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        idx = np.argmax(result, axis=1)
        return np.asarray(self._classes)[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      **kwargs):
        result = super().predict(X, raw_score=raw_score,
                                 start_iteration=start_iteration,
                                 num_iteration=num_iteration,
                                 pred_leaf=pred_leaf,
                                 pred_contrib=pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes <= 2 and result.ndim == 1:
            return np.stack([1.0 - result, result], axis=1)
        return result

    @property
    def classes_(self):
        if self._classes is None:
            raise _not_fitted_error(self)
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    """reference: sklearn.py:965-1014 LGBMRanker."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            eval_at=(1, 2, 3, 4, 5), early_stopping_rounds=None,
            verbose=False, feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None) -> "LGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is not None")
        self._other_params["eval_at"] = list(eval_at)
        self.eval_at = list(eval_at)
        super().fit(X, y, sample_weight=sample_weight, init_score=init_score,
                    group=group, eval_set=eval_set, eval_names=eval_names,
                    eval_sample_weight=eval_sample_weight,
                    eval_init_score=eval_init_score, eval_group=eval_group,
                    eval_metric=eval_metric,
                    early_stopping_rounds=early_stopping_rounds,
                    verbose=verbose, feature_name=feature_name,
                    categorical_feature=categorical_feature,
                    callbacks=callbacks, init_model=init_model)
        return self
