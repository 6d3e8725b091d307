"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Trains gradient-boosted trees (gbdt, goss, dart, rf; bagging and
feature_fraction) for every objective, ranking and multiclass included, or
for a custom one (``fobj``), on dense, sparse and categorical data through
hand-written Hopper kernels (``csrc/``) on a CUDA device, or through their
plain PyTorch versions with ``device_type="cpu"``. ``device_type``
defaults to ``"cuda"``; without a CUDA device that is an error, never a
fall-back. Training control is the JAX package's: callbacks, early
stopping, ``learning_rates``, custom metrics (``feval``), continued
training (``init_model``) and ``cv``. Prediction runs on the card
through a hand-written ensemble-traversal kernel (raw, converted,
``pred_leaf``, ``pred_contrib``, ``pred_early_stop``), beside the
scikit-learn estimators, the plotting helpers and the CLI (``python -m
lightgbm_tpu_torch``). ``tree_learner`` data, feature or voting trains
over a gang of processes (``distributed``: ``init``, ``spawn``,
``train_distributed``, ``load_partitioned``; or torchrun), and
``supervisor`` keeps a gang alive: heartbeats and a collective watchdog,
relaunches from sharded checkpoints at the same or a smaller world size,
and a cross-rank integrity vote, each failure classified by the
post-mortem analyzer (``postmortem``). ``ServeFrontend`` puts a model
behind traffic: micro-batching, deadlines, load shedding, validated hot
swap and a metrics endpoint, over the engine's serve mode; ``telemetry``
holds the flight recorder, the snapshot and its Prometheus form, and
trace capture. The package
imports torch and numpy only; scikit-learn, matplotlib and graphviz are
imported when their names are first used.

    import lightgbm_tpu_torch as lgb
    train = lgb.Dataset(X, label=y)
    booster = lgb.train({"objective": "binary"}, train, 100)
    booster.predict(X_test)
"""

from . import distributed, supervisor
from .basic import Dataset
from .booster import Booster
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       print_evaluation, record_evaluation, reset_parameter)
from .callback import checkpoint as checkpoint_callback
from .config import Config
from .convert import booster_from_numpy, booster_to_numpy, mappers_from_numpy
from .engine import CVBooster, cv, train
from .serving import (ServeFrontend, ServeOverloadError, ServeSwapError,
                      ServeTimeoutError)

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "EarlyStopException",
           "ServeFrontend", "ServeOverloadError", "ServeSwapError",
           "ServeTimeoutError", "distributed", "supervisor",
           "booster_from_numpy", "booster_to_numpy", "checkpoint_callback",
           "cv",
           "early_stopping", "log_evaluation", "mappers_from_numpy",
           "print_evaluation", "record_evaluation", "reset_parameter",
           "train"]


def __getattr__(name):
    # the scikit-learn estimators and the plotting helpers, imported on
    # first use (python-package/lightgbm/__init__.py exports them too)
    if name in ("LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"):
        from . import sklearn as _sk
        return getattr(_sk, name)
    if name in ("plot_importance", "plot_metric", "plot_tree",
                "plot_split_value_histogram", "create_tree_digraph"):
        from . import plotting as _pl
        return getattr(_pl, name)
    raise AttributeError(
        f"module 'lightgbm_tpu_torch' has no attribute {name!r}")
