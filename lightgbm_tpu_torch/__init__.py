"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Trains gradient-boosted trees (gbdt, goss, dart, rf; bagging and
feature_fraction) for every objective but ranking, multiclass included, on
dense numerical and categorical data through hand-written Hopper kernels
(``csrc/``) on a CUDA device, or through their plain PyTorch versions with
``device_type="cpu"``. ``device_type`` defaults to
``"cuda"``; without a CUDA device that is an error, never a fall-back.
The package imports torch and numpy only.

    import lightgbm_tpu_torch as lgb
    train = lgb.Dataset(X, label=y)
    booster = lgb.train({"objective": "binary"}, train, 100)
    booster.predict(X_test)
"""

from .basic import Dataset
from .booster import Booster
from .config import Config
from .convert import booster_from_numpy, mappers_from_numpy
from .engine import train

__all__ = ["Booster", "Config", "Dataset", "booster_from_numpy",
           "mappers_from_numpy", "train"]
