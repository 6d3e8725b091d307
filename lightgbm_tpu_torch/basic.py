"""Dataset: dense training/validation data on the device.

The port of lightgbm_tpu's ``basic.py`` ``Dataset`` for dense numpy input.
``construct()`` fits the bin mappers on the host (``binning.py``, the same
seeded row sample as the JAX package, so the mappers are bit-identical;
``categorical_feature`` columns get categorical mappers), keeps the
non-trivial features, and quantizes the matrix on the device into the
feature-major ``binsT [F, N]`` uint8 matrix the histogram kernels read.

A training set then moves every device column whose most frequent bin
holds >= 90% of its (>= 512) rows out of ``binsT`` into padded (row, bin)
streams of its non-default entries (``_maybe_extract_sparse``, the JAX
package's sparse device storage, on every device): ``binsT`` keeps the
dense columns, ``sp_cols``/``sp_rows``/``sp_bins``/``sp_default`` the rest.
A validation set built with ``reference=`` shares the training set's
mappers and stays dense. The metadata fields label, weight, group (query
sizes, for learning to rank) and init_score go with the rows
(``set_field``/``get_field``). The feature metadata carries the
parameters' ``monotone_constraints`` and ``feature_contri``, mapped from
original into used-feature space. Sparse input, pandas categoricals, EFB
bundles, streaming construction and a group column read from a file wait
for ROADMAP Queue 1 items 2, 9 and 12.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import binning
from .config import Config
from .ops.split import FeatureMeta, feature_meta_from_mappers, missing_bin_of
from .utils import log


def _to_2d_float(data) -> np.ndarray:
    """Dense float matrix; float32 stays float32 (it quantizes exactly on
    the device), everything else becomes float64."""
    if hasattr(data, "values"):
        data = data.values
    if not isinstance(data, np.ndarray) or data.dtype not in (np.float32,
                                                                np.float64):
        if hasattr(data, "toarray"):
            raise NotImplementedError(
                "sparse input is not ported to lightgbm_tpu_torch yet; it "
                "arrives with ROADMAP.md Queue 1 item 9")
        data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data.reshape(-1, 1)
    return data


class Dataset:
    """Training/validation data container (reference: basic.py Dataset)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group                  # query sizes (learning to rank)
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._constructed = False
        self.mappers: List[binning.BinMapper] = []
        self.used_features = np.zeros((0,), dtype=np.int32)
        self.binsT: Optional[torch.Tensor] = None     # [F_dense, N] device
        # sparse device storage (_maybe_extract_sparse); None = all dense
        self.sp_cols: Optional[np.ndarray] = None      # [F_sp] device column
        self.sp_rows: Optional[torch.Tensor] = None    # [F_sp, M] int32, pad N
        self.sp_bins: Optional[torch.Tensor] = None    # [F_sp, M] uint8
        self.sp_default: Optional[torch.Tensor] = None  # [F_sp] int32
        self.has_categorical = False
        self.num_data = 0
        self.num_total_features = 0
        self.device = None

    @classmethod
    def from_mappers(cls, mappers, used_features, feature_names=None,
                     params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """A data-free Dataset holding only bin mappers: the binning
        reference of a model carried across (``convert.py``)."""
        ds = cls(None, params=params)
        config = Config.from_params(ds.params)
        ds.device = config.torch_device()
        ds.mappers = list(mappers)
        ds.used_features = np.asarray(used_features, dtype=np.int32)
        ds.num_total_features = len(ds.mappers)
        ds._feature_names = (list(feature_names) if feature_names is not None
                             else [f"Column_{i}"
                                   for i in range(ds.num_total_features)])
        ds._build_feature_meta(config)
        ds._constructed = True
        return ds

    @property
    def has_sparse_cols(self) -> bool:
        return self.sp_cols is not None and len(self.sp_cols) > 0

    @property
    def bins(self) -> Optional[torch.Tensor]:
        """Row-major ``[N, F_used]`` view of the bin matrix."""
        return None if self.binsT is None else self.binsT.t()

    # ------------------------------------------------------------ fields
    def set_group(self, group) -> "Dataset":
        self.group = group
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        return self

    def set_field(self, name: str, data) -> "Dataset":
        if name not in ("label", "weight", "group", "init_score"):
            log.fatal(f"Unknown field: {name}")
        setattr(self, name, data)
        return self

    def get_field(self, name: str):
        return {"label": self.get_label(), "weight": self.get_weight(),
                "group": self.group, "init_score": self.init_score}[name]

    def get_label(self) -> Optional[np.ndarray]:
        return None if self.label is None else np.asarray(
            self.label, dtype=np.float64).reshape(-1)

    def get_weight(self) -> Optional[np.ndarray]:
        return None if self.weight is None else np.asarray(
            self.weight, dtype=np.float64).reshape(-1)

    def get_group(self) -> Optional[np.ndarray]:
        """Query sizes (int64), or None."""
        return None if self.group is None else np.asarray(
            self.group, dtype=np.int64).reshape(-1)

    def get_init_score(self) -> Optional[np.ndarray]:
        return None if self.init_score is None else np.asarray(
            self.init_score, dtype=np.float64)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this set's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params)

    def get_feature_names(self) -> List[str]:
        self.construct()
        return self._feature_names

    def construct(self) -> "Dataset":
        if self._constructed:
            return self
        config = Config.from_params(self.params)
        # a validation set lives where its reference does
        self.device = (self.reference.construct().device
                       if self.reference is not None
                       else config.torch_device())
        X = _to_2d_float(self.data)
        self.num_data, self.num_total_features = X.shape
        if self.feature_name in ("auto", None):
            self._feature_names = [f"Column_{i}"
                                   for i in range(self.num_total_features)]
        else:
            self._feature_names = list(self.feature_name)
        if self.reference is not None:
            ref = self.reference.construct()
            if self.num_total_features != ref.num_total_features:
                log.fatal("validation data has different number of features")
            self.mappers = ref.mappers
            self.used_features = ref.used_features
        else:
            cats = self._resolve_categorical(config)
            self.mappers = binning.find_bin_mappers(X, config, cats)
            self.used_features = np.array(
                [j for j, m in enumerate(self.mappers) if not m.is_trivial],
                dtype=np.int32)
            if len(self.used_features) == 0:
                log.warning("There are no meaningful features, as all feature "
                            "values are constant.")
        self._build_feature_meta(config)
        self.binsT = self._maybe_extract_sparse(self.bin_new_data(X), config)
        self._constructed = True
        if self.free_raw_data:
            self.data = None
        log.info(f"Number of data points in the train set: {self.num_data}, "
                 f"number of used features: {len(self.used_features)}")
        return self

    def _resolve_categorical(self, config: Config) -> List[int]:
        """Column indices of the categorical features: the Dataset's
        ``categorical_feature`` (indices or feature names), else the
        ``categorical_feature`` parameter; "auto" means none for numpy
        input (pandas categoricals are not ported)."""
        cf = self.categorical_feature
        if cf in ("auto", None, ""):
            cf = config.categorical_feature
        if cf in ("auto", None, ""):
            return []
        if isinstance(cf, (str, int)):
            cf = [c for c in str(cf).split(",") if c.strip()]
        out = []
        for c in cf:
            if isinstance(c, str) and not c.strip().lstrip("-").isdigit():
                if c in self._feature_names:
                    out.append(self._feature_names.index(c))
            else:
                out.append(int(c))
        return out

    def _maybe_extract_sparse(self, binsT: torch.Tensor,
                              config: Config) -> torch.Tensor:
        """Sparse device storage for heavily concentrated columns (the JAX
        package's ``Dataset._maybe_extract_sparse``, the analog of the
        reference's SparseBin with the most frequent bin elided and rebuilt
        by FixHistogram). A device column whose most frequent bin holds
        >= 90% of the rows (and N >= 512) leaves the dense matrix and is
        kept as its non-default (row, bin) entries in row order, padded to
        the longest stream with row N. Training sets only: validation sets
        (``reference=``) and dart and rf runs stay dense. Returns the dense
        columns' ``binsT``."""
        threshold, min_rows = 0.90, 512
        # dart (the dropped trees' scores) and rf re-traverse the train
        # bins over every column, which the streams no longer hold
        if (not config.is_enable_sparse or self.reference is not None
                or config.boosting in ("dart", "rf")):
            return binsT
        fc, n = binsT.shape
        if n < min_rows or fc == 0 or not len(self.used_features):
            return binsT
        sp, defaults, nnz = [], [], []
        for c in range(fc):
            cnt = torch.bincount(binsT[c].to(torch.int64))
            mode = int(torch.argmax(cnt))
            top = int(cnt[mode])
            if top >= threshold * n:
                sp.append(c)
                defaults.append(mode)
                nnz.append(n - top)
        if not sp:
            return binsT
        m = max(max(nnz), 1)
        dev = binsT.device
        rows = torch.full((len(sp), m), n, dtype=torch.int32, device=dev)
        vals = torch.zeros((len(sp), m), dtype=binsT.dtype, device=dev)
        for i, c in enumerate(sp):
            nz = torch.nonzero(binsT[c] != defaults[i]).reshape(-1)
            rows[i, :nz.shape[0]] = nz.to(torch.int32)
            vals[i, :nz.shape[0]] = binsT[c, nz]
        self.sp_cols = np.asarray(sp, dtype=np.int32)
        self.sp_rows, self.sp_bins = rows, vals
        self.sp_default = torch.as_tensor(np.asarray(defaults, np.int32),
                                          device=dev)
        dense = [c for c in range(fc) if c not in set(sp)]
        log.info(f"sparse storage: {len(sp)} of {fc} device columns (max {m} "
                 f"non-default entries; >= {threshold:.0%} concentrated)")
        return binsT[torch.as_tensor(dense, dtype=torch.long,
                                     device=dev)].contiguous()

    def _build_feature_meta(self, config: Config) -> None:
        used = [self.mappers[j] for j in self.used_features]
        self.max_num_bins = max((m.num_bin for m in used), default=2)
        if self.max_num_bins > 256:
            raise NotImplementedError(
                f"max_bin > 256 ({self.max_num_bins} bins) is not ported to "
                f"lightgbm_tpu_torch yet: the kernels take uint8 bins; it "
                f"arrives with ROADMAP.md Queue 2")
        # the monotone directions and feature_contri multipliers, from
        # original feature indices into used-feature space (reference:
        # feature_histogram.hpp:1170-1177 FeatureMetainfo init)
        f = max(len(used), 1)
        per_used = {}
        for key, dtype, fill in (("monotone_constraints", np.int8, 0),
                                 ("feature_contri", np.float32, 1)):
            vals = list(getattr(config, key) or [])
            if vals and len(vals) != self.num_total_features:
                log.fatal(f"{key} should be the same size as feature number "
                          f"({self.num_total_features}), got {len(vals)}")
            arr = np.full((f,), fill, dtype)
            for i, j in enumerate(self.used_features):
                if j < len(vals):
                    arr[i] = dtype(vals[j])
            per_used[key] = arr
        self.feature_meta: FeatureMeta = feature_meta_from_mappers(
            used, monotone=per_used["monotone_constraints"],
            penalty=per_used["feature_contri"])
        self.has_categorical = bool(self.feature_meta.is_categorical.any())
        self.missing_bin = torch.as_tensor(missing_bin_of(self.feature_meta))

    def bin_new_data(self, X) -> torch.Tensor:
        """Quantize raw rows with this dataset's mappers on its device ->
        binsT [F_used, N] uint8 (a zero column stands in for no features)."""
        X = _to_2d_float(X)
        if X.shape[1] != self.num_total_features:
            log.fatal(f"The number of features in data ({X.shape[1]}) is not "
                      f"the same as it was in training data "
                      f"({self.num_total_features}).")
        used = [self.mappers[j] for j in self.used_features]
        if not used:
            return torch.zeros((1, X.shape[0]), dtype=torch.uint8,
                               device=self.device)
        Xu = X if len(used) == X.shape[1] else X[:, self.used_features]
        return binning.bin_data_device(Xu, used, self.device)
