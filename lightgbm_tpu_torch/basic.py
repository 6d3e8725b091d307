"""Dataset: training/validation data on the device.

The port of lightgbm_tpu's ``basic.py`` ``Dataset``. ``construct()`` fits
the bin mappers on the host (``binning.py``, the same seeded row sample as
the JAX package, so the mappers are bit-identical; ``categorical_feature``
columns and pandas ``category`` columns get categorical mappers, the
``forcedbins_filename`` bounds and ``max_bin_by_feature`` apply per
column), keeps the non-trivial features, and quantizes the matrix into the
feature-major ``binsT [G, N]`` matrix the histogram kernels read: uint8
while every device column has at most 256 bins, else int16 up to 32,768
bins (the kernels' wide mode; the JAX package holds such bins as int32,
but 16 bits hold every bin below 32,768, read the same signed or
unsigned), else int32 up to the cap of 65,536 bins.

Two construct paths, as in the JAX package:

- dense input (numpy, pandas): one device column per used feature,
  quantized on the device;
- scipy-sparse input (CSR, CSC, COO) and validation sets of a bundled
  reference: ``_construct_sparse`` never densifies the raw matrix. The
  mappers are fitted from the sampled rows' nonzeros, Exclusive Feature
  Bundling (``bundling.py``, ``enable_bundle``) packs mutually exclusive
  sparse features into shared uint8 device columns, and the bundled split
  search reads the per-(column, bin) segment tables of ``bundle_meta``
  (``ops/split.py`` ``BundleMeta``).

A training set then moves every device column whose most frequent bin
holds >= 90% of its (>= 512) rows out of ``binsT`` into padded (row, bin)
streams of its non-default entries (``_maybe_extract_sparse``, the JAX
package's sparse device storage): ``binsT`` keeps the dense columns,
``sp_cols``/``sp_rows``/``sp_bins``/``sp_default`` the rest. A validation
set built with ``reference=`` shares the training set's mappers, bundles
and pandas category lists and stays dense. The metadata fields label,
weight, group (query sizes, for learning to rank) and init_score go with
the rows. The feature metadata carries ``monotone_constraints`` and
``feature_contri``, mapped from original into device-column space. A
dense construct keeps the raw features as float32 (``raw_data_np``) when
``linear_tree`` is in its params or its reference keeps them, for linear
leaves; sparse input with ``linear_tree`` raises. ``subset`` re-bins a
row subset with the set's mappers (``cv``'s folds; the raw data must be
kept, ``free_raw_data=False``). A group column of a data file is read by
the CLI's loader (``cli.py``).

The streaming construct (``Dataset.from_chunks``, or ``construct_streaming``
on array input) never holds the raw matrix: a sketch pass over the chunks
fits the mappers, a bin pass quantizes each chunk on the device into its
slot of ``binsT`` (``_construct_streaming``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import binning
from .config import Config
from .ops.cuda_hist import check_bins_cap
from .ops.split import (BundleMeta, FeatureMeta, feature_meta_from_mappers,
                        missing_bin_of)
from .utils import log


def _is_scipy_sparse(data) -> bool:
    """scipy CSR/CSC/COO, handled without densifying (the reference's
    sparse-input path, c_api.h LGBM_DatasetCreateFromCSR/CSC)."""
    return (hasattr(data, "tocsc") and hasattr(data, "nnz")
            and not hasattr(data, "values"))


def _to_2d_float(data) -> np.ndarray:
    """Dense float matrix; float32 stays float32 (it quantizes exactly on
    the device), everything else becomes float64. scipy-sparse input takes
    ``_construct_sparse`` and never comes here."""
    if hasattr(data, "values"):
        data = data.values
    if not isinstance(data, np.ndarray) or data.dtype not in (np.float32,
                                                                np.float64):
        if hasattr(data, "toarray"):
            raise NotImplementedError(
                "sparse input other than a scipy CSR/CSC/COO matrix is not "
                "supported by lightgbm_tpu_torch")
        data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data.reshape(-1, 1)
    return data


def _load_forced_bins(config: Config, num_features: int,
                      categorical: Sequence[int]) -> Dict[int, List[float]]:
    """Forced bin upper bounds from JSON (reference:
    DatasetLoader::GetForcedBins, dataset_loader.cpp:1373-1408; format
    [{"feature": i, "bin_upper_bound": [...]}, ...])."""
    if not config.forcedbins_filename:
        return {}
    try:
        with open(config.forcedbins_filename) as fh:
            arr = json.load(fh)
    except OSError:
        log.warning(f"Could not open {config.forcedbins_filename}. "
                    f"Will ignore.")
        return {}
    cats = set(int(c) for c in categorical)
    out: Dict[int, List[float]] = {}
    for entry in arr:
        j = int(entry["feature"])
        if j >= num_features:
            log.fatal(f"forced bins feature index {j} out of range")
        if j in cats:
            log.warning(f"Feature {j} is categorical. Will ignore forced "
                        f"bins for this feature.")
            continue
        deduped: List[float] = []
        for v in (float(v) for v in entry["bin_upper_bound"]):
            if not deduped or v != deduped[-1]:   # consecutive duplicates
                deduped.append(v)
        out[j] = deduped
    return out


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
        # per-column category lists of pandas category columns: raw values
        # map to these codes at train and at predict time
        self.pandas_categorical: Dict[int, list] = {}
        # EFB bundles (bundling.py): None = one device column a used
        # feature (every dense construct)
        self.bundles = None
        self._bundle_meta: Optional[BundleMeta] = None
        self.has_categorical = False
        self.num_data = 0
        self.num_total_features = 0
        self.device = None
        # pre-partitioned (distributed.load_partitioned): num_data is the
        # gang's rows, num_local_data this rank's, the first at
        # local_row_start
        self.is_pre_partitioned = False
        self.num_local_data = 0
        self.local_row_start = 0
        # the raw features as float32, kept for linear leaves (reference:
        # dataset.h:720 raw_data_), else None
        self.raw_data_np: Optional[np.ndarray] = None
        # the streaming construct (from_chunks): the chunk source, and the
        # construct's own numbers (sketch_pass, bin_pass, h2d_overlap
        # seconds, peak_host_bytes, rows), which the flight recorder's
        # header reads
        self._chunk_source = None
        self.construct_stats: Optional[Dict[str, Any]] = None

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

    @classmethod
    def from_chunks(cls, chunks, label=None,
                    reference: Optional["Dataset"] = None, weight=None,
                    group=None, init_score=None, feature_name="auto",
                    categorical_feature="auto",
                    params: Optional[Dict[str, Any]] = None,
                    free_raw_data: bool = True) -> "Dataset":
        """A Dataset over a chunk stream instead of one matrix: the raw
        feature matrix never exists in one piece. Construction makes two
        passes over the source (``_construct_streaming``): a sketch pass
        that fits the bin mappers, then a bin pass that quantizes each
        chunk on the device into its slot of ``binsT``, its upload
        overlapping the parse of the next chunk.

        ``chunks`` is a callable returning a fresh iterator of chunks, a
        sequence of chunks, or a 2-D array (sliced into
        ``construct_chunk_rows`` views). A chunk is ``[rows, F]`` or an
        ``(X, y)`` pair whose labels concatenate into the label (pass
        ``label=`` or chunk labels, not both). A pre-partitioned gang
        loads with ``distributed.load_partitioned_chunks`` instead."""
        ds = cls(None, label=label, reference=reference, weight=weight,
                 group=group, init_score=init_score,
                 feature_name=feature_name,
                 categorical_feature=categorical_feature, params=params,
                 free_raw_data=free_raw_data)
        ds._chunk_source = chunks
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

    def subset(self, used_indices: Sequence[int], params=None) -> "Dataset":
        """The rows ``used_indices``, binned with this set's mappers
        (reference: basic.py Dataset.subset / CopySubrow, dataset.h:416),
        with their labels and weights; the raw rows are needed (a
        scipy-sparse matrix's rows are densified, as in the JAX
        package)."""
        if self.data is None:
            log.fatal("Cannot subset a Dataset whose raw data was freed")
        idx = np.asarray(used_indices)
        if hasattr(self.data, "iloc"):
            data = self.data.iloc[idx]
        elif _is_scipy_sparse(self.data):
            data = np.asarray(self.data.tocsr()[idx].toarray(), np.float64)
        else:
            data = _to_2d_float(self.data)[idx]
        lbl = self.get_label()
        w = self.get_weight()
        return Dataset(data, label=None if lbl is None else lbl[idx],
                       reference=self,
                       weight=None if w is None else w[idx],
                       params=params or self.params)

    def save_binary(self, filename: str) -> "Dataset":
        """Serialize to the .bin snapshot format the CLI's save_binary task
        writes (reference: Dataset.save_binary -> SaveBinaryFile; the CLI
        loads it with data=<file>.bin)."""
        if self.data is None:
            log.fatal("save_binary needs the raw data (free_raw_data=False)")
        if _is_scipy_sparse(self.data):
            # the .bin format stores dense float arrays, loaded without
            # pickles
            log.fatal("save_binary does not support scipy-sparse data")
        if self.label is None:
            log.fatal("save_binary needs a label")
        from .cli import _save_binary
        X = _to_2d_float(self._pandas_to_codes(self.data))
        _save_binary(filename, X, self.get_label(), self.get_weight(),
                     self.get_group(), self.get_init_score())
        return self

    def get_feature_names(self) -> List[str]:
        self.construct()
        return self._feature_names

    def construct(self, streaming: Optional[bool] = None) -> "Dataset":
        """Bin the data on the device. A chunk source always streams;
        ``streaming`` (default: the ``construct_streaming`` parameter)
        streams array input too, in ``construct_chunk_rows`` slices."""
        if self._constructed:
            return self
        config = Config.from_params(self.params)
        # a validation set lives where its reference does
        ref = (self.reference.construct() if self.reference is not None
               else None)
        self.device = ref.device if ref is not None \
            else config.torch_device()
        if self._chunk_source is not None or (
                streaming if streaming is not None
                else config.construct_streaming):
            return self._construct_streaming(config, ref)
        if _is_scipy_sparse(self.data) or (ref is not None
                                           and ref.bundles is not None):
            return self._construct_sparse(config)
        if ref is not None:
            self.pandas_categorical = ref.pandas_categorical
        raw = self._pandas_to_codes(self.data)
        X = _to_2d_float(raw)
        self.num_data, self.num_total_features = X.shape
        self._set_feature_names()
        if ref is not None:
            if self.num_total_features != ref.num_total_features:
                log.fatal("validation data has different number of features")
            self.mappers = ref.mappers
            self.used_features = ref.used_features
        else:
            cats = self._resolve_categorical(config)
            forced = _load_forced_bins(config, self.num_total_features, cats)
            self.mappers = binning.find_bin_mappers(X, config, cats,
                                                    forced_bounds=forced)
            self.used_features = np.array(
                [j for j, m in enumerate(self.mappers) if not m.is_trivial],
                dtype=np.int32)
            if len(self.used_features) == 0:
                log.warning("There are no meaningful features, as all feature "
                            "values are constant.")
        self._build_feature_meta(config)
        self.binsT = self._maybe_extract_sparse(self.bin_new_data(X), config)
        # raw features for linear trees: kept with linear_tree, or when the
        # reference keeps them (a valid set's linear scores read them)
        keep_raw = config.linear_tree or (ref is not None
                                          and ref.raw_data_np is not None)
        self.raw_data_np = X.astype(np.float32) if keep_raw else None
        self._finish_construct()
        return self

    def _construct_streaming(self, config: Config, ref) -> "Dataset":
        """Two-pass construct with O(chunk) host memory: the raw matrix
        never exists in one piece.

        Pass 1 (scope ``sketch_pass``) folds each chunk into per-feature
        ``binning.FeatureSketch`` es and fits the mappers from them: the
        sampled ``find_bin_mappers``' mappers whenever the sample is every
        row (the sketches stay exact). A valid set aligned to ``ref``
        takes its mappers and makes the light pass (rows, sizes, labels).
        Pass 2 (``bin_pass``) quantizes each chunk on the device into its
        slot of ``binsT`` (``binning.StreamingBinWriter``, one write in
        flight, the upload of chunk k overlapping the parse of chunk k+1);
        the wait for the last write is the ``h2d_overlap`` scope. No EFB
        and no sparse columns (dense chunks, as the dense monolithic
        construct); ``linear_tree``, scipy-sparse and pandas input, and an
        EFB-bundled reference are refused.

        The gauges ``construct_sketch_s``, ``construct_bin_s``,
        ``construct_h2d_overlap_s``, ``construct_peak_bytes`` (the most raw
        bytes resident: a chunk and the staged copy) and ``construct_rows``
        describe the process's last streaming construct
        (``telemetry.construct_snapshot``); ``construct_stats`` keeps this
        dataset's, so a later construct changes neither."""
        import time
        from .utils import profiling
        if config.linear_tree:
            log.fatal("linear_tree keeps the raw matrix resident and is not "
                      "supported with streaming construction")
        source = (self._chunk_source if self._chunk_source is not None
                  else self.data)
        if _is_scipy_sparse(source) or hasattr(source, "dtypes"):
            log.fatal("streaming construction supports dense arrays or chunk "
                      "sources only (scipy-sparse and pandas input take the "
                      "monolithic paths)")
        profiling.drop_gauges("construct_")
        factory = binning.chunk_factory(source, config.construct_chunk_rows)
        peak = [0]

        def track(nbytes):
            peak[0] = max(peak[0], int(nbytes))

        t0 = time.time()
        with profiling.timer("sketch_pass"):
            sketches, num_data, sizes, chunk_labels = binning.sketch_chunks(
                factory, max_size=config.sketch_max_size, track_bytes=track,
                fold=ref is None)
        sketch_s = time.time() - t0
        self.num_data, self.num_total_features = num_data, len(sketches)
        if chunk_labels is not None:
            if self.label is not None:
                log.fatal("labels were passed both to the Dataset and in the "
                          "chunk stream; pass one or the other")
            self.label = chunk_labels
        self._set_feature_names()
        self.bundles = None
        if ref is not None:
            if ref.bundles is not None:
                log.fatal("streaming construction cannot align to an "
                          "EFB-bundled reference dataset")
            if self.num_total_features != ref.num_total_features:
                log.fatal("validation data has different number of features")
            self.mappers = ref.mappers
            self.used_features = ref.used_features
            self.pandas_categorical = ref.pandas_categorical
        else:
            cats = self._resolve_categorical(config)
            forced = _load_forced_bins(config, self.num_total_features, cats)
            self.mappers = binning.fit_mappers_from_sketches(
                sketches, num_data, config, cats, forced_bounds=forced)
            self.used_features = np.array(
                [j for j, m in enumerate(self.mappers) if not m.is_trivial],
                dtype=np.int32)
            if len(self.used_features) == 0:
                log.warning("There are no meaningful features, as all feature "
                            "values are constant.")
        sketches = None
        self._build_feature_meta(config)

        uf = self.used_features
        writer = binning.StreamingBinWriter(
            [self.mappers[j] for j in uf], num_data, max(sizes, default=1),
            self.device)
        t0 = time.time()
        with profiling.timer("bin_pass"):
            binning.bin_chunks_host(factory, uf, writer, track)
            t1 = time.time()
            with profiling.timer("h2d_overlap"):
                self.binsT = writer.finalize()
            overlap_s = time.time() - t1
        bin_s = time.time() - t0

        profiling.set_gauge("construct_sketch_s", sketch_s)
        profiling.set_gauge("construct_bin_s", bin_s)
        profiling.set_gauge("construct_h2d_overlap_s", overlap_s)
        profiling.set_gauge("construct_peak_bytes", float(peak[0]))
        profiling.set_gauge("construct_rows", float(num_data))
        self.construct_stats = {
            "sketch_pass": round(sketch_s, 6),
            "bin_pass": round(bin_s, 6),
            "h2d_overlap": round(overlap_s, 6),
            "peak_host_bytes": int(peak[0]),
            "rows": int(num_data),
        }
        # nothing of a monolithic raw matrix survives a streaming construct
        self.sp_cols = self.sp_rows = self.sp_bins = self.sp_default = None
        self.raw_data_np = None
        if self.free_raw_data:
            self._chunk_source = None
        log.info(f"streaming construct: {len(sizes)} chunks, peak raw "
                 f"{peak[0]} bytes, sketch {sketch_s:.2f}s + bin "
                 f"{bin_s:.2f}s, drain {overlap_s:.2f}s")
        self._finish_construct()
        return self

    def _set_feature_names(self) -> None:
        if self.feature_name in ("auto", None):
            if hasattr(self.data, "columns"):
                self._feature_names = [str(c) for c in self.data.columns]
            else:
                self._feature_names = [f"Column_{i}" for i in
                                       range(self.num_total_features)]
        else:
            self._feature_names = list(self.feature_name)

    def _finish_construct(self) -> None:
        self._constructed = True
        if self.free_raw_data:
            self.data = None
        g = self.num_used_features()
        log.info(f"Number of data points in the train set: {self.num_data}, "
                 f"number of used features: {len(self.used_features)}"
                 + (f" (bundled into {g} columns)"
                    if self.bundles is not None
                    and g != len(self.used_features) else ""))

    def _pandas_to_codes(self, raw):
        """pandas ``category`` columns as float codes through the captured
        (train) or reused (reference, predict) category lists, so train and
        predict agree (reference: basic.py:504-568 pandas_categorical); an
        unseen category reads NaN. pandas is imported here only, for a
        DataFrame."""
        if not hasattr(raw, "dtypes"):
            return raw
        import pandas as pd
        raw = raw.copy()
        for ci, col in enumerate(raw.columns):
            if str(raw[col].dtype) != "category":
                continue
            if ci in self.pandas_categorical:
                codes = pd.Categorical(
                    raw[col], categories=self.pandas_categorical[ci]).codes
            else:
                self.pandas_categorical[ci] = list(raw[col].cat.categories)
                codes = raw[col].cat.codes
            raw[col] = np.where(np.asarray(codes) >= 0,
                                np.asarray(codes, dtype=np.float64), np.nan)
        return raw

    def _resolve_categorical(self, config: Config) -> List[int]:
        """Column indices of the categorical features: the Dataset's
        ``categorical_feature`` (indices or feature names), else the
        ``categorical_feature`` parameter; "auto" means a DataFrame's
        ``category`` columns, and none for other input."""
        cf = self.categorical_feature
        if cf in ("auto", None, ""):
            cf = config.categorical_feature
        if cf in ("auto", None, ""):
            if hasattr(self.data, "dtypes"):
                return [i for i, dt in enumerate(self.data.dtypes)
                        if str(dt) == "category"]
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
                or config.boosting in ("dart", "rf")
                # the distributed learners shard dense columns
                or str(config.tree_learner or "serial") != "serial"):
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
        check_bins_cap(self.max_num_bins)
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

    def bin_new_data(self, X, device=None) -> torch.Tensor:
        """Quantize raw rows with this dataset's mappers (and bundles) on
        its device, or on ``device`` (a sharded predict's shard) -> binsT
        [G, N] (uint8, or int16 / int32 in the wide mode; a zero column
        stands in for no features). scipy-sparse rows are binned column by
        column without densifying."""
        X = self._new_rows(X)
        device = self.device if device is None else device
        if self.bundles is not None:
            return self._bin_columns(X).to(device)
        if _is_scipy_sparse(X):
            return self._bin_columns_unbundled(X).to(device)
        if not len(self.used_features):
            return torch.zeros((1, X.shape[0]), dtype=torch.uint8,
                               device=device)
        return binning.bin_data_device(*self._used_columns(X), device)

    def serve_rows(self, X):
        """The serve mode's input (``models/predict_engine.py``): the dense
        raw rows of the used features and their mappers, as
        ``bin_new_data`` would bin them, or None where it bins otherwise
        (EFB bundles, scipy-sparse rows, no used features)."""
        if self.bundles is not None or _is_scipy_sparse(X) \
                or not len(self.used_features):
            return None
        return self._used_columns(self._new_rows(X))

    def _new_rows(self, X):
        """New raw rows as ``bin_new_data`` takes them: dense float (or
        scipy-sparse), their feature count checked."""
        if not _is_scipy_sparse(X):
            X = _to_2d_float(self._pandas_to_codes(X))
        if X.shape[1] != self.num_total_features:
            log.fatal(f"The number of features in data ({X.shape[1]}) is not "
                      f"the same as it was in training data "
                      f"({self.num_total_features}).")
        return X

    def _used_columns(self, X):
        """The used features' columns of dense rows, and their mappers."""
        used = [self.mappers[j] for j in self.used_features]
        return (X if len(used) == X.shape[1]
                else X[:, self.used_features]), used

    # ------------------------------------------------- sparse + EFB path
    def _construct_sparse(self, config: Config) -> "Dataset":
        """Construct from scipy-sparse input, or align a validation set to
        a bundled reference, without densifying the raw matrix (reference:
        sparse_bin.hpp storage + dataset.cpp:239 FastFeatureBundling: the
        sparse features bundle into shared dense device columns, a
        ``[G, N]`` bin matrix with G ~ bundles, not features)."""
        if config.linear_tree:
            log.fatal("linear_tree is not supported with sparse input")
        sparse = _is_scipy_sparse(self.data)
        X = (self.data.tocsc() if sparse
             else _to_2d_float(self._pandas_to_codes(self.data)))
        self.num_data, self.num_total_features = X.shape
        self._set_feature_names()
        if self.reference is not None:
            ref = self.reference.construct()
            if self.num_total_features != ref.num_total_features:
                log.fatal("validation data has different number of features")
            for attr in ("mappers", "used_features", "feature_meta",
                         "missing_bin", "max_num_bins", "has_categorical",
                         "bundles", "_bundle_meta", "_owner_orig",
                         "_thr_fwd", "_thr_rev", "pandas_categorical"):
                setattr(self, attr, getattr(ref, attr, None))
        else:
            cats = self._resolve_categorical(config)
            sample = binning.sample_indices(
                self.num_data, config.bin_construct_sample_cnt,
                config.data_random_seed)
            Xs = self.data.tocsr()[sample].tocsc() if sparse else X[sample]
            forced = _load_forced_bins(config, self.num_total_features, cats)
            self.mappers = self._fit_mappers_from_sample(
                Xs, len(sample), config, cats, forced)
            self.used_features = np.array(
                [j for j, m in enumerate(self.mappers) if not m.is_trivial],
                dtype=np.int32)
            if len(self.used_features) == 0:
                log.warning("There are no meaningful features, as all feature"
                            " values are constant.")
            self._run_bundling(Xs, len(sample), config)
            self._build_feature_meta_bundled(config)
        binsT = (self._bin_columns_unbundled(X) if self.bundles is None
                 else self._bin_columns(X))
        self.binsT = self._maybe_extract_sparse(binsT, config)
        self._finish_construct()
        return self

    def _fit_mappers_from_sample(self, Xs, total, config, cats,
                                 forced_bounds=None):
        """Per-feature BinMapper from a row sample; for CSC input only the
        nonzeros are touched (the zeros implied by the count, the
        reference's sparse sampling protocol, dataset_loader.cpp:953+)."""
        sparse = _is_scipy_sparse(Xs)
        filter_cnt = binning.filter_cnt_for_sample(config, total,
                                                   self.num_data)
        cat_set = set(int(c) for c in cats)
        mappers = []
        for j in range(self.num_total_features):
            if sparse:
                vals = np.asarray(
                    Xs.data[Xs.indptr[j]:Xs.indptr[j + 1]], dtype=np.float64)
            else:
                col = np.asarray(Xs[:, j], dtype=np.float64)
                vals = col[col != 0.0]
            mappers.append(binning.fit_mapper_for_column(
                j, vals, total, config, cat_set, filter_cnt, forced_bounds))
        return mappers

    def _run_bundling(self, Xs, total, config) -> None:
        """Greedy EFB over the bundle-eligible used features (reference:
        dataset.cpp:239 FastFeatureBundling): numerical, no NaN bin, the
        most frequent bin the zero bin, unconstrained, contri 1."""
        from .bundling import fast_feature_bundling
        mc = list(config.monotone_constraints or [])
        fc = list(config.feature_contri or [])
        sparse = _is_scipy_sparse(Xs)
        num_bins, nonzero_rows = [], []
        bundle_ok = np.zeros(len(self.used_features), dtype=bool)
        for i, j in enumerate(self.used_features):
            m = self.mappers[j]
            num_bins.append(m.num_bin)
            ok = (config.enable_bundle
                  and m.bin_type == binning.BIN_TYPE_NUMERICAL
                  and m.missing_type != binning.MISSING_NAN
                  and m.most_freq_bin == m.default_bin
                  and not (j < len(mc) and int(mc[j]) != 0)
                  and not (j < len(fc) and float(fc[j]) != 1.0))
            if not ok:
                nonzero_rows.append(None)
                continue
            if sparse:
                rows = Xs.indices[Xs.indptr[j]:Xs.indptr[j + 1]]
                vals = np.asarray(Xs.data[Xs.indptr[j]:Xs.indptr[j + 1]],
                                  dtype=np.float64)
            else:
                col = np.asarray(Xs[:, j], dtype=np.float64)
                rows = np.nonzero(col != 0.0)[0]
                vals = col[rows]
            b = m.values_to_bins(vals)
            nonzero_rows.append(np.asarray(rows)[b != m.most_freq_bin])
            bundle_ok[i] = True
        self.bundles = fast_feature_bundling(nonzero_rows, num_bins,
                                             bundle_ok, total)

    def _build_feature_meta_bundled(self, config: Config) -> None:
        """Per-COLUMN metadata of a bundled dataset: each device column is
        a bundle or a single feature; bundle columns get the segment tables
        of the EFB-aware split search (``BundleMeta``), and the host maps
        from (column, bin) back to the original feature and its own bin
        (``_owner_orig``, ``_thr_fwd``, ``_thr_rev``), as the JAX package
        builds them."""
        used = self.used_features
        bundles = self.bundles
        g = max(len(bundles), 1)
        nb = np.full(g, 2, np.int32)
        missing = np.zeros(g, np.int32)
        default_bin = np.zeros(g, np.int32)
        is_cat = np.zeros(g, bool)
        monotone = np.zeros(g, np.int8)
        penalty = np.ones(g, np.float32)
        mc = list(config.monotone_constraints or [])
        fc = list(config.feature_contri or [])
        for key, vals in (("monotone_constraints", mc),
                          ("feature_contri", fc)):
            if vals and len(vals) != self.num_total_features:
                log.fatal(f"{key} should be the same size as feature number "
                          f"({self.num_total_features}), got {len(vals)}")
        for gi, bd in enumerate(bundles):
            if len(bd.members) == 1:
                j = int(used[bd.members[0]])
                m = self.mappers[j]
                nb[gi] = m.num_bin
                missing[gi] = m.missing_type
                default_bin[gi] = m.default_bin
                is_cat[gi] = m.bin_type == binning.BIN_TYPE_CATEGORICAL
                if j < len(mc):
                    monotone[gi] = np.int8(mc[j])
                if j < len(fc):
                    penalty[gi] = np.float32(fc[j])
            else:
                nb[gi] = bd.num_bin
        self.max_num_bins = int(nb.max()) if len(bundles) else 2
        check_bins_cap(self.max_num_bins)
        b = self.max_num_bins
        seg_lo = np.zeros((g, b), np.int32)
        seg_hi = np.zeros((g, b), np.int32)
        is_bundle = np.zeros(g, bool)
        fwd_ok = np.zeros((g, b), bool)
        rev_ok = np.zeros((g, b), bool)
        owner_orig = np.zeros((g, b), np.int32)
        thr_fwd = np.tile(np.arange(b, dtype=np.int32), (g, 1))
        thr_rev = np.tile(np.arange(b, dtype=np.int32), (g, 1))
        # tie-break preference tables (higher wins among equal keys),
        # ordered by the candidate's ORIGINAL feature first, so ties inside
        # a bundle and across columns resolve as the unbundled scan's
        # feature-major order does (ops/split.py BundleMeta)
        u = int(self.num_total_features)
        pref_fwd = np.zeros((g, b), np.int64)
        pref_rev = np.zeros((g, b), np.int64)

        def owner_base(j):
            return (u - 1 - j) * 4 * b

        t = np.arange(b, dtype=np.int64)
        for gi, bd in enumerate(bundles):
            if len(bd.members) == 1:
                j = int(used[bd.members[0]])
                seg_hi[gi, :] = nb[gi] - 1
                owner_orig[gi, :] = j
                pref_rev[gi, :] = owner_base(j) + 2 * b + t
                pref_fwd[gi, :] = owner_base(j) + (b - 1) - t
                continue
            is_bundle[gi] = True
            # per-bin candidate masks reproducing each member's unbundled
            # scan: its most frequent mass (rebuilt from the leaf totals)
            # sits at its ordinal position z, so forward candidates are
            # the thresholds below z, reverse ones those at or above z; the
            # leading phantom bin hosts the z-only-left candidate (z == 0)
            for mi, off in zip(bd.members, bd.offsets):
                j = int(used[mi])
                m = self.mappers[j]
                nbm, z = m.num_bin, m.most_freq_bin
                seg_lo[gi, off:off + nbm] = off
                seg_hi[gi, off:off + nbm] = off + nbm - 1
                owner_orig[gi, off:off + nbm] = j
                r = np.arange(nbm - 1)                  # data-bin ranks
                ds_ = slice(off + 1, off + nbm)
                if m.missing_type == binning.MISSING_ZERO and nbm > 2:
                    # zero-as-missing member: both directions, the default
                    # bin's threshold skipped
                    t_orig = r + (r >= z)
                    ok = t_orig <= nbm - 2
                    fwd_ok[gi, ds_] = ok
                    rev_ok[gi, ds_] = ok
                    thr_fwd[gi, ds_] = t_orig
                    thr_rev[gi, ds_] = t_orig
                    pref_rev[gi, ds_] = owner_base(j) + 2 * b + t_orig
                    pref_fwd[gi, ds_] = owner_base(j) + (b - 1) - t_orig
                else:
                    fwd_ok[gi, ds_] = r < z
                    rev_ok[gi, ds_] = (r >= z - 1) & (r <= nbm - 3)
                    thr_fwd[gi, ds_] = r
                    thr_rev[gi, ds_] = r + 1
                    # the member's unbundled scan is one reverse pass:
                    # every candidate competes with the reverse preference
                    # of its original threshold
                    pref_fwd[gi, ds_] = owner_base(j) + 2 * b + r
                    pref_rev[gi, ds_] = owner_base(j) + 2 * b + (r + 1)
                    if z == 0:                  # phantom: left = z mass
                        rev_ok[gi, off] = True
                        thr_rev[gi, off] = 0
                        pref_rev[gi, off] = owner_base(j) + 2 * b
        dev = self.device
        self._bundle_meta = BundleMeta(*(torch.as_tensor(a, device=dev) for a in (
            seg_lo, seg_hi, is_bundle, fwd_ok, rev_ok, pref_fwd, pref_rev)))
        self._owner_orig = owner_orig
        self._thr_fwd = thr_fwd
        self._thr_rev = thr_rev
        self.has_categorical = bool(is_cat.any())
        self.feature_meta = FeatureMeta(*(torch.as_tensor(a) for a in (
            nb, missing, default_bin, is_cat, monotone, penalty)))
        self.missing_bin = torch.as_tensor(missing_bin_of(self.feature_meta))

    def _bin_columns(self, X) -> torch.Tensor:
        """Raw matrix -> bundled bin matrix [G, N] on the device (the
        analog of FeatureGroup::PushData, feature_group.h): a single
        feature's column its bins (implicit zeros at the default bin), a
        bundle's column each member's non-most-frequent bins after its
        offset and phantom bin, 0 where every member is at its most
        frequent bin."""
        sparse = _is_scipy_sparse(X)
        X = X.tocsc() if sparse else _to_2d_float(X)
        n = X.shape[0]
        g = len(self.bundles)
        binsT = torch.zeros((max(g, 1), n),
                            dtype=binning.bins_dtype(self.max_num_bins))
        out = binsT.numpy()
        for gi, bd in enumerate(self.bundles):
            for mi, off in zip(bd.members, bd.offsets):
                j = int(self.used_features[mi])
                m = self.mappers[j]
                if sparse:
                    rows = X.indices[X.indptr[j]:X.indptr[j + 1]]
                    vals = np.asarray(X.data[X.indptr[j]:X.indptr[j + 1]],
                                      dtype=np.float64)
                else:
                    col = np.asarray(X[:, j], dtype=np.float64)
                    rows = np.nonzero((col != 0.0) | np.isnan(col))[0]
                    vals = col[rows]
                if len(bd.members) == 1:
                    out[gi] = m.default_bin
                    if len(rows):
                        out[gi, rows] = m.values_to_bins(vals)
                else:
                    bvals = m.values_to_bins(vals)
                    sel = bvals != m.most_freq_bin
                    bb = bvals[sel]
                    bb = bb - (bb > m.most_freq_bin)
                    # +1: the data bins follow the member's phantom bin
                    out[gi, np.asarray(rows)[sel]] = off + 1 + bb
        return binsT.to(self.device)

    def _bin_columns_unbundled(self, X) -> torch.Tensor:
        """scipy-sparse rows -> the unbundled bin matrix [F_used, N]
        through the per-feature mappers, column by column (a dense
        reference has one column a used feature)."""
        X = X.tocsc()
        n = X.shape[0]
        binsT = torch.zeros((max(len(self.used_features), 1), n),
                            dtype=binning.bins_dtype(self.max_num_bins))
        out = binsT.numpy()
        for i, j in enumerate(self.used_features):
            m = self.mappers[int(j)]
            rows = X.indices[X.indptr[j]:X.indptr[j + 1]]
            vals = np.asarray(X.data[X.indptr[j]:X.indptr[j + 1]],
                              dtype=np.float64)
            # implicit zeros take the bin of value 0 (bin.h GetDefaultBin)
            out[i] = m.default_bin
            if len(rows):
                out[i, rows] = m.values_to_bins(vals)
        return binsT.to(self.device)

    @property
    def bundle_meta(self) -> Optional[BundleMeta]:
        """The EFB segment tables, or None without bundles."""
        self.construct()
        return self._bundle_meta if self.bundles is not None else None

    def num_used_features(self) -> int:
        """Number of device columns (a bundle counts as one)."""
        self.construct()
        if self.bundles is not None:
            return max(len(self.bundles), 1)
        return max(len(self.used_features), 1)

    def traversal_binsT(self) -> torch.Tensor:
        """The full-width [G, N] bin matrix tree traversal reads: tree
        feature ids are device-column positions, and a sparse-stored
        set's ``binsT`` holds only its dense columns, so the stream columns
        are rebuilt from their (row, bin) entries and default bin (the
        whole-column form of SparseBin::Split's stream walk); kept on the
        dataset after the first call."""
        if not self.has_sparse_cols:
            return self.binsT
        kept = getattr(self, "_traversal_binsT", None)
        if kept is not None:
            return kept
        n = self.num_data
        sp = np.asarray(self.sp_cols, dtype=np.int64)
        fc = self.binsT.shape[0] + len(sp) if self.binsT is not None \
            else len(sp)
        dev = self.sp_rows.device
        full = torch.zeros((fc, n), dtype=self.sp_bins.dtype, device=dev)
        dense = np.setdiff1d(np.arange(fc), sp)
        if len(dense):
            full[torch.as_tensor(dense, device=dev)] = self.binsT
        for i, c in enumerate(sp):
            col = torch.full((n,), int(self.sp_default[i]),
                             dtype=full.dtype, device=dev)
            ok = self.sp_rows[i] < n             # stream pad = out of range
            col[self.sp_rows[i][ok].long()] = self.sp_bins[i][ok]
            full[int(c)] = col
        self._traversal_binsT = full
        return full


