"""Feature quantization (binning), numerical and categorical features.

The port of lightgbm_tpu's ``binning.py`` for dense data. The bin mappers
are fitted on the host exactly as there (numpy, float64), so they are
bit-identical to the JAX package's:

- ``greedy_find_bin``: equal-count greedy bin boundaries over sampled
  distinct values (reference ``GreedyFindBin``, bin.cpp:78-155).
- ``find_bin_with_zero_as_one_bin``: dedicated zero bin straddling
  ±kZeroThreshold (reference ``FindBinWithZeroAsOneBin``, bin.cpp:256-314).
- Missing handling ``MissingType {None, Zero, NaN}`` (reference bin.h:26):
  with NaN present and ``use_missing``, the LAST bin is the NaN bin.
- Categorical features (reference bin.cpp:424-490): categories ordered by
  count, bin 0 the other/NaN bin, negative values read as NaN.
- Per-feature ``max_bin_by_feature`` and forced upper bounds
  (``forcedbins_filename``, ``_find_bin_with_predefined``, reference
  FindBinWithPredefinedBin, bin.cpp:157-254); ``fit_mapper_for_column`` is
  the one per-column fit of the dense and the sparse construct paths.

The data matrix is quantized on the device (``bin_data_device``): one
``torch.searchsorted`` over the feature-major matrix against the per-feature
bound tables of ``device_bin_tables``, which returns the feature-major
``binsT [F, N]`` the histogram kernels read directly; categorical columns
are mapped on the host (``values_to_bins``) and copied in. The bin matrix
is uint8 while every feature has at most 256 bins and int16 above (the
wide mode; every bin is below the kernels' cap of 4,096 bins, so its
value reads the same signed or unsigned). Streaming sketches wait for
ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .utils import log

# reference: include/LightGBM/bin.h:30 (kZeroThreshold = 1e-35)
K_ZERO_THRESHOLD = 1e-35
# reference: include/LightGBM/bin.h:39 (kSparseThreshold = 0.7)
K_SPARSE_THRESHOLD = 0.7

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_TYPE_NUMERICAL = 0
BIN_TYPE_CATEGORICAL = 1


def _get_double_upper_bound(a: float) -> float:
    """Smallest double strictly greater than a (reference: common.h:830)."""
    return float(np.nextafter(a, np.inf))


def _check_double_equal_ordered(a: float, b: float) -> bool:
    """reference: common.h:825 CheckDoubleEqualOrdered."""
    upper = _get_double_upper_bound(a)
    return a >= b or b <= upper


def need_filter(cnt_in_bin: np.ndarray, total_cnt: int,
                filter_cnt: int, bin_type: int = BIN_TYPE_NUMERICAL) -> bool:
    """Pre-filter: no threshold leaves >= filter_cnt on both sides
    (reference: bin.cpp:54-76 NeedFilter)."""
    if bin_type == BIN_TYPE_NUMERICAL:
        sum_left = 0
        for i in range(len(cnt_in_bin) - 1):
            sum_left += int(cnt_in_bin[i])
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
    else:
        if len(cnt_in_bin) > 2:
            return False
        for i in range(len(cnt_in_bin) - 1):
            sum_left = int(cnt_in_bin[i])
            if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
                return False
    return True


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> List[float]:
    """Equal-count greedy bin upper bounds (reference: bin.cpp:78-155)."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    assert max_bin > 0
    if num_distinct <= max_bin:
        cur_cnt_inbin = 0
        for i in range(num_distinct - 1):
            cur_cnt_inbin += counts[i]
            if cur_cnt_inbin >= min_data_in_bin:
                val = _get_double_upper_bound(
                    (distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if (not bin_upper_bound
                        or not _check_double_equal_ordered(bin_upper_bound[-1],
                                                           val)):
                    bin_upper_bound.append(val)
                    cur_cnt_inbin = 0
        bin_upper_bound.append(math.inf)
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = min(max_bin, total_cnt // min_data_in_bin)
        max_bin = max(max_bin, 1)
    mean_bin_size = total_cnt / max_bin

    rest_bin_cnt = max_bin
    rest_sample_cnt = int(total_cnt)
    is_big_count_value = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big_count_value.sum())
    rest_sample_cnt -= int(counts[is_big_count_value].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    upper_bounds = [math.inf] * max_bin
    lower_bounds = [math.inf] * max_bin
    bin_cnt = 0
    lower_bounds[0] = float(distinct_values[0])
    # the reference's walk over the distinct values, a bin at a time: its
    # cut conditions are a running count reaching a threshold (monotone,
    # a search on the prefix sums) or a big-count value here or next, so
    # each bin's end is found without visiting the values between (a
    # Python step a distinct value made this most of a wide table's
    # construct time); the same integers and doubles, the same bounds
    cnt = np.asarray(counts, np.int64)
    big = np.asarray(is_big_count_value, bool)
    csum = np.cumsum(cnt)
    small_csum = np.cumsum(np.where(big, 0, cnt))
    # next_big[k]: the first big-count index >= k (num_distinct: none)
    idx = np.where(big, np.arange(num_distinct), num_distinct)
    next_big = np.append(np.minimum.accumulate(idx[::-1])[::-1],
                         [num_distinct, num_distinct])
    last = num_distinct - 2              # the walk's last index
    i0 = 0
    while i0 <= last:
        base = int(csum[i0 - 1]) if i0 > 0 else 0
        j = int(next_big[i0])                                   # big here
        jb = int(np.searchsorted(csum, base + math.ceil(mean_bin_size)))
        j = min(j, max(jb, i0))                                 # full bin
        jc = int(np.searchsorted(
            csum, base + math.ceil(max(1.0, mean_bin_size * 0.5))))
        j = min(j, int(next_big[max(jc, i0) + 1]) - 1)          # big next
        if j > last:
            break
        rest_sample_cnt -= int(small_csum[j]) - (
            int(small_csum[i0 - 1]) if i0 > 0 else 0)
        upper_bounds[bin_cnt] = float(distinct_values[j])
        bin_cnt += 1
        lower_bounds[bin_cnt] = float(distinct_values[j + 1])
        if bin_cnt >= max_bin - 1:
            break
        if not big[j]:
            rest_bin_cnt -= 1
            mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
        i0 = j + 1
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _get_double_upper_bound(
            (upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if (not bin_upper_bound
                or not _check_double_equal_ordered(bin_upper_bound[-1], val)):
            bin_upper_bound.append(val)
    bin_upper_bound.append(math.inf)
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray,
                                  counts: np.ndarray, max_bin: int,
                                  total_sample_cnt: int,
                                  min_data_in_bin: int,
                                  forced_bounds: Optional[Sequence[float]]
                                  = None) -> List[float]:
    """Bin bounds with a dedicated zero bin (reference: bin.cpp:256-314);
    with ``forced_bounds``, the forced bounds and a greedy fill around
    them (``_find_bin_with_predefined``)."""
    if forced_bounds:
        return _find_bin_with_predefined(distinct_values, counts, max_bin,
                                         total_sample_cnt, min_data_in_bin,
                                         list(forced_bounds))
    left_mask = distinct_values <= -K_ZERO_THRESHOLD
    right_mask = distinct_values > K_ZERO_THRESHOLD
    left_cnt_data = int(counts[left_mask].sum())
    cnt_zero = int(counts[~left_mask & ~right_mask].sum())
    right_cnt_data = int(counts[right_mask].sum())

    nz = np.nonzero(distinct_values > -K_ZERO_THRESHOLD)[0]
    left_cnt = int(nz[0]) if len(nz) else len(distinct_values)

    bin_upper_bound: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bin_upper_bound = greedy_find_bin(distinct_values[:left_cnt],
                                          counts[:left_cnt], left_max_bin,
                                          left_cnt_data, min_data_in_bin)
        if bin_upper_bound:
            bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    nz = np.nonzero(distinct_values[left_cnt:] > K_ZERO_THRESHOLD)[0]
    right_start = (left_cnt + int(nz[0])) if len(nz) else -1

    right_max_bin = max_bin - 1 - len(bin_upper_bound)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(distinct_values[right_start:],
                                       counts[right_start:], right_max_bin,
                                       right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(math.inf)
    assert len(bin_upper_bound) <= max_bin
    return bin_upper_bound


def _find_bin_with_predefined(distinct_values: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_sample_cnt: int,
                              min_data_in_bin: int,
                              forced_bounds: List[float]) -> List[float]:
    """Forced bin bounds + a proportional greedy fill of each forced
    segment (reference: bin.cpp:157-254 FindBinWithPredefinedBin: the zero
    and infinity bounds first, the forced bounds inserted up to the budget,
    then the free bins spread over the segments in proportion to their
    sample counts and found greedily within each)."""
    nvals = len(distinct_values)
    left_cnt = nvals
    for i in range(nvals):
        if distinct_values[i] > -K_ZERO_THRESHOLD:
            left_cnt = i
            break
    right_start = -1
    for i in range(left_cnt, nvals):
        if distinct_values[i] > K_ZERO_THRESHOLD:
            right_start = i
            break

    bin_upper_bound: List[float] = []
    if max_bin == 2:
        bin_upper_bound.append(K_ZERO_THRESHOLD if left_cnt == 0
                               else -K_ZERO_THRESHOLD)
    elif max_bin >= 3:
        if left_cnt > 0:
            bin_upper_bound.append(-K_ZERO_THRESHOLD)
        if right_start >= 0:
            bin_upper_bound.append(K_ZERO_THRESHOLD)
    bin_upper_bound.append(math.inf)

    max_to_insert = max_bin - len(bin_upper_bound)
    num_inserted = 0
    for b in forced_bounds:
        if num_inserted >= max_to_insert:
            break
        if abs(b) > K_ZERO_THRESHOLD:
            bin_upper_bound.append(float(b))
            num_inserted += 1
    bin_upper_bound.sort()

    free_bins = max_bin - len(bin_upper_bound)
    bounds_to_add: List[float] = []
    value_ind = 0
    for i, ub in enumerate(bin_upper_bound):
        cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < nvals and distinct_values[value_ind] < ub:
            cnt_in_bin += int(counts[value_ind])
            value_ind += 1
        bins_remaining = (max_bin - len(bin_upper_bound)
                          - len(bounds_to_add))
        num_sub_bins = int(round(cnt_in_bin * free_bins
                                 / max(total_sample_cnt, 1)))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == len(bin_upper_bound) - 1:
            num_sub_bins = bins_remaining + 1
        new_ub = greedy_find_bin(distinct_values[bin_start:value_ind],
                                 counts[bin_start:value_ind], num_sub_bins,
                                 cnt_in_bin, min_data_in_bin)
        bounds_to_add.extend(new_ub[:-1])       # the last bound is infinity
    out = sorted(bin_upper_bound + bounds_to_add)
    assert len(out) <= max_bin
    return out


class BinMapper:
    """Per-feature value->bin mapping (reference:
    include/LightGBM/bin.h:61-225)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.bin_type: int = BIN_TYPE_NUMERICAL
        self.is_trivial: bool = True
        self.sparse_rate: float = 1.0
        self.bin_upper_bound: np.ndarray = np.array([math.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: Dict[int, int] = {}
        self.default_bin: int = 0       # bin of value 0 (bin.h GetDefaultBin)
        self.most_freq_bin: int = 0
        self.min_val: float = 0.0
        self.max_val: float = 0.0

    def find_bin(self, values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int = 3,
                 min_split_data: int = 0, pre_filter: bool = False,
                 bin_type: int = BIN_TYPE_NUMERICAL,
                 use_missing: bool = True,
                 zero_as_missing: bool = False,
                 forced_bounds: Optional[Sequence[float]] = None) -> None:
        """Fit the mapper on sampled values (reference: bin.cpp:325-520).
        ``total_sample_cnt - len(values)`` rows are implied zeros;
        ``forced_bounds`` are a numerical feature's forced upper bounds."""
        values = np.asarray(values, dtype=np.float64)
        na_mask = np.isnan(values)
        na_cnt = int(na_mask.sum())
        values = values[~na_mask]
        if len(values):
            vals, counts = np.unique(values, return_counts=True)
        else:
            vals, counts = np.array([]), np.array([], dtype=np.int64)
        counts = np.asarray(counts, dtype=np.int64)

        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE
        self.bin_type = bin_type
        self.default_bin = 0
        zero_cnt = int(total_sample_cnt - counts.sum() - na_cnt)
        # zero slot positioned in sorted order (reference: bin.cpp:355-395)
        if zero_cnt > 0 or len(vals) == 0:
            if 0.0 not in vals:
                insert_at = int(np.searchsorted(vals, 0.0))
                vals = np.insert(vals, insert_at, 0.0)
                counts = np.insert(counts, insert_at, zero_cnt)
            else:
                counts[np.searchsorted(vals, 0.0)] += zero_cnt
        self.min_val = float(vals[0]) if len(vals) else 0.0
        self.max_val = float(vals[-1]) if len(vals) else 0.0
        counts = counts.astype(np.int64)

        if bin_type == BIN_TYPE_NUMERICAL:
            cnt_in_bin = self._fit_numerical(vals, counts, na_cnt,
                                             total_sample_cnt, max_bin,
                                             min_data_in_bin, forced_bounds)
        else:
            cnt_in_bin = self._fit_categorical(vals, counts, na_cnt,
                                               total_sample_cnt, max_bin,
                                               min_data_in_bin)

        # trivial / pre-filter (bin.cpp:494-503)
        self.is_trivial = self.num_bin <= 1
        if (not self.is_trivial and pre_filter
                and need_filter(cnt_in_bin, int(total_sample_cnt),
                                int(min_split_data), bin_type)):
            self.is_trivial = True
        if not self.is_trivial:
            self.default_bin = self.value_to_bin(0.0)
            self.most_freq_bin = int(np.argmax(cnt_in_bin))
            max_sparse_rate = (float(cnt_in_bin[self.most_freq_bin])
                               / max(total_sample_cnt, 1))
            if (self.most_freq_bin != self.default_bin
                    and max_sparse_rate < K_SPARSE_THRESHOLD):
                self.most_freq_bin = self.default_bin
            self.sparse_rate = (float(cnt_in_bin[self.most_freq_bin])
                                / max(total_sample_cnt, 1))
        else:
            self.sparse_rate = 1.0

    def _fit_numerical(self, vals, counts, na_cnt, total_sample_cnt, max_bin,
                       min_data_in_bin, forced_bounds=None) -> np.ndarray:
        """Numerical bounds and the count per bin (bin.cpp:398-421)."""
        if self.missing_type in (MISSING_ZERO, MISSING_NONE):
            bounds = find_bin_with_zero_as_one_bin(
                vals, counts, max_bin, total_sample_cnt, min_data_in_bin,
                forced_bounds)
            if self.missing_type == MISSING_ZERO and len(bounds) == 2:
                self.missing_type = MISSING_NONE
        else:  # NaN bin appended as the last bin (bin.cpp:398-402)
            bounds = find_bin_with_zero_as_one_bin(
                vals, counts, max_bin - 1, total_sample_cnt - na_cnt,
                min_data_in_bin, forced_bounds)
            bounds.append(math.nan)
        self.bin_upper_bound = np.asarray(bounds)
        self.num_bin = len(bounds)
        n_real = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
        finite_bounds = self.bin_upper_bound[:n_real]
        cnt_in_bin = np.zeros(self.num_bin, dtype=np.int64)
        if len(vals):
            idx = np.searchsorted(finite_bounds, vals, side="left")
            np.add.at(cnt_in_bin, np.minimum(idx, n_real - 1), counts)
        if self.missing_type == MISSING_NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        return cnt_in_bin

    def _fit_categorical(self, vals, counts, na_cnt, total_sample_cnt,
                         max_bin, min_data_in_bin) -> np.ndarray:
        """Categories by descending count, bin 0 the other/NaN bin; the
        count per bin (bin.cpp:424-490)."""
        vals_int = vals.astype(np.int64)
        neg = vals_int < 0
        if neg.any():
            log.warning("Met negative value in categorical features, will "
                        "convert it to NaN")
            na_cnt += int(counts[neg].sum())
            vals_int, counts = vals_int[~neg], counts[~neg]
        if len(vals_int):            # merge the duplicates of the int cast
            vals_u, inv = np.unique(vals_int, return_inverse=True)
            counts_u = np.zeros(len(vals_u), dtype=np.int64)
            np.add.at(counts_u, inv, counts)
        else:
            vals_u, counts_u = vals_int, counts
        rest_cnt = total_sample_cnt - na_cnt
        self.bin_2_categorical = [-1]
        self.categorical_2_bin = {-1: 0}
        cnt_list = [0]
        self.num_bin = 1
        if rest_cnt > 0 and len(vals_u):
            order = np.argsort(-counts_u, kind="stable")
            cut_cnt = int(round((total_sample_cnt - na_cnt) * 0.99))
            distinct_cnt = len(vals_u) + (1 if na_cnt > 0 else 0)
            eff_max_bin = min(distinct_cnt, max_bin)
            used_cnt = 0
            for rank, j in enumerate(order):
                if not (used_cnt < cut_cnt or self.num_bin < eff_max_bin):
                    break
                if counts_u[j] < min_data_in_bin and rank > 1:
                    break
                cat = int(vals_u[j])
                self.bin_2_categorical.append(cat)
                self.categorical_2_bin[cat] = self.num_bin
                used_cnt += int(counts_u[j])
                cnt_list.append(int(counts_u[j]))
                self.num_bin += 1
            all_used = (self.num_bin - 1) == len(vals_u)
            self.missing_type = (MISSING_NONE if (all_used and na_cnt == 0)
                                 else MISSING_NAN)
            cnt_list[0] = int(total_sample_cnt - used_cnt)
        return np.asarray(cnt_list, dtype=np.int64)

    def value_to_bin(self, value: float) -> int:
        """Scalar value->bin (reference: bin.h:464-502 ValueToBin)."""
        return int(self.values_to_bins(np.array([value]))[0])

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin for a whole column (host, float64). A
        category outside the mapper, NaN or a negative value -> bin 0."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            out = np.zeros(len(values), dtype=np.int32)
            cats = np.array(self.bin_2_categorical[1:], dtype=np.int64)
            if len(cats):
                bins = np.arange(1, self.num_bin, dtype=np.int32)
                vals_int = np.where(np.isnan(values), -1,
                                    values).astype(np.int64)
                sorter = np.argsort(cats)
                pos = np.clip(np.searchsorted(cats[sorter], vals_int), 0,
                              len(cats) - 1)
                matched = cats[sorter][pos] == vals_int
                out = np.where(matched, bins[sorter][pos], 0).astype(np.int32)
            return out
        has_nan_bin = self.missing_type == MISSING_NAN
        n_real = self.num_bin - (1 if has_nan_bin else 0)
        finite_bounds = (self.bin_upper_bound[:n_real - 1] if n_real > 0
                         else np.array([]))
        vals = values
        if self.missing_type == MISSING_ZERO:
            vals = np.where(np.isnan(vals), 0.0, vals)
        idx = np.searchsorted(finite_bounds, vals, side="left").astype(np.int32)
        if has_nan_bin:
            idx = np.where(np.isnan(values), self.num_bin - 1,
                           idx).astype(np.int32)
        return idx

    def bin_to_value(self, bin_idx: int) -> float:
        """Real threshold of a bin boundary (reference: tree.h
        RealThreshold); a categorical bin's category value."""
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return (float(self.bin_2_categorical[bin_idx])
                    if bin_idx < len(self.bin_2_categorical) else -1.0)
        return float(self.bin_upper_bound[bin_idx])


def sample_indices(num_data: int, sample_cnt: int, seed: int) -> np.ndarray:
    """Row sample for bin finding: the same seeded draw as the JAX
    package, so both fit their mappers on the same rows."""
    if num_data <= sample_cnt:
        return np.arange(num_data)
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(num_data, size=sample_cnt, replace=False))


def filter_cnt_for_sample(config, sample_cnt: int, num_data: int) -> int:
    """reference: dataset_loader.cpp:647-648 filter_cnt scaling."""
    return int(config.min_data_in_leaf * sample_cnt / max(num_data, 1))


def _find_bin_kwargs(j: int, config, cat_set, filter_cnt: int,
                     forced_bounds=None) -> dict:
    """Column ``j``'s binning parameters from the config: its
    ``max_bin_by_feature`` entry (else ``max_bin``), categorical or
    numerical, and its forced bounds."""
    return dict(
        max_bin=(config.max_bin_by_feature[j]
                 if j < len(config.max_bin_by_feature) else config.max_bin),
        min_data_in_bin=config.min_data_in_bin,
        min_split_data=filter_cnt,
        pre_filter=config.feature_pre_filter,
        bin_type=(BIN_TYPE_CATEGORICAL if j in cat_set
                  else BIN_TYPE_NUMERICAL),
        use_missing=config.use_missing,
        zero_as_missing=config.zero_as_missing,
        forced_bounds=(forced_bounds or {}).get(j),
    )


def fit_mapper_for_column(j: int, vals: np.ndarray, total_sample_cnt: int,
                          config, cat_set, filter_cnt: int,
                          forced_bounds=None) -> BinMapper:
    """Fit column ``j``'s BinMapper on its sampled values ``vals`` (the
    dense path passes the whole sampled column, the sparse path its
    nonzeros with the zeros implied by ``total_sample_cnt``): the one
    per-column fit of both construct paths (reference: DatasetLoader::
    ConstructBinMappersFromTextData's FindBin call,
    dataset_loader.cpp:953-1140)."""
    m = BinMapper()
    m.find_bin(vals, total_sample_cnt=total_sample_cnt,
               **_find_bin_kwargs(j, config, cat_set, filter_cnt,
                                  forced_bounds))
    return m


def find_bin_mappers(X: np.ndarray, config,
                     categorical_features: Sequence[int] = (),
                     forced_bounds: Optional[Dict[int, List[float]]] = None
                     ) -> List[BinMapper]:
    """Fit one BinMapper per column (reference: DatasetLoader::
    ConstructBinMappersFromTextData, dataset_loader.cpp:953-1140); the
    columns in ``categorical_features`` get categorical mappers, those in
    ``forced_bounds`` their forced upper bounds."""
    num_data, num_features = X.shape
    sample_idx = sample_indices(num_data, config.bin_construct_sample_cnt,
                                config.data_random_seed)
    filter_cnt = filter_cnt_for_sample(config, len(sample_idx), num_data)
    cat_set = set(int(c) for c in categorical_features)
    return [fit_mapper_for_column(
        j, np.asarray(X[sample_idx, j], dtype=np.float64), len(sample_idx),
        config, cat_set, filter_cnt, forced_bounds)
        for j in range(num_features)]


def bins_dtype(max_num_bins: int):
    """The bin matrix's dtype: uint8 up to 256 bins, int16 above (the
    wide mode)."""
    import torch
    return torch.uint8 if max_num_bins <= 256 else torch.int16


def device_bin_tables(mappers: Sequence[BinMapper], dtype=np.float32):
    """Per-feature tables for device quantization in ``dtype``.

    The host path compares float64 values against float64 upper bounds
    (``values_to_bins``: idx = #{bounds < v}). For float32 inputs the same
    predicate is computed exactly in f32 by replacing each f64 bound b with
    the largest f32 <= b: for any f32 v, (v > b) == (v > b_dn). For float64
    inputs the bounds are used as they are. Returns (bounds [F, Bpad]
    (+inf padded, ascending), nan_to_zero [F] bool, nan_bin [F] int64)."""
    fs = len(mappers)
    finite = []
    nan_to_zero = np.zeros((fs,), dtype=bool)
    nan_bin = np.zeros((fs,), dtype=np.int64)
    for i, m in enumerate(mappers):
        has_nan_bin = m.missing_type == MISSING_NAN
        n_real = m.num_bin - (1 if has_nan_bin else 0)
        fb = (np.asarray(m.bin_upper_bound[:n_real - 1], dtype=np.float64)
              if n_real > 0 else np.zeros((0,), np.float64))
        finite.append(fb)
        nan_to_zero[i] = m.missing_type == MISSING_ZERO
        # NaN-as-missing gets the top bin; with no NaN handling, the host
        # searchsorted lands NaN at the end of the finite bounds
        nan_bin[i] = m.num_bin - 1 if has_nan_bin else max(n_real - 1, 0)
    bpad = max(1, max((len(fb) for fb in finite), default=1))
    bounds = np.full((fs, bpad), np.inf, dtype=dtype)
    for i, fb in enumerate(finite):
        if not len(fb):
            continue
        if dtype == np.float64:
            bounds[i, :len(fb)] = fb
            continue
        b32 = fb.astype(np.float32)
        over = b32.astype(np.float64) > fb
        bounds[i, :len(fb)] = np.where(
            over, np.nextafter(b32, np.float32(-np.inf)), b32)
    return bounds, nan_to_zero, nan_bin


def quantize_block(xT, bounds, nan_to_zero, nan_bin):
    """The device quantize predicate for one block of feature-major rows
    (the torch form of the JAX package's ``_quantize_block``): ``xT [F, C]``
    float, ``bounds [F, Bpad]`` from ``device_bin_tables``; returns the bin
    count #{bounds < v} per value as int64 ``[F, C]``."""
    import torch
    v = torch.where(torch.isnan(xT) & nan_to_zero[:, None],
                    torch.zeros((), dtype=xT.dtype, device=xT.device), xT)
    cnt = torch.searchsorted(bounds, v.contiguous(), right=False)
    return torch.where(torch.isnan(v), nan_bin[:, None], cnt)


class BinSlot:
    """Buffers to quantize up to ``rows`` rows of one feature width in
    place, allocated once: the serve mode's binning
    (``bin_data_device(..., out=slot)``, ``models/predict_engine.py``).
    The rows go to a host staging buffer (pinned on a CUDA device), up to
    the device in one asynchronous copy, are transposed into ``xT`` and
    quantized over the whole slot into ``cnt`` and ``binsT`` with the
    operations' ``out=`` forms: a call allocates no device memory. The
    predicate is ``quantize_block``'s, so the bins are bitwise
    ``bin_data_device``'s; rows past the call's ``n`` hold stale values
    nobody reads."""

    def __init__(self, mappers: Sequence[BinMapper], rows: int, dtype,
                 device):
        import torch
        self.mappers = list(mappers)
        self.rows = int(rows)
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        fs = len(self.mappers)
        bounds, nz, nb = device_bin_tables(self.mappers, self.dtype.type)
        tdt = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        dev = self.device
        self.bounds = torch.as_tensor(bounds, device=dev)
        self.nz = torch.as_tensor(nz, device=dev)[:, None]
        self.nb = torch.as_tensor(nb, device=dev)[:, None]
        pin = dev.type == "cuda"
        self.host = torch.empty((self.rows, fs), dtype=tdt, pin_memory=pin)
        self.host_np = self.host.numpy()
        self.raw = torch.empty((self.rows, fs), dtype=tdt, device=dev)
        self.xT = torch.empty((fs, self.rows), dtype=tdt, device=dev)
        self.nan = torch.empty((fs, self.rows), dtype=torch.bool, device=dev)
        self.cnt = torch.empty((fs, self.rows), dtype=torch.int64, device=dev)
        out_dtype = bins_dtype(max((m.num_bin for m in self.mappers),
                                   default=2))
        self.binsT = torch.empty((fs, self.rows), dtype=out_dtype, device=dev)
        self.cat = [j for j, m in enumerate(self.mappers)
                    if m.bin_type == BIN_TYPE_CATEGORICAL]
        self.cat_host = torch.empty((len(self.cat), self.rows),
                                    dtype=out_dtype, pin_memory=pin)
        self.cat_np = self.cat_host.numpy()

    def fits(self, X: np.ndarray) -> bool:
        return (X.shape[0] <= self.rows and X.shape[1] == len(self.mappers)
                and X.dtype == self.dtype)

    def bin(self, X: np.ndarray):
        """Quantize ``X [n, F]`` (n <= rows) into ``binsT[:, :n]`` and
        return that view. With profiling enabled the copy in and the
        binning are scopes of their own (``serve_copy_in``,
        ``serve_bin``)."""
        import torch
        from .utils import profiling
        n = X.shape[0]
        nb = not self.device.type == "cpu"
        with profiling.timer("serve_copy_in", sync=self.device):
            self.host_np[:n] = X
            self.raw[:n].copy_(self.host[:n], non_blocking=nb)
        with profiling.timer("serve_bin", sync=self.device):
            self.xT[:, :n].copy_(self.raw[:n].t())
            torch.ne(self.xT, self.xT, out=self.nan)
            torch.logical_and(self.nan, self.nz, out=self.nan)
            self.xT.masked_fill_(self.nan, 0)
            torch.searchsorted(self.bounds, self.xT, right=False,
                               out=self.cnt)
            torch.ne(self.xT, self.xT, out=self.nan)
            torch.where(self.nan, self.nb, self.cnt, out=self.cnt)
            self.binsT.copy_(self.cnt)
            # categorical columns: the host's category lookup overwrites
            # the row, as in bin_data_device
            for i, j in enumerate(self.cat):
                self.cat_np[i, :n] = self.mappers[j].values_to_bins(X[:, j])
                self.binsT[j, :n].copy_(self.cat_host[i, :n],
                                        non_blocking=nb)
        return self.binsT[:, :n]


def bin_data_device(X: np.ndarray, mappers: Sequence[BinMapper], device,
                    block: int = 1 << 20, out: Optional[BinSlot] = None):
    """Quantize ``X [N, F]`` on ``device``; returns the feature-major
    ``binsT [F, N]`` (``bins_dtype``: uint8 when every feature has <= 256
    bins, else int16). Bit-exact vs ``bin_data`` for float32 and float64 input (see
    ``device_bin_tables``). Rows go up in blocks so the int64 searchsorted
    result stays bounded. ``out``: a ``BinSlot`` of these mappers that fits
    ``X``, which bins in place into its preallocated buffers and returns
    the ``[F, N]`` view of its bins (the serve mode's path)."""
    import torch
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    if out is not None:
        if not out.fits(X):
            raise ValueError(f"bin_data_device: rows {X.shape} {X.dtype} do "
                             f"not fit the slot ({out.rows} rows of "
                             f"{len(out.mappers)} columns, {out.dtype})")
        return out.bin(X)
    n, fs = X.shape
    bounds, nz, nb = device_bin_tables(mappers, X.dtype.type)
    out_dtype = bins_dtype(max((m.num_bin for m in mappers), default=2))
    bd = torch.as_tensor(bounds, device=device)
    nzt = torch.as_tensor(nz, device=device)
    nbt = torch.as_tensor(nb, device=device)
    out = torch.empty((fs, n), dtype=out_dtype, device=device)
    for s in range(0, n, block):
        xb = torch.as_tensor(np.ascontiguousarray(X[s:s + block].T),
                             device=device)
        out[:, s:s + block] = quantize_block(xb, bd, nzt, nbt).to(out_dtype)
    # categorical columns: the host's category lookup overwrites the row
    for j, m in enumerate(mappers):
        if m.bin_type == BIN_TYPE_CATEGORICAL:
            out[j] = torch.as_tensor(m.values_to_bins(X[:, j]),
                                     device=device).to(out_dtype)
    return out
