"""Numerical best-split search over histogram planes, in PyTorch.

The port of lightgbm_tpu's ``ops/split.py`` for numerical features: every
(leaf, feature, direction, threshold) candidate is evaluated at once with
cumulative sums over the bin axis, and a masked lexicographic argmax
reproduces the reference's first-better-wins order (reference:
src/treelearner/feature_histogram.hpp:858-1050). The arithmetic is the JAX
package's, operation for operation, in float32, so candidate tables and
``SplitInfo`` come out bit-identical on identical planes. Three details
make that hold:

- ``_round_fence`` is the identity here. The JAX package fences products
  before an add because XLA contracts a multiply feeding an add into one
  FMA; eager PyTorch never contracts, so every product already rounds on
  its own. The call sites are kept so the two files read side by side.
- ``_sign`` follows XLA's ``sign`` (±0 stays ±0), which ``torch.sign``
  does not, so a zero gradient sum keeps the sign of zero XLA gives it.
- The bin-axis cumulative sum runs in XLA's block order
  (``utils.ordered.blocked_cumsum``).

The CUDA split epilogue (``csrc/split_epilogue.cu``) computes
``numerical_candidates`` with the same operation order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from ..utils.ordered import blocked_cumsum

K_EPSILON = 1e-15          # reference: include/LightGBM/meta.h kEpsilon
K_MIN_SCORE = float("-inf")  # reference: kMinScore


class FeatureMeta(NamedTuple):
    """Per-feature metadata tensors, all shape [F]."""
    num_bins: torch.Tensor        # int32, total bins incl. NaN bin
    missing_type: torch.Tensor    # int32, MISSING_{NONE,ZERO,NAN}
    default_bin: torch.Tensor     # int32, bin of value 0.0
    is_categorical: torch.Tensor  # bool (all False in this slice)
    monotone: torch.Tensor        # int8 (all 0 in this slice)
    penalty: torch.Tensor         # float32 feature_contri (all 1.0)

    def to(self, device) -> "FeatureMeta":
        return FeatureMeta(*(t.to(device) for t in self))


class SplitParams(NamedTuple):
    """The numerical-scan split hyperparameters as float32 scalars."""
    lambda_l1: torch.Tensor
    lambda_l2: torch.Tensor
    max_delta_step: torch.Tensor
    path_smooth: torch.Tensor
    min_data_in_leaf: torch.Tensor
    min_sum_hessian_in_leaf: torch.Tensor
    min_gain_to_split: torch.Tensor

    @classmethod
    def from_config(cls, config, device="cpu") -> "SplitParams":
        return cls(*(torch.tensor(float(getattr(config, n)),
                                  dtype=torch.float32, device=device)
                     for n in cls._fields))

    @classmethod
    def from_packed(cls, pv: torch.Tensor) -> "SplitParams":
        """Inverse of ``ops.cuda_hist.pack_scan_params``."""
        return cls(*(pv[i] for i in range(len(cls._fields))))

    def to(self, device) -> "SplitParams":
        return SplitParams(*(t.to(device) for t in self))


class SplitInfo(NamedTuple):
    """Per-leaf best numerical split, struct-of-arrays of shape [L]
    (reference: src/treelearner/split_info.hpp:22-90)."""
    gain: torch.Tensor          # f32; -inf when unsplittable
    feature: torch.Tensor       # int32 inner feature index
    threshold: torch.Tensor     # int32 bin threshold (left: bin <= thr)
    default_left: torch.Tensor  # bool, direction for missing values
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """XLA's sign: ±1, ±0 for ±0, NaN for NaN."""
    keep = (x == 0) | torch.isnan(x)
    return torch.where(keep, x, torch.copysign(torch.ones_like(x), x))


def threshold_l1(s: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """reference: feature_histogram.hpp:737-741 ThresholdL1."""
    return _sign(s) * torch.maximum(torch.abs(s) - l1, torch.zeros_like(s))


def _round_fence(x: torch.Tensor, p: SplitParams) -> torch.Tensor:
    """Identity: eager PyTorch never contracts a multiply into an add (see
    the module docstring); kept so the formulas read as in the JAX file."""
    return x


def calculate_leaf_output(sum_g, sum_h, p: SplitParams, num_data,
                          parent_output):
    """reference: feature_histogram.hpp:743-764 CalculateSplittedLeafOutput."""
    ret = -threshold_l1(sum_g, p.lambda_l1) / (sum_h + p.lambda_l2)
    ret = torch.where((p.max_delta_step > 0)
                      & (torch.abs(ret) > p.max_delta_step),
                      _sign(ret) * p.max_delta_step, ret)
    use_smooth = p.path_smooth > _f32(K_EPSILON, ret)
    one = _f32(1.0, ret)
    n_over_s = num_data / torch.where(use_smooth, p.path_smooth, one)
    smoothed = (_round_fence(ret * (n_over_s / (n_over_s + one)), p)
                + parent_output / (n_over_s + one))
    return torch.where(use_smooth, smoothed, ret)


def leaf_gain_given_output(sum_g, sum_h, output, p: SplitParams):
    """reference: feature_histogram.hpp:846-856 GetLeafGainGivenOutput."""
    sg = threshold_l1(sum_g, p.lambda_l1)
    return -(_round_fence(_f32(2.0, sg) * sg * output, p)
             + _round_fence((sum_h + p.lambda_l2) * output * output, p))


def leaf_gain(sum_g, sum_h, p: SplitParams, num_data, parent_output):
    """reference: feature_histogram.hpp:826-843 GetLeafGain."""
    out = calculate_leaf_output(sum_g, sum_h, p, num_data, parent_output)
    return leaf_gain_given_output(sum_g, sum_h, out, p)


def _directional_sums(hist_excl, leaf_sum_g, leaf_sum_h, leaf_cnt):
    """Cumulative left/right sums for every threshold, both directions.
    Threshold t means: left = bins <= t, right = bins > t; the accumulated
    side's hessian starts at kEpsilon (feature_histogram.hpp:882)."""
    csum = blocked_cumsum(hist_excl, 2)                     # [L, F, B, 3]
    total_excl = csum[:, :, -1:, :]
    fwd_left = csum
    rev_right = total_excl - csum
    eps = _f32(K_EPSILON, csum)
    lt = dict(
        fwd_left_g=fwd_left[..., 0], fwd_left_h=fwd_left[..., 1] + eps,
        fwd_left_c=fwd_left[..., 2],
        rev_right_g=rev_right[..., 0], rev_right_h=rev_right[..., 1] + eps,
        rev_right_c=rev_right[..., 2],
    )
    b = (leaf_sum_g[:, None, None], leaf_sum_h[:, None, None],
         leaf_cnt[:, None, None])
    lt["fwd_right_g"] = b[0] - lt["fwd_left_g"]
    lt["fwd_right_h"] = b[1] - lt["fwd_left_h"]
    lt["fwd_right_c"] = b[2] - lt["fwd_left_c"]
    lt["rev_left_g"] = b[0] - lt["rev_right_g"]
    lt["rev_left_h"] = b[1] - lt["rev_right_h"]
    lt["rev_left_c"] = b[2] - lt["rev_right_c"]
    return lt


# candidate-table channel layout ([..., CAND_CHANNELS] float32), the JAX
# package's: gain is the SHIFTED raw gain (gain - min_gain_shift,
# K_MIN_SCORE = invalid), threshold/is_rev as exact small-integer floats
CAND_CHANNELS = 12
CAND_GAIN, CAND_THR, CAND_REV = 0, 1, 2
CAND_LG, CAND_LH, CAND_LC = 3, 4, 5
CAND_RG, CAND_RH, CAND_RC = 6, 7, 8


def numerical_candidates(hist, leaf_sum_g, leaf_sum_h, leaf_cnt, leaf_output,
                         num_bins_f, missing_type_f, default_bin_f,
                         p: SplitParams) -> torch.Tensor:
    """Per-(leaf, feature) best numerical split candidate.

    hist: [P, F, B, 3] float32 planes (excluded bins zeroed here); leaf
    aggregates [P]; per-feature int tensors [F]. Returns [P, F, 12]."""
    P, F, B, _ = hist.shape
    dev = hist.device
    nb = num_bins_f.to(torch.int32)[None, :, None]
    bins = torch.arange(B, dtype=torch.int32, device=dev)[None, None, :]
    mode_a = (num_bins_f > 2) & (missing_type_f != MISSING_NONE)
    is_nan = missing_type_f == MISSING_NAN
    is_zero = missing_type_f == MISSING_ZERO
    dbin = default_bin_f.to(torch.int32)[None, :, None]

    excl = (((mode_a & is_nan)[None, :, None] & (bins == nb - 1))
            | ((mode_a & is_zero)[None, :, None] & (bins == dbin)))
    hist_excl = torch.where(excl[..., None], torch.zeros_like(hist), hist)

    s = _directional_sums(hist_excl, leaf_sum_g, leaf_sum_h, leaf_cnt)
    parent_out = leaf_output[:, None, None]

    def split_gain_dir(prefix):
        lg, lh, lc = (s[f"{prefix}_left_g"], s[f"{prefix}_left_h"],
                      s[f"{prefix}_left_c"])
        rg, rh, rc = (s[f"{prefix}_right_g"], s[f"{prefix}_right_h"],
                      s[f"{prefix}_right_c"])
        lo = calculate_leaf_output(lg, lh, p, lc, parent_out)
        ro = calculate_leaf_output(rg, rh, p, rc, parent_out)
        return (leaf_gain_given_output(lg, lh, lo, p)
                + leaf_gain_given_output(rg, rh, ro, p))

    gain_fwd = split_gain_dir("fwd")
    gain_rev = split_gain_dir("rev")
    min_gain_shift = (leaf_gain(leaf_sum_g, leaf_sum_h, p, leaf_cnt,
                                leaf_output)
                      + p.min_gain_to_split)[:, None, None]

    def constraint_mask(prefix):
        lh, lc = s[f"{prefix}_left_h"], s[f"{prefix}_left_c"]
        rh, rc = s[f"{prefix}_right_h"], s[f"{prefix}_right_c"]
        return ((lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                & (lh >= p.min_sum_hessian_in_leaf)
                & (rh >= p.min_sum_hessian_in_leaf))

    thr_ok_common = bins <= nb - 2
    fwd_ok = mode_a[None, :, None] & thr_ok_common
    rev_upper = nb - 2 - (mode_a & is_nan)[None, :, None].to(torch.int32)
    rev_ok = bins <= rev_upper
    zero_thr_skip = (mode_a & is_zero)[None, :, None] & (bins == dbin)
    fwd_ok = fwd_ok & ~zero_thr_skip
    rev_ok = rev_ok & ~zero_thr_skip

    valid_fwd = (constraint_mask("fwd") & fwd_ok
                 & (gain_fwd > min_gain_shift) & ~torch.isnan(gain_fwd))
    valid_rev = (constraint_mask("rev") & rev_ok
                 & (gain_rev > min_gain_shift) & ~torch.isnan(gain_rev))
    neg = torch.full_like(gain_fwd, K_MIN_SCORE)
    key_fwd = torch.where(valid_fwd, gain_fwd - min_gain_shift, neg)
    key_rev = torch.where(valid_rev, gain_rev - min_gain_shift, neg)

    # within-feature lexicographic reduction: reverse scan first keeps its
    # highest-threshold maximum, forward replaces only on strictly greater
    # gain (lowest threshold first)
    gains = torch.stack([key_rev, key_fwd], dim=2)          # [P, F, 2, B]
    bvec = torch.arange(B, dtype=torch.int64, device=dev)
    pref = torch.stack([2 * B + bvec, (B - 1) - bvec], 0)   # [2, B]
    flat = gains.reshape(P, F, 2 * B)
    best = flat.max(dim=2).values
    is_best = flat == best[..., None]
    pref_b = pref.reshape(1, 1, 2 * B).expand(P, F, 2 * B)
    bidx = torch.where(is_best, pref_b, torch.full_like(pref_b, -1)
                       ).argmax(dim=2)
    bdir = bidx // B                                        # 0=rev, 1=fwd
    bt = bidx % B

    def pick(rev_name, fwd_name):
        rv = torch.gather(s[rev_name], 2, bt[:, :, None])[..., 0]
        fv = torch.gather(s[fwd_name], 2, bt[:, :, None])[..., 0]
        return torch.where(bdir == 0, rv, fv)

    out = torch.zeros((P, F, CAND_CHANNELS), dtype=torch.float32, device=dev)
    out[:, :, CAND_GAIN] = best
    out[:, :, CAND_THR] = bt.to(torch.float32)
    out[:, :, CAND_REV] = (bdir == 0).to(torch.float32)
    out[:, :, CAND_LG] = pick("rev_left_g", "fwd_left_g")
    out[:, :, CAND_LH] = pick("rev_left_h", "fwd_left_h")
    out[:, :, CAND_LC] = pick("rev_left_c", "fwd_left_c")
    out[:, :, CAND_RG] = pick("rev_right_g", "fwd_right_g")
    out[:, :, CAND_RH] = pick("rev_right_h", "fwd_right_h")
    out[:, :, CAND_RC] = pick("rev_right_c", "fwd_right_c")
    return out


def candidates_to_splitinfo(cand, leaf_sum_g, leaf_sum_h, leaf_cnt,
                            leaf_output, leaf_depth, meta: FeatureMeta,
                            p: SplitParams, feature_mask,
                            max_depth: int = -1) -> SplitInfo:
    """Cross-feature argmax over a candidate table -> per-leaf SplitInfo:
    the feature_contri multiplier and feature/depth masks, then the
    lowest-index-wins argmax (the reference's in-order feature loop with a
    strict operator>). ``cand``: [P, F, 12]; ``feature_mask``: [P, F]."""
    P, F, _ = cand.shape
    dev = cand.device
    raw = cand[:, :, CAND_GAIN]
    valid = torch.isfinite(raw)
    key = raw * meta.penalty[None, :]
    fmask = feature_mask.to(torch.bool) & ~meta.is_categorical[None, :]
    depth_ok = (torch.ones((P,), dtype=torch.bool, device=dev)
                if max_depth <= 0 else (leaf_depth < max_depth))
    key = torch.where(valid & fmask & depth_ok[:, None], key,
                      torch.full_like(key, K_MIN_SCORE))
    best_gain = key.max(dim=1).values
    is_best = key == best_gain[:, None]
    fpref = ((F - 1) - torch.arange(F, device=dev))[None, :].expand(P, F)
    bf = torch.where(is_best, fpref, torch.full_like(fpref, -1)).argmax(dim=1)

    row = cand[torch.arange(P, device=dev), bf]              # [P, 12]
    bt = row[:, CAND_THR].to(torch.int32)
    bdir_rev = row[:, CAND_REV] > 0.5
    left_g, left_h, left_c = row[:, CAND_LG], row[:, CAND_LH], row[:, CAND_LC]
    right_g, right_h, right_c = (row[:, CAND_RG], row[:, CAND_RH],
                                 row[:, CAND_RC])
    left_out = calculate_leaf_output(left_g, left_h, p, left_c, leaf_output)
    right_out = calculate_leaf_output(right_g, right_h, p, right_c,
                                      leaf_output)
    mode_a = (meta.num_bins > 2) & (meta.missing_type != MISSING_NONE)
    nan_single = ((meta.missing_type == MISSING_NAN) & ~mode_a)[bf]
    return SplitInfo(
        gain=best_gain, feature=bf.to(torch.int32), threshold=bt,
        default_left=bdir_rev & ~nan_single,
        left_sum_g=left_g, left_sum_h=left_h, left_count=left_c,
        right_sum_g=right_g, right_sum_h=right_h, right_count=right_c,
        left_output=left_out, right_output=right_out)


def feature_meta_from_mappers(used_mappers, device="cpu") -> FeatureMeta:
    """FeatureMeta for the used (non-trivial) features, as the JAX
    package's Dataset._build_feature_meta builds it for numerical data."""
    nb = np.array([m.num_bin for m in used_mappers] or [2], np.int32)
    mt = np.array([m.missing_type for m in used_mappers] or [0], np.int32)
    db = np.array([m.default_bin for m in used_mappers] or [0], np.int32)
    f = len(nb)
    return FeatureMeta(
        num_bins=torch.as_tensor(nb, device=device),
        missing_type=torch.as_tensor(mt, device=device),
        default_bin=torch.as_tensor(db, device=device),
        is_categorical=torch.zeros((f,), dtype=torch.bool, device=device),
        monotone=torch.zeros((f,), dtype=torch.int8, device=device),
        penalty=torch.ones((f,), dtype=torch.float32, device=device))


def missing_bin_of(meta: FeatureMeta) -> np.ndarray:
    """[F] int32 bin routed by a split's default direction, or -1 (the JAX
    package's Dataset._missing_bin)."""
    nb = meta.num_bins.cpu().numpy()
    mt = meta.missing_type.cpu().numpy()
    db = meta.default_bin.cpu().numpy()
    mode_a = (nb > 2) & (mt != MISSING_NONE)
    return np.where(mode_a & (mt == MISSING_NAN), nb - 1,
                    np.where(mode_a & (mt == MISSING_ZERO), db, -1)
                    ).astype(np.int32)
