"""Best-split search over histogram planes, in PyTorch.

The port of lightgbm_tpu's ``ops/split.py`` for numerical and categorical
features: every (leaf, feature, direction, threshold) candidate is
evaluated at once with cumulative sums over the bin axis, and a masked
lexicographic argmax reproduces the reference's first-better-wins order
(reference: src/treelearner/feature_histogram.hpp:858-1050 numerical,
:277-515 categorical). Two entry points share the numerical scan:
``numerical_candidates`` (the fused split epilogue's per-feature table) and
``find_best_splits`` (the classic search over the resident ``[L, F, B, 3]``
planes, numerical and categorical). The arithmetic is the JAX package's,
operation for operation, in float32 -- or in float64 on the f64 planes of
``gpu_use_dp``, where the JAX package's Python constants are float64
(``_weak``) and only the gain is cast to float32 -- so candidate tables,
``SplitInfo`` and categorical bitsets come out bit-identical on identical
planes. Four details make that hold:

- ``_round_fence`` is the identity here. The JAX package fences products
  before an add because XLA contracts a multiply feeding an add into one
  FMA; eager PyTorch never contracts, so every product already rounds on
  its own. The call sites are kept so the two files read side by side.
- ``_sign`` follows XLA's ``sign`` (±0 stays ±0), which ``torch.sign``
  does not, so a zero gradient sum keeps the sign of zero XLA gives it.
- The bin-axis cumulative sum runs in XLA's block order
  (``utils.ordered.blocked_cumsum``).
- The categorical sort by ``g / (h + cat_smooth)`` is stable, as
  ``jnp.argsort`` is, so ties keep bin order and give the same bitset.

EFB bundles (``BundleMeta``) make the scan segment-relative on a bundle
column, with per-bin direction masks and tie-break tables that reproduce
each member feature's unbundled scan; CEGB's per-(leaf, feature) cost
(``gain_adjust``) comes off the keyed gains of both searches.

The split constraints live here too: monotone bounds (a clip of each
candidate's outputs with XLA's max and min, ``clip``, and gain 0 for a
candidate that breaks its feature's direction), the monotone depth
penalty and feature_contri on the keyed gains, and extra_trees' one
random threshold per (leaf, feature).

The CUDA split epilogue (``csrc/split_epilogue.cu``) computes
``numerical_candidates`` with the same operation order, its monotone
mode included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..binning import (BIN_TYPE_CATEGORICAL, MISSING_NAN, MISSING_NONE,
                       MISSING_ZERO)
from ..objectives import exp2_f32
from ..utils.ordered import blocked_cumsum

K_EPSILON = 1e-15          # reference: include/LightGBM/meta.h kEpsilon
K_MIN_SCORE = float("-inf")  # reference: kMinScore


class FeatureMeta(NamedTuple):
    """Per-feature metadata tensors, all shape [F]."""
    num_bins: torch.Tensor        # int32, total bins incl. NaN bin
    missing_type: torch.Tensor    # int32, MISSING_{NONE,ZERO,NAN}
    default_bin: torch.Tensor     # int32, bin of value 0.0
    is_categorical: torch.Tensor  # bool
    monotone: torch.Tensor        # int8, -1/0/+1 (0 = unconstrained)
    penalty: torch.Tensor         # float32 feature_contri gain multiplier

    def to(self, device) -> "FeatureMeta":
        return FeatureMeta(*(t.to(device) for t in self))


# the numerical scan reads the first seven fields (the packed ``pvec``)
_NUM_FIELDS = 7
_INT_FIELDS = ("max_cat_threshold", "max_cat_to_onehot")


class SplitParams(NamedTuple):
    """The split hyperparameters as scalar tensors: float32, but int32 for
    the two categorical counts (as the JAX package holds them). The scan
    reads the first seven; ``monotone_penalty`` enters the keyed gains
    after it."""
    lambda_l1: torch.Tensor
    lambda_l2: torch.Tensor
    max_delta_step: torch.Tensor
    path_smooth: torch.Tensor
    min_data_in_leaf: torch.Tensor
    min_sum_hessian_in_leaf: torch.Tensor
    min_gain_to_split: torch.Tensor
    cat_l2: torch.Tensor
    cat_smooth: torch.Tensor
    max_cat_threshold: torch.Tensor
    min_data_per_group: torch.Tensor
    max_cat_to_onehot: torch.Tensor
    monotone_penalty: torch.Tensor

    @classmethod
    def from_config(cls, config, device="cpu") -> "SplitParams":
        return cls(*(
            torch.tensor(int(getattr(config, n)), dtype=torch.int32,
                         device=device) if n in _INT_FIELDS
            else torch.tensor(float(getattr(config, n)), dtype=torch.float32,
                              device=device)
            for n in cls._fields))

    @classmethod
    def from_packed(cls, pv: torch.Tensor) -> "SplitParams":
        """Inverse of ``ops.cuda_hist.pack_scan_params`` (the numerical
        fields; the others, which the scan never reads, are 0)."""
        zero = torch.zeros((), dtype=torch.float32, device=pv.device)
        return cls(*(pv[i] for i in range(_NUM_FIELDS)),
                   *(zero.to(torch.int32) if n in _INT_FIELDS else zero
                     for n in cls._fields[_NUM_FIELDS:]))

    def to(self, device) -> "SplitParams":
        return SplitParams(*(t.to(device) for t in self))


class BundleMeta(NamedTuple):
    """Per-(column, bin) EFB segment structure (``bundling.py`` layout),
    built on the host by ``Dataset._build_feature_meta_bundled``. For a
    bundle column, bin ``b`` inside member ``f``'s range has
    ``seg_lo``/``seg_hi`` = that range's first/last bin; bundle bin 0 has
    lo = hi = 0. Regular columns: lo = 0, hi = num_bin - 1, which makes the
    segment-relative sums the plain ones. ``fwd_ok``/``rev_ok`` restrict a
    bundle column's threshold candidates per scan direction to the member
    feature's unbundled candidate set; ``pref_fwd``/``pref_rev`` are the
    tie-break keys (higher wins among equal keys), ordered by the
    candidate's original feature, then by its own scan order."""
    seg_lo: torch.Tensor     # int32 [F, B]
    seg_hi: torch.Tensor     # int32 [F, B]
    is_bundle: torch.Tensor  # bool [F]
    fwd_ok: torch.Tensor     # bool [F, B]
    rev_ok: torch.Tensor     # bool [F, B]
    pref_fwd: torch.Tensor   # int64 [F, B]
    pref_rev: torch.Tensor   # int64 [F, B]

    def to(self, device) -> "BundleMeta":
        return BundleMeta(*(t.to(device) for t in self))


class SplitInfo(NamedTuple):
    """Per-leaf best split, struct-of-arrays of shape [L] (reference:
    src/treelearner/split_info.hpp:22-90). The fields are tensors, or
    numpy arrays where the grower holds them on the host."""
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
    is_cat: torch.Tensor        # bool, categorical (bitset) split
    cat_bitset: torch.Tensor    # int64 [L, cat_words] 32-bit words of the
    #                             left side's bins (0 when numerical)
    seg_lo: torch.Tensor        # int32 EFB bundle segment start (-1 regular)
    seg_hi: torch.Tensor        # int32 EFB bundle segment end (inclusive)


# the bitset width a candidate table's SplitInfo gets when its caller
# names none (the JAX package's default: 256 bins); the searches over
# planes take theirs from the planes' B (``cat_words_for``)
CAT_BITSET_WORDS = 8


def cat_words_for(num_bins: int) -> int:
    """Bitset words a split over ``num_bins`` bins needs (at least one)."""
    return max(1, -(-num_bins // 32))


def _weak(v, like: torch.Tensor) -> torch.Tensor:
    """The Python constant ``v`` as JAX's weakly typed scalar meets
    ``like``: float64 beside float64 (the f64 planes of ``gpu_use_dp``),
    else float32."""
    dt = torch.float64 if like.dtype == torch.float64 else torch.float32
    return torch.tensor(v, dtype=dt, device=like.device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """XLA's sign: ±1, ±0 for ±0, NaN for NaN."""
    keep = (x == 0) | torch.isnan(x)
    return torch.where(keep, x, torch.copysign(torch.ones_like(x), x))


def ieee_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's float maximum (``jnp.maximum``): NaN when either is NaN, and
    +0 of two zeros of either sign, where ``torch.maximum`` returns its
    first argument of two equal zeros."""
    out = torch.where(a > b, a, b)
    out = torch.where((a == b) & (a == 0), a + b, out)
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(out, float("nan")), out)


def ieee_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's float minimum (``jnp.minimum``): NaN when either is NaN, and
    -0 of two zeros of either sign."""
    out = torch.where(a < b, a, b)
    out = torch.where((a == b) & (a == 0), -((-a) + (-b)), out)
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(out, float("nan")), out)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` as XLA lowers it: ``minimum(hi,
    maximum(lo, x))`` (``torch.clamp`` differs on signed zeros)."""
    return ieee_min(hi, ieee_max(lo, x))


def threshold_l1(s: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """reference: feature_histogram.hpp:737-741 ThresholdL1."""
    return _sign(s) * torch.maximum(torch.abs(s) - l1, torch.zeros_like(s))


def _round_fence(x: torch.Tensor, p: SplitParams) -> torch.Tensor:
    """Identity: eager PyTorch never contracts a multiply into an add (see
    the module docstring); kept so the formulas read as in the JAX file."""
    return x


def calculate_leaf_output(sum_g, sum_h, p: SplitParams, num_data,
                          parent_output, lambda_l2=None):
    """reference: feature_histogram.hpp:743-764 CalculateSplittedLeafOutput.
    ``lambda_l2`` overrides ``p.lambda_l2`` (the categorical search's
    ``lambda_l2 + cat_l2``)."""
    l2 = p.lambda_l2 if lambda_l2 is None else lambda_l2
    ret = -threshold_l1(sum_g, p.lambda_l1) / (sum_h + l2)
    ret = torch.where((p.max_delta_step > 0)
                      & (torch.abs(ret) > p.max_delta_step),
                      _sign(ret) * p.max_delta_step, ret)
    use_smooth = p.path_smooth > _weak(K_EPSILON, p.path_smooth)
    one = _weak(1.0, ret)
    n_over_s = num_data / torch.where(use_smooth, p.path_smooth, one)
    smoothed = (_round_fence(ret * (n_over_s / (n_over_s + one)), p)
                + parent_output / (n_over_s + one))
    return torch.where(use_smooth, smoothed, ret)


def leaf_gain_given_output(sum_g, sum_h, output, p: SplitParams,
                           lambda_l2=None):
    """reference: feature_histogram.hpp:846-856 GetLeafGainGivenOutput."""
    l2 = p.lambda_l2 if lambda_l2 is None else lambda_l2
    sg = threshold_l1(sum_g, p.lambda_l1)
    return -(_round_fence(_weak(2.0, sg) * sg * output, p)
             + _round_fence((sum_h + l2) * output * output, p))


def leaf_gain(sum_g, sum_h, p: SplitParams, num_data, parent_output):
    """reference: feature_histogram.hpp:826-843 GetLeafGain."""
    out = calculate_leaf_output(sum_g, sum_h, p, num_data, parent_output)
    return leaf_gain_given_output(sum_g, sum_h, out, p)


def _leaf_gain_nosmooth(sum_g, sum_h, p: SplitParams, lambda_l2):
    """Leaf gain with no path smoothing (the categorical min_gain_shift
    when path_smooth is off, feature_histogram.hpp:296-302)."""
    sg = threshold_l1(sum_g, p.lambda_l1)
    out = -sg / (sum_h + lambda_l2)
    out = torch.where((p.max_delta_step > 0)
                      & (torch.abs(out) > p.max_delta_step),
                      _sign(out) * p.max_delta_step, out)
    return -(_round_fence(_weak(2.0, sg) * sg * out, p)
             + _round_fence((sum_h + lambda_l2) * out * out, p))


def _directional_sums(hist_excl, leaf_sum_g, leaf_sum_h, leaf_cnt,
                      bundle: "BundleMeta | None" = None):
    """Cumulative left/right sums for every threshold, both directions.
    Threshold t means: left = bins <= t, right = bins > t; the accumulated
    side's hessian starts at kEpsilon (feature_histogram.hpp:882). With
    ``bundle`` the accumulated side is segment-relative: inside member f's
    range of a bundle column the left mass at t is csum[t] -
    csum[seg_lo - 1] and the reverse scan's right mass csum[seg_hi] -
    csum[t]; the complement side comes from the leaf totals, which puts
    every row outside the segment on the scan's default side (the
    reference's FixHistogram)."""
    csum = blocked_cumsum(hist_excl, 2)                     # [L, F, B, 3]
    if bundle is None:
        fwd_left = csum
        rev_right = csum[:, :, -1:, :] - csum
    else:
        lo = bundle.seg_lo.long()[None, :, :, None]          # [1, F, B, 1]
        hi = bundle.seg_hi.long()[None, :, :, None]
        lo_b = (lo - 1).clamp(min=0).expand(csum.shape)
        csum_lo = torch.where(lo > 0, torch.gather(csum, 2, lo_b),
                              torch.zeros((), dtype=csum.dtype,
                                          device=csum.device))
        csum_hi = torch.gather(csum, 2, hi.expand(csum.shape))
        fwd_left = csum - csum_lo
        rev_right = csum_hi - csum
    eps = _weak(K_EPSILON, csum)
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


def _numerical_scan(hist, leaf_sum_g, leaf_sum_h, leaf_cnt, leaf_output,
                    num_bins_f, missing_type_f, default_bin_f,
                    p: SplitParams, monotone_f=None, bounds=None,
                    rand_bin=None, bundle=None):
    """Every (leaf, feature, direction, threshold) numerical candidate:
    the directional sums and the SHIFTED gains (gain - min_gain_shift,
    K_MIN_SCORE where invalid) of the reverse and forward scans, each
    [P, F, B]. The shared core of ``numerical_candidates`` (the fused
    epilogue) and ``find_best_splits`` (the classic search).

    ``bounds`` (monotone constraints): (left min, left max, right min,
    right max), each broadcastable to [P, F, B]; every candidate's child
    outputs are clipped to them before its gain, and a candidate whose
    clipped outputs break its feature's direction ``monotone_f`` [F]
    gets gain 0 (GetSplitGains' USE_MC, feature_histogram.hpp:766-824).
    ``rand_bin`` [P, F] (extra_trees): the one threshold each (leaf,
    feature) may split at. ``bundle`` (EFB): segment-relative sums and
    the bundle columns' direction masks."""
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

    s = _directional_sums(hist_excl, leaf_sum_g, leaf_sum_h, leaf_cnt,
                          bundle)
    parent_out = leaf_output[:, None, None]

    def split_gain_dir(prefix):
        lg, lh, lc = (s[f"{prefix}_left_g"], s[f"{prefix}_left_h"],
                      s[f"{prefix}_left_c"])
        rg, rh, rc = (s[f"{prefix}_right_g"], s[f"{prefix}_right_h"],
                      s[f"{prefix}_right_c"])
        lo = calculate_leaf_output(lg, lh, p, lc, parent_out)
        ro = calculate_leaf_output(rg, rh, p, rc, parent_out)
        if bounds is not None:
            lo = clip(lo, bounds[0], bounds[1])
            ro = clip(ro, bounds[2], bounds[3])
        gain = (leaf_gain_given_output(lg, lh, lo, p)
                + leaf_gain_given_output(rg, rh, ro, p))
        if bounds is not None:
            mono = monotone_f.to(torch.int32)[None, :, None]
            viol = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
            gain = torch.where(viol, torch.zeros_like(gain), gain)
        return gain

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
    if bundle is not None:
        isb = bundle.is_bundle[None, :, None]
        fwd_ok = torch.where(isb, bundle.fwd_ok[None], fwd_ok)
        rev_ok = torch.where(isb, bundle.rev_ok[None], rev_ok)
    if rand_bin is not None:
        rb = rand_bin.to(torch.int32)[:, :, None]
        fwd_ok = fwd_ok & (bins == rb)
        rev_ok = rev_ok & (bins == rb)

    valid_fwd = (constraint_mask("fwd") & fwd_ok
                 & (gain_fwd > min_gain_shift) & ~torch.isnan(gain_fwd))
    valid_rev = (constraint_mask("rev") & rev_ok
                 & (gain_rev > min_gain_shift) & ~torch.isnan(gain_rev))
    neg = torch.full_like(gain_fwd, K_MIN_SCORE)
    key_fwd = torch.where(valid_fwd, gain_fwd - min_gain_shift, neg)
    key_rev = torch.where(valid_rev, gain_rev - min_gain_shift, neg)
    return s, key_rev, key_fwd


def numerical_candidates(hist, leaf_sum_g, leaf_sum_h, leaf_cnt, leaf_output,
                         num_bins_f, missing_type_f, default_bin_f,
                         p: SplitParams, *, monotone_f=None,
                         with_monotone: bool = False, leaf_min=None,
                         leaf_max=None) -> torch.Tensor:
    """Per-(leaf, feature) best numerical split candidate.

    hist: [P, F, B, 3] float32 planes (excluded bins zeroed here); leaf
    aggregates [P]; per-feature int tensors [F]. ``with_monotone`` (the
    basic monotone mode): each slot's candidates clipped to its
    [``leaf_min``, ``leaf_max``] [P], and those breaking ``monotone_f``
    [F] at gain 0. Returns [P, F, 12]."""
    P, F, B, _ = hist.shape
    dev = hist.device
    bounds = None
    if with_monotone:
        lm, lx = leaf_min[:, None, None], leaf_max[:, None, None]
        bounds = (lm, lx, lm, lx)
    s, key_rev, key_fwd = _numerical_scan(
        hist, leaf_sum_g, leaf_sum_h, leaf_cnt, leaf_output, num_bins_f,
        missing_type_f, default_bin_f, p, monotone_f, bounds)

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
                            max_depth: int = -1,
                            cat_words: int = CAT_BITSET_WORDS,
                            with_monotone: bool = False,
                            leaf_min=None, leaf_max=None) -> SplitInfo:
    """Cross-feature argmax over a candidate table -> per-leaf SplitInfo:
    the feature_contri multiplier, the monotone depth penalty and the
    feature/depth masks, in ``find_best_splits``' order, then the
    lowest-index-wins argmax (the reference's in-order feature loop with a
    strict operator>). ``cand``: [P, F, 12]; ``feature_mask``: [P, F].
    Both transforms commute with the scan's within-feature pick only for
    a positive multiplier, so a non-positive feature_contri keeps the
    classic search (``GBDT._split_fusion_on``). ``with_monotone``: the
    chosen children's outputs are clipped to [``leaf_min``,
    ``leaf_max``] [P]."""
    P, F, _ = cand.shape
    dev = cand.device
    raw = cand[:, :, CAND_GAIN]
    valid = torch.isfinite(raw)
    key = _mono_penalized(raw * meta.penalty[None, :], leaf_depth, meta, p)
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
    if with_monotone:
        left_out = clip(left_out, leaf_min, leaf_max)
        right_out = clip(right_out, leaf_min, leaf_max)
    mode_a = (meta.num_bins > 2) & (meta.missing_type != MISSING_NONE)
    nan_single = ((meta.missing_type == MISSING_NAN) & ~mode_a)[bf]
    return SplitInfo(
        gain=best_gain, feature=bf.to(torch.int32), threshold=bt,
        default_left=bdir_rev & ~nan_single,
        left_sum_g=left_g, left_sum_h=left_h, left_count=left_c,
        right_sum_g=right_g, right_sum_h=right_h, right_count=right_c,
        left_output=left_out, right_output=right_out,
        is_cat=torch.zeros((P,), dtype=torch.bool, device=dev),
        cat_bitset=torch.zeros((P, cat_words), dtype=torch.int64,
                               device=dev),
        seg_lo=torch.full((P,), -1, dtype=torch.int32, device=dev),
        seg_hi=torch.full((P,), -1, dtype=torch.int32, device=dev))


def monotone_split_penalty(leaf_depth, p: SplitParams) -> torch.Tensor:
    """Depth-decaying gain multiplier [L] for splits on monotone features
    (reference: monotone_constraints.hpp:355-364), with ``jnp.exp2`` as
    XLA:CPU computes it."""
    d = leaf_depth.to(torch.float32)
    pen = p.monotone_penalty.to(torch.float32)
    eps = _weak(K_EPSILON, d)
    small = (1.0 - pen / exp2_f32(d)) + eps
    large = (1.0 - exp2_f32(pen - 1.0 - d)) + eps
    out = torch.where(pen <= 1.0, small, large)
    out = torch.where(pen >= d + 1.0, eps, out)
    return torch.where(pen > 0.0, out, torch.ones_like(out))


def _mono_penalized(key, leaf_depth, meta: FeatureMeta, p: SplitParams):
    """``key`` [L, F, ...] times the monotone depth penalty where the
    feature is monotone (the JAX package's ``where(is_mono, key * pen,
    key)``; with no monotone feature that is the identity)."""
    if not bool(meta.monotone.any()):
        return key
    pen = monotone_split_penalty(leaf_depth, p)
    pen = pen.reshape((-1,) + (1,) * (key.dim() - 1))
    is_mono = (meta.monotone != 0).reshape((1, -1) + (1,) * (key.dim() - 2))
    return torch.where(is_mono, key * pen, key)


def find_best_cat_splits(hist, leaf_sum_g, leaf_sum_h, leaf_cnt, leaf_output,
                         leaf_depth, meta: FeatureMeta, p: SplitParams,
                         feature_mask, max_depth: int = -1,
                         cat_words: Optional[int] = None, gain_adjust=None):
    """Best categorical split per leaf over all categorical features
    (reference: feature_histogram.hpp:277-515
    FindBestThresholdCategoricalInner). Per feature, one of two modes:

    - one-hot (num_bin <= max_cat_to_onehot): each bin t in [1, nb) is a
      one-vs-rest candidate, with plain lambda_l2;
    - sorted many-vs-many: the bins holding >= cat_smooth rows, sorted by
      g / (h + cat_smooth); a candidate takes the first i+1 sorted bins
      from either end, with l2 + cat_l2, the min_data_per_group group
      counter and the max_cat_threshold cap.

    All candidates are evaluated at once as [L, F, 3, B] gains (one-hot,
    dir +1, dir -1) and a lexicographic argmax keeps the reference's
    first-better-wins order. Bin 0 is the other/NaN bin and never goes
    left. Returns (gain [L], feature [L], left sums g/h/c [L], bitset
    [L, cat_words] int64 words, the l2 of the chosen mode [L])."""
    L, F, B, _ = hist.shape
    dev = hist.device
    cat_words = cat_words_for(B) if cat_words is None else cat_words
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    nb = meta.num_bins.to(torch.int32)[None, :]                    # [1, F]
    bins = torch.arange(B, dtype=torch.int32, device=dev)[None, None, :]
    in_range = (bins >= 1) & (bins < nb[:, :, None])
    G, H, C = leaf_sum_g[:, None], leaf_sum_h[:, None], leaf_cnt[:, None]
    parent_out = leaf_output[:, None, None]
    eps = _weak(K_EPSILON, hist)
    neg_inf = _weak(K_MIN_SCORE, hist)
    zero = torch.zeros((), dtype=hist.dtype, device=dev)

    use_onehot = (meta.num_bins.to(torch.int32)
                  <= p.max_cat_to_onehot)[None, :]                 # [1, F]
    l2_sorted = p.lambda_l2 + p.cat_l2

    # min_gain_shift (feature_histogram.hpp:291-305): with smoothing the
    # parent's actual output, otherwise plain-l2 gain without smoothing
    use_smooth = p.path_smooth > eps
    shift_smooth = leaf_gain_given_output(leaf_sum_g, leaf_sum_h,
                                          leaf_output, p)
    shift_plain = _leaf_gain_nosmooth(leaf_sum_g, leaf_sum_h, p, p.lambda_l2)
    min_gain_shift = (torch.where(use_smooth, shift_smooth, shift_plain)
                      + p.min_gain_to_split)[:, None, None]

    def split_gain(lg, lh, lc, l2):
        rg, rh, rc = (G[:, :, None] - lg, H[:, :, None] - lh,
                      C[:, :, None] - lc)
        lo = calculate_leaf_output(lg, lh, p, lc, parent_out, l2)
        ro = calculate_leaf_output(rg, rh, p, rc, parent_out, l2)
        return (leaf_gain_given_output(lg, lh, lo, p, l2)
                + leaf_gain_given_output(rg, rh, ro, p, l2))

    # ---- one-hot candidates: left = the single bin t
    oh_lg, oh_lh, oh_lc = g, h + eps, c
    oh_gain = split_gain(oh_lg, oh_lh, oh_lc, p.lambda_l2)
    oh_ok = (in_range
             & (c >= p.min_data_in_leaf) & (h >= p.min_sum_hessian_in_leaf)
             & (C[:, :, None] - c >= p.min_data_in_leaf)
             & (H[:, :, None] - h - eps >= p.min_sum_hessian_in_leaf))

    # ---- sorted candidates (a stable sort, as jnp.argsort's)
    valid = in_range & (c >= p.cat_smooth)
    ratio = torch.where(valid, g / (h + p.cat_smooth),
                        torch.full_like(g, float("inf")))
    order = torch.sort(ratio, dim=2, stable=True).indices
    sg = torch.gather(torch.where(valid, g, zero), 2, order)
    sh = torch.gather(torch.where(valid, h, zero), 2, order)
    sc = torch.gather(torch.where(valid, c, zero), 2, order)
    csum_g = blocked_cumsum(sg, 2)
    csum_h = blocked_cumsum(sh, 2)
    csum_c = blocked_cumsum(sc, 2)
    used_bin = valid.sum(dim=2).to(torch.int32)                    # [L, F]
    max_num_cat = torch.minimum(p.max_cat_threshold,
                                torch.div(used_bin + 1, 2,
                                          rounding_mode="floor"))

    idx = bins
    # dir +1: left = the first i+1 sorted bins
    fw_lg, fw_lh, fw_lc = csum_g, csum_h + eps, csum_c
    # dir -1: left = the last i+1 valid sorted bins
    j = used_bin[:, :, None] - 2 - idx
    jc = j.clamp(0, B - 1).long()

    def back(csum):
        tot = csum[:, :, -1:]
        return tot - torch.where(j >= 0, torch.gather(csum, 2, jc), zero)

    bw_lg, bw_lh, bw_lc = back(csum_g), back(csum_h) + eps, back(csum_c)
    cand_ok_base = ((idx < used_bin[:, :, None])
                    & (idx < max_num_cat[:, :, None]))

    def sorted_guards(lh_, lc_):
        rc = C[:, :, None] - lc_
        rh = H[:, :, None] - lh_
        return ((lc_ >= p.min_data_in_leaf)
                & (lh_ >= p.min_sum_hessian_in_leaf)
                & (rc >= p.min_data_in_leaf) & (rc >= p.min_data_per_group)
                & (rh >= p.min_sum_hessian_in_leaf))

    # the group counter (feature_histogram.hpp:443-447) accumulates along
    # the scan and resets when a candidate is emitted: a recurrence over
    # the bin axis with [L, F] lanes. No candidate lies at or past
    # max_cat_threshold, so the recurrence stops there.
    scan_len = min(B, max(int(p.max_cat_threshold), 0))

    def group_scan(per_bin_cnt, eligible):
        acc = torch.zeros(per_bin_cnt.shape[:2], dtype=hist.dtype,
                          device=dev)
        emits = torch.zeros_like(eligible)
        for i in range(scan_len):
            acc = acc + per_bin_cnt[:, :, i]
            emit = eligible[:, :, i] & (acc >= p.min_data_per_group)
            emits[:, :, i] = emit
            acc = torch.where(emit, zero, acc)
        return emits

    fw_elig = cand_ok_base & sorted_guards(fw_lh, fw_lc)
    bw_elig = cand_ok_base & sorted_guards(bw_lh, bw_lc)
    bw_cnt = torch.where(j + 1 >= 0,
                         torch.gather(sc, 2, (j + 1).clamp(0, B - 1).long()),
                         zero)
    fw_ok = group_scan(sc, fw_elig)
    bw_ok = group_scan(bw_cnt, bw_elig)
    fw_gain = split_gain(fw_lg, fw_lh, fw_lc, l2_sorted)
    bw_gain = split_gain(bw_lg, bw_lh, bw_lc, l2_sorted)

    # ---- [L, F, 3, B]: mode 0 one-hot, 1 dir +1, 2 dir -1
    fmask = feature_mask
    if fmask.dim() == 1:
        fmask = fmask[None, :]
    base_ok = (fmask.to(torch.bool) & meta.is_categorical)[:, :, None]
    if max_depth > 0:
        base_ok = base_ok & (leaf_depth < max_depth)[:, None, None]
    oh_val = oh_ok & base_ok & use_onehot[:, :, None]
    so_val = base_ok & ~use_onehot[:, :, None]
    contri = meta.penalty[None, :, None]

    def keyed(gain, ok):
        key = (gain - min_gain_shift) * contri
        if gain_adjust is not None:
            key = key - gain_adjust[:, :, None]
        return torch.where(ok, key, neg_inf)

    gains = torch.stack([
        keyed(oh_gain, oh_val & (oh_gain > min_gain_shift)),
        keyed(fw_gain, so_val & fw_ok & (fw_gain > min_gain_shift)),
        keyed(bw_gain, so_val & bw_ok & (bw_gain > min_gain_shift)),
    ], dim=2)                                                      # [L,F,3,B]

    # lexicographic argmax: features in index order, then evaluation order
    # (one-hot t asc | dir +1 i asc | dir -1 i asc), strict-greater wins
    farange = torch.arange(F, dtype=torch.int64, device=dev)[None, :, None,
                                                             None]
    slot_pref = torch.tensor([3 * B, 2 * B, B], dtype=torch.int64,
                             device=dev)[None, None, :, None]
    pref = (((F - 1) - farange) * (8 * B) + slot_pref
            - idx.long()[:, :, None, :])                           # [1,F,3,B]
    flat = gains.reshape(L, -1)
    best_gain = flat.max(dim=1).values
    is_best = flat == best_gain[:, None]
    pref_f = pref.expand(L, F, 3, B).reshape(L, -1)
    best_idx = torch.where(is_best, pref_f,
                           torch.full_like(pref_f, -1)).argmax(dim=1)
    bf = torch.div(best_idx, 3 * B, rounding_mode="floor")
    rem = best_idx % (3 * B)
    bmode = torch.div(rem, B, rounding_mode="floor")
    bi = rem % B
    li = torch.arange(L, device=dev)

    def pick3(a0, a1, a2):
        return torch.where(bmode == 0, a0[li, bf, bi],
                           torch.where(bmode == 1, a1[li, bf, bi],
                                       a2[li, bf, bi]))

    left_g = pick3(oh_lg, fw_lg, bw_lg)
    left_h = pick3(oh_lh, fw_lh, bw_lh)
    left_c = pick3(oh_lc, fw_lc, bw_lc)

    # ---- the chosen candidate's membership bitset over bins
    rank = torch.argsort(order[li, bf], dim=1)                     # bin -> pos
    ub_rows = used_bin[li, bf][:, None]
    bins_row = torch.arange(B, device=dev)[None, :]
    bic = bi[:, None]
    member = torch.where(
        (bmode == 0)[:, None], bins_row == bic,
        torch.where((bmode == 1)[:, None], rank <= bic,
                    (rank >= ub_rows - 1 - bic) & (rank < ub_rows)))
    member = member & (bins_row >= 1) & (bins_row < meta.num_bins[bf][:, None])
    nwords = -(-B // 32)
    assert nwords <= cat_words, (f"bitset width {nwords} exceeds "
                                 f"cat_words={cat_words}")
    mw = torch.zeros((L, cat_words * 32), dtype=torch.int64, device=dev)
    mw[:, :B] = member.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = (mw.reshape(L, cat_words, 32) << shifts).sum(dim=2)
    l2_out = torch.where(use_onehot[0, bf], p.lambda_l2, l2_sorted)
    return best_gain.to(torch.float32), bf.to(torch.int32), left_g, left_h, \
        left_c, words, l2_out


def find_best_splits(hist, leaf_sum_g, leaf_sum_h, leaf_cnt, leaf_output,
                     leaf_depth, meta: FeatureMeta, p: SplitParams,
                     feature_mask, max_depth: int = -1,
                     with_categorical: bool = False,
                     cat_words: Optional[int] = None,
                     leaf_min=None, leaf_max=None, adv_bounds=None,
                     gain_adjust=None, rand_bin=None,
                     bundle: Optional[BundleMeta] = None,
                     return_feature_gains: bool = False):
    """Best split per leaf over the resident planes (the classic search).

    hist: [L, F, B, 3] (grad, hess, count); leaf aggregates [L];
    feature_mask [F] or [L, F] (column sampling, by-node sampling,
    interaction constraints); max_depth: leaves at max_depth get gain
    -inf. Numerical candidates from the shared scan go through one
    lexicographic argmax over (feature, direction, threshold); with
    ``with_categorical`` the categorical best competes per leaf, ties to
    the lower feature index. The keyed gains carry feature_contri
    (``meta.penalty``) and the monotone depth penalty.

    Monotone constraints: ``leaf_min``/``leaf_max`` [L] clip every
    candidate's child outputs and reject (gain 0) those that break the
    feature's direction; ``adv_bounds`` (the advanced mode's per-threshold
    child bounds, (lmin, lmax, rmin, rmax) [L, F, B]) replace that clip in
    the numerical search. ``rand_bin`` [L, F] (extra_trees): the one
    threshold a (leaf, feature) may take. ``gain_adjust`` [L, F] (CEGB's
    cost, cost_effective_gradient_boosting.hpp DeltaGain) comes off the
    keyed gains after feature_contri and before the monotone penalty.
    ``bundle`` (EFB): the segment-relative scan of the bundle columns, and
    their tie-break tables, so ties resolve as the unbundled run's; the
    chosen bundle split's segment is ``seg_lo``/``seg_hi``. ``cat_words``:
    the bitset's words, by default ``cat_words_for(B)``.
    ``return_feature_gains``: also return each (leaf, feature)'s best keyed
    numerical gain [L, F] (``per_feature_best_gain_key``, what the voting
    learner votes on)."""
    L, F, B, _ = hist.shape
    dev = hist.device
    cat_words = cat_words_for(B) if cat_words is None else cat_words
    use_mc = leaf_min is not None or adv_bounds is not None
    bounds = adv_bounds
    if bounds is None and leaf_min is not None:
        lm, lx = leaf_min[:, None, None], leaf_max[:, None, None]
        bounds = (lm, lx, lm, lx)
    s, key_rev, key_fwd = _numerical_scan(
        hist, leaf_sum_g, leaf_sum_h, leaf_cnt, leaf_output, meta.num_bins,
        meta.missing_type, meta.default_bin, p, meta.monotone, bounds,
        rand_bin, bundle)
    fmask = feature_mask
    if fmask.dim() == 1:
        fmask = fmask[None, :]
    fmask = (fmask.to(torch.bool) & ~meta.is_categorical)[..., None]
    depth_ok = (torch.ones((L,), dtype=torch.bool, device=dev)
                if max_depth <= 0 else (leaf_depth < max_depth))
    base_ok = fmask & depth_ok[:, None, None]
    contri = meta.penalty[None, :, None]
    neg = _weak(K_MIN_SCORE, hist)

    def keyed(key):
        adj = key * contri
        if gain_adjust is not None:
            adj = adj - gain_adjust[:, :, None]
        return torch.where(base_ok & (key > neg),
                           _mono_penalized(adj, leaf_depth, meta, p), neg)

    key_fwd, key_rev = keyed(key_fwd), keyed(key_rev)

    # reverse scan first keeps its highest-threshold maximum, forward
    # replaces only on strictly greater gain; lowest feature index wins
    gains = torch.stack([key_rev, key_fwd], dim=2)          # [L, F, 2, B]
    if bundle is not None:
        # ordered by each candidate's original feature and its unbundled
        # scan order (BundleMeta)
        pref = torch.stack([bundle.pref_rev, bundle.pref_fwd],
                           1).long()                        # [F, 2, B]
    else:
        bvec = torch.arange(B, dtype=torch.int64, device=dev)
        tpref = torch.stack([2 * B + bvec, (B - 1) - bvec], 0)  # [2, B]
        farange = torch.arange(F, dtype=torch.int64, device=dev)
        pref = (((F - 1) - farange)[:, None, None] * (4 * B)
                + tpref[None])                              # [F, 2, B]
    flat = gains.reshape(L, -1)
    best_gain = flat.max(dim=1).values
    is_best = flat == best_gain[:, None]
    pref_f = pref.reshape(1, -1).expand(L, -1)
    best_idx = torch.where(is_best, pref_f,
                           torch.full_like(pref_f, -1)).argmax(dim=1)
    bf = torch.div(best_idx, 2 * B, rounding_mode="floor")
    rem = best_idx % (2 * B)
    bdir = torch.div(rem, B, rounding_mode="floor")         # 0=rev, 1=fwd
    bt = rem % B
    li = torch.arange(L, device=dev)

    def pick(rev_name, fwd_name):
        return torch.where(bdir == 0, s[rev_name][li, bf, bt],
                           s[fwd_name][li, bf, bt])

    left_g = pick("rev_left_g", "fwd_left_g")
    left_h = pick("rev_left_h", "fwd_left_h")
    left_c = pick("rev_left_c", "fwd_left_c")
    right_g = pick("rev_right_g", "fwd_right_g")
    right_h = pick("rev_right_h", "fwd_right_h")
    right_c = pick("rev_right_c", "fwd_right_c")
    left_out = calculate_leaf_output(left_g, left_h, p, left_c, leaf_output)
    right_out = calculate_leaf_output(right_g, right_h, p, right_c,
                                      leaf_output)
    if adv_bounds is not None:
        lmin_a, lmax_a, rmin_a, rmax_a = adv_bounds
        left_out = clip(left_out, lmin_a[li, bf, bt], lmax_a[li, bf, bt])
        right_out = clip(right_out, rmin_a[li, bf, bt], rmax_a[li, bf, bt])
    elif use_mc:
        left_out = clip(left_out, leaf_min, leaf_max)
        right_out = clip(right_out, leaf_min, leaf_max)
    mode_a = (meta.num_bins > 2) & (meta.missing_type != MISSING_NONE)
    nan_single = ((meta.missing_type == MISSING_NAN) & ~mode_a)[bf]
    none = torch.full((L,), -1, dtype=torch.int32, device=dev)
    if bundle is not None:
        chose = bundle.is_bundle[bf]
        seg_lo = torch.where(chose, bundle.seg_lo[bf, bt].to(torch.int32),
                             none)
        seg_hi = torch.where(chose, bundle.seg_hi[bf, bt].to(torch.int32),
                             none)
    else:
        seg_lo, seg_hi = none, none
    num = SplitInfo(
        gain=best_gain.to(torch.float32), feature=bf.to(torch.int32),
        threshold=bt.to(torch.int32),
        default_left=(bdir == 0) & ~nan_single,
        left_sum_g=left_g, left_sum_h=left_h, left_count=left_c,
        right_sum_g=right_g, right_sum_h=right_h, right_count=right_c,
        left_output=left_out, right_output=right_out,
        is_cat=torch.zeros((L,), dtype=torch.bool, device=dev),
        cat_bitset=torch.zeros((L, cat_words), dtype=torch.int64,
                               device=dev),
        seg_lo=seg_lo, seg_hi=seg_hi)
    fgain = (per_feature_best_gain_key(key_rev, key_fwd)
             if return_feature_gains else None)
    if not with_categorical:
        return (num, fgain) if return_feature_gains else num

    cgain, cfeat, clg, clh, clc, cbits, cl2 = find_best_cat_splits(
        hist, leaf_sum_g, leaf_sum_h, leaf_cnt, leaf_output, leaf_depth,
        meta, p, feature_mask, max_depth, cat_words, gain_adjust)
    crg, crh, crc = leaf_sum_g - clg, leaf_sum_h - clh, leaf_cnt - clc
    clo = calculate_leaf_output(clg, clh, p, clc, leaf_output, cl2)
    cro = calculate_leaf_output(crg, crh, p, crc, leaf_output, cl2)
    if use_mc:
        clo = clip(clo, leaf_min, leaf_max)
        cro = clip(cro, leaf_min, leaf_max)
    take_cat = (cgain > num.gain) | ((cgain == num.gain)
                                     & torch.isfinite(cgain)
                                     & (cfeat < num.feature))

    def sel(cv, nv):
        cond = take_cat
        while cond.dim() < cv.dim():
            cond = cond[..., None]
        return torch.where(cond, cv, nv)

    zi = torch.zeros((L,), dtype=torch.int32, device=dev)
    merged = SplitInfo(
        gain=sel(cgain, num.gain), feature=sel(cfeat, num.feature),
        threshold=sel(zi, num.threshold),
        default_left=sel(torch.zeros_like(num.default_left),
                         num.default_left),
        left_sum_g=sel(clg, num.left_sum_g),
        left_sum_h=sel(clh, num.left_sum_h),
        left_count=sel(clc, num.left_count),
        right_sum_g=sel(crg, num.right_sum_g),
        right_sum_h=sel(crh, num.right_sum_h),
        right_count=sel(crc, num.right_count),
        left_output=sel(clo, num.left_output),
        right_output=sel(cro, num.right_output),
        is_cat=take_cat, cat_bitset=sel(cbits, num.cat_bitset),
        seg_lo=sel(none, num.seg_lo), seg_hi=sel(none, num.seg_hi))
    return (merged, fgain) if return_feature_gains else merged


def sync_best_splits(info: SplitInfo, net) -> SplitInfo:
    """The per-leaf best of every rank's ``SplitInfo`` over the network
    ``net`` (the JAX package's ``sync_best_splits``, an all_gather and an
    argmax; reference: SyncUpGlobalBestSplit, parallel_tree_learner.h:
    191-214): the largest gain wins, a tie goes to the lowest rank. Used
    by the learners whose ranks each searched their own feature slice
    (``feature``, and ``data``'s owner search)."""
    return net.sync_best(info)


def per_feature_best_gain_key(gains_rev, gains_fwd) -> torch.Tensor:
    """Best adjusted gain per (leaf, feature) over all numerical candidates
    (the quantity the voting-parallel learner votes on, reference:
    voting_parallel_tree_learner.cpp:137-150)."""
    return torch.maximum(gains_rev.max(dim=2).values,
                         gains_fwd.max(dim=2).values)


def feature_meta_from_mappers(used_mappers, device="cpu", monotone=None,
                              penalty=None) -> FeatureMeta:
    """FeatureMeta for the used (non-trivial) features, as the JAX
    package's Dataset._build_feature_meta builds it: categorical flags,
    and ``monotone`` (int8 directions) and ``penalty`` (float32
    feature_contri) in used-feature space, 0 and 1 where not given."""
    nb = np.array([m.num_bin for m in used_mappers] or [2], np.int32)
    mt = np.array([m.missing_type for m in used_mappers] or [0], np.int32)
    db = np.array([m.default_bin for m in used_mappers] or [0], np.int32)
    f = len(nb)
    monotone = (np.zeros((f,), np.int8) if monotone is None
                else np.asarray(monotone, np.int8))
    penalty = (np.ones((f,), np.float32) if penalty is None
               else np.asarray(penalty, np.float32))
    return FeatureMeta(
        num_bins=torch.as_tensor(nb, device=device),
        missing_type=torch.as_tensor(mt, device=device),
        default_bin=torch.as_tensor(db, device=device),
        is_categorical=torch.as_tensor(
            np.array([m.bin_type == BIN_TYPE_CATEGORICAL
                      for m in used_mappers] or [False]), device=device),
        monotone=torch.as_tensor(monotone, device=device),
        penalty=torch.as_tensor(penalty, device=device))


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
