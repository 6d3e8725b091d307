"""Per-leaf gradient-statistics histograms for a tile of leaves.

The port of lightgbm_tpu's ``ops/histogram.py``. A tile pass builds the
``[P, F, B, 3]`` (grad, hess, count) planes of up to P pending leaves in
one data pass. Two entries:

- ``histogram_tiles``: the planes alone (the classic split path, the JAX
  package's plane-only Pallas kernels 3-4);
- ``histogram_tiles_with_candidates``: the planes, the derived siblings'
  planes and each (leaf, feature)'s best numerical candidate (the fused
  split path, kernels 1-2).

On a CUDA tensor they run the Hopper kernels of ``ops/cuda_hist.py``
(``hist_tile``, then ``split_epilogue`` for the fused entry); on a CPU
tensor their plain versions: a flat ``index_add_`` (bitwise equal to the JAX
package's ``histogram_scatter``) and ``derive_and_scan`` (the JAX package's
XLA twin of the in-kernel epilogue, the same ops in the same order).

The quantized-gradient mode (``quantized_grad``, ``pallas_q8``) hands
them int8 stats: the planes are exact int32 sums, dequantized once per
pass (``derive_and_scan`` / the epilogue kernel with ``q_scale``, or the
classic grower's tile pass).

The compaction ladder's row-index buffer (``compact_indices``) selects the
gather form of the pass.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import HIST_METHODS
from . import cuda_hist
from .split import SplitParams, numerical_candidates


def resolve_method(method: str, device: torch.device,
                   quantized: bool = False) -> str:
    """Map ``histogram_method`` onto the port's one histogram path:
    ``"cuda"`` (the Hopper kernels) on a CUDA device, ``"plain"`` (their
    plain PyTorch versions) on the CPU. ``pallas`` and ``pallas_hilo`` both
    mean the f32 kernel here: the TPU's bf16 hi/lo split is an MXU device,
    and Hopper accumulates true f32 (within hilo's documented ~2^-17).
    ``quantized`` (``quantized_grad``) or ``pallas_q8`` selects the q8
    mode, ``"cuda_q8"`` / ``"plain_q8"`` (the JAX package's ``pallas_q8``
    and its XLA twin ``onehot_q8``)."""
    if method not in HIST_METHODS:
        raise NotImplementedError(
            f"histogram_method={method!r} has no counterpart in "
            f"lightgbm_tpu_torch: the port has one histogram path "
            f"({', '.join(HIST_METHODS)})")
    base = "cuda" if torch.device(device).type == "cuda" else "plain"
    return base + "_q8" if quantized or method == "pallas_q8" else base


def compact_indices(keep: torch.Tensor, size: int) -> torch.Tensor:
    """[size] int32 indices of the ``keep`` rows in original row order,
    padded with N (the compaction ladder's row-index buffer). The caller
    guarantees ``keep.sum() <= size``."""
    n = keep.shape[0]
    out = torch.full((size,), n, dtype=torch.int32, device=keep.device)
    nz = torch.nonzero(keep).reshape(-1)
    out[:nz.shape[0]] = nz.to(torch.int32)
    return out


def histogram_tiles(binsT: torch.Tensor, stats: torch.Tensor,
                    leaf_ids: torch.Tensor, sel: torch.Tensor, num_bins: int,
                    num_leaves: int,
                    gather_idx: Optional[torch.Tensor] = None,
                    plane: bool = True) -> torch.Tensor:
    """[P, F, B, 3] planes: slot p accumulates the rows whose leaf is
    ``sel[p]`` (< 0 = inactive slot, zero output); ``gather_idx`` restricts
    the pass to those rows (entries >= N are padding). Every slot is
    computed; no epilogue runs. ``sel`` may live on the host (its lane
    table is read there to size the launch). Float32 planes of float32
    stats; exact int32 planes of int8 stats (q8)."""
    chan = cuda_hist.chan_leaf_table(sel)
    return cuda_hist.hist_tile(binsT, leaf_ids, stats, chan, sel.shape[0],
                               num_bins, num_leaves, gather_idx, plane=plane)


def epilogue_supported(p: int, s: int) -> bool:
    """Whether a tile of ``p`` slots of ``s`` stats fits the split
    epilogue's 128-lane tables (the JAX package's precondition; on the
    port every device has the epilogue, as a kernel or its plain
    version, in the f32 and the q8 mode alike)."""
    return s == 3 and p * s <= 128


def derive_and_scan(tile, derive, parent_planes, leaf_aux, fmeta, pvec, *,
                    q8: bool = False, q_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split epilogue at plane level: dequantize an int32 tile (``q8``,
    each cell times ``q_scale`` [3] of its stat), derive the odd slots'
    planes as parent - computed sibling (a one-slot roll, the TPU kernel's
    static lane shift), then scan every slot to its per-feature best
    candidate. Returns (full planes, cand [P, F, 12])."""
    params = SplitParams.from_packed(pvec.to(torch.float32))
    if q8:
        # the JAX package fences this product (_round_fence) so XLA cannot
        # contract it into the subtraction below; eager torch never
        # contracts, so the product rounds on its own here too
        tile = tile.to(torch.float32) * q_scale.to(torch.float32)
    else:
        tile = tile.to(torch.float32)
    shifted = torch.cat([torch.zeros_like(tile[:1]), tile[:-1]], dim=0)
    full = torch.where(derive.to(torch.bool)[:, None, None, None],
                       parent_planes.to(torch.float32) - shifted, tile)
    la = leaf_aux.to(torch.float32)
    fm = fmeta.to(torch.float32)
    cand = numerical_candidates(
        full, la[:, 0], la[:, 1], la[:, 2], la[:, 3],
        fm[:, 0].to(torch.int32), fm[:, 1].to(torch.int32),
        fm[:, 2].to(torch.int32), params)
    return full, cand


def histogram_tiles_with_candidates(binsT, stats, leaf_ids, sel, derive,
                                    parent_planes, leaf_aux, fmeta, pvec,
                                    num_bins: int, num_leaves: int,
                                    gather_idx=None, q_scale=None):
    """Histogram tile pass + split epilogue: the computed (even) slots are
    histogrammed, the derived (odd) slots come from parent - sibling, and
    every (leaf, feature) reduces to its best candidate. In q8 mode
    (int8 ``stats``) the epilogue dequantizes the int32 tile by
    ``q_scale`` first. Returns (float32 tile [P, F, B, 3] with the derived
    planes filled in, cand [P, F, 12])."""
    sel_compute = torch.where(derive, torch.full_like(sel, -1), sel)
    tile = histogram_tiles(binsT, stats, leaf_ids, sel_compute, num_bins,
                           num_leaves, gather_idx, plane=False)
    der = cuda_hist._epilogue_lanes(sel, derive).to(tile.device)
    return cuda_hist.split_epilogue(tile, parent_planes.contiguous(), der,
                                    leaf_aux.contiguous(), fmeta.contiguous(),
                                    pvec.contiguous(), q_scale)
