"""Experiments on the one-hot histogram kernel's shape: features per
group and rows per block.

The port of ``scripts/exp_hist_variants.py``: each variant ``FGxBLK`` runs
the feature-grouped one-hot contraction of a ``[N, 256]`` bf16 right-hand
side (a hi/lo pair of 128 lanes) on the tensor cores
(``csrc/hist_onehot.cu``) and prints its time per pass. The same flags,
defaults and data as the JAX script (``np.random.RandomState(0)``, rows
zero-padded to a multiple of the block):

    python -m lightgbm_tpu_torch.scripts.exp_hist_variants \\
        [--rows 2000000] [--features 28] [--bins 255] [--reps 5] \\
        [--variants 2x2048,4x2048,4x1024,7x1024]

A variant that fails prints a FAILED line and the others still run; the
run then exits non-zero (``VariantsFailed``). The kernel and its plain
version are ``ops/cuda_hist.py``'s ``hist_onehot`` and
``hist_onehot_plain``. Not part of the library: the results feed the
histogram kernels' design.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda_hist import hist_onehot

_RHS = 256          # rhs lanes: the hi and lo halves of 128


class VariantsFailed(RuntimeError):
    """Raised by ``main`` after its loop when a variant failed; carries every
    variant's result (``results``) and the data (``data``), as ``main``
    returns them."""

    def __init__(self, results: List[Dict], data):
        failed = [f"{r['fg']}x{r['blk']}" for r in results if "error" in r]
        super().__init__(f"{len(failed)} variant(s) failed: "
                         f"{', '.join(failed)}")
        self.results, self.data = results, data


def make_variant(fg: int, blk: int) -> Callable:
    """The JAX script's ``make_variant``: a callable ``(binsT [F, N] uint8,
    rhs [N, 256] bf16, num_bins) -> out [F * B, 128] f32``."""
    def call(binsT: torch.Tensor, rhs: torch.Tensor, *,
             num_bins: int) -> torch.Tensor:
        return hist_onehot(binsT, rhs, num_bins, fg, blk)
    return call


def make_data(rows: int, features: int, bins: int,
              device: torch.device):
    """The JAX script's data: bins and a normal rhs from RandomState(0),
    the rhs rounded to bf16."""
    rng = np.random.RandomState(0)
    binsT = torch.from_numpy(
        rng.randint(0, bins, size=(features, rows)).astype(np.uint8))
    rhs = torch.from_numpy(
        rng.normal(size=(rows, _RHS)).astype(np.float32))
    return binsT.to(device), rhs.to(device).to(torch.bfloat16)


def pad_rows(binsT: torch.Tensor, rhs: torch.Tensor, blk: int):
    """Zero-pad the rows to a multiple of ``blk`` (padded rows have bin 0
    and a zero rhs, so they add nothing)."""
    npad = -binsT.shape[1] % blk
    if not npad:
        return binsT, rhs
    return (torch.nn.functional.pad(binsT, (0, npad)),
            torch.nn.functional.pad(rhs, (0, 0, 0, npad)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None, device: str = "cuda"
         ) -> Tuple[List[Dict], Tuple[torch.Tensor, torch.Tensor]]:
    """Run the variants; returns each variant's result (its ``out`` and
    ``ms_per_pass``) and the unpadded data they ran on. A variant that fails
    prints its FAILED line, as the JAX script does, and the others still
    run; then ``VariantsFailed`` is raised (its ``error`` in the variant's
    result), so the entry point exits non-zero. ``device="cpu"`` (for a
    test; no flag) runs the plain version."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--features", type=int, default=28)
    ap.add_argument("--bins", type=int, default=255)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", type=str,
                    default="2x2048,4x2048,4x1024,7x1024")
    args = ap.parse_args(argv)

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the variants run on a CUDA device "
                           "(torch.cuda.is_available() is False)")
    n, f, b = args.rows, args.features, args.bins
    binsT, rhs = make_data(n, f, b, dev)
    results = []
    for spec in args.variants.split(","):
        fg, blk = (int(x) for x in spec.split("x"))
        binsT_p, rhs_p = pad_rows(binsT, rhs, blk)
        try:
            call = make_variant(fg, blk)
            out = call(binsT_p, rhs_p, num_bins=b)
            _sync(dev)
            t0 = time.time()
            for _ in range(args.reps):
                out = call(binsT_p, rhs_p, num_bins=b)
            _sync(dev)
            dt = (time.time() - t0) / args.reps
            print(f"fg={fg} blk={blk}: {dt * 1e3:9.1f} ms/pass", flush=True)
            results.append({"fg": fg, "blk": blk, "ms_per_pass": dt * 1e3,
                            "out": out})
        except Exception as e:
            print(f"fg={fg} blk={blk}: FAILED {type(e).__name__}: "
                  f"{str(e)[:200]}", flush=True)
            results.append({"fg": fg, "blk": blk, "error": repr(e)})
    if any("error" in r for r in results):
        raise VariantsFailed(results, (binsT, rhs))
    return results, (binsT, rhs)


if __name__ == "__main__":
    main()
