"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU, and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed 0] [--rows 2000000] [--valid-rows 200000]
                          [--rounds 5]

Phases, in order, each printing one JSON line (any failure raises and the
script exits non-zero; nothing is caught):

  device          nvidia-smi's name and power limit, torch's device name
  build           nvcc of every kernel source in lightgbm_tpu_torch/csrc/
  hist_tile       full-row form at the train phase's shapes (N=--rows,
                  F=28, B=255, 255 leaves, a 42-slot tile of 21 computed
                  leaves): bitwise vs the plain version on integer-valued
                  stats, within 1e-5 of the summed magnitudes on float stats,
                  bitwise equal to hist_tile_exact (its own fixed-point
                  arithmetic in plain torch) and to a second launch on float
                  stats (deterministic); kernel / plain / index_add_ times
                  and the bound
  hist_tile_gather the gather form over the trainer's two compaction rungs
                  (N/2 and N/8 rounded up to 64 rows)
  split_epilogue  P=42, F=28, B=255 with derived slots: bitwise vs plain
  train           lightgbm_tpu_torch.train, binary, 255 leaves, max_bin 255,
                  lr 0.1, on Higgs-shaped data made from --seed (2M train,
                  200k valid rows, 5 rounds; the fused split path):
                  sec/iter, valid AUC (> 0.6), rows read per tree and each
                  kernel's launches on this run (both hist_tile forms and
                  split_epilogue must launch, at the shapes the kernel
                  phases checked)
  parity          the same training at 50,000 x 28, 63 leaves, 3 rounds on
                  the card and on the CPU plain path: same split features
                  and thresholds, leaf values within 1e-4; two card runs,
                  and a CPU run with the kernel's fixed-point sums
                  (kernel_sums_on_cpu), give identical model text
  hist_plane      the plane-only launch (the classic path's kernels 3-4)
                  at train_cat's shapes (N=--rows, F=8, B=255, 42 computed
                  slots): full form and both rungs, the hist_tile checks
  train_cat       the classic split path: binary, 255 leaves, lr 0.1, on
                  Expo-shaped (airline on-time) data made from --seed, six
                  categorical columns (2M train, 200k valid rows, 5 rounds):
                  sec/iter, valid AUC (> 0.6), categorical nodes (> 0), the
                  plane-only launches (> 0) and no split_epilogue launch
  parity_cat,     the classic path at 50,000 rows, 3 rounds, card vs CPU:
  parity_sparse   Expo-shaped at 63 leaves, and 28 Higgs-shaped columns of
                  which 4 are >= 90% zeros (sparse device columns): two
                  card runs and the kernel-sums CPU run identical; against
                  the CPU's float32 sums the first tree that differs (a
                  near-tie among categories can flip when the sums differ
                  in the last bit) and the leaf error before it

The quantized-gradient (q8) mode, kernels 1-4 on int8 gradients:

  hist_tile_q8    the q8 forms (int8 stats made from --seed, exact int32
                  planes) at the main path's shapes (full form and both
                  rungs) and at the classic path's (plane-only full form
                  and both rungs): bitwise vs the plain version and vs a
                  second launch; kernel / plain / int32 index_add_ times
                  and the bound
  split_epilogue_q8 the dequantizing epilogue on an int32 tile with a
                  non-trivial q_scale, P=42, F=28, B=255: bitwise vs plain
  train_q8        train's run with quantized_grad=True: sec/iter, valid AUC
                  (> 0.6 and >= train's - 0.01, the JAX package's q8
                  quality bar), q8 launches of every fused-path form and
                  none of the f32 forms
  train_q8_cat    train_cat's run with quantized_grad=True: AUC as above
                  against train_cat, plane-only q8 launches only
  parity_q8,      50,000 rows, 3 rounds, numerical and Expo-shaped, card
  parity_q8_cat   vs CPU plain path: the model text bitwise equal (exact
                  int32 sums, the same quantization arithmetic), and two
                  card runs identical

and kernel 5, the experiment script's one-hot histogram:

  hist_variants   python -m lightgbm_tpu_torch.scripts.exp_hist_variants at
                  its defaults (2M rows, 28 features, 255 bins, variants
                  2x2048, 4x2048, 4x1024, 7x1024): each variant within
                  1e-5 of each cell's summed magnitudes of
                  hist_onehot_plain; kernel / plain / materialized one-hot
                  cuBLAS matmul (the library stand-in) times, the bound
                  (the function's least bytes and f32 adds) and, apart,
                  the one-hot form's tensor-core floor

then a ``kernels`` line, nvidia-smi's ``name, power.limit`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result. Times come from CUDA events (median of >= 10 launches
after warm-up, the L2 cache flushed before each); bounds use the H100 SXM
data-sheet peaks (3.35 TB/s, 67 TFLOP/s float32), whatever the card's power
limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores (also the
                               # bound's rate for integer adds: the guide's
                               # table has no CUDA-core integer rate)
BF16_FLOP_PER_S = 989e12       # bf16 tensor cores, dense
# the main path's kernel shapes: Higgs width, max_bin 255, 255 leaves, the
# grower's 42-slot tile (train_phase checks the trainer used these); the
# classic path's: the Expo width of 8 columns, all 42 slots computed
F, B, LEAVES, P = 28, 255, 255, 42
F_CAT = 8


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


_flush_buf = None


def flush_l2() -> None:
    """Overwrite the 50 MB L2 with a 64 MB buffer."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
    _flush_buf.zero_()


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each timed alone
    with CUDA events on a cold L2."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush_l2()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def float_err(kernel: torch.Tensor, plain: torch.Tensor,
              magnitude: torch.Tensor, rtol: float = 1e-5) -> float:
    """Max |kernel - plain|; fails unless every cell is within ``rtol`` of
    the sum of the magnitudes that cell accumulated (a float32 sum's error
    is bounded by the magnitudes, not by the possibly cancelling result)."""
    diff = (kernel - plain).abs()
    bad = diff > rtol * magnitude + 1e-30
    if bool(bad.any()):
        raise AssertionError(f"kernel disagrees with its plain version at "
                             f"{int(bad.sum())} cells (max err "
                             f"{float(diff.max())})")
    return float(diff.max())


# --------------------------------------------------------------- kernels
def ladder_rungs(n: int):
    """The compaction ladder's row buffers for N rows, as the trainer sizes
    them (models/gbdt.py _compaction_ladder): 0.125 and 0.5 of N, rounded
    up to 64 rows, ascending."""
    return [-(-max(int(round(n * fr)), 1) // 64) * 64 for fr in (0.125, 0.5)]


def tile_selection(plane=False):
    """A tile as the grower hands it to hist_tile. Fused path: P slots, the
    computed smaller sibling of each pair in the even slot, the odd
    (derived) slot -1 -- 21 computed leaves out of LEAVES. Classic path
    (``plane``): all P slots computed."""
    if plane:
        return torch.arange(P, dtype=torch.int32) * (LEAVES // P)
    sel = torch.full((P,), -1, dtype=torch.int32)
    sel[0::2] = torch.arange(P // 2, dtype=torch.int32) * (LEAVES // (P // 2))
    return sel


def hist_inputs(n, f, seed, integer, tile_leaves, share):
    """Random rows over LEAVES leaves, ``share`` of them in the tile's
    computed leaves."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    binsT = torch.randint(0, B, (f, n), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    others = torch.ones(LEAVES, dtype=torch.bool)
    others[tile_leaves.long()] = False
    others = torch.nonzero(others).reshape(-1).to(torch.int32).cuda()
    in_tile = torch.rand(n, generator=g, device="cuda") < share
    pick_t = torch.randint(0, tile_leaves.shape[0], (n,), generator=g,
                           device="cuda")
    pick_o = torch.randint(0, others.shape[0], (n,), generator=g,
                           device="cuda")
    leaf = torch.where(in_tile, tile_leaves.cuda()[pick_t],
                       others[pick_o]).contiguous()
    if integer:
        stats = torch.stack([
            torch.randint(-3, 4, (n,), generator=g, device="cuda"),
            torch.randint(0, 4, (n,), generator=g, device="cuda"),
            torch.ones(n, device="cuda")], 1).to(torch.float32)
    else:
        stats = torch.stack([
            torch.randn(n, generator=g, device="cuda"),
            torch.rand(n, generator=g, device="cuda"),
            torch.ones(n, device="cuda")], 1)
    return binsT, leaf, stats.contiguous()


def hist_phase(cuda_hist, n, m=None, seed=0, f=F, plane=False):
    """Kernel vs plain on integer-valued and float stats at the shapes of
    one main-path pass: the full form (``m`` None; 3/4 of the rows in the
    tile, as when a full pass is taken) or the gather form over a rung of
    ``m`` rows holding the tile's rows (9/10 of the rung) in row order,
    padded with N, as the grower builds it. ``plane``: the classic path's
    plane-only launch (all slots computed). Two launches on float stats
    must give the same bits."""
    from lightgbm_tpu_torch.ops.histogram import compact_indices
    sel = tile_selection(plane)
    tile_leaves = sel[sel >= 0]
    chan = cuda_hist.chan_leaf_table(sel).cuda()
    share = 0.75 if m is None else 0.9 * m / n
    out = {}
    for integer in (True, False):
        binsT, leaf, stats = hist_inputs(n, f, seed, integer, tile_leaves,
                                         share)
        in_tile = torch.isin(leaf, tile_leaves.cuda())
        n_tile = int(in_tile.sum())
        idx = None
        if m is not None:
            if n_tile > m:
                raise AssertionError(f"{n_tile} tile rows overflow the "
                                     f"{m}-row rung")
            idx = compact_indices(in_tile, m)
        args = (binsT, leaf, stats, chan, P, B, LEAVES, idx)
        k = cuda_hist.hist_tile(*args, plane=plane)
        p = cuda_hist.hist_tile_plain(*args)
        torch.cuda.synchronize()
        if integer:
            if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
                raise AssertionError("hist_tile is not bitwise equal to its "
                                     "plain version on integer-valued stats")
            out["int_max_abs_err"] = float((k - p).abs().max())
            continue
        again = cuda_hist.hist_tile(*args, plane=plane)
        exact = cuda_hist.hist_tile_exact(*args)
        torch.cuda.synchronize()
        if not torch.equal(k.view(torch.int32), again.view(torch.int32)):
            raise AssertionError("two hist_tile launches on the same float "
                                 "stats differ")
        if not torch.equal(k.view(torch.int32), exact.view(torch.int32)):
            raise AssertionError("hist_tile is not bitwise equal to "
                                 "hist_tile_exact (its own arithmetic in "
                                 "plain PyTorch) on float stats")
        out["deterministic"] = True
        out["bitwise_vs_exact"] = True
        mag = cuda_hist.hist_tile_plain(binsT, leaf, stats.abs(), chan, P, B,
                                        LEAVES, idx)
        out["max_abs_err"] = float_err(k, p, mag)
        out["ms"] = time_ms(lambda: cuda_hist.hist_tile(*args, plane=plane))
        out["plain_ms"] = time_ms(lambda: cuda_hist.hist_tile_plain(*args),
                                  reps=10, warm=1)
        # one PyTorch call computing the same function: index_add_ over the
        # tile rows' flattened (slot, feature, bin) cells
        r = torch.nonzero(in_tile).reshape(-1)
        slot_of_leaf = torch.full((LEAVES,), -1, dtype=torch.long,
                                  device="cuda")
        slot_of_leaf[tile_leaves.long().cuda()] = \
            torch.nonzero(sel >= 0).reshape(-1).cuda()
        s = slot_of_leaf[leaf[r].long()]
        flat = ((s[:, None] * f + torch.arange(f, device="cuda")[None, :]) * B
                + binsT[:, r].T.long()).reshape(-1)
        contrib = stats[r][:, None, :].expand(r.shape[0], f, 3).reshape(-1, 3)
        acc = torch.zeros((P * f * B, 3), device="cuda")
        out["library_ms"] = time_ms(lambda: acc.index_add_(0, flat, contrib))
        # least traffic: the row-index buffer (gather form), the leaf id of
        # every row it names, the bins and stats of the tile's rows, the
        # planes written once; one add per (tile row, feature, stat)
        scanned = n if idx is None else n_tile
        nbytes = (0 if idx is None else 4 * m) + 4 * scanned \
            + n_tile * (f + 12) + P * f * B * 3 * 4
        out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * n_tile * f)
        out["rows"], out["tile_rows"] = (n if m is None else m), n_tile
    return out


def epilogue_phase(cuda_hist, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    tile = torch.zeros((P, F, B, 3), device="cuda")
    parent = torch.zeros_like(tile)
    derive = torch.zeros(P, dtype=torch.bool)
    derive[1::2] = True
    # planes of random rows: grad N(0,1), hess U(0,1), count 1 per row
    for p in range(P):
        cnt = torch.randint(0, 40, (F, B), generator=g, device="cuda")
        cnt = cnt.to(torch.float32)
        gsum = torch.randn((F, B), generator=g, device="cuda") * cnt.sqrt()
        hsum = torch.rand((F, B), generator=g, device="cuda") * cnt
        plane = torch.stack([gsum, hsum, cnt], -1)
        if derive[p]:
            parent[p] = plane + tile[p - 1]
        else:
            tile[p] = plane
    full = torch.where(derive.cuda()[:, None, None, None],
                       parent - torch.cat([tile[:1] * 0, tile[:-1]]), tile)
    s = full[:, 0].sum(1)                                   # [P, 3]
    la = cuda_hist.pack_leaf_aux(s[:, 0], s[:, 1], s[:, 2],
                                 -0.1 * s[:, 0] / (s[:, 1] + 1)).cuda()
    nb = torch.full((F,), B, dtype=torch.int32)
    nb[3], nb[7] = 64, 2
    mt = torch.zeros(F, dtype=torch.int32)
    mt[5], mt[6] = 2, 1                                     # NaN, Zero
    db = torch.zeros(F, dtype=torch.int32)
    db[6] = 17
    fm = cuda_hist.pack_feature_meta(nb, mt, db,
                                     torch.zeros(F, dtype=torch.int32)).cuda()
    pv = torch.tensor([0.0, 1.0, 0.0, 0.0, 20.0, 1e-3, 0.0, 0.0],
                      device="cuda")
    der = cuda_hist._epilogue_lanes(torch.arange(P, dtype=torch.int32),
                                    derive).cuda()
    args = (tile, parent, der, la, fm, pv)
    kf, kc = cuda_hist.split_epilogue(*args)
    pf, pc = cuda_hist.split_epilogue_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kc.view(torch.int32), pc.view(torch.int32))
            and torch.equal(kf.view(torch.int32), pf.view(torch.int32))):
        raise AssertionError("split_epilogue is not bitwise equal to its "
                             "plain version")
    valid = int(torch.isfinite(kc[..., 0]).sum())
    if valid == 0:
        raise AssertionError("split_epilogue found no valid candidate")
    plane_bytes = P * F * B * 3 * 4
    nbytes = 3 * plane_bytes + P * F * 12 * 4 + P * 8 * 4 + F * 8 * 4
    bms, by = bound(nbytes, 60 * P * F * B)
    return {"max_abs_err": float((kc - pc).nan_to_num(0.0).abs().max()),
            "valid_candidates": valid,
            "ms": time_ms(lambda: cuda_hist.split_epilogue(*args)),
            "plain_ms": time_ms(lambda: cuda_hist.split_epilogue_plain(*args),
                                reps=10, warm=1),
            "library_ms": None, "bound_ms": bms, "bound_by": by}


def q8_stats(n: int, seed: int) -> torch.Tensor:
    """int8 stats as the quantized-gradient mode makes them: grad in
    [-127, 127], hess in [0, 127], count 1."""
    g = torch.Generator(device="cuda").manual_seed(seed + 101)
    return torch.stack([
        torch.randint(-127, 128, (n,), generator=g, device="cuda"),
        torch.randint(0, 128, (n,), generator=g, device="cuda"),
        torch.ones(n, dtype=torch.int64, device="cuda")],
        1).to(torch.int8).contiguous()


def hist_q8_phase(cuda_hist, n, m=None, seed=0, f=F, plane=False):
    """The q8 form (int8 stats, exact int32 planes) at the shapes of one
    main-path or classic-path pass, as hist_phase: bitwise vs the plain
    version and vs a second launch."""
    from lightgbm_tpu_torch.ops.histogram import compact_indices
    sel = tile_selection(plane)
    tile_leaves = sel[sel >= 0]
    chan = cuda_hist.chan_leaf_table(sel).cuda()
    share = 0.75 if m is None else 0.9 * m / n
    binsT, leaf, _ = hist_inputs(n, f, seed, True, tile_leaves, share)
    stats = q8_stats(n, seed)
    in_tile = torch.isin(leaf, tile_leaves.cuda())
    n_tile = int(in_tile.sum())
    idx = None
    if m is not None:
        if n_tile > m:
            raise AssertionError(f"{n_tile} tile rows overflow the {m}-row "
                                 f"rung")
        idx = compact_indices(in_tile, m)
    args = (binsT, leaf, stats, chan, P, B, LEAVES, idx)
    k = cuda_hist.hist_tile(*args, plane=plane)
    again = cuda_hist.hist_tile(*args, plane=plane)
    p = cuda_hist.hist_tile_plain(*args)
    torch.cuda.synchronize()
    if k.dtype != torch.int32 or not torch.equal(k, p):
        raise AssertionError("q8 hist_tile is not bitwise equal to its plain "
                             "version (exact int32 sums)")
    if not torch.equal(k, again):
        raise AssertionError("two q8 hist_tile launches differ")
    out = {"bitwise_vs_plain": True, "deterministic": True,
           "max_abs_err": float((k - p).abs().max())}
    out["ms"] = time_ms(lambda: cuda_hist.hist_tile(*args, plane=plane))
    out["plain_ms"] = time_ms(lambda: cuda_hist.hist_tile_plain(*args),
                              reps=10, warm=1)
    # one PyTorch call computing the same function: an int32 index_add_
    # over the tile rows' flattened (slot, feature, bin) cells
    r = torch.nonzero(in_tile).reshape(-1)
    slot_of_leaf = torch.full((LEAVES,), -1, dtype=torch.long, device="cuda")
    slot_of_leaf[tile_leaves.long().cuda()] = \
        torch.nonzero(sel >= 0).reshape(-1).cuda()
    s = slot_of_leaf[leaf[r].long()]
    flat = ((s[:, None] * f + torch.arange(f, device="cuda")[None, :]) * B
            + binsT[:, r].T.long()).reshape(-1)
    contrib = stats[r].to(torch.int32)[:, None, :].expand(
        r.shape[0], f, 3).reshape(-1, 3)
    acc = torch.zeros((P * f * B, 3), dtype=torch.int32, device="cuda")
    out["library_ms"] = time_ms(lambda: acc.index_add_(0, flat, contrib))
    # least traffic: the row-index buffer (gather form), the leaf id of
    # every row it names, the bins and 3 int8 stats of the tile's rows,
    # the int32 planes written once; one add per (tile row, feature, stat)
    scanned = n if idx is None else n_tile
    nbytes = (0 if idx is None else 4 * m) + 4 * scanned \
        + n_tile * (f + 3) + P * f * B * 3 * 4
    out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * n_tile * f)
    out["rows"], out["tile_rows"] = (n if m is None else m), n_tile
    return out


def epilogue_q8_phase(cuda_hist, seed=0):
    """The dequantizing epilogue: an int32 tile of exact sums (derived
    slots zero), float32 parents (dequantized sums, as resident), a
    non-trivial q_scale."""
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    q_scale = torch.tensor([0.0173, 0.00291, 1.0], device="cuda")
    tile = torch.zeros((P, F, B, 3), dtype=torch.int32, device="cuda")
    parent = torch.zeros((P, F, B, 3), device="cuda")
    derive = torch.zeros(P, dtype=torch.bool)
    derive[1::2] = True
    for p in range(P):
        cnt = torch.randint(0, 40, (F, B), generator=g, device="cuda")
        plane = torch.stack([
            torch.randint(-127, 128, (F, B), generator=g, device="cuda") * cnt,
            torch.randint(0, 128, (F, B), generator=g, device="cuda") * cnt,
            cnt], -1).to(torch.int32)
        if derive[p]:
            parent[p] = (plane + tile[p - 1]).to(torch.float32) * q_scale
        else:
            tile[p] = plane
    deq = tile.to(torch.float32) * q_scale
    full = torch.where(derive.cuda()[:, None, None, None],
                       parent - torch.cat([deq[:1] * 0, deq[:-1]]), deq)
    s = full[:, 0].sum(1)
    la = cuda_hist.pack_leaf_aux(s[:, 0], s[:, 1], s[:, 2],
                                 -0.1 * s[:, 0] / (s[:, 1] + 1)).cuda()
    nb = torch.full((F,), B, dtype=torch.int32)
    nb[3], nb[7] = 64, 2
    mt = torch.zeros(F, dtype=torch.int32)
    mt[5], mt[6] = 2, 1
    db = torch.zeros(F, dtype=torch.int32)
    db[6] = 17
    fm = cuda_hist.pack_feature_meta(nb, mt, db,
                                     torch.zeros(F, dtype=torch.int32)).cuda()
    pv = torch.tensor([0.0, 1.0, 0.0, 0.0, 20.0, 1e-3, 0.0, 0.0],
                      device="cuda")
    der = cuda_hist._epilogue_lanes(torch.arange(P, dtype=torch.int32),
                                    derive).cuda()
    args = (tile, parent, der, la, fm, pv, q_scale)
    kf, kc = cuda_hist.split_epilogue(*args)
    kf2, kc2 = cuda_hist.split_epilogue(*args)
    pf, pc = cuda_hist.split_epilogue_plain(*args)
    torch.cuda.synchronize()
    for a, b in ((kc, pc), (kf, pf), (kc, kc2), (kf, kf2)):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("q8 split_epilogue is not bitwise equal to "
                                 "its plain version and to a second launch")
    valid = int(torch.isfinite(kc[..., 0]).sum())
    if valid == 0:
        raise AssertionError("q8 split_epilogue found no valid candidate")
    plane_bytes = P * F * B * 3 * 4
    nbytes = 3 * plane_bytes + P * F * 12 * 4 + P * 8 * 4 + F * 8 * 4 + 12
    bms, by = bound(nbytes, 61 * P * F * B)
    # the f32 form on the dequantized tile, timed in turns with the q8 form
    # (f32, q8, q8, f32): the two modes' cost on the same data and clocks
    f32_args = (tile.to(torch.float32) * q_scale,) + args[1:6]
    ff, fc = cuda_hist.split_epilogue(*f32_args)
    torch.cuda.synchronize()
    if not (torch.equal(ff.view(torch.int32), kf.view(torch.int32))
            and torch.equal(fc.view(torch.int32), kc.view(torch.int32))):
        raise AssertionError("the q8 epilogue differs from the f32 one on "
                             "the tile it dequantizes")
    turns = {"f32": [], "q8": []}
    for mode in ("f32", "q8", "q8", "f32"):
        a = f32_args if mode == "f32" else args
        turns[mode].append(time_ms(lambda: cuda_hist.split_epilogue(*a)))
    return {"max_abs_err": float((kc - pc).nan_to_num(0.0).abs().max()),
            "valid_candidates": valid, "q_scale": q_scale.tolist(),
            "ms": statistics.median(turns["q8"]),
            "turns_ms": turns,
            "plain_ms": time_ms(lambda: cuda_hist.split_epilogue_plain(*args),
                                reps=10, warm=1),
            "library_ms": None, "bound_ms": bms, "bound_by": by}


# ------------------------------------------------------------ main path
def higgs_like(n: int, seed: int):
    """Higgs-shaped data: 28 float32 features (21 low-level kinematics --
    positive momenta, angles in [-pi, pi], Gaussian-ish components -- and 7
    high-level mass-like features) and a binary label from a nonlinear
    function of them plus noise."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 28), np.float32)
    for j in range(21):
        kind = j % 3
        if kind == 0:
            X[:, j] = rng.exponential(1.0, n)
        elif kind == 1:
            X[:, j] = rng.uniform(-np.pi, np.pi, n)
        else:
            X[:, j] = rng.standard_normal(n)
    for j in range(21, 28):
        X[:, j] = np.abs(rng.standard_normal(n) * 0.5 + 1.0) \
            + 0.1 * X[:, (j - 21) * 3]
    z = (0.9 * X[:, 21] - 0.8 * X[:, 24] + 0.6 * np.sin(X[:, 1]) * X[:, 0]
         + 0.5 * X[:, 2] * X[:, 5] - 0.4 * X[:, 26] ** 2 + 0.3 * X[:, 9]
         + rng.logistic(0.0, 1.0, n) * 0.8)
    y = (z > np.median(z)).astype(np.float64)
    return X, y


def auc(score: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(-score, kind="stable")
    ys = y[order]
    npos = ys.sum()
    nneg = len(ys) - npos
    neg_below = nneg - np.cumsum(1 - ys)
    return float((ys * neg_below).sum() / (npos * nneg))


PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "learning_rate": 0.1, "metric": "auc", "verbosity": -1}


def train_phase(lgb, cuda_hist, args, q8_ref_auc=None):
    """The fused path on 2M Higgs-shaped rows; with ``q8_ref_auc`` (the
    f32 run's AUC) the quantized-gradient mode, which must launch only the
    q8 forms and keep the AUC within 0.01 of the f32 run's."""
    q8 = q8_ref_auc is not None
    t0 = time.time()
    X, y = higgs_like(args.rows + args.valid_rows, args.seed)
    Xv, yv = X[args.rows:], y[args.rows:]
    X, y = X[:args.rows], y[:args.rows]
    t_data = time.time() - t0
    params = dict(PARAMS, device_type="cuda", quantized_grad=q8)
    train = lgb.Dataset(X, label=y, params=params)
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    t0 = time.time()
    train.construct()
    valid.construct()
    torch.cuda.synchronize()
    t_construct = time.time() - t0
    evals = {}
    cuda_hist.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    booster = lgb.train(params, train, args.rounds, valid_sets=[valid],
                        valid_names=["valid"], evals_result=evals)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_hist.launch_counts()
    sfx = "_q8" if q8 else ""
    valid_auc = evals["valid"]["auc"][-1]
    check_auc = auc(booster.predict(Xv, raw_score=True), yv)
    out = {"rows": args.rows, "valid_rows": args.valid_rows,
           "features": 28, "rounds": args.rounds, "quantized_grad": q8,
           "sec_per_iter": wall / args.rounds, "train_wall_s": wall,
           "data_s": t_data, "construct_s": t_construct,
           "valid_auc": valid_auc, "valid_auc_from_predict": check_auc,
           "rows_streamed_per_tree": booster.rows_streamed_per_tree,
           "full_passes_per_tree": (launches["hist_tile.launches" + sfx]
                                    - launches["hist_tile.gather_launches"
                                               + sfx])
           / args.rounds,
           "launches": launches, "trees": booster.num_trees(),
           "leaves_last_tree": booster._boosting.host_trees[-1].num_leaves}
    gb = booster._boosting
    shapes = {"features": gb.train_set.binsT.shape[0],
              "num_bins": gb.train_set.max_num_bins,
              "num_leaves": gb.config.num_leaves,
              "tile_slots": gb.config.tile_leaves
              or cuda_hist.structural_tile_leaves(),
              "rungs": list(gb._compaction_ladder())}
    if shapes != {"features": F, "num_bins": B, "num_leaves": LEAVES,
                  "tile_slots": P, "rungs": ladder_rungs(args.rows)}:
        raise AssertionError(f"the kernel checks ran at other shapes than "
                             f"the main path's {shapes}")
    out["kernel_shapes"] = shapes
    other = "" if q8 else "_q8"
    gather = launches["hist_tile.gather_launches" + sfx]
    if gather <= 0 or \
            launches["hist_tile.launches" + sfx] - gather <= 0 or \
            launches["split_epilogue.launches" + sfx] <= 0 or \
            launches["hist_tile.launches_plane" + sfx] or \
            launches["hist_tile.launches" + other] or \
            launches["split_epilogue.launches" + other]:
        raise AssertionError(f"the main path missed a kernel, left the "
                             f"fused path or ran the other mode: {launches}")
    # the valid-score cache adds float32 tree outputs, predict accumulates
    # in float64: scores that tie in one may not in the other
    if not (valid_auc > 0.6 and abs(valid_auc - check_auc) < 1e-3):
        raise AssertionError(f"valid AUC {valid_auc} (predict: {check_auc})")
    if q8 and not valid_auc >= q8_ref_auc - 0.01:
        raise AssertionError(f"q8 valid AUC {valid_auc} more than 0.01 "
                             f"below the f32 run's {q8_ref_auc}")
    out["profile"] = profile_iteration(booster, wall / args.rounds)
    return out, launches


def profile_iteration(booster, sec_per_iter: float):
    """Where one more boosting iteration's time goes: device time by kernel
    (torch.profiler, CUDA activity only) against the unprofiled sec/iter,
    and the host's hottest Python functions (cProfile over a further
    iteration; its own overhead inflates the host times)."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        booster.update()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {"device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
           "top_device": [{"name": k[:60], "ms": us / 1e3, "calls": c}
                          for us, k, c in rows[:8]]}
    if busy_ms > 0:
        out["device_idle_share"] = max(0.0, 1 - busy_ms
                                       / (sec_per_iter * 1e3))
    prof_host = cProfile.Profile()
    t0 = time.time()
    prof_host.enable()
    booster.update()
    torch.cuda.synchronize()
    prof_host.disable()
    out["cprofile_iteration_ms"] = (time.time() - t0) * 1e3
    st = pstats.Stats(prof_host)
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
    out["top_host"] = [{"fn": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}",
                        "tottime_ms": v[2] * 1e3, "calls": v[1]}
                       for k, v in top]
    return out


def expo_like(n: int, seed: int):
    """Expo-shaped data (the airline on-time set of LightGBM's categorical
    benchmark, docs/Experiments.rst), its 8 columns in its order: Month
    (12), DayofMonth (31), DayOfWeek (7), DepTime (hhmm), UniqueCarrier
    (22), Origin and Dest (300 airports each, Zipf-skewed: p ~ (rank +
    8)^-2, so the busiest airport has 11% of the flights and 220 airports
    99%, which keeps the mappers' 99% category cut within 255 bins) and
    Distance (miles); the six categorical columns hold category codes. The
    label is logistic in per-category effects plus the two numericals."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 8), np.float32)
    zipf = 1.0 / (np.arange(1, 301) + 8.0) ** 2
    zipf /= zipf.sum()
    z = rng.logistic(0.0, 1.0, n) * 0.8
    for j, card in ((0, 12), (1, 31), (2, 7), (4, 22), (5, 300), (6, 300)):
        codes = (rng.choice(card, n, p=zipf) if card == 300
                 else rng.randint(0, card, n))
        X[:, j] = codes
        z += rng.standard_normal(card)[codes] * (0.3 if j == 1 else 0.6)
    minutes = np.clip(rng.normal(13.5, 4.0, n), 0, 23.99) * 60
    X[:, 3] = (minutes // 60) * 100 + minutes % 60
    X[:, 7] = np.exp(rng.normal(6.5, 0.7, n)).clip(30, 5000)
    z += 0.15 * (minutes / 60 - 13.5) + 0.3 * (np.log(X[:, 7]) - 6.5)
    y = (z > np.median(z)).astype(np.float64)
    return X, y


CAT_COLUMNS = [0, 1, 2, 4, 5, 6]


def sparse_higgs_like(n: int, seed: int):
    """Higgs-shaped data with 4 of its 28 columns >= 90% zeros (each row
    keeps a value with probability 0.06): the sparse device columns."""
    X, y = higgs_like(n, seed)
    rng = np.random.RandomState(seed + 1)
    for j in (3, 10, 17, 24):
        X[rng.rand(n) >= 0.06, j] = 0.0
    return X, y


def train_cat_phase(lgb, cuda_hist, args, q8_ref_auc=None):
    """The classic path on 2M Expo-shaped rows; ``q8_ref_auc`` as in
    train_phase."""
    q8 = q8_ref_auc is not None
    X, y = expo_like(args.rows + args.valid_rows, args.seed + 11)
    Xv, yv = X[args.rows:], y[args.rows:]
    X, y = X[:args.rows], y[:args.rows]
    params = dict(PARAMS, device_type="cuda", quantized_grad=q8)
    train = lgb.Dataset(X, label=y, params=params,
                        categorical_feature=CAT_COLUMNS)
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    t0 = time.time()
    train.construct()
    valid.construct()
    torch.cuda.synchronize()
    t_construct = time.time() - t0
    evals = {}
    cuda_hist.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    booster = lgb.train(params, train, args.rounds, valid_sets=[valid],
                        valid_names=["valid"], evals_result=evals)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_hist.launch_counts()
    sfx, other = ("_q8", "") if q8 else ("", "_q8")
    gb = booster._boosting
    cat_nodes = int(sum(int(np.sum(ht.is_cat)) for ht in gb.host_trees))
    valid_auc = evals["valid"]["auc"][-1]
    shapes = {"features": gb.train_set.binsT.shape[0],
              "num_bins": gb.train_set.max_num_bins,
              "num_leaves": gb.config.num_leaves,
              "tile_slots": gb.config.tile_leaves
              or cuda_hist.structural_tile_leaves(),
              "rungs": list(gb._compaction_ladder()),
              "sparse_columns": int(gb.train_set.has_sparse_cols),
              "split_fusion": gb._split_fusion_on()}
    out = {"rows": args.rows, "valid_rows": args.valid_rows, "features": 8,
           "categorical": CAT_COLUMNS, "rounds": args.rounds,
           "quantized_grad": q8,
           "sec_per_iter": wall / args.rounds, "train_wall_s": wall,
           "construct_s": t_construct, "valid_auc": valid_auc,
           "categorical_nodes": cat_nodes,
           "rows_streamed_per_tree": booster.rows_streamed_per_tree,
           "launches": launches, "kernel_shapes": shapes,
           "leaves_last_tree": gb.host_trees[-1].num_leaves}
    if shapes != {"features": F_CAT, "num_bins": B, "num_leaves": LEAVES,
                  "tile_slots": P, "rungs": ladder_rungs(args.rows),
                  "sparse_columns": 0, "split_fusion": False}:
        raise AssertionError(f"the plane-only kernel checks ran at other "
                             f"shapes than the classic path's {shapes}")
    plane = launches["hist_tile.launches_plane" + sfx]
    if plane <= 0 or launches["split_epilogue.launches"] \
            or launches["split_epilogue.launches_q8"] \
            or plane != launches["hist_tile.launches" + sfx] \
            or launches["hist_tile.launches" + other]:
        raise AssertionError(f"the classic path did not run on the "
                             f"plane-only kernel of its mode alone: "
                             f"{launches}")
    if not (valid_auc > 0.6 and cat_nodes > 0):
        raise AssertionError(f"valid AUC {valid_auc}, {cat_nodes} "
                             f"categorical nodes")
    if q8 and not valid_auc >= q8_ref_auc - 0.01:
        raise AssertionError(f"q8 valid AUC {valid_auc} more than 0.01 "
                             f"below the f32 run's {q8_ref_auc}")
    out["profile"] = profile_iteration(booster, wall / args.rounds)
    return out, launches


def _structure(text):
    from lightgbm_tpu_torch.io.model_text import load_model
    return [(t.split_feature.tolist(), t.threshold.tolist(),
             t.decision_type.tolist(), t.cat_threshold.tolist(),
             t.left_child.tolist(), t.right_child.tolist())
            for t in load_model(text).trees]


def _parity(lgb, X, y, params, categorical=None, strict=False):
    """One training (3 rounds) on the card twice and on the CPU twice: with
    the CPU path's float32 sums (the JAX package's order) and with the
    kernel's fixed-point sums (``kernel_sums_on_cpu``). The two card runs
    and the kernel-sums CPU run must give the same model text, bit for bit.
    Against the float32-sum run: the first tree whose structure (split
    features, thresholds, category bitsets, children) differs, and the
    largest leaf difference of the trees before it; ``strict`` requires
    the same structure throughout and leaves within 1e-4."""
    from lightgbm_tpu_torch.io.model_text import load_model
    from lightgbm_tpu_torch.ops import cuda_hist
    texts = {}
    kw = {} if categorical is None else {"categorical_feature": categorical}
    for run in ("cuda", "cuda_again", "cpu", "cpu_kernel_sums"):
        p = dict(params, device_type=run.split("_")[0])
        with (cuda_hist.kernel_sums_on_cpu() if run == "cpu_kernel_sums"
              else contextlib.nullcontext()):
            b = lgb.train(p, lgb.Dataset(X, label=y, params=p, **kw), 3)
        texts[run] = b.model_to_string()
    sc, sp = _structure(texts["cuda"]), _structure(texts["cpu"])
    diverge = next((i for i, (a, b) in enumerate(zip(sc, sp)) if a != b),
                   None if len(sc) == len(sp) else min(len(sc), len(sp)))
    tc, tp = load_model(texts["cuda"]).trees, load_model(texts["cpu"]).trees
    upto = len(tc) if diverge is None else diverge
    leaf_err = max([float(np.abs(a.leaf_value - b.leaf_value).max())
                    for a, b in zip(tc[:upto], tp[:upto])] or [0.0])
    out = {"rows": len(X), "num_leaves": params["num_leaves"], "rounds": 3,
           "card_runs_identical_text": texts["cuda"] == texts["cuda_again"],
           "card_equals_cpu_kernel_sums": texts["cuda"]
           == texts["cpu_kernel_sums"],
           "same_structure_as_cpu": diverge is None,
           "first_divergent_tree_vs_cpu": diverge,
           "max_leaf_abs_err_before_divergence": leaf_err,
           "categorical_nodes": int(sum(t.num_cat for t in tc))}
    if not (out["card_runs_identical_text"]
            and out["card_equals_cpu_kernel_sums"]) or (
            strict and (diverge is not None or leaf_err > 1e-4)):
        raise AssertionError(f"card vs CPU disagree: {out}")
    return out


def parity_phase(lgb, seed):
    X, y = higgs_like(50_000, seed + 7)
    return _parity(lgb, X, y, dict(PARAMS, num_leaves=63), strict=True)


def parity_cat_phase(lgb, seed):
    X, y = expo_like(50_000, seed + 13)
    out = _parity(lgb, X, y, dict(PARAMS, num_leaves=63), CAT_COLUMNS)
    if out["categorical_nodes"] <= 0:
        raise AssertionError(f"no categorical node: {out}")
    return out


def parity_sparse_phase(lgb, seed):
    X, y = sparse_higgs_like(50_000, seed + 17)
    ds = lgb.Dataset(X, label=y, params=dict(PARAMS, device_type="cpu"))
    ds.construct()
    if not ds.has_sparse_cols or len(ds.sp_cols) != 4:
        raise AssertionError(f"expected 4 sparse device columns, got "
                             f"{ds.sp_cols}")
    out = _parity(lgb, X, y, dict(PARAMS, num_leaves=63))
    out["sparse_columns"] = ds.sp_cols.tolist()
    return out


def _parity_q8(lgb, X, y, params, categorical=None):
    """q8 training, 3 rounds, on the card twice and on the CPU plain path:
    the int8 quantization is the same torch arithmetic on both devices and
    the int32 sums are exact (127 * 50,000 < 2^24 keeps the root's float32
    sums exact too), so all three model texts must be equal bit for bit."""
    from lightgbm_tpu_torch.io.model_text import load_model
    texts = {}
    kw = {} if categorical is None else {"categorical_feature": categorical}
    for run in ("cuda", "cuda_again", "cpu"):
        p = dict(params, quantized_grad=True, device_type=run.split("_")[0])
        b = lgb.train(p, lgb.Dataset(X, label=y, params=p, **kw), 3)
        texts[run] = b.model_to_string()
    out = {"rows": len(X), "num_leaves": params["num_leaves"], "rounds": 3,
           "card_runs_identical_text": texts["cuda"] == texts["cuda_again"],
           "card_equals_cpu_text": texts["cuda"] == texts["cpu"],
           "categorical_nodes": int(sum(
               t.num_cat for t in load_model(texts["cuda"]).trees))}
    if not (out["card_runs_identical_text"] and out["card_equals_cpu_text"]):
        raise AssertionError(f"q8 card vs CPU disagree: {out}")
    return out


def parity_q8_phase(lgb, seed):
    X, y = higgs_like(50_000, seed + 7)
    return _parity_q8(lgb, X, y, dict(PARAMS, num_leaves=63))


def parity_q8_cat_phase(lgb, seed):
    X, y = expo_like(50_000, seed + 13)
    out = _parity_q8(lgb, X, y, dict(PARAMS, num_leaves=63), CAT_COLUMNS)
    if out["categorical_nodes"] <= 0:
        raise AssertionError(f"no categorical node: {out}")
    return out


VARIANT_RTOL = 1e-5     # of each cell's summed magnitudes (products exact)


def hist_variants_phase(cuda_hist):
    """Kernel 5 through its entry point, the experiment script's main at
    its defaults; then each variant's output against hist_onehot_plain on
    the same data, and the kernel, plain and library times."""
    from lightgbm_tpu_torch.scripts import exp_hist_variants as ev
    cuda_hist.reset_launch_counts()
    results, (binsT, rhs) = ev.main(["--reps", "5"])
    launches = cuda_hist.hist_onehot.launches
    failed = [r for r in results if "error" in r]
    if failed or launches <= 0:
        raise AssertionError(f"hist_variants: {failed}, {launches} launches")
    f, n = binsT.shape
    b = 255
    plain = cuda_hist.hist_onehot_plain(binsT, rhs, b)
    mag = cuda_hist.hist_onehot_plain(binsT, rhs.abs(), b)
    torch.cuda.synchronize()
    variants = {}
    for r in results:
        diff = (r.pop("out") - plain).abs()
        bad = diff > VARIANT_RTOL * mag
        if bool(bad.any()):
            raise AssertionError(f"hist_onehot fg={r['fg']} blk={r['blk']} "
                                 f"disagrees with its plain version at "
                                 f"{int(bad.sum())} cells")
        rel = float((diff / mag.clamp_min(1e-30)).max())
        binsT_p, rhs_p = ev.pad_rows(binsT, rhs, r["blk"])
        ms = time_ms(lambda: cuda_hist.hist_onehot(
            binsT_p, rhs_p, b, r["fg"], r["blk"]), reps=5, warm=1)
        variants[f"{r['fg']}x{r['blk']}"] = {
            "ms": ms, "script_ms_per_pass": r["ms_per_pass"],
            "max_abs_err": float(diff.max()), "max_rel_err": rel}
        del binsT_p, rhs_p
    plain_ms = time_ms(lambda: cuda_hist.hist_onehot_plain(binsT, rhs, b),
                       reps=3, warm=1)
    # the library stand-in: one cuBLAS bf16 matmul of the materialized
    # [F * B, N] one-hot against rhs (28.6 GB at the defaults); the fold of
    # its two halves is left out
    oh = torch.empty((f * b, n), dtype=torch.bfloat16, device="cuda")
    ar = torch.arange(b, device="cuda", dtype=torch.uint8)[:, None]
    for j in range(f):
        oh[j * b:(j + 1) * b] = (binsT[j][None, :] == ar).to(torch.bfloat16)
    library_ms = time_ms(lambda: torch.matmul(oh, rhs), reps=3, warm=1)
    del oh
    torch.cuda.empty_cache()
    # the function's least work: bins and rhs read once, out written once;
    # one f32 add per row and lane to fold the halves, one per (feature,
    # row, lane) to sum. The one-hot form's floor, its 2*N*F*B*256 bf16
    # products on the tensor cores (most of them by a zero), is kept apart.
    nbytes = f * n + n * 256 * 2 + f * b * 128 * 4
    bms, by = bound(nbytes, 1.0 * n * 128 * (f + 1))
    onehot_floor_ms = 2.0 * n * f * b * 256 / BF16_FLOP_PER_S * 1e3
    best = min(variants, key=lambda k: variants[k]["ms"])
    return {"rows": n, "features": f, "bins": b, "launches": launches,
            "variants": variants, "best": best, "ms": variants[best]["ms"],
            "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
            "max_rel_err": max(v["max_rel_err"] for v in variants.values()),
            "rtol": VARIANT_RTOL, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "torch.matmul of the materialized bf16 one-hot "
                       "(cuBLAS), halves not folded",
            "bound_ms": bms, "bound_by": by,
            "onehot_floor_ms": onehot_floor_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--valid-rows", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import cuda_hist
    t_start = time.time()

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.time()
    cuda_hist.build_kernels()
    ptxas = [ln.strip() for text in cuda_hist.build_log.values()
             for ln in text.splitlines() if "registers" in ln or "smem" in ln]
    emit("build", seconds=time.time() - t0, ptxas=ptxas)

    n = args.rows
    full = hist_phase(cuda_hist, n)
    emit("hist_tile", n=n, f=F, b=B, p=P, leaves=LEAVES, **full)
    rungs = {}
    for m in ladder_rungs(n):
        rungs[str(m)] = hist_phase(cuda_hist, n, m=m, seed=3)
    emit("hist_tile_gather", n=n, f=F, b=B, p=P, leaves=LEAVES, rungs=rungs)
    epi = epilogue_phase(cuda_hist)
    emit("split_epilogue", p=P, f=F, b=B, **epi)

    tr, launches = train_phase(lgb, cuda_hist, args)
    emit("train", **tr)
    emit("parity", **parity_phase(lgb, args.seed))

    plane_full = hist_phase(cuda_hist, n, f=F_CAT, plane=True, seed=5)
    plane_rungs = {str(m): hist_phase(cuda_hist, n, m=m, seed=6, f=F_CAT,
                                      plane=True)
                   for m in ladder_rungs(n)}
    emit("hist_plane", n=n, f=F_CAT, b=B, p=P, leaves=LEAVES, **plane_full,
         rungs=plane_rungs)
    tc, cat_launches = train_cat_phase(lgb, cuda_hist, args)
    emit("train_cat", **tc)
    emit("parity_cat", **parity_cat_phase(lgb, args.seed))
    emit("parity_sparse", **parity_sparse_phase(lgb, args.seed))

    q8_full = hist_q8_phase(cuda_hist, n, seed=21)
    q8_rungs = {str(m): hist_q8_phase(cuda_hist, n, m=m, seed=22)
                for m in ladder_rungs(n)}
    q8_plane = hist_q8_phase(cuda_hist, n, f=F_CAT, plane=True, seed=23)
    q8_plane_rungs = {str(m): hist_q8_phase(cuda_hist, n, m=m, seed=24,
                                            f=F_CAT, plane=True)
                      for m in ladder_rungs(n)}
    emit("hist_tile_q8", n=n, b=B, p=P, leaves=LEAVES,
         full={"f": F, **q8_full}, rungs=q8_rungs,
         plane={"f": F_CAT, **q8_plane}, plane_rungs=q8_plane_rungs)
    epi_q8 = epilogue_q8_phase(cuda_hist)
    emit("split_epilogue_q8", p=P, f=F, b=B, **epi_q8)
    tq, q8_launches = train_phase(lgb, cuda_hist, args,
                                  q8_ref_auc=tr["valid_auc"])
    emit("train_q8", **tq)
    tqc, q8_cat_launches = train_cat_phase(lgb, cuda_hist, args,
                                           q8_ref_auc=tc["valid_auc"])
    emit("train_q8_cat", **tqc)
    emit("parity_q8", **parity_q8_phase(lgb, args.seed))
    emit("parity_q8_cat", **parity_q8_cat_phase(lgb, args.seed))

    hv = hist_variants_phase(cuda_hist)
    emit("hist_variants", **hv)

    hist_err = max([full["max_abs_err"]]
                   + [r["max_abs_err"] for r in rungs.values()])
    plane_err = max([plane_full["max_abs_err"]]
                    + [r["max_abs_err"] for r in plane_rungs.values()])
    kernels = [
        {"name": "hist_tile", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:497 _fused_epi_kernel "
                     "+ :527 _gather_epi_kernel (accumulation)",
         "launches": launches["hist_tile.launches"], "max_abs_err": hist_err,
         "ms": full["ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "library_ms": full["library_ms"],
         "gather_launches": launches["hist_tile.gather_launches"],
         "gather_ms": {k: v["ms"] for k, v in rungs.items()},
         "gather_bound_ms": {k: v["bound_ms"] for k, v in rungs.items()}},
        {"name": "hist_tile (plane-only)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:154 _fused_kernel "
                     "(pallas_call :270) + :205 _gather_kernel "
                     "(pallas_call :324)",
         "launches": cat_launches["hist_tile.launches_plane"],
         "max_abs_err": plane_err, "ms": plane_full["ms"],
         "plain_ms": plane_full["plain_ms"],
         "bound_ms": plane_full["bound_ms"],
         "bound_by": plane_full["bound_by"],
         "library_ms": plane_full["library_ms"],
         "gather_launches": cat_launches["hist_tile.gather_launches"],
         "gather_ms": {k: v["ms"] for k, v in plane_rungs.items()},
         "gather_bound_ms": {k: v["bound_ms"]
                             for k, v in plane_rungs.items()}},
        {"name": "split_epilogue", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_epilogue.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:465 _epilogue_compute "
                     "(epilogue of :497 and :527)",
         "launches": launches["split_epilogue.launches"],
         "max_abs_err": epi["max_abs_err"], "ms": epi["ms"],
         "plain_ms": epi["plain_ms"], "bound_ms": epi["bound_ms"],
         "bound_by": epi["bound_by"], "library_ms": None},
        {"name": "hist_tile (q8)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:497 _fused_epi_kernel "
                     "(pallas_call :588) + :527 _gather_epi_kernel "
                     "(pallas_call :663), mode q8 (accumulation)",
         "launches": q8_launches["hist_tile.launches_q8"],
         "max_abs_err": max([q8_full["max_abs_err"]]
                            + [r["max_abs_err"] for r in q8_rungs.values()]),
         "ms": q8_full["ms"], "plain_ms": q8_full["plain_ms"],
         "bound_ms": q8_full["bound_ms"], "bound_by": q8_full["bound_by"],
         "library_ms": q8_full["library_ms"],
         "gather_launches": q8_launches["hist_tile.gather_launches_q8"],
         "gather_ms": {k: v["ms"] for k, v in q8_rungs.items()},
         "gather_bound_ms": {k: v["bound_ms"] for k, v in q8_rungs.items()}},
        {"name": "hist_tile (plane-only, q8)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:154 _fused_kernel "
                     "(pallas_call :270) + :205 _gather_kernel "
                     "(pallas_call :324), mode q8",
         "launches": q8_cat_launches["hist_tile.launches_plane_q8"],
         "max_abs_err": max([q8_plane["max_abs_err"]]
                            + [r["max_abs_err"]
                               for r in q8_plane_rungs.values()]),
         "ms": q8_plane["ms"], "plain_ms": q8_plane["plain_ms"],
         "bound_ms": q8_plane["bound_ms"], "bound_by": q8_plane["bound_by"],
         "library_ms": q8_plane["library_ms"],
         "gather_launches": q8_cat_launches["hist_tile.gather_launches_q8"],
         "gather_ms": {k: v["ms"] for k, v in q8_plane_rungs.items()},
         "gather_bound_ms": {k: v["bound_ms"]
                             for k, v in q8_plane_rungs.items()}},
        {"name": "split_epilogue (q8)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_epilogue.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:465 _epilogue_compute "
                     "mode q8 (dequant + epilogue of :497 and :527)",
         "launches": q8_launches["split_epilogue.launches_q8"],
         "max_abs_err": epi_q8["max_abs_err"], "ms": epi_q8["ms"],
         "plain_ms": epi_q8["plain_ms"], "bound_ms": epi_q8["bound_ms"],
         "bound_by": epi_q8["bound_by"], "library_ms": None},
        {"name": "hist_onehot", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_onehot.cu",
         "replaces": "scripts/exp_hist_variants.py:22 kernel in make_variant "
                     "(pallas_call :44)",
         "launches": hv["launches"], "max_abs_err": hv["max_abs_err"],
         "max_rel_err": hv["max_rel_err"], "ms": hv["ms"],
         "variant": hv["best"],
         "variant_ms": {k: v["ms"] for k, v in hv["variants"].items()},
         "plain_ms": hv["plain_ms"], "bound_ms": hv["bound_ms"],
         "bound_by": hv["bound_by"], "library_ms": hv["library_ms"],
         "onehot_floor_ms": hv["onehot_floor_ms"]},
    ]
    print(json.dumps({"kernels": kernels,
                      "total_seconds": time.time() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
