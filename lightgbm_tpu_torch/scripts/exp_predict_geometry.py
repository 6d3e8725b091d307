"""Experiments on the ensemble-traversal kernel's launch geometries, and
on the first predict of a new model (the engine build included).

The default times ``predict_ensemble``'s float64 mode on random trees and
bins in every geometry that fits each shape, the rule's choice
(``ops/predict.py launch_geometry``) beside the other, each held bitwise
to the rule's output: Higgs' 28 uint8 columns at 2M rows x 100 trees of
255 leaves; Epsilon's 2,000 columns; 255 to 4,095 leaves, with and
without EFB segments; categorical bitsets of 8 and 128 words (the tiled
mode also past the rule's 16 KB stage, on numerical trees). ``--cold``
times a new engine's first accumulation over 2M rows (``PredictEngine``:
the trees packed and placed on the card, then the launch) at 100 and 500
trees of 255 leaves, against the same engine's second call.

    python lightgbm_tpu_torch/scripts/exp_predict_geometry.py \\
        [--cold] [--package DIR] [--seed 0]

``--package DIR`` imports ``lightgbm_tpu_torch`` from DIR (another
checkout: the same measurement on its package). One JSON object a line;
times are CUDA events (median of 10, the L2 flushed before each) and host
seconds (median of 5). Needs a CUDA device. Not part of the library: the
results feed the kernel's geometry rule.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cold", action="store_true")
    ap.add_argument("--package", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


ARGS = _args() if __name__ == "__main__" else None
if ARGS is not None:
    sys.path.insert(0, os.path.abspath(ARGS.package or os.path.join(
        os.path.dirname(__file__), "..", "..")))

import torch  # noqa: E402

from lightgbm_tpu_torch.models.tree import empty_tree, stack_trees  # noqa
from lightgbm_tpu_torch.ops import cuda_hist  # noqa: E402
from lightgbm_tpu_torch.ops import predict as P  # noqa: E402


def random_trees(count, leaves, f, bins, seed, segments=False, words=0):
    """``count`` random unbalanced trees of ``leaves`` leaves over ``f``
    columns of ``bins`` bins (a leaf drawn at random splits next); with
    ``segments`` a third of the nodes on EFB segments, with ``words`` a
    third categorical with random bitsets of that many words."""
    rng = np.random.RandomState(seed)
    trees = []
    for _ in range(count):
        li = leaves - 1
        left, right = np.zeros(li, np.int32), np.zeros(li, np.int32)
        open_leaves, link, depth = [0], {}, {0: 0}
        for node in range(li):
            leaf = open_leaves.pop(rng.randint(len(open_leaves)))
            if leaf in link:
                arr, pos = link.pop(leaf)
                arr[pos] = node
            new = node + 1
            left[node], right[node] = ~leaf, ~new
            link[leaf], link[new] = (left, node), (right, node)
            depth[leaf] = depth[new] = depth[leaf] + 1
            open_leaves += [leaf, new]
        t = empty_tree(leaves, cat_words=max(words, 1))._replace(
            num_leaves=torch.tensor(leaves, dtype=torch.int32),
            node_feature=torch.as_tensor(rng.randint(0, f, li),
                                         dtype=torch.int32),
            node_threshold_bin=torch.as_tensor(rng.randint(0, bins - 1, li),
                                               dtype=torch.int32),
            node_default_left=torch.as_tensor(rng.rand(li) < 0.5),
            node_left=torch.as_tensor(left),
            node_right=torch.as_tensor(right),
            leaf_value=torch.as_tensor(rng.randn(leaves).astype(np.float32)),
            leaf_depth=torch.as_tensor(
                np.array([depth[i] for i in range(leaves)], np.int32)))
        if segments:
            lo = rng.randint(0, bins // 2, li)
            seg = rng.rand(li) < 1 / 3
            t = t._replace(
                node_seg_lo=torch.as_tensor(np.where(seg, lo, -1),
                                            dtype=torch.int32),
                node_seg_hi=torch.as_tensor(np.where(seg, lo + bins // 3, -1),
                                            dtype=torch.int32))
        if words:
            t = t._replace(
                node_cat=torch.as_tensor(rng.rand(li) < 1 / 3),
                node_cat_bitset=torch.as_tensor(
                    rng.randint(0, 2 ** 32, size=(li, words)),
                    dtype=torch.int64))
        trees.append(t)
    return stack_trees(trees)


def random_bins(n, f, bins, seed):
    rng = np.random.RandomState(seed)
    dtype = np.uint8 if bins <= 256 else np.int16
    binsT = torch.as_tensor(rng.randint(0, bins, size=(f, n)).astype(dtype))
    mb = torch.as_tensor(rng.randint(-1, bins, size=f), dtype=torch.int32)
    return binsT.cuda(), mb.cuda()


_flush = None


def time_ms(fn, reps=10, warm=2):
    """Median CUDA-event ms of ``fn``, the L2 flushed before each."""
    global _flush
    if _flush is None:
        _flush = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        _flush.fill_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def forced(mode, g, tables, n, f, bin_bytes):
    """The shape laid out as ``mode`` (None when it cannot take it): the
    tiled mode also past the rule's stage limit, on numerical trees whose
    tiles fit."""
    if mode == "global":
        return P.Geometry("global", max(-(-n // 256), 1), 256, 1, 256, 0, 0,
                          g.stage, 0, 0)
    if g.mode == "tiled":
        return g
    if tables.has_cat or tables.has_seg or not 1 <= f <= 4096:
        return None
    # the tiled layout of small trees, with this shape's stage
    tile = P.launch_geometry(n, f, bin_bytes, 254, 255, False)
    chunk = min(max(40 * 1024 // (2 * g.stage.bytes), 1), 16)
    smem = tile.off_trees + 2 * chunk * g.stage.bytes
    if tile.mode != "tiled" or smem > cuda_hist.SMEM_PER_BLOCK:
        return None
    return tile._replace(chunk_trees=chunk, stage=g.stage, smem=smem)


def geometry_case(name, stacked, binsT, mb):
    tables = P.pack_ensemble(stacked, int(stacked.leaf_depth.max()), "cuda")
    f, n = binsT.shape
    t = int(tables.nodes.shape[0])
    rule = P.launch_geometry
    g = rule(n, f, binsT.element_size(), int(tables.nodes.shape[1]),
             int(stacked.leaf_value.shape[1]), tables.has_cat, tables.has_seg,
             torch.cuda.get_device_properties(0).multi_processor_count)
    if tables.stage is None and not (tables.has_cat or tables.has_seg):
        tables = tables._replace(
            stage=P.stage_ensemble(tables.stacked, tables.nodes,
                                   tables.depth))
    want = P.predict_ensemble(tables, binsT, mb, (0, t), 1)
    row = {"case": name, "rows": n, "columns": f, "trees": t,
           "leaves_cap": int(stacked.leaf_value.shape[1]),
           "bins": str(binsT.dtype), "stage_bytes": g.stage.bytes,
           "rule": g.mode, "ms": {}}
    geos = {mode: forced(mode, g, tables, n, f, binsT.element_size())
            for mode in P.GEOMETRY_MODES}   # before the rule is replaced
    try:
        for mode, geo in geos.items():
            if geo is None:
                continue
            P.launch_geometry = lambda *a, _g=geo, **k: _g
            got = P.predict_ensemble(tables, binsT, mb, (0, t), 1)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: {mode} differs from {g.mode}")
            row["ms"][mode] = time_ms(
                lambda: P.predict_ensemble(tables, binsT, mb, (0, t), 1))
    finally:
        P.launch_geometry = rule
    print(json.dumps(row), flush=True)


def geometry(seed):
    n2m, n200k = 2_000_000, 200_000
    binsT, mb = random_bins(n2m, 28, 255, seed)
    geometry_case("higgs_2M_100x255", random_trees(100, 255, 28, 255, seed),
                  binsT, mb)
    binsT, mb = binsT[:, :n200k].contiguous(), mb
    for leaves, count in ((255, 20), (1023, 20), (2047, 8), (4095, 8)):
        for seg in (False, True):
            geometry_case(f"leaves_{leaves}{'_segments' if seg else ''}"
                          f"_200k", random_trees(count, leaves, 28, 255,
                                                 seed + leaves, seg),
                          binsT, mb)
    geometry_case("categorical_8_words_200k",
                  random_trees(20, 255, 28, 255, seed + 1, words=8),
                  binsT, mb)
    wb, wmb = random_bins(n200k, 28, 4096, seed + 2)
    geometry_case("categorical_128_words_int16_200k",
                  random_trees(20, 255, 28, 4096, seed + 2, words=128),
                  wb, wmb)
    del wb, wmb
    eb, emb = random_bins(n200k, 2000, 255, seed + 3)
    geometry_case("epsilon_2000_columns_200k",
                  random_trees(20, 255, 2000, 255, seed + 3), eb, emb)


def cold(seed):
    from lightgbm_tpu_torch.models.predict_engine import PredictEngine
    binsT, mb = random_bins(2_000_000, 28, 255, seed)
    for count in (100, 500):
        stacked = random_trees(count, 255, 28, 255, seed + count)
        depth = int(stacked.leaf_depth.max())
        firsts, seconds, builds = [], [], []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = PredictEngine(stacked, 1, count, depth, device="cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.accumulate([binsT], mb, use_bias=False)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            eng.accumulate([binsT], mb, use_bias=False)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            builds.append(t1 - t0)
            firsts.append(t2 - t0)
            seconds.append(t3 - t2)
        # the first engine also loaded the library: left out
        print(json.dumps({"cold_trees": count, "rows": 2_000_000,
                          "engine_build_s": statistics.median(builds[1:]),
                          "first_call_s": statistics.median(firsts[1:]),
                          "second_call_s": statistics.median(seconds[1:])}),
              flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_predict_geometry: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0] if smi else "not read",
                      "package": os.path.dirname(P.__file__)}), flush=True)
    cuda_hist.build_kernels()
    if ARGS.cold:
        cold(ARGS.seed)
    else:
        geometry(ARGS.seed)


if __name__ == "__main__":
    main()
