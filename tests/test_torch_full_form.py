"""The full-row form of the port's ``hist_tile`` (its plain version
``full_accumulate_plain``) against the JAX package.

``full_accumulate_plain`` repeats the arithmetic of the Hopper full form
(``csrc/hist_tile.cu``): for a tile of one computed slot -- the root pass
-- ``full_accumulate``'s row blocks and feature groups, each f32 cell kept
as two 32-bit words with the low word's carries, the blocks' cells added
as int64 and converted once; for a tile of several computed slots, the
gather form's partition and accumulation over all N rows. It is held,
at the root shape (one computed slot, every row in it), at a one-slot
tile whose other rows are dropped and at a tile of several slots with
leaves outside it, at F = 28, 8 and 40 (two feature groups in f32), to:

- the interpreted Pallas ``_fused_kernel`` (``histogram_tiles_pallas_mode``,
  mode "highest") on integer-valued stats, bitwise, and in mode "q8" on
  int8 stats (exact int32 sums), bitwise;
- ``hist_tile_exact`` (the kernel's fixed-point arithmetic written
  plainly) on float stats, bitwise, for any number of row blocks;
- the interpreted Pallas ``_fused_epi_kernel``
  (``histogram_tiles_pallas_epilogue``) followed by the port's plain
  epilogue, tile and candidates bitwise, in modes "highest" and "q8".

The kernel itself needs the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold it to these plain versions there.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops import pallas_hist as jph
from lightgbm_tpu_torch.ops import cuda_hist

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

CASES = ["root", "one_slot", "slots"]
WIDTHS = [28, 8, 40]
B = 255
N_LEAVES = 12


def _case(case, f, seed=30):
    """(binsT, leaf, sel, derive) of one full-form pass over 900 rows.
    ``root``: one computed slot, every row in it; ``one_slot``: the
    computed slot's leaf holds about a twelfth of the rows, its derived
    sibling another, the rest are dropped; ``slots``: the computed slots of
    sibling pairs, leaves outside the tile and ids >= N_LEAVES dropped."""
    rng = np.random.RandomState(seed + f)
    n = 900
    binsT = rng.randint(0, B, size=(f, n)).astype(np.uint8)
    derive = np.zeros(8, bool)
    if case == "root":
        sel = np.array([0, -1, -1, -1, -1, -1, -1, -1], np.int32)
        leaf = np.zeros(n, np.int32)
    elif case == "one_slot":
        sel = np.array([5, 4, -1, -1, -1, -1, -1, -1], np.int32)
        derive[1] = True
        leaf = rng.randint(0, N_LEAVES, n).astype(np.int32)
    else:
        sel = np.array([0, 2, 5, 7, 9, 11, -1, -1], np.int32)
        derive[[1, 3]] = True
        leaf = rng.randint(0, N_LEAVES + 2, n).astype(np.int32)
    return binsT, leaf, sel, derive


def _computed(sel, derive):
    return np.where(derive, -1, sel).astype(np.int32)


def _plain(binsT, leaf, stats, sel, amax=None, blocks=3):
    return cuda_hist.full_accumulate_plain(
        torch.from_numpy(binsT), torch.from_numpy(leaf),
        torch.from_numpy(stats), cuda_hist.chan_leaf_table(
            torch.from_numpy(sel)), len(sel), B, N_LEAVES,
        None if amax is None else torch.from_numpy(amax), blocks)


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_full_form_matches_pallas_fused_kernel(case, f):
    """Integer-valued f32 stats: bitwise the interpreted _fused_kernel in
    mode "highest"; int8 stats: bitwise it in mode "q8"."""
    binsT, leaf, sel, derive = _case(case, f)
    sel = _computed(sel, derive)
    rng = np.random.RandomState(31)
    n = leaf.shape[0]
    for mode, stats in (
            ("highest", (rng.randint(-1023, 1024, (n, 3)) / 1024.0
                         ).astype(np.float32)),
            ("q8", rng.randint(-127, 128, (n, 3)).astype(np.int8))):
        ref = jph.histogram_tiles_pallas_mode(
            jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
            jnp.asarray(sel), B, block=512, mode=mode, interpret=True)
        out = _plain(binsT, leaf, stats, sel)
        assert out.dtype == (torch.int32 if mode == "q8" else torch.float32)
        _bits_equal(out.numpy(), ref)


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_full_form_matches_exact_on_float_stats(case, f):
    """Float stats of mixed magnitudes (carries out of the low word, both
    signs): bitwise hist_tile_exact whatever the row blocks, with the
    caller's amax or without; a non-finite stat makes its channel NaN."""
    binsT, leaf, sel, derive = _case(case, f)
    sel = _computed(sel, derive)
    rng = np.random.RandomState(32)
    n = leaf.shape[0]
    stats = (rng.randn(n, 3) * 10.0 ** rng.uniform(-6, 3, (n, 3))
             ).astype(np.float32)
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(sel))
    args = (torch.from_numpy(binsT), torch.from_numpy(leaf),
            torch.from_numpy(stats), chan, len(sel), B, N_LEAVES)
    exact = cuda_hist.hist_tile_exact(*args).numpy()
    assert np.abs(exact).max() > 0
    for blocks in (1, 3, 29):
        _bits_equal(_plain(binsT, leaf, stats, sel, blocks=blocks).numpy(),
                    exact)
    _bits_equal(_plain(binsT, leaf, stats, sel,
                       np.abs(stats).max(0)).numpy(), exact)
    bad = stats.copy()
    bad[7, 1] = np.inf
    out = _plain(binsT, leaf, bad, sel).numpy()
    computed = sel >= 0
    assert np.isnan(out[computed][..., 1]).all()
    _bits_equal(out[..., 0], exact[..., 0])


@pytest.mark.parametrize("mode", ["highest", "q8"])
@pytest.mark.parametrize("case", CASES)
def test_full_form_matches_pallas_fused_epi_kernel(case, mode):
    """The fused full pass: the interpreted Pallas _fused_epi_kernel
    against the full form's plain version over the computed slots followed
    by split_epilogue_plain, tile and candidates bitwise, on integer-valued
    f32 stats and on int8 stats (dequantized by q_scale in the
    epilogue)."""
    binsT, leaf, sel, derive = _case(case, 8)
    n, f = leaf.shape[0], binsT.shape[0]
    rng = np.random.RandomState(33)
    q8 = mode == "q8"
    if q8:
        stats = rng.randint(-127, 128, (n, 3)).astype(np.int8)
        q_scale = np.array([0.0137, 0.00291, 1.0], np.float32)
    else:
        stats = (rng.randint(-1023, 1024, (n, 3)) / 1024.0).astype(np.float32)
        q_scale = None
    stats[:, 1] = np.abs(stats[:, 1])
    stats[:, 2] = 1
    # every slot's full plane (exact: integer sums), the derived slots'
    # parents and the leaf aggregates
    full = cuda_hist.hist_tile_plain(
        torch.from_numpy(binsT), torch.from_numpy(leaf),
        torch.from_numpy(stats), cuda_hist.chan_leaf_table(
            torch.from_numpy(sel)), len(sel), B, N_LEAVES).numpy()
    full = full.astype(np.float32) * (1.0 if q_scale is None else q_scale)
    parent = np.zeros_like(full)
    for i in np.nonzero(derive)[0]:
        parent[i] = full[i] + full[i - 1]
    sums = full[:, 0].sum(1)
    out = sums[:, 0] * np.float32(-0.1) / (sums[:, 1] + 1)
    la = cuda_hist.pack_leaf_aux(*(torch.from_numpy(np.ascontiguousarray(c))
                                   for c in (sums[:, 0], sums[:, 1],
                                             sums[:, 2], out)))
    fm = cuda_hist.pack_feature_meta(*(torch.from_numpy(c) for c in (
        np.full(f, B, np.int32), np.zeros(f, np.int32),
        np.zeros(f, np.int32), np.zeros(f, np.int32))))
    pv = np.array([0.0, 1.0, 0.0, 0.0, 2.0, 1e-3, 0.0, 0.0], np.float32)
    jt, jc = jph.histogram_tiles_pallas_epilogue(
        jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
        jnp.asarray(sel), jnp.asarray(derive), jnp.asarray(parent),
        jnp.asarray(la.numpy()), jnp.asarray(fm.numpy()),
        jnp.asarray(pv[:7]), B, block=512, mode=mode, interpret=True,
        q_scale=None if q_scale is None else jnp.asarray(q_scale))
    tile = _plain(binsT, leaf, stats, _computed(sel, derive))
    tt, tc = cuda_hist.split_epilogue_plain(
        tile, torch.from_numpy(parent), cuda_hist._epilogue_lanes(
            torch.from_numpy(sel), torch.from_numpy(derive)), la, fm,
        torch.from_numpy(pv),
        None if q_scale is None else torch.from_numpy(q_scale))
    _bits_equal(tt.numpy(), jt)
    _bits_equal(tc.numpy(), jc)
    assert np.isfinite(np.asarray(jc)[..., 0]).any()


def test_full_layout_and_the_cpu_switch():
    """The full form's launch shape -- all 28 Higgs features in one
    block, 40 features in two groups of 20 in f32 and 80 in two of 40 in
    q8, the row-major bin copy the gather form's -- and
    kernel_sums_on_cpu, which sends a CPU full pass through the full
    form's plain version (a card run's bits)."""
    assert cuda_hist.full_layout(28, 255, False) == (28, 32)
    assert cuda_hist.full_layout(28, 255, True) == (28, 32)
    assert cuda_hist.full_layout(8, 255, False) == (8, 8)
    assert cuda_hist.full_layout(40, 255, False) == (20, 64)
    assert cuda_hist.full_layout(80, 255, True) == (40, 96)
    for f in (8, 28, 40, 80):
        assert cuda_hist.full_layout(f, 255, False)[1] == \
            cuda_hist.gather_layout(f, 255, False)[1]
    binsT, leaf, sel, _ = _case("root", 28)
    stats = np.random.RandomState(34).randn(leaf.shape[0], 3).astype(
        np.float32)
    args = (torch.from_numpy(binsT), torch.from_numpy(leaf),
            torch.from_numpy(stats),
            cuda_hist.chan_leaf_table(torch.from_numpy(sel)), len(sel), B,
            N_LEAVES)
    with cuda_hist.kernel_sums_on_cpu():
        on = cuda_hist.hist_tile(*args)
    _bits_equal(on.numpy(), cuda_hist.hist_tile_exact(*args).numpy())
    _bits_equal(cuda_hist.hist_tile(*args).numpy(),
                cuda_hist.hist_tile_plain(*args).numpy())
