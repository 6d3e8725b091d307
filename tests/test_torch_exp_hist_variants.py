"""Kernel 5, the experiment script's one-hot histogram: the port's
``lightgbm_tpu_torch/scripts/exp_hist_variants.py`` against the JAX
script ``scripts/exp_hist_variants.py``.

The plain version of the port's tensor-core kernel (``hist_onehot_plain``,
what ``make_variant``'s callable runs on a CPU tensor) is held to the JAX
``make_variant`` kernel run through the Pallas interpreter, on the same
bins and bf16 right-hand side made with numpy. Every product of a 0/1
one-hot entry and a bf16 value is exact in float32; only the order of the
float32 sums differs (the JAX kernel sums each 128-lane half over a block
of rows, folds the halves and adds the block into the output; the plain
version adds the folded rows one by one). The bar is ``rtol=1e-5`` of each
cell's summed magnitudes. The kernel itself needs the card: it is held to
its plain version by ``chip_smoke.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.scripts import exp_hist_variants as tv

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, F, B = 4096, 5, 31


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_exp_hist_variants", REPO / "scripts" / "exp_hist_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    orig_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        kwargs["interpret"] = True
        return orig_call(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


def _data(seed=0, n=N, f=F, b=B):
    rng = np.random.RandomState(seed)
    binsT = rng.randint(0, b, size=(f, n)).astype(np.uint8)
    rhs = torch.from_numpy(rng.normal(size=(n, 256)).astype(np.float32)
                           ).to(torch.bfloat16)
    return binsT, rhs


@pytest.mark.parametrize("fg", [2, 4])
def test_plain_matches_jax_make_variant(fg, interpret):
    binsT, rhs = _data()
    rhs_f32 = rhs.to(torch.float32).numpy()
    ref = np.asarray(_jax_script().make_variant(fg, 1024)(
        jnp.asarray(binsT), jnp.asarray(rhs_f32).astype(jnp.bfloat16),
        num_bins=B))
    out = tv.make_variant(fg, 1024)(torch.from_numpy(binsT), rhs,
                                    num_bins=B).numpy()
    assert out.shape == ref.shape == (F * B, 128)
    mag = cuda_hist.hist_onehot_plain(torch.from_numpy(binsT),
                               rhs.to(torch.float32).abs().to(torch.bfloat16),
                               B).numpy()
    assert np.all(np.abs(out - ref) <= 1e-5 * mag)
    assert np.abs(out).max() > 1.0


def test_plain_is_the_folded_histogram():
    """The plain version against a float64 numpy histogram of the folded
    rows; bins >= num_bins add nothing."""
    binsT, rhs = _data(seed=1, n=3000, f=3, b=17)
    binsT[1, :50] = 200
    fold = (rhs[:, :128].to(torch.float64) + rhs[:, 128:].to(torch.float64)
            ).numpy()
    ref = np.zeros((3 * 17, 128))
    for j in range(3):
        keep = binsT[j] < 17
        np.add.at(ref, j * 17 + binsT[j][keep].astype(np.int64), fold[keep])
    out = cuda_hist.hist_onehot_plain(torch.from_numpy(binsT), rhs, 17).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def test_entry_point_on_cpu(capsys):
    """``python -m lightgbm_tpu_torch.scripts.exp_hist_variants``'s main at
    a small size: one line per variant, rows padded to the block (the
    padding adds nothing), a bad variant reported as FAILED after which
    the other variants still run and the run fails."""
    with pytest.raises(tv.VariantsFailed, match="0x64") as failed:
        tv.main(["--rows", "1000", "--features", "3", "--bins", "15",
                 "--reps", "1", "--variants", "2x256,3x64,0x64"],
                device="cpu")
    res, (binsT0, _) = failed.value.results, failed.value.data
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "fg=2 blk=256", "fg=3 blk=64", "fg=0 blk=64"]
    assert "ms/pass" in lines[0] and "FAILED" in lines[2]
    binsT, rhs = tv.make_data(1000, 3, 15, torch.device("cpu"))
    assert torch.equal(binsT, binsT0) and binsT.shape == (3, 1000)
    want = cuda_hist.hist_onehot_plain(binsT, rhs, 15)
    for r in res[:2]:
        np.testing.assert_array_equal(r["out"].numpy(), want.numpy())


def test_entry_point_fails_on_a_failed_variant(monkeypatch, capsys):
    """A variant whose call raises (here ``blk`` that does not divide the
    rows, through a ``pad_rows`` that pads nothing) is printed as FAILED,
    the variants after it still run, and the run ends in an error: the
    entry point does not exit 0 on a failed variant."""
    monkeypatch.setattr(tv, "pad_rows", lambda binsT, rhs, blk: (binsT, rhs))
    with pytest.raises(tv.VariantsFailed, match="1x96") as failed:
        tv.main(["--rows", "1024", "--features", "2", "--bins", "7",
                 "--reps", "1", "--variants", "1x96,2x64"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("fg=1 blk=96: FAILED ValueError")
    assert lines[1].startswith("fg=2 blk=64:") and "ms/pass" in lines[1]
    res = failed.value.results
    assert "multiple of blk" in res[0]["error"] and "out" in res[1]
    # without the failing variant the same run returns
    out, _ = tv.main(["--rows", "1024", "--features", "2", "--bins", "7",
                      "--reps", "1", "--variants", "2x64"], device="cpu")
    np.testing.assert_array_equal(out[0]["out"].numpy(),
                                  res[1]["out"].numpy())


@pytest.mark.parametrize("f,n,b,fg", [
    (28, 2_001_920, 255, 2), (28, 2_000_896, 255, 7), (5, 4096, 31, 4),
    (1, 1024, 2, 3), (3, 4096, 1, 1), (40, 8192, 256, 28)])
def test_onehot_layout_covers_rows_and_features(f, n, b, fg):
    """The kernel's launch geometry (``onehot_layout``, 132 SMs): chunks of
    whole 64-row stages that cover the N rows, tiles of 256 one-hot rows
    per feature group, and a bins box that holds every feature a tile's
    rows meet."""
    tpg, ntiles, nf_box, nchunk, per = cuda_hist.onehot_layout(
        f, n, b, fg, 132)
    assert per % 64 == 0 and (nchunk - 1) * per < n <= nchunk * per
    assert ntiles == -(-f // fg) * tpg
    assert tpg * 256 >= fg * b > (tpg - 1) * 256
    assert 1 <= nf_box <= min(fg, 256)
    for t in range(tpg):
        first, last = t * 256, min(fg * b, t * 256 + 256) - 1
        assert last // b - first // b + 1 <= nf_box
    if n > 2_000_000:
        # the script's defaults: 28 tiles, whole waves of one block per SM
        assert ntiles * nchunk % 132 == 0


def test_wrapper_checks_and_counts_no_cpu_launch():
    binsT, rhs = _data(seed=2, n=640, f=2, b=9)
    cuda_hist.reset_launch_counts()
    out = cuda_hist.hist_onehot(torch.from_numpy(binsT), rhs, 9, 2, 64)
    assert out.shape == (18, 128)
    assert cuda_hist.launch_counts()["hist_onehot.launches"] == 0
    with pytest.raises(ValueError, match="multiple of blk"):
        cuda_hist.hist_onehot(torch.from_numpy(binsT), rhs, 9, 2, 100)
    meta = torch.empty((2, 640), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_hist.hist_onehot(meta, rhs.to("meta"), 9, 2, 64)
