"""The collective layer and the distributed front end of the PyTorch port
(``lightgbm_tpu_torch/network.py``, ``distributed.py``), against the JAX
package's collectives on the CPU.

- ``fold_sum`` and ``fold_sum_scatter`` are bitwise ``jax.lax.psum`` and
  ``psum_scatter(tiled=True)`` under ``shard_map`` at W = 2 and 8 (XLA:CPU
  adds in rank order; float32 values spanning 2^-29..2^29);
  ``reduce_scatter_int``, ``allreduce_max``, ``allgather_object`` and
  ``exchange_host`` are exact; ``sync_best`` gives a tie to the lowest
  rank; the backend choice follows the topology and refuses NCCL on a
  shared card.
- ``hist_tile``'s integer-planes mode: the int64 planes of W row slices at
  the gang's exponent, summed (and reduce-scattered), then converted,
  equal one pass over all rows (``hist_tile_exact``) in f32 and f64; the
  q8 planes add exactly too.
- The refusals of the distributed learners carry the JAX package's
  messages; ``_rank_from_machines`` resolves a rank by address and port.
- One gang of two processes (``spawn``): ``load_partitioned`` gives both
  ranks the same bin mappers and the replicated run's model text,
  ``train_distributed`` with two parts the same text, and
  ``free_network`` / ``set_network`` leave and join a gang of two, the
  CLI's network keys join one; a failing rank fails its gang with its
  traceback.

The ranks run as threads over ``ProcessGroupGloo`` and a ``HashStore``
(``network.thread_gang``) but in the gang tests.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.parallel.learners import _shard_map
from lightgbm_tpu_torch import distributed, network
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops.split import SplitInfo
from lightgbm_tpu_torch.utils.log import LightGBMError

sys.path.insert(0, os.path.dirname(__file__))
import torch_gang_cases as gc  # noqa: E402

torch.set_num_threads(1)


def _values(w, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(w, n) * np.exp2(rng.randint(-29, 30, (w, n)))
            ).astype(np.float32)


def _mesh(w):
    return Mesh(np.asarray(jax.devices()[:w]), ("r",))


@pytest.mark.parametrize("w", [2, 8])
def test_fold_sum_is_psum_bitwise(w):
    x = _values(w, 4096, w)
    fn = jax.jit(_shard_map(lambda v: jax.lax.psum(v, "r"), mesh=_mesh(w),
                            in_specs=P("r"), out_specs=P()))
    ref = np.asarray(fn(jnp.asarray(x.reshape(-1))))
    outs = network.thread_gang(
        w, lambda net: net.fold_sum(torch.from_numpy(x[net.rank])).numpy())
    for o in outs:
        np.testing.assert_array_equal(o.view(np.uint32), ref.view(np.uint32))
    # a pairwise sum differs somewhere: the order is what is pinned
    pair = x.copy()
    while pair.shape[0] > 1:
        pair = pair[0::2] + pair[1::2]
    assert not np.array_equal(pair[0], ref) or w == 2


@pytest.mark.parametrize("w", [2, 8])
def test_fold_sum_scatter_is_psum_scatter_bitwise(w):
    c = 96
    x = _values(w, w * c * 3, 10 + w).reshape(w, w * c, 3)
    fn = jax.jit(_shard_map(
        lambda v: jax.lax.psum_scatter(v[0], "r", scatter_dimension=0,
                                       tiled=True),
        mesh=_mesh(w), in_specs=P("r"), out_specs=P("r")))
    ref = np.asarray(fn(jnp.asarray(x))).reshape(w, c, 3)
    outs = network.thread_gang(w, lambda net: net.fold_sum_scatter(
        torch.from_numpy(x[net.rank]), 0).numpy())
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o.view(np.uint32),
                                      ref[r].view(np.uint32))


def test_integer_collectives_and_objects():
    w = 4
    rng = np.random.RandomState(3)
    xi = rng.randint(-2 ** 40, 2 ** 40, (w, 8, 5)).astype(np.int64)

    def body(net):
        r = net.rank
        rs = net.reduce_scatter_int(torch.from_numpy(xi[r]), 0)
        mx = net.allreduce_max(torch.tensor([float(r), -float(r)]))
        objs = net.allgather_object({"rank": r, "tag": "x" * (r + 1)})
        host = net.exchange_host("t", f"p{r}")
        net.barrier()
        return rs.numpy(), mx.numpy(), objs, host, net.totals()

    outs = network.thread_gang(w, body)
    total = xi.sum(0)
    for r, (rs, mx, objs, host, tot) in enumerate(outs):
        np.testing.assert_array_equal(rs, total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(mx, [w - 1, 0])
        assert objs == [{"rank": q, "tag": "x" * (q + 1)} for q in range(w)]
        assert host == [f"p{q}" for q in range(w)]
        assert tot["calls"] >= 4 and tot["bytes"] > 0
    with pytest.raises(TypeError, match="integers"):
        network.Network().reduce_scatter_int(torch.zeros(4), 0)


def _info(gains, feature):
    L = len(gains)
    z = torch.zeros((L,), dtype=torch.float32)
    zi = torch.zeros((L,), dtype=torch.int32)
    return SplitInfo(
        gain=torch.tensor(gains, dtype=torch.float32),
        feature=torch.tensor(feature, dtype=torch.int32), threshold=zi,
        default_left=torch.zeros((L,), dtype=torch.bool),
        left_sum_g=z, left_sum_h=z, left_count=z, right_sum_g=z,
        right_sum_h=z, right_count=z, left_output=z, right_output=z,
        is_cat=torch.zeros((L,), dtype=torch.bool),
        cat_bitset=torch.full((L, 2), 2 ** 32 - 1, dtype=torch.int64),
        seg_lo=zi - 1, seg_hi=zi - 1)


def test_sync_best_ties_to_the_lowest_rank():
    gains = [[1.0, 5.0, float("-inf"), 2.0],
             [3.0, 5.0, float("-inf"), 2.0],
             [3.0, 4.0, float("-inf"), 7.0]]

    def body(net):
        r = net.rank
        return net.sync_best(_info(gains[r], [10 * r + i for i in range(4)]))

    for best in network.thread_gang(3, body):
        assert best.gain.tolist() == [3.0, 5.0, float("-inf"), 7.0]
        # leaf 0: ranks 1 and 2 tie -> 1; leaf 1: ranks 0 and 1 -> 0;
        # leaf 2: all -inf -> 0
        assert best.feature.tolist() == [10, 1, 2, 23]
        assert best.cat_bitset.tolist() == [[2 ** 32 - 1] * 2] * 4


def test_backend_choice_follows_the_topology():
    choose = network.choose_backend
    assert choose(["h|cpu", "h|cpu"])[0] == "gloo"
    assert choose(["h|cuda:0", "h|cuda:1"])[0] == "nccl"
    assert choose(["a|cuda:0", "b|cuda:0"])[0] == "nccl"
    assert choose(["h|cuda:0", "h|cuda:0"]) == (
        "gloo", "ranks share a card (reduced through host memory)")
    assert choose(["h|cuda:0", "h|cuda:0"], "gloo")[0] == "gloo"
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        choose(["h|cuda:0", "h|cuda:0"], "nccl")
    with pytest.raises(ValueError, match="CUDA card"):
        choose(["h|cpu", "h|cpu"], "nccl")


def _hist_inputs(seed, n=1000, f=5, b=16, q8=False):
    rng = np.random.RandomState(seed)
    binsT = torch.from_numpy(rng.randint(0, b, (f, n)).astype(np.uint8))
    leaf = torch.from_numpy(rng.randint(0, 4, n).astype(np.int32))
    if q8:
        stats = torch.from_numpy(rng.randint(-127, 128, (n, 3)).astype(
            np.int8))
    else:
        s = rng.randn(n, 3) * np.exp2(rng.randint(-8, 8, (n, 3)))
        s[:, 2] = 1.0
        stats = torch.from_numpy(s.astype(np.float32))
    sel = torch.tensor([2, -1, 0], dtype=torch.int32)
    chan = cuda_hist.chan_leaf_table(sel)
    return binsT, leaf, stats, chan, sel.shape[0], b, 4


@pytest.mark.parametrize("mode", ["f32", "f64", "q8"])
def test_integer_planes_of_row_slices_equal_one_pass(mode):
    """W row slices' integer planes at the gang's exponent (its max|stat|
    and row count), summed by the gang and converted once, are the planes
    of one pass over all rows -- whatever W, whatever order."""
    binsT, leaf, stats, chan, p, b, nl = _hist_inputs(5, q8=mode == "q8")
    w = p                    # one slot a rank after the reduce-scatter
    n = binsT.shape[1]
    dtype = torch.float64 if mode == "f64" else torch.float32
    amax = cuda_hist._absmax(stats) if mode != "q8" else None
    c = -(-n // w)

    def body(net):
        sl = slice(net.rank * c, (net.rank + 1) * c)
        part = cuda_hist.hist_tile(binsT[:, sl].contiguous(), leaf[sl],
                                   stats[sl], chan, p, b, nl, plane=True,
                                   amax=amax, rows=n, raw=True)
        whole = net.fold_sum(part)                   # exact: integers
        mine = net.reduce_scatter_int(part, 0)       # the data learner's
        if mode == "q8":
            return whole, mine
        return (cuda_hist.hist_convert(whole, amax, n, dtype),
                cuda_hist.hist_convert(mine, amax, n, dtype))

    outs = network.thread_gang(w, body)
    if mode == "q8":
        ref = cuda_hist.hist_tile_plain(binsT, leaf, stats, chan, p, b, nl)
    else:
        ref = cuda_hist.hist_tile_exact(binsT, leaf, stats, chan, p, b, nl,
                                        amax=amax, dtype=dtype)
        raw = cuda_hist.hist_tile_exact(binsT, leaf, stats, chan, p, b, nl,
                                        amax=amax, raw=True)
        np.testing.assert_array_equal(
            cuda_hist.hist_convert_plain(raw, amax, n, dtype).numpy(),
            ref.numpy())
    for r, (whole, mine) in enumerate(outs):
        np.testing.assert_array_equal(whole.numpy(), ref.numpy())
        np.testing.assert_array_equal(mine.numpy(), ref[r:r + 1].numpy())


def test_raw_planes_keep_the_given_exponent():
    binsT, leaf, stats, chan, p, b, nl = _hist_inputs(6)
    amax = cuda_hist._absmax(stats)
    n = binsT.shape[1]
    raw = cuda_hist.hist_tile(binsT, leaf, stats, chan, p, b, nl,
                              plane=True, amax=amax, rows=8 * n, raw=True)
    assert raw.dtype == torch.int64
    k = cuda_hist._fixed_exponent(amax, 8 * n)
    fixed = torch.round(stats.double() * torch.ldexp(
        torch.ones(3, dtype=torch.float64), k)).long()
    # the root's slot (leaf 2, slot 0) of feature 0 sums its rows' values
    rows = leaf == 2
    for bb in range(b):
        m = rows & (binsT[0] == bb)
        np.testing.assert_array_equal(raw[0, 0, bb].numpy(),
                                      fixed[m].sum(0).numpy())
    with pytest.raises(ValueError, match="integer-planes"):
        cuda_hist.hist_tile(binsT, leaf, stats, chan, p, b, nl, amax=amax,
                            raw=True)


REFUSALS = [
    ({"cegb_penalty_split": 0.1}, "data"),
    ({"interaction_constraints": [[0, 1], [2, 3]]}, "data"),
    ({"feature_fraction_bynode": 0.5}, "feature"),
    ({"linear_tree": True}, "voting"),
    ({"forcedsplits_filename": "FORCED"}, "voting"),
    ({}, "bogus"),
]


@pytest.mark.parametrize("extra,learner", REFUSALS,
                         ids=["cegb", "interactions", "bynode", "linear",
                              "forced_voting", "unknown"])
def test_refusals_carry_the_jax_messages(extra, learner, tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5)
    y = (X[:, 0] > 0).astype(float)
    if "forcedsplits_filename" in extra:
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
        extra = {"forcedsplits_filename": str(path)}
    msgs = []
    for lib, more in ((lj, {}), (lt, {"device_type": "cpu"})):
        p = dict({"objective": "binary", "verbosity": -1, "num_leaves": 4,
                  "tree_learner": learner}, **extra, **more)
        with pytest.raises(Exception) as e:
            lib.train(p, lib.Dataset(X, label=y, params=dict(p)), 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "tree_learner" in msgs[1] or "Unknown tree learner" in msgs[1]


def test_a_gang_of_one_trains_on_the_datasets_device():
    """A process in no gang (a world of 1) trains a distributed learner on
    its Dataset's device whatever its network's device: a gang of 1 runs
    no collective (a single-card run of tree_learner=data was refused)."""
    X, y, params, _ = gc.case("data_binary")
    params = dict(params, device_type="cpu")

    def run():
        return lt.train(params, lt.Dataset(X, label=y, params=dict(params)),
                        2).model_to_string()

    alone = run()
    with network.bind(network.Network(None, 0, 1, device="meta")):
        assert run() == alone


@pytest.mark.parametrize("key,value", [
    ("construct_streaming", True), ("construct_chunk_rows", 1024),
    ("sketch_max_size", 128), ("predict_sharded", True),
    ("mesh_shape", {"data": 2}), ("num_gpu", 2)])
def test_the_rest_of_item_15_is_accepted(key, value):
    """Items 15.4-15.5's parameters (the streaming construct, row-sharded
    predict; mesh_shape and num_gpu read by nothing, as in the JAX
    package) configure the port."""
    cfg = lt.Config.from_params({key: value, "device_type": "cpu"})
    assert getattr(cfg, key) == value != getattr(lt.Config(), key)


@pytest.mark.parametrize("key,value", [
    ("heartbeat_interval", 1.0), ("collective_deadline", 30.0),
    ("max_restarts", 0), ("rank_restart_budget", 3), ("min_world_size", 2),
    ("integrity_check_period", 5), ("checkpoint_shards", False),
    ("fault_hang_at_iter", 3), ("fault_kill_rank_at_iter", "1:3"),
    ("fault_hang_rank_at_iter", "1:3"), ("fault_kill_in_shard_write", "0:2"),
    ("fault_corrupt_shard", 1), ("fault_flip_score_rank", "1:2")])
def test_supervision_parameters_are_accepted(key, value):
    """Item 15's supervision, elasticity and integrity parameters
    configure the port."""
    cfg = lt.Config.from_params({key: value, "device_type": "cpu"})
    assert getattr(cfg, key) == value


def test_streaming_and_sharded_checkpoints_raise(tmp_path):
    """The streaming constructs are ported: an empty chunk source raises
    as in the JAX package, a gang of one loads chunks; a gang over
    replicated rows checkpoints, from rank 0 alone."""
    X, y, params, _ = gc.case("data_binary")
    params = dict(params, device_type="cpu")
    with pytest.raises(LightGBMError, match="yielded no chunks"):
        lt.Dataset.from_chunks([], params=dict(params)).construct()
    with pytest.raises(LightGBMError, match="yielded no chunks"):
        distributed.load_partitioned_chunks([], params=dict(params))
    assert lt.Dataset.from_chunks([(X, y)], params=dict(
        params)).construct().num_data == len(X)
    assert distributed.load_partitioned_chunks(
        [(X, y)], params=dict(params)).is_pre_partitioned

    def body(net):
        ds = lt.Dataset(X, label=y, params=dict(params))
        lt.train(params, ds, 2, callbacks=[lt.checkpoint_callback(
            str(tmp_path / f"r{net.rank}"))])
        return True

    assert network.thread_gang(2, body) == [True, True]
    assert sorted(os.listdir(tmp_path / "r0")) == ["ckpt_00000001",
                                                  "ckpt_00000002"]
    assert not (tmp_path / "r1").exists()


def test_train_distributed_refuses_serial():
    with pytest.raises(Exception, match="train_distributed requires "
                                        "tree_learner"):
        distributed.train_distributed({"tree_learner": "serial"}, [{}, {}])


def test_rank_from_machines(tmp_path):
    local = "127.0.0.1"
    assert distributed._rank_from_machines(
        ["10.255.255.1:1", f"{local}:2", "10.255.255.2:3"]) == 1
    both = [f"{local}:5000", f"{local}:5001"]
    assert distributed._rank_from_machines(both, 5001) == 1
    assert distributed._rank_from_machines(both, 5000) == 0
    with pytest.raises(Exception, match="multiple machines entries"):
        distributed._rank_from_machines(both)
    assert distributed._rank_from_machines(["10.255.255.3:9"]) is None
    mlist = tmp_path / "mlist.txt"
    mlist.write_text(f"10.255.255.1 12400\n{local} 12401  # me\n")
    entries = distributed._machine_list("", str(mlist))
    assert entries == ["10.255.255.1:12400", f"{local}:12401"]
    assert distributed._rank_from_machines(entries, 12401) == 1


def _fail_on_rank_one(rank):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


@pytest.fixture(scope="module")
def gang_of_two():
    names = ["data_binary", "voting_binary"]
    ports = [distributed.free_port() for _ in range(4)]
    out = distributed.spawn(gc.partitioned, nproc=2, args=(names, ports),
                            device_type="cpu", timeout=240)
    X, y, params, _ = gc.case("data_binary")
    params = dict(params, device_type="cpu", boost_from_average=False)
    parts = [{"data": X[:300], "label": y[:300]},
             {"data": X[300:], "label": y[300:]}]
    td = distributed.train_distributed(params, parts, gc.ROUNDS,
                                       timeout=240)
    return out, td.model_to_string()


@pytest.mark.parametrize("name", ["data_binary", "voting_binary"])
def test_load_partitioned_equals_the_replicated_run(gang_of_two, name):
    """The pre-partitioned run (mappers fitted from the allgathered samples
    of both halves) trains the replicated 2-rank run's text; both ranks
    hold the same mappers, the ones of the whole data."""
    out, _ = gang_of_two
    res = out[name]
    assert res["prepart"] == res["replicated"]
    assert res["ranks_mappers"] == [res["mappers"]] * 2
    assert res["local_rows"] == 300 and res["num_data"] == 600
    X, y, params, _ = gc.case(name)
    ref = lt.Dataset(X, label=y, params=dict(params, device_type="cpu",
                                             tree_learner="serial"))
    ref.construct()
    assert res["mappers"] == [np.asarray(m.bin_upper_bound,
                                         np.float64).tobytes()
                              for m in ref.mappers]


def test_train_distributed_with_two_parts(gang_of_two):
    out, text = gang_of_two
    assert text == out["data_binary"]["replicated"]


def test_set_network_joins_a_gang_of_two(gang_of_two):
    out, _ = gang_of_two
    sn = out["set_network"]
    assert sn["alone"] == 1 and sn["world"] == 2 and sn["rank"] == 0
    assert sn["text"] == out["data_binary"]["replicated"]


def test_cli_network_keys_train_in_a_gang_of_two(gang_of_two):
    out, _ = gang_of_two
    cli = out["cli"]
    trees = out["data_binary"]["replicated"].split("\nparameters:")[0]
    assert cli["world"] == 2
    assert cli["text"].split("\nparameters:")[0] == trees
    assert "[num_machines: 2]" in cli["text"]


def test_a_failing_rank_fails_the_gang():
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 failed:.*rank one fails"):
        distributed.spawn(_fail_on_rank_one, nproc=2, device_type="cpu",
                          timeout=120)
