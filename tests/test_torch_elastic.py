"""The port's sharded checkpoints and resume at another world size against
the JAX package, on the CPU.

The JAX package's ``tests/test_elastic.py`` suite on one shared training
pair (``bag_run``: the data learner over pre-partitioned rows,
``load_partitioned``, with bagging; the uninterrupted 5-round text and a
directory of sharded checkpoints of its first 3 iterations, mid bagging
period):

- the layout: one shard a rank, ``PARTITION.json`` and a manifest listing
  every shard with its bytes and sha256; the global ``state.pkl`` holds
  no score cache;
- kill-and-resume at the same world size is byte-equal to the
  uninterrupted text, which is the JAX data learner's (a 1-device mesh);
- the checkpoint re-sharded offline to 4, then 2, then 3 ranks
  (``repartition_checkpoint``) resumes through the re-partition on load to
  the same text; a gang of 2 thread-ranks resuming from the 4-way shards
  gives the JAX package's text of the same run (3 iterations on 1 device,
  then 2 on 2 devices, resumed from the JAX package's own checkpoint);
- ``repartition_rows`` equals the JAX function on the 4 -> 2, 2 -> 3 and
  4 -> 3 matrices and refuses gaps and short shards with its messages;
  a 1 -> 4 re-shard keeps every row's bits;
- a missing or corrupt shard invalidates the checkpoint (the fallback to
  the previous one), the corrupt-shard fault, a tampered label hash is
  refused, ``checkpoint_shards=false`` writes the replicated layout, a
  replicated booster reads a sharded checkpoint, a stale ``.tmp`` (also
  one a writer killed inside the shard write left) is ignored and
  removed;
- the protocol across two thread-ranks: both shards, the partition, and
  a read under another split;
- ``dataset_fingerprint(local=True)``, ``label_range_sha256`` and
  ``split_local_state`` equal the JAX package's.
"""

import hashlib
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import checkpoint as jckpt
from lightgbm_tpu import distributed as jd
from lightgbm_tpu_torch import checkpoint as tckpt
from lightgbm_tpu_torch import distributed as td
from lightgbm_tpu_torch import network
from lightgbm_tpu_torch.checkpoint import CheckpointManager
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils.log import LightGBMError

sys.path.insert(0, os.path.dirname(__file__))
import torch_jax_mesh  # noqa: E402

torch.set_num_threads(1)

N, F = 320, 6
ROUNDS, K = 5, 3     # K is mid bagging period (freq 2): the resume must
                     # re-derive the period's bag, not only load state

BAG_PARAMS = {"objective": "binary", "num_leaves": 8, "min_data_in_leaf": 5,
              "boost_from_average": False, "verbosity": -1,
              "tree_learner": "data", "bagging_fraction": 0.7,
              "bagging_freq": 2, "bagging_seed": 5}
GBDT_PARAMS = {k: v for k, v in BAG_PARAMS.items()
               if not k.startswith("bagging")}


def _data():
    rng = np.random.RandomState(7)
    X = rng.normal(size=(N, F))
    y = (X[:, 0] - 0.5 * X[:, 2] > 0).astype(np.float64)
    return X, y


def _train(params, rounds, ckdir=None, resume=None, keep=4):
    """The port's pre-partitioned run of this thread's or process's gang
    (a gang of 1 outside a thread gang): each rank its contiguous rows."""
    X, y = _data()
    p = dict(params, device_type="cpu")
    net = network.current()
    c = -(-N // net.world)
    lo, hi = net.rank * c, min((net.rank + 1) * c, N)
    ds = td.load_partitioned(X[lo:hi], label=y[lo:hi], params=dict(p))
    cbs = ([lt.checkpoint_callback(ckdir, period=1, keep=keep)]
           if ckdir else [])
    return lt.train(dict(p), ds, rounds, callbacks=cbs, resume_from=resume)


@pytest.fixture(scope="module")
def bag_run(tmp_path_factory):
    td_ = tmp_path_factory.mktemp("elastic_bag")
    full = _train(BAG_PARAMS, ROUNDS).model_to_string()
    ckdir = str(td_ / "ck")
    _train(BAG_PARAMS, K, ckdir=ckdir)
    X, y = _data()
    jck = str(td_ / "jax_ck")
    torch_jax_mesh.jax_on_mesh(1, BAG_PARAMS, X, y, K, callbacks=[
        lj.checkpoint_callback(jck, period=1)])
    return {"full": full, "ckdir": ckdir, "td": td_,
            "jax_full": torch_jax_mesh.jax_on_mesh(1, BAG_PARAMS, X, y,
                                                   ROUNDS),
            "jax_w1_then_w2": torch_jax_mesh.jax_on_mesh(
                2, BAG_PARAMS, X, y, ROUNDS, resume_from=jck)}


def _fresh_copy(bag_run, name):
    dst = str(bag_run["td"] / name)
    shutil.copytree(bag_run["ckdir"], dst)
    return dst


# ============================================== sharded layout + manifest
def test_sharded_layout_and_hardened_manifest(bag_run):
    lc = CheckpointManager(bag_run["ckdir"]).load_latest_valid()
    assert lc is not None and lc.iteration == K
    files = sorted(os.listdir(lc.path))
    assert "shard_rank0.pkl" in files and "PARTITION.json" in files
    man = lc.manifest
    assert man["world_size"] == 1
    shard = man["files"]["shard_rank0.pkl"]
    assert shard["bytes"] == os.path.getsize(
        os.path.join(lc.path, "shard_rank0.pkl"))
    assert len(shard["sha256"]) == 64
    assert set(man["dataset_fingerprint"]) == {"0"}
    part = lc.partition
    assert part["global_rows"] == N
    assert [(e["row_start"], e["row_count"]) for e in part["ranks"]] \
        == [(0, N)]
    assert len(part["ranks"][0]["label_sha256"]) == 64
    assert "train_score" not in lc.state["boosting"]
    local = tckpt.load_shard(lc.path, 0)
    assert local["train_score"].shape[0] == N
    assert local["train_score"].dtype == np.float32


def test_uninterrupted_text_is_the_jax_data_learner(bag_run):
    assert bag_run["full"] == bag_run["jax_full"]


@pytest.mark.parametrize("params", [GBDT_PARAMS, BAG_PARAMS],
                         ids=["gbdt", "bagging"])
def test_prepart_kill_resume_same_world_bit_identical(params, tmp_path,
                                                      bag_run):
    if params is BAG_PARAMS:
        full, ckdir = bag_run["full"], _fresh_copy(bag_run, "same_world")
    else:
        full = _train(params, ROUNDS).model_to_string()
        ckdir = str(tmp_path / "ck")
        _train(params, K, ckdir=ckdir)
    resumed = _train(params, ROUNDS, ckdir=ckdir, resume=ckdir)
    assert resumed.model_to_string() == full
    assert resumed.current_iteration() == ROUNDS


def test_resume_from_repartitioned_checkpoints_bit_identical(bag_run):
    """4, then 4 -> 2, then 2 -> 3 ranks: each layout resumes to the
    uninterrupted text (pure row movement: the reassembled score caches
    are the same bits per row)."""
    src = os.path.join(bag_run["ckdir"], f"ckpt_{K:08d}")
    tmp = bag_run["td"]
    p4 = tckpt.repartition_checkpoint(src, 4, str(tmp / "w4"))
    p2 = tckpt.repartition_checkpoint(p4, 2, str(tmp / "w2"))
    p3 = tckpt.repartition_checkpoint(p2, 3, str(tmp / "w3"))
    for path, world in ((p4, 4), (p2, 2), (p3, 3)):
        with open(os.path.join(path, "PARTITION.json")) as fh:
            part = json.load(fh)
        assert part["world_size"] == world
        counts = [e["row_count"] for e in part["ranks"]]
        assert sum(counts) == N and max(counts) - min(counts) <= 1
        resumed = _train(BAG_PARAMS, ROUNDS, ckdir=str(tmp / f"cont{world}"),
                         resume=os.path.dirname(path))
        assert resumed.model_to_string() == bag_run["full"], world


def test_gang_of_2_resumes_from_4_way_shards_as_the_jax_package(bag_run):
    """A gang of 2 thread-ranks resumes from the 4-way re-shard (each rank
    reads the two old shards of its rows): the JAX package's text for 3
    iterations on 1 device, then 2 on 2 devices."""
    src = os.path.join(bag_run["ckdir"], f"ckpt_{K:08d}")
    tmp = bag_run["td"]
    p4 = tckpt.repartition_checkpoint(src, 4, str(tmp / "gang_w4"))

    def body(net):
        return _train(BAG_PARAMS, ROUNDS, resume=os.path.dirname(p4)
                      ).model_to_string()

    texts = network.thread_gang(2, body)
    assert texts[0] == texts[1] == bag_run["jax_w1_then_w2"]
    assert texts[0] != bag_run["full"]


def test_repartition_preserves_row_bits(bag_run):
    src = os.path.join(bag_run["ckdir"], f"ckpt_{K:08d}")
    orig = tckpt.load_shard(src, 0)["train_score"]
    p4 = tckpt.repartition_checkpoint(src, 4, str(bag_run["td"] / "bits4"))
    parts = [tckpt.load_shard(p4, r)["train_score"] for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), orig)
    assert (np.concatenate(parts).view(np.uint32)
            == orig.view(np.uint32)).all()
    with open(os.path.join(p4, "PARTITION.json")) as fh:
        part = json.load(fh)
    # no new range is the old single rank's, so no label hash carries over
    assert all(e["label_sha256"] is None for e in part["ranks"])
    CheckpointManager(os.path.dirname(p4)).validate(p4)


# ===================================================== repartition_rows
def _ranges(counts):
    out, s = [], 0
    for c in counts:
        out.append((s, c))
        s += c
    return out


@pytest.mark.parametrize("old_counts,new_counts", [
    ((25, 25, 25, 25), (50, 50)),
    ((50, 50), (34, 33, 33)),
    ((25, 25, 25, 25), (34, 33, 33)),
    ((100,), (0, 60, 40)),
])
def test_repartition_rows_matches_jax(old_counts, new_counts):
    g = np.arange(200, dtype=np.float32).reshape(100, 2) * 2.0
    old = _ranges(old_counts)
    touched = {"t": set(), "j": set()}

    def fetch(key):
        def f(r):
            touched[key].add(r)
            s0, c0 = old[r]
            return g[s0:s0 + c0]
        return f

    s = 0
    for c in new_counts:
        got = td.repartition_rows(old, s, c, fetch("t"))
        want = jd.repartition_rows(old, s, c, fetch("j"))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, g[s:s + c])
        s += c
    assert touched["t"] == touched["j"] == set(range(len(old_counts)))


@pytest.mark.parametrize("old,lo,n,rows", [
    ([(0, 50), (60, 40)], 0, 100, None),        # a gap at row 50
    ([(0, 50), (50, 50)], 0, 100, 10),          # a short shard
    ([(0, 50)], 0, 80, None),                   # rows not covered
])
def test_repartition_rows_refuses_as_jax(old, lo, n, rows):
    def fetch(r):
        return np.zeros(rows if rows is not None else old[r][1], np.float32)

    with pytest.raises(ValueError) as et:
        td.repartition_rows(old, lo, n, fetch)
    with pytest.raises(ValueError) as ej:
        jd.repartition_rows(old, lo, n, fetch)
    assert str(et.value) == str(ej.value)


def test_exchange_host_single_process():
    assert td.exchange_host("t", "payload") == ["payload"]


# ================================== manifest hardening: invalid fallback
def test_missing_shard_invalidates_checkpoint(bag_run):
    ckdir = _fresh_copy(bag_run, "missing_shard")
    newest = os.path.join(ckdir, f"ckpt_{K:08d}")
    os.unlink(os.path.join(newest, "shard_rank0.pkl"))
    mgr = CheckpointManager(ckdir)
    with pytest.raises(ValueError, match="missing file shard_rank0.pkl"):
        mgr.validate(newest)
    assert not mgr._quick_valid(newest)
    assert mgr.load_latest_valid().iteration == K - 1


def test_corrupt_shard_checksum_invalidates_checkpoint(bag_run):
    ckdir = _fresh_copy(bag_run, "corrupt_shard")
    newest = os.path.join(ckdir, f"ckpt_{K:08d}")
    faults.corrupt_file(os.path.join(newest, "shard_rank0.pkl"))
    mgr = CheckpointManager(ckdir)
    with pytest.raises(ValueError, match="shard_rank0.pkl checksum"):
        mgr.validate(newest)
    assert mgr.load_latest_valid().iteration == K - 1
    faults.corrupt_file(os.path.join(newest, "shard_rank0.pkl"),
                        truncate=True)
    assert not mgr._quick_valid(newest)


def test_corrupt_shard_fault_injection_point(tmp_path):
    cfg = lt.Config.from_params({"fault_corrupt_shard": 0,
                                 "device_type": "cpu"})
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, config=cfg)
    path = mgr.write_sharded(
        1, model_text="m\n",
        global_state={"boosting": {"iter": 1}, "callbacks": {}},
        local_state={"train_score": np.zeros(8, np.float32),
                     "valid_scores": []},
        row_start=0, row_count=8, global_rows=8, fingerprint="fp",
        label_sha256=None, valid_counts=[], phash="p")
    with pytest.raises(ValueError, match="shard_rank0.pkl checksum"):
        mgr.validate(path)
    assert CheckpointManager(str(tmp_path / "ck")).load_latest_valid() \
        is None


def test_partition_label_tamper_rejected(bag_run):
    ckdir = _fresh_copy(bag_run, "tamper")
    newest = os.path.join(ckdir, f"ckpt_{K:08d}")
    ppath = os.path.join(newest, "PARTITION.json")
    with open(ppath) as fh:
        part = json.load(fh)
    part["ranks"][0]["label_sha256"] = "0" * 64
    part_bytes = json.dumps(part, indent=1, sort_keys=True).encode()
    with open(ppath, "wb") as fh:
        fh.write(part_bytes)
    mpath = os.path.join(newest, "MANIFEST.json")
    with open(mpath) as fh:
        man = json.load(fh)
    man["files"]["PARTITION.json"] = {
        "bytes": len(part_bytes),
        "sha256": hashlib.sha256(part_bytes).hexdigest()}
    man["dataset_fingerprint"] = {}     # only the content hash is left
    with open(mpath, "w") as fh:
        json.dump(man, fh, indent=1, sort_keys=True)
    with pytest.raises(LightGBMError, match="recorded content hash"):
        _train(BAG_PARAMS, ROUNDS, resume=ckdir)


def test_sharding_toggle_off_writes_legacy_layout(tmp_path):
    params = dict(GBDT_PARAMS, checkpoint_shards=False)
    ckdir = str(tmp_path / "ck")
    _train(params, K, ckdir=ckdir)
    lc = CheckpointManager(ckdir).load_latest_valid()
    assert lc.partition is None
    assert "shard_rank0.pkl" not in os.listdir(lc.path)
    assert "train_score" in lc.state["boosting"]
    restored = _train(params, K, resume=ckdir)
    assert restored.current_iteration() == K
    assert restored.model_to_string().split("\nparameters:")[0] == \
        lc.model_text.split("\nparameters:")[0]


def test_replicated_booster_resumes_from_sharded_checkpoint(bag_run):
    X, y = _data()
    p = dict(BAG_PARAMS, device_type="cpu")
    full_ds = lt.Dataset(X, label=y, params=dict(p), free_raw_data=False)
    ckdir = _fresh_copy(bag_run, "replicated_read")
    booster = lt.train(dict(p), full_ds, K, resume_from=ckdir)
    assert booster.current_iteration() == K
    lc = CheckpointManager(ckdir).load_latest_valid()
    assert booster.model_to_string().split("\nparameters:")[0] == \
        lc.model_text.split("\nparameters:")[0]


# ============================= kill-during-shard-write (stale .tmp path)
def test_stale_sharded_tmp_ignored_and_reclaimed(bag_run):
    ckdir = _fresh_copy(bag_run, "stale_tmp")
    stale = os.path.join(ckdir, f"ckpt_{K + 1:08d}.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "shard_rank0.pkl"), "wb") as fh:
        fh.write(b"partial shard bytes")
    assert CheckpointManager(ckdir).load_latest_valid().iteration == K
    resumed = _train(BAG_PARAMS, ROUNDS, ckdir=ckdir, resume=ckdir)
    assert resumed.model_to_string() == bag_run["full"]
    assert not [e for e in os.listdir(ckdir) if e.endswith(".tmp")]


class _Killed(BaseException):
    pass


def test_kill_in_shard_write_recovers(bag_run, tmp_path, monkeypatch):
    """``fault_kill_in_shard_write`` "0:2" ends the writer between its
    shard and the metadata exchange (here by an exception standing in for
    ``os._exit``): ``ckpt_2.tmp`` holds the shard alone, the resume takes
    checkpoint 1 and gives the uninterrupted text, and the stale stage is
    removed."""
    def die(context):
        raise _Killed(context)

    monkeypatch.setattr(faults, "_hard_exit", die)
    ckdir = str(tmp_path / "ck")
    with pytest.raises(_Killed, match="inside sharded checkpoint write"):
        _train(dict(BAG_PARAMS, fault_kill_in_shard_write="0:2"), ROUNDS,
               ckdir=ckdir)
    assert sorted(os.listdir(ckdir)) == ["ckpt_00000001",
                                         "ckpt_00000002.tmp"]
    assert os.listdir(os.path.join(ckdir, "ckpt_00000002.tmp")) == \
        ["shard_rank0.pkl"]
    resumed = _train(BAG_PARAMS, ROUNDS, ckdir=ckdir, resume=ckdir)
    assert resumed.model_to_string() == bag_run["full"]
    assert not [e for e in os.listdir(ckdir) if e.endswith(".tmp")]


# ========================== the protocol across two thread-ranks
def test_two_rank_sharded_protocol(tmp_path):
    """Every cross-rank step of the sharded write (the decision, each
    rank's shard, the metadata exchange, rank 0's partition, manifest and
    rename) and a read under another split, over two thread-ranks."""
    ckdir = str(tmp_path / "ck")
    counts = [100, 150]

    def body(net):
        rank = net.rank
        start, n = sum(counts[:rank]), counts[rank]
        score = np.arange(start, start + n, dtype=np.float32) * 0.5
        CheckpointManager(ckdir, keep=2).write_sharded(
            7, model_text="protocol test\n",
            global_state={"boosting": {"iter": 7}, "callbacks": {}},
            local_state={"train_score": score, "valid_scores": []},
            row_start=start, row_count=n, global_rows=250,
            fingerprint=f"fp{rank}", label_sha256=None, valid_counts=[],
            phash="abc")
        td.barrier("proto_after_write")
        lc = CheckpointManager(ckdir).load_latest_valid()
        new_counts = [200, 50]
        ns, nn = sum(new_counts[:rank]), new_counts[rank]
        local = tckpt.reassemble_local_state(lc, ns, nn, [])
        np.testing.assert_array_equal(
            local["train_score"],
            np.arange(ns, ns + nn, dtype=np.float32) * 0.5)
        return lc.partition["world_size"], sorted(os.listdir(lc.path))

    out = network.thread_gang(2, body)
    assert out[0] == out[1]
    world, files = out[0]
    assert world == 2
    assert {"shard_rank0.pkl", "shard_rank1.pkl", "PARTITION.json",
            "MANIFEST.json", "model.txt", "state.pkl"} == set(files)


# ==================================== the helpers against the JAX package
def test_local_fingerprint_label_hash_and_split_match_jax():
    X, y = _data()
    p = dict(GBDT_PARAMS)
    tds = td.load_partitioned(X, label=y, params=dict(p, device_type="cpu"))
    jds = jd.load_partitioned(X, label=y, params=dict(p))
    assert tckpt.dataset_fingerprint(tds, local=True) == \
        jckpt.dataset_fingerprint(jds, local=True)
    assert tckpt.dataset_fingerprint(tds) == jckpt.dataset_fingerprint(jds)
    for lo, hi in ((0, N), (10, 90), (5, 5)):
        assert tckpt.label_range_sha256(y, lo, hi) == \
            jckpt.label_range_sha256(y, lo, hi)
    state = {"format": 1, "boosting": {"iter": 3, "train_score": np.ones(4),
                                       "valid_scores": [np.zeros(2)],
                                       "trees": ["t"]},
             "callbacks": {}}
    gt, lt_ = tckpt.split_local_state(state)
    gj, lj_ = jckpt.split_local_state(state)
    assert pickle.dumps(gt) == pickle.dumps(gj)
    assert pickle.dumps(lt_) == pickle.dumps(lj_)
    assert "train_score" in state["boosting"]      # the input is kept
