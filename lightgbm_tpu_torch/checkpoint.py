"""Atomic checkpoint/resume for fault-tolerant training.

The port of lightgbm_tpu's ``checkpoint.py``, replicated half. A
checkpoint holds the model text and a trainer-state sidecar; every file
lands through ``utils/atomic_write`` (tmp + fsync + rename), and a
manifest written last records byte lengths and sha256 checksums, so a kill
at any point leaves either a valid checkpoint or one that validation
rejects. Layout under the checkpoint directory::

    ckpt_00000007/
        model.txt       v3 model text (loads as a normal model, in this
                        package and in the JAX package)
        state.pkl       pickled trainer state: numpy arrays and plain
                        Python (no torch storages, nothing that pins a
                        device)
        MANIFEST.json   format, iteration, params hash, dataset
                        fingerprint, per-file {bytes, sha256} and the
                        health snapshot; its presence marks the
                        checkpoint complete

A checkpoint is staged in ``ckpt_N.tmp`` and published with one directory
rename. ``load_latest_valid`` walks the checkpoints newest first and falls
back past a truncated or corrupt one with a warning. Resume is
bit-identical: the sidecar restores the exact float32 score caches, the
trees, the feature-fraction and DART drop generators and the OOM ladder's
position, and the bagging draw of a period is keyed on its first
iteration, so a run killed at k and resumed gives the uninterrupted run's
model text byte for byte. ``device_type`` is part of the params hash: a
card checkpoint resumed on the CPU would not continue bit for bit (the
card's fixed-point histogram sums are not the CPU's plain ones).

A gang that trains replicated data (every rank all rows) checkpoints from
rank 0 alone: every rank's state is the same. A pre-partitioned gang
(``distributed.load_partitioned``) writes the sharded layout unless
``checkpoint_shards`` is false: every rank writes its own score caches
(the float32 bits of its rows) as ``shard_rank<r>.pkl``, the shards'
sizes and checksums are exchanged over the gang's store
(``distributed.exchange_host``), and rank 0 writes the model text, the
rank-symmetric rest of the state (``split_local_state``),
``PARTITION.json`` (each rank's row range, the sha256 of its labels and
its valid sets' row counts) and, last, the manifest, which lists every
shard. A resume reassembles each rank's rows from the shards that overlap
them (``reassemble_local_state`` over ``distributed.repartition_rows``),
so a gang may come back at another world size, a smaller one after the
supervisor gave up a rank; ``repartition_checkpoint`` re-shards a
checkpoint offline.

``state.pkl`` is a pickle: load checkpoints only from directories you
trust, like any model artifact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import re
import shutil
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import distributed
from .utils import faults, log
from .utils.atomic_write import atomic_write_bytes, atomic_write_text

MANIFEST_NAME = "MANIFEST.json"
MODEL_NAME = "model.txt"
STATE_NAME = "state.pkl"
PARTITION_NAME = "PARTITION.json"
_CKPT_RE = re.compile(r"^ckpt_(\d{8})$")
MANIFEST_FORMAT = 1


def shard_name(rank: int) -> str:
    """A rank's score-cache shard file inside a sharded checkpoint."""
    return f"shard_rank{int(rank)}.pkl"


# params that steer IO, logging, supervision or fault injection but not the
# trained model: they may differ between the checkpointing run and the
# resuming run (the JAX package's list)
_NON_TRAINING_PARAMS = frozenset({
    "task", "data", "valid", "input_model", "output_model", "output_result",
    "convert_model", "convert_model_language", "verbosity", "snapshot_freq",
    "metric_freq", "num_threads", "machine_list_filename",
    "checkpoint_path", "checkpoint_keep", "checkpoint_shards",
    "check_numerics",
    "hist_autotune",
    # bit-identical to the classic split phase by contract
    "split_fusion",
    "heartbeat_interval", "collective_deadline", "max_restarts",
    "rank_restart_budget", "min_world_size",
    # the divergence-check cadence and the OOM fallback gate steer
    # supervision; a degrade event's configuration rides the trainer state
    "integrity_check_period", "hist_oom_fallback",
    "serve_flush_ms", "serve_max_batch_rows", "serve_max_queue_rows",
    "serve_deadline_ms", "serve_metrics", "serve_metrics_port",
    "serve_metrics_host",
    "telemetry_flight_recorder", "telemetry_ring_size", "telemetry_dir",
    "telemetry_flush_period", "telemetry_memory",
    "fault_kill_at_iter", "fault_hang_at_iter", "fault_kill_in_ckpt_write",
    "fault_nan_grad_at_iter", "fault_corrupt_checkpoint",
    "fault_kill_rank_at_iter", "fault_hang_rank_at_iter",
    "fault_kill_in_shard_write", "fault_corrupt_shard",
    "fault_flip_score_rank", "fault_nan_hist_at_iter",
    "fault_oom_at_iter", "fault_oom_count",
    "fault_slow_predict_ms", "fault_oom_at_predict",
})


def params_hash(config) -> str:
    """Stable hash of the training-relevant parameters (every Config field
    but ``_NON_TRAINING_PARAMS``, lists included): resuming under another
    configuration is refused, not silently trained on."""
    items = sorted(
        (f.name, repr(getattr(config, f.name)))
        for f in dataclasses.fields(type(config))
        if f.name not in _NON_TRAINING_PARAMS)
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def dataset_fingerprint(train_set, local: bool = False) -> str:
    """Cheap identity check for the training data: shape plus the label
    and weight bytes (float64), the JAX package's digest. With ``local``
    the shape counts the rank's own rows (a pre-partitioned set's labels
    and weights are its own already): the per-rank fingerprint of a
    sharded manifest."""
    h = hashlib.sha256()
    n_local = getattr(train_set, "num_local_data", None) if local else None
    n = int(n_local if n_local else
            (getattr(train_set, "num_data", 0) or 0))
    f = int(getattr(train_set, "num_total_features", 0) or 0)
    h.update(f"{n}x{f}".encode())
    label = train_set.get_label() if hasattr(train_set, "get_label") else None
    if label is not None:
        h.update(np.ascontiguousarray(np.asarray(label, np.float64)).tobytes())
    weight = train_set.get_weight() if hasattr(train_set, "get_weight") \
        else None
    if weight is not None:
        h.update(np.ascontiguousarray(np.asarray(weight, np.float64)).tobytes())
    return h.hexdigest()[:16]


def label_range_sha256(label, lo: int, hi: int) -> str:
    """sha256 of the local label rows [lo, hi) as float64 bytes: the
    per-rank row-content hash PARTITION.json records, which any later rank
    whose rows contain [lo, hi) can recompute."""
    a = np.ascontiguousarray(np.asarray(label, np.float64)[lo:hi])
    return hashlib.sha256(a.tobytes()).hexdigest()


def split_local_state(state: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                                      Dict[str, Any]]:
    """A captured trainer state split into (global, local) halves for the
    sharded layout: the score caches are the rank's own rows and go into
    its shard; the rest (trees, generators, counters) is the same on every
    rank and goes into rank 0's state.pkl. The inverse is a dict merge
    before ``set_trainer_state``."""
    state = dict(state)
    boosting = dict(state["boosting"])
    local = {
        "train_score": boosting.pop("train_score"),
        "valid_scores": boosting.pop("valid_scores"),
    }
    state["boosting"] = boosting
    return state, local


def capture_state(booster) -> Dict[str, Any]:
    """Full trainer state of a training booster: the boosting layer's
    (``GBDT.get_trainer_state``), the booster's best iteration, best
    scores and attributes, and the states of the stateful callbacks the
    engine registered on it."""
    state: Dict[str, Any] = {
        "format": MANIFEST_FORMAT,
        "boosting": booster._boosting.get_trainer_state(),
        "booster": {
            "best_iteration": booster.best_iteration,
            "best_score": dict(booster.best_score),
            "attr": dict(getattr(booster, "_attr", {}) or {}),
        },
        "callbacks": {},
    }
    for cb in getattr(booster, "_callbacks", []) or []:
        key = getattr(cb, "ckpt_key", None)
        if key and hasattr(cb, "get_state"):
            state["callbacks"][key] = cb.get_state()
    return state


@dataclass
class LoadedCheckpoint:
    path: str
    iteration: int
    manifest: Dict[str, Any]
    model_text: str
    state: Dict[str, Any]
    partition: Optional[Dict[str, Any]] = None


class CheckpointManager:
    """Writes, validates, prunes and loads checkpoints in one directory.
    ``last_save`` holds the last write's host seconds and file bytes."""

    def __init__(self, directory: str, keep: int = 2, config=None):
        self.directory = os.fspath(directory)
        self.keep = max(1, int(keep))
        self._fault_plan = faults.plan_from(config)
        self._dataset_fp: Optional[str] = None
        self._label_sha: Optional[str] = None
        self.last_save: Dict[str, Any] = {}

    # ------------------------------------------------------------- write
    def save(self, booster, iteration: int) -> Optional[str]:
        """Checkpoint ``booster`` after ``iteration`` completed boosting
        iterations. Replicated data: rank 0 writes. A pre-partitioned gang
        (``checkpoint_shards``): every rank writes its shard and rank 0
        publishes the checkpoint. Then every rank passes the barrier, so
        no rank races past a checkpoint another may resume from.
        ``last_save`` holds this rank's host seconds."""
        import time
        from . import network
        t0 = time.perf_counter()
        net = network.current()
        boosting = getattr(booster, "_boosting", None)
        sharded = bool(getattr(boosting, "_pre_part", False)) and \
            bool(getattr(booster.config, "checkpoint_shards", True))
        path = None
        if sharded:
            path = self._write_sharded_booster(booster, iteration)
        elif net.world <= 1 or net.rank == 0:
            path = self._write(booster, iteration)
        distributed.barrier(f"lgbm_tpu_checkpoint_{iteration}")
        self.last_save = dict(self.last_save,
                              seconds=time.perf_counter() - t0,
                              sharded=sharded)
        return path

    def _write_sharded_booster(self, booster, iteration: int
                               ) -> Optional[str]:
        """The sharded write's inputs from a live pre-partitioned booster,
        then the protocol every rank runs (``write_sharded``)."""
        from . import network
        rank = network.current().rank
        boosting = booster._boosting
        ts = boosting.train_set
        if rank == 0:
            global_state, local_state = split_local_state(
                capture_state(booster))
        else:
            # the other ranks give only their shard: the rest is the same
            # on every rank and rank 0 alone writes it
            global_state = {}
            local_state = {
                "train_score": boosting.train_score.detach().cpu().numpy(),
                "valid_scores": [s.detach().cpu().numpy()
                                 for s in boosting._valid_scores],
            }
        row_start = int(getattr(ts, "local_row_start", 0) or 0)
        n_local = getattr(ts, "num_local_data", None)
        row_count = int(n_local if n_local else ts.num_data)
        if self._dataset_fp is None:
            self._dataset_fp = dataset_fingerprint(ts, local=True)
        if self._label_sha is None:
            # labels do not change after construction: hashed once
            label = ts.get_label() if hasattr(ts, "get_label") else None
            self._label_sha = (label_range_sha256(label, 0, row_count)
                               if label is not None else "")
        phash = getattr(booster, "_initial_params_hash", None) \
            or params_hash(booster.config)
        return self.write_sharded(
            iteration,
            model_text=(booster.model_to_string(num_iteration=-1)
                        if rank == 0 else ""),
            global_state=global_state, local_state=local_state,
            row_start=row_start, row_count=row_count,
            global_rows=int(ts.num_data), fingerprint=self._dataset_fp,
            label_sha256=self._label_sha or None,
            valid_counts=[int(s.shape[0])
                          for s in local_state["valid_scores"]],
            phash=phash)

    def write_sharded(self, iteration: int, *, model_text: str,
                      global_state: Dict[str, Any],
                      local_state: Dict[str, Any],
                      row_start: int, row_count: int, global_rows: int,
                      fingerprint: str, label_sha256: Optional[str],
                      valid_counts: List[int],
                      phash: str = "") -> Optional[str]:
        """The sharded checkpoint protocol, run by every rank in lockstep;
        its only cross-rank step is the store exchange
        (``distributed.exchange_host``):

        1. rank 0 stages ``ckpt_N.tmp`` (or keeps an already valid
           ``ckpt_N``) and sends the decision;
        2. every rank writes ``shard_rank<r>.pkl`` into the stage and
           exchanges its metadata (bytes, sha256, row range, fingerprint);
           the exchange is also the all-shards-landed barrier;
        3. rank 0 writes model.txt, the global state.pkl, PARTITION.json
           and, last, MANIFEST.json, and publishes with one rename.

        A rank killed at any point leaves either no ``ckpt_N`` (a stale
        ``.tmp`` readers ignore) or a complete one. Returns the published
        path on rank 0, None elsewhere; ``last_save["shard_seconds"]`` is
        this rank's time to its shard's metadata exchange."""
        import time
        from . import network
        t0 = time.perf_counter()
        net = network.current()
        rank, world = net.rank, net.world
        name = f"ckpt_{iteration:08d}"
        path = os.path.join(self.directory, name)
        stage = path + ".tmp"
        decision = ""
        if rank == 0:
            os.makedirs(self.directory, exist_ok=True)
            self._clean_stale_tmp()
            if os.path.isdir(path) and self._quick_valid(path):
                decision = "skip"     # a resume re-reached it, same bits
            else:
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                os.makedirs(stage, exist_ok=True)
                decision = "stage"
        decision = distributed.exchange_host(
            f"ckpt_decision_{iteration}", decision)[0]
        if decision == "skip":
            if rank == 0:
                self._prune()
                return path
            return None
        shard_bytes = pickle.dumps(local_state, protocol=4)
        atomic_write_bytes(os.path.join(stage, shard_name(rank)),
                           shard_bytes)
        faults.maybe_kill_in_shard_write(self._fault_plan, iteration)
        meta = {
            "rank": rank,
            "bytes": len(shard_bytes),
            "sha256": hashlib.sha256(shard_bytes).hexdigest(),
            "row_start": int(row_start),
            "row_count": int(row_count),
            "fingerprint": fingerprint,
            "label_sha256": label_sha256,
            "valid_counts": [int(c) for c in valid_counts],
        }
        metas = [json.loads(m) for m in distributed.exchange_host(
            f"ckpt_shard_{iteration}", json.dumps(meta))]
        self.last_save = {"shard_seconds": time.perf_counter() - t0,
                          "shard_bytes": len(shard_bytes)}
        if rank != 0:
            return None
        model_bytes = model_text.encode()
        state_bytes = pickle.dumps(global_state, protocol=4)
        atomic_write_bytes(os.path.join(stage, MODEL_NAME), model_bytes)
        atomic_write_bytes(os.path.join(stage, STATE_NAME), state_bytes)
        faults.maybe_kill_in_ckpt_write(self._fault_plan, iteration)
        partition = {
            "world_size": world,
            "global_rows": int(global_rows),
            "ranks": [{"rank": m["rank"],
                       "row_start": m["row_start"],
                       "row_count": m["row_count"],
                       "label_sha256": m["label_sha256"],
                       "valid_counts": m["valid_counts"]}
                      for m in sorted(metas, key=lambda m: m["rank"])],
        }
        part_bytes = json.dumps(partition, indent=1, sort_keys=True).encode()
        atomic_write_bytes(os.path.join(stage, PARTITION_NAME), part_bytes)
        files = {
            MODEL_NAME: {"bytes": len(model_bytes),
                         "sha256": hashlib.sha256(model_bytes).hexdigest()},
            STATE_NAME: {"bytes": len(state_bytes),
                         "sha256": hashlib.sha256(state_bytes).hexdigest()},
            PARTITION_NAME: {"bytes": len(part_bytes),
                             "sha256": hashlib.sha256(part_bytes).hexdigest()},
        }
        for m in metas:
            files[shard_name(m["rank"])] = {"bytes": m["bytes"],
                                            "sha256": m["sha256"]}
        manifest = {
            "format": MANIFEST_FORMAT,
            "iteration": int(iteration),
            "params_hash": phash,
            "world_size": world,
            # a fingerprint per rank: each rank's rows are another slice
            "dataset_fingerprint": {str(m["rank"]): m["fingerprint"]
                                    for m in metas},
            "files": files,
            "health": distributed.health_snapshot(),
        }
        atomic_write_text(os.path.join(stage, MANIFEST_NAME),
                          json.dumps(manifest, indent=1, sort_keys=True))
        os.replace(stage, path)
        for m in metas:
            faults.maybe_corrupt_shard(
                self._fault_plan, os.path.join(path, shard_name(m["rank"])),
                m["rank"])
        faults.maybe_corrupt_checkpoint(self._fault_plan,
                                        os.path.join(path, MODEL_NAME))
        self._prune()
        self.last_save.update(state_bytes=len(state_bytes),
                              model_bytes=len(model_bytes))
        return path

    def _write(self, booster, iteration: int) -> str:
        """Stage the whole checkpoint in ``ckpt_N.tmp`` and publish it with
        one directory rename: a writer killed at any point leaves either
        no ``ckpt_N`` (a stale ``.tmp`` the name filter ignores and the
        next write removes) or a complete one; the manifest lands last."""
        import time
        t0 = time.perf_counter()
        name = f"ckpt_{iteration:08d}"
        path = os.path.join(self.directory, name)
        stage = path + ".tmp"
        os.makedirs(self.directory, exist_ok=True)
        self._clean_stale_tmp()
        if os.path.isdir(path):
            if self._quick_valid(path):
                # a resumed run re-reaches a checkpointed iteration: resume
                # is bit-identical, so the valid checkpoint already holds
                # these bytes, and keeping it means a kill can never
                # destroy a published valid checkpoint
                self._prune()
                return path
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(stage, exist_ok=True)
        model_bytes = booster.model_to_string(num_iteration=-1).encode()
        state_bytes = pickle.dumps(capture_state(booster), protocol=4)
        atomic_write_bytes(os.path.join(stage, MODEL_NAME), model_bytes)
        atomic_write_bytes(os.path.join(stage, STATE_NAME), state_bytes)
        faults.maybe_kill_in_ckpt_write(self._fault_plan, iteration)
        if self._dataset_fp is None:
            self._dataset_fp = dataset_fingerprint(
                booster._boosting.train_set)
        phash = getattr(booster, "_initial_params_hash", None) \
            or params_hash(booster.config)
        manifest = {
            "format": MANIFEST_FORMAT,
            "iteration": int(iteration),
            "params_hash": phash,
            "dataset_fingerprint": self._dataset_fp,
            "files": {
                MODEL_NAME: {"bytes": len(model_bytes),
                             "sha256": hashlib.sha256(model_bytes).hexdigest()},
                STATE_NAME: {"bytes": len(state_bytes),
                             "sha256": hashlib.sha256(state_bytes).hexdigest()},
            },
            "health": distributed.health_snapshot(),
        }
        atomic_write_text(os.path.join(stage, MANIFEST_NAME),
                          json.dumps(manifest, indent=1, sort_keys=True))
        os.replace(stage, path)
        faults.maybe_corrupt_checkpoint(self._fault_plan,
                                        os.path.join(path, MODEL_NAME))
        self._prune()
        self.last_save = {"seconds": time.perf_counter() - t0,
                          "state_bytes": len(state_bytes),
                          "model_bytes": len(model_bytes)}
        return path

    def _clean_stale_tmp(self) -> None:
        """Remove the ``ckpt_*.tmp`` staging directories a killed writer
        left behind (readers already ignore them)."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        for entry in entries:
            if entry.startswith("ckpt_") and entry.endswith(".tmp"):
                log.warning(f"removing stale checkpoint staging dir "
                            f"{entry} (writer was killed mid-write)")
                shutil.rmtree(os.path.join(self.directory, entry),
                              ignore_errors=True)

    def _quick_valid(self, path: str) -> bool:
        """Cheap structural validation for pruning: the manifest parses and
        every listed file exists at its recorded length (``validate`` does
        the checksums on the read side)."""
        try:
            with open(os.path.join(path, MANIFEST_NAME)) as fh:
                manifest = json.load(fh)
            if manifest.get("format") != MANIFEST_FORMAT:
                return False
            files = manifest.get("files", {})
            if not files:
                return False
            for fname, meta in files.items():
                if os.path.getsize(os.path.join(path, fname)) \
                        != int(meta["bytes"]):
                    return False
        except (OSError, ValueError, KeyError, TypeError):
            return False
        return True

    def _prune(self) -> None:
        """Retention by validity: keep the newest ``keep`` structurally
        valid checkpoints; invalid ones are deleted and never count toward
        ``keep``, so damaged newer checkpoints cannot evict the newest one
        that works."""
        valid, invalid = [], []
        for it, path in self.checkpoints():
            (valid if self._quick_valid(path) else invalid).append((it, path))
        for _, path in valid[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)
        for _, path in invalid:
            log.warning(f"pruning invalid checkpoint "
                        f"{os.path.basename(path)} (failed structural "
                        f"validation; it could never be resumed from)")
            shutil.rmtree(path, ignore_errors=True)

    # -------------------------------------------------------------- read
    def checkpoints(self) -> List[Tuple[int, str]]:
        """(iteration, path) pairs sorted ascending by iteration."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for entry in entries:
            m = _CKPT_RE.match(entry)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, entry)))
        return sorted(out)

    def validate(self, path: str) -> Dict[str, Any]:
        """Parse and integrity-check one checkpoint's manifest; raises
        ValueError naming what failed."""
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.exists(mpath):
            raise ValueError("no manifest (checkpoint write did not complete)")
        try:
            with open(mpath) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as e:
            raise ValueError(f"unreadable manifest: {e}")
        if manifest.get("format") != MANIFEST_FORMAT:
            raise ValueError(f"unknown manifest format "
                             f"{manifest.get('format')!r}")
        for fname, meta in manifest.get("files", {}).items():
            fpath = os.path.join(path, fname)
            if not os.path.exists(fpath):
                raise ValueError(f"missing file {fname}")
            size = os.path.getsize(fpath)
            if size != int(meta["bytes"]):
                raise ValueError(f"{fname} is {size} bytes, manifest says "
                                 f"{meta['bytes']} (truncated?)")
            with open(fpath, "rb") as fh:
                digest = hashlib.sha256(fh.read()).hexdigest()
            if digest != meta["sha256"]:
                raise ValueError(f"{fname} checksum mismatch (corrupt)")
        return manifest

    def load_latest_valid(self) -> Optional[LoadedCheckpoint]:
        """The newest checkpoint that passes validation, falling back past
        truncated or corrupt ones with a warning; None when the directory
        holds no valid checkpoint."""
        for iteration, path in reversed(self.checkpoints()):
            try:
                manifest = self.validate(path)
                with open(os.path.join(path, MODEL_NAME),
                          encoding="utf-8") as fh:
                    model_text = fh.read()
                with open(os.path.join(path, STATE_NAME), "rb") as fh:
                    state = pickle.load(fh)
                partition = None
                if PARTITION_NAME in manifest.get("files", {}):
                    with open(os.path.join(path, PARTITION_NAME)) as fh:
                        partition = json.load(fh)
            except (ValueError, OSError, pickle.UnpicklingError, EOFError,
                    TypeError, AttributeError, ImportError) as e:
                log.warning(f"checkpoint {os.path.basename(path)} is corrupt "
                            f"or truncated ({e}); falling back to the "
                            f"previous checkpoint")
                continue
            return LoadedCheckpoint(path=path, iteration=iteration,
                                    manifest=manifest, model_text=model_text,
                                    state=state, partition=partition)
        return None


def load_shard(ckpt_path: str, rank: int) -> Dict[str, Any]:
    """One rank's score-cache shard of a sharded checkpoint (``validate``
    checked it against the manifest already)."""
    with open(os.path.join(ckpt_path, shard_name(rank)), "rb") as fh:
        return pickle.load(fh)


def _cumulative_ranges(counts: List[int]) -> List[Tuple[int, int]]:
    out, start = [], 0
    for c in counts:
        out.append((start, int(c)))
        start += int(c)
    return out


def reassemble_local_state(ckpt: LoadedCheckpoint, row_start: int,
                           row_count: int,
                           valid_ranges: List[Tuple[int, int]]
                           ) -> Dict[str, Any]:
    """This rank's score caches (train and valid) from a sharded
    checkpoint written at any world size: each row range is reassembled
    from the old shards that overlap it (``distributed.repartition_rows``),
    and only those shard files are read, so a resume under the same
    partition reads its own shard alone."""
    part = ckpt.partition or {}
    ranks = part.get("ranks") or []
    old_train = [(e["row_start"], e["row_count"]) for e in ranks]
    cache: Dict[int, Dict[str, Any]] = {}

    def fetch(field, vi=None):
        def _fetch(r):
            if r not in cache:
                cache[r] = load_shard(ckpt.path, r)
            s = cache[r]
            return np.asarray(s[field] if vi is None
                              else s["valid_scores"][vi])
        return _fetch

    train_score = distributed.repartition_rows(
        old_train, row_start, row_count, fetch("train_score"))
    valid_scores = []
    for vi, (vs, vc) in enumerate(valid_ranges):
        old_valid = _cumulative_ranges(
            [e["valid_counts"][vi] for e in ranks])
        valid_scores.append(distributed.repartition_rows(
            old_valid, vs, vc, fetch(None, vi)))
    return {"train_score": train_score, "valid_scores": valid_scores}


def _validate_sharded_dataset(booster, ckpt: LoadedCheckpoint,
                              row_start: int, row_count: int) -> None:
    """The dataset checks of a sharded resume. A rank whose rows are an
    old rank's compares that rank's fingerprint; after a re-partition the
    rank recomputes the recorded label hash of every old range its own
    range contains (row content only, so at any world size)."""
    part = ckpt.partition or {}
    ts = booster._boosting.train_set
    global_rows = int(getattr(ts, "num_data", 0) or 0)
    if int(part.get("global_rows", -1)) != global_rows:
        log.fatal(
            f"cannot resume from {ckpt.path}: it was written for "
            f"{part.get('global_rows')} global rows, this dataset has "
            f"{global_rows}.")
    want_fp = ckpt.manifest.get("dataset_fingerprint")
    ranks = part.get("ranks") or []
    exact = next((e for e in ranks
                  if int(e["row_start"]) == row_start
                  and int(e["row_count"]) == row_count), None)
    if exact is not None and isinstance(want_fp, dict):
        rec = want_fp.get(str(exact["rank"]))
        fp = dataset_fingerprint(ts, local=True)
        if rec and rec != fp:
            log.fatal(
                f"cannot resume from {ckpt.path}: it was written against "
                f"a different training dataset (rank {exact['rank']} "
                f"fingerprint {rec} != {fp}).")
    label = ts.get_label() if hasattr(ts, "get_label") else None
    if label is None:
        return
    lo, hi = row_start, row_start + row_count
    for e in ranks:
        s, c = int(e["row_start"]), int(e["row_count"])
        if s >= lo and s + c <= hi and e.get("label_sha256"):
            got = label_range_sha256(label, s - lo, s + c - lo)
            if got != e["label_sha256"]:
                log.fatal(
                    f"cannot resume from {ckpt.path}: label rows "
                    f"[{s}, {s + c}) do not match the checkpoint's "
                    f"recorded content hash — the dataset changed (or "
                    f"rows were reordered) since the checkpoint was "
                    f"written.")


def _near_equal_counts(total: int, parts: int) -> List[int]:
    base, rem = divmod(int(total), int(parts))
    return [base + (1 if r < rem else 0) for r in range(parts)]


def repartition_checkpoint(ckpt_path: str, new_world_size: int,
                           dest_dir: str) -> str:
    """Offline re-shard: a sharded checkpoint rewritten for another world
    size (near-equal contiguous row ranges) into ``dest_dir``, for an
    operator who prefers to pay the re-shard once before relaunching (the
    resume re-partitions on load by itself either way). Pure row
    movement: every row's float32 score bits are kept. Returns the new
    checkpoint's path."""
    ckpt_path = os.path.abspath(ckpt_path)
    new_world_size = int(new_world_size)
    if new_world_size < 1:
        raise ValueError(f"new_world_size must be >= 1, got {new_world_size}")
    manifest = CheckpointManager(os.path.dirname(ckpt_path)).validate(
        ckpt_path)
    if PARTITION_NAME not in manifest.get("files", {}):
        raise ValueError(f"{ckpt_path} is not a sharded checkpoint "
                         f"(no {PARTITION_NAME})")
    with open(os.path.join(ckpt_path, PARTITION_NAME)) as fh:
        partition = json.load(fh)
    ranks = partition["ranks"]
    shards = [load_shard(ckpt_path, e["rank"]) for e in ranks]
    train = np.concatenate([np.asarray(s["train_score"]) for s in shards],
                           axis=0)
    nvalid = len(ranks[0].get("valid_counts") or []) if ranks else 0
    valids = [np.concatenate([np.asarray(s["valid_scores"][vi])
                              for s in shards], axis=0)
              for vi in range(nvalid)]
    counts = _near_equal_counts(partition["global_rows"], new_world_size)
    vcounts = [_near_equal_counts(v.shape[0], new_world_size)
               for v in valids]
    old_by_range = {(int(e["row_start"]), int(e["row_count"])): e
                    for e in ranks}
    iteration = int(manifest["iteration"])
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, f"ckpt_{iteration:08d}")
    stage = dest + ".tmp"
    if os.path.isdir(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    files = {}
    new_ranks = []
    start = 0
    vstarts = [0] * nvalid
    for r, count in enumerate(counts):
        local = {
            "train_score": train[start:start + count],
            "valid_scores": [valids[vi][vstarts[vi]:vstarts[vi]
                                        + vcounts[vi][r]]
                             for vi in range(nvalid)],
        }
        shard_bytes = pickle.dumps(local, protocol=4)
        atomic_write_bytes(os.path.join(stage, shard_name(r)), shard_bytes)
        files[shard_name(r)] = {
            "bytes": len(shard_bytes),
            "sha256": hashlib.sha256(shard_bytes).hexdigest()}
        # label hashes and fingerprints carry over only for a range that
        # is exactly an old rank's (labels are not in the checkpoint, so
        # they cannot be hashed again offline)
        old = old_by_range.get((start, count))
        new_ranks.append({
            "rank": r, "row_start": start, "row_count": count,
            "label_sha256": old.get("label_sha256") if old else None,
            "valid_counts": [vcounts[vi][r] for vi in range(nvalid)]})
        start += count
        for vi in range(nvalid):
            vstarts[vi] += vcounts[vi][r]
    for fname in (MODEL_NAME, STATE_NAME):
        shutil.copy2(os.path.join(ckpt_path, fname),
                     os.path.join(stage, fname))
        files[fname] = dict(manifest["files"][fname])
    new_partition = {"world_size": new_world_size,
                     "global_rows": int(partition["global_rows"]),
                     "ranks": new_ranks}
    part_bytes = json.dumps(new_partition, indent=1, sort_keys=True).encode()
    atomic_write_bytes(os.path.join(stage, PARTITION_NAME), part_bytes)
    files[PARTITION_NAME] = {
        "bytes": len(part_bytes),
        "sha256": hashlib.sha256(part_bytes).hexdigest()}
    old_fp = manifest.get("dataset_fingerprint")
    new_fp = {}
    if isinstance(old_fp, dict):
        for e in new_ranks:
            old = old_by_range.get((e["row_start"], e["row_count"]))
            if old is not None and str(old["rank"]) in old_fp:
                new_fp[str(e["rank"])] = old_fp[str(old["rank"])]
    new_manifest = dict(manifest)
    new_manifest.update({"world_size": new_world_size,
                         "dataset_fingerprint": new_fp, "files": files})
    atomic_write_text(os.path.join(stage, MANIFEST_NAME),
                      json.dumps(new_manifest, indent=1, sort_keys=True))
    if os.path.isdir(dest):
        shutil.rmtree(dest)
    os.replace(stage, dest)
    return dest


def restore_booster(booster, ckpt: LoadedCheckpoint) -> Dict[str, Any]:
    """Restore a freshly constructed training booster to the checkpointed
    state after checking that the params and the dataset match what the
    checkpoint was written with. A sharded checkpoint also gives this rank
    its score caches, reassembled from the shards under the current
    partition (a resume at another world size re-partitions on load).
    Returns the saved callback states (keyed by ``ckpt_key``) for the
    engine to hand to its callbacks."""
    phash = getattr(booster, "_initial_params_hash", None) \
        or params_hash(booster.config)
    want = ckpt.manifest.get("params_hash")
    if want and want != phash:
        log.fatal(
            f"cannot resume from {ckpt.path}: it was written with different "
            f"training parameters (params_hash {want} != {phash}) — "
            f"resuming would silently train a different model. Use the "
            f"original parameters, or delete the checkpoint directory to "
            f"start fresh.")
    from . import network
    boosting = booster._boosting
    net = network.current()
    if ckpt.partition is not None:
        ts = boosting.train_set
        row_start = int(getattr(ts, "local_row_start", 0) or 0)
        n_local = getattr(ts, "num_local_data", None)
        row_count = int(n_local if n_local else ts.num_data)
        _validate_sharded_dataset(booster, ckpt, row_start, row_count)
        my_valid_counts = [int(s.shape[0]) for s in boosting._valid_scores]
        ranks = ckpt.partition.get("ranks") or []
        old_nvalid = len(ranks[0].get("valid_counts") or []) if ranks else 0
        if len(my_valid_counts) != old_nvalid:
            log.fatal(
                f"cannot resume from {ckpt.path}: it was written with "
                f"{old_nvalid} validation sets; this run has "
                f"{len(my_valid_counts)} — pass the same valid_sets in the "
                f"same order")
        if boosting._pre_part:
            # each rank's valid-row offsets from the counts of the ranks
            # below it (a store exchange; trivial in a gang of one)
            all_counts = [json.loads(p) for p in distributed.exchange_host(
                "resume_valid_counts", json.dumps(my_valid_counts))]
            valid_ranges = [
                (sum(c[vi] for c in all_counts[:net.rank]),
                 my_valid_counts[vi])
                for vi in range(len(my_valid_counts))]
        else:
            # a replicated booster reading a sharded checkpoint: every rank
            # holds all rows, every range starts at 0 (no exchange: every
            # rank skips it alike)
            valid_ranges = [(0, c) for c in my_valid_counts]
            if getattr(boosting, "_need_bagging", False):
                log.warning(
                    "resuming a pre-partitioned (sharded) checkpoint with "
                    "replicated data: the bagging sample stream is "
                    "mode-dependent (pre-partitioned draws are keyed per "
                    "global row), so continued training will not "
                    "bit-match a continuation of the original "
                    "pre-partitioned run")
        local = reassemble_local_state(ckpt, row_start, row_count,
                                       valid_ranges)
        merged = dict(ckpt.state["boosting"])
        merged.update(local)
        boosting.set_trainer_state(merged)
    else:
        if boosting._pre_part and net.world > 1:
            log.fatal(
                f"cannot resume from {ckpt.path}: the checkpoint is not "
                f"sharded (no {PARTITION_NAME}), but this is a "
                f"multi-process pre-partitioned run whose score caches "
                f"are process-local. Re-run the original training with "
                f"checkpoint_shards=true, or resume replicated.")
        fp = dataset_fingerprint(boosting.train_set)
        want_fp = ckpt.manifest.get("dataset_fingerprint")
        if want_fp and not isinstance(want_fp, dict) and want_fp != fp:
            log.fatal(
                f"cannot resume from {ckpt.path}: it was written against a "
                f"different training dataset (fingerprint {want_fp} != "
                f"{fp}).")
        boosting.set_trainer_state(ckpt.state["boosting"])
    b = ckpt.state.get("booster", {})
    booster.best_iteration = b.get("best_iteration", -1)
    booster.best_score = dict(b.get("best_score", {}))
    if b.get("attr"):
        booster._attr = dict(b["attr"])
    return dict(ckpt.state.get("callbacks", {}))
