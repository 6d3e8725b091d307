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

The sharded layout of pre-partitioned multi-process runs
(``write_sharded``, ``load_shard``, ``reassemble_local_state``,
``repartition_checkpoint``, ``checkpoint_shards``) comes with ROADMAP
Queue 1 item 15.

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
_SHARDED = "Queue 1 item 15 (distributed)"

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


def _sharded(what: str):
    raise NotImplementedError(
        f"{what}: sharded checkpoints of pre-partitioned multi-process runs "
        f"are not ported to lightgbm_tpu_torch yet; they arrive with "
        f"ROADMAP.md {_SHARDED}")


def params_hash(config) -> str:
    """Stable hash of the training-relevant parameters (every Config field
    but ``_NON_TRAINING_PARAMS``, lists included): resuming under another
    configuration is refused, not silently trained on."""
    items = sorted(
        (f.name, repr(getattr(config, f.name)))
        for f in dataclasses.fields(type(config))
        if f.name not in _NON_TRAINING_PARAMS)
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def dataset_fingerprint(train_set) -> str:
    """Cheap identity check for the training data: shape plus the label
    and weight bytes (float64), the JAX package's digest."""
    h = hashlib.sha256()
    n = int(getattr(train_set, "num_data", 0) or 0)
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
        self.last_save: Dict[str, Any] = {}

    # ------------------------------------------------------------- write
    def save(self, booster, iteration: int) -> Optional[str]:
        """Checkpoint ``booster`` after ``iteration`` completed boosting
        iterations, then pass the barrier (a no-op in one process). A
        multi-rank run's checkpoint is the sharded layout, which is not
        ported yet."""
        from . import network
        if network.current().world > 1:
            _sharded("a checkpoint of a multi-rank run")
        path = self._write(booster, iteration)
        distributed.barrier(f"lgbm_tpu_checkpoint_{iteration}")
        return path

    def write_sharded(self, *args, **kwargs):
        _sharded("CheckpointManager.write_sharded")

    def _write_sharded_booster(self, booster, iteration: int):
        _sharded("CheckpointManager._write_sharded_booster")

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


def load_shard(ckpt_path: str, rank: int):
    _sharded("load_shard")


def reassemble_local_state(*args, **kwargs):
    _sharded("reassemble_local_state")


def repartition_checkpoint(ckpt_path: str, new_world_size: int,
                           dest_dir: str) -> str:
    _sharded("repartition_checkpoint")


def restore_booster(booster, ckpt: LoadedCheckpoint) -> Dict[str, Any]:
    """Restore a freshly constructed training booster to the checkpointed
    state after checking that the params and the dataset match what the
    checkpoint was written with. Returns the saved callback states (keyed
    by ``ckpt_key``) for the engine to hand to its callbacks."""
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
    if ckpt.partition is not None:
        _sharded(f"resuming from the sharded checkpoint {ckpt.path}")
    boosting = booster._boosting
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
