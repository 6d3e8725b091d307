"""Command-line application.

The port of lightgbm_tpu's ``cli.py``, after the reference CLI (reference:
src/main.cpp:11-42, src/application/application.cpp:31-271): ``python -m
lightgbm_tpu_torch config=train.conf [key=value ...]`` with tasks train /
predict / convert_model / refit / save_binary, on the card unless
``device_type=cpu``. Data files are parsed by the native C++ loader
(native/text_parser.cpp); side files ``<data>.weight`` / ``<data>.query``
/ ``<data>.init`` supply metadata the way the reference's Metadata loader
does (reference: src/io/metadata.cpp). ``snapshot_freq`` writes atomic
training checkpoints under ``checkpoint_path`` (default
``<output_model>.ckpt``), keeping ``checkpoint_keep``, and a second
``task=train`` with the same command resumes from the newest valid one.
Every output file (model, converted C++, the ``.bin`` dataset) is written
atomically (``utils/atomic_write``)."""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import binning
from .basic import Dataset
from .booster import Booster
from .config import Config, parse_config_file
from .engine import train as engine_train
from .native import parse_text_file
from .utils import log


def _parse_argv(argv: List[str]) -> Dict[str, str]:
    """key=value args + config file merge (reference: application.cpp:31-85 —
    command-line pairs override the config file)."""
    params: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            log.fatal(f"Unknown argument: {arg} (expected key=value)")
        key, value = arg.split("=", 1)
        params[key.strip()] = value.strip()
    if "config" in params:
        file_params = parse_config_file(params.pop("config"))
        for key, value in file_params.items():
            params.setdefault(key, value)
    return params


def _column_index(spec: str, header_names: Optional[List[str]]) -> Optional[int]:
    """Column spec: int index or 'name:<col>' (reference: config.h label_column
    docs)."""
    if spec == "":
        return None
    if spec.startswith("name:"):
        name = spec[5:]
        if header_names is None or name not in header_names:
            log.fatal(f"Column name {name} requires header=true and a matching "
                      f"header line")
        return header_names.index(name)
    return int(spec)


def _read_header(path: str, config: Config) -> Optional[List[str]]:
    if not config.header:
        return None
    with open(path) as fh:
        first = fh.readline().rstrip("\n")
    if "," in first:
        return first.split(",")
    if "\t" in first:
        return first.split("\t")
    # whitespace-separated files (the native parser's auto-detected format)
    return first.split()


def _side_file(path: str, suffix: str) -> Optional[np.ndarray]:
    """Optional metadata side file (reference: metadata.cpp loads
    <data>.weight/.query/.init when present)."""
    side = path + suffix
    if os.path.exists(side):
        return np.loadtxt(side, ndmin=1)
    return None


def _resolve_columns(path: str, config: Config):
    """Shared column resolution for both loading paths: returns
    (header_names, label_idx, weight_idx, group_idx, drop-set)."""
    header_names = _read_header(path, config)
    label_idx = _column_index(config.label_column, header_names)
    if label_idx is None:
        label_idx = 0
    drop = {label_idx}
    if config.ignore_column:
        for part in str(config.ignore_column).split(","):
            idx = _column_index(part, header_names)
            if idx is not None:
                drop.add(idx)
    weight_idx = _column_index(config.weight_column, header_names)
    group_idx = _column_index(config.group_column, header_names)
    if weight_idx is not None:
        drop.add(weight_idx)
    if group_idx is not None:
        drop.add(group_idx)
    return header_names, label_idx, weight_idx, group_idx, drop


def _qid_to_group(group_col: np.ndarray) -> np.ndarray:
    """Per-row query ids -> query boundary counts by CONSECUTIVE RUNS in
    file order (reference: metadata.cpp query column handling — qids need
    not be globally sorted, only grouped)."""
    group_col = np.asarray(group_col)
    if len(group_col) == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(np.diff(group_col) != 0)[0]
    bounds = np.concatenate([[0], change + 1, [len(group_col)]])
    return np.diff(bounds)


def load_data_file(path: str, config: Config
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                              Optional[np.ndarray], Optional[np.ndarray]]:
    """Load one data file -> (X, y, weight, group, init_score)."""
    if path.endswith(".bin"):
        return _load_binary(path)
    (header_names, label_idx, weight_idx, group_idx,
     drop) = _resolve_columns(path, config)
    mat, _fmt = parse_text_file(path, has_header=config.header,
                                num_threads=config.num_threads)

    y = mat[:, label_idx]
    weight = mat[:, weight_idx] if weight_idx is not None else None
    group_col = mat[:, group_idx] if group_idx is not None else None
    keep = [j for j in range(mat.shape[1]) if j not in drop]
    X = mat[:, keep]

    if weight is None:
        weight = _side_file(path, ".weight")
    group = _side_file(path, ".query")
    if group is None and group_col is not None:
        group = _qid_to_group(group_col)
    init_score = _side_file(path, ".init")
    return X, y, weight, group, init_score


def _save_binary(path: str, X, y, weight, group, init_score) -> None:
    """Dataset binary serialization (reference: dataset_loader.cpp:316
    LoadFromBinFile / save_binary -- here a versioned npz container, the
    JAX package's format), written to a temporary file and renamed (a
    killed save must not leave a truncated .bin a later run would trip
    over)."""
    from .utils.atomic_write import atomic_open
    with atomic_open(path) as fh:   # file object: np.savez won't append .npz
        np.savez_compressed(fh, version=1, X=X, y=y,
                            weight=weight if weight is not None else np.zeros(0),
                            group=group if group is not None else np.zeros(0),
                            init_score=(init_score if init_score is not None
                                        else np.zeros(0)))


def _load_binary(path: str):
    z = np.load(path, allow_pickle=False)
    opt = lambda a: None if a.size == 0 else a
    return (z["X"], z["y"], opt(z["weight"]), opt(z["group"]),
            opt(z["init_score"]))


def _iter_parsed_chunks(path: str, config: Config,
                        chunk_bytes: int = 64 << 20):
    """Stream a text file in line-aligned chunks, parsing each with the
    native parser (the streaming half of the reference's two-round loading,
    dataset_loader.cpp:225-244 + pipeline_reader.h)."""
    from .native import parse_buffer
    carry = b""
    first = True
    ncols = None

    def emit(data):
        nonlocal ncols
        mat = parse_buffer(data, has_header=False,
                           num_threads=config.num_threads)[0]
        # the parser infers the width per buffer; ragged rows or format
        # drift across chunk boundaries would silently corrupt columns
        if ncols is None:
            ncols = mat.shape[1]
        elif mat.shape[1] != ncols:
            log.fatal(f"two_round loading needs a fixed column count: "
                      f"{path} yielded {mat.shape[1]} columns in a chunk "
                      f"where earlier chunks had {ncols} (ragged rows?)")
        return mat

    with open(path, "rb") as fh:
        while True:
            blk = fh.read(chunk_bytes)
            if not blk:
                if carry.strip():
                    yield emit(carry)
                return
            blk = carry + blk
            cut = blk.rfind(b"\n")
            if cut < 0:
                carry = blk
                continue
            chunk, carry = blk[:cut + 1], blk[cut + 1:]
            if first and config.header:
                chunk = chunk[chunk.find(b"\n") + 1:]
            first = False
            if chunk.strip():
                yield emit(chunk)


def _metadata_tail(path: str, ws: list, gs: list):
    """Shared weight/group/init_score precedence for the streaming loaders:
    in-file columns win, then side files, with qid runs converted to group
    boundaries (metadata.cpp)."""
    weight = np.concatenate(ws) if ws else _side_file(path, ".weight")
    group = _side_file(path, ".query")
    if group is None and gs:
        group = _qid_to_group(np.concatenate(gs))
    return weight, group, _side_file(path, ".init")


def _two_round_eligible(path: str, config: Config) -> bool:
    """CSV/TSV with fixed columns only; linear trees need resident raw
    features. Ineligible files fall back to in-memory loading."""
    if config.linear_tree:
        log.warning("two_round is not supported with linear_tree; "
                    "falling back to in-memory loading")
        return False
    # chunked parsing needs a fixed column count per line; LibSVM's sparse
    # rows make per-chunk column inference unstable -> in-memory fallback
    # (sniff several lines: a LibSVM file may open with label-only rows)
    with open(path) as fh:
        if config.header:
            fh.readline()
        probe = [fh.readline() for _ in range(5)]
    if any(":" in t for line in probe for t in line.split()[1:]):
        log.warning("two_round loading supports CSV/TSV only; "
                    "falling back to in-memory loading for LibSVM input")
        return False
    return True


def _bin_chunk(Xc: np.ndarray, used_idx, used, device) -> torch.Tensor:
    """One parsed chunk's used columns binned on ``device``: [F, rows] (a
    zero column when no feature is used, as ``Dataset.bin_new_data``)."""
    if not len(used):
        return torch.zeros((1, Xc.shape[0]), dtype=torch.uint8,
                           device=device)
    return binning.bin_data_device(Xc[:, used_idx], used, device)


def load_valid_two_round(path: str, config: Config, params: Dict[str, str],
                         reference: Dataset) -> Optional[Dataset]:
    """Stream-bin a VALIDATION file against the reference's mappers (the
    second round only — mappers come from the train set; reference:
    dataset_loader.cpp:262-314 LoadFromFileAlignWithOtherDataset under
    two-round mode)."""
    if getattr(reference, "bundles", None) is not None:
        return None   # bundled references bin through bundle columns
    if not _two_round_eligible(path, config):
        return None
    (header_names, label_idx, weight_idx, group_idx,
     drop) = _resolve_columns(path, config)
    used_idx = reference.used_features
    used = [reference.mappers[j] for j in used_idx]
    ys, ws, gs, chunks = [], [], [], []
    for mat in _iter_parsed_chunks(path, config):
        keep = [j for j in range(mat.shape[1]) if j not in drop]
        if len(keep) != reference.num_total_features:
            log.fatal(f"validation file {path} has {len(keep)} features; "
                      f"training data had "
                      f"{reference.num_total_features}")
        ys.append(mat[:, label_idx].copy())
        if weight_idx is not None:
            ws.append(mat[:, weight_idx].copy())
        if group_idx is not None:
            gs.append(mat[:, group_idx].copy())
        chunks.append(_bin_chunk(mat[:, keep], used_idx, used,
                                 reference.device))
    if not chunks:
        log.fatal(f"empty validation file {path}")
    y = np.concatenate(ys)
    ds = Dataset(None, label=y, reference=reference, params=dict(params),
                 feature_name=list(reference._feature_names))
    ds.device = reference.device
    ds.mappers = reference.mappers
    ds.used_features = reference.used_features
    ds.pandas_categorical = reference.pandas_categorical
    ds.num_data = len(y)
    ds.num_total_features = reference.num_total_features
    ds._feature_names = list(reference._feature_names)
    ds._build_feature_meta(config)
    ds.binsT = torch.cat(chunks, dim=1) if len(chunks) > 1 else chunks[0]
    ds.raw_data_np = None
    ds._constructed = True
    ds.weight, ds.group, ds.init_score = _metadata_tail(path, ws, gs)
    log.info(f"two-round valid loading: {len(y)} rows")
    return ds


def load_dataset_two_round(path: str, config: Config,
                           params: Dict[str, str]) -> Optional[Dataset]:
    """Two-round low-memory loading (reference: dataset_loader.cpp:225-244
    use_two_round_loading): round 1 streams the file collecting the label/
    weight/group columns and a row sample for bin finding; round 2 streams
    again, binning each chunk against the fitted mappers — the full raw
    feature matrix is never resident (peak memory = the 1-byte bin matrix
    plus one parsed chunk)."""
    if not _two_round_eligible(path, config):
        return None
    (header_names, label_idx, weight_idx, group_idx,
     drop) = _resolve_columns(path, config)

    # round 1: labels/metadata + reservoir sample of feature rows
    # (algorithm R, seeded — the analog of the reference's Random::Sample
    # over the stream)
    rng = np.random.RandomState(config.data_random_seed)
    cap = config.bin_construct_sample_cnt
    sample_rows: List[np.ndarray] = []
    ys, ws, gs = [], [], []
    keep = None
    n_total = 0
    for mat in _iter_parsed_chunks(path, config):
        if keep is None:
            keep = [j for j in range(mat.shape[1]) if j not in drop]
        ys.append(mat[:, label_idx].copy())
        if weight_idx is not None:
            ws.append(mat[:, weight_idx].copy())
        if group_idx is not None:
            gs.append(mat[:, group_idx].copy())
        Xc = mat[:, keep]
        m = Xc.shape[0]
        take = min(max(cap - n_total, 0), m)
        if take:                            # filling phase, vectorized
            sample_rows.extend(list(Xc[:take].copy()))
        if take < m:
            # vectorized reservoir (algorithm R) for the rest of the chunk
            draws = rng.randint(0, n_total + np.arange(take, m) + 1)
            hit = np.nonzero(draws < cap)[0]
            for r in hit:
                sample_rows[draws[r]] = Xc[take + r].copy()
        n_total += m
    if keep is None:
        log.fatal(f"empty data file {path}")
    y = np.concatenate(ys)
    sample = np.asarray(sample_rows)

    names = ([header_names[j] for j in keep] if header_names
             else [f"Column_{i}" for i in range(len(keep))])
    ds = Dataset(None, label=y, params=dict(params), feature_name=names)
    ds.device = config.torch_device()
    ds._feature_names = names
    ds.num_total_features = len(keep)
    cats = ds._resolve_categorical(config)
    cat_set = set(int(c) for c in cats)
    from .basic import _load_forced_bins
    forced = _load_forced_bins(config, len(keep), cats)
    filter_cnt = binning.filter_cnt_for_sample(config, len(sample), n_total)
    ds.mappers = [binning.fit_mapper_for_column(
        j, np.asarray(sample[:, j], np.float64), len(sample), config,
        cat_set, filter_cnt, forced) for j in range(len(keep))]
    ds.used_features = np.array(
        [j for j, m in enumerate(ds.mappers) if not m.is_trivial], np.int32)
    ds.num_data = n_total
    ds.bundles = None
    ds._build_feature_meta(config)

    # round 2: bin chunk by chunk against the agreed mappers, on the device
    used = [ds.mappers[j] for j in ds.used_features]
    binsT = torch.cat([_bin_chunk(mat[:, keep], ds.used_features, used,
                                  ds.device)
                       for mat in _iter_parsed_chunks(path, config)], dim=1)
    ds.binsT = ds._maybe_extract_sparse(binsT, config)
    ds.raw_data_np = None
    ds._constructed = True

    ds.weight, ds.group, ds.init_score = _metadata_tail(path, ws, gs)
    log.info(f"two-round loading: {n_total} rows, "
             f"{len(ds.used_features)} used features")
    return ds


def _make_dataset(path: str, config: Config, params: Dict[str, str],
                  reference: Optional[Dataset] = None) -> Dataset:
    if config.two_round and not path.endswith(".bin"):
        ds = (load_dataset_two_round(path, config, params)
              if reference is None
              else load_valid_two_round(path, config, params,
                                        reference.construct()))
        if ds is not None:
            return ds
    X, y, weight, group, init_score = load_data_file(path, config)
    return Dataset(X, label=y, weight=weight, group=group,
                   init_score=init_score, reference=reference, params=params,
                   free_raw_data=False)


def run_train(config: Config, params: Dict[str, str]) -> None:
    """task=train (reference: application.cpp InitTrain/Train)."""
    if not config.data:
        log.fatal("No training data: set data=<file>")
    train_set = _make_dataset(config.data, config, params)
    valid_sets, valid_names = [], []
    for vf in config.valid:
        valid_sets.append(_make_dataset(vf, config, params, reference=train_set))
        valid_names.append(os.path.basename(vf))

    callbacks = []
    resume_from = None
    if config.snapshot_freq > 0:
        # snapshot_freq rides the atomic checkpoints (in place of the
        # reference's non-atomic model.txt.snapshot_iter_N dumps,
        # gbdt.cpp:277-281): the full trainer state, manifest-validated
        # files, and automatic resume -- a killed run started again with
        # the same command continues bit-identically from the newest
        # valid checkpoint
        from . import callback as callback_mod
        ckpt_dir = config.checkpoint_path or (config.output_model + ".ckpt")
        callbacks.append(callback_mod.checkpoint(
            ckpt_dir, period=config.snapshot_freq,
            keep=config.checkpoint_keep))
        if os.path.isdir(ckpt_dir):
            resume_from = ckpt_dir
            log.info(f"checkpoint directory {ckpt_dir} exists; resuming "
                     f"from the newest valid checkpoint")

    booster = engine_train(
        dict(params), train_set, num_boost_round=config.num_iterations,
        valid_sets=valid_sets, valid_names=valid_names,
        init_model=config.input_model or None,
        early_stopping_rounds=config.early_stopping_round or None,
        verbose_eval=config.metric_freq if (valid_sets or
                                            config.is_provide_training_metric)
        else False,
        callbacks=callbacks, resume_from=resume_from)
    booster.save_model(config.output_model)
    log.info(f"Finished training, model saved to {config.output_model}")


def run_predict(config: Config, params: Dict[str, str]) -> None:
    """task=predict (reference: application.cpp Predict + predictor.hpp)."""
    if not config.input_model:
        log.fatal("No model file: set input_model=<file>")
    if not config.data:
        log.fatal("No prediction data: set data=<file>")
    booster = Booster(model_file=config.input_model)
    X, _y, _w, _g, _i = load_data_file(config.data, config)
    result = booster.predict(
        X, raw_score=config.predict_raw_score,
        pred_leaf=config.predict_leaf_index,
        pred_contrib=config.predict_contrib,
        num_iteration=config.num_iteration_predict,
        start_iteration=config.start_iteration_predict)
    result = np.atleast_2d(np.asarray(result))
    if result.shape[0] == 1 and X.shape[0] != 1:
        result = result.T
    np.savetxt(config.output_result, result, fmt="%.10g", delimiter="\t")
    log.info(f"Finished prediction, results saved to {config.output_result}")


def run_convert_model(config: Config, params: Dict[str, str]) -> None:
    """task=convert_model: if-else C++ codegen
    (reference: gbdt_model_text.cpp ModelToIfElse)."""
    if not config.input_model:
        log.fatal("No model file: set input_model=<file>")
    booster = Booster(model_file=config.input_model)
    from .io.codegen import model_to_if_else
    from .utils.atomic_write import atomic_write_text
    atomic_write_text(config.convert_model,
                      model_to_if_else(booster._boosting))
    log.info(f"Converted model saved to {config.convert_model}")


def run_refit(config: Config, params: Dict[str, str]) -> None:
    """task=refit: re-fit leaf values of an existing model on new data
    (reference: application.cpp:221 ConvertModel task=refit ->
    GBDT::RefitTree, gbdt.cpp:285-321)."""
    if not config.input_model:
        log.fatal("No model file: set input_model=<file>")
    if not config.data:
        log.fatal("No refit data: set data=<file>")
    # the refit's passes run where device_type says
    booster = Booster(params={"device_type": config.device_type},
                      model_file=config.input_model)
    X, y, weight, group, _i = load_data_file(config.data, config)
    refitted = booster.refit(X, y, weight=weight, group=group,
                             decay_rate=config.refit_decay_rate)
    refitted.save_model(config.output_model)
    log.info(f"Finished refit, model saved to {config.output_model}")


def run_save_binary(config: Config, params: Dict[str, str]) -> None:
    """task=save_binary (reference: application.cpp:260-270)."""
    if not config.data:
        log.fatal("No data: set data=<file>")
    X, y, weight, group, init_score = load_data_file(config.data, config)
    out = config.data + ".bin"
    _save_binary(out, X, y, weight, group, init_score)
    log.info(f"Dataset saved to {out}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    params = _parse_argv(argv)
    config = Config.from_params(dict(params))
    task = config.task
    runners = {"train": run_train, "predict": run_predict,
               "prediction": run_predict, "test": run_predict,
               "convert_model": run_convert_model, "refit": run_refit,
               "refit_tree": run_refit, "save_binary": run_save_binary}
    if task not in runners:
        log.fatal(f"Unknown task: {task}")
    runners[task](config, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
