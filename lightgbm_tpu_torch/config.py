"""Configuration / parameter system of the PyTorch/CUDA port.

The parameter table of lightgbm_tpu's ``config.py`` carried over field for
field (same names, defaults, order and alias table, so ``to_params`` echoes
the same ``parameters:`` block into model text), with three port rules:

- ``device_type`` (alias ``device``) defaults to ``"cuda"``; ``"cpu"`` runs
  every kernel's plain PyTorch version. ``"cuda"`` on a machine without a
  CUDA device raises a RuntimeError naming the missing device — the port
  never continues on the CPU behind the caller's back (``torch_device``).
- ``histogram_method`` accepts ``auto``/``pallas``/``pallas_hilo``/
  ``pallas_q8``: on CUDA all of them resolve to the hand-written Hopper
  kernels (which accumulate true f32, so ``pallas_hilo`` equals ``pallas``
  there), on the CPU to their plain versions. ``pallas_q8``, or
  ``quantized_grad`` with any of the others, selects the kernels' q8 mode
  (int8 gradients, exact int32 sums). Any other value raises: the XLA
  methods (``scatter``, ``binloop``, ``onehot*``) have no counterpart in
  the port, which has one histogram path.
- ``gpu_use_dp`` always means the JAX package's float64 mode as it runs
  with x64 on (f64 histograms on the classic split path): the port has no
  x64 switch, so it has no float32 fallback either.
- ``deterministic`` is accepted and changes nothing: the port's kernels
  add their float sums in a fixed order, so two runs on the card give the
  same bits whether it is set or not (and on Hopper there is no hi/lo
  split for it to turn off).
- Every parameter outside the port's implemented slice (dense numerical
  and categorical data with sparse device columns, serial learner; gbdt,
  goss, dart and rf boosting with bagging and by-tree feature_fraction;
  every objective and metric, ranking's included; the fused split
  epilogue, the classic split path, f32, f64 (``gpu_use_dp``) and
  quantized-gradient histograms, linear leaves; training control:
  callbacks, early stopping, custom objectives with objective ``none``;
  prediction and the CLI; fault tolerance: checkpoints, ``check_numerics``,
  ``histogram_pool_size``, the OOM ladder and the single-process faults)
  raises
  NotImplementedError when set to a non-default value, naming the ROADMAP
  item that brings it (``_check_slice``). Nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from .utils import log

# Alias -> canonical name (reference: src/io/config_auto.cpp:12-168).
PARAM_ALIASES: Dict[str, str] = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective", "app": "objective", "application": "objective",
    "boosting_type": "boosting", "boost": "boosting",
    "linear_trees": "linear_tree",
    "train": "data", "train_data": "data", "train_data_file": "data", "data_filename": "data",
    "test": "valid", "valid_data": "valid", "valid_data_file": "valid",
    "test_data": "valid", "test_data_file": "valid", "valid_filenames": "valid",
    "num_iteration": "num_iterations", "n_iter": "num_iterations",
    "num_tree": "num_iterations", "num_trees": "num_iterations",
    "num_round": "num_iterations", "num_rounds": "num_iterations",
    "num_boost_round": "num_iterations", "n_estimators": "num_iterations",
    "shrinkage_rate": "learning_rate", "eta": "learning_rate",
    "num_leaf": "num_leaves", "max_leaves": "num_leaves", "max_leaf": "num_leaves",
    "tree": "tree_learner", "tree_type": "tree_learner", "tree_learner_type": "tree_learner",
    "num_thread": "num_threads", "nthread": "num_threads", "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed", "random_state": "seed",
    "hist_pool_size": "histogram_pool_size",
    "min_data_per_leaf": "min_data_in_leaf", "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf", "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction", "subsample": "bagging_fraction", "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction", "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction", "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction", "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode", "colsample_bynode": "feature_fraction_bynode",
    "extra_tree": "extra_trees",
    "early_stopping_rounds": "early_stopping_round", "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step", "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2", "lambda": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints", "monotone_constraint": "monotone_constraints",
    "monotone_constraining_method": "monotone_constraints_method",
    "mc_method": "monotone_constraints_method",
    "monotone_splits_penalty": "monotone_penalty", "ms_penalty": "monotone_penalty",
    "mc_penalty": "monotone_penalty",
    "feature_contrib": "feature_contri", "fc": "feature_contri", "fp": "feature_contri",
    "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename", "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename", "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "model_input": "input_model", "model_in": "input_model",
    "model_output": "output_model", "model_out": "output_model",
    "save_period": "snapshot_freq",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "data_seed": "data_random_seed",
    "is_sparse": "is_enable_sparse", "enable_sparse": "is_enable_sparse", "sparse": "is_enable_sparse",
    "is_enable_bundle": "enable_bundle", "bundle": "enable_bundle",
    "is_pre_partition": "pre_partition",
    "two_round_loading": "two_round", "use_two_round_loading": "two_round",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column", "group_id": "group_column", "query_column": "group_column",
    "query": "group_column", "query_id": "group_column",
    "ignore_feature": "ignore_column", "blacklist": "ignore_column",
    "cat_feature": "categorical_feature", "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "is_save_binary": "save_binary", "is_save_binary_file": "save_binary",
    "is_predict_raw_score": "predict_raw_score", "predict_rawscore": "predict_raw_score",
    "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index", "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib", "contrib": "predict_contrib",
    "predict_result": "output_result", "prediction_result": "output_result",
    "predict_name": "output_result", "prediction_name": "output_result",
    "pred_name": "output_result", "name_pred": "output_result",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance", "unbalanced_sets": "is_unbalance",
    "metrics": "metric", "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at", "ndcg_at": "eval_at", "map_eval_at": "eval_at", "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port", "port": "local_listen_port",
    "machine_list_file": "machine_list_filename", "machine_list": "machine_list_filename",
    "mlist": "machine_list_filename",
    "workers": "machines", "nodes": "machines",
    "checkpoint_dir": "checkpoint_path", "ckpt_dir": "checkpoint_path",
}

# Objective aliases (reference: src/objective/objective_function.cpp + config.cpp ParseObjectiveAlias)
_OBJECTIVE_ALIASES = {
    "regression_l2": "regression", "mean_squared_error": "regression", "mse": "regression",
    "l2": "regression", "l2_root": "regression", "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1", "mean_absolute_error": "regression_l1",
    "mae": "regression_l1", "l1": "regression_l1",
    "mean_absolute_percentage_error": "mape",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "cross_entropy", "xentlambda": "cross_entropy_lambda",
    "mean_squared_logarithmic_error": "regression",
}

_METRIC_ALIASES = {
    "l2_root": "rmse", "root_mean_squared_error": "rmse",
    "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2", "regression": "l2",
    "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "mean_absolute_percentage_error": "mape",
    "binary_logloss": "binary_logloss",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg", "xendcg": "ndcg",
    "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg", "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss", "ovr": "multi_logloss",
    "xentropy": "cross_entropy", "xentlambda": "cross_entropy_lambda",
    "kldiv": "kullback_leibler",
}


@dataclass
class Config:
    """All supported parameters, defaults matching the reference (config.h:34-1197)."""

    # Core (config.h:97-233)
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "cuda"  # reference default "cpu" (config.h:225); "cpu" = plain versions
    seed: Optional[int] = None
    deterministic: bool = False

    # Learning control (config.h:237-600)
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    linear_lambda: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1          # DART
    max_drop: int = 50              # DART
    skip_drop: float = 0.5          # DART
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2           # GOSS
    other_rate: float = 0.1         # GOSS
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20                 # voting parallel
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: List[List[int]] = field(default_factory=list)
    verbosity: int = 1
    snapshot_freq: int = -1
    linear_tree: bool = False
    # fail fast on NaN/Inf gradients/hessians/leaf outputs/score deltas,
    # naming the iteration and source before they poison the histograms.
    # On the fused one-dispatch path the checks run IN-PROGRAM as numerics
    # sentinels: a packed flag word (NaN/Inf bits per source) computed
    # inside the compiled step and judged lazily via non-blocking ready
    # checks (so the fetch never stalls the dispatch pipeline;
    # state-capture paths flush it first, so poisoned state is never
    # written) — the guard works WITH fused_iteration and quantized-grad
    # training (it no longer gates them off; the unfused path keeps the
    # host-side counting checks)
    check_numerics: bool = False

    # Checkpointing
    # directory for atomic training checkpoints ("" = <output_model>.ckpt
    # when snapshot_freq > 0 in the CLI); see lightgbm_tpu/checkpoint.py
    checkpoint_path: str = ""
    # how many recent checkpoints to retain (>= 2 keeps a fallback when the
    # newest is truncated/corrupt)
    checkpoint_keep: int = 2
    # sharded checkpoint layout for pre-partitioned datasets: every rank
    # writes its process-local score-cache shard (shard_rank{r}.pkl) plus a
    # rank-0 PARTITION.json row-partition manifest, enabling resume at a
    # DIFFERENT world size (re-partition-on-load) and supervisor gang
    # shrink; off falls back to the replicated rank-0-only layout (which
    # pre-partitioned multi-process runs cannot resume from)
    checkpoint_shards: bool = True

    # Distributed training supervision (see lightgbm_tpu/supervisor.py)
    # seconds between liveness heartbeats each rank sends to rank 0 over
    # the supervisor's TCP side-channel (<= 0 disables; only active in
    # multi-process runs with a heartbeat address configured)
    heartbeat_interval: float = 5.0
    # seconds one boosting step (or cross-process barrier) may take before
    # the watchdog declares the collective stalled and raises a
    # DistributedTimeoutError naming the suspect rank(s) and the last
    # completed iteration (0 disables the watchdog)
    collective_deadline: float = 0.0
    # how many times the gang supervisor relaunches a failed gang from the
    # latest valid checkpoint before giving up
    max_restarts: int = 2
    # per-rank restart budget: once the SAME rank has failed more than this
    # many times at the current world size (or its spawn itself fails), the
    # supervisor classifies it permanently lost and relaunches the gang at
    # world size n-1 (a gang SHRINK) instead of burning same-size restarts
    rank_restart_budget: int = 1
    # the smallest world size the supervisor may shrink a gang to; a loss
    # that would go below it exhausts the restart budget instead
    min_world_size: int = 1

    # Training integrity (see README "Training integrity")
    # every this many iterations, ranks exchange a cheap fingerprint of
    # the global model state (tree-structure hash + a score-cache checksum
    # over the rank's row range) over the coordination service and
    # majority-vote any mismatch: a minority rank whose state silently
    # diverged from the gang is named in a RankDivergenceError — or, under
    # supervision, exits with DIVERGENCE_EXIT_CODE so the supervisor
    # restarts it from the last valid checkpoint (and shrinks it away
    # after rank_restart_budget). 0 disables; no-op single-process
    integrity_check_period: int = 0
    # catch RESOURCE_EXHAUSTED during histogram compile/execute and step
    # down the documented degradation ladder (smaller histogram block ->
    # hist_method -> XLA scatter -> chunked predict buckets) instead of
    # killing the job; every degradation event lands in health_snapshot(),
    # the gauges and the checkpoint manifest's health section so an
    # operator can see the job is running degraded
    hist_oom_fallback: bool = True
    # flip ONE bit of rank r's train-score cache after 0-based iteration k
    # ("r:k"; config twin of LGBM_TPU_FAULT_FLIP_SCORE_RANK) — the silent
    # corruption the divergence check must attribute to exactly that rank
    fault_flip_score_rank: str = ""
    # poison one gradient value with NaN INSIDE the compiled program at
    # this 0-based iteration (the fused path's sentinels must catch it;
    # unlike fault_nan_grad_at_iter it does not unfuse the iteration)
    fault_nan_hist_at_iter: int = -1
    # raise a simulated RESOURCE_EXHAUSTED from the boosting step at this
    # 0-based iteration, fault_oom_count consecutive times — drives the
    # OOM degradation ladder one rung per raise
    fault_oom_at_iter: int = -1
    fault_oom_count: int = 1

    # Fault injection (testing)
    # hard-exit (like SIGKILL) at the start of this 0-based iteration;
    # see lightgbm_tpu/utils/faults.py
    fault_kill_at_iter: int = -1
    # sleep forever (interruptibly) at the start of this 0-based iteration
    # — the hung-rank shape the collective_deadline watchdog must catch
    fault_hang_at_iter: int = -1
    # hard-exit ONLY process rank r at 0-based iteration k ("r:k"; the
    # config twin of LGBM_TPU_FAULT_KILL_RANK_AT_ITER — unlike the env
    # form, the supervisor's one-shot fault stripping cannot disarm it)
    fault_kill_rank_at_iter: str = ""
    # hang ONLY process rank r at 0-based iteration k ("r:k")
    fault_hang_rank_at_iter: str = ""
    # hard-exit in the middle of the checkpoint write for this 0-based
    # iteration (after the payload files, before the manifest)
    fault_kill_in_ckpt_write: int = -1
    # hard-exit rank r mid-way through the SHARDED checkpoint write for
    # 0-based iteration k ("r:k": after its shard file, before the
    # shard-metadata exchange)
    fault_kill_in_shard_write: str = ""
    # flip bytes in rank r's shard file of every sharded checkpoint right
    # after publication (manifest intact: only checksums catch it)
    fault_corrupt_shard: int = -1
    # overwrite leading gradient values with NaN at this 0-based iteration
    fault_nan_grad_at_iter: int = -1
    # flip bytes in each checkpoint's model text right after it is written
    fault_corrupt_checkpoint: bool = False
    # sleep this many milliseconds inside EVERY predict dispatch (config
    # twin of LGBM_TPU_FAULT_SLOW_PREDICT_MS) — the slow-dispatch shape
    # the serving layer's deadlines and admission control must catch
    fault_slow_predict_ms: float = 0.0
    # raise a simulated RESOURCE_EXHAUSTED from the next N predict
    # dispatches, process-wide (twin of LGBM_TPU_FAULT_OOM_AT_PREDICT) —
    # drives the serve-side predict-chunk degradation rung
    fault_oom_at_predict: int = 0

    # IO / dataset (config.h:604-800)
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    # streaming chunked construction (binning.py FeatureSketch +
    # StreamingBinWriter, basic.py Dataset.from_chunks): rows per chunk
    # when slicing monolithic array input (0 = auto, ~1M-row chunks);
    # chunk sources keep their own chunk sizes
    construct_chunk_rows: int = 0
    # route Dataset.construct through the two-pass streaming path (sketch
    # pass -> device bin pass, host memory O(chunk)) even for monolithic
    # array input; chunk-source datasets always stream
    construct_streaming: bool = False
    # per-feature distinct-value budget of the mergeable construct sketch;
    # 0 = exact (unbounded). Past it the sketch compacts to equal-mass
    # representatives (rank error ~compactions/sketch_max_size)
    sketch_max_size: int = 65536
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: Union[str, List[int]] = ""
    forcedbins_filename: str = ""
    save_binary: bool = False
    precise_float_parser: bool = False

    # Predict (config.h:804-900)
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    output_result: str = "LightGBM_predict_result.txt"

    # Convert / model files
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"

    # Objective (config.h:904-970)
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9              # Huber / Quantile
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)

    # Metric (config.h:1000-1060)
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # Network / distributed (config.h:974-995). On TPU these select the device
    # mesh rather than a socket/MPI rank list (SURVEY.md §2.6 TPU-native note).
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # GPU analog: TPU controls
    gpu_use_dp: bool = False        # if True use float64-grade (compensated) histograms
    num_gpu: int = 1

    # TPU-specific (new; no reference analog)
    mesh_shape: Optional[Dict[str, int]] = None     # e.g. {"data": 8}
    # "batched": all available splits per histogram round (fast, see
    # models/grower.py docstring); "exact": strict best-first like the
    # reference's leaf-wise order (one histogram round per split).
    tree_growth_mode: str = "batched"
    histogram_method: str = "auto"                  # auto|scatter|binloop|onehot|onehot_hilo|onehot_q8|pallas|pallas_hilo|pallas_q8
    # quantized-gradient training (the XGBoost-GPU recipe, arXiv:1706.08359
    # §5; LightGBM 4.x quantized training re-designed for the MXU):
    # grad/hess quantize to int8 with stochastic rounding, histograms
    # accumulate EXACTLY in int32 on the int8 MXU path (~2x the bf16 rate),
    # and rescale to f32 once per tile at split-gain time. Maps
    # histogram_method onto its q8 twin (pallas_q8 on TPU, onehot_q8
    # elsewhere); excluded with gpu_use_dp
    quantized_grad: bool = False
    tile_leaves: int = 0                            # hist tile width (0 = auto: 42)
    hist_block: int = 0                             # hist row-block size (0 = auto per method)
    # measured Pallas kernel tuning on TPU (ops/pallas_hist.py
    # autotune_hist): times the candidate row-block sizes once per shape
    # bucket (keyed like the predict engine's compile cache) and picks the
    # leaf batch structurally (the widest tile in the 128-lane group);
    # explicit tile_leaves/hist_block values always win. Serial learner
    # only — the parallel learners keep the static defaults (a measured
    # winner is wall-clock-dependent and the method/block are static SPMD
    # program parameters that must match across shards)
    hist_autotune: bool = True
    # fused split-finding epilogue + level-batched frontier growth
    # (ops/pallas_hist.py epilogue kernels, models/grower.py
    # tile_pass_fused): the split-gain scan + per-feature argmax run in
    # the histogram pass itself — in kernel on the Pallas methods — and
    # sibling pairs share one frontier launch with the larger child's
    # plane derived in-pass (parent - smaller), so the split phase
    # consumes a tiny [L, F] candidate table instead of re-reading the
    # [L, F, B, 3] planes. "auto" (default) enables it whenever the
    # numerical non-bundled search is the whole story — serial learner,
    # no categorical features, no EFB bundles, no forced splits, no CEGB,
    # no extra_trees/bynode sampling, basic-or-off monotone constraints,
    # f32 histograms — and falls back to the classic split phase
    # otherwise (those semantics stay in ops/split.py find_best_splits).
    # "on" asserts instead of falling back; "off" forces the classic
    # phase (the reference side of the fusion bit-parity suite). Model
    # text is bit-identical to the classic path on representable sums
    # (tier-1-asserted), structure-identical within documented f32
    # bounds otherwise.
    split_fusion: str = "auto"
    # run the Pallas histogram kernels through the Pallas INTERPRETER on
    # non-TPU backends (tests/CI): the production TPU pipeline — fused
    # leaf channels, in-kernel row gather, q8 — becomes CPU-testable;
    # never set in production (the interpreter is orders of magnitude
    # slower than the XLA fallbacks)
    hist_pallas_interpret: bool = False
    # histogram subtraction trick (serial_tree_learner.cpp:311-320): build
    # only the smaller sibling and derive the larger as parent - smaller
    hist_subtraction: bool = True
    # leaf-partitioned row compaction (the DataPartition analog,
    # data_partition.hpp:21-60): gather only the pending leaves' rows into
    # a padded buffer before each histogram tile pass, sized by the first
    # ladder rung that fits (fractions of the histogram row count; the
    # full-size pass remains the fallback). Serial learner only.
    hist_compaction: bool = True
    hist_compaction_ladder: List[float] = field(
        default_factory=lambda: [0.5, 0.125])
    # run gradients -> tree growth -> score update as ONE jitted program
    # per boosting iteration whenever the configuration allows it (see
    # models/gbdt.py _fused_ok for the gate and its remaining exclusions).
    # false forces the phase-by-phase path — a debugging escape hatch and
    # the reference side of the fused-vs-unfused bit-parity test suite.
    fused_iteration: bool = True
    # grow this many boosting iterations per compiled-program dispatch: a
    # lax.scan over iterations INSIDE the fused program (the scan body is
    # the fused step re-keyed by the scanned iteration index), emitting K
    # stacked iterations' trees per dispatch and carrying the score cache
    # in-program — bit-identical to K separate fused iterations (the
    # carry add uses the pre-shrunk-tree gather form so nothing can
    # FMA-contract). Amortizes both the per-iteration dispatch round trip
    # and — the big one — the first-iteration XLA compile wall across K
    # trees. Only engine.train drives block consumption (manual
    # Booster.update loops keep one-iteration semantics); evaluation,
    # callbacks and early stopping run at block boundaries, and a
    # checkpoint callback period must be a multiple of K (rejected
    # otherwise). Configurations the fused gate excludes fall back to 1.
    boost_rounds_per_dispatch: int = 1
    # persistent XLA compilation cache directory ("" = disabled unless
    # JAX_COMPILATION_CACHE_DIR is already set): compiled programs are
    # keyed by (HLO, backend, flags) and written to disk, so a restarted
    # supervisor incarnation, a resumed elastic gang, or a second
    # same-shape process pays each compile ONCE EVER instead of once per
    # process — the 232s first-iteration wall at 10.5M rows becomes a
    # cache deserialization on every later start
    compile_cache_dir: str = ""
    # AOT-warm the training programs (fused step + score add) at
    # checkpoint-restore time via jit(...).lower().compile(): with the
    # persistent cache above, a warm restart reaches its first iteration
    # with zero XLA recompiles; without it, the compile simply moves from
    # the first boosting step to restore time
    compile_warmup: bool = True

    # Inference engine (models/predict_engine.py; no reference analog)
    # row-padding floor of the predict compile cache: batch rows pad up to
    # power-of-two buckets >= this, so varying serving batch sizes reuse a
    # handful of compiled programs instead of recompiling per distinct N
    predict_bucket_min_rows: int = 1024
    # chunked streaming predict: inputs larger than this many rows run in
    # row chunks so the device never holds more than one chunk of the
    # feature matrix (0 = auto, ~4M-row chunks)
    predict_chunk_rows: int = 0
    # row-shard full-ensemble prediction over all visible devices via
    # shard_map (trees replicated, rows split; per-row accumulation order
    # is unchanged so results are bit-identical to single-device)
    predict_sharded: bool = False
    # ensemble accumulation precision: auto|float64|compensated|float32.
    # auto/float64 sums tree outputs in float64 on device IN TREE ORDER —
    # bit-identical to the host-f64 reference accumulation; compensated =
    # two-float (Kahan) f32 for backends without usable f64; float32 =
    # fastest, least precise
    predict_accum: str = "auto"

    # Serving front end (lightgbm_tpu/serving.py ServeFrontend)
    # how long the micro-batching dispatcher waits after the FIRST queued
    # request before flushing the coalesced batch (the latency the
    # batching may add to a lone request; a full batch flushes early)
    serve_flush_ms: float = 2.0
    # coalesced-batch row cap: a flush takes queued same-model requests in
    # arrival order up to this many rows (one oversized request still
    # dispatches alone — the engine chunks it internally)
    serve_max_batch_rows: int = 8192
    # admission-control cap on queued + in-flight rows: a request that
    # would push past it is SHED with a retriable ServeOverloadError
    # instead of growing the queue without bound (recorded in
    # health_snapshot() / the serve_shed_count gauge); one request larger
    # than the cap still admits on an idle frontend — it dispatches alone
    # and the engine chunks it internally
    serve_max_queue_rows: int = 65536
    # default per-request deadline in milliseconds (0 = none): a request
    # not answered in time raises a ServeTimeoutError naming the phase it
    # died in (queue-wait vs dispatch); per-request deadline_ms overrides
    serve_deadline_ms: float = 0.0
    # expose a Prometheus-style text metrics endpoint on the
    # ServeFrontend (GET /metrics renders telemetry.prometheus_text():
    # lightgbm_tpu_serve_p99_ms and friends from the latency ring, plus
    # the scopes/counters/dispatch/health planes) — started when the
    # first model registers
    serve_metrics: bool = False
    # TCP port for the /metrics endpoint (0 = an ephemeral port; read the
    # bound address from ServeFrontend.metrics_addr)
    serve_metrics_port: int = 0
    # bind host for the /metrics endpoint. Loopback by default — the
    # exposition has no auth, so exposing it is an explicit decision:
    # set "0.0.0.0" (or a specific interface) for the standard off-host
    # Prometheus scrape deployment
    serve_metrics_host: str = "127.0.0.1"

    # Telemetry (lightgbm_tpu/telemetry.py)
    # per-iteration flight recorder: a bounded in-memory ring of
    # structured records (phase wall-time deltas, dispatch/transfer
    # deltas, sentinel verdicts, OOM rungs, heartbeat ages) flushed to
    # JSONL atomically on watchdog fire / divergence verdict /
    # OOM-ladder exhaustion / training error / fault-harness kill — any
    # dead gang or failed TPU round leaves a self-describing
    # post-mortem. Reads only already-fetched host values (never forces
    # a device sync): recorder-on training keeps the fused path at 2
    # dispatches/iteration and within the <=2% overhead budget
    telemetry_flight_recorder: bool = True
    # how many per-iteration records the flight-recorder ring retains
    telemetry_ring_size: int = 256
    # sample device + host memory into every flight record (and the
    # hbm_bytes_in_use / hbm_peak_bytes / host_rss_bytes gauges): one
    # allocator query + one /proc read per iteration, zero dispatches.
    # Backends without Device.memory_stats() (CPU) record the HBM fields
    # as null — never an error
    telemetry_memory: bool = True
    # where flight-recorder JSONLs flush ("" = the supervisor's diag dir
    # when supervised, else <checkpoint_path>/telemetry, else a temp dir
    # created only when an event flush actually fires)
    telemetry_dir: str = ""
    # with a durable telemetry directory configured, also flush the ring
    # every this many iterations (a REAL SIGKILL cannot flush, so the
    # periodic flush bounds the post-mortem loss to one period; 0 = only
    # event-driven flushes)
    telemetry_flush_period: int = 64

    def __post_init__(self):
        if self.seed is not None:
            # seed derives the sub-seeds exactly like config.cpp:150-161
            self.data_random_seed = self.seed + 1
            self.bagging_seed = self.seed + 3
            self.drop_seed = self.seed + 4
            self.feature_fraction_seed = self.seed + 2
            self.extra_seed = self.seed + 6

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]] = None, **kwargs) -> "Config":
        params = dict(params or {})
        params.update(kwargs)
        resolved: Dict[str, Any] = {}
        fields = {f.name for f in dataclasses.fields(cls)}
        for key, value in params.items():
            canonical = PARAM_ALIASES.get(key, key)
            if canonical in resolved and key != canonical:
                continue  # explicit canonical name wins over alias (config.cpp KV2Map)
            if canonical not in fields:
                log.warning(f"Unknown parameter: {key}")
                continue
            resolved[canonical] = value
        cfg = cls()
        for key, value in resolved.items():
            setattr(cfg, key, _coerce(cfg, key, value))
        cfg.objective = _OBJECTIVE_ALIASES.get(cfg.objective, cfg.objective)
        cfg.metric = [_METRIC_ALIASES.get(m, m) for m in cfg.metric]
        cfg._check()
        return cfg

    def _check(self) -> None:
        _check_slice(self)
        # bounds checks mirroring config.h CHECK_ constraints
        if self.num_leaves < 2:
            log.fatal(f"num_leaves must be >= 2, got {self.num_leaves}")
        if not (1 < self.max_bin <= 65535):
            log.fatal(f"max_bin must be in (1, 65535], got {self.max_bin}")
        if not (0.0 < self.bagging_fraction <= 1.0):
            log.fatal("bagging_fraction should be in (0.0, 1.0]")
        if not (0.0 < self.feature_fraction <= 1.0):
            log.fatal("feature_fraction should be in (0.0, 1.0]")
        if self.objective in ("multiclass", "multiclassova") and self.num_class < 2:
            log.fatal("num_class must be >= 2 for multiclass objectives")
        if self.split_fusion not in ("auto", "on", "off"):
            log.fatal(f"split_fusion must be auto/on/off, "
                      f"got {self.split_fusion!r}")
        if self.device_type not in ("cuda", "gpu", "cpu"):
            log.fatal(f"device_type must be cuda or cpu, "
                      f"got {self.device_type!r}")
        log.set_verbosity(self.verbosity)

    def torch_device(self):
        """The explicit torch.device every tensor of a run lives on. A CUDA
        request on a machine without a CUDA device is an error, never a
        fall-back to the CPU."""
        import torch
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device_type={self.device_type!r} needs a CUDA device, but "
                "torch.cuda.is_available() is False on this machine (pass "
                "device_type='cpu' to run the plain PyTorch versions)")
        return torch.device("cuda", torch.cuda.current_device())

    def to_params(self) -> Dict[str, Any]:
        """Canonical parameter dict (analog of Config::ToString,
        config_auto.cpp). ``device_type`` is left out: where a model was
        trained is no parameter of the model, and leaving it out keeps the
        model text the same on the card and on the CPU."""
        out = {}
        for f in dataclasses.fields(self):
            if f.name == "device_type":
                continue
            v = getattr(self, f.name)
            if v != f.default and not isinstance(f.default, dataclasses._MISSING_TYPE):
                out[f.name] = v
        return out


# Parameters the port implements, at any value its checks accept. The rest
# of the table is accepted only at its default value (_check_slice).
_SLICE_PARAMS = frozenset({
    "task", "objective", "boosting", "num_iterations", "learning_rate",
    "num_leaves", "tree_learner", "num_threads", "device_type", "seed",
    "max_depth", "min_data_in_leaf",
    "min_sum_hessian_in_leaf", "lambda_l1", "lambda_l2", "max_delta_step",
    "min_gain_to_split", "path_smooth", "verbosity", "max_bin",
    "min_data_in_bin", "bin_construct_sample_cnt", "data_random_seed",
    "use_missing", "zero_as_missing", "feature_pre_filter",
    "is_enable_sparse", "enable_bundle", "num_class", "is_unbalance",
    "scale_pos_weight", "sigmoid", "boost_from_average", "metric",
    "metric_freq", "is_provide_training_metric", "histogram_method",
    "split_fusion", "hist_subtraction", "hist_compaction",
    "hist_compaction_ladder", "tile_leaves", "fused_iteration",
    "tree_growth_mode", "deterministic", "quantized_grad",
    # the precision modes: f64 histograms on the classic path, linear leaves
    "gpu_use_dp", "linear_tree", "linear_lambda",
    # boosting modes, row and column sampling, objective parameters
    "bagging_fraction", "pos_bagging_fraction", "neg_bagging_fraction",
    "bagging_freq", "feature_fraction", "top_rate", "other_rate",
    "drop_rate", "max_drop", "skip_drop", "xgboost_dart_mode",
    "uniform_drop", "reg_sqrt", "alpha", "fair_c", "poisson_max_delta_step",
    "tweedie_variance_power", "multi_error_top_k", "auc_mu_weights",
    # learning to rank
    "lambdarank_truncation_level", "lambdarank_norm", "label_gain",
    "eval_at",
    # categorical features (the classic split path)
    "categorical_feature", "max_cat_threshold", "cat_l2", "cat_smooth",
    "max_cat_to_onehot", "min_data_per_group",
    # split constraints and the randomised search
    "monotone_constraints", "monotone_constraints_method",
    "monotone_penalty", "interaction_constraints", "feature_contri",
    "extra_trees", "feature_fraction_bynode",
    # the data layer: forced bins and splits, per-feature bin counts, CEGB;
    # force_col_wise / force_row_wise are accepted and have no effect (the
    # JAX package reads them nowhere either)
    "forcedbins_filename", "max_bin_by_feature", "forcedsplits_filename",
    "cegb_tradeoff", "cegb_penalty_split", "cegb_penalty_feature_lazy",
    "cegb_penalty_feature_coupled", "force_col_wise", "force_row_wise",
    # training control: first_metric_only reaches early stopping through
    # train's params; refit_decay_rate and early_stopping_round are read by
    # no training entry point (the JAX package's CLI alone reads them)
    "first_metric_only", "refit_decay_rate", "early_stopping_round",
    # sub-seeds derived from ``seed`` in __post_init__
    "bagging_seed", "drop_seed", "feature_fraction_seed", "extra_seed",
    # prediction and the user surface: the CLI's data files (the parser is
    # always exact, so precise_float_parser has no effect, as in the JAX
    # package), the predict and convert tasks, and the engine's parameters
    # (predict_bucket_min_rows sizes the serve mode's smallest slot; the
    # ordinary path pads no rows)
    "data", "valid", "header", "label_column", "weight_column",
    "group_column", "ignore_column", "two_round", "save_binary",
    "precise_float_parser", "start_iteration_predict",
    "num_iteration_predict", "predict_raw_score", "predict_leaf_index",
    "predict_contrib", "predict_disable_shape_check", "pred_early_stop",
    "pred_early_stop_freq", "pred_early_stop_margin", "output_result",
    "convert_model_language", "convert_model", "input_model",
    "output_model", "predict_bucket_min_rows", "predict_chunk_rows",
    "predict_accum",
    # fault tolerance: checkpoints (snapshot_freq in the CLI), the numerics
    # guard, the memory-bounded pass under histogram_pool_size, the OOM
    # ladder's gate, and the single-process fault hooks (utils/faults.py)
    "snapshot_freq", "checkpoint_path", "checkpoint_keep", "check_numerics",
    "histogram_pool_size", "hist_oom_fallback",
    "fault_kill_at_iter", "fault_kill_in_ckpt_write",
    "fault_nan_grad_at_iter", "fault_nan_hist_at_iter",
    "fault_corrupt_checkpoint", "fault_oom_at_iter", "fault_oom_count",
    "fault_oom_at_predict",
    # the distributed learners and their network (distributed.py,
    # network.py, parallel/)
    "top_k", "num_machines", "machines", "local_listen_port", "time_out",
    "machine_list_filename", "pre_partition",
    # supervised, elastic distributed training: heartbeats and the
    # collective watchdog, the supervisor's budgets (read by
    # supervisor.train_supervised), sharded checkpoints, the integrity
    # vote and the multi-process faults
    "heartbeat_interval", "collective_deadline", "max_restarts",
    "rank_restart_budget", "min_world_size", "checkpoint_shards",
    "integrity_check_period", "fault_hang_at_iter",
    "fault_kill_rank_at_iter", "fault_hang_rank_at_iter",
    "fault_kill_in_shard_write", "fault_corrupt_shard",
    "fault_flip_score_rank",
    # the ops layer: the serving front end (serving.py), the flight
    # recorder and memory telemetry (telemetry.py), the slow-predict fault
    "serve_flush_ms", "serve_max_batch_rows", "serve_max_queue_rows",
    "serve_deadline_ms", "serve_metrics", "serve_metrics_port",
    "serve_metrics_host", "telemetry_flight_recorder", "telemetry_ring_size",
    "telemetry_memory", "telemetry_dir", "telemetry_flush_period",
    "fault_slow_predict_ms",
})

# ROADMAP.md "Queue 1" item that brings each group of parameters
_ROADMAP_ITEM = {}
for _names, _item in (
        (("hist_block", "hist_autotune"),
         "Queue 2 (autotune_hist becomes a Hopper sweep over rows per "
         "block)"),
        (("boost_rounds_per_dispatch", "compile_cache_dir",
          "compile_warmup"),
         "Queue 1 item 13 (dispatch)"),
        (("mesh_shape", "num_gpu", "construct_chunk_rows",
          "construct_streaming", "sketch_max_size", "predict_sharded"),
         "Queue 1 item 15 (distributed)"),
        (("hist_pallas_interpret",),
         "Queue 2 (the port runs no Pallas interpreter; its CPU path is the "
         "plain PyTorch version of each kernel)")):
    for _n in _names:
        _ROADMAP_ITEM[_n] = _item

_SLICE_OBJECTIVES = (
    "regression", "regression_l1", "huber", "fair", "poisson", "quantile",
    "mape", "gamma", "tweedie", "binary", "multiclass", "multiclassova",
    "cross_entropy", "cross_entropy_lambda", "lambdarank", "rank_xendcg",
    # no built-in objective: the gradients come from ``fobj``
    "none", "null", "custom", "na")
HIST_METHODS = ("auto", "pallas", "pallas_hilo", "pallas_q8")


def _not_in_slice(name: str, value, why: str = "") -> None:
    item = _ROADMAP_ITEM.get(name, "Queue 1")
    raise NotImplementedError(
        f"parameter {name}={value!r} is not ported to lightgbm_tpu_torch "
        f"yet{why}; it arrives with ROADMAP.md {item}")


def _check_slice(cfg: Config) -> None:
    """Reject, loudly, every setting the port does not implement."""
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in _SLICE_PARAMS:
            continue
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        if v != default:
            _not_in_slice(f.name, v)
    if cfg.objective not in _SLICE_OBJECTIVES:
        raise NotImplementedError(
            f"objective={cfg.objective!r} is not ported to lightgbm_tpu_torch "
            f"(the port has {', '.join(_SLICE_OBJECTIVES)}; a custom "
            f"objective is passed to train() as fobj with objective none)")
    if cfg.tree_learner not in ("serial", "data", "feature", "voting"):
        log.fatal(f"Unknown tree learner type {cfg.tree_learner}")
    if cfg.histogram_method not in HIST_METHODS:
        raise NotImplementedError(
            f"parameter histogram_method={cfg.histogram_method!r} has no "
            f"counterpart in lightgbm_tpu_torch: the port has one histogram "
            f"path, the Hopper kernels and their plain versions "
            f"({', '.join(HIST_METHODS)}; with quantized_grad their q8 "
            f"mode), and no XLA method to fall back to")
    if not 0 <= cfg.tile_leaves <= 42:
        log.fatal(f"tile_leaves must be in [0, 42] (42 slots of 3 stats fill "
                  f"the kernels' 128-lane tables), got {cfg.tile_leaves}")
    if cfg.tree_growth_mode not in ("batched", "exact"):
        log.fatal(f"tree_growth_mode must be batched or exact, "
                  f"got {cfg.tree_growth_mode!r}")


def _coerce(cfg: Config, key: str, value: Any) -> Any:
    """Coerce a string/user value to the field's declared type (Config::Set)."""
    current = getattr(cfg, key)
    ftype = type(current)
    if value is None:
        return current
    if key == "metric":
        if isinstance(value, str):
            value = [v.strip() for v in value.split(",") if v.strip() and v.strip() != "None"]
        elif isinstance(value, (list, tuple)):
            value = list(value)
        return value
    if key == "interaction_constraints":
        # string form "[0,1],[2,3]" (reference: config.cpp
        # Config::Str2FeatureVec interaction parsing)
        if isinstance(value, str):
            import re
            return [[int(x) for x in grp.split(",") if x.strip()]
                    for grp in re.findall(r"\[([^\]]*)\]", value)]
        return [list(map(int, grp)) for grp in value]
    if key in ("valid", "label_gain", "eval_at", "monotone_constraints", "feature_contri",
               "max_bin_by_feature", "auc_mu_weights", "cegb_penalty_feature_lazy",
               "cegb_penalty_feature_coupled", "hist_compaction_ladder"):
        if isinstance(value, str):
            parts = [v for v in value.split(",") if v]
            elem = float if key in ("label_gain", "feature_contri", "auc_mu_weights",
                                    "cegb_penalty_feature_lazy", "cegb_penalty_feature_coupled",
                                    "hist_compaction_ladder") else (
                str if key == "valid" else int)
            return [elem(v) for v in parts]
        return list(value)
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes", "+")
        return bool(value)
    if isinstance(current, int) or (current is None and key == "seed"):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value


def parse_config_file(path: str) -> Dict[str, str]:
    """Parse a CLI ``key = value`` config file (reference:
    application.cpp:52-85, Config::KV2Map). Text after '#' is a comment."""
    params: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            params[key.strip()] = value.strip()
    return params
