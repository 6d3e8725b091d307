"""Build and drive the PyTorch/CUDA port on one NVIDIA GPU, and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed 0] [--rows 2000000] [--valid-rows 200000]
                          [--rounds 5] [--parent DIR]
                          [--only precision|control|predict|faults|
                                  distributed|resilience|redesign|serve]

Phases, each printing one JSON line (any failure raises and the script
exits non-zero; nothing is caught). The full run times the kernel phases
first, with the card to itself: device, build, hist_tile_root through
hist_tile_q8, split_epilogue, hist_wide, epilogue_wide and hist_variants.
Then it starts three lanes (LANES), processes of this script that run
beside it: ``gangs`` (the distributed group, the resilience group,
training control, the serve group), ``predict`` (prediction and the user surface, then the
faults group) and ``constraints`` (learning to rank, then the split
constraints). The main process goes on with train through parity_q8_cat,
the boosting modes, the data layer's training and parity phases and the
precision modes; then it relays each lane's lines (``at_s`` from the main
process's start) and prints the kernels line. Control and the
constraints wait for train's and train_q8's numbers. Below, each group's
phases in the order they run:

  device          nvidia-smi's name and power limit, torch's device name
  build           nvcc of every kernel source in lightgbm_tpu_torch/csrc/
  hist_tile_root  the root pass, the one full pass a tree takes (a 42-slot
                  tile whose slot 0 computes leaf 0, every row in it) of
                  both paths and modes: F=28 (fused) and F=8 (plane-only),
                  f32 and q8, each on uniform random bins and on the train
                  phases' own bins (the Higgs- and Expo-shaped rows binned
                  by the package's Dataset); checks and times as hist_tile
                  and hist_tile_q8
  hist_tile       full-row form of several computed slots at the train
                  phase's shapes (N=--rows, F=28, B=255, 255 leaves, a
                  42-slot tile of 21 computed leaves holding 3/4 of the
                  rows): bitwise vs the plain version on integer-valued
                  stats, within 1e-5 of the summed magnitudes on float stats,
                  bitwise equal to hist_tile_exact (its own fixed-point
                  arithmetic in plain torch) and to a second launch on float
                  stats (deterministic); kernel / plain / index_add_ times
                  and the bound
  hist_tile_gather the gather form over the trainer's two compaction rungs
                  (N/2 and N/8 rounded up to 64 rows), 9/10 of each rung
                  real rows; the f32 phases pass the stats' max|stat| as
                  the grower does (``ms``) and also time the launch that
                  computes it (``ms_computing_amax``)
  hist_tile_stress the gather form at the N/2 rung on three stress inputs,
                  f32 and q8: a rung of 1% real rows, one slot with 90% of
                  the tile's rows, 80% of the bins 0; checks and times as
                  hist_tile
  split_epilogue  P=42, F=28, B=255 with derived slots: bitwise vs plain
                  and vs a second launch; device ms a launch over 50
                  launches in one profile, each after an L2 flush (one
                  alone can leave no device activity in the profiler's
                  trace); the bound counts the planes the kernel must
                  read (computed slots' tiles, derived slots' parents)
  train           lightgbm_tpu_torch.train, binary, 255 leaves, max_bin 255,
                  lr 0.1, on Higgs-shaped data made from --seed (2M train,
                  200k valid rows, 5 rounds; the fused split path):
                  sec/iter, valid AUC (> 0.6), rows read per tree (and
                  of them the tile's rows, rows_real_per_tree) and each
                  kernel's launches on this run (both hist_tile forms and
                  split_epilogue must launch, at the shapes the kernel
                  phases checked)
  parity          the same training at 50,000 x 28, 63 leaves, 1 round on
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
  parity_cat,     the classic path at 50,000 rows, 1 round, card vs CPU:
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
                  and vs a second launch, device ms as split_epilogue
  train_q8        train's run with quantized_grad=True: sec/iter, valid AUC
                  (> 0.6 and >= train's - 0.01, the JAX package's q8
                  quality bar), q8 launches of every fused-path form and
                  none of the f32 forms
  train_q8_cat    train_cat's run with quantized_grad=True: AUC as above
                  against train_cat, plane-only q8 launches only
  parity_q8,      50,000 rows, 1 round, numerical and Expo-shaped, card
  parity_q8_cat   vs CPU plain path: the model text bitwise equal (exact
                  int32 sums, the same quantization arithmetic), and two
                  card runs identical

The boosting modes, on the kernels above (counted from 0 around each run):

  train_multiclass, multiclass on Covertype-shaped data (its 581,012 rows
  train_q8_multiclass  to train on, 54 columns, 40 of them
                  >= 90%-zero one-hot columns stored as sparse streams, so
                  the classic path; 7 classes, 5 rounds = 35 trees), f32
                  and q8: sec/iter, valid multi_logloss and multi_error
                  (below the majority class's 0.512; q8 within 0.01 of
                  f32), the split path, plane-only launches only
  parity_multiclass  multiclass f32 and q8 at 50,000 rows, 1 round: two
                  card runs and the CPU run (kernel sums in f32) identical
  train_sampling  on train's rows, one Dataset, 5 rounds each: bagging
                  mask (0.8), subset (0.5; at most 0.55x the plain train
                  run's rows a tree, rungs of its k rows), pos/neg
                  fractions, feature_fraction 0.8, GOSS at lr 0.5 (samples
                  in >= 3 iterations), DART (drops trees in >= 1
                  iteration), RF: sec/iter, valid AUC
                  (> 0.6), rows a tree, the fused path's f32 launches
  parity_sampling six of those modes (GOSS also in q8; DART at drop_rate
                  0.3, so that a tree drops) at 50,000 rows, 3 rounds:
                  card twice and CPU, identical model text

Learning to rank (first in the ``constraints`` lane), at MS LTR width
(MSLR-WEB30K Fold 1's 2,270,296 training documents in 18,919 queries, the
longest 1,251, 136 dense features, labels 0-4 at its shares, made from
--seed; valid: 6,000 more queries):

  lambdarank_grads the pairwise lambda kernel (csrc/lambdarank.cu) at
                  train_rank's query layout and labels (scores N(0, 1)) and
                  at edge layouts (1-document queries, a query longer than
                  a block's threads, one longer than the kernel's partner
                  tile, all-tied scores, labels all 0, truncation 3 and
                  above n, no normalisation with sigmoid 2): bitwise its
                  plain version in the kernel's order
                  (lambdarank_grads_exact) and a second launch; within
                  1e-5 of the largest magnitude of the JAX-order plain
                  version (lambdarank_grads_plain, chunked on the card);
                  ms, device ms, plain ms and the bound (the admitted
                  pairs' operations, the documents' bytes)
  hist_tile_rank  hist_tile's root pass (train_rank's own bins and uniform
                  ones) and N/2 rung, f32 and q8, and split_epilogue f32
                  and q8, at F = 136, the widest a training path gives them
  train_rank      lambdarank, 255 leaves, max_bin 255, lr 0.1, eval_at 1, 3,
                  5, 10, --rounds rounds (the fused path): sec/iter, valid
                  NDCG@k (NDCG@10 above the random scores'), the kernels'
                  launches (lambdarank_grads once an iteration), peak device
                  memory against one [Q, M, M] tensor's bytes, the host ms of
                  the objective and of the NDCG evaluation, one profiled
                  iteration
  train_rank_xendcg the same with rank_xendcg (no kernel of its own; its
                  host gamma draw timed)
  parity_rank     lambdarank f32, q8, rank_xendcg, and lambdarank with
                  weights, an init_score and a custom label_gain, at 12,500
                  documents, 63 leaves, 1 round: two card runs and the CPU
                  run in the kernels' orders (kernel_sums_on_cpu) give the
                  same model text; against the CPU's JAX-order run, equal
                  text or the first differing tree and the leaf error
                  before it

The split constraints (after learning to rank in its lane; monotone,
interaction, feature_contri, extra_trees, by-node sampling), on train's
2M Higgs-shaped rows:

  epilogue_mono   split_epilogue's monotone mode at P=42, B=255, F = 28
                  (tiles of train's own bins) and F = 136 (train_rank's),
                  f32 and q8: bitwise its plain version and a second
                  launch; bounds tight enough to change winners, one slot
                  with leaf_min == leaf_max, one plane whose every
                  candidate breaks its direction, directions +1, -1 and
                  0; ms and device ms beside the unconstrained mode's on
                  the same inputs (in turns), the plain ms and the bound
  train_mono,     basic monotone constraints (+1 on three features, -1 on
  train_mono_q8   three), 255 leaves, --rounds rounds, the fused path:
                  sec/iter, valid AUC beside train's, the monotone
                  epilogue's launches (> 0) and the unconstrained one's
                  (0), one profiled iteration, and a monotonicity sweep
                  (1,000 valid rows x 60 points over each constrained
                  feature: 0 violations)
  train_mono_modes the intermediate and advanced modes (1 round, one
                  split a phase, the classic path): sec/iter, searches a
                  tree, AUC, the sweep, the host ms a phase of
                  intermediate_bounds and advanced_child_bounds, and
                  device busy against wall time over a 16-phase window
                  of one more iteration
  train_constraints interaction constraints of three groups (fused; no
                  tree path across groups), feature_contri with a 0 (the
                  feature never split on), extra_trees,
                  feature_fraction_bynode 0.5; 1 round each
  parity_constraints basic f32 and q8, intermediate, advanced,
                  monotone_penalty 2, interactions, feature_contri
                  (positive, and with a 0), extra_trees, bynode at 12,500
                  rows, 63 leaves, 1 round: two card runs and the CPU run
                  in the kernels' orders give the same text; against the
                  CPU's plain run, equal text or the first differing tree
                  (and its first differing node) and the leaf error
                  before it

The data layer (max_bin above 255 in the kernels' wide mode, int16 bins;
scipy-sparse input with EFB, forced bins, max_bin_by_feature, forced
splits, CEGB):

  hist_wide       hist_tile's wide mode at N=--rows, F=28, B=1023: the
                  root pass, the several-slot full form and both rungs
                  (fused path), the plane-only full form and the larger
                  rung (classic path), f32 and q8, with hist_phase's and
                  hist_q8_phase's checks and times; the root and the
                  larger rung at B=4095 (the cap's edge); the uint8 mode
                  at B=255 on rows drawn the same way; no uint8 launch
                  in the wide checks
  epilogue_wide   split_epilogue at P=42, F=28, B=255, 1023 and 4095, f32
                  and q8, unconstrained and monotone: bitwise its plain
                  version and a second launch, each mode's own counter;
                  ms, device ms a launch, plain ms, the bound
  train_wide,     train's rows at max_bin 1023, the fused path, --rounds
  train_wide_q8   rounds: sec/iter, device busy and idle share, valid AUC
                  within 0.01 of train's (q8: of train_wide's), launches of
                  the wide modes only
  train_wide_classic the same with split_fusion=off, f32 and q8, 3 rounds:
                  the plane-only wide forms
  train_efb       Allstate-shaped CSR (docs/Experiments.rst; 4,228 one-hot
                  and numerical columns, 30 nonzeros a row), rows cut from
                  13,184,290 to 2,000,000 for the host's construct time:
                  construct seconds, device columns after EFB (at most
                  200), the bins' device bytes against the unbundled
                  [4228, N] uint8, peak device memory, sec/iter, valid AUC
                  (> 0.6), and predict on a 20,000-row valid slice from the
                  raw sparse rows equal to the valid score cache
  train_forced_cegb train's rows, 3 rounds each: a forced-splits JSON three
                  levels deep (every tree starts with it), CEGB split +
                  coupled and CEGB lazy (features used against an
                  unpenalised run), max_bin_by_feature with a forced-bins
                  JSON (the JSON files written to a temporary directory)
  parity_data     wide fused f32, q8, classic, monotone f32 and q8, a
                  400-category feature at max_bin 511, EFB on CSR, CSR
                  unbundled, forced bins, max_bin_by_feature, forced
                  splits, CEGB split, coupled and lazy, at 12,500 rows, 63
                  leaves, 1 round: as parity_constraints

The precision modes (gpu_use_dp: the plane-only forms' f64 mode;
linear_tree):

  hist_plane_dp   the f64 mode at N=--rows: F=8 (train_cat's shapes, all
                  42 slots computed: the root pass, the several-slot full
                  form, both rungs), F=28 (the root pass on train's own
                  bins, the full form, both rungs) and the root pass at
                  B=1023: bitwise hist_tile_exact at float64 and a second
                  launch, rounded to float32 bitwise the f32 mode on the
                  same inputs, within 1e-11 of the summed magnitudes of a
                  torch float64 sum; ms and device ms beside the f32
                  mode's (in turns; at most 1.15x), plain ms, a float64
                  index_add_ as the library time, the bound (f64 planes)
  train_dp        gpu_use_dp on train's rows (binary, 255 leaves, --rounds
                  rounds; the classic path): sec/iter, one profiled
                  iteration, valid AUC within 0.01 of train's, f64
                  plane-only launches only
  train_linear    linear_tree (linear_lambda 0.01) on 2M + 200k regression
                  rows, train's 28 features with 3% NaNs in features 0-2, a
                  piecewise-linear target (--rounds rounds, 255 leaves; the
                  fused path): sec/iter with the host's leaf fits split
                  out, valid l2 below a plain run's on the same rows and
                  rounds, kernels 1, 2 and the epilogue launched, the
                  model text loaded back predicting 20,000 valid rows
                  bitwise as Booster.predict
  parity_dp,      gpu_use_dp on numerical, Expo-shaped categorical and
  parity_linear   sparse-column data; linear_tree as regression with NaNs
                  and as binary; 50,000 rows, 63 leaves, 2 rounds: as
                  parity_data

With ``--only precision`` the script runs device, build, train and these
phases alone (the full run runs them after parity_data, last in the
main process).

Training control (callbacks, early stopping, custom objectives and
metrics, init_model, rollback, refit, free_dataset, cv), on the fused
path's kernels; each run's launches of kernels 1, 2 and the epilogue are
counted from 0 around it and must be above 0:

  train_control   on train's 2M + 200k Higgs-shaped rows (binary, 255
                  leaves, max_bin 255): early stopping (binary_logloss,
                  early_stopping_rounds 2, record_evaluation) under
                  learning_rates 0.1 for 3 rounds and then 3.0, 8 rounds
                  at most: it must stop early, and the first
                  best_iteration trees equal a plain run's of that many
                  rounds block by block; fobj (numpy binary-logloss
                  gradients, --rounds rounds): valid AUC within 0.01 of
                  train's, the host ms an iteration of the score's trip
                  to the host, the numpy gradients and their trip back,
                  one profiled iteration; init_model (3 rounds, then 2
                  more from that Booster): the first 3 tree blocks
                  byte-identical, predictions within rtol 1e-5, atol 1e-7
                  of a 5-round run; rollback after 3 rounds and one
                  update(): tree counts 3, 2, 3, the rolled-back model
                  predicting as a 2-round run and its valid scores within
                  1e-5 of that run's; refit of the 3-round model on the
                  valid rows: its seconds, its text equal to a CPU
                  refit's; free_dataset: device memory back >= the bin
                  matrix's bytes, predict unchanged; cv (3 stratified
                  folds, 3 rounds, early stopping): each fold's seconds
                  with the host's row subset and the fold sets' construct
                  apart, the result keys, each fold's launches
  parity_control  early stopping under a rate schedule, fobj with feval,
                  init_model continued, 3 rounds -> rollback -> 1,
                  reset_parameter of lambda_l2 and bagging_fraction
                  mid-run, cv fold 0's booster; 50,000 rows, 63 leaves, at
                  most 3 rounds: two card runs and the CPU run in the
                  kernels' orders give the same text

With ``--only control`` the script runs device, build, train and these
phases alone, and prints their launches by path in place of the kernels
line (the full run runs them in the ``gangs`` lane, after the
resilience group).

and prediction and the user surface (first in the ``predict`` lane):

  predict_ensemble the ensemble traversal kernel alone: a 100-round,
                  255-leaf model trained on 500,000 of train's rows, over
                  the bins of the 2M train and 200k valid rows, in each
                  accumulation mode (float64, compensated, float32)
                  without and with per-tree biases and with an active mask
                  of half the rows, and in leaves mode: bitwise the plain
                  version on the same card tensors and a second launch;
                  ms (events), device ms, plain ms, bound (the bins, the
                  tables and the result over 3.35 TB/s, against the node
                  visits of this run's leaves x OPS_PER_VISIT over 67
                  T/s); then int16 bins (max_bin 1,023, 3 rounds), a
                  categorical Expo-shaped model (50,000 rows), the K = 7
                  Covertype-shaped model, random 1,023-leaf trees, the
                  200k rows inside 2,000 columns and 4,095-leaf trees on
                  EFB segments, each case checked in the geometry
                  launch_geometry gives its shape (tiled or global; only
                  the tiled 2M, 200k and int16 cases timed)
  predict         Booster.predict of that model on the 2M and the 200k raw
                  rows: seconds, split into the host's input checks,
                  binning on the card, the kernel, the conversion and the
                  fetch, and the kernel's launches a call; raw and
                  converted scores (20,000 rows), pred_leaf,
                  pred_early_stop (freq 10, margin 1.5) and a
                  start_iteration / num_iteration window (20,000 rows)
                  bitwise the same trees carried to a CPU booster
                  (convert.booster_to_numpy -> booster_from_numpy); a
                  K = 7 Covertype-shaped model (50,000 rows, 3 rounds)
                  the same; score_dataset of 20,000 valid rows, with the
                  trees' biases, bitwise the plain version on the CPU
  predict_contrib TreeSHAP of that model over 10,000 valid rows on the
                  card: seconds (host decisions, device DP), peak device
                  memory; within rtol 1e-9 / atol 1e-11 of the CPU's on
                  200 rows, each row summing to its raw score within
                  1e-6 / 1e-8, two runs on 2,000 rows the same bits
  cli             python -m lightgbm_tpu_torch task=train / predict /
                  convert_model on a 50,000-row CSV (header, a named label
                  column, a .weight side file): the model text equals
                  train on the same parsed arrays, the predictions file
                  Booster.predict, the C++ the CPU's text; the native
                  parser bitwise the plain parser on the file
  sklearn         LGBMRegressor fit and predict on the same rows: bitwise
                  train with the parameters it maps (and whether
                  scikit-learn was importable: without it the stand-ins
                  run)

With ``--only predict`` the script runs device, build, train and these
phases alone, and prints a kernels line of predict_ensemble alone.

then the faults group (after the predict group in its lane; fault
tolerance; no new kernel: its runs launch
kernels 1-4 and predict_ensemble, counted by path):

  train_resume    train's rows (2M + 200k valid, 28 features, 255 leaves),
                  5 rounds with bagging_fraction 0.8 / bagging_freq 2 /
                  feature_fraction 0.8 and a checkpoint every round: the
                  checkpoint saves' host seconds and bytes (state.pkl,
                  model.txt); a child process killed by
                  LGBM_TPU_FAULT_KILL_AT_ITER=3 (exit 137) and a second
                  child resumed from its checkpoints give the uninterrupted
                  run's model text and valid predictions bit for bit (the
                  resume's validate / load / restore seconds); in-process, a
                  writer killed inside the write of checkpoint 3
                  (fault_kill_in_ckpt_write, its hard exit replaced by an
                  exception) leaves ckpt_00000003.tmp, resume takes
                  checkpoint 2 and the next write removes the stale stage;
                  checkpoints corrupted as written (fault_corrupt_checkpoint)
                  fall back to the last clean one; each resumed to the same
                  text
  train_blocked   an Epsilon-shaped table (docs/GPU-Performance.rst: dense
                  binary, 2,000 float features; 100,000 + 25,000 valid rows
                  made from --seed), 255 leaves, 3 rounds: the blocked pass
                  under histogram_pool_size=256 (569 columns a block, 4
                  blocks), twice, against the resident run on the classic
                  path (split_fusion off) with hist_subtraction=False,
                  which launches kernels 3-4: the trees bit for bit, kernel 3
                  launched once a block a pass; sec/iter, peak device memory
                  (max_memory_allocated), the resident state's bytes, rows
                  streamed a tree and valid AUC of each; at 2,000 of the rows
                  (15 leaves, 2 rounds, 311 columns a block) the card's text
                  against the CPU's in the kernels' orders
  oom_ladder      at that parity size (15 leaves), fault_oom_at_iter=1 with
                  fault_oom_count=3 walks rungs 1, 2, 3 (the blocked pass at
                  a quarter of the resident state's bytes, at 16 columns, the
                  predict chunk) and the run completes; each rung's run
                  (degraded from iteration 0, one round) gives the trees of a
                  fresh run at its setting; then a child process capped
                  (torch.cuda.set_per_process_memory_fraction) below the
                  resident state of 50,000 Epsilon-shaped rows hits a real
                  torch.cuda.OutOfMemoryError, rung 1 engages and the run
                  ends with the trees of a fresh run at that width
  numerics        check_numerics with fault_nan_grad_at_iter=2 and with
                  fault_nan_hist_at_iter=2 on the parity rows: the JAX
                  package's message, naming iteration 2
  predict_oom     fault_oom_at_predict=2 at predict_chunk_rows 65,536 over
                  train_resume's 200k valid rows: the chunk halves twice, the
                  predictions stay bitwise the unchunked ones and
                  predict_ensemble launches once a chunk

With ``--only faults`` the script runs device, build, train and this group
alone, and prints its launches by path.

The distributed group (first in the ``gangs`` lane), the learners of
``tree_learner`` data, feature and voting in a gang of 2 ranks (each a
``--child dist`` process; on one card both ranks share it and the gang's
collectives go through host memory over gloo):

  hist_int_planes the integer-planes mode of kernels 3-4 at one rank's
                  rows of train's (N / 2, F = 28, B = 255, the exponent over
                  N), the root pass and a 42-slot tile: int64 planes bitwise
                  hist_tile_exact's integers and a second launch, the two
                  row halves' planes adding to the pass's, hist_convert
                  bitwise its plain version and one pass's float planes;
                  ms, device ms, plain ms, the bound (bytes) and one
                  index_add_ of int64 (the library call)
  train_serial_classic  train's rows on the classic path (split_fusion
                  off), 2 rounds: the AUC reference
  train_data_parallel, train_feature_parallel, train_voting_parallel
                  each learner on train's 2M + 200k Higgs-shaped rows at
                  255 leaves, 2 rounds, twice, every rank holding all rows:
                  the backend, sec/iter, device busy an iteration (one
                  profiled iteration per rank), the collectives' seconds,
                  bytes and calls an iteration, valid AUC within 0.01 of
                  the serial classic run's; the two runs' texts equal, the
                  ranks' equal, every rank launched kernels 3-4 (the data
                  learner their integer-planes mode and hist_convert), and
                  whether the trees equal the serial classic run's (else
                  the first line that differs)
  parity_distributed  each learner at 50,000 rows and 63 leaves, 2 rounds:
                  the card gang's text equals the same gang's CPU run inside
                  kernel_sums_on_cpu()
  train_data_parallel_nccl  with two or more cards, the data learner on a
                  gang of 2 over NCCL, a card a rank: its text the gloo
                  gang's; with one card, the reason it did not run

With ``--only distributed`` the script runs device, build and this group
alone, and prints its kernel entries and launches by path.

and the resilience group (supervised, elastic distributed training;
lightgbm_tpu_torch.supervisor gangs of 2 processes sharing card 0 over
gloo, the data learner over pre-partitioned rows, 1M of train's rows a
rank, 255 leaves, 4 rounds, a sharded checkpoint every iteration,
collective_deadline 10 s, heartbeats every 1 s, the integrity vote every
iteration; every run prints its restarts, exit codes, seconds to detect,
to tear down and to relaunch up to the first resumed iteration, the
sharded checkpoint's and the vote's host times, and rank 0's launches of
hist_tile's integer-planes mode and of hist_convert):

  resilience_reference  the uninterrupted gang: the text the next two
                  are held to, its valid AUC
  resilience_kill rank 1 killed at iteration 2: one relaunch, bitwise; the
                  report's post-mortem (the supervisor's analysis of the
                  flushed flight recorders and exit codes) says kill,
                  rank 1, iteration 2
  resilience_hang rank 1 hung at iteration 2: the watchdog's exit names
                  rank 1 within the deadline plus 2 s; one relaunch,
                  bitwise; the post-mortem says hang, rank 1, iteration 1
                  (the last completed: the hang comes before iteration
                  2's step)
  resilience_shrink  relaunched from the reference's sharded checkpoint
                  of iteration 2, rank 1's spawn fails: the gang shrinks
                  to 1 and resumes from the two shards (the same bits
                  again in this process); its valid AUC against the gang
                  of 2's and the first difference recorded (the gang of 1
                  bins from its own sample)
  resilience_parity  at 50,000 rows and 63 leaves, in this process: 2
                  iterations by a gang of 2 thread-ranks, then a gang of 1
                  resuming from its shards, twice on the card and once on
                  the CPU inside kernel_sums_on_cpu(), the three texts
                  equal, the bins and valid AUC (within 1e-4) the gang of
                  2's; a supervised gang over replicated rows with rank
                  1's score cache flipped after iteration 2 (no majority
                  at world 2: both ranks raise, one relaunch) bitwise the
                  same gang uninterrupted

The serve group (last in the ``gangs`` lane; the ops layer: the engine's
serve mode, ServeFrontend, telemetry; no new kernel: predict_ensemble
serves, kernels 1-4 train), over the predict group's model (trained again
in the lane):

  serve_kernel    predict_ensemble at 1, 64, 1,024 and 8,192 rows x 100
                  trees: every mode bitwise its plain version and a second
                  launch (ensemble_case); ms (events), device ms
                  (profiler, cold L2; 20 launches a profile below 1,024
                  rows), plain ms and the bound as the 2M-row case's
  serve_steady    200 flushes of 1-8,192 rows (log-uniform) through serve
                  mode (raw scores): after each bucket's first flush the
                  caching allocator takes no request, every slot buffer
                  keeps its address, one launch a flush, the answers
                  bitwise Booster.predict outside serve mode; host ms a
                  flush, and with profiling on the split into copy in,
                  binning, kernel and fetch
  serve           a ServeFrontend with the default policy, 16 client
                  threads in closed loops of 1-256 rows for 10 s:
                  requests/s, rows/s, p50 / p99 ms, batches, rows a
                  batch; every answer bitwise Booster.predict of its rows,
                  one launch a batch
  serve_control   overload (serve_max_queue_rows 64 behind a slow
                  dispatch: ServeOverloadErrors, one serve_shed episode in
                  health_snapshot()), the dispatch and queue-wait
                  deadlines, a hot swap under traffic to a same-shape
                  model of other rows (the old bits before it, the new
                  after), a rejected swap to 3 classes (the old model
                  serves on), the serve OOM (the chunk halves, the bits
                  stay), a GET /metrics whose serve p99 is stats()'s
  telemetry       train's rows (2M + 200k, 255 leaves, --rounds) with
                  profiling on and the dispatch hook, the flight recorder
                  off and on: the texts bitwise, launches and the hook's
                  counts each iteration equal, one valid flight record an
                  iteration with torch.cuda's memory, the five largest
                  scopes; a trace_window of 2 more iterations naming the
                  hist_tile and split_epilogue kernels and the scopes

With ``--only serve`` the script runs device, build and this group alone,
and prints predict_ensemble's entry with its serve sizes.

With ``--only resilience`` the script runs device, build,
hist_int_planes and this group alone, and prints the two integer-planes
kernel entries with the group's launches by path.

With ``--only redesign`` the script runs device, build, train,
epilogue_wide, train_wide, train_wide_q8 and parity_data's four wide runs
on the card (parity_data_wide: f32, q8, monotone, monotone q8; each
text's sha256 and launches), and with ``--parent DIR`` the wide
epilogue's probes on DIR's package and on this one (parent, this, this,
parent) around them: B = 1023 and 4095, f32 and q8, unconstrained and
monotone, each event ms, device ms a launch on a cold L2 and the sha256
of both outputs, which must be the same in every probe; DIR's package
also trains the four wide runs, whose texts must equal this run's. It
prints the wide epilogue's four entries (``probes`` in each).

and kernel 5, the experiment script's one-hot histogram (after
epilogue_wide, before the lanes start):

  hist_variants   python -m lightgbm_tpu_torch.scripts.exp_hist_variants at
                  its defaults (2M rows, 28 features, 255 bins, variants
                  2x2048, 4x2048, 4x1024, 7x1024; a failed variant fails
                  the entry point): each variant within 1e-5 of each
                  cell's summed magnitudes of hist_onehot_plain and
                  bitwise equal to a second launch; kernel (events and
                  device ms) / plain / materialized one-hot
                  cuBLAS matmul (the library stand-in) times, the bound
                  (the function's least bytes and f32 adds) and, apart,
                  the one-hot form's tensor-core floor

Each hist_tile form is timed twice: ``ms``, CUDA events around the call
(host gaps between its launches included), and ``device_ms``, the summed
device time of what it launched (torch.profiler). With ``--parent DIR``
(another checkout, e.g. the parent commit unpacked by ``git archive``) a
subprocess runs this script's hist_tile phases, and the split epilogue's
and kernel 5's probes (``redesign_probes``), on DIR's package, same
inputs and checks, before the first phase and after the last
(``parent_times``); the ``kernels`` line carries those times as
``parent_ms``: two designs timed in one run; the wide epilogue's probes
run on both packages, parent, this, this, parent (``probes`` in its
entries, outputs bitwise the same); the probe also trains the parity
phases' models and parity_data's four wide runs once on the card with
DIR's package, and each of parity, parity_sparse, parity_q8,
parity_q8_cat and the wide runs must give the same model text (sha256).
The epilogue entries also
carry their device ms a launch in the train phases' own profiles
(``train_device_ms_per_launch``).

The ``kernels`` line gives each hist_tile entry the root pass on the train
phase's own bins as its ``ms`` / ``plain_ms`` / ``bound_ms`` /
``library_ms`` (the full pass the main path launches), with the root on
uniform bins (``root_uniform``) and the several-slot probe
(``multi_slot``) beside it.

Then a ``kernels`` line (each kernel's ``launches`` on its main path's
run, and ``launches_by_path``: its launches in every train phase and
sampling run that launched it), nvidia-smi's ``name, power.limit`` line,
and last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result. Times come from CUDA events (median of >= 10 launches
after warm-up, the L2 cache flushed before each); bounds use the H100 SXM
data-sheet peaks (3.35 TB/s, 67 TFLOP/s float32), whatever the card's power
limit.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import itertools
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


_T0 = time.time()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line; ``at_s``: the script's seconds so far."""
    print(json.dumps({"phase": phase, **kw, "at_s": time.time() - _T0}),
          flush=True)


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


def _device_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0))


def _short(name: str) -> str:
    """A kernel's name without its namespace and signature."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:60]


def device_ms(fn, reps: int = 5, per_profile: int = 1, need: str = None,
              cold_each: bool = False):
    """Median device time of ``fn`` over ``reps`` calls, each alone on a
    cold L2: the summed durations of the kernels, copies and fills it puts
    on the card (torch.profiler, CUDA activity), without the host's time
    between its launches that time_ms's events also hold. Returns (ms,
    {kernel: ms} of the median call) over the calls whose trace holds
    device time, or ("not measured", {}) when none does (the profiler
    dropped the device activity; when no call of the first ``reps`` holds
    any, ``reps`` more are profiled). ``per_profile`` > 1 (for a call of a
    few microseconds, whose lone activity the profiler can drop): each of
    the ``reps`` profiles holds that many calls back to back after one L2
    flush, and its device time is divided by the launches of ``need``
    the trace recorded (by the calls made without ``need``). ``need``: a
    profile counts only if it holds a kernel of that name (the profiler
    can drop one kernel's activity and keep another's). ``cold_each``
    (with ``need``): an L2 flush precedes each of the ``per_profile`` calls,
    and only the kernels of ``need`` are summed, the flushes left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    runs = []
    for attempt in range(2 * reps):
        if attempt == reps and runs:
            break
        flush_l2()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the trace can miss the window's first kernel: a marker kernel
            # goes first, and is left out of the sums
            torch.cuda._sleep(1000)
            for _ in range(per_profile):
                if cold_each:
                    flush_l2()
                fn()
            torch.cuda.synchronize()
        split, calls = {}, 0
        for ev in prof.key_averages():
            if _device_us(ev) > 0 and "spin_kernel" not in ev.key and not (
                    cold_each and need not in ev.key):
                key = _short(ev.key)
                split[key] = split.get(key, 0.0) + _device_us(ev) / 1e3
                if need and need in ev.key:
                    calls = max(calls, ev.count)
        if split and (need is None or calls):
            # a call's share: over the recorded launches of ``need`` (one a
            # call), else over the calls made
            per = calls if need and per_profile > 1 else per_profile
            split = {k: v / per for k, v in split.items()}
            runs.append((sum(split.values()), split))
    if not runs:
        return "not measured", {}
    runs.sort(key=lambda r: r[0])
    return runs[len(runs) // 2]


def float_err(kernel: torch.Tensor, plain: torch.Tensor,
              magnitude: torch.Tensor, rtol: float = 1e-5,
              rows: torch.Tensor = None) -> float:
    """Max |kernel - plain|; fails unless every cell is within ``rtol`` of
    the sum of the magnitudes that cell accumulated (a float32 sum's error
    is bounded by the magnitudes, not by the possibly cancelling result).
    With ``rows`` (the rows each cell added) a cell's bound is the larger
    of ``rtol`` and the float32 plain sum's own error bound over that many
    terms, rows * 2^-24 (the root pass's cells add up to all N rows)."""
    diff = (kernel - plain).abs()
    if rows is not None:
        rtol = torch.clamp(rows * 2.0 ** -24, min=rtol)
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


def tile_selection(plane=False, root=False):
    """A tile as the grower hands it to hist_tile. Fused path: P slots, the
    computed smaller sibling of each pair in the even slot, the odd
    (derived) slot -1 -- 21 computed leaves out of LEAVES. Classic path
    (``plane``): all P slots computed. The root pass (``root``, both
    paths): slot 0 computes leaf 0, the other slots nothing."""
    if root:
        sel = torch.full((P,), -1, dtype=torch.int32)
        sel[0] = 0
        return sel
    if plane:
        return torch.arange(P, dtype=torch.int32) * (LEAVES // P)
    sel = torch.full((P,), -1, dtype=torch.int32)
    sel[0::2] = torch.arange(P // 2, dtype=torch.int32) * (LEAVES // (P // 2))
    return sel


def hist_inputs(n, f, seed, integer, tile_leaves, share, hot=0.0, skew=0.0,
                b=B):
    """Random rows over LEAVES leaves, ``share`` of them in the tile's
    computed leaves; ``hot`` of the tile's rows in its first leaf, and
    ``skew`` of all bins 0 (the rest uniform over ``b`` bins: uint8, or
    int16 past 256 bins, the wide mode)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    binsT = torch.randint(0, b, (f, n), generator=g, device="cuda",
                          dtype=torch.int32).to(
        torch.uint8 if b <= 256 else torch.int16)
    if skew:
        binsT[torch.rand((f, n), generator=g, device="cuda") < skew] = 0
    others = torch.ones(LEAVES, dtype=torch.bool)
    others[tile_leaves.long()] = False
    others = torch.nonzero(others).reshape(-1).to(torch.int32).cuda()
    in_tile = torch.rand(n, generator=g, device="cuda") < share
    pick_t = torch.randint(0, tile_leaves.shape[0], (n,), generator=g,
                           device="cuda")
    if hot:
        pick_t[torch.rand(n, generator=g, device="cuda") < hot] = 0
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


def library_ms(binsT, leaf, stats, sel, in_tile, f, b, acc_dtype):
    """The time of one PyTorch call computing a tile pass's function: an
    ``index_add_`` in ``acc_dtype`` over the tile rows' flattened (slot,
    feature, bin) cells."""
    tile_leaves = sel[sel >= 0]
    r = torch.nonzero(in_tile).reshape(-1)
    slot_of_leaf = torch.full((LEAVES,), -1, dtype=torch.long, device="cuda")
    slot_of_leaf[tile_leaves.long().cuda()] = \
        torch.nonzero(sel >= 0).reshape(-1).cuda()
    s = slot_of_leaf[leaf[r].long()]
    flat = ((s[:, None] * f + torch.arange(f, device="cuda")[None, :]) * b
            + binsT[:, r].T.long()).reshape(-1)
    contrib = stats[r].to(acc_dtype)[:, None, :].expand(
        r.shape[0], f, 3).reshape(-1, 3)
    acc = torch.zeros((P * f * b, 3), dtype=acc_dtype, device="cuda")
    return time_ms(lambda: acc.index_add_(0, flat, contrib))


def hist_phase(cuda_hist, n, m=None, seed=0, f=F, plane=False, real=0.9,
               hot=0.0, skew=0.0, root=False, bins=None, b=B):
    """Kernel vs plain on integer-valued and float stats at the shapes of
    one main-path pass: the full form (``m`` None; 3/4 of the rows in the
    tile's computed slots) or the gather form over a rung of ``m`` rows
    holding the tile's rows (``real`` of the rung) in row order, padded
    with N, as the grower builds it; ``hot`` and ``skew`` as hist_inputs.
    ``root``: the root pass, the full pass the trainer takes (one computed
    slot, every row in it); ``bins``: [f, n] bins on the card to use for
    the random ones (the train phases' own data, real_bins). ``plane``:
    the classic path's plane-only launch (all slots computed). The kernel
    takes the stats' max|stat| from its caller, as the grower passes it
    once a tree; a launch that computes it itself and a second launch
    must give the same bits. ``ms_computing_amax`` times the launch
    without it. The kernel gets the slot table on the host, as the grower
    hands it over; the plain versions on the card."""
    from lightgbm_tpu_torch.ops.histogram import compact_indices
    sel = tile_selection(plane, root)
    tile_leaves = sel[sel >= 0]
    chan_h = cuda_hist.chan_leaf_table(sel)
    chan = chan_h.cuda()
    share = 1.0 if root else 0.75 if m is None else real * m / n
    out = {}
    for integer in (True, False):
        binsT, leaf, stats = hist_inputs(n, f, seed, integer, tile_leaves,
                                         share, hot, skew, b)
        binsT = binsT if bins is None else bins
        amax = stats.abs().amax(0)
        in_tile = torch.isin(leaf, tile_leaves.cuda())
        n_tile = int(in_tile.sum())
        idx = None
        if m is not None:
            if n_tile > m:
                raise AssertionError(f"{n_tile} tile rows overflow the "
                                     f"{m}-row rung")
            idx = compact_indices(in_tile, m)
        args = (binsT, leaf, stats, chan, P, b, LEAVES, idx)
        kargs = (binsT, leaf, stats, chan_h, P, b, LEAVES, idx)
        k = cuda_hist.hist_tile(*kargs, plane=plane, amax=amax)
        p = cuda_hist.hist_tile_plain(*args)
        torch.cuda.synchronize()
        if integer:
            if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
                raise AssertionError("hist_tile is not bitwise equal to its "
                                     "plain version on integer-valued stats")
            out["int_max_abs_err"] = float((k - p).abs().max())
            continue
        again = cuda_hist.hist_tile(*kargs, plane=plane)
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
        mag = cuda_hist.hist_tile_plain(binsT, leaf, stats.abs(), chan, P, b,
                                        LEAVES, idx)
        # a cell's rows: its count channel (1 a row); the root's cells add
        # up to N rows, where the float32 plain sum's error passes 1e-5
        out["max_abs_err"] = float_err(k, p, mag,
                                       rows=mag[..., 2:] if root else None)
        out["ms"] = time_ms(lambda: cuda_hist.hist_tile(*kargs, plane=plane,
                                                        amax=amax))
        out["device_ms"], out["device_split"] = device_ms(
            lambda: cuda_hist.hist_tile(*kargs, plane=plane, amax=amax))
        out["ms_computing_amax"] = time_ms(
            lambda: cuda_hist.hist_tile(*kargs, plane=plane))
        out["plain_ms"] = time_ms(lambda: cuda_hist.hist_tile_plain(*args),
                                  reps=10, warm=1)
        out["library_ms"] = library_ms(binsT, leaf, stats, sel, in_tile, f,
                                       b, torch.float32)
        # least traffic: the row-index buffer (gather form), the leaf id of
        # every row it names, the bins and stats of the tile's rows, the
        # planes written once; one add per (tile row, feature, stat)
        scanned = n if idx is None else n_tile
        nbytes = (0 if idx is None else 4 * m) + 4 * scanned \
            + n_tile * (f * binsT.element_size() + 12) + P * f * b * 3 * 4
        out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * n_tile * f)
        out["rows"], out["tile_rows"] = (n if m is None else m), n_tile
    return out


# the gather form's stress inputs at the main path's larger rung: 1% of the
# rung real rows (late passes walk big rungs for few rows), one slot with
# 90% of the tile's rows, and 80% of all bins in bin 0 (shared-memory
# atomic contention, as on real sparse-ish columns)
STRESS = {"sparse_rung": {"real": 0.01}, "hot_slot": {"hot": 0.9},
          "skew_bins": {"skew": 0.8}}


def stress_phase(cuda_hist, n):
    """Each stress input, f32 and q8, through hist_phase / hist_q8_phase
    at the 1,000,000-row rung of N rows: bitwise checks and times."""
    m = ladder_rungs(n)[1]
    return {"m": m,
            "f32": {k: hist_phase(cuda_hist, n, m=m, seed=31 + i, **kw)
                    for i, (k, kw) in enumerate(STRESS.items())},
            "q8": {k: hist_q8_phase(cuda_hist, n, m=m, seed=41 + i, **kw)
                   for i, (k, kw) in enumerate(STRESS.items())}}


_bins_cache = {}


def real_bins(n: int, valid_rows: int, seed: int):
    """The bins of the train phases' own data on the card: the first n of
    the Higgs-shaped rows of train_phase and of the Expo-shaped rows of
    train_cat_phase, binned by the package's Dataset as those phases bin
    them, made once a run. Returns {"higgs": [28, n] uint8, "expo": [8, n]
    uint8}."""
    if (n, valid_rows, seed) in _bins_cache:
        return _bins_cache[(n, valid_rows, seed)]
    import lightgbm_tpu_torch as lgb
    params = dict(PARAMS, device_type="cuda")
    X, y = higgs_like(n + valid_rows, seed)
    higgs = lgb.Dataset(X[:n], label=y[:n], params=params).construct()
    X, y = expo_like(n + valid_rows, seed + 11)
    expo = lgb.Dataset(X[:n], label=y[:n], params=params,
                       categorical_feature=CAT_COLUMNS).construct()
    _bins_cache[(n, valid_rows, seed)] = {"higgs": higgs.binsT,
                                          "expo": expo.binsT}
    return _bins_cache[(n, valid_rows, seed)]


def root_phases(cuda_hist, n, bins):
    """The root pass, the one full pass a tree takes (one computed slot,
    all N rows), of both paths and modes, each on uniform random bins and
    on the train phases' own bins (``bins``, real_bins)."""
    return {
        "full_root": {
            "uniform": hist_phase(cuda_hist, n, root=True, seed=51),
            "higgs": hist_phase(cuda_hist, n, root=True, seed=52,
                                bins=bins["higgs"])},
        "plane_root": {
            "uniform": hist_phase(cuda_hist, n, f=F_CAT, plane=True,
                                  root=True, seed=53),
            "expo": hist_phase(cuda_hist, n, f=F_CAT, plane=True, root=True,
                               seed=54, bins=bins["expo"])},
        "q8_full_root": {
            "uniform": hist_q8_phase(cuda_hist, n, root=True, seed=55),
            "higgs": hist_q8_phase(cuda_hist, n, root=True, seed=56,
                                   bins=bins["higgs"])},
        "q8_plane_root": {
            "uniform": hist_q8_phase(cuda_hist, n, f=F_CAT, plane=True,
                                     root=True, seed=57),
            "expo": hist_q8_phase(cuda_hist, n, f=F_CAT, plane=True,
                                  root=True, seed=58, bins=bins["expo"])}}


def kernel_phases(cuda_hist, n, valid_rows, seed):
    """Every hist_tile phase of this script at N rows: the root passes of
    both paths and modes, the main path's full form of several slots and
    its rungs and the stress inputs, the classic path's plane-only forms,
    and the q8 forms of both (the train phases' data for the real bins
    made from ``seed`` with ``valid_rows`` more rows, as they make it)."""
    rungs = ladder_rungs(n)
    bins = real_bins(n, valid_rows, seed)
    return {
        **root_phases(cuda_hist, n, bins),
        "full": hist_phase(cuda_hist, n),
        "rungs": {str(m): hist_phase(cuda_hist, n, m=m, seed=3)
                  for m in rungs},
        "stress": stress_phase(cuda_hist, n),
        "plane_full": hist_phase(cuda_hist, n, f=F_CAT, plane=True, seed=5),
        "plane_rungs": {str(m): hist_phase(cuda_hist, n, m=m, seed=6,
                                           f=F_CAT, plane=True)
                        for m in rungs},
        "q8_full": hist_q8_phase(cuda_hist, n, seed=21),
        "q8_rungs": {str(m): hist_q8_phase(cuda_hist, n, m=m, seed=22)
                     for m in rungs},
        "q8_plane": hist_q8_phase(cuda_hist, n, f=F_CAT, plane=True,
                                  seed=23),
        "q8_plane_rungs": {str(m): hist_q8_phase(cuda_hist, n, m=m, seed=24,
                                                 f=F_CAT, plane=True)
                           for m in rungs}}


def _times(phases):
    """Each form's (event ms, device ms) from kernel_phases' results."""
    pick = lambda r: [r["ms"], r["device_ms"]]
    out = {}
    for key, val in phases.items():
        if key == "stress":
            for mode in ("f32", "q8"):
                out.update({f"stress_{mode}/{k}": pick(v)
                            for k, v in val[mode].items()})
        elif "ms" in val:
            out[key] = pick(val)
        else:
            out.update({f"{key}/{m}": pick(v) for m, v in val.items()})
    return out


# Run in a subprocess (--parent): this script's kernel_phases drive the
# other checkout's lightgbm_tpu_torch (first on sys.path) on the same
# inputs, with the same checks and clocks, so two designs compare in one
# run. A kernel that takes no amax computes it itself.
PARENT_PROBE = r"""
import importlib.util, inspect, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from lightgbm_tpu_torch.ops import cuda_hist
if "amax" not in inspect.signature(cuda_hist.hist_tile).parameters:
    def hist_tile(*a, amax=None, _take=cuda_hist.hist_tile, **k):
        return _take(*a, **k)
    hist_tile.__dict__.update(cuda_hist.hist_tile.__dict__)  # its counters
    cuda_hist.hist_tile = hist_tile
cuda_hist.build_kernels()
import lightgbm_tpu_torch as lgb
seed, what = int(sys.argv[5]), sys.argv[6]
if what == "all":
    times = cs._times(cs.kernel_phases(
        cuda_hist, int(sys.argv[3]), int(sys.argv[4]), seed))
    times.update(cs.redesign_probes(cuda_hist, seed))
    times["parity_sha256"] = cs.parity_text_hashes(lgb, seed)
else:
    times = cs.redesign_probes(cuda_hist, seed, cs.WIDE_PASS)
times["wide_sha256"] = {k: v["sha256"]
                        for k, v in cs.wide_texts(lgb, seed).items()}
print(json.dumps(times))
"""


VARIANTS = ("2x2048", "4x2048", "4x1024", "7x1024")   # the script's default


WIDE_PASS = ("split_epilogue_wide",)
PROBES = ("split_epilogue", "hist_onehot") + WIDE_PASS


def redesign_probes(cuda_hist, seed: int = 0, kernels=PROBES):
    """The redesigned kernels timed on any checkout's package at the main
    path's shapes: per form [event ms, device ms] --
    ``split_epilogue`` and ``split_epilogue_q8`` (P=42, F=28, B=255, device
    ms a launch over EPI_LAUNCHES, each on a cold L2),
    ``hist_onehot/<variant>`` at the experiment script's defaults (2M rows,
    28 features, 255 bins, its data) and
    ``split_epilogue_wide/b<B>[_q8][_mono]`` at B = 1,023 and 4,095, f32
    and q8, unconstrained and monotone (epilogue_wide's inputs; device ms
    as the B = 255 probes), each with ``/sha256`` of both outputs'
    bytes."""
    out = {}
    if "split_epilogue" in kernels:
        for q8 in (False, True):
            args = epilogue_inputs(cuda_hist, seed, q8)
            out["split_epilogue" + ("_q8" if q8 else "")] = [
                time_ms(lambda: cuda_hist.split_epilogue(*args)),
                epilogue_device_ms(cuda_hist, args)]
    if "hist_onehot" in kernels:
        from lightgbm_tpu_torch.scripts import exp_hist_variants as ev
        binsT, rhs = ev.make_data(2_000_000, F, B, torch.device("cuda"))
        for spec in VARIANTS:
            fg, blk = (int(x) for x in spec.split("x"))
            bp, rp = ev.pad_rows(binsT, rhs, blk)
            call = lambda: cuda_hist.hist_onehot(bp, rp, B, fg, blk)
            out[f"hist_onehot/{spec}"] = [
                time_ms(call, reps=5, warm=1),
                device_ms(call, reps=5, need="hist_onehot_kernel")[0]]
            del bp, rp
        del binsT, rhs
    if "split_epilogue_wide" in kernels:
        for b in (WIDE_B, WIDE_STRESS_B):
            for q8 in (False, True):
                base = epilogue_inputs(cuda_hist, seed, q8=q8, b=b)
                for mono in (False, True):
                    call = wide_epilogue_call(cuda_hist, base, q8, mono)
                    kf, kc = call()
                    key = wide_form(b, q8, mono)
                    out[key] = [time_ms(call), device_ms(
                        call, per_profile=EPI_LAUNCHES,
                        need="split_epilogue", cold_each=True)[0]]
                    out[key + "/sha256"] = hashlib.sha256(
                        kf.cpu().numpy().tobytes()
                        + kc.cpu().numpy().tobytes()).hexdigest()
    torch.cuda.empty_cache()
    return out


def parent_times(parent_dir: str, n: int, valid_rows: int, seed: int,
                 what: str = "all"):
    """The other checkout's kernels timed by this script's phases: per
    form, [event ms, device ms]. ``what``: "all" (the hist_tile forms,
    every probe of ``redesign_probes`` and the parity texts' hashes) or
    "wide" (the wide epilogue's probes); both with the card texts' hashes
    of parity_data's four wide runs (``wide_sha256``)."""
    res = subprocess.run([sys.executable, "-c", PARENT_PROBE,
                          os.path.abspath(parent_dir),
                          os.path.abspath(__file__), str(n),
                          str(valid_rows), str(seed), what],
                         cwd=parent_dir, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"the probe of {parent_dir} failed:\n"
                           f"{res.stderr[-6000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def attach_probes(entries, own, parent):
    """Each wide epilogue entry's probe times (``probes``: per form, this
    run's and the other checkout's in the order taken), after checking
    that every probe of a form gave the same bits. ``entries``: (entry,
    (q8, monotone)) pairs."""
    runs = own + parent
    for entry, (q8, mono) in entries:
        forms = [wide_form(b, q8, mono) for b in (WIDE_B, WIDE_STRESS_B)]
        for form in forms:
            if len({r[form + "/sha256"] for r in runs}) != 1:
                raise AssertionError(f"the probes' {form} outputs differ "
                                     f"between checkouts or calls")
        entry["probes"] = {f: {"change": [r[f] for r in own],
                               "parent": [r[f] for r in parent]}
                           for f in forms}


EPI_LAUNCHES = 50    # epilogue launches in one profile, each on a cold L2


def epilogue_inputs(cuda_hist, seed=0, q8=False, f=F, b=B):
    """The epilogue's arguments at the main path's P=42, F=28 (or ``f``),
    B=255 (or ``b`` bins): the derived odd slots, random planes (f32: grad N(0,1), hess
    U(0,1), count 1 per row; q8: the int32 sums of int8 stats, a
    non-trivial q_scale, the derived slots' parents dequantized as
    resident), features with fewer bins and the NaN and Zero missing
    types. Returns (tile, parent, der, la, fm, pv), with q_scale last in
    q8 mode."""
    if q8:
        g = torch.Generator(device="cuda").manual_seed(seed + 7)
        q_scale = torch.tensor([0.0173, 0.00291, 1.0], device="cuda")
        tile = torch.zeros((P, f, b, 3), dtype=torch.int32, device="cuda")
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
        tile = torch.zeros((P, f, b, 3), device="cuda")
    parent = torch.zeros((P, f, b, 3), device="cuda")
    derive = torch.zeros(P, dtype=torch.bool)
    derive[1::2] = True
    for p in range(P):
        cnt = torch.randint(0, 40, (f, b), generator=g, device="cuda")
        if q8:
            plane = torch.stack([
                torch.randint(-127, 128, (f, b), generator=g,
                              device="cuda") * cnt,
                torch.randint(0, 128, (f, b), generator=g, device="cuda")
                * cnt, cnt], -1).to(torch.int32)
            if derive[p]:
                parent[p] = (plane + tile[p - 1]).to(torch.float32) * q_scale
            else:
                tile[p] = plane
            continue
        cnt = cnt.to(torch.float32)
        gsum = torch.randn((f, b), generator=g, device="cuda") * cnt.sqrt()
        hsum = torch.rand((f, b), generator=g, device="cuda") * cnt
        plane = torch.stack([gsum, hsum, cnt], -1)
        if derive[p]:
            parent[p] = plane + tile[p - 1]
        else:
            tile[p] = plane
    deq = tile.to(torch.float32) * q_scale if q8 else tile
    full = torch.where(derive.cuda()[:, None, None, None],
                       parent - torch.cat([deq[:1] * 0, deq[:-1]]), deq)
    s = full[:, 0].sum(1)                                   # [P, 3]
    la = cuda_hist.pack_leaf_aux(s[:, 0], s[:, 1], s[:, 2],
                                 -0.1 * s[:, 0] / (s[:, 1] + 1)).cuda()
    nb = torch.full((f,), b, dtype=torch.int32)
    nb[3], nb[7] = 64, 2
    mt = torch.zeros(f, dtype=torch.int32)
    mt[5], mt[6] = 2, 1                                     # NaN, Zero
    db = torch.zeros(f, dtype=torch.int32)
    db[6] = 17
    fm = cuda_hist.pack_feature_meta(nb, mt, db,
                                     torch.zeros(f, dtype=torch.int32)).cuda()
    pv = torch.tensor([0.0, 1.0, 0.0, 0.0, 20.0, 1e-3, 0.0, 0.0],
                      device="cuda")
    der = cuda_hist._epilogue_lanes(torch.arange(P, dtype=torch.int32),
                                    derive).cuda()
    args = (tile, parent, der, la, fm, pv)
    return args + (q_scale,) if q8 else args


def epilogue_device_ms(cuda_hist, args):
    """The epilogue's device ms a launch: EPI_LAUNCHES launches in each
    profile (one alone can leave no device activity in the trace), each
    after an L2 flush, as the HBM bound assumes."""
    return device_ms(lambda: cuda_hist.split_epilogue(*args),
                     per_profile=EPI_LAUNCHES, need="split_epilogue",
                     cold_each=True)[0]


def epilogue_bound(der, q8: bool, f: int = F, mono: bool = False,
                   b: int = B):
    """The epilogue's bound at P, F, B (or ``f``, ``b``) on derive lanes
    ``der`` (slot p at lane 3p): the bytes it must move are the tile planes it reads (each
    computed slot's, also the sibling of a derived slot), the derived
    slots' parent planes, every full plane written once, and the small
    tables; 60 float operations a bin (61 in q8, the dequant; MONO_OPS
    more in the monotone mode)."""
    derive = (der[0, 0:3 * P:3] != 0).tolist()
    tiles = {p - 1 if d else p for p, d in enumerate(derive)} - {-1}
    planes = len(tiles) + sum(derive) + P
    nbytes = planes * f * b * 3 * 4 + P * f * 12 * 4 + P * 8 * 4 \
        + f * 8 * 4 + 8 * 4 + (12 if q8 else 0)
    return bound(nbytes, ((61 if q8 else 60) + (MONO_OPS if mono else 0))
                 * P * f * b)


def epilogue_phase(cuda_hist, seed=0):
    args = epilogue_inputs(cuda_hist, seed)
    kf, kc = cuda_hist.split_epilogue(*args)
    kf2, kc2 = cuda_hist.split_epilogue(*args)
    pf, pc = cuda_hist.split_epilogue_plain(*args)
    torch.cuda.synchronize()
    for a, b in ((kc, pc), (kf, pf), (kc, kc2), (kf, kf2)):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("split_epilogue is not bitwise equal to "
                                 "its plain version and to a second launch")
    valid = int(torch.isfinite(kc[..., 0]).sum())
    if valid == 0:
        raise AssertionError("split_epilogue found no valid candidate")
    bms, by = epilogue_bound(args[2], q8=False)
    return {"max_abs_err": float((kc - pc).nan_to_num(0.0).abs().max()),
            "valid_candidates": valid, "deterministic": True,
            "ms": time_ms(lambda: cuda_hist.split_epilogue(*args)),
            "device_ms": epilogue_device_ms(cuda_hist, args),
            "device_ms_launches": EPI_LAUNCHES,
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


def hist_q8_phase(cuda_hist, n, m=None, seed=0, f=F, plane=False, real=0.9,
                  hot=0.0, skew=0.0, root=False, bins=None, b=B):
    """The q8 form (int8 stats, exact int32 planes) at the shapes of one
    main-path or classic-path pass, as hist_phase: bitwise vs the plain
    version and vs a second launch."""
    from lightgbm_tpu_torch.ops.histogram import compact_indices
    sel = tile_selection(plane, root)
    tile_leaves = sel[sel >= 0]
    chan_h = cuda_hist.chan_leaf_table(sel)
    chan = chan_h.cuda()
    share = 1.0 if root else 0.75 if m is None else real * m / n
    binsT, leaf, _ = hist_inputs(n, f, seed, True, tile_leaves, share, hot,
                                 skew, b)
    binsT = binsT if bins is None else bins
    stats = q8_stats(n, seed)
    in_tile = torch.isin(leaf, tile_leaves.cuda())
    n_tile = int(in_tile.sum())
    idx = None
    if m is not None:
        if n_tile > m:
            raise AssertionError(f"{n_tile} tile rows overflow the {m}-row "
                                 f"rung")
        idx = compact_indices(in_tile, m)
    args = (binsT, leaf, stats, chan, P, b, LEAVES, idx)
    kargs = (binsT, leaf, stats, chan_h, P, b, LEAVES, idx)
    k = cuda_hist.hist_tile(*kargs, plane=plane)
    again = cuda_hist.hist_tile(*kargs, plane=plane)
    p = cuda_hist.hist_tile_plain(*args)
    torch.cuda.synchronize()
    if k.dtype != torch.int32 or not torch.equal(k, p):
        raise AssertionError("q8 hist_tile is not bitwise equal to its plain "
                             "version (exact int32 sums)")
    if not torch.equal(k, again):
        raise AssertionError("two q8 hist_tile launches differ")
    out = {"bitwise_vs_plain": True, "deterministic": True,
           "max_abs_err": float((k - p).abs().max())}
    out["ms"] = time_ms(lambda: cuda_hist.hist_tile(*kargs, plane=plane))
    out["device_ms"], out["device_split"] = device_ms(
        lambda: cuda_hist.hist_tile(*kargs, plane=plane))
    out["plain_ms"] = time_ms(lambda: cuda_hist.hist_tile_plain(*args),
                              reps=10, warm=1)
    out["library_ms"] = library_ms(binsT, leaf, stats, sel, in_tile, f, b,
                                   torch.int32)
    # least traffic: the row-index buffer (gather form), the leaf id of
    # every row it names, the bins and 3 int8 stats of the tile's rows,
    # the int32 planes written once; one add per (tile row, feature, stat)
    scanned = n if idx is None else n_tile
    nbytes = (0 if idx is None else 4 * m) + 4 * scanned \
        + n_tile * (f * binsT.element_size() + 3) + P * f * b * 3 * 4
    out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * n_tile * f)
    out["rows"], out["tile_rows"] = (n if m is None else m), n_tile
    return out


def epilogue_q8_phase(cuda_hist, seed=0):
    """The dequantizing epilogue: an int32 tile of exact sums (derived
    slots zero), float32 parents (dequantized sums, as resident), a
    non-trivial q_scale."""
    args = epilogue_inputs(cuda_hist, seed, q8=True)
    tile, q_scale = args[0], args[6]
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
    bms, by = epilogue_bound(args[2], q8=True)
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
            "valid_candidates": valid, "deterministic": True,
            "q_scale": q_scale.tolist(),
            "ms": statistics.median(turns["q8"]),
            "device_ms": epilogue_device_ms(cuda_hist, args),
            "device_ms_launches": EPI_LAUNCHES,
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
           "rows_real_per_tree": booster.rows_real_per_tree,
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


# the port's own kernels (csrc/), each reported in a train phase's profile
# whether or not it is among the iteration's top device times
OWN_KERNELS = ("full_accumulate", "gather_count", "gather_scatter",
               "gather_accumulate", "hist_tile_reduce", "stat_absmax",
               "split_epilogue", "lambdarank_kernel")


def profile_iteration(booster, sec_per_iter: float, fobj=None):
    """Where one more boosting iteration's time goes: device time by kernel
    (torch.profiler, CUDA activity only) against the unprofiled sec/iter,
    the top 12 and every kernel of the port's own, and the host's hottest
    Python functions (cProfile over a further iteration; its own overhead
    inflates the host times). ``fobj``: the run's custom objective, which
    each of those iterations takes too."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        booster.update(fobj=fobj)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {"device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
           "top_device": [{"name": k[:60], "ms": us / 1e3, "calls": c}
                          for us, k, c in rows[:12]],
           "own_kernels": {_short(k): {"ms": us / 1e3, "calls": c}
                           for us, k, c in rows
                           if any(o in k for o in OWN_KERNELS)}}
    if busy_ms > 0:
        out["device_idle_share"] = max(0.0, 1 - busy_ms
                                       / (sec_per_iter * 1e3))
    prof_host = cProfile.Profile()
    t0 = time.time()
    prof_host.enable()
    booster.update(fobj=fobj)
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
           "rows_real_per_tree": booster.rows_real_per_tree,
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


# UCI Covertype (581,012 rows): the rows of each of its 7 classes (cover
# types 1-7 as 0-6) and the shares of its 4 wilderness areas
COVER_ROWS = 581_012
COVER_CLASS_ROWS = (211840, 283301, 35754, 2747, 9493, 17367, 20510)
COVER_WILDERNESS = (0.449, 0.051, 0.436, 0.064)


def covertype_like(n: int, seed: int):
    """Covertype-shaped data: its 54 columns in its order (10 integer
    numerical -- elevation, aspect, slope, the distances to water, roads
    and fire points, three hillshades -- then 4 wilderness and 40 soil
    one-hot binaries, exactly one of each set a row; soil shares Zipf-like,
    so most one-hot columns are >= 90% zeros and stored as sparse streams)
    and a 7-class label from a noisy elevation-led score, cut at the
    dataset's class shares with the classes in the dataset's elevation
    order."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 54), np.float32)
    X[:, 0] = np.round(np.clip(rng.normal(2959, 280, n), 1859, 3858))
    X[:, 1] = rng.randint(0, 361, n)
    X[:, 2] = np.round(np.clip(rng.gamma(4.0, 3.5, n), 0, 66))
    X[:, 3] = np.round(np.clip(rng.exponential(270, n), 0, 1397))
    X[:, 4] = np.round(np.clip(rng.normal(46, 58, n), -173, 601))
    X[:, 5] = np.round(np.clip(rng.exponential(2350, n), 0, 7117))
    X[:, 6] = np.round(np.clip(rng.normal(212, 27, n), 0, 254))
    X[:, 7] = np.round(np.clip(rng.normal(223, 20, n), 0, 254))
    X[:, 8] = np.round(np.clip(rng.normal(143, 38, n), 0, 254))
    X[:, 9] = np.round(np.clip(rng.exponential(1980, n), 0, 7173))
    wild = rng.choice(4, n, p=COVER_WILDERNESS)
    X[np.arange(n), 10 + wild] = 1.0
    soil_p = 1.0 / (np.arange(40) + 2.5) ** 1.1
    soil = rng.choice(40, n, p=rng.permutation(soil_p / soil_p.sum()))
    X[np.arange(n), 14 + soil] = 1.0
    eff = np.random.RandomState(seed + 1).randn(44)
    z = ((X[:, 0] - 2959) / 280 + 0.25 * np.sin(np.radians(X[:, 1]))
         - 0.01 * X[:, 2] - 0.0004 * X[:, 5] + 0.3 * eff[wild]
         + 0.3 * eff[4 + soil] + 0.4 * rng.randn(n))
    order = (3, 2, 5, 1, 4, 0, 6)     # Cottonwood/Willow lowest ... Krummholz
    shares = np.array([COVER_CLASS_ROWS[c] for c in order], np.float64)
    cuts = np.quantile(z, np.cumsum(shares)[:-1] / shares.sum())
    y = np.asarray(order)[np.searchsorted(cuts, z)].astype(np.float64)
    return X, y


MULTICLASS = {"objective": "multiclass", "num_class": 7,
              "metric": ["multi_logloss", "multi_error"]}


def train_multiclass_phase(lgb, cuda_hist, args, q8_ref_error=None):
    """Multiclass on Covertype-shaped data (COVER_ROWS train rows, a
    tenth of that more for validation, PARAMS otherwise, 5 rounds: 35
    trees); its one-hot columns are sparse streams, so the classic path:
    plane-only hist_tile launches only. With ``q8_ref_error`` (the f32
    run's valid multi_error) the q8 mode, whose multi_error must be within
    0.01 of it."""
    q8 = q8_ref_error is not None
    t0 = time.time()
    nv = COVER_ROWS // 10
    X, y = covertype_like(COVER_ROWS + nv, args.seed + 3)
    Xv, yv = X[COVER_ROWS:], y[COVER_ROWS:]
    X, y = X[:COVER_ROWS], y[:COVER_ROWS]
    t_data = time.time() - t0
    params = dict(PARAMS, **MULTICLASS, device_type="cuda",
                  quantized_grad=q8)
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
    gb = booster._boosting
    prob = booster.predict(Xv)
    sfx, other = ("_q8", "") if q8 else ("", "_q8")
    merr = evals["valid"]["multi_error"][-1]
    out = {"rows": COVER_ROWS, "valid_rows": nv, "features": 54,
           "classes": 7, "rounds": args.rounds, "quantized_grad": q8,
           "sec_per_iter": wall / args.rounds, "train_wall_s": wall,
           "data_s": t_data, "construct_s": t_construct,
           "valid_multi_logloss": evals["valid"]["multi_logloss"][-1],
           "valid_multi_error": merr,
           "valid_multi_error_from_predict": float(np.mean(
               prob.argmax(1) != yv)),
           "split_path": "fused" if gb._split_fusion_on() else "classic",
           "sparse_columns": len(train.sp_cols) if train.has_sparse_cols
           else 0,
           "rows_streamed_per_tree": booster.rows_streamed_per_tree,
           "rows_real_per_tree": booster.rows_real_per_tree,
           "launches": launches, "trees": booster.num_trees()}
    plane = launches["hist_tile.launches_plane" + sfx]
    if out["split_path"] != "classic" or plane <= 0 \
            or launches["hist_tile.gather_launches" + sfx] <= 0 \
            or plane != launches["hist_tile.launches" + sfx] \
            or launches["split_epilogue.launches"] \
            or launches["split_epilogue.launches_q8"] \
            or launches["hist_tile.launches" + other]:
        raise AssertionError(f"the multiclass run left the classic path or "
                             f"missed its kernels: {out}")
    # the majority class holds 48.8% of the rows
    baseline = 1.0 - max(COVER_CLASS_ROWS) / sum(COVER_CLASS_ROWS)
    if out["trees"] != 7 * args.rounds or prob.shape != (nv, 7) \
            or not np.all(np.isfinite(prob)) \
            or not np.allclose(prob.sum(1), 1.0, atol=1e-5) \
            or not np.isfinite(out["valid_multi_logloss"]) \
            or not merr < baseline \
            or abs(merr - out["valid_multi_error_from_predict"]) > 1e-3:
        raise AssertionError(f"multiclass output: {out}")
    if q8 and not abs(merr - q8_ref_error) <= 0.01:
        raise AssertionError(f"q8 multi_error {merr} not within 0.01 of the "
                             f"f32 run's {q8_ref_error}")
    out["profile"] = profile_iteration(booster, wall / args.rounds)
    return out, launches


# the sampling runs: the boosting modes users tune, on train's data
SAMPLING = {
    "bagging_mask": {"bagging_fraction": 0.8, "bagging_freq": 1},
    "bagging_subset": {"bagging_fraction": 0.5, "bagging_freq": 1},
    "bagging_posneg": {"pos_bagging_fraction": 0.8,
                       "neg_bagging_fraction": 0.5, "bagging_freq": 1},
    "feature_fraction": {"feature_fraction": 0.8},
    "goss": {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1,
             "learning_rate": 0.5},
    "dart": {"boosting": "dart"},
    "rf": {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
           "feature_fraction": 0.8},
}


def train_sampling_phase(lgb, cuda_hist, args, plain_rows_per_tree):
    """Each SAMPLING run on train's Higgs-shaped data (one Dataset,
    constructed once), 5 rounds: sec/iter, valid AUC (> 0.6), rows read
    per tree, launches (the fused path's kernels, f32). The subset run
    reads at most 0.55x the rows a tree of ``plain_rows_per_tree`` (the
    plain train run's), with rungs of its k rows; GOSS samples from
    iteration int(1 / 0.5) = 2 on, 3 of the 5; DART at its defaults
    (drop_seed 4) drops trees in at least one iteration (the fourth)."""
    X, y = higgs_like(args.rows + args.valid_rows, args.seed)
    Xv, yv = X[args.rows:], y[args.rows:]
    X, y = X[:args.rows], y[:args.rows]
    base = dict(PARAMS, device_type="cuda")
    train = lgb.Dataset(X, label=y, params=base)
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    train.construct()
    valid.construct()
    runs = {}
    for name, extra in SAMPLING.items():
        params = dict(base, **extra)
        evals = {}
        cuda_hist.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        booster = lgb.train(params, train, args.rounds, valid_sets=[valid],
                            valid_names=["valid"], evals_result=evals)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = cuda_hist.launch_counts()
        gb = booster._boosting
        r = {"params": extra, "sec_per_iter": wall / args.rounds,
             "valid_auc": evals["valid"]["auc"][-1],
             "valid_auc_from_predict": auc(
                 booster.predict(Xv, raw_score=True), yv),
             "rows_streamed_per_tree": booster.rows_streamed_per_tree,
             "rows_real_per_tree": booster.rows_real_per_tree,
             "bagging_mode": gb._bagging_mode(),
             "rungs": list(gb._compaction_ladder()),
             "trees": booster.num_trees(), "launches": launches}
        if name == "goss":
            r["sampled_iterations"] = list(gb.sampled_iterations)
        if name == "dart":
            r["drop_sets"] = list(gb.drop_sets)
        runs[name] = r
        fused = (launches["hist_tile.launches"]
                 - launches["hist_tile.launches_plane"])
        if not (r["valid_auc"] > 0.6
                and abs(r["valid_auc"] - r["valid_auc_from_predict"]) < 1e-3
                and r["trees"] == args.rounds and fused > 0
                and launches["hist_tile.gather_launches"] > 0
                and launches["split_epilogue.launches"] > 0
                and not launches["hist_tile.launches_plane"]
                and not launches["hist_tile.launches_q8"]):
            raise AssertionError(f"sampling run {name}: {r}")
    sub = runs["bagging_subset"]
    k = int(round(args.rows * 0.5))
    if not (sub["bagging_mode"] == "subset"
            and sub["rows_streamed_per_tree"] <= 0.55 * plain_rows_per_tree
            and sub["rungs"] == ladder_rungs(k)):
        raise AssertionError(f"the subset run: {sub} (plain train "
                             f"{plain_rows_per_tree} rows a tree)")
    if runs["bagging_mask"]["bagging_mode"] != "mask" or \
            len(runs["goss"]["sampled_iterations"]) < 3 or \
            not any(runs["dart"]["drop_sets"]):
        raise AssertionError(f"bagging mask / GOSS / DART: {runs}")
    return {"rows": args.rows, "valid_rows": args.valid_rows,
            "rounds": args.rounds, "plain_rows_streamed_per_tree":
            plain_rows_per_tree, "runs": runs}


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


# the parity phases' runs, one definition for the phases and for the
# parent's probe (parity_text_hashes): name -> (data, seed offset,
# categorical columns, q8); each trains PARITY_ROUNDS rounds on
# PARITY_ROWS rows with 63 leaves
PARITY_RUNS = {"parity": (higgs_like, 7, None, False),
               "parity_cat": (expo_like, 13, CAT_COLUMNS, False),
               "parity_sparse": (sparse_higgs_like, 17, None, False),
               "parity_q8": (higgs_like, 7, None, True),
               "parity_q8_cat": (expo_like, 13, CAT_COLUMNS, True)}
# the five parity phases' rounds: 1, cut from 3 to 2 when the faults group
# came in and to 1 when the distributed group did; the boosting modes'
# parity runs keep 3 (DART drops a tree at the third iteration)
PARITY_ROWS, PARITY_ROUNDS, PARITY_MODES_ROUNDS = 50_000, 1, 3
# the phases whose card text is held bitwise (and to the parent's)
PARITY_HELD = ("parity", "parity_sparse", "parity_q8", "parity_q8_cat")


def parity_setup(name: str, seed: int):
    """A parity phase's (X, y, params, Dataset keywords)."""
    data, offset, cat, q8 = PARITY_RUNS[name]
    X, y = data(PARITY_ROWS, seed + offset)
    params = dict(PARAMS, num_leaves=63)
    if q8:
        params["quantized_grad"] = True
    return X, y, params, ({} if cat is None else {"categorical_feature": cat})


def parity_text(lgb, setup, device: str, rounds: int = PARITY_ROUNDS) -> str:
    """The model text of one training of a parity phase on ``device``."""
    X, y, params, kw = setup
    p = dict(params, device_type=device)
    return lgb.train(p, lgb.Dataset(X, label=y, params=p, **kw),
                     rounds).model_to_string()


def parity_text_hashes(lgb, seed: int):
    """The card's model text of the PARITY_HELD phases, one card run each,
    as sha256: a checkout's package run by --parent's probe gives the text
    its phases would."""
    return {name: _sha(parity_text(lgb, parity_setup(name, seed), "cuda"))
            for name in PARITY_HELD}


def same_as_parent(out, name, parent):
    """With --parent: the phase's card model text must be the text the
    other checkout's package gives (its probe's parity_text_hashes)."""
    if parent:
        same = out["card_text_sha256"] == parent[0]["parity_sha256"][name]
        out["card_text_equals_parent"] = same
        if not same:
            raise AssertionError(f"{name}: the card's model text differs "
                                 f"from the parent checkout's")
    return out


def _structure(text):
    from lightgbm_tpu_torch.io.model_text import load_model
    return [(t.split_feature.tolist(), t.threshold.tolist(),
             t.decision_type.tolist(), t.cat_threshold.tolist(),
             t.left_child.tolist(), t.right_child.tolist())
            for t in load_model(text).trees]


def _parity(lgb, name, seed, strict=False):
    """One training on the card twice and on the CPU twice: with the CPU
    path's float32 sums (the JAX package's order) and with the kernel's
    fixed-point sums (``kernel_sums_on_cpu``). The two card runs and the
    kernel-sums CPU run must give the same model text, bit for bit.
    Against the float32-sum run: the first tree whose structure (split
    features, thresholds, category bitsets, children) differs, and the
    largest leaf difference of the trees before it; ``strict`` requires
    the same structure throughout and leaves within 1e-4."""
    from lightgbm_tpu_torch.io.model_text import load_model
    from lightgbm_tpu_torch.ops import cuda_hist
    setup = parity_setup(name, seed)
    texts = {}
    for run in ("cuda", "cuda_again", "cpu", "cpu_kernel_sums"):
        with (cuda_hist.kernel_sums_on_cpu() if run == "cpu_kernel_sums"
              else contextlib.nullcontext()):
            texts[run] = parity_text(lgb, setup, run.split("_")[0])
    sc, sp = _structure(texts["cuda"]), _structure(texts["cpu"])
    diverge = next((i for i, (a, b) in enumerate(zip(sc, sp)) if a != b),
                   None if len(sc) == len(sp) else min(len(sc), len(sp)))
    tc, tp = load_model(texts["cuda"]).trees, load_model(texts["cpu"]).trees
    upto = len(tc) if diverge is None else diverge
    leaf_err = max([float(np.abs(a.leaf_value - b.leaf_value).max())
                    for a, b in zip(tc[:upto], tp[:upto])] or [0.0])
    out = {"rows": PARITY_ROWS, "num_leaves": setup[2]["num_leaves"],
           "rounds": PARITY_ROUNDS,
           "card_runs_identical_text": texts["cuda"] == texts["cuda_again"],
           "card_equals_cpu_kernel_sums": texts["cuda"]
           == texts["cpu_kernel_sums"],
           "same_structure_as_cpu": diverge is None,
           "first_divergent_tree_vs_cpu": diverge,
           "max_leaf_abs_err_before_divergence": leaf_err,
           "categorical_nodes": int(sum(t.num_cat for t in tc)),
           "card_text_sha256": _sha(texts["cuda"])}
    if not (out["card_runs_identical_text"]
            and out["card_equals_cpu_kernel_sums"]) or (
            strict and (diverge is not None or leaf_err > 1e-4)):
        raise AssertionError(f"card vs CPU disagree: {out}")
    return out


def parity_phase(lgb, seed):
    return _parity(lgb, "parity", seed, strict=True)


def parity_cat_phase(lgb, seed):
    out = _parity(lgb, "parity_cat", seed)
    if out["categorical_nodes"] <= 0:
        raise AssertionError(f"no categorical node: {out}")
    return out


def parity_sparse_phase(lgb, seed):
    X, y = parity_setup("parity_sparse", seed)[:2]
    ds = lgb.Dataset(X, label=y, params=dict(PARAMS, device_type="cpu"))
    ds.construct()
    if not ds.has_sparse_cols or len(ds.sp_cols) != 4:
        raise AssertionError(f"expected 4 sparse device columns, got "
                             f"{ds.sp_cols}")
    out = _parity(lgb, "parity_sparse", seed)
    out["sparse_columns"] = ds.sp_cols.tolist()
    return out


def _parity_q8(lgb, name, seed):
    """q8 training on the card twice and on the CPU plain path: the int8
    quantization is the same torch arithmetic on both devices and the
    int32 sums are exact (127 * 50,000 < 2^24 keeps the root's float32
    sums exact too), so all three model texts must be equal bit for bit."""
    from lightgbm_tpu_torch.io.model_text import load_model
    setup = parity_setup(name, seed)
    texts = {run: parity_text(lgb, setup, run.split("_")[0])
             for run in ("cuda", "cuda_again", "cpu")}
    out = {"rows": PARITY_ROWS, "num_leaves": setup[2]["num_leaves"],
           "rounds": PARITY_ROUNDS,
           "card_runs_identical_text": texts["cuda"] == texts["cuda_again"],
           "card_equals_cpu_text": texts["cuda"] == texts["cpu"],
           "categorical_nodes": int(sum(
               t.num_cat for t in load_model(texts["cuda"]).trees)),
           "card_text_sha256": _sha(texts["cuda"])}
    if not (out["card_runs_identical_text"] and out["card_equals_cpu_text"]):
        raise AssertionError(f"q8 card vs CPU disagree: {out}")
    return out


def parity_q8_phase(lgb, seed):
    return _parity_q8(lgb, "parity_q8", seed)


def parity_q8_cat_phase(lgb, seed):
    out = _parity_q8(lgb, "parity_q8_cat", seed)
    if out["categorical_nodes"] <= 0:
        raise AssertionError(f"no categorical node: {out}")
    return out


# the slice's parity runs: name -> (data, seed offset, parameters over
# PARAMS at 63 leaves); each trains PARITY_MODES_ROUNDS rounds on
# PARITY_ROWS rows
PARITY_MODES = {
    "multiclass": (covertype_like, 19, dict(MULTICLASS)),
    "multiclass_q8": (covertype_like, 19, dict(MULTICLASS,
                                               quantized_grad=True)),
    "bagging_subset_ff": (higgs_like, 23, {"bagging_fraction": 0.5,
                                           "bagging_freq": 1,
                                           "feature_fraction": 0.8}),
    "bagging_posneg": (higgs_like, 23, SAMPLING["bagging_posneg"]),
    "goss": (higgs_like, 23, SAMPLING["goss"]),
    "goss_q8": (higgs_like, 23, dict(SAMPLING["goss"],
                                     quantized_grad=True)),
    # at drop_rate 0.1 (the default) no tree drops in PARITY_MODES_ROUNDS
    # rounds;
    # at 0.3 the third iteration drops the second's tree
    "dart": (higgs_like, 23, dict(SAMPLING["dart"], drop_rate=0.3)),
    "rf": (higgs_like, 23, SAMPLING["rf"]),
}


def _parity_mode(lgb, name, seed, rounds: int = PARITY_MODES_ROUNDS):
    """One PARITY_MODES training of ``rounds`` rounds twice on the card and
    once on the CPU (f32: with the kernel's fixed-point sums,
    kernel_sums_on_cpu; q8: the plain path, whose int32 sums are exact):
    the three model texts must be equal bit for bit."""
    from lightgbm_tpu_torch.ops import cuda_hist
    data, offset, extra = PARITY_MODES[name]
    X, y = data(PARITY_ROWS, seed + offset)
    setup = (X, y, dict(PARAMS, num_leaves=63, **extra), {})
    q8 = bool(extra.get("quantized_grad"))
    texts = {run: parity_text(lgb, setup, "cuda", rounds)
             for run in ("cuda", "cuda_again")}
    with (contextlib.nullcontext() if q8
          else cuda_hist.kernel_sums_on_cpu()):
        texts["cpu"] = parity_text(lgb, setup, "cpu", rounds)
    out = {"params": extra, "trees": texts["cuda"].count("Tree="),
           "card_runs_identical_text": texts["cuda"] == texts["cuda_again"],
           "card_equals_cpu_text": texts["cuda"] == texts["cpu"],
           "cpu_sums": "plain (exact int32)" if q8 else "kernel_sums_on_cpu",
           "card_text_sha256": _sha(texts["cuda"])}
    if not (out["card_runs_identical_text"] and out["card_equals_cpu_text"]):
        raise AssertionError(f"{name}: card vs CPU disagree: {out}")
    if extra.get("boosting") == "dart":
        # a dropped tree and the trees trained beside drops shrink below
        # the learning rate
        out["tree_shrinkages"] = sorted(set(
            float(line.split("=")[1]) for line in texts["cuda"].splitlines()
            if line.startswith("shrinkage=")))
        if len(out["tree_shrinkages"]) < 2:
            raise AssertionError(f"{name}: no tree was dropped: {out}")
    return out


# parity_multiclass' rounds: 1, cut from PARITY_ROUNDS to 2 when the
# precision modes' phases came in (7 trees a round on the CPU) and to 1
# when the predict group came in
PARITY_MULTICLASS_ROUNDS = 1


def parity_multiclass_phase(lgb, seed):
    return {"rows": PARITY_ROWS, "num_leaves": 63,
            "rounds": PARITY_MULTICLASS_ROUNDS,
            **{m: _parity_mode(lgb, m, seed, PARITY_MULTICLASS_ROUNDS)
               for m in ("multiclass", "multiclass_q8")}}


def parity_sampling_phase(lgb, seed):
    return {"rows": PARITY_ROWS, "num_leaves": 63,
            "rounds": PARITY_MODES_ROUNDS,
            **{m: _parity_mode(lgb, m, seed) for m in PARITY_MODES
               if not m.startswith("multiclass")}}


# ------------------------------------------------------- learning to rank
# MSLR-WEB30K Fold 1's training set (the reference's "MS LTR" experiment,
# docs/Experiments.rst): its query and document counts, its longest query,
# its 136 features and its relevance labels' shares; valid: more queries
# from the same generator
MSLR_QUERIES, MSLR_DOCS, MSLR_LONGEST = 18_919, 2_270_296, 1_251
MSLR_FEATURES = 136
MSLR_VALID_QUERIES = 6_000
MSLR_LABEL_SHARES = (0.51, 0.33, 0.13, 0.02, 0.01)
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "metric": "ndcg",
               "eval_at": [1, 3, 5, 10], "verbosity": -1}
# float operations of one admitted pair in lambdarank_grads (csrc/
# lambdarank.cu pair_terms: the score, gain and discount differences, the
# delta-NDCG product and its normalisation, the sigmoid with its exp's
# eight multiply-adds, the lambda and hessian products, two sums)
RANK_PAIR_OPS = 45
RANK_TOL = 1e-5     # kernel vs the JAX-order plain version: of the largest
                    # magnitude (the same float32 terms summed in another
                    # order)


def mslr_sizes(rng, n_queries: int, n_docs: int, longest: int):
    """Query lengths: gamma(2)-distributed around n_docs / n_queries, cut
    to [1, longest], the first query ``longest``, summing to n_docs."""
    sizes = np.clip(np.round(rng.gamma(2.0, n_docs / n_queries / 2.0,
                                       n_queries)), 1, longest - 1)
    sizes = sizes.astype(np.int64)
    sizes[0] = longest
    while (d := n_docs - int(sizes.sum())) != 0:
        i = rng.integers(1, n_queries, abs(d))
        np.add.at(sizes, i, np.sign(d))
        sizes[1:] = np.clip(sizes[1:], 1, longest - 1)
    return sizes


def mslr_like(n_queries: int, n_docs: int, seed: int):
    """MS LTR-shaped data: query lengths as mslr_sizes (the longest
    MSLR_LONGEST), MSLR_FEATURES dense float32 features, and labels 0-4 at
    MSLR_LABEL_SHARES cut from a noisy function of five features. Returns
    (X, y, group)."""
    rng = np.random.default_rng(seed)
    sizes = mslr_sizes(rng, n_queries, n_docs, MSLR_LONGEST)
    X = rng.standard_normal((n_docs, MSLR_FEATURES), dtype=np.float32)
    z = (0.9 * X[:, 0] + 0.7 * X[:, 1] * X[:, 2] - 0.5 * X[:, 3] ** 2
         + 0.6 * np.sin(2.0 * X[:, 4]) + rng.standard_normal(n_docs))
    cuts = np.quantile(z, np.cumsum(MSLR_LABEL_SHARES)[:-1])
    y = np.searchsorted(cuts, z, side="right").astype(np.float64)
    return X, y, sizes


_rank_cache = {}


def rank_datasets(lgb, seed: int):
    """train_rank's data on the card, made once: the MS LTR-shaped train
    set (MSLR_DOCS documents in MSLR_QUERIES queries) and the valid set
    (MSLR_VALID_QUERIES more queries), binned by the package's Dataset.
    Returns (train, valid, Xv, seconds to make, seconds to construct)."""
    if seed not in _rank_cache:
        t0 = time.time()
        X, y, g = mslr_like(MSLR_QUERIES, MSLR_DOCS, seed + 37)
        nv = MSLR_VALID_QUERIES * (MSLR_DOCS // MSLR_QUERIES)
        Xv, yv, gv = mslr_like(MSLR_VALID_QUERIES, nv, seed + 41)
        t_data = time.time() - t0
        params = dict(RANK_PARAMS, device_type="cuda")
        train = lgb.Dataset(X, label=y, group=g, params=params)
        valid = lgb.Dataset(Xv, label=yv, group=gv, reference=train)
        t0 = time.time()
        train.construct()
        valid.construct()
        torch.cuda.synchronize()
        zero_share = float((X == 0).mean(axis=0).max())
        _rank_cache[seed] = (train, valid, Xv, t_data, time.time() - t0,
                             zero_share)
    return _rank_cache[seed]


# the kernel's edge layouts: query sizes, what the labels and scores hold,
# and the parameters
RANK_LAYOUTS = {
    "mixed": ([1, 7, 12, 1, 5, 9, 3, 20, 300, 1251], "random", {}),
    "trunc3": ([1, 7, 12, 1, 5, 9, 3, 20, 300], "random",
               {"lambdarank_truncation_level": 3}),
    "trunc_above_n": ([4, 30, 129, 2], "random",
                      {"lambdarank_truncation_level": 5000}),
    "all_tied": ([1, 7, 12, 200], "tied", {}),
    "labels_all_0": ([3, 7, 40], "zero_labels", {}),
    "no_norm_sigmoid2": ([5, 64, 130], "random",
                         {"lambdarank_norm": False, "sigmoid": 2.0}),
    # a query past the kernel's partner tile of 256 documents (its top
    # walks tile through, its other documents read partners from global
    # memory) and past 32 x trunc
    "longer_than_tile": ([2100, 1, 7, 40, 1251], "random", {}),
}


def admitted_pairs(obj, score) -> int:
    """The pairs the truncation admits on this score: pairs of a query with
    one document at least ranked above the truncation level and unequal
    labels (each counted once)."""
    from lightgbm_tpu_torch.ops import rank
    lay = obj.layout
    r, _ = rank.doc_ranks(score, lay)
    top = (r < obj.truncation_level).to(torch.int64)
    lab = obj.label.to(torch.int64).clamp(0, 31)
    q = lay.num_queries
    cnt = torch.zeros((2, q, 32), dtype=torch.int64, device=score.device)
    cnt.index_put_((top, lay.qid, lab), torch.ones_like(lab),
                   accumulate=True)
    rest, tops = cnt[0], cnt[1]
    t, n = tops.sum(1), tops.sum(1) + rest.sum(1)
    pairs = t * (t - 1) // 2 + t * (n - t) \
        - (tops * (tops - 1) // 2).sum(1) - (tops * rest).sum(1)
    return int(pairs.sum())


def rank_kernel_case(cuda_hist, obj, score, timed=False):
    """lambdarank_grads on one layout: the kernel bitwise its plain version
    in the kernel's order (lambdarank_grads_exact) on the card, two
    launches equal, the JAX-order plain version (chunked on the card)
    within RANK_TOL of the largest magnitude; with ``timed``, the times
    and the bound."""
    from lightgbm_tpu_torch.ops import rank
    args = (score, obj.label, obj.gain, obj.inv_max_dcg, obj.layout,
            obj.sigmoid, obj.truncation_level, obj.norm)
    k = rank.lambdarank_grads(*args)
    k2 = rank.lambdarank_grads(*args)
    e = rank.lambdarank_grads_exact(*args)
    p = rank.lambdarank_grads_plain(*args)
    torch.cuda.synchronize()
    for a, b, what in ((k, k2, "a second launch"), (k, e, "its plain "
                       "version in the kernel's order")):
        for x, y in zip(a, b):
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise AssertionError(f"lambdarank_grads is not bitwise "
                                     f"equal to {what}")
    err = max(float((x - y).abs().max()) for x, y in zip(k, p))
    scale = max(float(y.abs().max()) for y in p)
    if err > RANK_TOL * scale:
        raise AssertionError(f"lambdarank_grads differs from the JAX-order "
                             f"plain version by {err} (scale {scale})")
    out = {"queries": obj.layout.num_queries, "docs": obj.layout.num_data,
           "longest": int(np.diff(obj.layout.bounds_np).max()),
           "bitwise_vs_exact": True, "deterministic": True,
           "max_abs_err_vs_plain": err, "plain_scale": scale,
           "tolerance": RANK_TOL}
    if timed:
        out["ms"] = time_ms(lambda: rank.lambdarank_grads(*args))
        out["device_ms"], out["device_split"] = device_ms(
            lambda: rank.lambdarank_grads(*args))
        out["plain_ms"] = time_ms(lambda: rank.lambdarank_grads_plain(*args),
                                  reps=1, warm=0)
        out["exact_ms"] = time_ms(lambda: rank.lambdarank_grads_exact(*args),
                                  reps=1, warm=0)
        pairs = admitted_pairs(obj, score)
        n, q = obj.layout.num_data, obj.layout.num_queries
        # least traffic: score, label, gain in, lambda and hessian out, the
        # inverse max DCG and the query boundaries
        out["pairs_admitted"] = pairs
        out["bound_ms"], out["bound_by"] = bound(20 * n + 8 * q + 4,
                                                 RANK_PAIR_OPS * pairs)
        out["library_ms"] = None
    return out


def rank_kernel_phase(lgb, cuda_hist, args):
    """lambdarank_grads at train_rank's query layout and labels (scores
    N(0, 1)), timed, and at the edge layouts."""
    from lightgbm_tpu_torch import ranking
    from lightgbm_tpu_torch.config import Config
    train = rank_datasets(lgb, args.seed)[0]
    cfg = Config.from_params(dict(RANK_PARAMS, device_type="cuda"))
    obj = ranking.create_ranking_objective(cfg)
    obj.init(train.get_label(), None, train.get_group(), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed + 43)
    score = torch.randn(train.num_data, generator=g, device="cuda")
    out = {"train_rank_layout": rank_kernel_case(cuda_hist, obj, score,
                                                 timed=True)}
    for name, (groups, kind, extra) in RANK_LAYOUTS.items():
        rng = np.random.RandomState(len(out))
        n = int(np.sum(groups))
        label = rng.randint(0, 5, size=n).astype(np.float64)
        sc = rng.normal(size=n).astype(np.float32)
        if kind == "tied":
            sc[:] = 0.25
        if kind == "zero_labels":
            label[:] = 0.0
        cfg = Config.from_params(dict(RANK_PARAMS, device_type="cuda",
                                      **extra))
        o = ranking.create_ranking_objective(cfg)
        o.init(label, None, groups, device="cuda")
        out[name] = rank_kernel_case(cuda_hist, o,
                                     torch.from_numpy(sc).cuda())
    return out


def rank_entry(rk, launches):
    """The kernels line's entry of lambdarank_grads: train_rank's layout's
    numbers (the wrapper's ms and device ms, the kernel's device ms),
    ``launches`` the train_rank run's counts."""
    main = rk["train_rank_layout"]
    return {
        "name": "lambdarank_grads", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/lambdarank.cu",
        "replaces": "none, a port-only kernel: lightgbm_tpu/ranking.py:158 "
                    "LambdarankNDCG._padded_grads + :111 _scatter_grads "
                    "are plain jnp (no pallas_call)",
        "launches": launches["lambdarank_grads.launches"],
        "max_abs_err": max(v["max_abs_err_vs_plain"] for v in rk.values()),
        "tolerance_of_plain_scale": RANK_TOL,
        "ms": main["ms"], "device_ms": main["device_ms"],
        "kernel_device_ms": main["device_split"].get("lambdarank_kernel",
                                                     "not measured"),
        **{k: main[k] for k in ("plain_ms", "exact_ms", "bound_ms",
                                "bound_by", "pairs_admitted")},
        "library_ms": None}


def hist_rank_phase(lgb, cuda_hist, args):
    """hist_tile and split_epilogue at train_rank's width, F = 136, the
    widest a training path gives them (feature groups, the row-major bin
    copy's width and the epilogue's grid change there): the root pass on
    train_rank's own bins and on uniform ones, the gather form at the
    N/2 rung, f32 and q8; the epilogue at P=42, F=136, B=255, f32 and q8,
    bitwise its plain version and a second launch."""
    train = rank_datasets(lgb, args.seed)[0]
    n, f = train.num_data, train.binsT.shape[0]
    if f != MSLR_FEATURES:
        raise AssertionError(f"train_rank's bins have {f} features")
    m = ladder_rungs(n)[1]
    out = {"n": n, "f": f,
           "root": {"mslr": hist_phase(cuda_hist, n, f=f, root=True,
                                       seed=61, bins=train.binsT),
                    "uniform": hist_phase(cuda_hist, n, f=f, root=True,
                                          seed=62)},
           "rung": {str(m): hist_phase(cuda_hist, n, m=m, f=f, seed=63)},
           "q8_root": {"mslr": hist_q8_phase(cuda_hist, n, f=f, root=True,
                                             seed=64, bins=train.binsT)},
           "q8_rung": {str(m): hist_q8_phase(cuda_hist, n, m=m, f=f,
                                             seed=65)}}
    for q8 in (False, True):
        a = epilogue_inputs(cuda_hist, seed=66, q8=q8, f=f)
        kf, kc = cuda_hist.split_epilogue(*a)
        kf2, kc2 = cuda_hist.split_epilogue(*a)
        pf, pc = cuda_hist.split_epilogue_plain(*a)
        torch.cuda.synchronize()
        for x, y in ((kc, pc), (kf, pf), (kc, kc2), (kf, kf2)):
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                raise AssertionError(f"split_epilogue at F={f} (q8 {q8}) is "
                                     f"not bitwise its plain version and a "
                                     f"second launch")
        bms, by = epilogue_bound(a[2], q8=q8, f=f)
        out["epilogue_q8" if q8 else "epilogue"] = {
            "bitwise_vs_plain": True, "deterministic": True,
            "valid_candidates": int(torch.isfinite(kc[..., 0]).sum()),
            "ms": time_ms(lambda: cuda_hist.split_epilogue(*a)),
            "plain_ms": time_ms(lambda: cuda_hist.split_epilogue_plain(*a),
                                reps=3, warm=1),
            "bound_ms": bms, "bound_by": by}
    return out


def train_rank_phase(lgb, cuda_hist, args, objective="lambdarank"):
    """Learning to rank at MS LTR width (rank_datasets; 255 leaves, max_bin
    255, lr 0.1, eval_at 1, 3, 5, 10, --rounds rounds; the fused path):
    sec/iter, valid NDCG@k against NDCG@10 of random scores on the same
    set, the kernels' launches (lambdarank_grads once an iteration for
    lambdarank, never for rank_xendcg), peak device memory, the host time
    of the objective and of the NDCG evaluation, and one profiled
    iteration."""
    from lightgbm_tpu_torch.ops import rank
    from lightgbm_tpu_torch.ranking import NDCGMetric
    train, valid, Xv, t_data, t_construct, zero_share = \
        rank_datasets(lgb, args.seed)
    params = dict(RANK_PARAMS, objective=objective, device_type="cuda",
                  seed=args.seed)
    evals = {}
    cuda_hist.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    booster = lgb.train(params, train, args.rounds, valid_sets=[valid],
                        valid_names=["valid"], evals_result=evals)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_hist.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gb = booster._boosting
    ndcg = {k: v[-1] for k, v in evals["valid"].items()}
    rnd = NDCGMetric(gb.config)
    rnd.init(valid.get_label(), None, valid.get_group())
    random_ndcg = rnd.eval(np.random.default_rng(args.seed + 47)
                           .standard_normal(valid.num_data))
    pred = booster.predict(Xv)

    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            times.append((time.time() - t) * 1e3)
        return statistics.median(times)

    out = {"objective": objective, "docs": train.num_data,
           "queries": len(train.get_group()),
           "longest_query": int(train.get_group().max()),
           "valid_docs": valid.num_data,
           "valid_queries": len(valid.get_group()),
           "features": MSLR_FEATURES, "rounds": args.rounds,
           "sec_per_iter": wall / args.rounds, "train_wall_s": wall,
           "data_s": t_data, "construct_s": t_construct,
           "column_zero_share_max": zero_share,
           "sparse_columns": len(train.sp_cols) if train.has_sparse_cols
           else 0,
           "valid_ndcg": ndcg, "random_score_valid_ndcg@10": random_ndcg[-1],
           "max_memory_allocated_bytes": peak,
           "pair_tensor_bytes_jax_layout": 4 * len(train.get_group())
           * gb.objective.padding.m ** 2,
           "objective_host_ms": host_ms(
               lambda: gb.objective.get_grad_hess(gb.train_score)),
           "ndcg_eval_host_ms": host_ms(booster.eval_valid),
           "launches": launches, "trees": booster.num_trees(),
           "split_path": "fused" if gb._split_fusion_on() else "classic"}
    # one-time host work: the objective's padding plan and per-query
    # inverse max DCG, the NDCG metric's per-query inverse max DCG@k
    from lightgbm_tpu_torch.objectives import create_objective
    t = time.time()
    create_objective(gb.config).init(train.get_label(), None,
                                     train.get_group(), device="cuda")
    torch.cuda.synchronize()
    out["objective_init_host_ms"] = (time.time() - t) * 1e3
    t = time.time()
    NDCGMetric(gb.config).init(valid.get_label(), None, valid.get_group())
    out["ndcg_init_host_ms"] = (time.time() - t) * 1e3
    if objective == "rank_xendcg":
        shape = tuple(gb.objective.q_mask.shape)
        out["gamma_draw_host_ms"] = host_ms(
            lambda: np.random.RandomState(0).uniform(size=shape)
            .astype(np.float32))
    expect = args.rounds if objective == "lambdarank" else 0
    gather = launches["hist_tile.gather_launches"]
    if launches["lambdarank_grads.launches"] != expect or gather <= 0 \
            or launches["hist_tile.launches"] - gather <= 0 \
            or launches["split_epilogue.launches"] <= 0 \
            or launches["hist_tile.launches_plane"] \
            or out["split_path"] != "fused":
        raise AssertionError(f"{objective}: the run missed a kernel or left "
                             f"the fused path: {launches}")
    if not (ndcg["ndcg@10"] > random_ndcg[-1]
            and np.all(np.isfinite(pred)) and pred.shape == (valid.num_data,)
            and peak < out["pair_tensor_bytes_jax_layout"] / 10):
        raise AssertionError(f"{objective}: output {out}")
    out["profile"] = profile_iteration(booster, wall / args.rounds)
    return out, launches


# parity_rank's runs: name -> parameters over RANK_PARAMS at 63 leaves,
# and whether the documents carry weights and an init_score; each trains
# PARITY_ROUNDS rounds on PARITY_ROWS documents of MS LTR-shaped queries
# rounds of the ranking parity runs: 1, cut from PARITY_ROUNDS to 2 and,
# when the training-control phases came in, to 1, to keep the whole script
# near 800 s (their CPU runs are the costly part; the weighted run's
# init_score still starts its tree from a ranked score)
PARITY_RANK_ROUNDS = 1
# parity_rank's documents: a quarter of PARITY_ROWS, to keep the whole
# script well inside its limit on a slower host (the CPU runs are the
# costly part)
PARITY_RANK_ROWS = 12_500
PARITY_RANK = {
    "lambdarank": ({}, False),
    "lambdarank_q8": ({"quantized_grad": True}, False),
    "rank_xendcg": ({"objective": "rank_xendcg"}, False),
    "lambdarank_weighted": ({"label_gain": [0, 1, 3, 7, 15]}, True),
}


def _parity_rank(lgb, name, seed):
    """One PARITY_RANK training twice on the card and twice on the CPU:
    with the kernels' orders (kernel_sums_on_cpu: hist_tile's fixed-point
    sums in f32, lambdarank_grads' partner order) and with the JAX
    package's (float32 index_add_ sums, the JAX-order pair sums). The two
    card runs and the kernel-order CPU run must give the same model text;
    against the JAX-order run, equal text or the first tree whose
    structure differs and the leaf error before it."""
    from lightgbm_tpu_torch.io.model_text import load_model
    from lightgbm_tpu_torch.ops import cuda_hist
    extra, weighted = PARITY_RANK[name]
    n_queries = PARITY_RANK_ROWS // (MSLR_DOCS // MSLR_QUERIES)
    X, y, g = mslr_like(n_queries, PARITY_RANK_ROWS, seed + 53)
    kw = {"group": g}
    if weighted:
        rng = np.random.default_rng(seed + 59)
        kw.update(weight=rng.uniform(0.5, 2.0, PARITY_RANK_ROWS),
                  init_score=rng.standard_normal(PARITY_RANK_ROWS) * 0.1)
    params = dict(RANK_PARAMS, num_leaves=63, seed=seed, **extra)
    setup = (X, y, params, kw)
    texts = {}
    for run in ("cuda", "cuda_again", "cpu_kernel_order", "cpu"):
        with (cuda_hist.kernel_sums_on_cpu() if run == "cpu_kernel_order"
              else contextlib.nullcontext()):
            texts[run] = parity_text(lgb, setup, run.split("_")[0],
                                     PARITY_RANK_ROUNDS)
    sc, sp = _structure(texts["cuda"]), _structure(texts["cpu"])
    diverge = next((i for i, (a, b) in enumerate(zip(sc, sp)) if a != b),
                   None if len(sc) == len(sp) else min(len(sc), len(sp)))
    tc, tp = load_model(texts["cuda"]).trees, load_model(texts["cpu"]).trees
    upto = len(tc) if diverge is None else diverge
    leaf_err = max([float(np.abs(a.leaf_value - b.leaf_value).max())
                    for a, b in zip(tc[:upto], tp[:upto])] or [0.0])
    out = {"params": extra, "weight_and_init_score": weighted,
           "queries": len(g), "longest": int(g.max()),
           "trees": len(tc),
           "card_runs_identical_text": texts["cuda"] == texts["cuda_again"],
           "card_equals_cpu_kernel_order": texts["cuda"]
           == texts["cpu_kernel_order"],
           "card_equals_cpu_jax_order": texts["cuda"] == texts["cpu"],
           "first_divergent_tree_vs_jax_order": diverge,
           "max_leaf_abs_err_before_divergence": leaf_err,
           "card_text_sha256": _sha(texts["cuda"])}
    if not (out["card_runs_identical_text"]
            and out["card_equals_cpu_kernel_order"]):
        raise AssertionError(f"{name}: card vs CPU disagree: {out}")
    return out


def parity_rank_phase(lgb, seed):
    return {"docs": PARITY_RANK_ROWS, "num_leaves": 63,
            "rounds": PARITY_RANK_ROUNDS,
            **{m: _parity_rank(lgb, m, seed) for m in PARITY_RANK}}


VARIANT_RTOL = 1e-5     # of each cell's summed magnitudes (products exact)


def hist_variants_phase(cuda_hist):
    """Kernel 5 through its entry point, the experiment script's main at
    its defaults; then each variant's output against hist_onehot_plain on
    the same data, and the kernel, plain and library times."""
    from lightgbm_tpu_torch.scripts import exp_hist_variants as ev
    cuda_hist.reset_launch_counts()
    # a variant that fails makes main raise (VariantsFailed) after its loop
    results, (binsT, rhs) = ev.main(["--reps", "5"])
    launches = cuda_hist.hist_onehot.launches
    if launches <= 0:
        raise AssertionError(f"hist_variants: {launches} launches")
    f, n = binsT.shape
    b = 255
    plain = cuda_hist.hist_onehot_plain(binsT, rhs, b)
    mag = cuda_hist.hist_onehot_plain(binsT, rhs.abs(), b)
    torch.cuda.synchronize()
    variants = {}
    for r in results:
        out = r.pop("out")
        diff = (out - plain).abs()
        bad = diff > VARIANT_RTOL * mag
        if bool(bad.any()):
            raise AssertionError(f"hist_onehot fg={r['fg']} blk={r['blk']} "
                                 f"disagrees with its plain version at "
                                 f"{int(bad.sum())} cells")
        rel = float((diff / mag.clamp_min(1e-30)).max())
        binsT_p, rhs_p = ev.pad_rows(binsT, rhs, r["blk"])
        call = lambda: cuda_hist.hist_onehot(binsT_p, rhs_p, b, r["fg"],
                                             r["blk"])
        again = call()
        torch.cuda.synchronize()
        if not torch.equal(again.view(torch.int32), out.view(torch.int32)):
            raise AssertionError(f"two hist_onehot launches of fg={r['fg']} "
                                 f"blk={r['blk']} differ")
        variants[f"{r['fg']}x{r['blk']}"] = {
            "ms": time_ms(call, reps=5, warm=1),
            "device_ms": device_ms(call, reps=5,
                                   need="hist_onehot_kernel")[0],
            "script_ms_per_pass": r["ms_per_pass"],
            "max_abs_err": float(diff.max()), "max_rel_err": rel,
            "deterministic": True}
        del binsT_p, rhs_p, again, out
    best = min(variants, key=lambda k: variants[k]["ms"])
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


# ------------------------------------------------------- split constraints
# the monotone directions of train_mono: +1 on three Higgs-shaped
# features, -1 on three (higgs_like's label rises with 21 and 9, falls
# with 24 and 26)
MONO = {21: 1, 9: 1, 23: 1, 24: -1, 26: -1, 27: -1}
MONO_LIST = [MONO.get(j, 0) for j in range(28)]
MONO_OPS = 24          # the monotone mode's further operations a bin: two
                       # clips a side and the direction test, both scans
SWEEP_ROWS, SWEEP_POINTS = 1_000, 60
# train_mono_modes' and train_constraints' rounds: 1, cut from 3 to 2 when
# the data layer's phases came in and to 1 with the precision modes', to
# keep the whole script near its earlier length (the exact modes' 254
# searches a tree are the costly part)
CONSTRAINED_ROUNDS = 1
                         # (the exact modes grow one split a phase)


def epilogue_mono_inputs(cuda_hist, binsT, q8: bool, seed: int):
    """The monotone mode's arguments at P=42, B=255 on tiles of real bins:
    the first 400,000 rows of ``binsT`` (F = its features), random stats
    (f32: grad N(0,1), hess U(0,1); q8: int8 with a non-trivial q_scale),
    leaf p at slot p, the odd slots derived (parent = both siblings'
    planes). Slot 2's rows have a constant hessian and the first monotone
    feature (+1) binned by their gradient, so that every candidate of that
    plane breaks the direction; slot 0 has leaf_min == leaf_max; the other
    slots a window around their output a quarter as wide as their
    children's spread (open, unconstrained bounds on slots 1 and 3). The
    directions are MONO's on the Higgs width (F = 28) and the same pattern
    repeated at F = 136. Returns (args without q_scale, q_scale or None,
    the violating feature)."""
    f = binsT.shape[0]
    n = min(400_000, binsT.shape[1])
    g = torch.Generator(device="cuda").manual_seed(seed)
    bins = binsT[:, :n].clone()
    leaf = torch.randint(0, P, (n,), generator=g, device="cuda",
                         dtype=torch.int32)
    if q8:
        stats = torch.stack([
            torch.randint(-127, 128, (n,), generator=g, device="cuda"),
            torch.randint(1, 128, (n,), generator=g, device="cuda"),
            torch.ones(n, device="cuda")], 1).to(torch.int8)
        q_scale = torch.tensor([0.0173, 0.00291, 1.0], device="cuda")
    else:
        stats = torch.stack([
            torch.randn(n, generator=g, device="cuda"),
            torch.rand(n, generator=g, device="cuda"),
            torch.ones(n, device="cuda")], 1)
        q_scale = None
    mono = torch.tensor([MONO_LIST[j % 28] for j in range(f)],
                        dtype=torch.int32)
    vf = int(torch.nonzero(mono > 0)[0])
    rows = torch.nonzero(leaf == 2)[:, 0]
    stats[rows, 1] = 64 if q8 else 0.5
    order = torch.argsort(stats[rows, 0].to(torch.float32), stable=True)
    nb = int(bins[vf].max()) + 1
    bins[vf, rows[order]] = (torch.arange(len(rows), device="cuda") * nb
                             // len(rows)).to(torch.uint8)
    sel = torch.arange(P, dtype=torch.int32)
    planes = cuda_hist.hist_tile(bins, leaf, stats.contiguous(),
                                 cuda_hist.chan_leaf_table(sel.cuda()), P, B,
                                 P)
    full = planes.to(torch.float32) * (q_scale if q8 else 1.0)
    derive = torch.zeros(P, dtype=torch.bool)
    derive[1::2] = True
    dcu = derive.cuda()[:, None, None, None]
    tile = torch.where(dcu, torch.zeros_like(planes), planes).contiguous()
    parent = torch.where(dcu, full + torch.cat([full[:1] * 0, full[:-1]]),
                         torch.zeros_like(full)).contiguous()
    s = full[:, 0].sum(1)
    out = -s[:, 0] / (s[:, 1] + 1.0)
    csum = full[:, 1].cumsum(1)
    child = -csum[..., 0] / (csum[..., 1] + 1.0)
    w = 0.125 * (child - out[:, None]).abs().median(1).values
    big = float(np.finfo(np.float32).max)
    lmin, lmax = out - w, out + w
    lmin[0] = lmax[0] = out[0]
    lmin[[1, 3]], lmax[[1, 3]] = -big, big
    la = cuda_hist.pack_leaf_aux(s[:, 0], s[:, 1], s[:, 2], out, lmin,
                                 lmax).cuda()
    mt = torch.zeros(f, dtype=torch.int32)
    fm = cuda_hist.pack_feature_meta(
        torch.full((f,), B, dtype=torch.int32), mt, mt, mono).cuda()
    pv = torch.tensor([0.0, 1.0, 0.0, 0.0, 20.0, 1e-3, 0.0, 0.0],
                      device="cuda")
    der = cuda_hist._epilogue_lanes(sel, derive).cuda()
    return (tile, parent, der, la, fm, pv), q_scale, vf


def epilogue_mono_case(cuda_hist, binsT, q8: bool, seed: int):
    """One width and mode of the monotone epilogue: bitwise its plain
    version and a second launch; clipping changes some (slot, feature)'s
    winner and the violating plane has no candidate; ms and device ms
    beside the unconstrained mode's on the same inputs (timed in turns:
    free, mono, mono, free), the plain version's ms and the bound."""
    args, q_scale, vf = epilogue_mono_inputs(cuda_hist, binsT, q8, seed)
    a = args + (q_scale,)
    kf, kc = cuda_hist.split_epilogue(*a, with_monotone=True)
    kf2, kc2 = cuda_hist.split_epilogue(*a, with_monotone=True)
    pf, pc = cuda_hist.split_epilogue_plain(*a, with_monotone=True)
    _, free = cuda_hist.split_epilogue(*a)
    torch.cuda.synchronize()
    for x, y in ((kc, pc), (kf, pf), (kc, kc2), (kf, kf2)):
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError(
                f"split_epilogue's monotone mode (F={binsT.shape[0]}, q8 "
                f"{q8}) is not bitwise its plain version and a second "
                f"launch")
    changed = int((free[..., 1:3] != kc[..., 1:3]).any(-1).sum())
    if changed == 0 or torch.isfinite(kc[2, vf, 0]) or \
            not torch.isfinite(free[2, vf, 0]):
        raise AssertionError(f"the bounds changed no winner ({changed}) or "
                             f"the violating plane kept a candidate")
    turns = {"free": [], "mono": []}
    for mode in ("free", "mono", "mono", "free"):
        turns[mode].append(time_ms(lambda: cuda_hist.split_epilogue(
            *a, with_monotone=mode == "mono")))
    dev = {m: device_ms(lambda: cuda_hist.split_epilogue(
        *a, with_monotone=m == "mono"), per_profile=EPI_LAUNCHES,
        need="split_epilogue", cold_each=True)[0] for m in ("free", "mono")}
    bms, by = epilogue_bound(args[2], q8=q8, f=binsT.shape[0], mono=True)
    return {"max_abs_err": float((kc - pc).nan_to_num(0.0).abs().max()),
            "deterministic": True, "winners_changed": changed,
            "valid_candidates": int(torch.isfinite(kc[..., 0]).sum()),
            "ms": statistics.median(turns["mono"]),
            "free_ms": statistics.median(turns["free"]), "turns_ms": turns,
            "device_ms": dev["mono"], "free_device_ms": dev["free"],
            "device_ms_launches": EPI_LAUNCHES,
            "plain_ms": time_ms(lambda: cuda_hist.split_epilogue_plain(
                *a, with_monotone=True), reps=5, warm=1),
            "library_ms": None, "bound_ms": bms, "bound_by": by}


def epilogue_mono_phase(lgb, cuda_hist, args, higgs_bins):
    """split_epilogue's monotone mode at F = 28 (the Higgs-shaped train
    bins) and F = 136 (train_rank's MS LTR-shaped bins), f32 and q8."""
    mslr = rank_datasets(lgb, args.seed)[0].binsT
    return {f"f{b.shape[0]}{'_q8' if q8 else ''}":
            epilogue_mono_case(cuda_hist, b, q8, 70 + i)
            for i, (b, q8) in enumerate(itertools.product(
                (higgs_bins, mslr), (False, True)))}


_higgs_cache = {}


def higgs_rows(args):
    """train's Higgs-shaped rows (train, valid), made once a run."""
    key = (args.rows, args.valid_rows, args.seed)
    if key not in _higgs_cache:
        X, y = higgs_like(args.rows + args.valid_rows, args.seed)
        _higgs_cache.clear()
        _higgs_cache[key] = (X[:args.rows], y[:args.rows], X[args.rows:],
                             y[args.rows:])
    return _higgs_cache[key]


def sweep_violations(booster, Xv, directions, seed):
    """The monotonicity sweep (the JAX package's tests/test_constraints.py
    sweep, at scale): SWEEP_ROWS valid rows, each constrained feature set
    to SWEEP_POINTS values across its range in turn; the count of steps
    that go against the direction. Float64 sums of float32 leaf values in
    tree order keep a monotone model exactly monotone, so the bar is 0."""
    rng = np.random.RandomState(seed)
    base = Xv[rng.choice(len(Xv), SWEEP_ROWS, replace=False)]
    bad = 0
    for j, d in directions.items():
        grid = np.linspace(Xv[:, j].min(), Xv[:, j].max(), SWEEP_POINTS,
                           dtype=np.float32)
        Xs = np.repeat(base, SWEEP_POINTS, axis=0)
        Xs[:, j] = np.tile(grid, SWEEP_ROWS)
        pred = booster.predict(Xs, raw_score=True).reshape(SWEEP_ROWS,
                                                           SWEEP_POINTS)
        bad += int((np.diff(pred, axis=1) * d < 0).sum())
    return bad


def constrained_train(lgb, cuda_hist, args, extra, rounds, profile=False):
    """One training on train's rows with ``extra`` parameters, the launch
    counts read from 0 around it: (booster, summary, launches);
    ``profile``: one more iteration profiled (profile_iteration)."""
    X, y, Xv, yv = higgs_rows(args)
    params = dict(PARAMS, device_type="cuda", **extra)
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
    booster = lgb.train(params, train, rounds, valid_sets=[valid],
                        valid_names=["valid"], evals_result=evals)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_hist.launch_counts()
    out = {"params": extra, "rows": args.rows, "rounds": rounds,
           "sec_per_iter": wall / rounds, "construct_s": t_construct,
           "valid_auc": evals["valid"]["auc"][-1],
           "split_fusion": booster._boosting._split_fusion_on(),
           "trees": booster.num_trees(),
           "leaves_last_tree": booster._boosting.host_trees[-1].num_leaves,
           "launches": {k: v for k, v in launches.items() if v}}
    if not out["valid_auc"] > 0.6:
        raise AssertionError(f"valid AUC {out['valid_auc']}: {out}")
    if profile:
        out["profile"] = profile_iteration(booster, wall / rounds)
    return booster, out, launches


def train_mono_phase(lgb, cuda_hist, args, ref_auc, q8=False):
    """Basic monotone constraints on train's 2M Higgs-shaped rows (255
    leaves, --rounds rounds, the fused path): sec/iter, valid AUC beside
    the unconstrained train run's, the monotone epilogue's launches (> 0)
    and the unconstrained mode's (0), one profiled iteration, and the
    monotonicity sweep (0 violations)."""
    extra = {"monotone_constraints": MONO_LIST, "quantized_grad": q8}
    booster, out, launches = constrained_train(lgb, cuda_hist, args, extra,
                                               args.rounds, profile=True)
    sfx = "_q8" if q8 else ""
    out["unconstrained_valid_auc"] = ref_auc
    out["split_epilogue_mono_launches"] = \
        launches["split_epilogue.launches_mono" + sfx]
    out["split_epilogue_free_launches"] = \
        launches["split_epilogue.launches" + sfx]
    out["sweep_violations"] = sweep_violations(
        booster, higgs_rows(args)[2], MONO, args.seed + 5)
    if not (out["split_fusion"] and out["split_epilogue_mono_launches"] > 0
            and out["split_epilogue_free_launches"] == 0
            and launches["hist_tile.launches" + sfx] > 0
            and out["sweep_violations"] == 0):
        raise AssertionError(f"train_mono{sfx}: {out}")
    return out, launches


def _timed(module, name, acc):
    """Wrap ``module.name`` so that each call's wall time (to the device's
    end) adds to ``acc[name]``; returns the original."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        t0 = time.time()
        res = fn(*a, **k)
        torch.cuda.synchronize()
        acc.setdefault(name, []).append(time.time() - t0)
        return res
    setattr(module, name, wrapped)
    return fn


MODES_WINDOW = 16     # phases of train_mono_modes' profiled window


def window_profile(booster, grower, phases: int = MODES_WINDOW):
    """Device busy against wall time over ``phases`` consecutive phases
    (from one split search to the one ``phases`` later) of one more
    iteration: torch.profiler over the window only, since a whole
    iteration of exact growth (~100,000 launches) takes the profiler
    minutes."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    search = grower.Grower.split_search
    state = {"n": 0}

    def hooked(self, st):
        if state["n"] == 0:
            torch.cuda.synchronize()
            prof.start()
            state["t0"] = time.time()
        res = search(self, st)
        state["n"] += 1
        if state["n"] == phases + 1:
            torch.cuda.synchronize()
            state["wall"] = time.time() - state["t0"]
            prof.stop()
        return res
    grower.Grower.split_search = hooked
    try:
        booster.update()
    finally:
        grower.Grower.split_search = search
    if "wall" not in state:            # a tree of fewer phases than asked
        torch.cuda.synchronize()
        state["wall"] = time.time() - state["t0"]
        prof.stop()
        phases = state["n"]
    busy = sum(_device_us(ev) for ev in prof.key_averages()) / 1e3
    wall_ms = state["wall"] * 1e3
    return {"phases": phases, "wall_ms_per_phase": wall_ms / phases,
            "device_busy_ms_per_phase": (busy / phases if busy > 0
                                         else "not measured"),
            "device_idle_share": (max(0.0, 1 - busy / wall_ms) if busy > 0
                                  else "not measured")}


def train_mono_modes_phase(lgb, cuda_hist, args, rounds):
    """The intermediate and advanced monotone modes on train's rows (255
    leaves, ``rounds`` rounds; the classic path with one split a phase):
    sec/iter, split searches a tree, valid AUC, the sweep's violations
    (0), the host time a phase of intermediate_bounds and
    advanced_child_bounds (to the device's end), and the device's busy
    share over a window of MODES_WINDOW phases of one more iteration."""
    from lightgbm_tpu_torch.models import grower
    out = {}
    for mode in ("intermediate", "advanced"):
        acc = {}
        saved = {n: _timed(grower, n, acc) for n in
                 ("intermediate_bounds", "advanced_child_bounds")}
        search = grower.Grower.split_search
        calls = []

        def counted(self, st, _s=search):
            calls.append(1)
            return _s(self, st)
        grower.Grower.split_search = counted
        try:
            booster, res, _ = constrained_train(
                lgb, cuda_hist, args, {
                    "monotone_constraints": MONO_LIST,
                    "monotone_constraints_method": mode}, rounds)
        finally:
            grower.Grower.split_search = search
            for n, fn in saved.items():
                setattr(grower, n, fn)
        res["searches_per_tree"] = len(calls) / rounds
        res["window"] = window_profile(booster, grower)
        res["bounds_ms_per_phase"] = {
            n: 1e3 * statistics.mean(v) for n, v in acc.items()}
        res["sweep_violations"] = sweep_violations(
            booster, higgs_rows(args)[2], MONO, args.seed + 6)
        if res["split_fusion"] or res["sweep_violations"] or \
                res["launches"].get("split_epilogue.launches_mono"):
            raise AssertionError(f"train_mono_modes/{mode}: {res}")
        out[mode] = res
    return out


# three groups of the Higgs-shaped features for the interaction run
GROUPS = [list(range(0, 9)) + [21, 22], list(range(9, 18)) + [23, 24],
          list(range(18, 21)) + [25, 26, 27]]
CONTRI_ZERO = 21          # the feature feature_contri turns off


def _path_features(tree):
    """Each leaf's set of split features on its path, of a loaded tree."""
    out = []

    def walk(node, feats):
        if node < 0:
            out.append(feats)
            return
        f = int(tree.split_feature[node])
        walk(int(tree.left_child[node]), feats | {f})
        walk(int(tree.right_child[node]), feats | {f})
    if tree.num_leaves > 1:
        walk(0, frozenset())
    else:
        out.append(frozenset())
    return out


def train_constraints_phase(lgb, cuda_hist, args, rounds):
    """On train's rows, ``rounds`` rounds each: interaction constraints of
    three groups (the fused path; no tree path may use features of two
    groups), feature_contri with a 0 (the classic path; the feature is
    never split on), extra_trees and feature_fraction_bynode 0.5:
    sec/iter and valid AUC."""
    from lightgbm_tpu_torch.io.model_text import load_model
    contri = [1.0] * 28
    contri[CONTRI_ZERO] = 0.0
    runs = {"interactions": {"interaction_constraints": GROUPS},
            "contri_zero": {"feature_contri": contri},
            "extra_trees": {"extra_trees": True},
            "bynode": {"feature_fraction_bynode": 0.5}}
    out = {}
    for name, extra in runs.items():
        booster, res, _ = constrained_train(lgb, cuda_hist, args, extra,
                                            rounds)
        trees = load_model(booster.model_to_string()).trees
        if name == "interactions":
            res["paths_across_groups"] = sum(
                not any(p <= set(g) for g in GROUPS)
                for t in trees for p in _path_features(t))
            ok = res["split_fusion"] and res["paths_across_groups"] == 0
        elif name == "contri_zero":
            res["splits_on_zero_feature"] = int(sum(
                (t.split_feature[:t.num_leaves - 1] == CONTRI_ZERO).sum()
                for t in trees))
            ok = (not res["split_fusion"]
                  and res["splits_on_zero_feature"] == 0)
        else:
            ok = not res["split_fusion"]
        if not ok:
            raise AssertionError(f"train_constraints/{name}: {res}")
        out[name] = res
    return out


PARITY_CONSTRAINTS = {
    "basic": {"monotone_constraints": MONO_LIST},
    "basic_q8": {"monotone_constraints": MONO_LIST, "quantized_grad": True},
    "intermediate": {"monotone_constraints": MONO_LIST,
                     "monotone_constraints_method": "intermediate"},
    "advanced": {"monotone_constraints": MONO_LIST,
                 "monotone_constraints_method": "advanced"},
    "penalty": {"monotone_constraints": MONO_LIST, "monotone_penalty": 2.0},
    "interactions": {"interaction_constraints": GROUPS},
    "contri": {"feature_contri": [0.5 + (j % 4) * 0.25 for j in range(28)]},
    "contri_zero": {"feature_contri": [0.0 if j == CONTRI_ZERO else 1.0
                                       for j in range(28)]},
    "extra_trees": {"extra_trees": True},
    "bynode": {"feature_fraction_bynode": 0.5},
}


def parity_texts(lgb, name, setup, q8, rounds: int = PARITY_ROUNDS):
    """One parity run, twice on the card and on the CPU in the kernels'
    orders (kernel_sums_on_cpu; q8: the plain path, whose int32 sums are
    exact): the three texts must be equal. Against the CPU's plain run
    (float32 sums in the JAX package's order): equal text, or the first
    tree whose structure differs and the leaf error before it. Also the
    first card run's launch counts (the nonzero ones)."""
    from lightgbm_tpu_torch.io.model_text import load_model
    from lightgbm_tpu_torch.ops import cuda_hist
    cuda_hist.reset_launch_counts()
    texts = {"cuda": parity_text(lgb, setup, "cuda", rounds)}
    launches = {k: v for k, v in cuda_hist.launch_counts().items() if v}
    texts["cuda_again"] = parity_text(lgb, setup, "cuda", rounds)
    with (contextlib.nullcontext() if q8
          else cuda_hist.kernel_sums_on_cpu()):
        texts["cpu_kernel_order"] = parity_text(lgb, setup, "cpu", rounds)
    texts["cpu"] = (texts["cpu_kernel_order"] if q8
                    else parity_text(lgb, setup, "cpu", rounds))
    sc, sp = _structure(texts["cuda"]), _structure(texts["cpu"])
    diverge = next((i for i, (a, b) in enumerate(zip(sc, sp)) if a != b),
                   None)
    tc, tp = (load_model(texts[k]).trees for k in ("cuda", "cpu"))
    tc, tp = list(tc), list(tp)
    upto = len(tc) if diverge is None else diverge
    node = None
    if diverge is not None and diverge < min(len(tc), len(tp)):
        a, b = tc[diverge], tp[diverge]
        k = next((i for i in range(min(len(a.split_feature),
                                       len(b.split_feature)))
                  if (a.split_feature[i], a.threshold[i],
                      a.decision_type[i]) != (b.split_feature[i],
                                              b.threshold[i],
                                              b.decision_type[i])), None)
        if k is not None:
            node = {"node": k, "card": [int(a.split_feature[k]),
                                        float(a.threshold[k]),
                                        bool(a.decision_type[k] & 1)],
                    "cpu": [int(b.split_feature[k]), float(b.threshold[k]),
                            bool(b.decision_type[k] & 1)],
                    "card_gain": float(a.split_gain[k]),
                    "cpu_gain": float(b.split_gain[k])}
    res = {"card_runs_identical_text": texts["cuda"] == texts["cuda_again"],
           "card_equals_cpu_kernel_order":
           texts["cuda"] == texts["cpu_kernel_order"],
           "card_equals_cpu_plain": texts["cuda"] == texts["cpu"],
           "first_divergent_tree_vs_cpu_plain": diverge,
           "first_divergent_node": node,
           "max_leaf_abs_err_before_divergence": max(
               [float(np.abs(a.leaf_value - b.leaf_value).max())
                for a, b in zip(tc[:upto], tp[:upto])] or [0.0]),
           "card_text_sha256": _sha(texts["cuda"]), "launches": launches}
    if not (res["card_runs_identical_text"]
            and res["card_equals_cpu_kernel_order"]):
        raise AssertionError(f"{name}: {res}")
    if q8 and not res["card_equals_cpu_plain"]:
        raise AssertionError(f"{name}: the q8 card text differs from the "
                             f"CPU's plain run: {res}")
    return res


# parity_constraints' rounds: 1, cut from PARITY_ROUNDS to 2 when the data
# layer's phases came in and to 1 with the precision modes' (the exact
# modes' CPU runs are the costly part)
PARITY_CONSTRAINTS_ROUNDS = 1
# and its rows: a quarter of PARITY_ROWS, to keep the whole script well
# inside its limit on a slower host
PARITY_CONSTRAINTS_ROWS = 12_500


def parity_constraints_phase(lgb, seed):
    """Each constrained run at 12,500 Higgs-shaped rows, 63 leaves,
    PARITY_CONSTRAINTS_ROUNDS rounds (parity_texts)."""
    X, y = higgs_like(PARITY_CONSTRAINTS_ROWS, seed + 29)
    out = {"rows": PARITY_CONSTRAINTS_ROWS, "num_leaves": 63,
           "rounds": PARITY_CONSTRAINTS_ROUNDS}
    for name, extra in PARITY_CONSTRAINTS.items():
        setup = (X, y, dict(PARAMS, num_leaves=63, **extra), {})
        res = parity_texts(lgb, f"parity_constraints/{name}", setup,
                           bool(extra.get("quantized_grad")),
                           PARITY_CONSTRAINTS_ROUNDS)
        res.pop("launches")
        out[name] = res
    return out


# ------------------------------------------------------------- data layer
WIDE_B = 1023            # max_bin 1023: the wide mode's main-path bins
WIDE_STRESS_B = 4095     # one f32 plane of 98 KB a feature: the cap's edge
WIDE_ROUNDS = 3          # train_wide_classic's, train_forced_cegb's rounds
MONO_DIRS = torch.tensor([1.0, -1.0, 0.0])


def hist_wide_phase(cuda_hist, n, seed):
    """hist_tile's wide mode (int16 bins) at N=n, F=28, B=1023: the root
    pass, the several-slot full form and both rungs of the fused path,
    the plane-only full form (42 slots) and larger rung of the classic
    path, f32 and q8 (hist_phase / hist_q8_phase: bitwise its own
    arithmetic or exact sums, two launches equal, times, bound and one
    index_add_); the root and the larger rung at B = 4095 (the stress
    input: one feature's f32 plane of 98 KB); and the uint8 mode at B = 255
    on rows drawn the same way (root and rungs), to show it did not move.
    The launches are counted from 0 around the phase: the wide checks
    must launch only wide modes."""
    rungs = ladder_rungs(n)
    out = {}
    cuda_hist.reset_launch_counts()
    for mode, fn in (("f32", hist_phase), ("q8", hist_q8_phase)):
        res = {"b1023": {"root": fn(cuda_hist, n, seed=seed, root=True,
                                    b=WIDE_B),
                         "full": fn(cuda_hist, n, seed=seed, b=WIDE_B),
                         **{f"rung_{m}": fn(cuda_hist, n, m, seed=seed,
                                            b=WIDE_B) for m in rungs}},
               "plane_b1023": {"full": fn(cuda_hist, n, seed=seed, f=F,
                                          plane=True, b=WIDE_B),
                               f"rung_{rungs[-1]}": fn(
                                   cuda_hist, n, rungs[-1], seed=seed,
                                   plane=True, b=WIDE_B)},
               "b4095": {"root": fn(cuda_hist, n, seed=seed, root=True,
                                    b=WIDE_STRESS_B),
                         f"rung_{rungs[-1]}": fn(cuda_hist, n, rungs[-1],
                                                 seed=seed,
                                                 b=WIDE_STRESS_B)}}
        counts = cuda_hist.launch_counts()
        narrow = sum(v for k, v in counts.items()
                     if k.startswith("hist_tile.") and "_wide" not in k)
        if narrow or not counts["hist_tile.launches_wide"
                                + ("_q8" if mode == "q8" else "")]:
            raise AssertionError(f"the wide checks launched a uint8 form or "
                                 f"no wide one: {counts}")
        res["b255"] = {"root": fn(cuda_hist, n, seed=seed, root=True),
                       **{f"rung_{m}": fn(cuda_hist, n, m, seed=seed)
                          for m in rungs}}
        cuda_hist.reset_launch_counts()
        out[mode] = res
    return out


def wide_form(b: int, q8: bool, mono: bool) -> str:
    """A wide epilogue probe's name: split_epilogue_wide/b<B>[_q8][_mono]."""
    return (f"split_epilogue_wide/b{b}" + ("_q8" if q8 else "")
            + ("_mono" if mono else ""))


def wide_epilogue_call(cuda_hist, base, q8: bool, mono: bool, plain=False):
    """split_epilogue (or with ``plain`` its plain version) on
    epilogue_inputs' ``base``; ``mono``: the monotone mode with each
    slot's bounds +-0.02 and directions +1, -1, 0 over the features."""
    args = list(base[:6])
    if mono:
        args[3] = args[3].clone()
        args[3][:, 4], args[3][:, 5] = -0.02, 0.02
        args[4] = args[4].clone()
        f = args[4].shape[0]
        args[4][:, 3] = MONO_DIRS.repeat(f // 3 + 1)[:f].cuda()
    qs = base[6] if q8 else None
    fn = cuda_hist.split_epilogue_plain if plain else cuda_hist.split_epilogue
    return lambda: fn(*args, qs, with_monotone=mono)


def epilogue_wide_phase(cuda_hist, seed=0):
    """split_epilogue's wide mode at P=42, F=28, B = 1023 and 4095, f32 and
    q8, unconstrained and monotone (wide_epilogue_call), with the B = 255
    mode beside it on inputs made the same way: bitwise its plain version
    and a second launch, each launch counted in its own mode's counter;
    ms, device ms a launch (50 a profile, each on a cold L2), plain ms,
    the bound."""
    out = {}
    for b in (B, WIDE_B, WIDE_STRESS_B):
        for q8 in (False, True):
            base = epilogue_inputs(cuda_hist, seed, q8=q8, b=b)
            for mono in (False, True):
                call = wide_epilogue_call(cuda_hist, base, q8, mono)
                plain = wide_epilogue_call(cuda_hist, base, q8, mono,
                                           plain=True)
                cuda_hist.reset_launch_counts()
                kf, kc = call()
                kf2, kc2 = call()
                name = ("split_epilogue.launches"
                        + ("_wide" if b > 256 else "")
                        + ("_mono" if mono else "") + ("_q8" if q8 else ""))
                counts = cuda_hist.launch_counts()
                pf, pc = plain()
                torch.cuda.synchronize()
                for x, y in ((kc, pc), (kf, pf), (kc, kc2), (kf, kf2)):
                    if not torch.equal(x.view(torch.int32),
                                       y.view(torch.int32)):
                        raise AssertionError(
                            f"split_epilogue at B={b} (q8 {q8}, monotone "
                            f"{mono}) is not bitwise its plain version and "
                            f"a second launch")
                if counts[name] != 2 or sum(counts.values()) != 2:
                    raise AssertionError(f"{name}: {counts}")
                valid = int(torch.isfinite(kc[..., 0]).sum())
                if valid == 0:
                    raise AssertionError(f"no valid candidate at B={b}")
                bms, by = epilogue_bound(base[2], q8, mono=mono, b=b)
                out[f"b{b}" + ("_q8" if q8 else "")
                    + ("_mono" if mono else "")] = {
                    "bitwise_vs_plain": True, "deterministic": True,
                    "max_abs_err": float((kc - pc).nan_to_num(0.0).abs()
                                         .max()),
                    "valid_candidates": valid, "ms": time_ms(call),
                    "device_ms": device_ms(
                        call, per_profile=EPI_LAUNCHES,
                        need="split_epilogue", cold_each=True)[0],
                    "plain_ms": time_ms(plain, reps=3 if b > WIDE_B else 10,
                                        warm=1),
                    "library_ms": None, "bound_ms": bms, "bound_by": by}
    return out


def _launch_sums(launches):
    """(launches of the wide modes, launches of the uint8 modes) of
    hist_tile and split_epilogue."""
    wide = sum(v for k, v in launches.items() if "_wide" in k)
    narrow = sum(v for k, v in launches.items()
                 if k.startswith(("hist_tile.", "split_epilogue."))
                 and "_wide" not in k)
    return wide, narrow


def train_wide_phase(lgb, cuda_hist, args, ref_auc, q8=False,
                     classic=False):
    """train's rows at max_bin 1023 (the wide mode, int16 bins): the fused
    path in --rounds rounds, or with ``classic`` (split_fusion=off)
    WIDE_ROUNDS; sec/iter, device busy and idle share (one profiled
    iteration), valid AUC (within 0.01 of ``ref_auc``: train's run for
    the f32 fused path, train_wide's for q8), launches by mode: the wide
    modes only, never a uint8 one."""
    extra = {"max_bin": WIDE_B}
    if q8:
        extra["quantized_grad"] = True
    if classic:
        extra["split_fusion"] = "off"
    rounds = WIDE_ROUNDS if classic else args.rounds
    booster, out, launches = constrained_train(
        lgb, cuda_hist, args, extra, rounds, profile=not classic)
    sfx = "_wide" + ("_q8" if q8 else "")
    wide, narrow = _launch_sums(launches)
    ts = booster._boosting.train_set
    out.update(num_bins=ts.max_num_bins, bins_dtype=str(ts.binsT.dtype),
               wide_launches=wide, uint8_launches=narrow)
    need = (["hist_tile.launches_plane" + sfx, "hist_tile.gather_launches"
             + sfx] if classic else
            ["hist_tile.launches" + sfx, "hist_tile.gather_launches" + sfx,
             "split_epilogue.launches" + sfx])
    if narrow or any(launches[k] <= 0 for k in need) or \
            out["split_fusion"] == classic or ts.max_num_bins <= 256:
        raise AssertionError(f"the wide run left its path or mode: {out}")
    if not classic and abs(out["valid_auc"] - ref_auc) > 0.01:
        raise AssertionError(f"wide valid AUC {out['valid_auc']} not within "
                             f"0.01 of {ref_auc}")
    return out, launches


# Allstate-shaped rows (docs/Experiments.rst: Allstate Claim Prediction,
# 13,184,290 rows x 4,228 one-hot columns): 25 categorical source fields
# one-hot encoded into 4,223 columns, plus 5 dense numerical columns; 30
# nonzeros a row
ALLSTATE_CARD = (2, 3, 3, 4, 5, 7, 8, 10, 12, 15, 20, 25, 32, 40, 50, 64,
                 80, 100, 128, 160, 200, 300, 450, 900, 1605)
ALLSTATE_NUM = 5
ALLSTATE_COLS = sum(ALLSTATE_CARD) + ALLSTATE_NUM       # 4,228
EFB_MAX_COLUMNS = 200    # the JAX package's bar (tests/test_efb.py:183-200)


def allstate_like(n: int, seed: int, cards=ALLSTATE_CARD):
    """CSR rows of Allstate's shape: each row one category of each of the
    ``cards`` fields (Zipf-skewed, exponent 1.1) and ALLSTATE_NUM normal
    columns, float32; a binary label from per-category effects and the
    numerical columns plus logistic noise."""
    import scipy.sparse as sps
    rng = np.random.RandomState(seed)
    fields = len(cards)
    width = fields + ALLSTATE_NUM
    idx = np.empty((n, width), np.int32)
    z = np.zeros(n)
    off = 0
    for k, card in enumerate(cards):
        p = 1.0 / np.arange(1, card + 1) ** 1.1
        cat = rng.choice(card, n, p=p / p.sum())
        z += np.random.RandomState(seed * 7919 + k).normal(0, 0.5, card)[cat]
        idx[:, k] = off + cat
        off += card
    num = rng.standard_normal((n, ALLSTATE_NUM)).astype(np.float32)
    idx[:, fields:] = off + np.arange(ALLSTATE_NUM)
    data = np.ones((n, width), np.float32)
    data[:, fields:] = num
    z += num @ np.linspace(0.8, -0.4, ALLSTATE_NUM)
    z += rng.logistic(0.0, 1.0, n) * 0.7
    X = sps.csr_matrix((data.reshape(-1), idx.reshape(-1),
                        np.arange(0, n * width + 1, width, dtype=np.int64)),
                       shape=(n, off + ALLSTATE_NUM))
    return X, (z > np.median(z)).astype(np.float64)


def device_bytes(ds) -> int:
    """Bytes of a Dataset's bin matrix on the device: the dense columns
    and the sparse columns' streams."""
    out = ds.binsT.numel() * ds.binsT.element_size()
    if ds.has_sparse_cols:
        out += sum(t.numel() * t.element_size()
                   for t in (ds.sp_rows, ds.sp_bins, ds.sp_default))
    return int(out)


def train_efb_phase(lgb, cuda_hist, args, rows: int = 2_000_000,
                    predict_rows: int = 20_000):
    """EFB on Allstate-shaped CSR rows (4,228 columns; rows cut from
    13,184,290 to ``rows`` for the host's construct time), binary, 255
    leaves, --rounds rounds: construct seconds (the scipy input never
    densified), the device columns after bundling (at most 200), the bin
    matrix's device bytes against the unbundled [4228, N] uint8, peak
    device memory, sec/iter, valid AUC (> 0.6) on 200,000 more rows built
    on the bundled reference, and predict on a 20,000-row valid slice
    from the raw sparse rows (model trees, in row chunks), equal to the
    valid scores' cache within 1e-4."""
    t0 = time.time()
    X, y = allstate_like(rows + args.valid_rows, args.seed + 41)
    Xv, yv = X[rows:], y[rows:]
    X, y = X[:rows], y[:rows]
    t_data = time.time() - t0
    params = dict(PARAMS, device_type="cuda")
    train = lgb.Dataset(X, label=y, params=params)
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    train.construct()
    torch.cuda.synchronize()
    t_construct = time.time() - t0
    valid.construct()
    cols = train.num_used_features()
    evals = {}
    cuda_hist.reset_launch_counts()
    t0 = time.time()
    booster = lgb.train(params, train, args.rounds, valid_sets=[valid],
                        valid_names=["valid"], evals_result=evals)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_hist.launch_counts()
    gb = booster._boosting
    t0 = time.time()
    pred = booster.predict(Xv[:predict_rows], raw_score=True)
    t_pred = time.time() - t0
    cache = gb._valid_scores[0][:predict_rows].cpu().numpy()
    out = {"rows": rows, "rows_cut_from": 13_184_290,
           "valid_rows": args.valid_rows, "columns": ALLSTATE_COLS,
           "nnz_per_row": len(ALLSTATE_CARD) + ALLSTATE_NUM,
           "rounds": args.rounds, "data_s": t_data,
           "construct_s": t_construct, "used_features":
           len(train.used_features), "device_columns": cols,
           "bundles": sum(len(b.members) > 1 for b in train.bundles),
           "sparse_stream_columns": int(len(train.sp_cols))
           if train.has_sparse_cols else 0,
           "bins_device_bytes": device_bytes(train),
           "unbundled_uint8_bytes": ALLSTATE_COLS * rows,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "sec_per_iter": wall / args.rounds,
           "valid_auc": evals["valid"]["auc"][-1],
           "split_fusion": gb._split_fusion_on(),
           "predict_rows": predict_rows, "predict_s": t_pred,
           "predict_vs_valid_cache_max_abs": float(np.abs(pred - cache).max()),
           "launches": {k: v for k, v in launches.items() if v},
           "leaves_last_tree": gb.host_trees[-1].num_leaves}
    if not (cols <= EFB_MAX_COLUMNS and out["valid_auc"] > 0.6
            and out["predict_vs_valid_cache_max_abs"] <= 1e-4
            and not out["split_fusion"]
            and launches["hist_tile.launches_plane"] > 0):
        raise AssertionError(f"train_efb: {out}")
    return out


def forced_tree(X):
    """A forced-splits JSON three levels deep (seven nodes) on train's
    columns, each at its column's median: (the JSON object, the preorder
    features)."""
    feats = [21, 24, 0, 26, 2, 9, 5]

    def node(k):
        j = feats[k]
        out = {"feature": j, "threshold": float(np.median(X[:20000, j]))}
        if 2 * k + 1 < len(feats):
            out["left"] = node(2 * k + 1)
            out["right"] = node(2 * k + 2)
        return out

    order = []

    def pre(k):
        if k < len(feats):
            order.append(feats[k])
            pre(2 * k + 1)
            pre(2 * k + 2)

    pre(0)
    return node(0), order


def _features_used(booster):
    return sorted({int(f) for ht in booster._boosting.host_trees
                   for f in ht.feature_indices[ht.split_feature]})


def train_forced_cegb_phase(lgb, cuda_hist, args):
    """On train's rows, WIDE_ROUNDS rounds each (the classic path): a
    forced-splits JSON three levels deep, written by the script to a
    temporary directory (every tree must start with those seven splits in
    preorder); CEGB with split and coupled penalties, and CEGB lazy
    (``row_used`` [2M, 28] bool on the device), each with the distinct
    features used against an unpenalised run; max_bin_by_feature with a
    forced-bins JSON. sec/iter of each."""
    import tempfile
    X, y, _, _ = higgs_rows(args)
    tree, order = forced_tree(X)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        fs = os.path.join(tmp, "forced_splits.json")
        fb = os.path.join(tmp, "forced_bins.json")
        with open(fs, "w") as fh:
            json.dump(tree, fh)
        with open(fb, "w") as fh:
            json.dump([{"feature": 21, "bin_upper_bound":
                        [float(v) for v in np.quantile(X[:20000, 21],
                                                       [0.1, 0.5, 0.9])]},
                       {"feature": 0, "bin_upper_bound": [0.5, 1.0, 2.0]}],
                      fh)
        runs = {
            "unpenalised": {},
            "forced_splits": {"forcedsplits_filename": fs},
            "cegb": {"cegb_penalty_split": 1e-6,
                     "cegb_penalty_feature_coupled": [
                         0.0 if j in (21, 24, 26) else 2e4
                         for j in range(F)]},
            "cegb_lazy": {"cegb_penalty_feature_lazy": [
                0.0 if j in (21, 24, 26) else 1e-3 for j in range(F)]},
            "bins": {"max_bin_by_feature": [63 if j % 2 else 255
                                            for j in range(F)],
                     "forcedbins_filename": fb}}
        for name, extra in runs.items():
            booster, res, _ = constrained_train(lgb, cuda_hist, args, extra,
                                                WIDE_ROUNDS)
            res["features_used"] = len(_features_used(booster))
            res.pop("params")
            if name == "forced_splits":
                tops = [list(ht.feature_indices[ht.split_feature[:7]])
                        for ht in booster._boosting.host_trees]
                res["forced_at_top"] = all(t == order for t in tops)
                if not res["forced_at_top"]:
                    raise AssertionError(f"forced splits not at the top: "
                                         f"{tops[:3]} vs {order}")
            if name.startswith("cegb"):
                res["features_used_unpenalised"] = \
                    out["unpenalised"]["features_used"]
                state = booster._boosting._cegb.state
                if state["row_used"] is not None:
                    res["row_used_bytes"] = state["row_used"].numel()
            out[name] = res
    return out


# parity_data's rows: a quarter of PARITY_ROWS, to keep the whole script
# well inside its limit on a slower host (its CPU runs are the costly part)
PARITY_DATA_ROWS = 12_500
# parity_data's rounds: 1, cut from PARITY_ROUNDS when the precision modes'
# phases came in (its CPU runs are the costly part)
PARITY_DATA_ROUNDS = 1


def parity_data_setups(seed: int, tmp: str):
    """The data layer's parity runs at PARITY_DATA_ROWS rows, 63 leaves:
    name -> (X, y, params, Dataset keywords)."""
    X, y = higgs_like(PARITY_DATA_ROWS, seed + 43)
    base = dict(PARAMS, num_leaves=63)
    Xc = X.copy()
    rng = np.random.RandomState(seed + 47)
    Xc[:, 3] = rng.randint(0, 400, PARITY_DATA_ROWS)
    yc = ((y + (Xc[:, 3] % 5 == 0)) > 0.5).astype(np.float64)
    # the first 14 fields (241 columns): the unbundled run's [63, F, B, 3]
    # planes stay small on the CPU
    Xs, ys = allstate_like(PARITY_DATA_ROWS, seed + 53, ALLSTATE_CARD[:14])
    tree, _ = forced_tree(X)
    fs, fb = os.path.join(tmp, "forced.json"), os.path.join(tmp, "bins.json")
    with open(fs, "w") as fh:
        json.dump(tree, fh)
    with open(fb, "w") as fh:
        json.dump([{"feature": 0, "bin_upper_bound": [0.5, 1.0, 2.0]}], fh)
    wide = dict(base, max_bin=WIDE_B)
    return {
        "wide": (X, y, wide, {}),
        "wide_q8": (X, y, dict(wide, quantized_grad=True), {}),
        "wide_classic": (X, y, dict(wide, split_fusion="off"), {}),
        "wide_mono": (X, y, dict(wide, monotone_constraints=MONO_LIST), {}),
        "wide_mono_q8": (X, y, dict(wide, monotone_constraints=MONO_LIST,
                                    quantized_grad=True), {}),
        "cat400": (Xc, yc, dict(base, max_bin=511, cat_smooth=1.0,
                                min_data_per_group=20),
                   {"categorical_feature": [3]}),
        "efb_csr": (Xs, ys, base, {}),
        "csr_unbundled": (Xs, ys, dict(base, enable_bundle=False), {}),
        "forced_bins": (X, y, dict(base, forcedbins_filename=fb), {}),
        "max_bin_by_feature": (X, y, dict(base, max_bin_by_feature=[
            15 + 40 * (j % 7) for j in range(F)]), {}),
        "forced_splits": (X, y, dict(base, forcedsplits_filename=fs), {}),
        "cegb_split": (X, y, dict(base, cegb_penalty_split=1e-4), {}),
        "cegb_coupled": (X, y, dict(base, cegb_penalty_feature_coupled=[
            5.0 * (j % 3) for j in range(F)]), {}),
        "cegb_lazy": (X, y, dict(base, cegb_penalty_feature_lazy=[
            0.01 * (j % 4) for j in range(F)]), {}),
    }


def parity_data_phase(lgb, seed):
    """Each data-layer run at 12,500 rows, 63 leaves, PARITY_DATA_ROUNDS
    rounds (parity_texts: two card runs and the CPU run in the kernels'
    orders equal; q8 also the CPU's plain run; f32 against it equal or the
    first divergent tree named), with the first card run's launches."""
    import tempfile
    out = {"rows": PARITY_DATA_ROWS, "num_leaves": 63,
           "rounds": PARITY_DATA_ROUNDS}
    with tempfile.TemporaryDirectory() as tmp:
        for name, setup in parity_data_setups(seed, tmp).items():
            out[name] = parity_texts(lgb, f"parity_data/{name}", setup,
                                     bool(setup[2].get("quantized_grad")),
                                     PARITY_DATA_ROUNDS)
    if not all(out[k]["launches"].get("split_epilogue.launches_wide_mono"
                                      + s, 0) > 0
               for k, s in (("wide_mono", ""), ("wide_mono_q8", "_q8"))):
        raise AssertionError("the wide monotone runs missed the epilogue's "
                             "wide monotone mode")
    return out


WIDE_TEXTS = ("wide", "wide_q8", "wide_mono", "wide_mono_q8")


def wide_texts(lgb, seed: int):
    """parity_data's four wide fused runs (max_bin 1023: f32, q8,
    monotone, monotone q8), one card training each: name -> {"sha256":
    the model text's, "launches": the nonzero launch counts}. A
    checkout's package run by --parent's probe gives the texts its
    parity_data phase would."""
    import tempfile
    from lightgbm_tpu_torch.ops import cuda_hist
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        setups = parity_data_setups(seed, tmp)
        for name in WIDE_TEXTS:
            cuda_hist.reset_launch_counts()
            text = parity_text(lgb, setups[name], "cuda", PARITY_DATA_ROUNDS)
            out[name] = {"sha256": _sha(text), "launches": {
                k: v for k, v in cuda_hist.launch_counts().items() if v}}
    return out


def same_wide_texts(hashes, parent):
    """With --parent: parity_data's four wide card texts (``hashes``,
    name -> sha256) must be the other checkout's, in each of its probes."""
    for name, sha in hashes.items():
        if any(pt["wide_sha256"][name] != sha for pt in parent):
            raise AssertionError(f"parity_data/{name}: the card's model "
                                 f"text differs from the parent checkout's")
    return {"wide_texts_equal_parent": True}


# -------------------------------------------------------- precision modes
DP_TOL = 1e-11          # f64 mode vs a torch float64 sum: of each cell's
                        # summed magnitudes (each stat rounds to the pass's
                        # 2^-k once: amax * N / 2^61 a row at most)
DP_DEVICE_SLACK = 1.15  # the f64 mode's device ms against the f32 mode's


def hist_dp_case(cuda_hist, n, f, m=None, root=False, seed=0, bins=None,
                 b=B):
    """The f64 mode (gpu_use_dp) of a plane-only launch at one shape: the
    full form (``m`` None; ``root``: the root pass, one computed slot
    holding every row; else all 42 slots computed, 3/4 of the rows in
    them) or the gather form over a rung of ``m`` rows (9/10 of it the
    tile's rows); ``bins``: [f, n] bins on the card for the random ones.
    Float stats only (the mode is the float one). Bitwise
    ``hist_tile_exact(dtype=float64)`` and a second launch (which
    computes the stats' amax itself), the f64 planes rounded to float32
    bitwise the f32 mode's planes on the same inputs, within DP_TOL of the
    summed magnitudes of a torch float64 sum (hist_tile_plain at float64);
    the launches counted as the f64 mode's and the f32 launch as the f32
    mode's. ms and device ms of both modes, taken in turns (f64, f32, f32,
    f64), the plain version's ms, a float64 ``index_add_`` over the same
    cells as the library time, and the bound (the f64 planes' bytes)."""
    from lightgbm_tpu_torch.ops.histogram import compact_indices
    f64 = torch.float64
    sel = tile_selection(plane=True, root=root)
    tile_leaves = sel[sel >= 0]
    chan_h = cuda_hist.chan_leaf_table(sel)
    chan = chan_h.cuda()
    share = 1.0 if root else 0.75 if m is None else 0.9 * m / n
    binsT, leaf, stats = hist_inputs(n, f, seed, False, tile_leaves, share,
                                     b=b)
    binsT = binsT if bins is None else bins
    amax = stats.abs().amax(0)
    in_tile = torch.isin(leaf, tile_leaves.cuda())
    n_tile = int(in_tile.sum())
    idx = None if m is None else compact_indices(in_tile, m)
    args = (binsT, leaf, stats, chan, P, b, LEAVES, idx)
    kargs = (binsT, leaf, stats, chan_h, P, b, LEAVES, idx)

    def k64():
        return cuda_hist.hist_tile(*kargs, plane=True, amax=amax, dtype=f64)

    def k32():
        return cuda_hist.hist_tile(*kargs, plane=True, amax=amax)

    cuda_hist.reset_launch_counts()
    k = k64()
    again = cuda_hist.hist_tile(*kargs, plane=True, dtype=f64)
    k_f32 = k32()
    counts = cuda_hist.launch_counts()
    exact = cuda_hist.hist_tile_exact(*args, dtype=f64)
    plain = cuda_hist.hist_tile_plain(*args, dtype=f64)
    mag = cuda_hist.hist_tile_plain(binsT, leaf, stats.abs(), chan, P, b,
                                    LEAVES, idx, dtype=f64)
    torch.cuda.synchronize()
    w = "_wide" if b > 256 else ""
    want = {f"hist_tile.launches{w}_dp": 2,
            f"hist_tile.launches_plane{w}_dp": 2,
            f"hist_tile.gather_launches{w}_dp": 0 if m is None else 2,
            f"hist_tile.launches{w}": 1, f"hist_tile.launches_plane{w}": 1,
            f"hist_tile.gather_launches{w}": 0 if m is None else 1}
    got = {c: v for c, v in counts.items() if v}
    if got != {c: v for c, v in want.items() if v}:
        raise AssertionError(f"the f64 checks launched other forms or "
                             f"modes: {got}")
    for name, other in (("hist_tile_exact(dtype=float64)", exact),
                        ("a second launch", again)):
        if not torch.equal(k.view(torch.int64), other.view(torch.int64)):
            raise AssertionError(f"the f64 mode is not bitwise equal to "
                                 f"{name}")
    if not torch.equal(k.to(torch.float32).view(torch.int32),
                       k_f32.view(torch.int32)):
        raise AssertionError("the f64 planes rounded to float32 differ from "
                             "the f32 mode's planes on the same inputs")
    out = {"rows": n if m is None else m, "tile_rows": n_tile, "f": f,
           "b": b, "bitwise_vs_exact": True, "deterministic": True,
           "rounds_to_f32_mode": True,
           "max_abs_err": float_err(k, plain, mag, rtol=DP_TOL),
           "max_rel_err_of_magnitudes": float(
               ((k - plain).abs() / mag.clamp(min=1e-300)).max()),
           "tolerance_of_magnitudes": DP_TOL, "launches_checked": got}
    out["ms"] = time_ms(k64)
    out["f32_ms"] = time_ms(k32)
    d64a, split = device_ms(k64)
    d32a, _ = device_ms(k32)
    d32b, _ = device_ms(k32)
    d64b, _ = device_ms(k64)
    if "not measured" in (d64a, d64b, d32a, d32b):
        out["device_ms"] = out["f32_device_ms"] = "not measured"
    else:
        out["device_ms"] = (d64a + d64b) / 2
        out["f32_device_ms"] = (d32a + d32b) / 2
        out["device_ms_ratio_to_f32"] = out["device_ms"] / out["f32_device_ms"]
    out["device_split"] = split
    out["plain_ms"] = time_ms(
        lambda: cuda_hist.hist_tile_plain(*args, dtype=f64), reps=10, warm=1)
    out["library_ms"] = library_ms(binsT, leaf, stats, sel, in_tile, f, b,
                                   f64)
    # least traffic: hist_phase's, the planes written as float64
    scanned = n if idx is None else n_tile
    nbytes = (0 if idx is None else 4 * m) + 4 * scanned \
        + n_tile * (f * binsT.element_size() + 12) + P * f * b * 3 * 8
    out["bound_ms"], out["bound_by"] = bound(nbytes, 3 * n_tile * f)
    return out


def hist_plane_dp_phase(cuda_hist, args):
    """The f64 mode at train_cat's shapes (F = 8, all 42 slots computed:
    the root pass, the several-slot full form and both rungs) and at Higgs
    width (F = 28: the root pass on train_dp's own bins, the full form and
    both rungs), and one root pass at B = 1023 (int16 bins). Fails if a
    case's device ms passes DP_DEVICE_SLACK times the f32 mode's."""
    n = args.rows
    rungs = ladder_rungs(n)
    higgs = real_bins(n, args.valid_rows, args.seed)["higgs"]
    out = {"expo_f8": {
        "root": hist_dp_case(cuda_hist, n, F_CAT, root=True, seed=61),
        "full": hist_dp_case(cuda_hist, n, F_CAT, seed=62),
        **{f"rung_{m}": hist_dp_case(cuda_hist, n, F_CAT, m=m, seed=63)
           for m in rungs}},
        "higgs_f28": {
        "root": hist_dp_case(cuda_hist, n, F, root=True, seed=64,
                             bins=higgs),
        "full": hist_dp_case(cuda_hist, n, F, seed=65),
        **{f"rung_{m}": hist_dp_case(cuda_hist, n, F, m=m, seed=66)
           for m in rungs}},
        "wide_b1023": {"root": hist_dp_case(cuda_hist, n, F, root=True,
                                            seed=67, b=WIDE_B)}}
    slow = {f"{g}/{c}": r["device_ms_ratio_to_f32"]
            for g, cases in out.items() for c, r in cases.items()
            if r.get("device_ms_ratio_to_f32", 0) > DP_DEVICE_SLACK}
    out["device_slack"] = DP_DEVICE_SLACK
    out["slower_than_slack"] = slow
    if slow:
        raise AssertionError(f"the f64 mode's device ms exceeds "
                             f"{DP_DEVICE_SLACK}x the f32 mode's: {slow}")
    return out


def train_dp_phase(lgb, cuda_hist, args, ref_auc):
    """gpu_use_dp on train's 2M Higgs-shaped rows (binary, 255 leaves, lr
    0.1, --rounds rounds): the classic path with f64 planes. sec/iter,
    device busy and idle share from one profiled iteration, valid AUC
    within 0.01 of train's (the JAX package's f64-vs-f32 bar,
    tests/test_precision.py:61), and launches of the f64 plane-only forms
    alone: no f32 launch of any form, no split_epilogue."""
    _, out, launches = constrained_train(
        lgb, cuda_hist, args, {"gpu_use_dp": True}, args.rounds,
        profile=True)
    out["f32_valid_auc"] = ref_auc
    dp = {k: v for k, v in launches.items()
          if k.startswith("hist_tile.") and k.endswith("_dp")}
    others = {k: v for k, v in launches.items()
              if k.startswith(("hist_tile.", "split_epilogue."))
              and k not in dp and v}
    out["f64_launches"] = dp
    if out["split_fusion"] or others \
            or dp["hist_tile.launches_plane_dp"] <= 0 \
            or dp["hist_tile.gather_launches_dp"] <= 0 \
            or dp["hist_tile.launches_dp"] != dp["hist_tile.launches_plane_dp"]:
        raise AssertionError(f"train_dp left the f64 plane-only forms: "
                             f"{launches}")
    if abs(out["valid_auc"] - ref_auc) > 0.01:
        raise AssertionError(f"f64 valid AUC {out['valid_auc']} not within "
                             f"0.01 of the f32 run's {ref_auc}")
    return out, launches


def linear_like(n: int, seed: int):
    """Regression rows for linear leaves: train's 28 Higgs-shaped features,
    features 0-2 with 3% NaNs, and a target piecewise-linear in features
    0-2 (the pieces split on feature 1's sign and feature 2 above 0.5) plus
    Gaussian noise; a NaN counts as 0 in the target."""
    X, _ = higgs_like(n, seed)
    rng = np.random.RandomState(seed + 1)
    x0, x1, x2 = (X[:, j].astype(np.float64) for j in range(3))
    y = np.where(x1 > 0, 2.0 * x0 - 1.5 * x2, -x0 + 0.5 * x2) \
        + np.where(x2 > 0.5, 3.0 * x2, 0.0) + 0.3 * rng.standard_normal(n)
    for j in range(3):
        X[rng.rand(n) < 0.03, j] = np.nan
    return X, y


LINEAR_PARAMS = {"objective": "regression", "num_leaves": 255,
                 "max_bin": 255, "learning_rate": 0.1, "metric": "l2",
                 "verbosity": -1}
LINEAR_PREDICT_ROWS = 20_000


def train_linear_phase(lgb, cuda_hist, args):
    """linear_tree on 2M + 200k regression rows (linear_like; 28 features,
    255 leaves, linear_lambda 0.01, --rounds rounds; the fused path, whose
    kernels 1, 2 and the epilogue must launch): sec/iter with the host's
    leaf fits split out, valid l2 below a plain run's on the same rows and
    rounds, and the card's model text loaded back with load_model
    predicting LINEAR_PREDICT_ROWS valid rows bitwise as Booster.predict
    does."""
    from lightgbm_tpu_torch.io.model_text import load_model
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    X, y = linear_like(args.rows + args.valid_rows, args.seed + 71)
    Xv, yv = X[args.rows:], y[args.rows:]
    X, y = X[:args.rows], y[:args.rows]
    out = {"rows": args.rows, "valid_rows": args.valid_rows, "features": F,
           "rounds": args.rounds, "nan_share_features_0_2": 0.03}
    for linear in (True, False):
        params = dict(LINEAR_PARAMS, device_type="cuda",
                      linear_tree=linear, linear_lambda=0.01 if linear
                      else 0.0)
        train = lgb.Dataset(X, label=y, params=params)
        valid = lgb.Dataset(Xv, label=yv, reference=train)
        train.construct()
        valid.construct()
        evals, fits = {}, {}
        cuda_hist.reset_launch_counts()
        orig = _timed(gbdt_mod.GBDT, "_fit_linear_leaves", fits)
        torch.cuda.synchronize()
        t0 = time.time()
        try:
            booster = lgb.train(params, train, args.rounds,
                                valid_sets=[valid], valid_names=["valid"],
                                evals_result=evals)
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            gbdt_mod.GBDT._fit_linear_leaves = orig
        launches = cuda_hist.launch_counts()
        if not linear:
            out["plain_sec_per_iter"] = wall / args.rounds
            out["plain_valid_l2"] = evals["valid"]["l2"][-1]
            continue
        fit_s = sum(fits.get("_fit_linear_leaves", []))
        gb = booster._boosting
        out.update(
            sec_per_iter=wall / args.rounds,
            leaf_fit_host_ms_per_iter=fit_s * 1e3 / args.rounds,
            rest_ms_per_iter=(wall - fit_s) * 1e3 / args.rounds,
            valid_l2=evals["valid"]["l2"][-1],
            split_fusion=gb._split_fusion_on(),
            linear_leaves_last_tree=int(sum(
                1 for c in gb.host_trees[-1].leaf_coeff if c)),
            leaves_last_tree=gb.host_trees[-1].num_leaves,
            launches={k: v for k, v in launches.items() if v})
        lin_launches = launches
        text = booster.model_to_string()
        rows = Xv[:LINEAR_PREDICT_ROWS]
        t0 = time.time()
        pred = booster.predict(rows)
        out["predict_s"] = time.time() - t0
        loaded = load_model(text).predict(rows)
        out["loaded_text_predicts_bitwise"] = bool(np.array_equal(
            pred.view(np.uint64), loaded.view(np.uint64)))
        out["predict_rows"] = LINEAR_PREDICT_ROWS
    if not (out["split_fusion"] and out["linear_leaves_last_tree"] > 0
            and lin_launches["hist_tile.launches"]
            - lin_launches["hist_tile.launches_plane"] > 0
            and lin_launches["hist_tile.gather_launches"] > 0
            and lin_launches["split_epilogue.launches"] > 0):
        raise AssertionError(f"train_linear missed a kernel of the fused "
                             f"path or fitted no leaf: {out}")
    if not out["valid_l2"] < out["plain_valid_l2"]:
        raise AssertionError(f"linear valid l2 {out['valid_l2']} not below "
                             f"the plain run's {out['plain_valid_l2']}")
    if not out["loaded_text_predicts_bitwise"]:
        raise AssertionError("the loaded linear model text predicts other "
                             "values than Booster.predict")
    return out, lin_launches


def parity_precision_setups(seed: int):
    """The precision modes' parity runs at PARITY_ROWS rows, 63 leaves:
    gpu_use_dp on numerical, Expo-shaped categorical and sparse-column
    data; linear_tree as regression with NaNs and as binary. name -> (X,
    y, params, Dataset keywords)."""
    base = dict(PARAMS, num_leaves=63)
    dp = dict(base, gpu_use_dp=True)
    Xh, yh = higgs_like(PARITY_ROWS, seed + 7)
    Xc, yc = expo_like(PARITY_ROWS, seed + 13)
    Xs, ys = sparse_higgs_like(PARITY_ROWS, seed + 17)
    Xl, yl = linear_like(PARITY_ROWS, seed + 73)
    lin = {"linear_tree": True, "linear_lambda": 0.01}
    return {
        "dp": (Xh, yh, dp, {}),
        "dp_cat": (Xc, yc, dp, {"categorical_feature": CAT_COLUMNS}),
        "dp_sparse": (Xs, ys, dp, {}),
        "linear_regression": (Xl, yl, dict(LINEAR_PARAMS, num_leaves=63,
                                           **lin), {}),
        "linear_binary": (Xh, yh, dict(base, **lin), {}),
    }


# the precision parity runs' rounds: 2, cut from PARITY_ROUNDS when the
# predict group came in (a linear model's leaves are fitted from its
# second tree on)
PARITY_PRECISION_ROUNDS = 2


def parity_precision_phase(lgb, seed, prefix: str):
    """The ``prefix`` ("dp" or "linear") runs of parity_precision_setups,
    2 rounds each (parity_texts: two card runs and the CPU run in the
    kernels' orders equal; against the CPU's plain run equal text or the
    first divergent tree named), each with the first card run's launches:
    the f64 plane-only forms alone for dp, kernels 1, 2 and the epilogue
    for linear."""
    out = {"rows": PARITY_ROWS, "num_leaves": 63,
           "rounds": PARITY_PRECISION_ROUNDS}
    for name, setup in parity_precision_setups(seed).items():
        if not name.startswith(prefix):
            continue
        res = parity_texts(lgb, f"parity_{prefix}/{name}", setup, False,
                           PARITY_PRECISION_ROUNDS)
        got = res["launches"]
        if prefix == "dp":
            ok = got.get("hist_tile.launches_plane_dp", 0) > 0 and all(
                k.endswith("_dp") for k in got
                if k.startswith(("hist_tile.", "split_epilogue.")))
        else:
            ok = all(got.get(k, 0) > 0 for k in (
                "hist_tile.launches", "hist_tile.gather_launches",
                "split_epilogue.launches"))
        if not ok:
            raise AssertionError(f"parity_{prefix}/{name} ran other kernels "
                                 f"than its mode's: {got}")
        out[name] = res
    return out


def precision_phases(lgb, cuda_hist, args, ref_auc):
    """The precision modes' phases, each emitted; returns their results
    for the kernels line."""
    hd = hist_plane_dp_phase(cuda_hist, args)
    emit("hist_plane_dp", n=args.rows, p=P, leaves=LEAVES, **hd)
    tdp, dp_launches = train_dp_phase(lgb, cuda_hist, args, ref_auc)
    emit("train_dp", **tdp)
    tl, lin_launches = train_linear_phase(lgb, cuda_hist, args)
    emit("train_linear", **tl)
    pdp = parity_precision_phase(lgb, args.seed, "dp")
    emit("parity_dp", **pdp)
    plin = parity_precision_phase(lgb, args.seed, "linear")
    emit("parity_linear", **plin)
    return {"hist": hd, "dp_launches": dp_launches,
            "linear_launches": lin_launches}


def dp_kernel_entry(prec):
    """The kernels line's entry of the f64 mode: the root pass on train_dp's
    own bins (the full pass its main path launches) as its numbers, the
    other shapes beside them."""
    keys = ("ms", "device_ms", "f32_ms", "f32_device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    hd = prec["hist"]
    launched = prec["dp_launches"]
    cases = {f"{g}/{c}": r for g in ("expo_f8", "higgs_f28", "wide_b1023")
             for c, r in hd[g].items()}
    return {
        "name": "hist_tile (plane-only, f64)", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
        "replaces": "lightgbm_tpu/ops/pallas_hist.py:154 _fused_kernel "
                    "(pallas_call :270) + :205 _gather_kernel (pallas_call "
                    ":324), f64 planes: the JAX package's XLA scatter at "
                    "float64 (lightgbm_tpu/ops/histogram.py:220-223)",
        "launches": launched["hist_tile.launches_plane_dp"],
        "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
        "max_rel_err_of_magnitudes": max(r["max_rel_err_of_magnitudes"]
                                         for r in cases.values()),
        **{k: hd["higgs_f28"]["root"][k] for k in keys},
        "shapes": {k: {kk: r[kk] for kk in keys} for k, r in cases.items()},
        "gather_launches": launched["hist_tile.gather_launches_dp"],
        "launches_by_path": {"train_dp": launched[
            "hist_tile.launches_plane_dp"]}}


# training control (callbacks, early stopping, custom objectives and
# metrics, init_model, rollback, refit, free_dataset, cv) on the main path
CONTROL_ROUNDS = 8                        # the early-stopping run's at most
CONTROL_RATES = [0.1] * 3 + [3.0] * 5     # a jump the valid loss cannot take
CONTROL_STOP = 2                          # early_stopping_rounds
CONTROL_INIT_ROUNDS, CONTROL_MORE_ROUNDS = 3, 2
CONTROL_CV_FOLDS, CONTROL_CV_ROUNDS = 3, 3
CONTROL_PREDICT_RTOL, CONTROL_PREDICT_ATOL = 1e-5, 1e-7   # the JAX
# package's bar for a continued model (tests/test_fault_tolerance.py:305)
CONTROL_SCORE_ATOL = 1e-5    # rolled-back valid scores vs a shorter run's


def fused_launches(c):
    """The fused path's kernels in launch counts ``c``: kernel 1 (the full
    form of hist_tile), kernel 2 (its gather form), the epilogue."""
    return {"hist_tile_full": c["hist_tile.launches"]
            - c["hist_tile.gather_launches"] - c["hist_tile.launches_plane"],
            "hist_tile_gather": c["hist_tile.gather_launches"],
            "split_epilogue": c["split_epilogue.launches"]}


def _counted(cuda_hist, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (result, seconds, counts)."""
    cuda_hist.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = fn()
    torch.cuda.synchronize()
    return res, time.time() - t0, cuda_hist.launch_counts()


def _fused_check(name, counts):
    """A control run's launches of kernels 1, 2 and the epilogue, each of
    which must be above 0, on the fused path (no plane-only launch)."""
    got = fused_launches(counts)
    if min(got.values()) <= 0 or counts["hist_tile.launches_plane"]:
        raise AssertionError(f"{name} missed a kernel of the fused path: "
                             f"{ {k: v for k, v in counts.items() if v} }")
    return got


def _blocks(text):
    """The tree blocks of a model text, each from its Tree= line."""
    return ["Tree=" + b for b in
            text.split("end of trees")[0].split("Tree=")[1:]]


def _binary_fobj(host):
    """Binary logloss gradients in numpy (a user's custom objective); the
    seconds of each call go to ``host``."""
    def fobj(score, ds):
        t0 = time.time()
        prob = 1.0 / (1.0 + np.exp(-score))
        grad, hess = prob - ds.get_label(), prob * (1.0 - prob)
        host.append(time.time() - t0)
        return grad, hess
    return fobj


def _control_early_stopping(lgb, cuda_hist, params, train, valid):
    """Early stopping with a learning-rate schedule: CONTROL_RATES over at
    most CONTROL_ROUNDS rounds, early_stopping_rounds CONTROL_STOP, the
    evaluations in record_evaluation; the first best_iteration trees must
    be a plain run's of that many rounds, block by block."""
    evals = {}
    b, wall, counts = _counted(cuda_hist, lambda: lgb.train(
        params, train, CONTROL_ROUNDS, valid_sets=[valid],
        valid_names=["valid"], early_stopping_rounds=CONTROL_STOP,
        learning_rates=CONTROL_RATES,
        callbacks=[lgb.record_evaluation(evals)]))
    done = len(evals["valid"]["binary_logloss"])
    plain = lgb.train(params, train, b.best_iteration)
    out = {"rounds_run": done, "best_iteration": b.best_iteration,
           "best_score": b.best_score,
           "evals_result_lengths": {d: {m: len(v) for m, v in ms.items()}
                                    for d, ms in evals.items()},
           # a probability that rounds to 0 or 1 in float32 makes the
           # loss inf or nan (either counts as no improvement)
           "valid_binary_logloss": [v if np.isfinite(v) else str(v) for v
                                    in evals["valid"]["binary_logloss"]],
           "sec_per_iter": wall / done, "fired": done < CONTROL_ROUNDS,
           "best_trees_equal_plain_run": _blocks(b.model_to_string())
           == _blocks(plain.model_to_string()),
           "launches_by_kernel": _fused_check("early_stopping", counts)}
    if not (out["fired"] and 0 < b.best_iteration < done
            and out["best_trees_equal_plain_run"]):
        raise AssertionError(f"early stopping: {out}")
    return out, counts


def _control_fobj(lgb, cuda_hist, args, params, train, Xv, yv, ref_auc):
    """--rounds rounds of numpy binary-logloss gradients (objective none):
    valid AUC within 0.01 of train's, the host ms an iteration of the
    score's trip to the host, the gradients in numpy and their trip back
    split out, and one profiled iteration."""
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    from lightgbm_tpu_torch import booster as booster_mod
    host, acc = [], {}
    fobj = _binary_fobj(host)
    origs = [(gbdt_mod.GBDT, "_custom_gradients",
              _timed(gbdt_mod.GBDT, "_custom_gradients", acc)),
             (gbdt_mod.GBDT, "train_one_iter",
              _timed(gbdt_mod.GBDT, "train_one_iter", acc)),
             (booster_mod.Booster, "update",
              _timed(booster_mod.Booster, "update", acc))]
    try:
        b, wall, counts = _counted(cuda_hist, lambda: lgb.train(
            dict(params, metric="None"), train, args.rounds, fobj=fobj))
    finally:
        for owner, name, fn in origs:
            setattr(owner, name, fn)
    r = args.rounds
    fobj_s, h2d_s = sum(host), sum(acc["_custom_gradients"])
    d2h_s = sum(acc["update"]) - sum(acc["train_one_iter"]) - fobj_s
    valid_auc = auc(b.predict(Xv, raw_score=True), yv)
    out = {"rounds": r, "sec_per_iter": wall / r, "valid_auc": valid_auc,
           "train_valid_auc": ref_auc,
           "host_ms_per_iter": {"score_to_host": d2h_s * 1e3 / r,
                                "fobj_numpy": fobj_s * 1e3 / r,
                                "gradients_to_device": h2d_s * 1e3 / r,
                                "round_trip": (d2h_s + fobj_s + h2d_s)
                                * 1e3 / r},
           "launches_by_kernel": _fused_check("fobj", counts)}
    if not abs(valid_auc - ref_auc) <= 0.01:
        raise AssertionError(f"fobj valid AUC {valid_auc} not within 0.01 "
                             f"of train's {ref_auc}")
    out["profile"] = profile_iteration(b, wall / r, fobj=fobj)
    return out, counts


def _control_init_model(lgb, cuda_hist, params, train, valid, X, y, Xv, yv):
    """CONTROL_INIT_ROUNDS rounds, then CONTROL_MORE_ROUNDS more from that
    Booster (datasets that keep their raw rows): the first tree blocks
    byte-identical to the init model's, predictions within the JAX
    package's bar of a run of all the rounds at once."""
    from lightgbm_tpu_torch import engine as engine_mod
    total = CONTROL_INIT_ROUNDS + CONTROL_MORE_ROUNDS
    first = lgb.train(params, train, CONTROL_INIT_ROUNDS)
    tr = lgb.Dataset(X, label=y, params=params, free_raw_data=False)
    va = lgb.Dataset(Xv, label=yv, reference=tr, free_raw_data=False)
    tr.construct()
    va.construct()
    acc = {}
    orig = _timed(engine_mod, "_load_init_model", acc)
    try:
        cont, wall, counts = _counted(cuda_hist, lambda: lgb.train(
            params, tr, CONTROL_MORE_ROUNDS, valid_sets=[va],
            init_model=first))
    finally:
        engine_mod._load_init_model = orig
    full = lgb.train(params, train, total)
    pc, pf = cont.predict(Xv), full.predict(Xv)
    out = {"rounds": [CONTROL_INIT_ROUNDS, CONTROL_MORE_ROUNDS],
           "trees": cont.num_trees(), "wall_s": wall,
           "init_scores_host_s": sum(acc["_load_init_model"]),
           "sec_per_iter_after_init_scores":
           (wall - sum(acc["_load_init_model"])) / CONTROL_MORE_ROUNDS,
           "init_blocks_identical": _blocks(cont.model_to_string())
           [:CONTROL_INIT_ROUNDS] == _blocks(first.model_to_string()),
           "max_abs_diff_vs_full_run": float(np.abs(pc - pf).max()),
           "within_rtol_atol": bool(np.allclose(
               pc, pf, rtol=CONTROL_PREDICT_RTOL,
               atol=CONTROL_PREDICT_ATOL)),
           "launches_by_kernel": _fused_check("init_model", counts)}
    if not (out["init_blocks_identical"] and out["trees"] == total
            and out["within_rtol_atol"]):
        raise AssertionError(f"init_model: {out}")
    return out, counts, tr, first


def _control_rollback(lgb, cuda_hist, params, train, valid, Xv):
    """3 rounds, rollback_one_iter, one update(): the tree count follows,
    and the rolled-back model predicts as a 2-round run, its valid scores
    within float32 rounding of that run's."""
    seen = {}

    def run():
        b = lgb.train(params, train, 3, valid_sets=[valid])
        seen["trees"] = [b.num_trees()]
        b.rollback_one_iter()
        seen["trees"].append(b.num_trees())
        seen["pred"] = b.predict(Xv, raw_score=True)
        seen["valid_score"] = b._boosting._valid_scores[0].cpu().numpy()
        b.update()
        seen["trees"].append(b.num_trees())
        return b
    b, wall, counts = _counted(cuda_hist, run)
    two = lgb.train(params, train, 2, valid_sets=[valid])
    score_diff = float(np.abs(seen["valid_score"] - two._boosting
                              ._valid_scores[0].cpu().numpy()).max())
    out = {"trees_3_rolled_back_updated": seen["trees"], "wall_s": wall,
           "predict_equals_2_rounds": bool(np.array_equal(
               seen["pred"], two.predict(Xv, raw_score=True))),
           "valid_score_max_abs_diff_vs_2_rounds": score_diff,
           "launches_by_kernel": _fused_check("rollback", counts)}
    if not (seen["trees"] == [3, 2, 3] and out["predict_equals_2_rounds"]
            and score_diff <= CONTROL_SCORE_ATOL):
        raise AssertionError(f"rollback: {out}")
    return out, counts, b


def _control_cv(lgb, cuda_hist, params, full):
    """cv with CONTROL_CV_FOLDS stratified folds, CONTROL_CV_ROUNDS rounds
    and early stopping on the train rows: each fold's seconds, the host's
    row subset apart from the fold sets' construct (binning on the card)
    and from its training, and each fold's launches."""
    from lightgbm_tpu_torch import basic as basic_mod
    from lightgbm_tpu_torch import booster as booster_mod
    per = {}
    o_subset = basic_mod.Dataset.subset
    o_construct = basic_mod.Dataset.construct
    o_update = booster_mod.Booster.update

    def timed(key, fn):
        def wrapped(self, *a, **k):
            t0 = time.time()
            c0 = cuda_hist.launch_counts()
            res = fn(self, *a, **k)
            torch.cuda.synchronize()
            ident = id(res) if key == "subset_s" else id(self)
            d = per.setdefault(ident, {"launches": {}})
            d[key] = d.get(key, 0.0) + time.time() - t0
            if key == "train_s":
                c1 = cuda_hist.launch_counts()
                for c in c1:
                    d["launches"][c] = d["launches"].get(c, 0) \
                        + c1[c] - c0[c]
            return res
        return wrapped
    basic_mod.Dataset.subset = timed("subset_s", o_subset)
    basic_mod.Dataset.construct = timed("construct_s", o_construct)
    booster_mod.Booster.update = timed("train_s", o_update)
    try:
        res, wall, counts = _counted(cuda_hist, lambda: lgb.cv(
            params, full, CONTROL_CV_ROUNDS, nfold=CONTROL_CV_FOLDS,
            stratified=True, early_stopping_rounds=CONTROL_STOP,
            return_cvbooster=True))
    finally:
        basic_mod.Dataset.subset = o_subset
        basic_mod.Dataset.construct = o_construct
        booster_mod.Booster.update = o_update
    folds, fold_counts = [], []
    for b in res["cvbooster"].boosters:
        tr, te = b._train_set, b._boosting.valid_sets[0]
        f = {"train_rows": tr.num_data, "test_rows": te.num_data}
        for key in ("subset_s", "construct_s"):
            f[key] = sum(per.get(id(d), {}).get(key, 0.0) for d in (tr, te))
        f["train_s"] = per[id(b)]["train_s"]
        fold_counts.append(per[id(b)]["launches"])
        f["launches_by_kernel"] = _fused_check(f"cv fold {len(folds)}",
                                               fold_counts[-1])
        folds.append(f)
    host = sum(f["subset_s"] for f in folds)
    out = {"folds": folds, "wall_s": wall, "host_subset_share": host / wall,
           "construct_share": sum(f["construct_s"] for f in folds) / wall,
           "best_iteration": res["cvbooster"].best_iteration,
           "result_keys": sorted(k for k in res if k != "cvbooster"),
           "valid_binary_logloss_mean":
           res["valid binary_logloss-mean"][-1]}
    return out, counts, fold_counts


def train_control_phase(lgb, cuda_hist, args, ref):
    """Training control on train's 2M + 200k Higgs-shaped rows (binary,
    255 leaves, max_bin 255; the fused path), each run's launches of
    kernels 1, 2 and the epilogue above 0: early stopping with a
    learning-rate schedule, fobj, init_model, rollback, refit of the
    3-round model on the valid rows (its text equal to a CPU refit),
    free_dataset (device memory back >= the bin matrix's bytes, predict
    unchanged) and cv. ``ref``: train's result (sec/iter, AUC)."""
    X, y, Xv, yv = higgs_rows(args)
    params = dict(PARAMS, device_type="cuda", metric="binary_logloss")
    t0 = time.time()
    train = lgb.Dataset(X, label=y, params=params)
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    train.construct()
    valid.construct()
    torch.cuda.synchronize()
    out = {"rows": args.rows, "valid_rows": args.valid_rows, "features": F,
           "num_leaves": LEAVES, "construct_s": time.time() - t0,
           "train_sec_per_iter": ref["sec_per_iter"]}
    paths = {}
    out["early_stopping"], paths["early_stopping"] = _control_early_stopping(
        lgb, cuda_hist, params, train, valid)
    out["fobj"], paths["fobj"] = _control_fobj(
        lgb, cuda_hist, args, params, train, Xv, yv, ref["valid_auc"])
    (out["init_model"], paths["init_model"], full,
     first) = _control_init_model(lgb, cuda_hist, params, train, valid,
                                  X, y, Xv, yv)
    out["rollback"], paths["rollback"], rolled = _control_rollback(
        lgb, cuda_hist, params, train, valid, Xv)

    t0 = time.time()
    refit = first.refit(Xv, yv)
    refit_s = time.time() - t0
    cpu = lgb.Booster(params=dict(params, device_type="cpu"),
                      model_str=first.model_to_string()).refit(Xv, yv)
    out["refit"] = {"rows": args.valid_rows, "seconds": refit_s,
                    "text_equals_cpu_refit":
                    refit.model_to_string() == cpu.model_to_string()}
    if not out["refit"]["text_equals_cpu_refit"]:
        raise AssertionError(f"refit: {out['refit']}")

    pred = rolled.predict(Xv[:LINEAR_PREDICT_ROWS])
    bins_bytes = train.binsT.numel() * train.binsT.element_size()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rolled.free_dataset()
    torch.cuda.synchronize()
    released = before - torch.cuda.memory_allocated()
    out["free_dataset"] = {
        "released_bytes": released, "bin_matrix_bytes": bins_bytes,
        "predict_unchanged": bool(np.array_equal(
            rolled.predict(Xv[:LINEAR_PREDICT_ROWS]), pred))}
    if not (released >= bins_bytes and out["free_dataset"]
            ["predict_unchanged"]):
        raise AssertionError(f"free_dataset: {out['free_dataset']}")

    out["cv"], paths["cv"], folds = _control_cv(lgb, cuda_hist, params, full)
    paths.update({f"cv_fold{i}": c for i, c in enumerate(folds)})
    return out, paths


def control_text(lgb, name, setup, device: str) -> str:
    """One parity_control run on ``device`` (its model text): early
    stopping with a rate schedule, fobj with feval, init_model continued,
    3 rounds -> rollback -> 1, reset_parameter of lambda_l2 and the
    bagging fraction mid-run, cv fold 0's booster; at most 3 rounds."""
    X, y, params = setup
    p = dict(params, device_type=device)
    cut = len(X) * 4 // 5

    def sets():
        tr = lgb.Dataset(X[:cut], label=y[:cut], params=dict(p),
                         free_raw_data=False)
        return tr, lgb.Dataset(X[cut:], label=y[cut:], reference=tr,
                               free_raw_data=False)
    tr, va = sets()
    if name == "early_stopping":
        b = lgb.train(p, tr, 3, valid_sets=[va], early_stopping_rounds=1,
                      learning_rates=[0.1, 3.0, 3.0])
    elif name == "fobj":
        b = lgb.train(dict(p, metric="None"), tr, 3, valid_sets=[va],
                      fobj=_binary_fobj([]),
                      feval=lambda s, d: ("mean", float(s.mean()), True))
    elif name == "init_model":
        first = lgb.train(p, tr, 2)
        tr, va = sets()
        b = lgb.train(p, tr, 1, valid_sets=[va], init_model=first)
    elif name == "rollback":
        b = lgb.train(p, tr, 3, valid_sets=[va])
        b.rollback_one_iter()
        b.update()
    elif name == "reset_parameter":
        b = lgb.train(dict(p, bagging_fraction=0.8, bagging_freq=1), tr, 3,
                      valid_sets=[va], callbacks=[lgb.reset_parameter(
                          lambda_l2=lambda i: 0.0 if i < 1 else 4.0,
                          bagging_fraction=lambda i: 0.8 if i < 2 else 0.4)])
    else:
        b = lgb.cv(p, tr, 3, nfold=3,
                   return_cvbooster=True)["cvbooster"].boosters[0]
    return b.model_to_string()


CONTROL_RUNS = ("early_stopping", "fobj", "init_model", "rollback",
                "reset_parameter", "cv_fold0")


def parity_control_phase(lgb, seed):
    """Each CONTROL_RUNS run at PARITY_ROWS Higgs-shaped rows, 63 leaves:
    two card runs and the CPU run in the kernels' orders give the same
    model text; the first card run's fused-path launches above 0."""
    from lightgbm_tpu_torch.ops import cuda_hist
    X, y = higgs_like(PARITY_ROWS, seed + 79)
    setup = (X, y, dict(PARAMS, num_leaves=63, metric="binary_logloss"))
    out = {"rows": PARITY_ROWS, "num_leaves": 63, "rounds_at_most": 3}
    for name in CONTROL_RUNS:
        text, _, counts = _counted(cuda_hist, lambda: control_text(
            lgb, name, setup, "cuda"))
        again = control_text(lgb, name, setup, "cuda")
        with cuda_hist.kernel_sums_on_cpu():
            cpu = control_text(lgb, name, setup, "cpu")
        res = {"card_runs_identical_text": text == again,
               "card_equals_cpu_kernel_order": text == cpu,
               "trees": text.count("Tree="),
               "card_text_sha256": _sha(text),
               "launches_by_kernel": _fused_check(f"parity_control/{name}",
                                                  counts)}
        if not (res["card_runs_identical_text"]
                and res["card_equals_cpu_kernel_order"]):
            raise AssertionError(f"parity_control/{name}: {res}")
        out[name] = res
    return out


def control_phases(lgb, cuda_hist, args, ref):
    """The control group's phases, each emitted; returns each train_control
    run's launch counts by path for the kernels line."""
    t0 = time.time()
    tc, paths = train_control_phase(lgb, cuda_hist, args, ref)
    emit("train_control", seconds=time.time() - t0, **tc)
    t0 = time.time()
    pc = parity_control_phase(lgb, args.seed)
    emit("parity_control", seconds=time.time() - t0, **pc)
    return {f"train_control/{k}": v for k, v in paths.items()}


# prediction and the user surface: the ensemble traversal kernel, Booster
# .predict in every mode, TreeSHAP, the CLI and the sklearn estimator
PREDICT_ROUNDS = 100          # the group's model: 100 rounds of 255 leaves
PREDICT_TRAIN_ROWS = 500_000  # of train's Higgs-shaped rows
PREDICT_CPU_ROWS = 20_000     # rows the CPU twin predicts raw (plain torch)
PREDICT_MODE_ROWS = 20_000    # rows of the pred_leaf / early-stop / window checks
PREDICT_WIDE_ROUNDS = 3       # max_bin 1,023 (int16 bins)
PREDICT_CAT_ROWS = 50_000     # the Expo-shaped categorical model's rows
PREDICT_MC_ROWS = 50_000      # the Covertype-shaped K = 7 model's rows
PREDICT_MC_ROUNDS = 3
CONTRIB_ROWS = 10_000         # TreeSHAP rows on the card
CONTRIB_CPU_ROWS = 200        # of them, also run on the CPU (float64 DP)
CONTRIB_AGAIN_ROWS = 2_000    # of them, run twice on the card (same bits)
CLI_ROWS = 50_000             # the CLI's and the sklearn estimator's rows
CLI_ROUNDS = 3
# the kernel's operations a node visit: the node record's two 16-byte
# loads, the bin's address and load, the categorical / segment / missing
# tests and the child select, ~20 integer operations (the bound counts
# them at the guide's 67 T/s)
OPS_PER_VISIT = 20
SHAP_RTOL, SHAP_ATOL = 1e-9, 1e-11        # tests/test_shap_fast.py:25
SUM_RTOL, SUM_ATOL = 1e-6, 1e-8           # tests/test_shap_fast.py:96


def _flat(carry):
    return torch.cat(carry, 1) if isinstance(carry, tuple) else carry


def _cpu_tables(P, tables):
    """The kernel's tables copied to the CPU (the plain version's run on
    the same trees)."""
    st = type(tables.stacked)(*(x.cpu() for x in tables.stacked))
    return P.EnsembleTables(st, tables.nodes.cpu(), tables.bits.cpu(),
                            tables.depth)


def ensemble_case(P, tables, binsT, mb, k, seed, timed=False, mode=None):
    """``predict_ensemble`` on one bin matrix against its plain version on
    the same card tensors, in each accumulation mode without and with the
    biases and with an active mask of half the rows, and in leaves mode:
    bitwise, and a second launch equal; every launch in the geometry
    ``mode`` (``P.launch_geometry``'s choice for the shape). ``timed``: the
    float64 mode's ms (events), device ms (profiler), plain ms and
    bound."""
    from lightgbm_tpu_torch.ops import cuda_hist
    dev = binsT.device
    n = binsT.shape[1]
    t = int(tables.nodes.shape[0])
    geo = P.launch_geometry(
        n, binsT.shape[0], binsT.element_size(), int(tables.nodes.shape[1]),
        int(tables.stacked.leaf_value.shape[1]), tables.has_cat,
        tables.has_seg,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    if mode is not None and geo.mode != mode:
        raise AssertionError(f"predict_ensemble at {tuple(binsT.shape)}: "
                             f"geometry {geo.mode}, expected {mode}")
    cuda_hist.reset_launch_counts()
    rng = np.random.RandomState(seed)
    bias = torch.as_tensor(rng.randn(t) * 0.01, dtype=torch.float64,
                           device=dev)
    act = torch.as_tensor(rng.rand(n) < 0.5, device=dev)
    cases = 0
    for accum in ("float64", "compensated", "float32"):
        for kw in ({}, {"bias": bias}, {"bias": bias, "active": act}):
            one = _flat(P.predict_ensemble(tables, binsT, mb, (0, t), k,
                                           accum=accum, **kw))
            two = _flat(P.predict_ensemble(tables, binsT, mb, (0, t), k,
                                           accum=accum, **kw))
            ref = _flat(P.predict_ensemble_plain(
                tables, binsT, mb, (0, t), k, kw.get("bias"),
                kw.get("active"), P.new_carry(n, k, accum, dev), accum))
            if not (torch.equal(one, ref) and torch.equal(one, two)):
                raise AssertionError(
                    f"predict_ensemble {accum} {sorted(kw)} at {n} rows: "
                    f"max |kernel - plain| "
                    f"{float((one - ref).abs().max())}")
            cases += 1
    leaves = P.predict_ensemble(tables, binsT, mb, (0, t), k, leaves=True)
    again = P.predict_ensemble(tables, binsT, mb, (0, t), k, leaves=True)
    ref = P.predict_ensemble_plain(tables, binsT, mb, (0, t), k, leaves=True)
    if not (torch.equal(leaves, ref) and torch.equal(leaves, again)):
        raise AssertionError(f"predict_ensemble leaves at {n} rows differ "
                             f"from the plain version")
    visits = P.node_visits(tables, leaves, (0, t))
    counts = cuda_hist.launch_counts()
    launched = {m: counts[f"predict_ensemble_geometry.launches_{m}"]
                for m in P.GEOMETRY_MODES}
    if launched[geo.mode] != 2 * (cases + 1) or sum(launched.values()) != \
            launched[geo.mode]:
        raise AssertionError(f"predict_ensemble's geometry launches "
                             f"{launched}, expected {2 * (cases + 1)} in "
                             f"{geo.mode}")
    out = {"rows": n, "columns": int(binsT.shape[0]), "trees": t, "k": k,
           "bins": str(binsT.dtype), "depth": tables.depth,
           "leaves_cap": int(tables.stacked.leaf_value.shape[1]),
           "cases_bitwise": cases + 1, "node_visits": visits,
           "geometry": {"mode": geo.mode, "threads": geo.threads,
                        "rows_a_tile": geo.rows, "chunk_trees":
                        geo.chunk_trees, "stage_bytes": geo.stage.bytes,
                        "smem": geo.smem, "blocks": geo.blocks}}
    if timed:
        def run():
            P.predict_ensemble(tables, binsT, mb, (0, t), k)
        out["ms"] = time_ms(run)
        out["device_ms"] = device_ms(run, need="predict_ensemble")[0]
        def run_leaves():
            P.predict_ensemble(tables, binsT, mb, (0, t), k, leaves=True)
        out["leaves_ms"] = time_ms(run_leaves)
        out["leaves_device_ms"] = device_ms(run_leaves,
                                            need="predict_ensemble")[0]
        out["plain_ms"] = time_ms(lambda: P.predict_ensemble_plain(
            tables, binsT, mb, (0, t), k, None, None,
            P.new_carry(n, k, "float64", dev), "float64"), reps=3, warm=0)
        st = tables.stacked
        nbytes = (binsT.numel() * binsT.element_size() + n * k * 8
                  + tables.nodes.numel() * 4 + tables.bits.numel() * 4
                  + st.leaf_value.numel() * 4 + mb.numel() * 4)
        out["bound_ms"], out["bound_by"] = bound(nbytes,
                                                 visits * OPS_PER_VISIT)
        out["library_ms"] = None
    return out


def predict_model(lgb, args, X, y, rounds=PREDICT_ROUNDS, **extra):
    params = dict(PARAMS, device_type="cuda", **extra)
    t0 = time.time()
    booster = lgb.train(params, lgb.Dataset(X, label=y, params=dict(params)),
                        rounds)
    torch.cuda.synchronize()
    return booster, time.time() - t0


def random_trees(count: int, leaves: int, f: int, b: int, seed: int,
                 segments: bool = False):
    """``count`` random unbalanced trees of ``leaves`` leaves over ``f``
    columns of ``b`` bins (a leaf drawn at random splits next, on a random
    column and threshold, default directions at random; with ``segments``
    a third of the nodes on EFB bundle segments), stacked as the port's
    TreeArrays: ensembles past what the train phases grow."""
    from lightgbm_tpu_torch.models.tree import empty_tree, stack_trees
    rng = np.random.RandomState(seed)
    trees = []
    for _ in range(count):
        li = leaves - 1
        left = np.zeros(li, np.int32)
        right = np.zeros(li, np.int32)
        depth = {0: 0}
        open_leaves, link = [0], {}
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
        trees.append(empty_tree(leaves)._replace(
            num_leaves=torch.tensor(leaves, dtype=torch.int32),
            node_feature=torch.as_tensor(rng.randint(0, f, li),
                                         dtype=torch.int32),
            node_threshold_bin=torch.as_tensor(rng.randint(0, b - 1, li),
                                               dtype=torch.int32),
            node_default_left=torch.as_tensor(rng.rand(li) < 0.5),
            node_left=torch.as_tensor(left), node_right=torch.as_tensor(right),
            leaf_value=torch.as_tensor(rng.randn(leaves).astype(np.float32)),
            leaf_depth=torch.as_tensor(
                np.array([depth[i] for i in range(leaves)], np.int32))))
        if segments:
            lo = rng.randint(0, b // 2, li)
            seg = rng.rand(li) < 1 / 3
            trees[-1] = trees[-1]._replace(
                node_seg_lo=torch.as_tensor(np.where(seg, lo, -1),
                                            dtype=torch.int32),
                node_seg_hi=torch.as_tensor(np.where(seg, lo + b // 3, -1),
                                            dtype=torch.int32))
    return stack_trees(trees)


def wide_slice(binsT, mb, columns: int, pad: int = 37):
    """``binsT`` as the first rows of a ``columns``-row bin matrix, handed
    over as a column slice (leading dimension N + pad): the other columns
    are 0 and their missing bins -1, so the trees' walks are the same."""
    f, n = binsT.shape
    big = torch.zeros((columns, n + pad), dtype=binsT.dtype,
                      device=binsT.device)
    big[:f, 5:5 + n] = binsT
    wmb = torch.full((columns,), -1, dtype=mb.dtype, device=mb.device)
    wmb[:f] = mb
    return big[:, 5:5 + n], wmb


PREDICT_WIDE_COLUMNS = 2_000     # Epsilon's width: the bins stay in global
PREDICT_TILED_LEAVES = 1_023     # 12 KB a tree: the tiled mode's deepest
PREDICT_DEEP_LEAVES = 4_095      # with EFB segments: the global mode
PREDICT_DEEP_TREES = 4
PREDICT_EDGE_TREES = 20          # the model's first trees, in the wide cases
_mc_cache = {}


def first_trees(P, tables, count: int):
    """The kernel's tables of an ensemble's first ``count`` trees."""
    from lightgbm_tpu_torch.models.tree import TreeArrays
    return P.pack_ensemble(TreeArrays(*(x[:count] for x in tables.stacked)),
                           tables.depth, tables.nodes.device)


def multiclass_model(lgb, args):
    """The predict group's K = 7 Covertype-shaped model (50,000 rows, 3
    rounds) and its rows, trained once a run."""
    if args.seed not in _mc_cache:
        Xk, yk = covertype_like(PREDICT_MC_ROWS, args.seed)
        kb = lgb.train(dict(PARAMS, device_type="cuda", **MULTICLASS),
                       lgb.Dataset(Xk, label=yk,
                                   params={"device_type": "cuda"}),
                       PREDICT_MC_ROUNDS)
        _mc_cache[args.seed] = (kb, Xk)
    return _mc_cache[args.seed]


def predict_ensemble_phase(lgb, P, args, model):
    """The kernel alone at the main path's shapes: the 100-round model over
    the bins of the 2M train and 200k valid rows; then int16 bins
    (max_bin 1,023), categorical bitsets (Expo-shaped, ``global``), the
    K = 7 carry (Covertype-shaped), 1,023-leaf trees (``tiled``), and the
    shapes the rule sends to ``global``: the 200k rows as 2,000 columns
    (on the model's first PREDICT_EDGE_TREES trees) and 4,095-leaf trees
    with EFB segments. Only the main path's tiled shapes are timed."""
    b, X, Xv = model
    g = b._boosting
    eng = g._predict_engine()
    mb = g.train_set.missing_bin.cuda()
    out = {}
    for name, rows, timed in (("2M", X, True), ("200k", Xv, True)):
        binsT = g.train_set.bin_new_data(rows)
        out[name] = ensemble_case(P, eng.tables, binsT, mb, 1, args.seed,
                                  timed=timed, mode="tiled")
        if name == "200k":
            head = first_trees(P, eng.tables, PREDICT_EDGE_TREES)
            wide, wmb = wide_slice(binsT, mb, PREDICT_WIDE_COLUMNS)
            out["columns_2000_200k"] = ensemble_case(
                P, head, wide, wmb, 1, args.seed + 3, mode="global")
            del wide, wmb, head
            for leaves, segments, mode in (
                    (PREDICT_TILED_LEAVES, False, "tiled"),
                    (PREDICT_DEEP_LEAVES, True, "global")):
                st = random_trees(PREDICT_DEEP_TREES, leaves, F, B,
                                  args.seed + 4, segments)
                deep = P.pack_ensemble(st, int(st.leaf_depth.max()), "cuda")
                out[f"leaves_{leaves}" + ("_segments" if segments else "")
                    + "_200k"] = ensemble_case(
                    P, deep, binsT, mb, 1, args.seed + 4, mode=mode)
                del deep
        del binsT
    _, y = higgs_rows(args)[:2]
    wb, _ = predict_model(lgb, args, X[:PREDICT_TRAIN_ROWS],
                          y[:PREDICT_TRAIN_ROWS], PREDICT_WIDE_ROUNDS,
                          max_bin=1023)
    wg = wb._boosting
    wbins = wg.train_set.bin_new_data(Xv)
    if wbins.dtype != torch.int16:
        raise AssertionError(f"max_bin 1023 binned to {wbins.dtype}")
    out["wide_200k"] = ensemble_case(P, wg._predict_engine().tables, wbins,
                                     wg.train_set.missing_bin.cuda(), 1,
                                     args.seed + 1, timed=True, mode="tiled")
    Xc, yc = expo_like(PREDICT_CAT_ROWS, args.seed)
    cb = lgb.train(dict(PARAMS, device_type="cuda",
                        categorical_feature=CAT_COLUMNS),
                   lgb.Dataset(Xc, label=yc, categorical_feature=CAT_COLUMNS,
                               params={"device_type": "cuda"}), 5)
    cg = cb._boosting
    ctab = cg._predict_engine().tables
    if not bool(ctab.stacked.node_cat.any()):
        raise AssertionError("the Expo-shaped model made no categorical "
                             "split")
    out["categorical_50k"] = ensemble_case(
        P, ctab, cg.train_set.bin_new_data(Xc),
        cg.train_set.missing_bin.cuda(), 1, args.seed + 2, mode="global")
    out["categorical_50k"]["words"] = int(ctab.bits.shape[2])
    kb, Xk = multiclass_model(lgb, args)
    kg = kb._boosting
    keng = kg._predict_engine()
    out["multiclass_k7_50k"] = ensemble_case(
        P, keng.tables, kg.train_set.bin_new_data(Xk),
        kg.train_set.missing_bin.cuda(), keng.k, args.seed + 6, mode="tiled")
    return out


def _twin(lgb, booster):
    """The booster's own trees carried to a ``device_type="cpu"`` booster
    (``convert.booster_to_numpy`` -> ``booster_from_numpy``): the CPU's
    plain versions over the same trees."""
    return lgb.booster_from_numpy(*lgb.booster_to_numpy(booster, "cpu"))


def _equal(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = (np.max(np.abs(got.astype(np.float64)
                              - want.astype(np.float64)))
                if got.shape == want.shape else f"{got.shape}/{want.shape}")
        raise AssertionError(f"{name}: card and CPU differ ({diff})")


def _median_s(fn, reps: int = 5) -> float:
    """Median host seconds of ``fn`` (each call ends in a fetch)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        times.append(time.time() - t0)
    return statistics.median(times)


def _predict_launches(cuda_hist, P):
    c = cuda_hist.launch_counts()
    return sum(v for k, v in c.items() if k.startswith("predict_ensemble."))


def _geometry_launches(cuda_hist, P):
    c = cuda_hist.launch_counts()
    return {m: c[f"predict_ensemble_geometry.launches_{m}"]
            for m in P.GEOMETRY_MODES}


def predict_e2e_phase(lgb, cuda_hist, P, args, model):
    """Booster.predict end to end on the card, its time split, and its
    outputs against the same trees on the CPU; on the 2M rows also the
    first call after the engine is dropped (``seconds_cold``: the trees
    packed and staged again, as after training or a new tree window).
    Each path's launches by geometry (``geometry_by_path``); the 2M rows
    must take the tiled mode."""
    b, X, Xv = model
    g = b._boosting
    twin = _twin(lgb, b)
    out, paths, geometry = {}, {}, {}
    for name, rows in (("2M", X), ("200k", Xv)):
        b.predict(rows[:1000])                 # warm
        cold = None
        if name == "2M":
            g._engine_cache.clear()
            torch.cuda.synchronize()
            t0 = time.time()
            b.predict(rows)
            torch.cuda.synchronize()
            cold = time.time() - t0
        torch.cuda.synchronize()
        cuda_hist.reset_launch_counts()
        t0 = time.time()
        pred = b.predict(rows)
        torch.cuda.synchronize()
        total = time.time() - t0
        launched = _predict_launches(cuda_hist, P)
        paths[f"predict/{name}"] = launched
        geometry[f"predict/{name}"] = _geometry_launches(cuda_hist, P)
        if launched < 1:
            raise AssertionError(f"Booster.predict on {name} rows launched "
                                 f"no predict_ensemble")
        if name == "2M" and geometry["predict/2M"]["tiled"] != launched:
            raise AssertionError(f"Booster.predict on 2M rows: geometries "
                                 f"{geometry['predict/2M']}, expected "
                                 f"{launched} tiled")
        # the same call in its parts
        t0 = time.time()
        Xp = g._prep_predict_X(rows)
        t_check = time.time() - t0
        t0 = time.time()
        binsT = g.train_set.bin_new_data(Xp)
        torch.cuda.synchronize()
        t_bin = time.time() - t0
        eng = g._predict_engine()
        t0 = time.time()
        carry = eng.accumulate(binsT, g.train_set.missing_bin, use_bias=False)
        torch.cuda.synchronize()
        t_kernel = time.time() - t0
        # the conversion ends in the fetch of its float32 result: the
        # fetch of a float32 [N] alone is timed apart (medians of 5)
        conv = g._convert_on_device(carry[:, 0])
        _equal(f"predict/{name} parts", conv, pred)
        s32 = carry[:, 0].to(torch.float32)
        t_convert_fetch = _median_s(lambda: g._convert_on_device(
            carry[:, 0]))
        t_fetch = _median_s(lambda: s32.cpu())
        out[name] = {"rows": len(rows), "seconds": total,
                     "seconds_cold": cold,
                     "launches_per_call": launched,
                     "split_s": {"input_checks_host": t_check,
                                 "binning_on_card": t_bin,
                                 "kernel": t_kernel,
                                 "conversion": t_convert_fetch - t_fetch,
                                 "fetch": t_fetch},
                     "rows_per_s": len(rows) / total}
        del binsT, carry
    # the same trees on the CPU
    Xc = Xv[:PREDICT_CPU_ROWS]
    t0 = time.time()
    raw_cpu = twin.predict(Xc, raw_score=True)
    cpu_s = time.time() - t0
    _equal("raw", b.predict(Xc, raw_score=True), raw_cpu)
    _equal("converted", b.predict(Xc),
           twin._boosting._convert_on_device(torch.as_tensor(raw_cpu)))
    Xm = Xv[:PREDICT_MODE_ROWS]
    checks = {"raw_rows": len(Xc), "cpu_raw_s": cpu_s}
    for name, kw in (("pred_leaf", {"pred_leaf": True}),
                     ("pred_early_stop", {"pred_early_stop": True,
                                          "pred_early_stop_freq": 10,
                                          "pred_early_stop_margin": 1.5}),
                     ("window", {"start_iteration": 20,
                                 "num_iteration": 30, "raw_score": True})):
        cuda_hist.reset_launch_counts()
        got = b.predict(Xm, **kw)
        paths[f"predict/{name}"] = _predict_launches(cuda_hist, P)
        geometry[f"predict/{name}"] = _geometry_launches(cuda_hist, P)
        _equal(name, got, twin.predict(Xm, **kw))
        checks[name] = {"rows": len(Xm),
                        "launches": paths[f"predict/{name}"]}
    es_raw = b.predict(Xm, raw_score=True, pred_early_stop=True,
                       pred_early_stop_freq=10, pred_early_stop_margin=1.5)
    full = b.predict(Xm, raw_score=True)
    checks["pred_early_stop"]["rows_stopped_early"] = int(
        np.sum(es_raw != full))
    out["bitwise_cpu"] = checks
    # K = 7
    kb, Xk = multiclass_model(lgb, args)
    ktwin = _twin(lgb, kb)
    cuda_hist.reset_launch_counts()
    kraw = kb.predict(Xk, raw_score=True)
    paths["predict/multiclass"] = _predict_launches(cuda_hist, P)
    geometry["predict/multiclass"] = _geometry_launches(cuda_hist, P)
    _equal("multiclass raw", kraw, ktwin.predict(Xk, raw_score=True))
    _equal("multiclass converted", kb.predict(Xk), ktwin.predict(Xk))
    _equal("multiclass pred_leaf", kb.predict(Xk, pred_leaf=True),
           ktwin.predict(Xk, pred_leaf=True))
    out["multiclass"] = {"rows": len(Xk), "k": 7, "trees": kb.num_trees(),
                         "bitwise_cpu": True}
    # score_dataset with the per-tree biases vs the plain version on the CPU
    nv = PREDICT_MODE_ROWS
    _, _, _, yv = higgs_rows(args)
    vs = lgb.Dataset(Xv[:nv], label=yv[:nv], reference=g.train_set)
    cuda_hist.reset_launch_counts()
    score = g.score_dataset(vs)
    paths["score_dataset"] = _predict_launches(cuda_hist, P)
    geometry["score_dataset"] = _geometry_launches(cuda_hist, P)
    eng = g._predict_engine()
    if eng.biases is None:
        raise AssertionError("the model's trees carry no bias")
    base = torch.full((nv, 1), float(g.init_scores[0]), dtype=torch.float64)
    ref = P.predict_ensemble_plain(
        _cpu_tables(P, eng.tables), vs.traversal_binsT().cpu(),
        vs.missing_bin.cpu(), (0, eng.T), 1, eng.biases.cpu(), None, base)
    _equal("score_dataset", score, ref[:, 0].numpy())
    out["score_dataset"] = {"rows": nv, "bitwise_plain_cpu": True,
                            "bias_tree0": float(eng.biases[0])}
    out["geometry_by_path"] = geometry
    return out, paths


def predict_contrib_phase(lgb, cuda_hist, args, model):
    """TreeSHAP of the 100-round model on the card: seconds (the host's
    decisions apart), peak device memory, the CPU's values on a subset,
    and the sums-to-raw contract on every row."""
    from lightgbm_tpu_torch.io import shap as S
    b, X, Xv = model
    g = b._boosting
    rows = Xv[:CONTRIB_ROWS]
    b.predict(rows[:64], pred_contrib=True)     # the stacks, once
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    contrib = b.predict(rows, pred_contrib=True)
    torch.cuda.synchronize()
    total = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    split = dict(S.last_split)
    trees = [g._host_tree(it, 0) for it in range(b.num_trees())]
    stack = S._class_stack_cached(trees, rows.shape[1])
    raw = b.predict(rows, raw_score=True)
    sums = contrib.sum(axis=1)
    if not np.allclose(sums, raw, rtol=SUM_RTOL, atol=SUM_ATOL):
        raise AssertionError(f"contributions do not sum to the raw score: "
                             f"{np.max(np.abs(sums - raw))}")
    # the same call twice (another row count can take another product
    # algorithm, so rows are compared between calls of one shape)
    twice = [b.predict(rows[:CONTRIB_AGAIN_ROWS], pred_contrib=True)
             for _ in range(2)]
    if not np.array_equal(*twice):
        raise AssertionError("two card runs of TreeSHAP differ")
    # the CPU's DP (float64) on the same model trees and their stacks
    sub = np.asarray(rows[:CONTRIB_CPU_ROWS], np.float64)
    t0 = time.time()
    cpu = S.predict_contrib_trees_fast(trees, sub, rows.shape[1], 1,
                                       device="cpu")
    cpu_s = time.time() - t0
    if not np.allclose(contrib[:len(sub)], cpu, rtol=SHAP_RTOL,
                       atol=SHAP_ATOL):
        raise AssertionError(f"card SHAP vs CPU: "
                             f"{np.max(np.abs(contrib[:len(sub)] - cpu))}")
    return {"rows": len(rows), "trees": b.num_trees(), "predict_s": total,
            "split_s": {"decisions_host": split["decisions_s"],
                        "dp_device": split["dp_s"]},
            "peak_device_bytes": int(peak),
            "max_abs_vs_cpu": float(np.max(np.abs(contrib[:len(sub)] - cpu))),
            "cpu_rows": len(sub), "cpu_s": cpu_s,
            "max_abs_sum_vs_raw": float(np.max(np.abs(sums - raw))),
            "depth_buckets": [int(bk.Db) for bk in stack.buckets]}


def cli_phase(lgb, args):
    """``python -m lightgbm_tpu_torch`` on a 50,000-row CSV with a header,
    a named label column and a ``.weight`` side file: train, predict and
    convert_model, each a fresh interpreter on the card."""
    import tempfile
    from lightgbm_tpu_torch import cli, native
    from lightgbm_tpu_torch.io.codegen import model_to_if_else
    X, y = higgs_rows(args)[:2]
    X, y = X[:CLI_ROWS], y[:CLI_ROWS]
    w = np.random.RandomState(args.seed).uniform(0.5, 1.5, CLI_ROWS)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "train.csv")
        cols = [f"f{j}" for j in range(X.shape[1])]
        with open(csv, "w") as fh:
            fh.write(",".join(cols[:3] + ["label"] + cols[3:]) + "\n")
            body = np.column_stack([X[:, :3], y, X[:, 3:]])
            np.savetxt(fh, body, delimiter=",", fmt="%.9g")
        np.savetxt(csv + ".weight", w, fmt="%.6f")
        t0 = time.time()
        mat, fmt = native.parse_text_file(csv, has_header=True)
        t_native = time.time() - t0
        t0 = time.time()
        ref, _ = native._parse_text_file_py(csv, True)
        t_plain = time.time() - t0
        if not np.array_equal(mat, ref, equal_nan=True):
            raise AssertionError("the native parser differs from the plain "
                                 "parser")
        args_train = ["task=train", "objective=binary", "data=train.csv",
                      "header=true", "label_column=name:label",
                      f"num_iterations={CLI_ROUNDS}", "num_leaves=255",
                      "output_model=model.txt", "verbosity=-1",
                      "device_type=cuda"]
        steps = {}
        for step, a in (("train", args_train),
                        ("predict", ["task=predict", "data=train.csv",
                                     "header=true", "label_column=name:label",
                                     "input_model=model.txt",
                                     "output_result=preds.txt",
                                     "verbosity=-1", "device_type=cuda"]),
                        ("convert_model", ["task=convert_model",
                                           "input_model=model.txt",
                                           "convert_model=model.cpp",
                                           "verbosity=-1",
                                           "device_type=cuda"])):
            t0 = time.time()
            res = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                                  *a], cwd=tmp, env=env, capture_output=True,
                                 text=True, timeout=300)
            steps[step] = time.time() - t0
            if res.returncode != 0:
                raise AssertionError(f"CLI task={step} failed:\n"
                                     f"{res.stderr[-3000:]}")
        params = dict(x.split("=", 1) for x in args_train)
        Xf, yf, wf, gf, inf = cli.load_data_file(
            csv, lgb.Config.from_params(dict(params)))
        if wf is None or not np.array_equal(wf, np.loadtxt(csv + ".weight")):
            raise AssertionError("the .weight side file was not read")
        ds = lgb.Dataset(Xf, label=yf, weight=wf, params=dict(params),
                         free_raw_data=False)
        booster = lgb.train(dict(params), ds, CLI_ROUNDS)
        text = open(os.path.join(tmp, "model.txt")).read()
        if booster.model_to_string() != text:
            raise AssertionError("the CLI's model text differs from train "
                                 "on the same parsed arrays")
        preds = np.loadtxt(os.path.join(tmp, "preds.txt"))
        want = np.array([float(f"{v:.10g}") for v in booster.predict(Xf)])
        if not np.array_equal(preds, want):
            raise AssertionError("the CLI's predictions differ from "
                                 "Booster.predict")
        cpu_cpp = model_to_if_else(lgb.Booster(
            params={"device_type": "cpu"},
            model_file=os.path.join(tmp, "model.txt"))._boosting)
        if open(os.path.join(tmp, "model.cpp")).read() != cpu_cpp:
            raise AssertionError("convert_model's C++ differs from the "
                                 "CPU's")
        out = {"rows": CLI_ROWS, "columns": int(mat.shape[1]),
               "format": fmt, "native_parse_s": t_native,
               "plain_parse_s": t_plain, "task_s": steps,
               "model_text_equal_train": True,
               "predictions_equal_booster": True,
               "cpp_equal_cpu_bytes": len(cpu_cpp)}
    return out


def sklearn_phase(lgb, args):
    """LGBMRegressor fit and predict on the card: bitwise ``train`` with
    the parameters it maps."""
    from lightgbm_tpu_torch import sklearn as sk
    X, y = higgs_rows(args)[:2]
    X, y = X[:CLI_ROWS], y[:CLI_ROWS]
    est = lgb.LGBMRegressor(n_estimators=CLI_ROUNDS, num_leaves=255,
                            device_type="cuda")
    t0 = time.time()
    est.fit(X, y)
    pred = est.predict(X)
    torch.cuda.synchronize()
    secs = time.time() - t0
    params = est._booster_params()
    b = lgb.train(dict(params), lgb.Dataset(X, label=y, params=dict(params),
                                            free_raw_data=False), CLI_ROUNDS)
    if b.model_to_string() != est.booster_.model_to_string():
        raise AssertionError("LGBMRegressor's model differs from train's")
    _equal("LGBMRegressor.predict", pred, b.predict(X))
    return {"rows": CLI_ROWS, "seconds": secs, "sklearn_importable":
            sk._SKLEARN, "model_text_equal_train": True,
            "predict_equal_train": True}


_predict_model_cache = {}


def predict_group_model(lgb, args):
    """The predict group's model (100 rounds of 255 leaves on 500,000 of
    train's rows) with train's and valid's rows, trained once a run, and
    its training seconds."""
    if args.seed not in _predict_model_cache:
        X, y, Xv, _ = higgs_rows(args)
        b, train_s = predict_model(lgb, args, X[:PREDICT_TRAIN_ROWS],
                                   y[:PREDICT_TRAIN_ROWS])
        _predict_model_cache[args.seed] = ((b, X, Xv), train_s)
    return _predict_model_cache[args.seed]


def predict_kernel_phases(lgb, cuda_hist, args):
    """predict_ensemble and predict, each emitted; returns (the kernel
    phase's cases, the launches by path, and under ``"geometry"`` the
    predict paths' launches by geometry)."""
    from lightgbm_tpu_torch.ops import predict as P
    t0 = time.time()
    model, train_s = predict_group_model(lgb, args)
    pe = predict_ensemble_phase(lgb, P, args, model)
    emit("predict_ensemble", seconds=time.time() - t0,
         model={"rows": PREDICT_TRAIN_ROWS, "rounds": PREDICT_ROUNDS,
                "leaves": LEAVES, "train_s": train_s}, **pe)
    t0 = time.time()
    pr, paths = predict_e2e_phase(lgb, cuda_hist, P, args, model)
    emit("predict", seconds=time.time() - t0, **pr)
    return pe, dict(paths, geometry=pr["geometry_by_path"])


def predict_entry(pe, paths):
    """The kernels line's entry of predict_ensemble: the 2M-row float64
    case's numbers, every case's beside them, the launches by path."""
    main_case = pe["2M"]
    return {
        "name": "predict_ensemble", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/predict_ensemble.cu",
        "replaces": "none, a port-only kernel: lightgbm_tpu/models/"
                    "predict_engine.py:123 _accum_core + :182 _leaves_core "
                    "are plain jnp scans (no pallas_call)",
        "launches": paths["predict/2M"], "max_abs_err": 0.0,
        "geometry_by_path": paths["geometry"],
        **{k: main_case[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "node_visits", "rows", "trees")},
        "leaves_ms": main_case["leaves_ms"],
        "leaves_device_ms": main_case["leaves_device_ms"],
        "geometry": main_case["geometry"],
        "shapes": {k: {kk: v[kk] for kk in ("ms", "device_ms", "plain_ms",
                                            "bound_ms", "bound_by")}
                   | {"mode": v["geometry"]["mode"]}
                   for k, v in pe.items() if "ms" in v},
        "geometries_checked": sorted({v["geometry"]["mode"]
                                      for v in pe.values()}),
        "cases_bitwise": sum(v["cases_bitwise"] for v in pe.values()),
        "launches_by_path": {k: v for k, v in paths.items()
                             if k != "geometry" and v > 0}}


def predict_phases(lgb, cuda_hist, args):
    """The predict group's phases, each emitted; returns the kernels line's
    entry of predict_ensemble."""
    pe, paths = predict_kernel_phases(lgb, cuda_hist, args)
    model, _ = predict_group_model(lgb, args)
    t0 = time.time()
    pc = predict_contrib_phase(lgb, cuda_hist, args, model)
    emit("predict_contrib", seconds=time.time() - t0, **pc)
    t0 = time.time()
    cl = cli_phase(lgb, args)
    emit("cli", seconds=time.time() - t0, **cl)
    emit("sklearn", **sklearn_phase(lgb, args))
    return predict_entry(pe, paths)


# ------------------------------------------------------------------- serve
# The serve group (the ops layer's main path): the predict group's model
# behind the engine's serve mode and a ServeFrontend, then the telemetry
# layer around train's training.
SERVE_SIZES = (1, 64, 1024, 8192)   # predict_ensemble at serve flush sizes
SERVE_FLUSHES = 200                 # serve_steady's flushes of 1-8,192 rows
SERVE_BUCKETS = (1024, 2048, 4096, 8192)
SERVE_CLIENTS = 16                  # the serve phase's client threads
SERVE_SECONDS = 10.0                # their closed loops' length
SERVE_MAX_REQUEST = 256             # rows a request, uniform in 1..256
SERVE_SWAP_ROWS = 100_000           # the swapped-in model's training rows
SERVE_SWAP_CLIENTS = 4
TELEMETRY_TRACE_ITERS = 2


def serve_kernel_phase(P, args, model):
    """predict_ensemble at serve sizes over the predict group's model: each
    size's float64 launch bitwise its plain version and a second launch
    (``ensemble_case``: every mode, biases, the active mask, leaves), and
    its ms (events), device ms (profiler, cold L2; several launches a
    profile at the small sizes, whose lone activity the profiler can
    drop), plain ms and the bound as the 2M-row case computes it (each
    input byte once over 3.35 TB/s against this run's node visits x
    OPS_PER_VISIT over 67 T/s)."""
    b, _, Xv = model
    g = b._boosting
    eng = g._predict_engine()
    mb = g.train_set.missing_bin.cuda()
    out = {}
    for n in SERVE_SIZES:
        binsT = g.train_set.bin_new_data(Xv[:n])
        case = ensemble_case(P, eng.tables, binsT, mb, 1, args.seed + n)
        t = eng.T

        def run():
            P.predict_ensemble(eng.tables, binsT, mb, (0, t), 1)
        case["ms"] = time_ms(run)
        case["device_ms"] = device_ms(
            run, per_profile=1 if n >= 1024 else 20,
            need="predict_ensemble", cold_each=n < 1024)[0]
        case["plain_ms"] = time_ms(lambda: P.predict_ensemble_plain(
            eng.tables, binsT, mb, (0, t), 1, None, None,
            P.new_carry(n, 1, "float64", binsT.device), "float64"),
            reps=3, warm=1)
        st = eng.tables.stacked
        nbytes = (binsT.numel() * binsT.element_size() + n * 8
                  + eng.tables.nodes.numel() * 4
                  + eng.tables.bits.numel() * 4
                  + st.leaf_value.numel() * 4 + mb.numel() * 4)
        case["bound_ms"], case["bound_by"] = bound(
            nbytes, case["node_visits"] * OPS_PER_VISIT)
        case["library_ms"] = None
        out[str(n)] = case
    return out


def _serve_sizes(rng, count: int):
    """``count`` flush sizes of 1 to 8,192 rows, log-uniform."""
    return [int(v) for v in np.exp(rng.uniform(0, np.log(8192), count))
            .round().clip(1, 8192)]


def serve_steady_phase(lgb, cuda_hist, args, model):
    """SERVE_FLUSHES flushes of 1 to 8,192 rows through the engine's serve
    mode (Booster.predict, raw scores): after each bucket's first flush no
    device allocation (the caching allocator's request count), every slot
    buffer at its address, one predict_ensemble launch a flush, answers
    bitwise Booster.predict outside serve mode; the flushes' host ms, and
    with profiling on (each scope synchronised) the split into copy in,
    binning, kernel and fetch."""
    from lightgbm_tpu_torch.utils import profiling
    b, _, Xv = model
    g = b._boosting
    rng = np.random.RandomState(args.seed + 19)
    sizes = _serve_sizes(rng, SERVE_FLUSHES)
    starts = [int(rng.randint(0, len(Xv) - n)) for n in sizes]
    want = [b.predict(Xv[s:s + n], raw_score=True)
            for s, n in zip(starts, sizes)]
    g.enable_serve_mode(True)
    try:
        for n in SERVE_BUCKETS:                       # each slot's first
            b.predict(Xv[:n], raw_score=True)
        eng = g._predict_engine()
        if sorted(eng._serve_slots) != list(SERVE_BUCKETS):
            raise AssertionError(f"serve slots {sorted(eng._serve_slots)}")
        ptrs = {bk: {k: t.data_ptr() for k, t in sl.tensors().items()}
                for bk, sl in eng._serve_slots.items()}
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        cuda_hist.reset_launch_counts()
        got, host_ms = [], []
        for s, n in zip(starts, sizes):
            t0 = time.perf_counter()
            got.append(b.predict(Xv[s:s + n], raw_score=True))
            host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        alloc1 = torch.cuda.memory_stats()["allocation.all.allocated"]
        launches = _predict_launches(cuda_hist, None)
        same_ptrs = ptrs == {
            bk: {k: t.data_ptr() for k, t in sl.tensors().items()}
            for bk, sl in eng._serve_slots.items()}
        profiling.reset()
        profiling.enable(True)
        try:
            for s, n in zip(starts, sizes):
                b.predict(Xv[s:s + n], raw_score=True)
            sc = profiling.scopes()
        finally:
            profiling.enable(False)
            profiling.reset()
    finally:
        g.enable_serve_mode(False)
    bitwise = all(np.array_equal(w, o) for w, o in zip(want, got))
    split = {k: 1e3 * sc[f"serve_{k}"]["total_s"] / len(sizes)
             for k in ("copy_in", "bin", "kernel", "fetch")}
    out = {"flushes": len(sizes), "rows_min": min(sizes),
           "rows_max": max(sizes), "rows_mean": float(np.mean(sizes)),
           "buckets": list(SERVE_BUCKETS),
           "allocations_after_warmup": alloc1 - alloc0,
           "launches": launches, "slot_addresses_kept": same_ptrs,
           "bitwise_booster_predict": bitwise,
           "host_ms_p50": float(np.percentile(host_ms, 50)),
           "host_ms_p99": float(np.percentile(host_ms, 99)),
           "host_ms_mean": float(np.mean(host_ms)),
           "split_ms_mean_profiled": split,
           "profiled_flush_ms_mean": sum(split.values())}
    checks = {"no_allocation": alloc1 == alloc0,
              "one_launch_a_flush": launches == len(sizes),
              "slot_addresses_kept": same_ptrs, "bitwise": bitwise}
    out["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"serve_steady: {checks}")
    return out


def _serve_clients(fe, Xv, seed, done, clients, max_rows, raw=False):
    """``clients`` threads, each a closed loop of requests of 1 to
    ``max_rows`` rows (uniform, from ``seed``) at random offsets of
    ``Xv`` until ``done()``; returns [(thread, start, rows, t0, t1,
    answer)] and the threads' errors."""
    import threading
    log_, errs = [], []
    lock = threading.Lock()

    def client(i):
        rng = np.random.RandomState(seed + i)
        mine = []
        try:
            while not done():
                n = int(rng.randint(1, max_rows + 1))
                s = int(rng.randint(0, len(Xv) - n))
                t0 = time.perf_counter()
                ans = fe.predict(Xv[s:s + n], raw_score=raw)
                mine.append((i, s, n, t0, time.perf_counter(), ans))
        except BaseException as e:       # noqa: BLE001 -- reported
            errs.append(repr(e))
        with lock:
            log_.extend(mine)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError("a serve client did not finish")
    return log_, errs


def serve_phase(lgb, cuda_hist, args, model):
    """A ServeFrontend with the default policy over the model, driven by
    SERVE_CLIENTS client threads in closed loops of 1 to
    SERVE_MAX_REQUEST rows for SERVE_SECONDS: requests/s, rows/s, the
    clients' p50 / p99 ms, the batches and their mean rows; every answer
    bitwise Booster.predict of the same rows (converted scores), one
    predict_ensemble launch a batch (counts from 0 around the run)."""
    b, _, Xv = model
    M = 200_000
    want = b.predict(Xv[:M])
    fe = lgb.ServeFrontend(b)
    try:
        fe.predict(Xv[:1])
        st0 = fe.stats()
        cuda_hist.reset_launch_counts()
        t0 = time.perf_counter()
        log_, errs = _serve_clients(
            fe, Xv[:M], args.seed + 23,
            lambda: time.perf_counter() > t0 + SERVE_SECONDS,
            SERVE_CLIENTS, SERVE_MAX_REQUEST)
        wall = time.perf_counter() - t0
        launches = _predict_launches(cuda_hist, None)
        st = fe.stats()
    finally:
        fe.close()
    if errs:
        raise AssertionError(f"serve clients failed: {errs[:3]}")
    bad = [r for r in log_ if not np.array_equal(r[5], want[r[1]:r[1]
                                                               + r[2]])]
    lat = np.array([(r[4] - r[3]) * 1e3 for r in log_])
    rows = sum(r[2] for r in log_)
    batches = st["batches"] - st0["batches"]
    out = {"clients": SERVE_CLIENTS, "seconds": wall,
           "max_request_rows": SERVE_MAX_REQUEST, "requests": len(log_),
           "rows": rows, "requests_per_s": len(log_) / wall,
           "rows_per_s": rows / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "frontend_p50_ms": st.get("p50_ms"),
           "frontend_p99_ms": st.get("p99_ms"),
           "batches": batches, "rows_per_batch": rows / max(batches, 1),
           "launches": launches, "policy": {
               "flush_ms": fe.flush_s * 1e3,
               "max_batch_rows": fe.max_batch_rows,
               "max_queue_rows": fe.max_queue_rows}}
    checks = {"every_answer_bitwise": not bad,
              "launches_per_batch_1": launches == batches and batches > 0,
              "no_shed_or_timeout": st["shed"] == st["timeouts"] == 0}
    out["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"serve: {checks} ({len(bad)} answers "
                             f"differ)")
    return out, launches


def serve_control_phase(lgb, cuda_hist, args, model):
    """The serving layer's controls on the card: overload (a small
    serve_max_queue_rows behind a slow dispatch: ServeOverloadErrors and
    one serve_shed episode in health_snapshot()), the dispatch and
    queue-wait deadlines (fault_slow_predict_ms), a hot swap under traffic
    to a same-shape model trained from another seed (answers of requests
    finished before the swap began the old model's bits, of requests begun
    after it returned the new model's, in between one of the two), a
    rejected swap to a 3-class model (ServeSwapError, the old model
    serving on), the serve OOM (fault_oom_at_predict: the chunk halves,
    the answers stay bitwise), and a GET /metrics scrape whose
    lightgbm_tpu_serve_p99_ms is stats()'s."""
    import threading
    import urllib.request
    from lightgbm_tpu_torch import distributed
    from lightgbm_tpu_torch.serving import (ServeOverloadError,
                                            ServeSwapError,
                                            ServeTimeoutError)
    from lightgbm_tpu_torch.telemetry import _metric_value
    from lightgbm_tpu_torch.utils import faults
    b, X, Xv = model
    g = b._boosting
    out, checks = {}, {}
    slow = "LGBM_TPU_FAULT_SLOW_PREDICT_MS"

    # overload
    fe = lgb.ServeFrontend(b, flush_ms=2.0, max_queue_rows=64)
    try:
        fe.predict(Xv[:10])
        before = len(distributed.degradations())
        os.environ[slow] = "400"
        try:
            t1 = threading.Thread(target=lambda: fe.predict(Xv[:40]))
            t1.start()
            time.sleep(0.15)
            t2 = threading.Thread(target=lambda: fe.predict(Xv[40:60]))
            t2.start()
            time.sleep(0.05)
            shed = []
            for i in range(3):
                try:
                    fe.predict(Xv[60 + i:80 + i])
                except ServeOverloadError as e:
                    shed.append(e)
            t1.join(timeout=30)
            t2.join(timeout=30)
        finally:
            del os.environ[slow]
        episodes = [d for d in distributed.degradations()[before:]
                    if d["kind"] == "serve_shed"]
        health = distributed.health_snapshot()
        out["overload"] = {"max_queue_rows": 64, "shed": len(shed),
                           "episodes": len(episodes),
                           "episode_count": episodes[0]["count"]
                           if episodes else 0,
                           "message": str(shed[0]) if shed else None}
        checks["overload_sheds_retriable"] = (
            len(shed) == 3 and all(e.retriable for e in shed))
        checks["one_shed_episode_in_health"] = len(episodes) == 1 and any(
            d["kind"] == "serve_shed" for d in health.get("degradations",
                                                          []))
    finally:
        fe.close()

    # deadlines
    fe = lgb.ServeFrontend(b, flush_ms=2.0)
    try:
        fe.predict(Xv[:10])
        os.environ[slow] = "400"
        try:
            try:
                fe.predict(Xv[:10], deadline_ms=100.0)
                dispatch = None
            except ServeTimeoutError as e:
                dispatch = e
            t = threading.Thread(target=lambda: fe.predict(Xv[:10]))
            t.start()
            time.sleep(0.15)
            try:
                fe.predict(Xv[10:20], deadline_ms=80.0)
                queued = None
            except ServeTimeoutError as e:
                queued = e
            t.join(timeout=30)
        finally:
            del os.environ[slow]
        out["deadlines"] = {
            "dispatch": dispatch and {"phase": dispatch.phase,
                                      "waited_ms": dispatch.waited_ms},
            "queue_wait": queued and {"phase": queued.phase,
                                      "waited_ms": queued.waited_ms}}
        checks["deadline_dispatch"] = dispatch is not None \
            and dispatch.phase == "dispatch"
        checks["deadline_queue_wait"] = queued is not None \
            and queued.phase == "queue-wait"
    finally:
        fe.close()

    # hot swap under traffic, then a rejected swap
    _, y, _, _ = higgs_rows(args)
    lo = PREDICT_TRAIN_ROWS
    t0 = time.time()
    new, _ = predict_model(lgb, args, X[lo:lo + SERVE_SWAP_ROWS],
                           y[lo:lo + SERVE_SWAP_ROWS], seed=args.seed + 7)
    swap_train_s = time.time() - t0
    if new.num_trees() != b.num_trees():
        raise AssertionError("the swap candidate's shape differs")
    M = 50_000
    old_raw, new_raw = b.predict(Xv[:M], raw_score=True), \
        new.predict(Xv[:M], raw_score=True)
    fe = lgb.ServeFrontend(b)
    try:
        fe.predict(Xv[:1], raw_score=True)
        marks = {}

        def swapper():
            time.sleep(1.0)
            marks["t0"] = time.perf_counter()
            marks["version"] = fe.swap("default", new)
            marks["t1"] = time.perf_counter()

        sw = threading.Thread(target=swapper)
        sw.start()
        t_end = time.perf_counter() + 120.0
        # traffic runs on for a second past the swap's return
        log_, errs = _serve_clients(
            fe, Xv[:M], args.seed + 29,
            lambda: time.perf_counter() > min(
                t_end, marks.get("t1", t_end) + 1.0),
            SERVE_SWAP_CLIENTS, SERVE_MAX_REQUEST, raw=True)
        sw.join(timeout=120)
        if errs:
            raise AssertionError(f"swap clients failed: {errs[:3]}")
        before = [r for r in log_ if r[4] < marks["t0"]]
        after = [r for r in log_ if r[3] > marks["t1"]]
        between = [r for r in log_ if r not in before and r not in after]

        def same(r, ref):
            return np.array_equal(r[5], ref[r[1]:r[1] + r[2]])
        out["swap"] = {"train_s": swap_train_s, "requests": len(log_),
                       "before": len(before), "after": len(after),
                       "overlapping": len(between),
                       "swap_ms": (marks["t1"] - marks["t0"]) * 1e3,
                       "version": marks["version"]}
        checks["swap_before_old_bits"] = bool(before) and all(
            same(r, old_raw) for r in before)
        checks["swap_after_new_bits"] = bool(after) and all(
            same(r, new_raw) for r in after)
        checks["swap_overlap_one_of_two"] = all(
            same(r, old_raw) or same(r, new_raw) for r in between)
        checks["models_differ"] = not np.array_equal(old_raw, new_raw)
        # the wrong arity: 3 classes over the same 28 columns
        ym = np.digitize(X[:20_000, 0], [-0.5, 0.5]).astype(np.float64)
        mp = {"objective": "multiclass", "num_class": 3, "num_leaves": 15,
              "verbosity": -1, "device_type": "cuda"}
        multi = lgb.train(mp, lgb.Dataset(X[:20_000], label=ym,
                                          params=dict(mp)), 2)
        try:
            fe.swap("default", multi)
            rejected = None
        except ServeSwapError as e:
            rejected = str(e)
        out["rejected_swap"] = rejected
        checks["rejected_swap_raises"] = rejected is not None
        checks["old_model_serves_on"] = fe.version() == 2 and \
            np.array_equal(fe.predict(Xv[:300], raw_score=True),
                           new_raw[:300])
    finally:
        fe.close()

    # serve OOM
    fe = lgb.ServeFrontend(b, flush_ms=2.0)
    try:
        ref = b.predict(Xv[:500])
        fe.predict(Xv[:500])
        before = len(distributed.degradations())
        chunk0 = g._predict_chunk_rows()
        faults.reset_predict_oom()
        os.environ["LGBM_TPU_FAULT_OOM_AT_PREDICT"] = "1"
        cuda_hist.reset_launch_counts()
        try:
            ans = fe.predict(Xv[:500])
        finally:
            del os.environ["LGBM_TPU_FAULT_OOM_AT_PREDICT"]
            faults.reset_predict_oom()
        ooms = [d for d in distributed.degradations()[before:]
                if d["kind"] == "oom_predict"]
        out["serve_oom"] = {"chunk_before": chunk0,
                            "chunk_after": g._oom_predict_chunk,
                            "events": len(ooms),
                            "launches": _predict_launches(cuda_hist, None),
                            "memory": ooms[0]["memory"] if ooms else None}
        checks["serve_oom_halves_the_chunk"] = (
            len(ooms) == 1 and g._oom_predict_chunk == (chunk0 or 1 << 22)
            // 2 and g._oom_level == 0)
        checks["serve_oom_bitwise"] = np.array_equal(ans, ref)
    finally:
        fe.close()
    g._oom_predict_chunk = 0
    with g._engine_lock:
        g._engine_cache.clear()

    # the metrics endpoint
    fe = lgb.ServeFrontend(b, metrics=True, metrics_port=0)
    try:
        for n in (1, 10, 100):
            fe.predict(Xv[:n])
        body = urllib.request.urlopen(f"http://{fe.metrics_addr}/metrics",
                                      timeout=30).read().decode()
        p99 = fe.stats()["p99_ms"]
        line = next((ln for ln in body.splitlines()
                     if ln.startswith("lightgbm_tpu_serve_p99_ms ")), None)
        out["metrics"] = {"addr": fe.metrics_addr, "p99_line": line,
                          "stats_p99_ms": p99, "lines": len(
                              body.splitlines())}
        checks["metrics_p99_is_stats"] = line == \
            f"lightgbm_tpu_serve_p99_ms {_metric_value(p99)}"
    finally:
        fe.close()
    out["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"serve_control: {checks}")
    return out


def telemetry_phase(lgb, cuda_hist, args):
    """The telemetry layer around train's training (2M + 200k rows, 255
    leaves, args.rounds rounds) with profiling on and the dispatch hook
    installed, after a one-round warm-up: once with the flight recorder
    off and once on (telemetry_dir): the texts bitwise, the launches by
    path equal, the hook's counts each iteration (update and valid eval)
    equal; one flight record an iteration, the JSONL valid, every record's
    memory fields non-null (torch.cuda's allocator); the recorder-on run's
    five largest scopes in ms an iteration; the recorder's cost (sec/iter
    off, on, on, off without profiling or the hook); then a trace_window
    around TELEMETRY_TRACE_ITERS more iterations whose Chrome trace names
    the hist_tile and split_epilogue kernels and the grower's scopes."""
    import shutil
    import tempfile
    from lightgbm_tpu_torch import telemetry
    from lightgbm_tpu_torch.utils import profiling
    X, y, Xv, yv = higgs_rows(args)
    work = tempfile.mkdtemp(prefix="chip_telemetry_")
    out, runs = {}, {}
    try:
        train = lgb.Dataset(X, label=y, params=dict(PARAMS,
                                                    device_type="cuda"))
        valid = lgb.Dataset(Xv, label=yv, reference=train)
        train.construct()
        valid.construct()
        profiling.reset()
        profiling.enable(True)
        try:
            for on in (None, False, True):
                params = dict(PARAMS, device_type="cuda",
                              telemetry_flight_recorder=bool(on))
                if on:
                    params["telemetry_dir"] = os.path.join(work, "tele")
                per_iter, snap = [], {}

                def before(env):
                    snap["d"] = profiling.dispatch_stats()
                before.before_iteration = True

                def after(env):
                    per_iter.append(profiling.dispatch_delta(snap["d"]))
                after.order = -1
                profiling.reset()
                cuda_hist.reset_launch_counts()
                torch.cuda.synchronize()
                profiling.install_dispatch_hook()
                t0 = time.time()
                try:
                    booster = lgb.train(
                        params, train, 1 if on is None else args.rounds,
                        valid_sets=[valid], valid_names=["valid"],
                        callbacks=[before, after])
                    torch.cuda.synchronize()
                finally:
                    profiling.uninstall_dispatch_hook()
                runs[on] = {"text": booster.model_to_string().split(
                    "\nparameters:")[0],
                    "launches": cuda_hist.launch_counts(),
                    "dispatch": per_iter, "wall_s": time.time() - t0,
                    "scopes": profiling.scopes()}
            tdir = os.path.join(work, "trace")
            with telemetry.trace_window(tdir, TELEMETRY_TRACE_ITERS) as tw:
                for _ in range(TELEMETRY_TRACE_ITERS):
                    booster.update()
        finally:
            profiling.enable(False)
            profiling.reset()
        # the recorder's cost alone: sec/iter with it off and on, in turns
        # (off, on, on, off), no profiling and no dispatch hook
        cost = {False: [], True: []}
        for on in (False, True, True, False):
            params = dict(PARAMS, device_type="cuda",
                          telemetry_flight_recorder=on)
            if on:
                params["telemetry_dir"] = os.path.join(work, "cost")
            torch.cuda.synchronize()
            t0 = time.time()
            lgb.train(params, train, args.rounds)
            torch.cuda.synchronize()
            cost[on].append((time.time() - t0) / args.rounds)
        out["recorder_cost"] = {
            "sec_per_iter_off": cost[False], "sec_per_iter_on": cost[True],
            "on_over_off": sum(cost[True]) / sum(cost[False]) - 1.0}
        path = os.path.join(work, "tele", "flight_rank0.jsonl")
        recs, errors = telemetry.validate_flight_jsonl(path)
        iters = [r for r in recs if r["type"] == "iter"]
        mem_ok = bool(iters) and all(
            isinstance(r.get("mem", {}).get(k), int)
            for r in iters for k in ("hbm_bytes_in_use", "hbm_peak_bytes",
                                     "host_rss_bytes"))
        sc = runs[True]["scopes"]
        top = sorted(sc.items(), key=lambda kv: -kv[1]["total_s"])[:5]
        out["scopes_ms_per_iteration"] = {
            k: 1e3 * v["total_s"] / args.rounds for k, v in top}
        out["recorder"] = {
            "records": len(iters), "jsonl_errors": errors,
            "jsonl_bytes": os.path.getsize(path),
            "flushes": [r["reason"] for r in recs if r["type"] == "flush"],
            "context": recs[0]["context"],
            "phases_last": iters[-1]["phases"] if iters else None,
            "mem_last": iters[-1]["mem"] if iters else None,
            "dispatch_per_iteration": runs[True]["dispatch"],
            "wall_s_off": runs[False]["wall_s"],
            "wall_s_on": runs[True]["wall_s"]}
        checks = {
            "one_record_an_iteration": [r["iteration"] for r in iters]
            == list(range(args.rounds)),
            "jsonl_valid": errors == [],
            "memory_from_torch_cuda": mem_ok,
            "text_bitwise_on_off": runs[True]["text"] == runs[False]["text"],
            "launches_equal_on_off": runs[True]["launches"]
            == runs[False]["launches"],
            "dispatch_equal_on_off": runs[True]["dispatch"]
            == runs[False]["dispatch"]}
        if not tw.ok:
            raise AssertionError(f"trace_window: {tw.error}")
        with open(tw.path) as fh:
            events = json.load(fh)["traceEvents"]
        names = {e.get("name", "") for e in events}
        kernels = {k: any(k in nm for nm in names)
                   for k in ("full_accumulate", "gather_", "split_epilogue")}
        scopes = {k: k in names for k in ("grow_tree", "hist_pass",
                                          "apply_split", "score_update")}
        out["trace"] = {**tw.to_json(), "bytes": os.path.getsize(tw.path),
                        "events": len(events), "kernels": kernels,
                        "scopes": scopes}
        checks["trace_names_hist_tile"] = kernels["full_accumulate"] \
            or kernels["gather_"]
        checks["trace_names_split_epilogue"] = kernels["split_epilogue"]
        checks["trace_names_scopes"] = all(scopes.values())
        out["checks"] = checks
        if not all(checks.values()):
            raise AssertionError(f"telemetry: {checks}")
        return out, runs[True]["launches"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def serve_phases(lgb, cuda_hist, args):
    """The serve group's phases, each emitted; returns its numbers for the
    kernels line (the serve sizes' cases, the launches by path)."""
    from lightgbm_tpu_torch.ops import predict as P
    t0 = time.time()
    model, train_s = predict_group_model(lgb, args)
    sk = serve_kernel_phase(P, args, model)
    emit("serve_kernel", seconds=time.time() - t0,
         model={"rows": PREDICT_TRAIN_ROWS, "rounds": PREDICT_ROUNDS,
                "leaves": LEAVES, "train_s": train_s}, sizes=sk)
    t0 = time.time()
    ss = serve_steady_phase(lgb, cuda_hist, args, model)
    emit("serve_steady", seconds=time.time() - t0, **ss)
    sv, serve_launches = serve_phase(lgb, cuda_hist, args, model)
    emit("serve", **sv)
    t0 = time.time()
    sc = serve_control_phase(lgb, cuda_hist, args, model)
    emit("serve_control", seconds=time.time() - t0, **sc)
    t0 = time.time()
    tele, tele_launches = telemetry_phase(lgb, cuda_hist, args)
    emit("telemetry", seconds=time.time() - t0, **tele)
    return {"serve_sizes": sk, "serve_paths": {
        "serve/steady": ss["launches"], "serve/frontend": serve_launches},
        "telemetry_launches": tele_launches}


def serve_entry(serve):
    """The kernels line's entry of predict_ensemble under ``--only serve``:
    the 8,192-row case's numbers, every serve size beside them, the
    launches by path (the frontend's run is the main path)."""
    sizes = serve["serve_sizes"]
    main_case = sizes[str(SERVE_SIZES[-1])]
    return {
        "name": "predict_ensemble", "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/predict_ensemble.cu",
        "replaces": "none, a port-only kernel: lightgbm_tpu/models/"
                    "predict_engine.py:123 _accum_core + :182 _leaves_core "
                    "are plain jnp scans (no pallas_call)",
        "launches": serve["serve_paths"]["serve/frontend"],
        "max_abs_err": 0.0,
        **{k: main_case[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "node_visits", "rows", "trees")},
        "serve_sizes": serve_sizes_numbers(sizes),
        "launches_by_path": serve["serve_paths"]}


def serve_sizes_numbers(sizes):
    return {k: {kk: v[kk] for kk in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "node_visits")}
            | {"mode": v["geometry"]["mode"]} for k, v in sizes.items()}


# ------------------------------------------------------------------ faults
# The faults group (fault tolerance): checkpoints and bit-identical resume
# across a killed child process, the feature-blocked pass under
# histogram_pool_size on an Epsilon-shaped table, the OOM ladder (simulated
# and one real torch.cuda.OutOfMemoryError in a child under a memory cap),
# check_numerics, and the predict rung.
RESUME = {"bagging_fraction": 0.8, "bagging_freq": 2,
          "feature_fraction": 0.8}
RESUME_KILL_AT = 3
EPS_FEATURES = 2000            # Epsilon (docs/GPU-Performance.rst)
EPS_ROWS, EPS_VALID = 100_000, 25_000
EPS_ROUNDS = 3
EPS_POOL_MB = 256              # ~569 columns a block, 4 blocks
EPS_PARITY_ROWS, EPS_PARITY_LEAVES, EPS_PARITY_ROUNDS = 2_000, 15, 2
EPS_PARITY_POOL_MB = 50        # 311 columns a block at 15 leaves (7 blocks)
LADDER_LEAVES = 15             # the ladder's runs: rung 1 at 136 columns
OOM_CHILD_ROWS = 50_000
PREDICT_OOM_CHUNK = 65_536


def epsilon_like(n: int, seed: int):
    """Epsilon-shaped rows (the PASCAL challenge's dense binary set of
    upstream LightGBM's GPU benchmark): 2,000 float features, each row
    scaled to unit norm as in the published set, and a binary label from a
    sparse linear function of them plus noise; drawn on the card from a
    seeded generator (the host's generator took 20 s for 500,000 rows)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, EPS_FEATURES), generator=g, device="cuda")
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    w = torch.randn((40,), generator=g, device="cuda")
    noise = (torch.rand((n,), generator=g, device="cuda") - 0.5) * 0.04
    y = ((X[:, :40] @ w + noise) > 0).to(torch.float64)
    return X.cpu().numpy(), y.cpu().numpy()


class _Mappers:
    """A constructed reference Dataset's binning (its bin mappers), so a
    Dataset built with ``reference=`` bins new rows on ``device`` without
    fitting the 2,000 columns' mappers again."""

    def __init__(self, ds, device):
        self.mappers = ds.mappers
        self.used_features = ds.used_features
        self.num_total_features = ds.num_total_features
        self.bundles = None
        self.pandas_categorical = {}
        self.raw_data_np = None
        self.device = torch.device(device)

    def construct(self):
        return self


@contextlib.contextmanager
def _blocked_probe():
    """Counts the grower's blocked passes and its histogram launches by
    column width (``{(F, gather): count}``) within the block."""
    from lightgbm_tpu_torch.models import grower
    real_pass, real_hist = grower.Grower.blocked_pass, grower.histogram_tiles
    seen = {"passes": 0, "launches": {}}

    def blocked_pass(self, st):
        seen["passes"] += 1
        return real_pass(self, st)

    def histogram_tiles(binsT, *a, **k):
        key = (int(binsT.shape[0]), a[5] is not None if len(a) > 5
               else k.get("gather_idx") is not None)
        seen["launches"][key] = seen["launches"].get(key, 0) + 1
        return real_hist(binsT, *a, **k)

    grower.Grower.blocked_pass = blocked_pass
    grower.histogram_tiles = histogram_tiles
    try:
        yield seen
    finally:
        grower.Grower.blocked_pass = real_pass
        grower.histogram_tiles = real_hist


def _run_child(mode: str, workdir: str, env_extra: dict, *extra) -> tuple:
    """``chip_smoke.py --child mode`` in a fresh interpreter: (exit code,
    its last JSON line or None, seconds)."""
    t0 = time.time()
    env = dict(os.environ, **env_extra)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", mode,
         "--workdir", workdir, *extra], env=env, capture_output=True,
        text=True, timeout=300)
    last = None
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            last = json.loads(line)
    if proc.returncode not in (0, 137):
        raise AssertionError(f"child {mode} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return proc.returncode, last, time.time() - t0


def _resume_params():
    return dict(PARAMS, device_type="cuda", **RESUME)


def child_main(args) -> int:
    """The faults group's child processes: ``resume`` trains the
    train_resume run from the rows the parent saved (killed by
    LGBM_TPU_FAULT_KILL_AT_ITER, or resumed with --resume); ``oom`` trains
    the Epsilon-shaped rows under a memory cap below the resident
    histogram state."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pickle
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import checkpoint
    from lightgbm_tpu_torch.ops import cuda_hist, predict, rank  # noqa: F401
    wd = args.workdir
    if args.child == "resume":
        X, y = np.load(f"{wd}/X.npy"), np.load(f"{wd}/y.npy")
        Xv = np.load(f"{wd}/Xv.npy")
        params = _resume_params()
        train = lgb.Dataset(X, label=y, params=params).construct()
        timing = {"validate_s": 0.0, "restore_s": 0.0}
        real_validate = checkpoint.CheckpointManager.validate
        real_restore = checkpoint.restore_booster

        def validate(self, path):
            t0 = time.time()
            try:
                return real_validate(self, path)
            finally:
                timing["validate_s"] += time.time() - t0

        def restore(booster, ckpt):
            t0 = time.time()
            try:
                return real_restore(booster, ckpt)
            finally:
                torch.cuda.synchronize()
                timing["restore_s"] += time.time() - t0
        checkpoint.CheckpointManager.validate = validate
        checkpoint.restore_booster = restore
        t_load = [0.0]
        real_load = checkpoint.CheckpointManager.load_latest_valid

        def load_latest_valid(self):
            t0 = time.time()
            try:
                return real_load(self)
            finally:
                t_load[0] += time.time() - t0
        checkpoint.CheckpointManager.load_latest_valid = load_latest_valid
        cuda_hist.reset_launch_counts()
        t0 = time.time()
        b = lgb.train(params, train, args.rounds,
                      callbacks=[lgb.checkpoint_callback(f"{wd}/ckpt",
                                                         period=1)],
                      resume_from=f"{wd}/ckpt" if args.resume else None)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = cuda_hist.launch_counts()
        with open(f"{wd}/resumed.txt", "w") as fh:
            fh.write(b.model_to_string())
        np.save(f"{wd}/resumed_pred.npy", b.predict(Xv))
        print(json.dumps({
            "resume_seconds": {"validate": timing["validate_s"],
                               "load": t_load[0] - timing["validate_s"],
                               "restore": timing["restore_s"]},
            "train_wall_s": wall, "launches": counts}), flush=True)
        return 0
    # oom: the rung-1 check under a real allocation failure
    with open(f"{wd}/mappers.pkl", "rb") as fh:
        ref = pickle.load(fh)
    X, y = np.load(f"{wd}/X_oom.npy"), np.load(f"{wd}/y_oom.npy")
    params = dict(PARAMS, device_type="cuda")
    dev = torch.device("cuda", 0)
    train = lgb.Dataset(X, label=y, params=params,
                        reference=_Mappers(ref, dev)).construct()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    resident = LEAVES * EPS_FEATURES * train.max_num_bins * 3 * 4
    cap = base + resident - (16 << 20)
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    from lightgbm_tpu_torch import distributed
    cuda_hist.reset_launch_counts()
    t0 = time.time()
    b = lgb.train(params, train, EPS_ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    with open(f"{wd}/oom.txt", "w") as fh:
        fh.write(b.model_to_string())
    print(json.dumps({
        "rows": len(y), "cap_bytes": cap, "base_bytes": base,
        "resident_state_bytes": resident,
        "max_allocated_bytes": torch.cuda.max_memory_allocated(dev),
        "events": [{k: e[k] for k in ("kind", "iteration", "level",
                                      "action", "error")}
                   for e in distributed.degradations()],
        "oom_level": b._boosting._oom_level,
        "feature_block": b._boosting._feature_block(),
        "train_wall_s": wall, "launches": cuda_hist.launch_counts()}),
        flush=True)
    return 0


def train_resume_phase(lgb, cuda_hist, args, workdir):
    """train's rows, 5 rounds with a checkpoint every round: a child killed
    at iteration 3 (exit 137) and a second child resumed from its
    checkpoints give the uninterrupted run's text and predictions bit for
    bit; in-process, a writer killed inside the write of checkpoint 3
    (the hard exit replaced by an exception) and checkpoints corrupted on
    disk, each resumed to the same text."""
    from lightgbm_tpu_torch import checkpoint
    from lightgbm_tpu_torch.utils import faults
    X, y, Xv, yv = higgs_rows(args)
    for name, arr in (("X", X), ("y", y), ("Xv", Xv)):
        np.save(f"{workdir}/{name}.npy", arr)
    params = _resume_params()
    train = lgb.Dataset(X, label=y, params=params)
    t0 = time.time()
    train.construct()
    torch.cuda.synchronize()
    construct_s = time.time() - t0
    saves = []
    cb = lgb.checkpoint_callback(f"{workdir}/full", period=1)

    def record(env):
        saves.append(dict(cb.manager.last_save))
    record.order = 41
    b, wall, counts = _counted(cuda_hist, lambda: lgb.train(
        params, train, args.rounds, callbacks=[cb, record]))
    full_text = b.model_to_string()
    full_pred = b.predict(Xv)
    mgr = checkpoint.CheckpointManager(f"{workdir}/full")
    kill_rc, _, kill_s = _run_child(
        "resume", workdir, {"LGBM_TPU_FAULT_KILL_AT_ITER":
                            str(RESUME_KILL_AT)}, "--rounds",
        str(args.rounds))
    left = [it for it, _ in checkpoint.CheckpointManager(
        f"{workdir}/ckpt").checkpoints()]
    res_rc, res, res_s = _run_child("resume", workdir, {}, "--rounds",
                                    str(args.rounds), "--resume")
    with open(f"{workdir}/resumed.txt") as fh:
        resumed_text = fh.read()
    resumed_pred = np.load(f"{workdir}/resumed_pred.npy")
    out = {"rows": args.rows, "valid_rows": args.valid_rows,
           "rounds": args.rounds, "leaves": LEAVES, **RESUME,
           "construct_s": construct_s, "sec_per_iter": wall / args.rounds,
           "checkpoint_save": saves,
           "checkpoint_save_s_median": statistics.median(
               s["seconds"] for s in saves),
           "checkpoints_kept": [it for it, _ in mgr.checkpoints()],
           "killed_child": {"exit": kill_rc, "kill_at_iter": RESUME_KILL_AT,
                            "checkpoints_left": left, "seconds": kill_s},
           "resumed_child": {"exit": res_rc, "seconds": res_s,
                             **{k: res[k] for k in ("resume_seconds",
                                                    "train_wall_s")}},
           "resumed_text_equal": resumed_text == full_text,
           "resumed_predictions_bitwise": bool(np.array_equal(
               resumed_pred, full_pred))}
    if not (kill_rc == 137 and left == [RESUME_KILL_AT - 1, RESUME_KILL_AT]
            and res_rc == 0 and out["resumed_text_equal"]
            and out["resumed_predictions_bitwise"]):
        raise AssertionError(f"train_resume: {out}")

    # the writer killed inside the write of checkpoint 3, in-process
    class Killed(BaseException):
        pass

    def die(context):
        raise Killed(context)
    real_exit = faults._hard_exit
    faults._hard_exit = die
    d = f"{workdir}/kill_in_write"
    try:
        try:
            lgb.train(dict(params, fault_kill_in_ckpt_write=RESUME_KILL_AT),
                      train, args.rounds,
                      callbacks=[lgb.checkpoint_callback(d, period=1)])
            raise AssertionError("fault_kill_in_ckpt_write did not fire")
        except Killed:
            pass
    finally:
        faults._hard_exit = real_exit
    names = sorted(os.listdir(d))
    latest = checkpoint.CheckpointManager(d).load_latest_valid().iteration
    again = lgb.train(params, train, args.rounds, resume_from=d,
                      callbacks=[lgb.checkpoint_callback(d, period=1)])
    out["kill_in_ckpt_write"] = {
        "dir_after_kill": names, "resumed_from": latest,
        "stale_tmp_removed": not any(e.endswith(".tmp")
                                     for e in os.listdir(d)),
        "text_equal": again.model_to_string() == full_text}
    kw = out["kill_in_ckpt_write"]
    if not (f"ckpt_{RESUME_KILL_AT:08d}.tmp" in names
            and latest == RESUME_KILL_AT - 1 and kw["stale_tmp_removed"]
            and kw["text_equal"]):
        raise AssertionError(f"kill_in_ckpt_write: {kw}")
    # checkpoints corrupted on disk as they are written: resume falls back
    # past them to the last clean one
    d = f"{workdir}/corrupt"
    lgb.train(params, train, 2,
              callbacks=[lgb.checkpoint_callback(d, period=1, keep=5)])
    lgb.train(dict(params, fault_corrupt_checkpoint=True), train, 4,
              resume_from=d,
              callbacks=[lgb.checkpoint_callback(d, period=1, keep=5)])
    latest = checkpoint.CheckpointManager(d).load_latest_valid().iteration
    again = lgb.train(params, train, args.rounds, resume_from=d)
    out["corrupt_checkpoint"] = {
        "checkpoints": [it for it, _ in
                        checkpoint.CheckpointManager(d).checkpoints()],
        "fell_back_to": latest,
        "text_equal": again.model_to_string() == full_text}
    if not (latest == 2 and out["corrupt_checkpoint"]["text_equal"]):
        raise AssertionError(f"corrupt_checkpoint: {out['corrupt_checkpoint']}")
    return out, counts, {"resume_child": res["launches"]}, (b, Xv, full_pred)


def _eps_run(lgb, cuda_hist, train, valid, yv, extra, rounds):
    """One Epsilon-shaped training: (result, launch counts, text)."""
    params = dict(PARAMS, device_type="cuda", **extra)
    evals = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    copies = cuda_hist.bins_by_row.copies
    with _blocked_probe() as seen:
        b, wall, counts = _counted(cuda_hist, lambda: lgb.train(
            params, train, rounds, valid_sets=[valid],
            valid_names=["valid"], evals_result=evals))
    g = b._boosting
    fb = g._feature_block()
    res = {"sec_per_iter": wall / rounds,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "peak_above_data": torch.cuda.max_memory_allocated() - base,
           "resident_state_bytes": g._resident_hist_bytes(),
           "feature_block": fb, "blocked_passes": seen["passes"],
           "row_major_copies": cuda_hist.bins_by_row.copies - copies,
           "hist_launches_by_width": {f"F={f}" + ("/gather" if ga else ""): c
                                      for (f, ga), c in
                                      sorted(seen["launches"].items())},
           "rows_streamed_per_tree": b.rows_streamed_per_tree,
           "valid_auc": evals["valid"]["auc"][-1]}
    return b, res, counts, b.model_to_string()


def train_blocked_phase(lgb, cuda_hist, args, workdir):
    """An Epsilon-shaped table at 255 leaves: the blocked pass under
    histogram_pool_size=256 (twice) against the resident run on the
    classic path with hist_subtraction=False (split_fusion off), bit for
    bit; at the parity size the card's blocked text against the CPU's in
    the kernels' orders. The first blocked run's peak includes the column
    blocks' row-major bin copies, which the second reuses."""
    import pickle
    t0 = time.time()
    X, y = epsilon_like(EPS_ROWS + EPS_VALID, args.seed)
    Xv, yv = X[EPS_ROWS:], y[EPS_ROWS:]
    X, y = X[:EPS_ROWS], y[:EPS_ROWS]
    data_s = time.time() - t0
    params = dict(PARAMS, device_type="cuda")
    train = lgb.Dataset(X, label=y, params=params)
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    t0 = time.time()
    train.construct()
    valid.construct()
    torch.cuda.synchronize()
    construct_s = time.time() - t0
    with open(f"{workdir}/mappers.pkl", "wb") as fh:
        pickle.dump(_Mappers(train, "cpu"), fh)
    runs, counts, texts = {}, {}, {}
    for name, extra in (("blocked", {"histogram_pool_size": EPS_POOL_MB}),
                        ("blocked_again",
                         {"histogram_pool_size": EPS_POOL_MB}),
                        ("resident", {"hist_subtraction": False,
                                      "split_fusion": "off"})):
        b, runs[name], counts[name], texts[name] = _eps_run(
            lgb, cuda_hist, train, valid, yv, extra, EPS_ROUNDS)
        del b
    blk = runs["blocked"]
    fb = blk["feature_block"]
    widths = [min(fb, EPS_FEATURES - s) for s in range(0, EPS_FEATURES, fb)]
    want = {}
    for w in widths:
        want[f"F={w}"] = want.get(f"F={w}", 0) + blk["blocked_passes"]
    out = {"rows": EPS_ROWS, "valid_rows": EPS_VALID,
           "features": EPS_FEATURES, "leaves": LEAVES,
           "rounds": EPS_ROUNDS, "pool_mb": EPS_POOL_MB,
           "data_s": data_s, "construct_s": construct_s,
           "blocks": widths, **runs,
           # the parameters blocks differ (histogram_pool_size against
           # hist_subtraction); the trees must not
           "text_equals_resident": texts["blocked"].split("\nparameters:")[0]
           == texts["resident"].split("\nparameters:")[0],
           "text_equals_second_blocked": texts["blocked"]
           == texts["blocked_again"],
           "kernel3_once_per_block_per_pass":
           blk["hist_launches_by_width"] == want
           and counts["blocked"]["hist_tile.launches_plane"]
           == blk["blocked_passes"] * len(widths)}
    if not (out["text_equals_resident"] and out["text_equals_second_blocked"]
            and out["kernel3_once_per_block_per_pass"] and len(widths) >= 2
            and counts["blocked"]["split_epilogue.launches"] == 0
            and runs["resident"]["feature_block"] == 0
            # one row-major copy a column block, made once (the second
            # run reuses the views'), never one a launch
            and blk["row_major_copies"] == len(widths)
            and runs["blocked_again"]["row_major_copies"] == 0
            and counts["resident"]["hist_tile.gather_launches"] > 0
            and counts["resident"]["split_epilogue.launches"] == 0
            and blk["valid_auc"] > 0.6):
        raise AssertionError(f"train_blocked: {out}")
    # parity size: the first rows, binned with the same mappers on the card
    # and on the CPU
    Xp, yp = X[:EPS_PARITY_ROWS], y[:EPS_PARITY_ROWS]
    ptexts = {}
    for run in ("cuda", "cpu_kernel_sums"):
        dev = run.split("_")[0]
        p = dict(PARAMS, device_type=dev, num_leaves=EPS_PARITY_LEAVES,
                 histogram_pool_size=EPS_PARITY_POOL_MB)
        ds = lgb.Dataset(Xp, label=yp, params=p,
                         reference=_Mappers(train, "cuda" if dev == "cuda"
                                            else "cpu"))
        with (cuda_hist.kernel_sums_on_cpu() if dev == "cpu"
              else contextlib.nullcontext()):
            bp = lgb.train(p, ds, EPS_PARITY_ROUNDS)
        ptexts[run] = bp.model_to_string()
        if dev == "cuda":
            pfb = bp._boosting._feature_block()
    out["parity"] = {"rows": EPS_PARITY_ROWS, "leaves": EPS_PARITY_LEAVES,
                     "rounds": EPS_PARITY_ROUNDS,
                     "pool_mb": EPS_PARITY_POOL_MB, "feature_block": pfb,
                     "card_equals_cpu_kernel_sums":
                     ptexts["cuda"] == ptexts["cpu_kernel_sums"]}
    if not (out["parity"]["card_equals_cpu_kernel_sums"] and pfb > 0):
        raise AssertionError(f"train_blocked parity: {out['parity']}")
    return out, counts, (train, X, y)


def oom_ladder_phase(lgb, cuda_hist, args, workdir, eps):
    """At the parity size (15 leaves): fault_oom_at_iter=1 with
    fault_oom_count=3 walks rungs 1, 2, 3; each rung's run (degraded from
    iteration 0, one round) gives the trees of a fresh run configured at its
    setting. Then a real
    torch.cuda.OutOfMemoryError in a child capped below the resident
    state: rung 1 engages and the run ends with a fresh run's text at that
    width."""
    from lightgbm_tpu_torch import distributed
    train, X, y = eps
    Xp, yp = X[:EPS_PARITY_ROWS], y[:EPS_PARITY_ROWS]
    dev = torch.device("cuda", 0)

    def run(extra, rounds=EPS_PARITY_ROUNDS, rows=(Xp, yp),
            leaves=LADDER_LEAVES):
        p = dict(PARAMS, device_type="cuda", num_leaves=leaves, **extra)
        ds = lgb.Dataset(rows[0], label=rows[1], params=p,
                         reference=_Mappers(train, dev))
        return _counted(cuda_hist, lambda: lgb.train(p, ds, rounds))

    def trees(text):
        return text.split("\nparameters:")[0]
    walk, walk_s, walk_counts = run({"fault_oom_at_iter": 1,
                                     "fault_oom_count": 3})
    events = distributed.degradations()
    out = {"rows": EPS_PARITY_ROWS, "leaves": LADDER_LEAVES,
           "rounds": EPS_PARITY_ROUNDS, "walk_seconds": walk_s,
           "walk_events": [{k: e[k] for k in ("level", "iteration",
                                              "action")} for e in events],
           "walk_trees": walk.num_trees()}
    if not ([e["level"] for e in events] == [1, 2, 3]
            and walk.num_trees() == EPS_PARITY_ROUNDS):
        raise AssertionError(f"oom_ladder walk: {out}")
    state_mb = walk._boosting._resident_hist_bytes() / 2 ** 20
    out["rungs"] = {}
    # one round each: degraded from iteration 0, every tree grows at the
    # rung's setting
    for count, pool in ((1, state_mb / 4), (2, 0.01)):
        deg, _, _ = run({"fault_oom_at_iter": 0, "fault_oom_count": count},
                        rounds=1)
        fresh, _, _ = run({"histogram_pool_size": pool}, rounds=1)
        same = (trees(deg.model_to_string())
                == trees(fresh.model_to_string()))
        out["rungs"][f"rung_{count}"] = {
            "feature_block": deg._boosting._feature_block(),
            "fresh_feature_block": fresh._boosting._feature_block(),
            "trees_equal_fresh_run": same}
        if not same or deg._boosting._feature_block() \
                != fresh._boosting._feature_block():
            raise AssertionError(f"oom_ladder rung {count}: {out['rungs']}")
    # a real allocation failure in a child under a memory cap
    Xo, yo = X[:OOM_CHILD_ROWS], y[:OOM_CHILD_ROWS]
    np.save(f"{workdir}/X_oom.npy", Xo)
    np.save(f"{workdir}/y_oom.npy", yo)
    rc, child, child_s = _run_child("oom", workdir, {}, "--seed",
                                    str(args.seed))
    fresh, _, _ = run({"histogram_pool_size":
                       child["resident_state_bytes"] / 2 ** 22},
                      rounds=EPS_ROUNDS, rows=(Xo, yo), leaves=LEAVES)
    with open(f"{workdir}/oom.txt") as fh:
        child_text = fh.read()
    out["real_oom"] = {
        **{k: child[k] for k in ("rows", "cap_bytes", "base_bytes",
                                 "resident_state_bytes",
                                 "max_allocated_bytes", "events",
                                 "oom_level", "feature_block",
                                 "train_wall_s")},
        "exit": rc, "seconds": child_s,
        "fresh_feature_block": fresh._boosting._feature_block(),
        "trees_equal_fresh_run": trees(child_text)
        == trees(fresh.model_to_string())}
    ro = out["real_oom"]
    if not (rc == 0 and ro["oom_level"] == 1
            and [e["level"] for e in ro["events"]] == [1]
            and "out of memory" in ro["events"][0]["error"].lower()):
        raise AssertionError(f"oom_ladder real OOM: {ro}")
    if not (ro["trees_equal_fresh_run"]
            and ro["feature_block"] == ro["fresh_feature_block"]):
        raise AssertionError(f"oom_ladder real OOM: {ro}")
    return out, {"oom_ladder_walk": walk_counts,
                 "oom_child": child["launches"]}


def numerics_phase(lgb, args):
    """check_numerics with a NaN injected at iteration 2 (both injection
    points): the JAX package's message, naming the iteration."""
    from lightgbm_tpu_torch.utils.log import LightGBMError
    X, y, params, kw = parity_setup("parity", args.seed)
    out = {}
    for fault, bad in (("fault_nan_grad_at_iter", 8),
                       ("fault_nan_hist_at_iter", 1)):
        p = dict(params, device_type="cuda", check_numerics=True,
                 **{fault: 2})
        try:
            lgb.train(p, lgb.Dataset(X, label=y, params=p), 4)
            raise AssertionError(f"check_numerics missed {fault}")
        except LightGBMError as e:
            msg = str(e)
        want = (f"check_numerics: iteration 2: {bad} non-finite gradient and "
                f"0 non-finite hessian values out of {len(y)} — failing fast "
                f"before they poison the histograms (check the objective / "
                f"custom fobj, learning_rate, and input features)")
        out[fault] = {"message": msg, "as_expected": msg == want}
        if msg != want:
            raise AssertionError(f"numerics: {msg!r} != {want!r}")
    return out


def predict_oom_phase(lgb, cuda_hist, model):
    """fault_oom_at_predict=2 on train_resume's model over the 200k valid
    rows at predict_chunk_rows 65,536: the chunk halves twice (to 16,384),
    the predictions stay bitwise the unchunked ones, and predict_ensemble
    launches once a chunk."""
    from lightgbm_tpu_torch import distributed
    from lightgbm_tpu_torch.utils import faults
    b, Xv, want = model
    b.reset_parameter({"predict_chunk_rows": PREDICT_OOM_CHUNK})
    faults.reset_predict_oom()
    os.environ["LGBM_TPU_FAULT_OOM_AT_PREDICT"] = "2"
    try:
        got, secs, counts = _counted(cuda_hist, lambda: b.predict(Xv))
    finally:
        del os.environ["LGBM_TPU_FAULT_OOM_AT_PREDICT"]
        faults.reset_predict_oom()
    chunk = b._boosting._oom_predict_chunk
    launches = sum(v for k, v in counts.items()
                   if k.startswith("predict_ensemble."))
    out = {"rows": len(Xv), "chunk_rows": PREDICT_OOM_CHUNK,
           "chunk_after": chunk, "predict_s": secs,
           "events": [e["action"] for e in distributed.degradations()
                      if e["kind"] == "oom_predict"],
           "predict_ensemble_launches": launches,
           "chunks": -(-len(Xv) // chunk),
           "bitwise_unchunked": bool(np.array_equal(got, want))}
    if not (chunk == PREDICT_OOM_CHUNK // 4 and out["bitwise_unchunked"]
            and launches == out["chunks"]):
        raise AssertionError(f"predict_oom: {out}")
    return out, launches


def faults_phases(lgb, cuda_hist, args):
    """The faults group's phases, each emitted; returns the launch counts
    of its runs by path, and predict_oom's predict_ensemble launches."""
    import tempfile
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.time()
        tr, resume_counts, child_counts, model = train_resume_phase(
            lgb, cuda_hist, args, workdir)
        emit("train_resume", seconds=time.time() - t0, **tr)
        t0 = time.time()
        tb, blocked_counts, eps = train_blocked_phase(lgb, cuda_hist, args,
                                                      workdir)
        emit("train_blocked", seconds=time.time() - t0, **tb)
        t0 = time.time()
        ol, ladder_counts = oom_ladder_phase(lgb, cuda_hist, args, workdir,
                                             eps)
        emit("oom_ladder", seconds=time.time() - t0, **ol)
        del eps
    t0 = time.time()
    nm = numerics_phase(lgb, args)
    emit("numerics", seconds=time.time() - t0, **nm)
    t0 = time.time()
    po, po_launches = predict_oom_phase(lgb, cuda_hist, model)
    emit("predict_oom", seconds=time.time() - t0, **po)
    paths = {"faults/train_resume": resume_counts,
             **{f"faults/{k}": v for k, v in child_counts.items()},
             **{f"faults/train_{k}": v for k, v in blocked_counts.items()},
             **{f"faults/{k}": v for k, v in ladder_counts.items()}}
    return paths, po_launches


# ------------------------------------------------------- distributed group
DIST_WORLD = 2               # ranks of the gang (one card: they share it)
DIST_ROUNDS = 2              # each learner's full-width rounds, run twice
DIST_LEARNERS = ("data", "feature", "voting")
DIST_TOP_K = 20              # voting's top_k (the JAX package's default)
DIST_PARITY_ROWS = 50_000
DIST_PARITY_LEAVES = 63
DIST_PARITY_ROUNDS = 2
DIST_CHILD_TIMEOUT = 600


def _int_planes_case(cuda_hist, binsT, leaf, stats, sel, gang_rows):
    """One tile of the data learner's pass on one rank's rows in the
    integer-planes mode (the exponent from the gang's ``amax`` and
    ``gang_rows``): bitwise ``hist_tile_exact``'s integers and a second
    launch; the two row halves' planes (two ranks) add to the pass's;
    ``hist_convert`` of the sum bitwise its plain version and the one-pass
    planes; times of both launches, their plain versions and bounds."""
    n = binsT.shape[1]
    f = binsT.shape[0]
    chan = cuda_hist.chan_leaf_table(sel).cuda()
    amax = cuda_hist._absmax(stats)
    args = (binsT, leaf, stats, chan, P, B, LEAVES)

    def run():
        return cuda_hist.hist_tile(*args, plane=True, amax=amax,
                                   rows=gang_rows, raw=True)

    cuda_hist.reset_launch_counts()
    a, again = run(), run()
    launched = cuda_hist.launch_counts()["hist_tile.launches_plane_raw"]
    exact = cuda_hist.hist_tile_exact(*args, amax=amax, rows=gang_rows,
                                      raw=True)
    h = n // 2
    lo = cuda_hist.hist_tile(binsT[:, :h].contiguous(), leaf[:h].contiguous(),
                             stats[:h].contiguous(), chan, P, B, LEAVES,
                             plane=True, amax=amax, rows=gang_rows, raw=True)
    hi = cuda_hist.hist_tile(binsT[:, h:].contiguous(), leaf[h:].contiguous(),
                             stats[h:].contiguous(), chan, P, B, LEAVES,
                             plane=True, amax=amax, rows=gang_rows, raw=True)
    conv = cuda_hist.hist_convert(a, amax, gang_rows)
    conv_plain = cuda_hist.hist_convert_plain(a, amax, gang_rows)
    one_pass = cuda_hist.hist_tile_exact(*args, amax=amax, rows=gang_rows)
    torch.cuda.synchronize()
    checks = {"bitwise_exact": bool(torch.equal(a, exact)),
              "two_launches_equal": bool(torch.equal(a, again)),
              "rank_sum_equals_one_pass": bool(torch.equal(lo + hi, a)),
              "convert_bitwise_plain": bool(torch.equal(conv, conv_plain)),
              "convert_equals_one_pass": bool(torch.equal(conv, one_pass)),
              "launches_counted": launched == 2}
    if not all(checks.values()):
        raise AssertionError(f"hist_int_planes: {checks}")
    in_tile = torch.zeros(LEAVES, dtype=torch.bool, device="cuda")
    in_tile[sel[sel >= 0].long().cuda()] = True
    in_tile = in_tile[leaf.long()]
    fixed, _, _ = cuda_hist._to_fixed(stats, amax, gang_rows)
    cells = P * f * B * 3
    pass_bound = bound(f * n + 16 * n + cells * 8, float(in_tile.sum()) * f
                       * 3)
    conv_bound = bound(cells * (8 + 4), cells)
    pass_dev = device_ms(run)
    conv_dev = device_ms(lambda: cuda_hist.hist_convert(a, amax, gang_rows),
                         per_profile=10, need="hist_convert")
    return {**checks,
            "pass": {"ms": time_ms(run), "device_ms": pass_dev[0],
                     "device_split": pass_dev[1],
                     "plain_ms": time_ms(lambda: cuda_hist.hist_tile_exact(
                         *args, amax=amax, rows=gang_rows, raw=True),
                         reps=3, warm=1),
                     "bound_ms": pass_bound[0], "bound_by": pass_bound[1],
                     "library_ms": library_ms(binsT, leaf, fixed, sel,
                                              in_tile, f, B, torch.int64)},
            "convert": {"ms": time_ms(lambda: cuda_hist.hist_convert(
                a, amax, gang_rows)), "device_ms": conv_dev[0],
                "plain_ms": time_ms(lambda: cuda_hist.hist_convert_plain(
                    a, amax, gang_rows)),
                "bound_ms": conv_bound[0], "bound_by": conv_bound[1],
                "library_ms": None}}


def hist_int_planes_phase(cuda_hist, args):
    """hist_tile's integer-planes mode at the data learner's shapes: one
    rank's rows of a gang of DIST_WORLD over train's rows (N / 2 rows, F =
    28, B = 255, 255 leaves, the exponent over N), the root pass (one
    computed slot) and the classic tile (42 computed slots, the gather
    form over all the rank's rows)."""
    n_loc = args.rows // DIST_WORLD
    out = {"rows_per_rank": n_loc, "gang_rows": n_loc * DIST_WORLD}
    for name, sel, share in (("root", tile_selection(root=True), 1.0),
                             ("slots", tile_selection(plane=True), 0.75)):
        binsT, leaf, stats = hist_inputs(n_loc, F, args.seed + 31, False,
                                         sel[sel >= 0], share)
        out[name] = _int_planes_case(cuda_hist, binsT, leaf, stats, sel,
                                     n_loc * DIST_WORLD)
    return out


def _first_diff(a: str, b: str):
    """The first line at which two model texts' trees differ (the text
    before ``parameters:``): its number, its key and both values, cut."""
    ta = a.split("\nparameters:")[0].splitlines()
    tb = b.split("\nparameters:")[0].splitlines()
    tree = None
    for i, (x, y) in enumerate(zip(ta, tb)):
        if x.startswith("Tree="):
            tree = x
        # tree_sizes follows from the trees' own lines
        if x != y and not x.startswith("tree_sizes="):
            return {"line": i, "tree": tree, "key": x.split("=")[0],
                    "a": x[:160], "b": y[:160]}
    return None if len(ta) == len(tb) else {"line": min(len(ta), len(tb)),
                                             "key": "length"}


def _launched_nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def dist_child_main(args) -> int:
    """One rank of the distributed group's gang (``--child dist``): joins
    the gang (rank ``--rank`` of ``--world`` on the localhost port
    ``--port``; with ``--nccl`` card ``--rank`` and NCCL, else card 0,
    shared, through gloo), then trains train's Higgs-shaped rows with each
    learner twice at full width, replicated (every rank holds all rows),
    and (``--parity``) the 50,000-row parity runs on the card and, over
    the same gang, on the CPU inside ``kernel_sums_on_cpu()``. Prints one
    JSON line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import distributed, network
    from lightgbm_tpu_torch.ops import cuda_hist
    t_start = time.time()
    machines = ",".join(f"127.0.0.1:{args.port}" for _ in range(args.world))
    dev = f"cuda:{args.rank}" if args.nccl else "cuda:0"
    net = distributed.init(machines=machines, num_machines=args.world,
                           rank=args.rank, device=dev,
                           backend="nccl" if args.nccl else None,
                           params={"device_type": "cuda", "time_out": 10})
    out = {"rank": net.rank, "world": net.world, "device": str(net.device),
           "backend": net.backend, "reason": net.reason,
           "join_s": time.time() - t_start, "learners": {}}
    X, y = higgs_like(args.rows + args.valid_rows, args.seed)
    Xv, yv = X[args.rows:], y[args.rows:]
    X, y = X[:args.rows], y[:args.rows]
    base = dict(PARAMS, device_type="cuda", top_k=DIST_TOP_K)
    t0 = time.time()
    train = lgb.Dataset(X, label=y, params=dict(base, tree_learner="data"))
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    train.construct()
    valid.construct()
    torch.cuda.synchronize()
    out["construct_s"] = time.time() - t0
    learners = DIST_LEARNERS if not args.nccl else ("data",)
    for learner in learners:
        p = dict(base, tree_learner=learner)
        runs = []
        for _ in range(2):
            evals = {}
            cuda_hist.reset_launch_counts()
            net.reset_counters()
            torch.cuda.synchronize()
            t0 = time.time()
            b = lgb.train(p, train, args.rounds, valid_sets=[valid],
                          valid_names=["valid"], evals_result=evals)
            torch.cuda.synchronize()
            wall = time.time() - t0
            coll = {k: dict(v) for k, v in net.counters.items()
                    if v["calls"]}
            runs.append({"sec_per_iter": wall / args.rounds,
                         "valid_auc": evals["valid"]["auc"][-1],
                         "text": b.model_to_string(),
                         "launches": _launched_nonzero(
                             cuda_hist.launch_counts()),
                         "collectives": coll, "totals": net.totals()})
        prof = profile_iteration(b, runs[-1]["sec_per_iter"])
        tot = runs[-1]["totals"]
        out["learners"][learner] = {
            "sec_per_iter": [r["sec_per_iter"] for r in runs],
            "valid_auc": runs[-1]["valid_auc"],
            "texts_equal": runs[0]["text"] == runs[1]["text"],
            "text_sha": _sha(runs[-1]["text"]),
            "trees_sha": _sha(runs[-1]["text"].split("\nparameters:")[0]),
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof.get("device_idle_share",
                                          "not measured"),
            "own_kernels": prof["own_kernels"],
            "collective_s_per_iter": tot["seconds"] / args.rounds,
            "collective_bytes_per_iter": tot["bytes"] / args.rounds,
            "collective_calls_per_iter": tot["calls"] / args.rounds,
            "collectives": runs[-1]["collectives"],
            "launches": runs[-1]["launches"],
            "rows_streamed_per_tree": b.rows_streamed_per_tree}
        if args.rank == 0:
            out["learners"][learner]["text"] = runs[-1]["text"]
    if args.parity:
        out["parity"] = _dist_parity(lgb, cuda_hist, network, net, args)
    print(json.dumps(out), flush=True)
    distributed.shutdown()
    return 0


def _dist_parity(lgb, cuda_hist, network, net, args):
    """Each learner at DIST_PARITY_ROWS rows and DIST_PARITY_LEAVES leaves:
    the card gang's text against the same gang's CPU run inside
    ``kernel_sums_on_cpu()`` (a CPU network over the same gloo group)."""
    X, y = higgs_like(DIST_PARITY_ROWS, args.seed + 5)
    cpu_net = network.Network(net.group, net.rank, net.world, "cpu",
                              net.backend, net.store, "the CPU twin")
    out = {}
    for learner in DIST_LEARNERS:
        p = dict(PARAMS, num_leaves=DIST_PARITY_LEAVES, tree_learner=learner,
                 top_k=DIST_TOP_K)
        texts = {}
        for device in ("cuda", "cpu"):
            pd = dict(p, device_type=device)
            ctx = (cuda_hist.kernel_sums_on_cpu() if device == "cpu"
                   else contextlib.nullcontext())
            with ctx, network.bind(cpu_net if device == "cpu" else net):
                cuda_hist.reset_launch_counts()
                ds = lgb.Dataset(X, label=y, params=pd)
                texts[device] = lgb.train(pd, ds, DIST_PARITY_ROUNDS
                                          ).model_to_string()
                if device == "cuda":
                    launches = _launched_nonzero(cuda_hist.launch_counts())
        out[learner] = {"equal": texts["cuda"] == texts["cpu"],
                        "sha": _sha(texts["cuda"]), "launches": launches,
                        "first_diff": _first_diff(texts["cuda"],
                                                  texts["cpu"])}
    return out


def _run_gang(args, world, nccl=False, parity=True):
    """The distributed group's gang: ``world`` ranks as ``--child dist``
    processes started together; fails if a rank fails (its exit code and
    the tail of its error output). Returns every rank's JSON, rank order."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cmd = [sys.executable, os.path.abspath(__file__), "--child", "dist",
           "--world", str(world), "--port", str(port), "--seed",
           str(args.seed), "--rows", str(args.rows), "--valid-rows",
           str(args.valid_rows), "--rounds", str(DIST_ROUNDS)]
    cmd += (["--nccl"] if nccl else []) + (["--parity"] if parity else [])
    procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    results = []
    try:
        for r, proc in enumerate(procs):
            so, se = proc.communicate(timeout=DIST_CHILD_TIMEOUT)
            if proc.returncode != 0:
                raise AssertionError(f"distributed rank {r} exited "
                                     f"{proc.returncode}: {se[-3000:]}")
            results.append(json.loads([ln for ln in so.splitlines()
                                       if ln.startswith("{")][-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def distributed_phases(lgb, cuda_hist, args):
    """The distributed group's phases, each emitted: ``hist_int_planes``,
    the serial classic reference on train's rows, the gang's full-width
    runs of each learner (``train_data_parallel``,
    ``train_feature_parallel``, ``train_voting_parallel``),
    ``parity_distributed`` and the NCCL gang (with two or more cards).
    Returns (hist_int_planes's numbers, every rank's launches by path)."""
    t0 = time.time()
    hp = hist_int_planes_phase(cuda_hist, args)
    emit("hist_int_planes", seconds=time.time() - t0, **hp)
    # the serial classic run: the AUC reference, and the text the gangs'
    # trees are compared with
    t0 = time.time()
    X, y = higgs_like(args.rows + args.valid_rows, args.seed)
    params = dict(PARAMS, device_type="cuda", split_fusion="off")
    train = lgb.Dataset(X[:args.rows], label=y[:args.rows], params=params)
    valid = lgb.Dataset(X[args.rows:], label=y[args.rows:], reference=train)
    evals = {}
    torch.cuda.synchronize()
    t1 = time.time()
    serial = lgb.train(params, train, DIST_ROUNDS, valid_sets=[valid],
                       valid_names=["valid"], evals_result=evals)
    torch.cuda.synchronize()
    ref = {"sec_per_iter": (time.time() - t1) / DIST_ROUNDS,
           "valid_auc": evals["valid"]["auc"][-1], "rounds": DIST_ROUNDS}
    serial_text = serial.model_to_string()
    del train, valid, serial, X, y
    torch.cuda.empty_cache()
    emit("train_serial_classic", seconds=time.time() - t0, **ref)
    t0 = time.time()
    ranks = _run_gang(args, DIST_WORLD)
    gang_s = time.time() - t0
    paths = {}
    for learner in DIST_LEARNERS:
        per_rank = [r["learners"][learner] for r in ranks]
        text = per_rank[0].pop("text")
        lead = per_rank[0]
        ok = {"texts_equal_twice": all(r["texts_equal"] for r in per_rank),
              "ranks_equal": len({r["text_sha"] for r in per_rank}) == 1,
              "auc_within_0.01": abs(lead["valid_auc"] - ref["valid_auc"])
              <= 0.01,
              "every_rank_launched_kernels_3_4": all(
                  r["launches"].get("hist_tile.launches_plane", 0)
                  + r["launches"].get("hist_tile.launches_plane_raw", 0) > 0
                  for r in per_rank)}
        if learner == "data":
            ok["every_rank_integer_planes"] = all(
                r["launches"].get("hist_tile.launches_plane_raw", 0) > 0
                and r["launches"].get("hist_convert.launches", 0) > 0
                for r in per_rank)
        emit(f"train_{learner}_parallel", world=DIST_WORLD,
             backend=ranks[0]["backend"], reason=ranks[0]["reason"],
             rounds=DIST_ROUNDS, serial_classic=ref,
             trees_equal_serial_classic=(
                 text.split("\nparameters:")[0]
                 == serial_text.split("\nparameters:")[0]),
             first_diff_vs_serial=_first_diff(text, serial_text),
             ranks=per_rank, checks=ok, gang_seconds=gang_s)
        if not all(ok.values()):
            raise AssertionError(f"train_{learner}_parallel: {ok}")
        for rank, r in zip(ranks, per_rank):
            paths[f"distributed/{learner}/rank{rank['rank']}"] = \
                r["launches"]
    par = {learner: [r["parity"][learner] for r in ranks]
           for learner in DIST_LEARNERS}
    emit("parity_distributed", rows=DIST_PARITY_ROWS,
         leaves=DIST_PARITY_LEAVES, rounds=DIST_PARITY_ROUNDS, runs=par)
    if not all(x["equal"] for v in par.values() for x in v):
        raise AssertionError(f"parity_distributed: {par}")
    if torch.cuda.device_count() >= 2:
        # a card a rank: the same gang over NCCL must train the gloo
        # gang's text (integer planes and rank-order folds either way)
        t0 = time.time()
        nccl = _run_gang(args, 2, nccl=True, parity=False)
        lead = nccl[0]["learners"]["data"]
        lead.pop("text", None)
        same = lead["text_sha"] == ranks[0]["learners"]["data"]["text_sha"]
        if not (nccl[0]["backend"] == "nccl" and lead["texts_equal"]
                and same):
            raise AssertionError(f"train_data_parallel_nccl: {nccl[0]}")
        emit("train_data_parallel_nccl", seconds=time.time() - t0,
             ranks=[r["learners"]["data"] for r in nccl],
             backend=nccl[0]["backend"], equals_the_gloo_gang=same)
    else:
        emit("train_data_parallel_nccl", run=False,
             why=f"{torch.cuda.device_count()} card: NCCL needs a card per "
                 f"rank (two ranks on one card are refused), so the gang "
                 f"above reduced through host memory over gloo")
    return hp, paths


def dist_kernel_entries(hp, paths, lead=None):
    """The kernels line's entries of the distributed and resilience
    groups: hist_tile's integer-planes mode and its convert launch, their
    ``launches`` those of path ``lead`` (else the first data-learner path
    by name), ``launches_by_path`` every data-learner path's."""
    data = {k: v for k, v in paths.items() if "/data/" in k}
    lead = data[lead if lead is not None else min(data)]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [
        {"name": "hist_tile (plane-only, integer planes)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:154 _fused_kernel "
                     "(pallas_call :270) + :205 _gather_kernel (pallas_call "
                     ":324), each rank's planes before the psum_scatter of "
                     "lightgbm_tpu/models/grower.py:1110",
         "launches": lead.get("hist_tile.launches_plane_raw", 0),
         "max_abs_err": 0.0,
         **{k: hp["root"]["pass"][k] for k in keys},
         "slots": {k: hp["slots"]["pass"][k] for k in keys},
         "launches_by_path": {k: v.get("hist_tile.launches_plane_raw", 0)
                              for k, v in data.items()}},
        {"name": "hist_convert", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "the convert of lightgbm_tpu/ops/pallas_hist.py:154 "
                     "_fused_kernel + :205 _gather_kernel, run after the "
                     "cross-rank sum (lightgbm_tpu/models/grower.py:1110)",
         "launches": lead.get("hist_convert.launches", 0),
         "max_abs_err": 0.0,
         **{k: hp["slots"]["convert"][k] for k in keys},
         "launches_by_path": {k: v.get("hist_convert.launches", 0)
                              for k, v in data.items()}}]


# -------------------------------------------------------------- resilience
# The resilience group: supervised, elastic distributed training. Gangs of
# RES_WORLD processes started by lightgbm_tpu_torch.supervisor (the spawn
# context; every rank on card 0 through gloo, "ranks share a card"), the
# data learner over pre-partitioned rows (each rank its contiguous half of
# train's 2M Higgs-shaped rows), a sharded checkpoint every iteration and
# resume_from on the same directory, heartbeats, the collective watchdog
# and the integrity vote every iteration.
RES_WORLD = 2
RES_ROUNDS = 4
RES_DEADLINE = 10.0          # collective_deadline (s)
RES_HEARTBEAT = 1.0          # heartbeat_interval (s)
RES_FAULT = "1:2"            # rank 1 at the start of iteration 2
RES_TIMEOUT = 300            # an incarnation's deadline (s)
RES_AUC_TOL = 1e-4           # the shrunk run's valid AUC against W = 2's
RES_PARITY_VALID = 20_000    # resilience_parity's valid rows


def res_rank(rank, ckdir, cfg):
    """One rank of a resilience gang (module level: the supervisor's spawn
    context pickles it by name). Reads its rows from the group's .npy
    files (all rows with ``replicated``, else its contiguous block of the
    gang's world, taken after the init so a shrunk gang re-splits them),
    trains ``cfg["params"]`` (inside ``kernel_sums_on_cpu()`` with
    ``kernel_sums``) with a checkpoint every iteration and ``resume_from``
    on ``ckdir``, and appends one line an iteration to
    ``<ckdir>.events.jsonl``: incarnation, rank, world, iteration, wall
    time after its checkpoint, the checkpoint's seconds (``last_save``)
    and the integrity vote's host ms. Returns the model text, the
    kernels' launches in this run and the rank's data seconds."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import distributed, network
    from lightgbm_tpu_torch.ops import cuda_hist
    from lightgbm_tpu_torch.utils import profiling
    t0 = time.time()
    net = network.current()
    X = np.load(cfg["x"], mmap_mode="r")
    y = np.load(cfg["y"], mmap_mode="r")
    params = dict(PARAMS, **cfg["params"])
    if cfg.get("replicated"):
        lo, hi = 0, X.shape[0]
    else:
        c = -(-X.shape[0] // net.world)
        lo, hi = net.rank * c, min(X.shape[0], (net.rank + 1) * c)
    Xr, yr = np.ascontiguousarray(X[lo:hi]), np.ascontiguousarray(y[lo:hi])
    ckpt = lgb.checkpoint_callback(ckdir, period=1, keep=cfg.get("keep", 2))

    def event(env):
        line = {"incarnation": int(os.environ.get("LGBM_TPU_RESTART_COUNT",
                                                  "0")),
                "rank": net.rank, "world": net.world,
                "iteration": env.iteration, "t": time.time(),
                "ckpt": dict(ckpt.manager.last_save),
                "integrity_ms": profiling.gauges().get(
                    "integrity_check_ms")}
        with open(ckdir + ".events.jsonl", "a") as fh:
            fh.write(json.dumps(line) + "\n")
    event.order = 45             # after the checkpoint (40)

    with (cuda_hist.kernel_sums_on_cpu() if cfg.get("kernel_sums")
          else contextlib.nullcontext()):
        if cfg.get("replicated"):
            ds = lgb.Dataset(Xr, label=yr, params=dict(params))
            ds.construct()
        else:
            ds = distributed.load_partitioned(Xr, label=yr,
                                              params=dict(params))
        data_s = time.time() - t0
        cuda_hist.reset_launch_counts()
        booster = lgb.train(dict(params), ds, cfg["rounds"],
                            callbacks=[ckpt, event], resume_from=ckdir)
        launches = _launched_nonzero(cuda_hist.launch_counts())
    return {"text": booster.model_to_string(), "launches": launches,
            "data_s": data_s, "world": net.world}


def _res_events(ckdir):
    with open(ckdir + ".events.jsonl") as fh:
        return [json.loads(line) for line in fh]


def _res_run(workdir, name, cfg, env=None, world=RES_WORLD, **kw):
    """One supervised gang of ``world`` ranks, ``env`` (one-shot faults)
    set while it is launched. Returns (report, events, seconds)."""
    from lightgbm_tpu_torch import supervisor
    env = env or {}
    ckdir = os.path.join(workdir, name)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.time()
    try:
        rep = supervisor.run_supervised(
            res_rank, nproc=world, args=(ckdir, cfg),
            device_type=cfg["params"]["device_type"], checkpoint_dir=ckdir,
            max_restarts=2, timeout=RES_TIMEOUT, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rep, _res_events(ckdir), time.time() - t0


def _res_numbers(rep, events, fault_rank=None):
    """A supervised run's numbers: restarts, exit codes, the seconds to
    detect the fault (from the faulted rank's last completed iteration,
    or the incarnation's launch when it never completed one), to tear the
    gang down, to relaunch up to the end of the first resumed iteration
    (checkpoint included) and from the fault to it, the sharded
    checkpoint's and the integrity vote's host times (medians over every
    rank and iteration), and rank 0's launches of the integer-planes mode
    and of hist_convert."""
    def med(xs):
        xs = [x for x in xs if x is not None]
        return statistics.median(xs) if xs else "not measured"

    out = {"restarts": rep.restarts, "world_size": rep.world_size,
           "wall_s": rep.wall_time,
           "exit_codes": [{str(r): c for r, c in f.exit_codes.items()}
                          for f in rep.failures],
           "reasons": [f.reason if len(f.reason) <= 300 else
                       f.reason[:100] + " ... " + f.reason[-200:]
                       for f in rep.failures],
           "shrinks": [{"from": s.from_nproc, "to": s.to_nproc,
                        "lost": s.lost_ranks, "reason": s.reason}
                       for s in rep.shrinks],
           "diagnoses": [{k: d.get(k) for k in (
               "kind", "rank", "iteration", "phase", "suspects", "elapsed",
               "corrupt_ranks")} for f in rep.failures for d in f.watchdog],
           "ckpt_write_s": med(e["ckpt"].get("seconds") for e in events),
           "ckpt_shard_s": med(e["ckpt"].get("shard_seconds")
                               for e in events),
           "integrity_ms": med(e["integrity_ms"] for e in events),
           "rank0_data_s": rep.result["data_s"],
           "launches_plane_raw": rep.result["launches"].get(
               "hist_tile.launches_plane_raw", 0),
           "launches_convert": rep.result["launches"].get(
               "hist_convert.launches", 0),
           "postmortem": _res_postmortem(rep)}
    if rep.failures:
        f = rep.failures[0]
        before = [e["t"] for e in events if e["incarnation"] == 0
                  and e["rank"] == fault_rank]
        t_fault = max(before) if before else f.started_at
        after = [e["t"] for e in events if e["incarnation"] == 1]
        out.update({
            "detect_s": f.detected_at - t_fault,
            "teardown_s": f.teardown_seconds,
            "relaunch_to_first_iteration_s":
                min(after) - rep.incarnation_starts[1] if after
                else "no iteration left",
            "fault_to_first_resumed_iteration_s":
                min(after) - t_fault if after else "no iteration left"})
    return out


def _res_postmortem(rep):
    """The supervisor's post-mortem of a run with a failure (its verdict,
    rank, iteration, cause and the flight recorders it read), or None."""
    if rep.postmortem is None:
        return None
    with open(rep.postmortem) as fh:
        pm = json.load(fh)
    return {k: pm[k] for k in ("verdict", "rank", "iteration", "cause")} \
        | {"flights": len(pm["sources"]["flights"]),
           "diags": len(pm["sources"]["diags"])}


def _header(text: str) -> str:
    """A model text's bin-dependent header line (each feature's range)."""
    return next(ln for ln in text.splitlines()
                if ln.startswith("feature_infos="))


def _res_check(name, checks, out):
    out["checks"] = checks
    emit(name, **out)
    if not all(checks.values()):
        raise AssertionError(f"{name}: {checks}")


def resilience_phases(lgb, cuda_hist, args):
    """The resilience group's phases, each emitted:

    - ``resilience_reference``: the uninterrupted supervised gang, the
      text the next two phases are held to, its valid AUC;
    - ``resilience_kill``: rank 1 killed (exit 137) at iteration 2: one
      relaunch at the same world size, text bitwise the reference's;
    - ``resilience_hang``: rank 1 hung at iteration 2: a watchdog exit
      (97) whose diagnosis names rank 1, then the same;
    - ``resilience_shrink``: the gang is relaunched from the reference's
      sharded checkpoint of iteration 2 and rank 1's spawn fails (exit
      96): the gang shrinks to 1 and resumes from the two shards; the
      same resume again in this process gives the same bits; its valid
      AUC against the reference's (within RES_AUC_TOL or not: the gang of
      1 re-bins from its own sample) and its first difference recorded;
    - ``resilience_parity`` at DIST_PARITY_ROWS rows and
      DIST_PARITY_LEAVES leaves, in this process: a gang of 2 thread-ranks
      checkpoints 2 iterations and a gang of 1 resumes from its shards,
      twice on the card and once on the CPU inside kernel_sums_on_cpu(),
      the three texts equal, its bins and valid AUC (within RES_AUC_TOL)
      the uninterrupted gang of 2's; and a supervised gang over replicated
      rows
      with rank 1's score flipped after iteration 2 and the vote every
      iteration (at world 2 no majority: both ranks raise, the gang
      relaunches) against the same gang uninterrupted, bitwise.

    Returns the launches of every run's rank 0 by path."""
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="chip_resilience_")
    paths = {}
    try:
        t0 = time.time()
        X, y = higgs_like(args.rows + args.valid_rows, args.seed)
        Xv, yv = X[args.rows:], y[args.rows:]
        np.save(os.path.join(workdir, "x.npy"), X[:args.rows])
        np.save(os.path.join(workdir, "y.npy"), y[:args.rows])
        del X, y
        data_s = time.time() - t0
        supervision = {"tree_learner": "data",
                       "heartbeat_interval": RES_HEARTBEAT,
                       "collective_deadline": RES_DEADLINE,
                       "integrity_check_period": 1}
        full = {"x": os.path.join(workdir, "x.npy"),
                "y": os.path.join(workdir, "y.npy"), "rounds": RES_ROUNDS,
                "params": dict(supervision, device_type="cuda")}

        def valid_auc(text):
            b = lgb.Booster(params={"device_type": "cuda"}, model_str=text)
            return auc(np.asarray(b.predict(Xv)), yv)

        common = {"world": RES_WORLD, "rows": args.rows,
                  "rows_per_rank": args.rows // RES_WORLD,
                  "rounds": RES_ROUNDS, "leaves": PARAMS["num_leaves"],
                  "deadline_s": RES_DEADLINE}
        rep, ev, wall = _res_run(workdir, "reference", dict(full, keep=4))
        ref = rep.result["text"]
        ref_auc = valid_auc(ref)
        out = dict(common, make_data_s=data_s, seconds=wall,
                   valid_auc=ref_auc,
                   **_res_numbers(rep, ev))
        paths["resilience/data/reference"] = rep.result["launches"]
        _res_check("resilience_reference", {
            "no_restart": rep.restarts == 0,
            "integer_planes_launched": out["launches_plane_raw"] > 0,
            "convert_launched": out["launches_convert"] > 0,
            "sharded": all(e["ckpt"].get("sharded") for e in ev)}, out)

        rep, ev, wall = _res_run(
            workdir, "kill", full,
            {"LGBM_TPU_FAULT_KILL_RANK_AT_ITER": RES_FAULT})
        out = dict(common, seconds=wall, **_res_numbers(rep, ev, 1))
        paths["resilience/data/kill"] = rep.result["launches"]
        _res_check("resilience_kill", {
            "one_relaunch": rep.restarts == 1 and rep.world_size == RES_WORLD,
            "rank1_killed": rep.failures[0].exit_codes.get(1) == 137,
            "postmortem_kill_rank1_iteration2": out["postmortem"] is not None
            and (out["postmortem"]["verdict"], out["postmortem"]["rank"],
                 out["postmortem"]["iteration"]) == ("kill", 1, 2),
            "text_bitwise_reference": rep.result["text"] == ref}, out)

        rep, ev, wall = _res_run(
            workdir, "hang", full,
            {"LGBM_TPU_FAULT_HANG_RANK_AT_ITER": RES_FAULT})
        out = dict(common, seconds=wall, **_res_numbers(rep, ev, 1))
        paths["resilience/data/hang"] = rep.result["launches"]
        _res_check("resilience_hang", {
            "one_relaunch": rep.restarts == 1 and rep.world_size == RES_WORLD,
            "watchdog_fired": rep.failures[0].watchdog_fired,
            "names_rank1": any(1 in (d.get("suspects") or [])
                               for d in rep.failures[0].watchdog),
            "detected_within_deadline_plus_2s":
                out["detect_s"] <= RES_DEADLINE + 2.0,
            # the hang begins before iteration 2's step: the diagnoses
            # name iteration 1, the last one completed
            "postmortem_hang_rank1_iteration1": out["postmortem"] is not None
            and (out["postmortem"]["verdict"], out["postmortem"]["rank"],
                 out["postmortem"]["iteration"]) == ("hang", 1, 1),
            "text_bitwise_reference": rep.result["text"] == ref}, out)

        # the shrink: the gang checkpointed at iteration 2 (the
        # reference's sharded checkpoint, written by the gang of 2), is
        # relaunched, and rank 1's spawn fails: the gang of 1 resumes
        # from the two shards
        for name in ("shrink", "shrink_again"):
            os.makedirs(os.path.join(workdir, name))
            shutil.copytree(os.path.join(workdir, "reference",
                                         "ckpt_00000002"),
                            os.path.join(workdir, name, "ckpt_00000002"))
        rep, ev, wall = _res_run(
            workdir, "shrink", full,
            {"LGBM_TPU_FAULT_SPAWN_FAIL_RANK": "1"})
        shrunk = rep.result["text"]
        shrunk_auc = valid_auc(shrunk)
        # the same shrunk run again, in this process: a gang of 1 resuming
        # from the same checkpoint
        t1 = time.time()
        again = _res_inprocess(lgb, full, os.path.join(workdir,
                                                       "shrink_again"))
        # the gang of 1 bins its rows from its own sample
        # (bin_construct_sample_cnt rows of 2M, not 100,000 of each 1M):
        # its later trees see other bin boundaries, so the AUC bar is
        # recorded here and held at the parity size, where every world
        # size samples every row
        out = dict(common, seconds=wall, valid_auc=shrunk_auc,
                   reference_auc=ref_auc,
                   auc_diff=shrunk_auc - ref_auc,
                   auc_within_tol=abs(shrunk_auc - ref_auc) <= RES_AUC_TOL,
                   auc_tol=RES_AUC_TOL,
                   rebinned=_header(shrunk) != _header(ref),
                   text_equal_reference=shrunk == ref,
                   first_diff_vs_reference=_first_diff(shrunk, ref),
                   again_seconds=time.time() - t1,
                   launches_plane=rep.result["launches"].get(
                       "hist_tile.launches_plane", 0),
                   **_res_numbers(rep, ev))
        paths["resilience/data/shrink"] = rep.result["launches"]
        _res_check("resilience_shrink", {
            "shrunk_2_to_1": [(s.from_nproc, s.to_nproc, s.lost_ranks)
                              for s in rep.shrinks] == [(2, 1, [1])],
            "spawn_failed": rep.failures[0].spawn_failed_ranks == [1],
            "resumed_at_2": sorted({e["iteration"] for e in ev
                                    if e["incarnation"] == 1}) == [2, 3],
            "same_bits_twice": again == shrunk,
            "kernels_3_4_launched": out["launches_plane"] > 0}, out)

        par, ppaths = _resilience_parity(lgb, cuda_hist, workdir, args,
                                         supervision)
        paths.update(ppaths)
        emit("resilience_parity", **par)
        if not all(par["checks"].values()):
            raise AssertionError(f"resilience_parity: {par['checks']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return paths


def _res_inprocess(lgb, cfg, ckdir, stop=None, world=1, kernel_sums=False):
    """The group's training in this process: a gang of ``world``
    thread-ranks (network.thread_gang; a gang of 1 alone) on
    ``cfg["params"]``'s device, pre-partitioned like res_rank (all rows
    with ``replicated``), checkpointing to ``ckdir`` and resuming from it,
    ``stop`` rounds (else cfg's), each rank inside kernel_sums_on_cpu()
    with ``kernel_sums``. Returns rank 0's model text."""
    from lightgbm_tpu_torch import distributed, network
    from lightgbm_tpu_torch.ops import cuda_hist
    X, y = np.load(cfg["x"]), np.load(cfg["y"])
    params = dict(PARAMS, **cfg["params"])

    def body(net):
        with (cuda_hist.kernel_sums_on_cpu() if kernel_sums
              else contextlib.nullcontext()):
            if cfg.get("replicated"):
                ds = lgb.Dataset(X, label=y, params=dict(params))
            else:
                c = -(-X.shape[0] // net.world)
                lo, hi = net.rank * c, min(X.shape[0], (net.rank + 1) * c)
                ds = distributed.load_partitioned(
                    X[lo:hi], label=y[lo:hi], params=dict(params))
            b = lgb.train(dict(params), ds, stop or cfg["rounds"],
                          callbacks=[lgb.checkpoint_callback(ckdir,
                                                             period=1)],
                          resume_from=ckdir)
            return b.model_to_string()

    if world == 1:
        return body(network.current())
    dev = "cuda:0" if params["device_type"] == "cuda" else "cpu"
    return network.thread_gang(world, body, device=dev)[0]


def _resilience_parity(lgb, cuda_hist, workdir, args, supervision):
    """resilience_parity's runs (see resilience_phases); returns its line
    and the launches by path."""
    t0 = time.time()
    X, y = higgs_like(DIST_PARITY_ROWS + RES_PARITY_VALID, args.seed + 5)
    Xv, yv = X[DIST_PARITY_ROWS:], y[DIST_PARITY_ROWS:]
    np.save(os.path.join(workdir, "px.npy"), X[:DIST_PARITY_ROWS])
    np.save(os.path.join(workdir, "py.npy"), y[:DIST_PARITY_ROWS])
    small = {"x": os.path.join(workdir, "px.npy"),
             "y": os.path.join(workdir, "py.npy"), "rounds": RES_ROUNDS}
    card = dict(small, params=dict(supervision, device_type="cuda",
                                   num_leaves=DIST_PARITY_LEAVES))
    # the in-process runs arm no watchdog in this process: a CPU step in
    # the kernels' orders may take longer than the deadline
    quiet = dict(supervision, collective_deadline=0.0,
                 heartbeat_interval=0.0, num_leaves=DIST_PARITY_LEAVES)
    texts = {}
    # the kill and the shrink, in this process: a gang of 2 thread-ranks
    # checkpoints iterations 0 and 1, then a gang of 1 resumes from its
    # two shards
    for name, dev, sums in (("shrink_card", "cuda", False),
                            ("shrink_card_again", "cuda", False),
                            ("shrink_cpu_kernel_order", "cpu", True)):
        cfg = dict(small, params=dict(quiet, device_type=dev))
        ck = os.path.join(workdir, name)
        _res_inprocess(lgb, cfg, ck, stop=2, world=2, kernel_sums=sums)
        texts[name] = _res_inprocess(lgb, cfg, ck, kernel_sums=sums)
    # the same gang of 2 uninterrupted
    texts["gang_of_2"] = _res_inprocess(
        lgb, dict(small, params=dict(quiet, device_type="cuda")),
        os.path.join(workdir, "gang_of_2"), world=2)
    # replicated rows, the vote every iteration, rank 1's score flipped
    # after iteration 2: at world 2 no majority, both ranks raise, one
    # relaunch; against the same gang uninterrupted (in this process)
    rep_cfg = dict(card, replicated=True)
    texts["replicated"] = _res_inprocess(
        lgb, rep_cfg, os.path.join(workdir, "replicated"), world=2)
    rep, ev, wall = _res_run(workdir, "replicated_flip", rep_cfg,
                             {"LGBM_TPU_FAULT_FLIP_SCORE_RANK": RES_FAULT})
    flip = dict(seconds=wall, **_res_numbers(rep, ev, 1))
    texts["replicated_flip"] = rep.result["text"]
    aucs = {k: auc(np.asarray(lgb.Booster(
        params={"device_type": "cuda"}, model_str=texts[k]).predict(Xv)), yv)
        for k in ("shrink_card", "gang_of_2")}
    checks = {
        "shrunk_card_same_bits_twice":
            texts["shrink_card"] == texts["shrink_card_again"],
        "shrunk_card_equals_cpu_gang_kernel_order":
            texts["shrink_card"] == texts["shrink_cpu_kernel_order"],
        "flip_detected_and_relaunched":
            rep.restarts == 1
            and "RankDivergenceError" in " ".join(flip["reasons"]),
        "flip_restart_bitwise":
            texts["replicated_flip"] == texts["replicated"],
        "flip_integer_planes_launched": flip["launches_plane_raw"] > 0,
        # every world size bins every row here: the shrunk run's bins are
        # the gang of 2's
        "same_bins_after_the_shrink":
            _header(texts["shrink_card"]) == _header(texts["gang_of_2"]),
        "shrunk_auc_within_tol":
            abs(aucs["shrink_card"] - aucs["gang_of_2"]) <= RES_AUC_TOL}
    return ({"rows": DIST_PARITY_ROWS, "leaves": DIST_PARITY_LEAVES,
             "rounds": RES_ROUNDS, "seconds": time.time() - t0,
             "replicated_flip": flip,
             "valid_rows": RES_PARITY_VALID, "valid_auc": aucs,
             "text_sha": {k: _sha(v) for k, v in texts.items()},
             "first_diff_shrunk_vs_gang_of_2": _first_diff(
                 texts["shrink_card"], texts["gang_of_2"]),
             "checks": checks},
            {"resilience/data/parity_replicated_flip":
             rep.result["launches"]})

def per_launch(profile, name):
    """A kernel's device ms a launch in a train phase's profile
    (``own_kernels``)."""
    for key, val in profile["own_kernels"].items():
        if name in key and val["calls"]:
            return val["ms"] / val["calls"]
    return "not measured"


def _full_numbers(root, real, multi):
    """A kernel entry's full-form numbers: its own keys from the root pass
    on the train phase's bins (``root[real]``), the shape the main path
    launches; beside them the root on uniform bins and the full form of
    several computed slots."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {**{k: root[real][k] for k in keys},
            "root_bins": real,
            "root_uniform": {k: root["uniform"][k] for k in keys},
            "multi_slot": {k: multi[k] for k in keys}}


def epilogue_wide_entries(ew, q8: bool, fused, prof, mono_launches,
                          mono_path: str):
    """The wide epilogue's two kernels-line entries of one mode (f32 or
    q8), each with epilogue_wide's numbers at B = 1023 and those at 4095
    and 255 beside them: unconstrained (launches from ``fused``, the
    train_wide run's counts, and the device ms a launch in its profile
    ``prof``) and monotone (launches from ``mono_launches``, the counts
    of a wide monotone run on ``mono_path``, which must hold some)."""
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    tag, sfx = (", q8", "_q8") if q8 else ("", "")
    entries = []
    for mono in (False, True):
        m = "_mono" if mono else ""
        forms = {bb: ew[f"b{bb}{sfx}{m}"] for bb in (WIDE_B, WIDE_STRESS_B, B)}
        counter = f"split_epilogue.launches_wide{m}{sfx}"
        launched = (mono_launches if mono else fused).get(counter, 0)
        path = mono_path if mono else "train_wide" + sfx
        if launched <= 0:
            raise AssertionError(f"{path} launched no {counter}")
        entry = {
            "name": f"split_epilogue{m} (wide{tag})", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/split_epilogue.cu",
            "replaces": "lightgbm_tpu/ops/pallas_hist.py:465 "
                        "_epilogue_compute"
                        + (" with_monotone=True" if mono else "")
                        + " at num_bins > 256" + (", mode q8" if q8 else "")
                        + " (epilogue of :497 and :527)",
            "launches": launched,
            "max_abs_err": max(forms[WIDE_B]["max_abs_err"],
                               forms[WIDE_STRESS_B]["max_abs_err"]),
            **{k: forms[WIDE_B][k] for k in keys},
            f"b{WIDE_STRESS_B}": {k: forms[WIDE_STRESS_B][k] for k in keys},
            f"b{B}": {k: forms[B][k] for k in keys},
            "launches_by_path": {path: launched}}
        if not mono:
            entry["train_device_ms_per_launch"] = per_launch(
                prof, "split_epilogue_wide")
        entries.append(entry)
    return entries


def redesign_group(lgb, cuda_hist, args):
    """``--only redesign``: the wide epilogue alone -- train (the AUC the
    wide runs are held to), epilogue_wide, train_wide and train_wide_q8,
    parity_data's four wide runs on the card -- and with ``--parent DIR``
    its probes on DIR's package and on this one, in turns (parent, this,
    this, parent), on the same inputs, and those four runs' model texts
    against DIR's. Returns the wide epilogue's four entries."""
    parent, own = [], []

    def probe(other: bool):
        if other:
            parent.append(parent_times(args.parent, args.rows,
                                       args.valid_rows, args.seed, "wide"))
            emit("parent_times", dir=args.parent, ms=parent[-1])
        else:
            own.append(redesign_probes(cuda_hist, args.seed, WIDE_PASS))
            emit("probe_times", ms=own[-1])
    if args.parent:
        probe(True)
        probe(False)
    tr, _ = train_phase(lgb, cuda_hist, args)
    emit("train", **tr)
    ew = epilogue_wide_phase(cuda_hist, args.seed)
    emit("epilogue_wide", p=P, f=F, **ew)
    twd, wide_launches = train_wide_phase(lgb, cuda_hist, args,
                                          tr["valid_auc"])
    emit("train_wide", **twd)
    twq, wideq_launches = train_wide_phase(lgb, cuda_hist, args,
                                           twd["valid_auc"], q8=True)
    emit("train_wide_q8", **twq)
    texts = wide_texts(lgb, args.seed)
    if args.parent:
        probe(False)
        probe(True)
        same = same_wide_texts({k: v["sha256"] for k, v in texts.items()},
                               parent)
    emit("parity_data_wide", **texts, **(same if args.parent else {}))
    entries = []
    for q8, fused, prof in ((False, wide_launches, twd["profile"]),
                            (True, wideq_launches, twq["profile"])):
        mono_run = "wide_mono" + ("_q8" if q8 else "")
        entries += epilogue_wide_entries(ew, q8, fused, prof,
                                         texts[mono_run]["launches"],
                                         f"parity_data/{mono_run}")
    if args.parent:
        attach_probes(zip(entries, ((False, False), (False, True),
                                    (True, False), (True, True))),
                      own, parent)
    return entries


# ------------------------------------------------------------------ lanes
# The full run's groups that need nothing of the main process but train's
# and train_q8's numbers run beside its later phases: each lane is a
# process of this script (--child lane), all started together once the
# main process has timed its kernel phases. Their time is mostly the
# host's (process starts, gang ranks waiting on each other, the CPU's
# runs in the kernels' orders) and the card holds them all at once. A
# lane runs its groups in the order listed, writes its phase lines to its
# own output (relayed after the main process's phases; ``at_s`` counted
# from the main process's start) and its numbers as JSON; a lane that
# fails, or runs past LANE_DEADLINE, fails the run.
LANES = {"gangs": ("distributed", "resilience", "control", "serve"),
         "predict": ("predict", "faults"),
         "constraints": ("rank", "constraints")}
LANE_DEADLINE = 1100     # seconds from the main process's start
LANE_REF = "ref.json"    # train's and train_q8's numbers, for control and
                         # constraints (written by the main process)


def lane_ref(workdir: str) -> dict:
    """The main process's train numbers (``LANE_REF`` in ``workdir``),
    waited for up to the lanes' deadline."""
    path = os.path.join(workdir, LANE_REF)
    while not os.path.exists(path):
        if time.time() > _T0 + LANE_DEADLINE:
            raise AssertionError(f"lane: no {LANE_REF} from the main "
                                 f"process")
        time.sleep(0.5)
    with open(path) as fh:
        return json.load(fh)


def rank_phases(lgb, cuda_hist, args):
    """The ranking phases, each emitted; returns lambdarank_grads' numbers
    and train_rank's and train_rank_xendcg's launches."""
    rk = rank_kernel_phase(lgb, cuda_hist, args)
    emit("lambdarank_grads", **rk)
    emit("hist_tile_rank", **hist_rank_phase(lgb, cuda_hist, args))
    trk, rank_launches = train_rank_phase(lgb, cuda_hist, args)
    emit("train_rank", **trk)
    trx, xe_launches = train_rank_phase(lgb, cuda_hist, args, "rank_xendcg")
    emit("train_rank_xendcg", **trx)
    emit("parity_rank", **parity_rank_phase(lgb, args.seed))
    return {"rk": rk, "rank_launches": rank_launches,
            "xe_launches": xe_launches}


def constraint_phases(lgb, cuda_hist, args, ref):
    """The split constraints' phases, each emitted (``ref``: LANE_REF's
    train numbers); returns epilogue_mono's numbers, train_mono's and
    train_mono_q8's launches and profiles."""
    epm = epilogue_mono_phase(lgb, cuda_hist, args, real_bins(
        args.rows, args.valid_rows, args.seed)["higgs"])
    emit("epilogue_mono", p=P, b=B, **epm)
    tmn, mono_launches = train_mono_phase(lgb, cuda_hist, args,
                                          ref["train"]["valid_auc"])
    emit("train_mono", **tmn)
    tmq, monoq_launches = train_mono_phase(lgb, cuda_hist, args,
                                           ref["train_q8"]["valid_auc"],
                                           q8=True)
    emit("train_mono_q8", **tmq)
    emit("train_mono_modes", **train_mono_modes_phase(lgb, cuda_hist, args,
                                                      CONSTRAINED_ROUNDS))
    emit("train_constraints", **train_constraints_phase(
        lgb, cuda_hist, args, CONSTRAINED_ROUNDS))
    emit("parity_constraints", **parity_constraints_phase(lgb, args.seed))
    return {"epm": epm, "mono_launches": mono_launches,
            "monoq_launches": monoq_launches,
            "mono_profile": tmn["profile"], "monoq_profile": tmq["profile"]}


def _lane_group(group, lgb, cuda_hist, args) -> dict:
    """One group of a lane, its numbers as a JSON-able dict."""
    if group == "distributed":
        hp, paths = distributed_phases(lgb, cuda_hist, args)
        return {"dist_hp": hp, "dpaths": paths}
    if group == "resilience":
        return {"rpaths": resilience_phases(lgb, cuda_hist, args)}
    if group == "control":
        return {"control": control_phases(lgb, cuda_hist, args,
                                          lane_ref(args.workdir)["train"])}
    if group == "predict":
        return {"pentry": predict_phases(lgb, cuda_hist, args)}
    if group == "faults":
        fpaths, po_launches = faults_phases(lgb, cuda_hist, args)
        return {"fpaths": fpaths, "po_launches": po_launches}
    if group == "rank":
        return rank_phases(lgb, cuda_hist, args)
    if group == "serve":
        return {"serve": serve_phases(lgb, cuda_hist, args)}
    return constraint_phases(lgb, cuda_hist, args, lane_ref(args.workdir))


def lane_main(args) -> int:
    """``--child lane``: one lane's groups, then their numbers as one JSON
    object in ``<workdir>/<lane>.json``. Each lane takes an equal share of
    the host's cores for torch's CPU threads."""
    global _T0
    _T0 = args.t0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import cuda_hist, rank  # noqa: F401 (counts)
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // (len(LANES) + 1)))
    cuda_hist.build_kernels()
    out = {}
    for group in LANES[args.lane]:
        out.update(_lane_group(group, lgb, cuda_hist, args))
    tmp = os.path.join(args.workdir, f"{args.lane}.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(out, fh)
    os.replace(tmp, os.path.join(args.workdir, f"{args.lane}.json"))
    return 0


def start_lanes(args, workdir: str) -> dict:
    """Every lane of LANES as a process of this script in a session of its
    own (stop_lanes ends it with whatever it started), its output and
    error output to files in ``workdir``."""
    procs = {}
    for lane in LANES:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", "lane",
               "--lane", lane, "--workdir", workdir, "--t0", repr(_T0),
               "--seed", str(args.seed), "--rows", str(args.rows),
               "--valid-rows", str(args.valid_rows), "--rounds",
               str(args.rounds)]
        with open(os.path.join(workdir, f"{lane}.out"), "w") as out, \
                open(os.path.join(workdir, f"{lane}.err"), "w") as err:
            procs[lane] = subprocess.Popen(cmd, stdout=out, stderr=err,
                                           start_new_session=True)
    return procs


def write_lane_ref(workdir: str, ref: dict) -> None:
    tmp = os.path.join(workdir, LANE_REF + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(ref, fh)
    os.replace(tmp, os.path.join(workdir, LANE_REF))


def _relay(workdir: str, lane: str) -> str:
    """Prints a lane's phase lines and error output (once: the files go);
    returns the error output."""
    out, err = (os.path.join(workdir, f"{lane}.{k}") for k in ("out", "err"))
    if not os.path.exists(out):
        return ""
    with open(out) as fh:
        sys.stdout.write(fh.read())
    sys.stdout.flush()
    with open(err) as fh:
        text = fh.read()
    sys.stderr.write(text)
    sys.stderr.flush()
    os.remove(out)
    os.remove(err)
    return text


def finish_lanes(procs: dict, workdir: str) -> dict:
    """Waits for every lane up to LANE_DEADLINE; relays each one's phase
    lines and error output, in LANES' order; fails if one failed or ran
    out of time. Returns the lanes' numbers, merged."""
    out = {}
    for lane, proc in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, _T0 + LANE_DEADLINE
                                       - time.time()))
        except subprocess.TimeoutExpired:
            rc = None
        err = _relay(workdir, lane)
        if rc != 0:
            raise AssertionError(
                f"lane {lane} ({', '.join(LANES[lane])}) "
                + ("ran past its deadline" if rc is None else f"exited {rc}")
                + f": {err[-3000:]}")
        with open(os.path.join(workdir, f"{lane}.json")) as fh:
            out.update(json.load(fh))
    return out


def stop_lanes(procs: dict, workdir: str) -> None:
    """Ends every lane's session (the lane and what it started) and relays
    what a lane not yet relayed had written."""
    import signal
    for lane, proc in procs.items():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        _relay(workdir, lane)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--valid-rows", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--parent", default=None,
                    help="another checkout of this repository (e.g. the "
                         "parent commit from git archive): its kernels are "
                         "timed on the same inputs before and after this "
                         "run's phases")
    ap.add_argument("--only", choices=("precision", "control", "predict",
                                       "faults", "distributed",
                                       "resilience", "redesign", "serve"),
                    default=None,
                    help="run the device, build and train phases and this "
                         "group's phases alone (a quicker check of one "
                         "group; without it every phase runs)")
    # the faults group's child processes (see child_main)
    ap.add_argument("--child", choices=("resume", "oom", "dist", "lane"),
                    default=None, help=argparse.SUPPRESS)
    # a lane of the full run (see lane_main)
    ap.add_argument("--lane", choices=tuple(LANES), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    # the distributed group's ranks (see dist_child_main)
    for flag, kind in (("--rank", int), ("--world", int), ("--port", int)):
        ap.add_argument(flag, type=kind, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--nccl", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parity", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    if args.child == "dist":
        return dist_child_main(args)
    if args.child == "lane":
        return lane_main(args)
    if args.child:
        return child_main(args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import cuda_hist, rank  # noqa: F401 (counts)
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
    if args.only == "precision":
        tr, launches = train_phase(lgb, cuda_hist, args)
        emit("train", **tr)
        prec = precision_phases(lgb, cuda_hist, args, tr["valid_auc"])
        print(json.dumps({"kernels": [dp_kernel_entry(prec)],
                          "total_seconds": time.time() - t_start}),
              flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "control":
        tr, launches = train_phase(lgb, cuda_hist, args)
        emit("train", **tr)
        control = control_phases(lgb, cuda_hist, args, tr)
        print(json.dumps({"launches_by_path": {
            k: fused_launches(c) for k, c in control.items()},
            "total_seconds": time.time() - t_start}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "faults":
        tr, launches = train_phase(lgb, cuda_hist, args)
        emit("train", **tr)
        fpaths, po_launches = faults_phases(lgb, cuda_hist, args)
        print(json.dumps({"launches_by_path": {
            k: {n: v for n, v in c.items() if v} for k, c in fpaths.items()},
            "predict_oom_predict_ensemble_launches": po_launches,
            "total_seconds": time.time() - t_start}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "distributed":
        hp, dpaths = distributed_phases(lgb, cuda_hist, args)
        print(json.dumps({"kernels": dist_kernel_entries(hp, dpaths),
                          "launches_by_path": dpaths,
                          "total_seconds": time.time() - t_start}),
              flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "resilience":
        t0 = time.time()
        hp = hist_int_planes_phase(cuda_hist, args)
        emit("hist_int_planes", seconds=time.time() - t0, **hp)
        rpaths = resilience_phases(lgb, cuda_hist, args)
        print(json.dumps({"kernels": dist_kernel_entries(
            hp, rpaths, lead="resilience/data/reference"),
            "launches_by_path": rpaths,
            "total_seconds": time.time() - t_start}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "redesign":
        kernels = redesign_group(lgb, cuda_hist, args)
        print(json.dumps({"kernels": kernels,
                          "total_seconds": time.time() - t_start}),
              flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "serve":
        serve = serve_phases(lgb, cuda_hist, args)
        print(json.dumps({"kernels": [serve_entry(serve)],
                          "launches_by_path": {
                              "telemetry": {k: v for k, v in
                                            serve["telemetry_launches"]
                                            .items() if v}},
                          "total_seconds": time.time() - t_start}),
              flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "predict":
        tr, launches = train_phase(lgb, cuda_hist, args)
        emit("train", **tr)
        entry = predict_phases(lgb, cuda_hist, args)
        print(json.dumps({"kernels": [entry],
                          "total_seconds": time.time() - t_start}),
              flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    parent, own = [], []
    if args.parent:
        parent.append(parent_times(args.parent, n, args.valid_rows,
                                   args.seed))
        emit("parent_times", dir=args.parent, ms=parent[-1])
        own.append(redesign_probes(cuda_hist, args.seed, WIDE_PASS))
        emit("probe_times", ms=own[-1])
    kp = kernel_phases(cuda_hist, n, args.valid_rows, args.seed)
    emit("hist_tile_root", n=n, b=B, p=P, leaves=LEAVES,
         **{k: kp[k] for k in ("full_root", "plane_root", "q8_full_root",
                               "q8_plane_root")})
    full, rungs, stress = kp["full"], kp["rungs"], kp["stress"]
    emit("hist_tile", n=n, f=F, b=B, p=P, leaves=LEAVES, **full)
    emit("hist_tile_gather", n=n, f=F, b=B, p=P, leaves=LEAVES, rungs=rungs)
    emit("hist_tile_stress", n=n, f=F, b=B, p=P, leaves=LEAVES, **stress)
    plane_full, plane_rungs = kp["plane_full"], kp["plane_rungs"]
    emit("hist_plane", n=n, f=F_CAT, b=B, p=P, leaves=LEAVES, **plane_full,
         rungs=plane_rungs)
    q8_full, q8_rungs = kp["q8_full"], kp["q8_rungs"]
    q8_plane, q8_plane_rungs = kp["q8_plane"], kp["q8_plane_rungs"]
    emit("hist_tile_q8", n=n, b=B, p=P, leaves=LEAVES,
         full={"f": F, **q8_full}, rungs=q8_rungs,
         plane={"f": F_CAT, **q8_plane}, plane_rungs=q8_plane_rungs)
    epi = epilogue_phase(cuda_hist)
    emit("split_epilogue", p=P, f=F, b=B, **epi)
    hw = hist_wide_phase(cuda_hist, n, args.seed)
    emit("hist_wide", n=n, f=F, p=P, leaves=LEAVES, **hw)
    ew = epilogue_wide_phase(cuda_hist, args.seed)
    emit("epilogue_wide", p=P, f=F, **ew)
    hv = hist_variants_phase(cuda_hist)
    emit("hist_variants", **hv)

    # the lanes start once the kernel phases above have the card alone
    import shutil
    import tempfile
    lane_dir = tempfile.mkdtemp(prefix="chip_lanes_")
    lanes = start_lanes(args, lane_dir)
    try:
        tr, launches = train_phase(lgb, cuda_hist, args)
        emit("train", **tr)
        emit("parity", **same_as_parent(parity_phase(lgb, args.seed),
                                        "parity", parent))

        tc, cat_launches = train_cat_phase(lgb, cuda_hist, args)
        emit("train_cat", **tc)
        emit("parity_cat", **parity_cat_phase(lgb, args.seed))
        emit("parity_sparse", **same_as_parent(
            parity_sparse_phase(lgb, args.seed), "parity_sparse", parent))

        epi_q8 = epilogue_q8_phase(cuda_hist)
        emit("split_epilogue_q8", p=P, f=F, b=B, **epi_q8)
        tq, q8_launches = train_phase(lgb, cuda_hist, args,
                                      q8_ref_auc=tr["valid_auc"])
        emit("train_q8", **tq)
        write_lane_ref(lane_dir, {
            "train": {"sec_per_iter": tr["sec_per_iter"],
                      "valid_auc": tr["valid_auc"]},
            "train_q8": {"valid_auc": tq["valid_auc"]}})
        tqc, q8_cat_launches = train_cat_phase(lgb, cuda_hist, args,
                                               q8_ref_auc=tc["valid_auc"])
        emit("train_q8_cat", **tqc)
        emit("parity_q8", **same_as_parent(parity_q8_phase(lgb, args.seed),
                                           "parity_q8", parent))
        emit("parity_q8_cat", **same_as_parent(
            parity_q8_cat_phase(lgb, args.seed), "parity_q8_cat", parent))

        tm, mc_launches = train_multiclass_phase(lgb, cuda_hist, args)
        emit("train_multiclass", **tm)
        tmcq, mcq_launches = train_multiclass_phase(
            lgb, cuda_hist, args, q8_ref_error=tm["valid_multi_error"])
        emit("train_q8_multiclass", **tmcq)
        emit("parity_multiclass", **parity_multiclass_phase(lgb, args.seed))
        ts = train_sampling_phase(lgb, cuda_hist, args,
                                  tr["rows_streamed_per_tree"])
        emit("train_sampling", **ts)
        emit("parity_sampling", **parity_sampling_phase(lgb, args.seed))

        twd, wide_launches = train_wide_phase(lgb, cuda_hist, args,
                                              tr["valid_auc"])
        emit("train_wide", **twd)
        twq, wideq_launches = train_wide_phase(lgb, cuda_hist, args,
                                               twd["valid_auc"], q8=True)
        emit("train_wide_q8", **twq)
        twc, widec_launches = train_wide_phase(lgb, cuda_hist, args, None,
                                               classic=True)
        twcq, widecq_launches = train_wide_phase(lgb, cuda_hist, args, None,
                                                 q8=True, classic=True)
        emit("train_wide_classic", f32=twc, q8=twcq)
        emit("train_efb", **train_efb_phase(lgb, cuda_hist, args))
        emit("train_forced_cegb", **train_forced_cegb_phase(lgb, cuda_hist,
                                                            args))
        pdata = parity_data_phase(lgb, args.seed)
        emit("parity_data", **pdata)
        prec = precision_phases(lgb, cuda_hist, args, tr["valid_auc"])
        lane = finish_lanes(lanes, lane_dir)
    finally:
        stop_lanes(lanes, lane_dir)
        shutil.rmtree(lane_dir, ignore_errors=True)
    rk, rank_launches = lane["rk"], lane["rank_launches"]
    xe_launches, epm = lane["xe_launches"], lane["epm"]
    mono_launches, monoq_launches = (lane["mono_launches"],
                                     lane["monoq_launches"])
    control, fpaths, pentry = lane["control"], lane["fpaths"], lane["pentry"]
    pentry["launches_by_path"]["faults/predict_oom"] = lane["po_launches"]
    # the serving path (the gangs lane's serve group): the kernel at serve
    # sizes, its launches a flush
    pentry["serve_sizes"] = serve_sizes_numbers(lane["serve"]["serve_sizes"])
    pentry["launches_by_path"].update(lane["serve"]["serve_paths"])
    dist_hp, dpaths, rpaths = lane["dist_hp"], lane["dpaths"], lane["rpaths"]

    if args.parent:
        own.append(redesign_probes(cuda_hist, args.seed, WIDE_PASS))
        emit("probe_times", ms=own[-1])
        parent.append(parent_times(args.parent, n, args.valid_rows,
                                   args.seed))
        emit("parent_times", dir=args.parent, ms=parent[-1])
        same_wide_texts({k: pdata[k]["card_text_sha256"]
                         for k in WIDE_TEXTS}, parent)

    hist_err = max([full["max_abs_err"]]
                   + [r["max_abs_err"] for r in rungs.values()]
                   + [r["max_abs_err"] for r in stress["f32"].values()]
                   + [r["max_abs_err"] for r in kp["full_root"].values()])
    plane_err = max([plane_full["max_abs_err"]]
                    + [r["max_abs_err"] for r in plane_rungs.values()]
                    + [r["max_abs_err"] for r in kp["plane_root"].values()])
    kernels = [
        {"name": "hist_tile", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:497 _fused_epi_kernel "
                     "+ :527 _gather_epi_kernel (accumulation)",
         "launches": launches["hist_tile.launches"], "max_abs_err": hist_err,
         **_full_numbers(kp["full_root"], "higgs", full),
         "gather_launches": launches["hist_tile.gather_launches"],
         "gather_ms": {k: v["ms"] for k, v in rungs.items()},
         "gather_ms_computing_amax": {k: v["ms_computing_amax"]
                                      for k, v in rungs.items()},
         "gather_bound_ms": {k: v["bound_ms"] for k, v in rungs.items()},
         "gather_library_ms": {k: v["library_ms"] for k, v in rungs.items()},
         "stress_ms": {k: v["ms"] for k, v in stress["f32"].items()},
         "stress_library_ms": {k: v["library_ms"]
                               for k, v in stress["f32"].items()}},
        {"name": "hist_tile (plane-only)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:154 _fused_kernel "
                     "(pallas_call :270) + :205 _gather_kernel "
                     "(pallas_call :324)",
         "launches": cat_launches["hist_tile.launches_plane"],
         "max_abs_err": plane_err,
         **_full_numbers(kp["plane_root"], "expo", plane_full),
         "gather_launches": cat_launches["hist_tile.gather_launches"],
         "gather_ms": {k: v["ms"] for k, v in plane_rungs.items()},
         "gather_ms_computing_amax": {k: v["ms_computing_amax"]
                                      for k, v in plane_rungs.items()},
         "gather_bound_ms": {k: v["bound_ms"]
                             for k, v in plane_rungs.items()},
         "gather_library_ms": {k: v["library_ms"]
                               for k, v in plane_rungs.items()}},
        {"name": "split_epilogue", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_epilogue.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:465 _epilogue_compute "
                     "(epilogue of :497 and :527)",
         "launches": launches["split_epilogue.launches"],
         "max_abs_err": epi["max_abs_err"], "ms": epi["ms"],
         "device_ms": epi["device_ms"],
         "train_device_ms_per_launch": per_launch(tr["profile"],
                                                  "split_epilogue"),
         "plain_ms": epi["plain_ms"], "bound_ms": epi["bound_ms"],
         "bound_by": epi["bound_by"], "library_ms": None},
        {"name": "hist_tile (q8)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:497 _fused_epi_kernel "
                     "(pallas_call :588) + :527 _gather_epi_kernel "
                     "(pallas_call :663), mode q8 (accumulation)",
         "launches": q8_launches["hist_tile.launches_q8"],
         "max_abs_err": max([q8_full["max_abs_err"]]
                            + [r["max_abs_err"] for r in q8_rungs.values()]
                            + [r["max_abs_err"]
                               for r in stress["q8"].values()]
                            + [r["max_abs_err"]
                               for r in kp["q8_full_root"].values()]),
         **_full_numbers(kp["q8_full_root"], "higgs", q8_full),
         "gather_launches": q8_launches["hist_tile.gather_launches_q8"],
         "gather_ms": {k: v["ms"] for k, v in q8_rungs.items()},
         "gather_bound_ms": {k: v["bound_ms"] for k, v in q8_rungs.items()},
         "gather_library_ms": {k: v["library_ms"]
                               for k, v in q8_rungs.items()},
         "stress_ms": {k: v["ms"] for k, v in stress["q8"].items()},
         "stress_library_ms": {k: v["library_ms"]
                               for k, v in stress["q8"].items()}},
        {"name": "hist_tile (plane-only, q8)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:154 _fused_kernel "
                     "(pallas_call :270) + :205 _gather_kernel "
                     "(pallas_call :324), mode q8",
         "launches": q8_cat_launches["hist_tile.launches_plane_q8"],
         "max_abs_err": max([q8_plane["max_abs_err"]]
                            + [r["max_abs_err"]
                               for r in q8_plane_rungs.values()]
                            + [r["max_abs_err"]
                               for r in kp["q8_plane_root"].values()]),
         **_full_numbers(kp["q8_plane_root"], "expo", q8_plane),
         "gather_launches": q8_cat_launches["hist_tile.gather_launches_q8"],
         "gather_ms": {k: v["ms"] for k, v in q8_plane_rungs.items()},
         "gather_bound_ms": {k: v["bound_ms"]
                             for k, v in q8_plane_rungs.items()},
         "gather_library_ms": {k: v["library_ms"]
                               for k, v in q8_plane_rungs.items()}},
        {"name": "split_epilogue (q8)", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_epilogue.cu",
         "replaces": "lightgbm_tpu/ops/pallas_hist.py:465 _epilogue_compute "
                     "mode q8 (dequant + epilogue of :497 and :527)",
         "launches": q8_launches["split_epilogue.launches_q8"],
         "max_abs_err": epi_q8["max_abs_err"], "ms": epi_q8["ms"],
         "device_ms": epi_q8["device_ms"],
         "train_device_ms_per_launch": per_launch(tq["profile"],
                                                  "split_epilogue"),
         "plain_ms": epi_q8["plain_ms"], "bound_ms": epi_q8["bound_ms"],
         "bound_by": epi_q8["bound_by"], "library_ms": None},
        {"name": "hist_onehot", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/hist_onehot.cu",
         "replaces": "scripts/exp_hist_variants.py:22 kernel in make_variant "
                     "(pallas_call :44)",
         "launches": hv["launches"], "max_abs_err": hv["max_abs_err"],
         "max_rel_err": hv["max_rel_err"], "ms": hv["ms"],
         "device_ms": hv["variants"][hv["best"]]["device_ms"],
         "variant": hv["best"],
         "variant_ms": {k: v["ms"] for k, v in hv["variants"].items()},
         "variant_device_ms": {k: v["device_ms"]
                               for k, v in hv["variants"].items()},
         "plain_ms": hv["plain_ms"], "bound_ms": hv["bound_ms"],
         "bound_by": hv["bound_by"], "library_ms": hv["library_ms"],
         "onehot_floor_ms": hv["onehot_floor_ms"]},
        rank_entry(rk, rank_launches),
    ]
    # the epilogue's monotone mode: the kernels line's own numbers at the
    # main path's width (F = 28), F = 136 beside them
    for q8, launched in ((False, mono_launches), (True, monoq_launches)):
        sfx = "_q8" if q8 else ""
        main_f, wide = epm[f"f{F}{sfx}"], epm[f"f{MSLR_FEATURES}{sfx}"]
        kernels.append({
            "name": "split_epilogue_mono" + (" (q8)" if q8 else ""),
            "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/split_epilogue.cu",
            "replaces": "lightgbm_tpu/ops/pallas_hist.py:465 "
                        "_epilogue_compute with_monotone=True"
                        + (", mode q8" if q8 else "")
                        + " (epilogue of :497 and :527)",
            "launches": launched["split_epilogue.launches_mono" + sfx],
            "max_abs_err": max(main_f["max_abs_err"], wide["max_abs_err"]),
            **{k: main_f[k] for k in ("ms", "device_ms", "free_ms",
                                      "free_device_ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")},
            "train_device_ms_per_launch": per_launch(
                lane["monoq_profile" if q8 else "mono_profile"],
                "split_epilogue"),
            "f136": {k: wide[k] for k in ("ms", "device_ms", "free_ms",
                                          "free_device_ms", "plain_ms",
                                          "bound_ms")},
            "launches_by_path": {("train_mono_q8" if q8 else "train_mono"):
                                 launched["split_epilogue.launches_mono"
                                          + sfx]}})
    # the wide modes (max_bin above 255): each entry's own numbers at
    # B = 1023 (hist_tile: the root pass; the epilogue: P=42, F=28), B =
    # 4095 and the uint8 mode on rows drawn the same way beside them
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def nums(res):
        return {k: res[k] for k in keys}

    for q8, fused, classic, prof in (
            (False, wide_launches, widec_launches, twd["profile"]),
            (True, wideq_launches, widecq_launches, twq["profile"])):
        mode, tag = ("q8", ", q8") if q8 else ("f32", "")
        sfx = "_wide" + ("_q8" if q8 else "")
        h = hw[mode]
        rung = f"rung_{ladder_rungs(n)[-1]}"
        kernels.append({
            "name": f"hist_tile (wide{tag})", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
            "replaces": "lightgbm_tpu/ops/pallas_hist.py:497 "
                        "_fused_epi_kernel + :527 _gather_epi_kernel at "
                        "num_bins > 256, bins cast at :143 (accumulation)"
                        + (", mode q8" if q8 else ""),
            "launches": fused["hist_tile.launches" + sfx],
            "max_abs_err": max(r["max_abs_err"] for g in ("b1023", "b4095")
                               for r in h[g].values()),
            **nums(h["b1023"]["root"]),
            "multi_slot": nums(h["b1023"]["full"]),
            "gather_launches": fused["hist_tile.gather_launches" + sfx],
            "gather": {k: nums(v) for k, v in h["b1023"].items()
                       if k.startswith("rung_")},
            "b4095": {k: nums(v) for k, v in h["b4095"].items()},
            "uint8_same_rows": {k: nums(v) for k, v in h["b255"].items()},
            "launches_by_path": {("train_wide_q8" if q8 else "train_wide"):
                                 fused["hist_tile.launches" + sfx]}})
        kernels.append({
            "name": f"hist_tile (plane-only, wide{tag})", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/hist_tile.cu",
            "replaces": "lightgbm_tpu/ops/pallas_hist.py:154 _fused_kernel "
                        "(pallas_call :270) + :205 _gather_kernel "
                        "(pallas_call :324) at num_bins > 256"
                        + (", mode q8" if q8 else ""),
            "launches": classic["hist_tile.launches_plane" + sfx],
            "max_abs_err": max(r["max_abs_err"]
                               for r in h["plane_b1023"].values()),
            **nums(h["plane_b1023"]["full"]),
            "gather_launches": classic["hist_tile.gather_launches" + sfx],
            "gather": {rung: nums(h["plane_b1023"][rung])},
            "launches_by_path": {("train_wide_classic/q8" if q8 else
                                  "train_wide_classic/f32"):
                                 classic["hist_tile.launches_plane" + sfx]}})
        mono_run = "wide_mono" + ("_q8" if q8 else "")
        kernels += epilogue_wide_entries(ew, q8, fused, prof,
                                         pdata[mono_run]["launches"],
                                         f"parity_data/{mono_run}")
    # the f64 mode of the plane-only forms (gpu_use_dp)
    kernels.append(dp_kernel_entry(prec))
    # each kernel's launches on every path that launched it, each path's
    # counts read from 0 around its own run
    paths = {"train": launches, "train_cat": cat_launches,
             "train_q8": q8_launches, "train_q8_cat": q8_cat_launches,
             "train_multiclass": mc_launches,
             "train_q8_multiclass": mcq_launches,
             "train_rank": rank_launches, "train_rank_xendcg": xe_launches,
             "train_mono": mono_launches, "train_mono_q8": monoq_launches,
             "train_linear": prec["linear_launches"],
             **{f"train_sampling/{k}": v["launches"]
                for k, v in ts["runs"].items()},
             "telemetry": lane["serve"]["telemetry_launches"],
             **control, **fpaths}
    for entry, count in zip(kernels[:6], (
            lambda c: c["hist_tile.launches"] - c["hist_tile.launches_plane"],
            lambda c: c["hist_tile.launches_plane"],
            lambda c: c["split_epilogue.launches"],
            lambda c: c["hist_tile.launches_q8"]
            - c["hist_tile.launches_plane_q8"],
            lambda c: c["hist_tile.launches_plane_q8"],
            lambda c: c["split_epilogue.launches_q8"])):
        entry["launches_by_path"] = {k: count(c) for k, c in paths.items()
                                     if count(c) > 0}
    kernels[6]["launches_by_path"] = {"hist_variants": hv["launches"]}
    kernels[7]["launches_by_path"] = {
        k: c["lambdarank_grads.launches"] for k, c in paths.items()
        if c["lambdarank_grads.launches"] > 0}
    # device time (torch.profiler) beside the events' time of each form
    # ("root/<bins>": the root pass, "full": the several-slot full form);
    # with --parent, the other design's [event ms, device ms] from the
    # probes before and after this run's phases, as a list per form
    times = _times(kp)
    for entry, root_key, full_key, rung_key, stress_key in (
            (kernels[0], "full_root", "full", "rungs", "stress_f32"),
            (kernels[1], "plane_root", "plane_full", "plane_rungs", None),
            (kernels[3], "q8_full_root", "q8_full", "q8_rungs", "stress_q8"),
            (kernels[4], "q8_plane_root", "q8_plane", "q8_plane_rungs",
             None)):
        keys = {f"root/{k}": f"{root_key}/{k}" for k in kp[root_key]}
        keys["full"] = full_key
        keys.update({m: f"{rung_key}/{m}" for m in entry["gather_ms"]})
        if stress_key:
            keys.update({k: f"{stress_key}/{k}" for k in STRESS})
        entry["device_ms"] = {k: times[v][1] for k, v in keys.items()}
        if parent:
            entry["parent_ms"] = {k: [pt[v] for pt in parent]
                                  for k, v in keys.items()}
    if parent:
        kernels[2]["parent_ms"] = [pt["split_epilogue"] for pt in parent]
        kernels[5]["parent_ms"] = [pt["split_epilogue_q8"] for pt in parent]
        kernels[6]["parent_ms"] = {v: [pt[f"hist_onehot/{v}"]
                                       for pt in parent] for v in VARIANTS}
    kernels.append(pentry)
    if args.parent:
        by_name = {k["name"]: k for k in kernels}
        attach_probes([(by_name[f"split_epilogue{m} (wide{t})"], (q8, mono))
                       for q8, t in ((False, ""), (True, ", q8"))
                       for mono, m in ((False, ""), (True, "_mono"))],
                      own, parent)
    kernels.extend(dist_kernel_entries(dist_hp, {**dpaths, **rpaths},
                                       lead="distributed/data/rank0"))
    print(json.dumps({"kernels": kernels,
                      "total_seconds": time.time() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
