#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and probe paths on one
NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--timing-reps 20]

Every phase prints one JSON line (the probes phase first prints the
probes' own lines) and a ``phase_wall`` line with its wall seconds (also
on stderr); any failure raises and exits non-zero.  ``examples``,
``estimators``, ``boundary``, ``sparse``, ``capi`` and ``loader`` need none
of the other phases' datasets or models: they run in order in a second process
(``--side``, SIDE_PHASES) started after ``memory`` and joined before
``telemetry``, beside ``distributed``, ``resilience``, ``objectives``,
``sampling`` and ``engine``; their lines are printed at the join, and
their round times are taken beside that load.

1. ``build``: nvcc builds every kernel under ``lightgbm_tpu_torch/csrc/``
   for ``sm_90a`` (one nvcc per source, all started together); every
   instantiation of P2's kernel must show a 0-byte stack frame in the
   ``-Xptxas -v`` report.
2. ``kernels``: each kernel's wrapper on tensors on the card, held
   against its plain PyTorch version on the same inputs.  Forest walks
   (bit-equal, ``torch.equal``: both fold the same f32 per-tree values in
   one Kahan order): a small binary forest (3 categorical and 5 numeric
   features, 10% NaN, f32-colliding cut values, 31 leaves, 20 trees), a
   multiclass forest with a ragged number of trees per class, and the
   Higgs forest below at the bucket sizes its serving run uses; then
   every variant on the walk's edge cases (``walk_edges``: one tree, 37
   trees, which the plan's chunk does not divide, and a chain tree 254
   levels deep, each frozen with f32 and bf16, constant and linear
   leaves) at B = 1, one tile - 1, one tile + 1 and 4096 rows.  The leaf
   histogram K1 (exact int32 sums, so bit-equal, ``torch.equal``): uint8
   and uint16 bins, F in {5, 28, 30, 136}, windows of S in {0, 1, 4097,
   65536, 1000000} rows at a row offset,
   on the wrapper's choice of path and on each of its two paths forced;
   and at every window class of the train phase (2^10 to 2^20 rows) on
   both paths.
   The children histograms K2 and the fused split candidates K3 (f32
   atomics: the tolerances of ``ops/children_hist.py``): uint8 with 255
   bins and uint16 with 1000, F in {5, 28, 30}, N in the same sizes, a
   third of the rows in each child and a third elsewhere, plus the root
   forms at 1M rows and the 1M-row full pass with 2^14, 2^17, 2^19 and
   all rows in the two children; K3's features and
   thresholds equal except at reported near-ties.  Each call adds exactly
   one to its launch counter.
   The linear and bf16 variants of the walk (``linear_forest``): the
   Higgs forest below made piece-wise linear (its own random trees, one
   feature categorical; every leaf of ~90% of the trees gets 5 affine
   slots from its own path features, the categorical one included,
   N(0, 0.01) coefficients, ~10% of the slots -1 pads) with uint16 bins,
   the same at 250 cut values (uint8 bins), and a linear multiclass
   forest with a ragged tail, all on rows with 5% NaN; the linear walks
   bit-equal to their plain versions (both sum the slots in ascending
   order with one rounding per product and per add).  The bf16 variants,
   on the Higgs forests with leaf values scaled by 1e-2
   (``serve_quantize_leaves`` keeps bf16 for them), bit-equal to the
   plain walk on the dequantized table.
   The probe kernels (``compare_probes``): the roll chain P1 bit-equal
   to its plain version on the probe's seeded [12, 2048] input, two
   more seeds and four blocks of adversarial keys (all equal, only
   INT_MIN and INT_MAX, sorted either way), and after the probe's
   50-call ``^ 1`` chain; the device-windowed digit histogram P2 on the
   probe's 2^20 rows bit-equal to its plain version and to K1 on the
   same window, for both digit layouts (packed words, [N, 9] matrix), on
   the probe's window (5, N/2), an empty one, one row, one ending at N,
   one whose offset is not a multiple of any TPU nb and one clamped past
   N (bin 255 present); a profiled P2 call records its one kernel and no
   other device work (no memset, no fill; a profile that records nothing
   fails); then the probe's 10-call loop for each of its five runs, each
   offset computed on the card from the last output, under
   ``torch.cuda.set_sync_debug_mode("error")``, against a plain replay.
   Codes past ``max_bin`` (``compare_wide_codes``): K1, K2, K3 and P2
   bit-equal (K2 and K3 within their tolerances) to their plain versions
   where one column's codes reach ``max_bin + 38`` (the column first,
   then last; a 294-bin categorical column in K3), at 1M x 28 uint16
   with 255 bins, and P2 on the probe's rows at max_bin 200; each wide
   column's K1 sums are its in-range rows' (the codes are dropped).
3. ``serve``: the serving path at full width.  A Higgs-sized forest
   (binary, 28 features, 500 trees, 255 leaves, 255 cut values per
   feature: LightGBM's published Higgs experiment settings) is written
   from ``--seed`` in the LightGBM text format, loaded by
   ``serve_from_config`` on port 0, and asked by four client threads for
   1, 64 and 4096 rows each, then one client for five 1-row requests
   in a row.  Every response is held against the plain
   version on the card (same f32 binning, <= 1e-6); ``Booster.predict``
   (host f64 binning, then the binned kernel) is held against the f64
   host walk ``Tree.predict`` (raw <= 1e-5).  The launch counters are set
   to 0 just before this phase and read just after it.
   ``serve_linear``: the linear Higgs forest served the same way
   (``serve_nonfinite_policy=propagate``, 2% NaN in the rows; responses
   against the plain linear walk, ``/healthz`` reports ``linear``),
   ``Booster.predict`` (the binned linear kernel) against the f64 host
   walk with its affine part, then ``serve_from_config`` with
   ``serve_quantize_leaves=true`` three times: the two scaled forests
   (constant and linear) must freeze to bfloat16 and predict through
   both paths within QUANTIZE_LEAF_ATOL + 1e-5 of the f64 host walk;
   the linear Higgs forest itself, whose summed bf16 error is far over
   the pin, must stay float32 with one ``forest_quantize_fallback``.
   Counters set to 0 before and read after; every linear and bf16
   variant must have launched.
   ``fleet``: the serving fleet over K4, the Higgs forest with a
   training fingerprint (``fingerprinted``: 50k rows of its own grid)
   and a second Higgs forest from ``--seed + 1``, both through
   ``serve_from_config`` on port 0 with a canary slot at 0.25,
   ``lifecycle_window_s=3``, ``lifecycle_min_samples=50``,
   ``serve_shadow=0.5``, ``drift=on`` and a state file.  Four clients
   send 1, 64 and 4096 rows while ``POST /reload`` swaps the second
   forest in: no request fails, each response equals the plain walk of
   the generation it names (<= 1e-6), the old generation's batchers
   close; the reload's build, warm, swap and drain seconds and the p99
   of the requests in flight across it.  The first forest as the canary:
   every fourth request while it is live is the canary's,
   ``/metrics`` parsed by ``prom.parse_text`` carries its
   ``serve_latency_seconds{model="canary"}``, and the controller
   promotes it.  The second as the canary again, skewed by
   ``skew_predictions`` and fed labels through ``/feedback``: rolled back
   for its quality, no request failed, shadow batches counted.  Drift:
   2048 rows of the training distribution, then 2048 with one feature
   shifted 3 sigma: each window's PSI per feature equal to a host
   recomputation over the rows sent, the shifted feature first.  A
   restart with the state file serves the promoted forest, not
   ``input_model``.  ``serve_queue_depth=2`` under ``slow_replica``: 429
   with ``Retry-After``, the admitted p99 bounded.  ``wedge_replica`` on
   the lone replica: ejected, 503 at once, re-admitted on probation by
   the probe, healthy after three clean requests.  ``serve_walk=gather``
   against K4's answers, both timed at B = 1, 256 and 4096.  K4 launches
   counted over the phase.  Every server above warms in the background
   as ``task=serve`` does, and is sent traffic once ready.  The
   background warm itself (``fleet_background_warm``): the Higgs forest
   frozen by ``Booster.compile``; K4's library built anew into an empty
   directory for each of two modes: the order before (the fleet warmed,
   then bound) and ``warm_in_background=True``, each timed from start to
   the first ``/healthz`` 200.  In the background mode, with the warm held
   on an event, ``/healthz`` answers ``ready: false`` and ``/readyz`` and
   ``/predict`` 503 ``warming`` and K4 has not launched; released, the
   warm (the build and the buckets, timed) launches K4 binned and raw
   once a bucket (2 x 9), then ``/predict`` equals ``Booster.predict`` on
   the same f32-exact rows (TOL).  A second server stopped while its warm
   is held in the first bucket exits cleanly after that bucket's two
   launches.
4. ``train``: the training path at full width: the bench operating point
   (binary, ``make_higgs_like(1000000)`` from ``--seed``, 28 features,
   ``num_leaves=63``, ``max_bin=255``, ``learning_rate=0.1``,
   ``min_data_in_leaf=50``), 10 rounds of ``lightgbm_tpu_torch.train``
   with a 100k-row valid set, once per grower on the same datasets: the
   default ``ordered``, ``serial_grow=cached``, ``serial_grow=fused`` and
   ``histogram_pool_size=1 memory_policy=degrade`` (the nocache grower).
   The launch counters are set to 0 just before each run and read just
   after.  Checks (``train_run``): (a) the run's histogram kernel
   launches equal Σ over trees of 1 + splits (ordered) or rounds ×
   num_leaves (the fixed-trip growers), and no other histogram kernel
   ran; (b) the first two trees re-grown on the card through the plain
   versions from the same gradients: bit-identical for ordered and
   cached, structure-equal up to a reported f32 near-tie for fused and
   nocache; (c) ``Booster.predict(raw_score=True)`` of the saved model
   on 4096 train rows equals the training score buffer to 1e-5; (d)
   train and valid AUC finite, above 0.5 and rising, and every grower's
   final valid AUC within 1e-3 of the ordered run's; (e) the cached trees
   structure-equal to the ordered ones, values within 1e-6 relative.
   One more round per grower, outside the counted run, splits the
   round's time into the histogram kernel, the split scan (and the
   ordered grower's partition) and the rest with CUDA events.  The
   datasets keep raw values, and a fifth run trains ``linear_tree=true``
   (``linear_max_leaf_features=5``, ``linear_lambda=0.01``, the ordered
   grower): its launches as ordered's, tree 1 and 2 re-grown (from the
   run's own scores) and re-fit through the plain versions
   structure-equal, the saved model against
   the score buffer (1e-5) and against the f64 host walk with its affine
   part (1e-5), AUC rising, and the fit's share of a round.  Every run
   also counts its histogram kernel's launches by the power-of-two
   class of the rows each scans (``train_windows``: printed only).
   The model layer's own loop (``train_model_layer``): ``create_boosting``
   + ``add_valid_dataset`` + ``GBDT.train(3)`` on the same datasets with
   the ordered grower, its model text byte-equal to ``lt.train``'s for the
   same parameters and rounds, K1 launched once a leaf; then
   ``save_model_to_file``, the file loaded by a Booster and the valid rows
   predicted through K4 within 1e-5 of ``GBDT.predict``.
   ``train_delta``: the ordered run's model continued 5 rounds on
   100k fresh rows with feature 0 shifted 2 sigma: one skew warning
   counted, the fresh fingerprint carried, K1 launched.
   ``memory``: the device-memory gate on the train phase's datasets.
   For each grower (ordered, cached, fused, nocache) the gate's estimate
   beside the peak ``torch.cuda.max_memory_allocated`` measures over its
   construction and 3 rounds (the estimate bounds the peak, within 64x of
   it); the card's budget as ``_device_memory_limit`` reads it beside
   ``nvidia-smi``'s memory total; a ``LGBT_DEVICE_MEMORY_BYTES`` override
   below the estimate refused with ``MemoryBudgetExceeded`` before
   anything is allocated (``memory_allocated`` unchanged); a budget
   between the no-cache floor and the full estimate taking ``hist_cache``
   and training the nocache run's trees; a real CUDA OOM: a ballast
   tensor leaves the card nearly full, an override admits the run, and
   one round raises ``DeviceOOM`` naming its unit, its shapes, the
   admission table and a memwatch line; once the ballast is freed the
   same booster trains on; a valid set over the budget refused with the
   JAX package's message.
   ``distributed``: ``tools/probe_gloo.py`` (which gloo collectives take
   CUDA tensors) held against ``parallel/comm.py``'s rule; then two OS
   processes on the one card (``chip_smoke.py --dist-rank``), each a
   rank of a gloo group from a machine list of two localhost ports,
   each building the Higgs cell (1M x 28, 63 leaves, 255 bins) from the
   seed and training 3 rounds of data (``reduce_scatter``, then
   ``psum``), feature and voting (``top_k`` 20, then 28) through
   ``Booster.update``: both ranks' model texts byte-equal; data, feature
   and voting at ``top_k`` 28 the nocache serial grower's trees on the
   card (up to a near-tie; values within 1e-3 of a field's largest);
   voting at ``top_k`` 20 within 1e-3 of its valid AUC; K2 on one rank's
   row shard bit-equal to its plain version added in f64 and rounded
   once.  Per learner: seconds a round beside the serial run's,
   collective ms a round (host clock, the card synchronized before each
   collective), K2 launches a rank, collective bytes a tree (equal to
   ``traffic_per_tree``).
   Then ``examples/parallel_learning/train.conf`` through the CLI as
   written but for its 100 trees (in the script's process: it warns and
   trains serial) and as two CLI processes with ``num_machines=2`` and a
   machine list, 5 trees each,
   byte-equal models.  A rank that fails or outlives its timeout fails
   the phase; every rank's process group is killed at the end.
   ``resilience``: crash-safe training.  (a) On the train phase's
   datasets, the ordered grower (K1) 8 rounds uninterrupted, then with a
   snapshot every 2 rounds and an ``InjectedCrash`` after round 5; the
   newest snapshot (round 4) torn by ``truncate_file``; the rerun must
   skip it by name, resume from round 2 and end with the uninterrupted
   run's model text and training score buffer, bit for bit, K1 launched
   once per leaf of the resumed trees.  Each snapshot's write ms and
   bytes, the load and restore ms.  (b) Two gloo ranks on the card
   (``chip_smoke.py --resilience-rank``), each building 250k rows of
   the Higgs cell from the seed, the nocache data-parallel learner (K2),
   a snapshot every round, ``distributed_heartbeat_ms=100``,
   ``collective_timeout_s=8``, ``kill_rank(3, rank=1)``: rank 1 dies
   with SIGKILL, rank 0 exits 75 within the timeout + 10 s naming
   ``Comm::grow`` and rank 1; restarted on fresh ports, both ranks
   agree on round 3 (``coordinated_resume``) and end with a model
   byte-equal between them and to an uninterrupted two-rank run.  (c)
   and (d) in one launch of 250k-row ranks with
   ``collective_timeout_s=5``: ``corrupt_rank_state(2, rank=1,
   field="score")`` under ``distributed_consistency_check=1``:
   ``fail_fast`` names rank 1 and ``score`` on both ranks, then
   ``resync`` (one resync, timed) ends with the clean run's model; then
   ``hang_rank(2, rank=1)``: rank 0 exits 75 through its deadline (two
   timeouts, one extension) while rank 1's heartbeat is fresh, and rank
   1, released once rank 0's heartbeat stops, exits 75 too.  K1's and
   K2's launches counted over every run.
   ``examples``: each of the repo's four example confs
   (``examples/{binary_classification,regression,multiclass_classification,
   lambdarank}/train.conf``) through ``lightgbm_tpu_torch.cli.main`` in a
   copy of its directory, once with ``device=cuda`` and once with
   ``device=cpu``, 10 rounds, then its ``predict.conf`` (raw scores) on
   the test file with each model and the card once more with the CPU's
   model: the binary conf loads ``binary.train.weight``, the lambdarank
   conf reads LibSVM with its ``.query`` files and ``ndcg_at=1,3,5``,
   the multiclass conf trains 5 classes, and the regression conf runs
   as written, its ``bagging_fraction``, ``bagging_freq`` and
   ``feature_fraction`` too.  K1 launches Σ over trees of (1 + splits) in the
   card's run and K4 in every card prediction; the card's trees equal
   the CPU's up to a reported f32 near-tie, every round's metrics agree
   within 1e-4 (a ranking metric beyond it only at a near-tie of scores,
   shown by recomputing it from both models), the card's predictions of
   the CPU model within 1e-5 of the CPU's, and of its own model too
   unless a near-tie flipped a split.
   ``objectives``: every objective the port added, at the train phase's
   operating point (``num_leaves=63``, ``max_bin=255``): multiclass (5
   classes, labels the quintiles of a seeded latent over
   ``make_higgs_like(100000)`` features) and LambdaRank (MSLR-WEB10K's
   shape: 136 dense features, relevance 0-4, query sizes from the seed
   in [1, 1024], mean ~120, 100k rows), 10 rounds each; regression,
   regression_l1, huber and fair on the same latent and poisson on
   counts from it, 5 rounds each.  Each run: K1's launches equal Σ over
   trees of (1 + splits); the first tree of each class re-grown through
   the plain versions from the same gradients is bit-identical; the
   saved model through K4 equals the score buffer within 1e-5; the
   training metric improves; the card's gradients on the final scores
   equal the same function's on the CPU within 1e-6 relative (of each
   value plus the largest; LambdaRank's too); and each round's seconds and the gradient's share of it (CUDA
   events) are printed.
   ``sampling``: row and feature sampling, GOSS and DART on the train
   phase's datasets (before the engine phase gives them init scores),
   through ``Booster.update``, the launch counters set to 0 before each
   run: bagging at the regression example conf's settings
   (``bagging_fraction=0.8``, ``bagging_freq=5``,
   ``feature_fraction=0.9``), 10 rounds of the ordered grower and 3 each
   of the fused and nocache growers (K3 and K2 under a bag mask); GOSS
   (``top_rate=0.2``, ``other_rate=0.1``, 15 rounds: 10 of warmup, 5
   sampled); DART at the JAX defaults, 10 rounds; and the objectives
   phase's 5-class set with ``feature_fraction=0.7``, 3 rounds (the
   per-class draw order).  Each run: (a) every bag mask, GOSS draw
   (mask and amplified gradients, from the card's gradients copied to
   the host) and feature mask equal to the same draw on the CPU, bit
   for bit; (b) the histogram kernel's launches (Σ over trees of the
   leaves for the ordered grower, rounds x L for the fixed-trip ones);
   (c) the ordered grower's root window is each tree's sample and no
   window is larger (launches by window class printed); (d) the first
   sampled tree re-grown through the plain versions from its gradients,
   mask and shrinkage (bit-identical for the ordered grower); (e) DART's
   drops and shrinkage equal a host replay from ``drop_seed``; (f) the
   saved model through K4 equals the score buffer within 1e-5 (for DART
   the normalised trees); (g) the training metric improves.  Prints
   each run's seconds a round beside the train phase's unsampled
   ordered round, and the CUDA-event ms of one bag draw and one GOSS
   draw.
   ``engine``: the engine on the train phase's datasets (the Higgs
   training cell: 1M rows, 28 features, 63 leaves, 255 bins, the
   ordered grower, the 100k-row valid set).  An early-stopped run
   (learning rate 1.0, patience 3) must stop, its ``best_iteration`` the
   best round of its recorded valid logloss; a 2-fold stratified ``cv``
   of 6 rounds, timed.  Then 6 rounds saved and continued 6 more
   from the file and from the in-memory Booster (and the same with
   ``linear_tree=true``, 3 + 3): the init scores come from K4 (the
   linear variant for the linear model; launches counted) within 1e-5
   of the f64 host walk on 100k rows, the carried trees' text is
   byte-equal to the init model's, every tree structure-equal to an
   uninterrupted 12-round (6-round) run's up to a reported near-tie, K1
   launched once per leaf grown, and the saved model predicts the score
   buffer to 1e-5.  ``pred_leaf`` of the file-continued run (the f64
   host walk) equals the card's plain binned walk's leaves on the valid
   rows; 8 ``rollback_one_iter`` from its round 12, two of them into
   the init model's rounds, leave each score buffer within 1e-6 of the
   largest of the buffer recorded at that round (or of the init model's
   K4 prediction); ``merge(shrinkage_decay=0.5)`` of the base and the
   uninterrupted model predicts base + 0.5 * other (1e-5).  On the
   binary example conf's data, the card against the CPU: a 3-fold
   stratified ``cv`` (means and stdvs within 1e-4; a ranking metric
   beyond it only at a near-tie of scores, shown by recomputing it from
   both runs' fold scores, as the examples phase does) and the conf through
   the CLI with ``early_stopping_round=3`` (the same stop and best
   round, metrics as the examples phase holds them).  Prints the
   seconds a round of the continued runs beside the base runs', the
   init-score ms, the K1 and K4 launches and the ``cv`` seconds.
   ``telemetry``: the run's record on the train phase's datasets.  The
   ordered grower 10 rounds four times in turn: bare, with
   ``events_file``, ``trace_events_file`` and ``metrics_port`` while a
   process of its own scrapes ``/metrics`` every 0.2 s, so again, and
   bare again: the four model texts byte-equal, the same host reads a tree and K1
   launches, and in each instrumented run 10 event records whose
   ``trees`` are the model's trees' leaves and depths, 10
   ``GBDT::iteration`` roots in the trace, every scrape parsed and the
   last (the last round's callback) counting 10 rounds, the listener
   closed after ``train``; ``python -m lightgbm_tpu_torch obs-report
   --format=json`` over the first one's events file and (``--traces``)
   trace exiting 0.  One fused round bare and instrumented: one host
   read a tree, K3 once a step.  Then the Higgs forest through
   ``serve_from_config`` from four servers in turn, untraced, traced,
   traced, untraced (the traced ones with ``trace_events_file`` in their
   configuration; no key disarms the tracer), each one warm-up request a
   size and then 4 client threads x 16 requests (1, 64 and 4096 rows in
   turn); each traced server's export at ``stop()``: every
   ``Serve::request``'s critical path ends queue -> batch ->
   ``Predict::forest``, the ``Predict::forest`` spans number that
   server's K4 launches, ``summarize_traces`` reads both exports.  Prints
   the seconds a round bare and instrumented (pooled and by run), the
   scrapes' ms and bytes, each scrape's parse ms (timed after ``train``:
   what it would cost the training process), the exports' seconds and bytes, p50 and p99 by size
   untraced and traced (pooled and by server), spans a request.
   ``attribution``: device-time attribution on the same datasets and the
   Higgs forest.  The ordered grower 10 rounds with ``devprof`` off,
   ``full`` and ``sample:4``: model texts byte-equal, host reads a tree
   and K1's launches unchanged, every dispatch of a program a sample under
   ``full`` and a quarter under ``sample:4``, no forced sync; per program
   the seconds charged, samples and roofline against the ``h100`` row of
   ``obs/devcaps.py``, and the rounds' host/device split.  Fused and
   nocache 3 rounds under ``full`` (K3's and K2's bytes in
   ``train_step``).  A ``trace_dir`` window over rounds 1-2 of 3, after
   CUPTI's first start outside it: the device busy share (the union of
   kernel, memcpy and memset intervals over the window), K1's kernels
   against its launches, the time under ``hist`` / ``find_split`` /
   ``split``.  TIMETAG over 5 rounds with ``events_file`` (phase totals,
   forced syncs, the round beside the bare), ``memwatch`` over 2 (the
   ``GBDT::iteration`` watermark beside ``max_memory_allocated``), one
   ``devprof=full`` server (4 clients x 16 requests: the
   ``serve_forest_walk`` bucket series, its roofline, K4's bound at 4096
   rows), one nvcc build of ``roll_chain`` in a subprocess with the
   compile ledger armed (one line, read back by ``obs-report
   --compile``), and ``poison_gradients`` over 6 updates under
   ``nan_policy=skip_tree`` (5 trees, the clean run's).
   ``estimators``: the scikit-learn estimators at the Higgs cell's
   width (28 features, 63 leaves, 255 bins).  ``LGBMClassifier`` fitted
   on 250k rows, 20 rounds, with a 50k-row ``eval_set`` and
   ``early_stopping_rounds=5``: its model text byte-equal to ``train``
   on the card with the parameters ``_params_for_engine`` gives (K1
   once a grown leaf), ``predict_proba`` on the 50k rows (K4) within
   1e-6 of that booster's ``predict``, K1 on the fit's own bins and
   both walks on the 50k rows bit-equal to their plain versions;
   ``LGBMRegressor`` over a 2 x 2 grid (``learning_rate``,
   ``n_estimators``) with 2 folds on 30k rows (``grid_search``:
   GridSearchCV's protocol of estimators rebuilt from ``get_params()``,
   so that the script needs no scikit-learn), ``device="cuda"`` in all
   9 fits; ``LGBMRanker`` on 100k MSLR-like rows and their query groups
   (``mslr_like``), 10 rounds.  Prints the fits' seconds, the predict
   ms and the K1 and K4 launches.
   ``boundary``: the guarded data boundary.  A 100k x 28 Higgs-like TSV
   (below ``bin_construct_sample_cnt``, so both loaders bin from every
   row), damaged by ``mangle_rows`` (1%) and ``ragged_rows`` (0.5%),
   loaded with ``use_two_round_loading=true
   bad_data_policy=quarantine max_bad_row_fraction=0.05`` and trained 20
   rounds (K1): the quarantine file's lines equal the injected ones,
   ``bad_rows_total`` their count, and the model text equals that of a
   one-round fail-fast load of the clean file with those lines deleted
   (read through the Python parser, as the two-round loader reads: the
   native loader's decimals can differ in the last bits), trained the
   same way, up to the one-round load's fingerprint section
   (the two-round loader builds none, as in the JAX package);
   ``concurrent_append`` during a two-round load raises the named drift
   error, ``max_bad_rows=10`` the budget error.  Prints the seconds and
   the peak host RSS of the two-round and the one-round load of the
   dirty file, each in a process of its own.
   ``sparse``: the JAX package's wide-sparse operating point
   (``bench.py:505-531``: ``make_ctr_like`` of 2000 features in blocks
   of 20 exclusive ones, ~97% zeros; binary, 63 leaves, 255 bins, a
   binning sample of 50k rows), cut to 75k rows with a 25k-row valid
   set from the same draw, fed to ``Dataset`` as a scipy CSR matrix and
   binned twice: with the default ``enable_bundle=true`` (100 columns,
   one bundle of 20 features each, no sample conflict: checked) and
   without (2000 columns).  Runs, the launch counters set to 0 before
   each: the cached grower unbundled (15 rounds) and bundled (10): trees
   bit-identical, score buffers and the trees' model text equal, K1 over
   100 columns against 2000; ``serial_grow=ordered`` bundled falls back
   to cached with the JAX package's warning, the same trees; nocache and
   fused, unbundled (K2, K3 over 2000 columns) and bundled (K2 over the
   100 columns, no K3), 3 rounds each, rounds x L launches: the first
   two trees re-grown from the same gradients through the plain
   versions with f32 histograms and with histograms added in f64, the
   first bit-identical to both (its sums are exact in f32), the second
   held against the f64 re-grow up to a near-tie; where the f32 re-grow
   splits otherwise, both choices are scored in f64 on their leaf's
   rows and the kernel run's must score no worse; bagging
   (0.8 every 5), GOSS (learning rate 0.5: 2 warmup rounds, 3 sampled)
   and DART bundled, 5 rounds each, bit-identical to unbundled twins;
   linear leaves (3 rounds) within 1e-3 of a tree's largest leaf of the
   unbundled linear run; screening (``feature_screen_ratio=0.3``,
   warmup 6, refresh 4; 15 rounds): the active columns of each period
   equal a CPU replay of the screener on the run's trees, K1 over the 70
   active columns in screened rounds and 100 otherwise, the final valid
   AUC within 0.002 of the unbundled run's.  Also: the bundled model's
   predictions through K4 equal the unbundled model's, with the second
   round's gradients K1 on the run's own bundled bins (bit-equal) and K2
   on its bundled and unbundled bins (within its tolerance of its plain
   version added in f64; the plain f32 scatter's distance printed), the
   bundled set
   through ``save_binary`` and ``Dataset(path)`` trains the same first
   tree, and CUDA-event medians of K1 at the root over 100 and over 2000
   columns and of the two expansions.  Prints the host seconds of
   binning and planning and each run's seconds a round.
   ``capi``: the C API (``lightgbm_tpu_torch/capi/``), its library built
   by the host C compiler, from two hosts: ``ctypes`` in the side process
   at the Higgs cell's width (1M x 28 rows, ``TRAIN_PARAMS`` and
   ``device=cuda``, 10 x ``LGBM_BoosterUpdateOneIter`` through K1, the
   100k valid rows through ``LGBM_BoosterPredictForMat`` and K4), held
   against ``lt.Booster`` on the same rows: model text byte-equal (to the
   Booster whose Dataset got its label after binning, as the C API's
   does; to ``lt.Dataset(X, y)``'s but for the fingerprint's
   ``label_hist`` line), predictions and leaf indices bit-equal, K1
   launches equal, one K4 launch a bucket, ``SetLeafValue`` moving exactly
   its leaf's rows; and ``capi/demo.c``, a C program that boots its own
   interpreter, on a 100k-row slice (5 rounds, 4096 predicted rows): its
   model file and predictions byte-equal to the same calls from Python.
   Prints the build seconds, both hosts' round seconds beside the Python
   API's, the predict seconds and a call's round trip in microseconds.
   ``loader``: the native host loader (``lightgbm_tpu_torch/io/
   native.py`` over ``csrc/data_loader.cpp``), built by the host C++
   compiler (its path, the build seconds; fails unless its status is
   built or loaded).  A seeded Higgs-like CSV (28 features, every value
   written with ``repr``; 250k rows, cut from the Higgs cell's 1M for
   time) read by ``parse_file`` natively and through Python (seconds,
   MB/s; labels equal, features within 8 ulps), ``value_to_bin`` native
   against ``searchsorted`` on a 250k-value column (equal codes); 10
   rounds through ``lt.Dataset(path)`` on the card (K1) whose model text
   is byte-equal to ``lt.Dataset(X, y)``'s on the natively parsed
   arrays, the file predicted through K4 (``Booster.predict(path)``,
   equal to the arrays' predictions) and through the C API's
   ``LGBM_BoosterPredictForFile``; a 300-category CSV (a 294-bin mapper
   at ``max_bin=255``) read natively and trained on the card and on the
   CPU: trees structure-equal, leaves within ``EXAMPLE_LEAF_RTOL``.
5. ``probes``: the probes' own entry points, ``python -m
   lightgbm_tpu_torch.tools.probe_roll`` and ``probe_dynhist`` (their
   ``main``) at the JAX probes' sizes, each with its launch counter set
   to 0 just before and read just after.
6. ``timing``: each walk variant on the Higgs forest at B in {1, 256,
   4096, 65536} (the linear and bf16 variants on their forests, beside
   the constant walk over the same trees; plain versions at B = 4096, and
   at every B for the constant f32 walks), timed four ways as ``timed``
   does (single call, back to back, host enqueue, device time by kernel
   name: pass 0, 1 and 2) with its launch plan; CUDA-event medians of
   K1, K2 and K3
   at S in {4096, 65536, 500000, 1000000} beside their plain versions
   and the ``index_add_`` library call, and of P1 and P2 at the probes'
   shapes (P1 beside three launch floors and a CUDA graph's replay; P2
   at each of the probe's runs, beside K1 on the same window and
   ``index_add_`` on the unpacked window; both timed four ways), each
   beside its bound (the bytes are the kernel module's ``launch_cost``).  ``k1_windows``: K1's small path, large
   path, the wrapper as the growers call it and
   ``index_add_`` at every window class the train phase counts (2^10 to
   2^20 rows), each alone (``single_ms``: events around one call, the
   host's enqueue included), back to back (``back_to_back_ms``), by its
   host enqueue (``host_enqueue_us``) and by its device time per kernel
   name from ``torch.profiler`` (``device_us``, or "not measured"); the
   crossover of the two paths.
   ``k3_occupancy``: K3 and K2 on the 1M-row full pass
   with 2^14, 2^17, 2^19 and all rows in the children, timed the same
   ways, beside the ``index_add_`` computing K2's function
   (``library_ms``), and K2's root form (no leaf array).  Then ``rule2``:
   the kernels in the order to redesign them, first those that lose to
   the PyTorch call computing the same function at the sizes the main
   path launches them (K1 timed at each window class the train phase
   counted), then by launches x (ms - bound), each with the PR that
   redesigned it.

Then the kernels summary line, the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``.
Without a CUDA card the script exits non-zero before printing a result.
"""

import argparse
import contextlib
import copy
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch

WALKS = tuple(f"forest_walk{raw}{lin}{q}" for raw in ("", "_raw")
              for lin in ("", "_linear") for q in ("", "_bf16"))
SOURCE = {**{name: "lightgbm_tpu_torch/csrc/forest_walk.cu"
             for name in WALKS},
          "digit_histogram": "lightgbm_tpu_torch/csrc/leaf_hist.cu",
          "children_histograms": "lightgbm_tpu_torch/csrc/children_hist.cu",
          "fused_split_candidates":
              "lightgbm_tpu_torch/csrc/children_hist.cu",
          "roll_chain": "lightgbm_tpu_torch/csrc/roll_chain.cu",
          "window_digit_histogram": "lightgbm_tpu_torch/csrc/window_hist.cu"}
# the binned and raw entry points of the TPU walk; their aff= option is
# the affine epilogue (pallas_walk.py:238-242), a bf16 lv their :236 cast
REPLACES = {**{name: "lightgbm_tpu/ops/pallas_walk.py:"
               + ("391" if "_raw" in name else "372") for name in WALKS},
            "digit_histogram": "lightgbm_tpu/ops/leafhist.py:138",
            "children_histograms": "lightgbm_tpu/ops/pallas_histogram.py:185",
            "fused_split_candidates":
                "lightgbm_tpu/ops/pallas_histogram.py:232",
            "roll_chain": "tools/probe_roll.py:45",
            "window_digit_histogram": "tools/probe_dynhist.py:148"}
# the PR of the port that redesigned a kernel after its first port
REDESIGNED = {"digit_histogram": 6, "fused_split_candidates": 6,
              "children_histograms": 7, **{name: 7 for name in WALKS},
              "roll_chain": 8, "window_digit_histogram": 8}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TOL = 1e-6
HIGGS = dict(num_features=28, num_trees=500, num_leaves=255, num_cuts=255)
LINEAR_K = 5                   # affine slots a leaf (linear_max_leaf_features)
LINEAR_CAT = (3,)              # the linear Higgs forest's categorical feature
TINY_LEAVES = 1e-2             # leaf scale the bf16 pin accepts at 500 trees
SERVE_SIZES = (1, 64, 4096)
SERVE_CLIENTS = 4
SOLO = 5                       # sequential 1-row requests after the load
TIMING_SIZES = (1, 256, 4096, 65536)
TRAIN_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 63,
                "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 50}
TRAIN_ROWS, VALID_ROWS, TRAIN_ROUNDS = 1_000_000, 100_000, 10
# the model layer's own loop (GBDT.train) on the training cell
MODEL_LAYER_ROUNDS = 3
HIST_SIZES = (0, 1, 4097, 65536, 1_000_000)
HIST_FEATURES = (5, 28, 30)
HIST_TIMING_SIZES = (4096, 65536, 500_000, 1_000_000)
# K1's window classes on the training path (the power-of-two classes the
# train phase counts: 2^10 .. 2^20 rows) and its paths (None: the
# wrapper's choice); K3's leaf occupancies at the 1M-row full pass (rows in
# the two children)
WINDOW_CLASSES = tuple(1 << k for k in range(10, 21))
K1_PATHS = (None, "small", "large")
OCCUPANCIES = (1 << 14, 1 << 17, 1 << 19, 1 << 20)
# a split of a re-grown tree may differ from the kernel run's only where
# the two choices' gains are this close (relative): an f32 near-tie
TREE_TIE_RTOL = 1e-3
# the training runs: (grower, extra params, the histogram kernel it runs);
# the cache of 63 x 28 x 9 x 255 int32 (16 MB) is over a 1 MB pool
# (the datasets keep raw values for the linear run, so the constant runs
# say linear_tree=false)
CONST = {"linear_tree": False}
LINEAR_PARAMS = {"linear_tree": True, "linear_max_leaf_features": LINEAR_K,
                 "linear_lambda": 0.01}
GROWERS = (("ordered", {**CONST}, "digit_histogram"),
           ("cached", {**CONST, "serial_grow": "cached"}, "digit_histogram"),
           ("fused", {**CONST, "serial_grow": "fused"},
            "fused_split_candidates"),
           ("nocache", {**CONST, "histogram_pool_size": 1,
                        "memory_policy": "degrade"}, "children_histograms"),
           ("linear", LINEAR_PARAMS, "digit_histogram"))
REPO = os.path.dirname(os.path.abspath(__file__))
# the examples phase: (name, folder of examples/) and the rounds; each
# conf runs as written
EXAMPLES = (("binary", "binary_classification"), ("regression", "regression"),
            ("multiclass", "multiclass_classification"),
            ("lambdarank", "lambdarank"))
EXAMPLE_ROUNDS = 10
# card against CPU, a leaf value within this share of its tree's largest:
# f32 sums in another order (an H100 read 5.0e-5 at most, PERF.md)
EXAMPLE_LEAF_RTOL = 2e-4
# the objectives phase: the train phase's operating point, the MSLR-like
# width, and (objective, extra params, rounds, labels) for each run
# cut from 1M rows to 100k to bring the script to half its time limit
# (1M x 136 took 29 s of host binning alone)
OBJ_ROWS = 100_000
OBJ_PARAMS = {"num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
              "min_data_in_leaf": 50}
RANK_FEATURES = 136
OBJECTIVE_RUNS = (
    ("multiclass", {"num_class": 5}, 10, "multiclass"),
    ("lambdarank", {"ndcg_eval_at": "1,3,5,10"}, 10, "rank"),
    ("regression", {}, 5, "continuous"),
    ("regression_l1", {}, 5, "continuous"),
    ("huber", {}, 5, "continuous"),
    ("fair", {}, 5, "continuous"),
    ("poisson", {}, 5, "counts"))
# the card's gradients against the CPU's, relative to each value plus
# the largest (LambdaRank's pair sums associate otherwise on the card)
GRAD_RTOL = 1e-6
# the engine phase (on the train phase's datasets): base rounds and as
# many continued ones (constant; linear), the rollbacks from the end of
# the continued run (into the init model's rounds), the early-stopped
# run (a learning rate that overfits within a few rounds, its round cap
# and patience), the cv folds, the prefix of the training rows held
# against the f64 host walk, and the binary example conf's early-stopped
# CLI run's learning rate (so that it stops within ~30 rounds)
ENGINE_ROUNDS, ENGINE_LINEAR_ROUNDS, ENGINE_ROLLBACKS = 6, 3, 8
# two linear runs of the same data differ in the fit's f32 atomic sums:
# their leaf values are held to 1e-3 of the tree's largest, as
# ``compare_regrown`` holds a re-fit (a card read 3.2e-4)
LINEAR_LEAF_RTOL = 1e-3
ES_PARAMS = {"learning_rate": 1.0, "metric": "binary_logloss"}
ES_ROUNDS, ES_PATIENCE = 40, 3
# the example conf's cv, card against CPU (cut from 5 folds to pay for
# the fleet's background warm and the train phase's model-layer run; at
# 2 folds the card's and the CPU's AUC means part by more than 1e-4)
CV_FOLDS = 3
# the 1M-row cv: 2 folds, cut from 5 to pay for the telemetry phase's
# alternated runs, then from 3 for the background warm
HIGGS_CV_FOLDS = 2
HOST_WALK_ROWS = 100_000
EXAMPLE_ES_LR = 0.3
# the sampling phase: the regression example conf's bagging and feature
# fraction, GOSS (0.2 + 0.1 of the rows after int(1 / 0.1) = 10 warmup
# rounds), DART at the JAX defaults, the 5-class set's feature fraction,
# and each run's rounds
SAMPLING_BAG = {"bagging_fraction": 0.8, "bagging_freq": 5,
                "feature_fraction": 0.9}
SAMPLING_GOSS = {"boosting_type": "goss", "top_rate": 0.2,
                 "other_rate": 0.1, "learning_rate": 0.1}
SAMPLING_MULTICLASS = {"objective": "multiclass", "num_class": 5,
                       "feature_fraction": 0.7}
SAMPLING_ROUNDS, SAMPLING_SHORT_ROUNDS = 10, 3
SAMPLING_GOSS_ROUNDS, SAMPLING_MULTICLASS_ROUNDS = 15, 3
# the sparse phase: the JAX package's wide-sparse operating point
# (bench.py:505-531, docs/SPARSE.md's bench recipe): make_ctr_like of
# 2000 features (blocks of 20 exclusive features), binary, 63 leaves,
# 255 bins, a binning sample of 50k rows; cut from 500k rows to 250k
# (the phase took 215 s at 500k, 125 s of it host binning), then to
# 125k to make room for the resilience phase (164-183 s at 250k, 71 s
# of it host set-up), then to 75k for the estimators and boundary
# phases (99.4 s at 125k, the script 1070.8 s, on an NVIDIA H100 80GB
# HBM3 at 700 W), with a 25k-row valid
# set from the same draw; 10 rounds, 3 for ordered (the
# cached fallback), nocache, fused and linear, 5 for the sampled twins,
# 15 for screening (docs/SPARSE.md's recipe: ratio 0.3, 6 warmup rounds,
# a refresh every 4) and its unbundled reference, whose final valid AUC
# the screened run's is held to within the JAX package's pin; GOSS at
# learning rate 0.5, so that its 5 rounds sample after int(1 / 0.5) = 2
# warmup rounds
SPARSE_ROWS, SPARSE_VALID_ROWS, SPARSE_FEATURES = 75_000, 25_000, 2000
SPARSE_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 63,
                 "max_bin": 255, "learning_rate": 0.1,
                 "min_data_in_leaf": 50, "bin_construct_sample_cnt": 50_000}
SPARSE_ROUNDS, SPARSE_SHORT_ROUNDS, SPARSE_SAMPLED_ROUNDS = 10, 3, 5
SPARSE_SCREEN = {"feature_screen_ratio": 0.3, "feature_screen_warmup": 6,
                 "feature_screen_refresh": 4}
SPARSE_SCREEN_ROUNDS = 15
SPARSE_AUC_PIN = 0.002
SPARSE_GOSS_LR = {"learning_rate": 0.5}


# the memory phase: rounds measured per grower, the free memory the real
# OOM's ballast leaves at most (about 256 MB; less when a round needs
# less), the growers measured
MEM_ROUNDS = 3
MEM_LEAVE_MAX = 256 << 20
MEM_GROWERS = GROWERS[:4]
# the distributed phase: rounds a learner, the runs (name, params, the
# data-parallel reduce), the ranks' and the CLI's timeouts, the CLI
# two-process run's trees
DIST_ROUNDS = 3
DIST_RUNS = (("data_reduce_scatter", {"tree_learner": "data"},
              "reduce_scatter"),
             ("data_psum", {"tree_learner": "data"}, "psum"),
             ("feature", {"tree_learner": "feature"}, "reduce_scatter"),
             ("voting_top20", {"tree_learner": "voting", "top_k": 20},
              "reduce_scatter"),
             ("voting_top28", {"tree_learner": "voting", "top_k": 28},
              "reduce_scatter"))
DIST_EXACT = ("data_reduce_scatter", "data_psum", "feature", "voting_top28")
DIST_TIMEOUT_S = 420
DIST_CLI_TIMEOUT_S = 300
DIST_CLI_TREES = 5
DIST_AUC_PIN = 1e-3


# the resilience phase: (a) the serial crash and resume (rounds, the
# snapshot period, the round whose after-callback crashes); (b) the kill
# and resume of two gloo ranks (rows, rounds, the killed rank's round,
# the heartbeat, the deadline, the abort's allowance over it); (c) the
# hang and (d) the desync, in one launch of 250k-row ranks (rounds, the
# hung round, the deadline: two of them and a round bound the abort, the
# hung rank wakes after; the corrupted round); each launch's timeout
RES_ROUNDS, RES_SNAP_FREQ, RES_CRASH_AT = 8, 2, 5
# (the kill's ranks cut from 1M rows to 250k and its deadline from 20 s
# to 8 s, and its rounds from 8 to 6, for the script's time)
RES_DIST_ROWS, RES_DIST_ROUNDS, RES_KILL_AT = 250_000, 6, 3
RES_HEARTBEAT_MS, RES_KILL_TIMEOUT_S, RES_ABORT_SLACK_S = 100.0, 8.0, 10.0
RES_SMALL_ROWS, RES_SMALL_ROUNDS, RES_HANG_AT = 250_000, 6, 2
RES_HANG_TIMEOUT_S, RES_CORRUPT_AT = 5.0, 2
RES_LAUNCH_TIMEOUT_S = 240
# the ranks' nocache data-parallel learner (K2 on every rank)
RES_DIST_PARAMS = {**TRAIN_PARAMS, **CONST, "tree_learner": "data",
                   "num_machines": 2, "histogram_pool_size": 1,
                   "memory_policy": "degrade"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseClock:
    """The wall seconds of each phase of ``main``, each printed as the
    phase ends (on stdout, and on stderr, whose tail a run cut by its
    time limit still shows)."""

    def __init__(self, prefix=""):
        self.t = time.perf_counter()
        self.walls = {}
        self.prefix = prefix

    def lap(self, name):
        now = time.perf_counter()
        self.walls[name] = now - self.t
        self.t = now
        line = json.dumps({"phase_wall": self.prefix + name,
                           "seconds": self.walls[name],
                           "total": sum(self.walls.values())})
        print(line, flush=True)
        print(line, file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# model and rows from a seed


def cut_grid(rng, num_features: int, num_cuts: int) -> np.ndarray:
    """[F, C] per-feature N(0,1) quantiles: the cut values a LightGBM
    dataset of normal features gets from ``max_bin = C + 1``."""
    q = np.arange(1, num_cuts + 1) / (num_cuts + 1.0)
    sample = rng.normal(size=(num_features, 1 << 15))
    return np.quantile(sample, q, axis=1).T.copy()


def random_tree(rng, num_leaves, grid, cat_features, num_cats):
    """A tree grown leaf-wise by splitting a uniformly random leaf, in
    the LightGBM node layout (leaves are ``~index`` in the child
    arrays)."""
    from lightgbm_tpu_torch.models.tree import Tree
    t = Tree(num_leaves)
    parent = [-1]                         # node whose child is ~leaf
    for i in range(num_leaves - 1):
        leaf, new = int(rng.randint(i + 1)), i + 1
        p = parent[leaf]
        if p >= 0:
            if t.left_child[p] == ~leaf:
                t.left_child[p] = i
            else:
                t.right_child[p] = i
        f = int(rng.randint(grid.shape[0]))
        t.split_feature[i] = f
        if f in cat_features:
            t.decision_type[i] = 1
            t.threshold[i] = float(rng.randint(num_cats))
        else:
            t.threshold[i] = grid[f, rng.randint(grid.shape[1])]
        t.left_child[i], t.right_child[i] = ~leaf, ~new
        parent[leaf] = i
        parent.append(i)
    t.leaf_parent[:] = parent
    t.leaf_value[:] = rng.normal(0.0, 0.01, num_leaves)
    return t


def random_model(seed: int, num_features: int, num_trees: int,
                 num_leaves: int, num_cuts: int, num_class: int = 1,
                 cat_features=(), num_cats: int = 0, collide: bool = False,
                 ragged_tail: int = 0):
    """A ``GBDT`` of random trees plus its cut grid.  ``collide`` puts
    f64 cut values one ulp apart, which the f32 cut table merges;
    ``ragged_tail`` adds that many trees after the last full round, and
    every fifth tree of a multiclass forest has one leaf."""
    from lightgbm_tpu_torch.models.gbdt import GBDT, _PredictionObjective
    from lightgbm_tpu_torch.models.tree import Tree
    rng = np.random.RandomState(seed)
    grid = cut_grid(rng, num_features, num_cuts)
    if collide:
        for j in range(1, num_cuts, 7):
            grid[:, j] = np.nextafter(grid[:, j - 1], np.inf)
    g = GBDT()
    g.num_class = num_class
    g.max_feature_idx = num_features - 1
    g.sigmoid = 1.0 if num_class == 1 else -1.0
    g.feature_names = [f"Column_{i}" for i in range(num_features)]
    g.feature_infos_ = ["none"] * num_features
    g.objective = _PredictionObjective(
        "binary sigmoid:1" if num_class == 1
        else f"multiclass num_class:{num_class}", g.sigmoid, num_class)
    for i in range(num_trees * num_class + ragged_tail):
        if num_class > 1 and i % 5 == 4:
            t = Tree(1)
            t.leaf_value[0] = rng.normal(0.0, 0.01)
        else:
            t = random_tree(rng, num_leaves, grid, set(cat_features),
                            num_cats)
        g.models.append(t)
    return g, grid


def leaf_path_features(tree):
    """Each leaf's split features from the leaf up to the root, repeats
    dropped (categorical ones kept)."""
    parent = {}
    for node in range(tree.num_leaves - 1):
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                parent[int(child)] = node
    out = []
    for leaf in range(tree.num_leaves):
        feats, node = [], int(tree.leaf_parent[leaf])
        while node >= 0:
            f = int(tree.split_feature[node])
            if f not in feats:
                feats.append(f)
            node = parent.get(node, -1)
        out.append(feats)
    return out


def make_linear(g, seed: int, const_frac: float = 0.1,
                pad_frac: float = 0.1):
    """Give every leaf of ~(1 - const_frac) of ``g``'s trees LINEAR_K
    affine slots from its own path features (categorical ones included,
    as loaded model text may name them), N(0, 0.01) coefficients, and
    ``pad_frac`` of the slots -1; the other trees stay constant."""
    rng = np.random.RandomState(seed)
    for t in g.models:
        if t.num_leaves <= 1 or rng.rand() < const_frac:
            continue
        feat = np.full((t.num_leaves, LINEAR_K), -1, np.int32)
        for leaf, fs in enumerate(leaf_path_features(t)):
            fs = fs[:LINEAR_K]
            feat[leaf, :len(fs)] = fs
        feat[rng.rand(*feat.shape) < pad_frac] = -1
        t.leaf_feat = feat
        t.leaf_coeff = np.where(feat >= 0,
                                rng.normal(0.0, 0.01, feat.shape), 0.0)
    return g


def scaled(g, factor: float):
    """A copy of ``g`` (through its model text) with every leaf value
    times ``factor``; affine coefficients unchanged."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    out = GBDT.from_string(g.save_model_to_string())
    for t in out.models:
        t.leaf_value = t.leaf_value * factor
    return out


def random_rows(rng, n: int, grid, cat_features=(), num_cats: int = 0,
                nan_frac: float = 0.0, tie_frac: float = 0.0) -> np.ndarray:
    """[n, F] f64 rows: N(0,1) values, ``tie_frac`` of them exactly on a
    cut value, categorical codes in [0, num_cats + 3) (some unseen), and
    ``nan_frac`` NaN."""
    F = grid.shape[0]
    X = rng.normal(size=(n, F))
    ties = rng.rand(n, F) < tie_frac
    X[ties] = grid[np.nonzero(ties)[1], rng.randint(grid.shape[1],
                                                    size=int(ties.sum()))]
    for f in cat_features:
        X[:, f] = rng.randint(0, num_cats + 3, size=n)
    X[rng.rand(n, F) < nan_frac] = np.nan
    return X


def make_higgs_like(num_data: int, num_features: int = 28, seed: int = 42):
    """The bench's synthetic stand-in for the Higgs dataset (a few
    informative low-level features, quadratic 'derived' features, heavy
    noise); a copy, so the script needs nothing outside the port."""
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(num_data, num_features)).astype(np.float32)
    X[:, 7:14] = np.abs(X[:, 7:14])
    X[:, 14:21] = X[:, 0:7] * X[:, 7:14]
    logit = (0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.5 * X[:, 14]
             - 0.4 * X[:, 15] + 0.3 * X[:, 7] * X[:, 2]
             + rng.normal(scale=1.5, size=num_data))
    y = (logit > 0).astype(np.float32)
    return X.astype(np.float64), y


def hist_inputs(rng, rows: int, F: int, max_bin: int, dtype, dev):
    """Row-major bins [rows, F] and balanced int8 digits [rows, 9] of
    random g/h and an all-ones w, on ``dev``."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    bins = torch.from_numpy(rng.randint(0, max_bin, size=(rows, F))
                            .astype(dtype)).to(dev)
    g = torch.from_numpy(rng.normal(size=rows).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.uniform(0.01, 0.25, size=rows)
                         .astype(np.float32)).to(dev)
    w = torch.ones(rows, dtype=torch.float32, device=dev)
    return bins, lh.quantize_digits(g, h, w, lh.compute_scales(g, h, w))


def leaf_depths(tables) -> np.ndarray:
    """[K, T, L] nodes visited on the way to each leaf (an absorbing
    tree's leaf 0 counts its one root visit)."""
    _, _, _, lc, rc, lv = (a.cpu().numpy() for a in tables.stacks())
    K, T, _ = lc.shape
    depth = np.zeros((K, T, lv.shape[2]), np.int64)
    for k in range(K):
        for t in range(T):
            stack = [(0, 1)]
            while stack:
                node, d = stack.pop()
                for child in (lc[k, t, node], rc[k, t, node]):
                    if child < 0:
                        depth[k, t, ~child] = d
                    else:
                        stack.append((int(child), d + 1))
    return depth


# ---------------------------------------------------------------------------
# phases


def stack_frames(log: str):
    """{kernel: bytes of stack frame} from an ``nvcc -Xptxas -v`` report
    (the line after each "Function properties for <kernel>")."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.rsplit("for", 1)[1].strip()
        elif name is not None and "bytes stack frame" in ln:
            out[name] = int(ln.split("bytes stack frame")[0].split()[-1])
            name = None
    return out


def phase_build():
    """Builds every kernel; P2's kernels (every ``window_hist``
    instantiation) must show a stack frame of 0 bytes: no pointer table
    in local memory."""
    from lightgbm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    wall = time.perf_counter() - t0
    report = [ln.strip() for name in secs
              for ln in _build.build_log(name).splitlines()
              if "registers" in ln or "spill" in ln]
    frames = {name: stack_frames(_build.build_log(name)) for name in secs}
    p2 = {k: v for k, v in frames["window_hist"].items()
          if "window_hist_kernel" in k}
    check(len(p2) >= 2 and not any(p2.values()),
          f"window_hist: every instantiation needs a 0-byte stack frame; "
          f"ptxas reports {p2}")
    smi = nvidia_smi_line()
    emit({"phase": "build", "seconds": wall, "per_source": secs,
          "ptxas": report, "stack_frames": frames, "nvidia_smi": smi})
    return smi


def compare_kernels(cf, X, sizes, label, errs):
    """Both wrappers of ``cf``'s variant against their plain versions at
    each size, bit-equal (``torch.equal``; a bf16 table against the plain
    walk on its dequantized values: both fold the same f32 values in one
    Kahan order); each wrapper launch must add exactly one to its
    variant's counter.  The plain versions run once on the largest batch
    and are sliced to each size: a row's result depends on that row
    alone."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    tables = cf.walk_tables
    bnd, cats, is_cat = cf.cut_tables()
    nb, nr = tables.variant(raw=False), tables.variant(raw=True)
    out = {"variants": [nb, nr], "bin_dtype": cf.info()["bin_dtype"]}
    top = X[:max(sizes)]
    want_all = fw.forest_walk_plain(
        tables, cf.device_bins(top),
        cf.device_covariates(top) if tables.linear else None)
    want_raw_all = fw.forest_walk_raw_plain(tables, bnd, cats, is_cat,
                                            cf.device_rows(top))
    for B in sizes:
        bins = cf.device_bins(X[:B])
        rows = cf.device_rows(X[:B])
        xt = cf.device_covariates(X[:B]) if tables.linear else None
        before = fw.launch_counts()
        got = fw.forest_walk(tables, bins, xt)
        got_raw = fw.forest_walk_raw(tables, bnd, cats, is_cat, rows)
        torch.cuda.synchronize()
        after = fw.launch_counts()
        check(after[nb] == before[nb] + 1 and after[nr] == before[nr] + 1
              and sum(after.values()) == sum(before.values()) + 2,
              f"{label} B={B}: launch counters {before} -> {after}")
        want, want_raw = want_all[:, :B], want_raw_all[:, :B]
        d = float((got - want).abs().max())
        d_raw = float((got_raw - want_raw).abs().max())
        bit_equal = bool(torch.equal(got, want)
                         and torch.equal(got_raw, want_raw))
        check(bool(torch.isfinite(got).all() and torch.isfinite(got_raw)
                   .all()), f"{label} B={B}: non-finite kernel output")
        check(d <= TOL and d_raw <= TOL,
              f"{label} B={B}: kernel vs plain max_abs_diff binned={d} "
              f"raw={d_raw} (tolerance {TOL})")
        check(bit_equal, f"{label} B={B}: the walk is not bit-equal to its "
                         f"plain version")
        errs[nb] = max(errs[nb], d)
        errs[nr] = max(errs[nr], d_raw)
        out[str(B)] = {"binned": d, "raw": d_raw, "bit_equal": bit_equal}
    return out


def chain_tree(rng, grid, num_leaves: int):
    """A leaf-wise chain on feature 0: node i sends values up to cut i to
    leaf i and the rest on, so a row above cut num_leaves - 2 walks
    num_leaves - 1 levels (254 at 255 leaves)."""
    from lightgbm_tpu_torch.models.tree import Tree
    t = Tree(num_leaves)
    for i in range(num_leaves - 1):
        t.threshold[i] = grid[0, i]
        t.left_child[i] = ~i
        t.right_child[i] = i + 1 if i + 2 < num_leaves else ~(i + 1)
        t.leaf_parent[i] = i
    t.leaf_parent[num_leaves - 1] = num_leaves - 2
    t.leaf_value[:] = rng.normal(0.0, 0.01, num_leaves)
    return t


def walk_edge_forests(seed):
    """(label, GBDT, grid, rows) of the walk's edge cases, 28 features and
    255 leaves as the Higgs forest: one tree; 37 trees (not a multiple of
    the plan's chunk at B = 4096); a chain tree 254 levels deep before 3
    random trees, with an eighth of the rows above every cut of feature
    0.  Rows: 4096, 5% NaN."""
    rng = np.random.RandomState(seed + 85)
    one, g1 = random_model(seed + 80, 28, 1, 255, 255)
    odd, g2 = random_model(seed + 81, 28, 37, 255, 255)
    chain, g3 = random_model(seed + 82, 28, 3, 255, 255)
    chain.models.insert(0, chain_tree(rng, g3, 255))
    out = []
    for label, g, grid in (("one_tree", one, g1), ("trees_37", odd, g2),
                           ("chain_254", chain, g3)):
        X = random_rows(rng, 4096, grid, nan_frac=0.05, tie_frac=0.05)
        if label == "chain_254":
            X[::8, 0] = 10.0
        out.append((label, g, grid, X))
    return out


def compare_walk_edges(seed, dev, errs):
    """All eight walk variants bit-equal to their plain versions on
    ``walk_edge_forests``, each frozen four ways (f32 and bf16 leaves,
    constant and linear), at B = 1, one tile - 1, one tile + 1 (the
    plan's widest tile) and 4096 rows; and the 37-tree forest again with
    the scratch capped at 1000 rows, so that 4096 rows take eight waves of
    512 (a forest of many trees or classes takes waves at its own
    size)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import forest_walk as fw
    tile = fw.WALK_TILES[0]
    sizes = (1, tile - 1, tile + 1, 4096)
    out = {}
    for label, g, grid, X in walk_edge_forests(seed):
        lin = make_linear(scaled(g, 1.0), seed + 86)
        for kind, model, quantize in (
                ("f32", g, False), ("bf16", scaled(g, TINY_LEAVES), True),
                ("linear", lin, False),
                ("linear_bf16", scaled(lin, TINY_LEAVES), True)):
            cf = lt.CompiledForest.from_booster(model, device=dev,
                                                quantize_leaves=quantize)
            t = cf.walk_tables
            check(t.linear == kind.startswith("linear")
                  and (t.leaves.dtype == torch.bfloat16) == quantize,
                  f"{label}/{kind}: froze as {cf.info()}")
            plans = {B: fw.walk_plan(t, X.shape[1], B, raw=False)
                     for B in sizes}
            if label == "trees_37":
                check(37 % plans[4096].chunk != 0,
                      f"{label}/{kind}: 37 trees are whole chunks of "
                      f"{plans[4096].chunk}")
            if label == "chain_254" and kind == "f32":
                leaf = fw.walk_plain(t, cf.device_bins(X))[1][0, 0]
                check(int(leaf_depths(t)[0, 0].max()) == 254
                      and bool((leaf == 254).any()),
                      f"{label}/{kind}: no row walks 254 levels")
            res = compare_kernels(cf, X, sizes, f"{label}/{kind}", errs)
            res["plans"] = {str(B): p._asdict() for B, p in plans.items()}
            out[f"{label}/{kind}"] = res
            if label == "trees_37":
                out[f"{label}/waves/{kind}"] = compare_waves(cf, X, errs)
    return out


def compare_waves(cf, X, errs):
    """``compare_kernels`` at 1 and 4096 rows with the walk's scratch
    capped at 1000 rows a wave (``WALK_SCRATCH_BYTES``)."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    t = cf.walk_tables
    saved = fw.WALK_SCRATCH_BYTES
    fw.WALK_SCRATCH_BYTES = 4 * t.num_class * t.trees_per_class * 1000
    fw.plan_walk.cache_clear()
    try:
        p = fw.walk_plan(t, X.shape[1], 4096, raw=False)
        check(p.wave < 4096, f"waves: one wave of {p.wave} rows")
        res = compare_kernels(cf, X, (1, 4096), "waves", errs)
        res["plan"] = p._asdict()
    finally:
        fw.WALK_SCRATCH_BYTES = saved
        fw.plan_walk.cache_clear()
    return res


def linear_forests(seed, higgs_model, higgs_grid):
    """The linear Higgs forest, its grid, and the kernels phase's linear
    and bf16 forests as (label, GBDT, grid, quantize, categorical
    features, categories)."""
    lin, grid = random_model(seed + 5, cat_features=LINEAR_CAT, num_cats=8,
                             **HIGGS)
    make_linear(lin, seed + 6)
    lin8, grid8 = random_model(seed + 7, cat_features=LINEAR_CAT,
                               num_cats=8, **{**HIGGS, "num_cuts": 250})
    make_linear(lin8, seed + 8)
    mc, gmc = random_model(seed + 2, 6, 7, 15, 30, num_class=3,
                           ragged_tail=2, cat_features=(1,), num_cats=6)
    make_linear(mc, seed + 9)
    return lin, grid, [
        ("higgs_linear_u16", lin, grid, False, LINEAR_CAT, 8),
        ("higgs_linear_u8", lin8, grid8, False, LINEAR_CAT, 8),
        ("multiclass_ragged_linear", mc, gmc, False, (1,), 6),
        ("higgs_bf16", scaled(higgs_model, TINY_LEAVES), higgs_grid, True,
         (), 0),
        ("higgs_linear_bf16", scaled(lin, TINY_LEAVES), grid, True,
         LINEAR_CAT, 8)]


def phase_kernels(seed, dev, higgs_model, higgs_grid, linear_set, errs):
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    results = {}
    cat = (0, 1, 2)
    g, grid = random_model(seed + 1, 8, 20, 31, 40, cat_features=cat,
                           num_cats=6, collide=True)
    cf = lt.CompiledForest.from_booster(g, device=dev)
    X = random_rows(np.random.RandomState(seed + 11), 4096, grid, cat, 6,
                    nan_frac=0.1, tie_frac=0.1)
    results["binary_cat_nan"] = compare_kernels(
        cf, X, (1, 33, 129, 700, 4096), "binary_cat_nan", errs)
    g, grid = random_model(seed + 2, 6, 7, 15, 30, num_class=3,
                           ragged_tail=2)
    cf = lt.CompiledForest.from_booster(g, device=dev)
    check(cf.trees_per_class * 3 > g.num_trees(),
          "multiclass forest is not ragged")
    X = random_rows(np.random.RandomState(seed + 12), 4096, grid,
                    nan_frac=0.05, tie_frac=0.05)
    results["multiclass_ragged"] = compare_kernels(
        cf, X, (1, 33, 129, 700, 4096), "multiclass_ragged", errs)
    cf = lt.CompiledForest.from_booster(higgs_model, device=dev)
    check(cf.info()["bin_dtype"] == "uint16", "Higgs bins are not uint16")
    X = random_rows(np.random.RandomState(seed + 13), 4096, higgs_grid,
                    tie_frac=0.02)
    results["higgs"] = compare_kernels(cf, X, (16, 64, 4096), "higgs", errs)
    for i, (label, g, grid, quantize, cat, ncat) in enumerate(linear_set):
        cf = lt.CompiledForest.from_booster(g, device=dev,
                                            quantize_leaves=quantize)
        info = cf.info()
        check(info["linear"] == ("linear" in label)
              and info["leaf_dtype"] == ("bfloat16" if quantize
                                         else "float32"),
              f"{label}: froze as {info}")
        if label.endswith(("_u8", "_u16")):
            check(info["bin_dtype"] == "uint" + label.rsplit("_u", 1)[1],
                  f"{label}: bins are {info['bin_dtype']}")
        X = random_rows(np.random.RandomState(seed + 60 + i), 4096, grid,
                        cat, ncat, nan_frac=0.05, tie_frac=0.02)
        results[label] = compare_kernels(cf, X, (1, 64, 4096), label, errs)
    results["walk_edges"] = compare_walk_edges(seed, dev, errs)
    results["digit_histogram"] = compare_leaf_hist(seed, dev, errs)
    results["children_hist"] = compare_children_hist(seed, dev, errs)
    results["probes"] = compare_probes(seed, dev, errs)
    results["wide_codes"] = compare_wide_codes(seed, dev, errs)
    emit({"phase": "kernels", "max_abs_diff": results,
          "launches": {**fw.launch_counts(), **lh.launch_counts(),
                       **ch.launch_counts(), **rc.launch_counts(),
                       **wh.launch_counts()}})


def compare_leaf_hist(seed, dev, errs):
    """K1 against its plain version: bit-equal at every dtype, width (F
    in HIST_FEATURES and RANK_FEATURES) and window size, on the
    wrapper's own choice of path and on each path forced; then at every
    window class the train phase counts (2^10 to 2^20 rows, uint8, 28
    features, 255 bins) on both paths.  One launch per call."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    rng = np.random.RandomState(seed + 14)
    out = {}

    def held(bins, dig, max_bin, start, S, label, **kw):
        before = lh.launch_counts()["digit_histogram"]
        got = lh.digit_histogram(bins, dig, max_bin, start, S, **kw)
        torch.cuda.synchronize()
        after = lh.launch_counts()["digit_histogram"]
        check(after == before + (1 if bins.shape[1] else 0),
              f"K1 {label}: launch counter {before} -> {after}")
        want = lh.digit_histogram_plain(bins, dig, max_bin, start, S)
        check(torch.equal(got, want),
              f"K1 {label}: not bit-equal to the plain version")
        d = float((got - want).abs().max()) if got.numel() else 0.0
        errs["digit_histogram"] = max(errs["digit_histogram"], d)
        out[label] = d

    # the K2/K3 widths, and the objectives phase's LambdaRank width (the
    # LambdaRank example's 30 features are among them)
    for dtype, max_bin in ((np.uint8, 255), (np.uint16, 1000)):
        for F in HIST_FEATURES + (RANK_FEATURES,):
            bins, dig = hist_inputs(rng, max(HIST_SIZES) + 3, F, max_bin,
                                    dtype, dev)
            for S in HIST_SIZES:
                start = 3 if S < max(HIST_SIZES) else 0
                for path in K1_PATHS:
                    held(bins, dig, max_bin, start, S,
                         f"{dtype.__name__}/F{F}/S{S}/{path or 'auto'}",
                         path=path)
            del bins, dig
    F, B = 28, 255
    bins, dig = hist_inputs(rng, TRAIN_ROWS + 5, F, B, np.uint8, dev)
    for cls in WINDOW_CLASSES:
        S = min(cls, TRAIN_ROWS)
        for path in ("small", "large"):
            held(bins, dig, B, 5, S, f"class{cls}/{path}", path=path)
    return out


WIDE_EXTRA = 39                # codes max_bin .. max_bin + 38: 294 bins at 255
WIDE_P2_MAX_BIN = 200          # P2's uint8 words: codes 200 .. 238


def widen_column(rng, bins: np.ndarray, col: int, axis: int, max_bin: int):
    """Column ``col`` of ``bins`` (features along ``axis``) redrawn from
    [0, max_bin + WIDE_EXTRA), its first rows every code past
    ``max_bin``, as a 294-bin categorical mapper gives at max_bin 255.
    Returns the in-range mask of that column."""
    n = bins.shape[1 - axis]
    vals = rng.randint(0, max_bin + WIDE_EXTRA, size=n)
    vals[:WIDE_EXTRA] = max_bin + np.arange(WIDE_EXTRA)
    if axis == 0:
        bins[col] = vals
    else:
        bins[:, col] = vals
    return vals < max_bin


def compare_wide_codes(seed, dev, errs):
    """K1, K2, K3 and P2 against their plain versions where one column's
    bin codes reach past ``max_bin`` (``max_bin + 38``; the 300-category
    mapper of ``phase_loader`` has 294 bins at ``max_bin=255``), with the
    wide column first and then last: each kernel skips such codes, and
    each plain version drops them too (no other feature's bins and no
    other child's change).  K1 at the Higgs root (1M x 28 uint16, both
    paths and a 4097-row window), K2 and K3 over 1M rows in three leaves
    and in the root form, the wide column categorical with 294 bins in
    K3; P2 on the probe's 2^20 rows in uint8 words at max_bin 200 (codes
    to 238) over a half window.  Each wide column's K1 digit sums equal
    the sums of its in-range rows.  Each call adds one to its counter."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    from lightgbm_tpu_torch.ops import window_hist as wh
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.tools import probe_dynhist as pd
    rng = np.random.RandomState(seed + 17)
    F, B, N = 28, 255, TRAIN_ROWS
    sp = SplitParams(TRAIN_PARAMS["min_data_in_leaf"], 1e-3)
    out, ties = {}, []

    def counted(counts, name, fn):
        before = counts()[name]
        res = fn()
        torch.cuda.synchronize()
        check(counts()[name] == before + 1,
              f"wide {name}: launch counter did not move by one")
        return res

    g = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.uniform(0.01, 0.25, size=N)
                         .astype(np.float32)).to(dev)
    w = torch.ones(N, dtype=torch.float32, device=dev)
    dig = lh.quantize_digits(g, h, w, lh.compute_scales(g, h, w))
    leaf = torch.from_numpy(rng.randint(0, 3, size=N).astype(np.int32)
                            ).to(dev)
    for col in (0, F - 1):
        label = f"col{col}"
        rm = rng.randint(0, B, size=(N, F)).astype(np.uint16)
        keep = torch.from_numpy(widen_column(rng, rm, col, 1, B)).to(dev)
        bins_rm = torch.from_numpy(rm).to(dev)
        want1 = lh.digit_histogram_plain(bins_rm, dig, B)
        check(torch.equal(want1[col].sum(-1).long(),
                          dig[keep].long().sum(0)),
              f"wide K1 {label}: the plain version kept a code past "
              f"max_bin")
        for path in K1_PATHS:
            got = counted(lh.launch_counts, "digit_histogram",
                          lambda: lh.digit_histogram(bins_rm, dig, B,
                                                     path=path))
            check(torch.equal(got, want1), f"wide K1 {label}/{path}: not "
                                           f"bit-equal to the plain version")
        got = counted(lh.launch_counts, "digit_histogram",
                      lambda: lh.digit_histogram(bins_rm, dig, B, 11, 4097))
        check(torch.equal(got, lh.digit_histogram_plain(bins_rm, dig, B, 11,
                                                        4097)),
              f"wide K1 {label}/window4097: not bit-equal")
        del bins_rm, want1
        bins = torch.from_numpy(np.ascontiguousarray(rm.T)).to(dev)
        del rm
        got2 = counted(ch.launch_counts, "children_histograms",
                       lambda: ch.children_histograms(bins, g, h, w, leaf,
                                                      1, 2, B))
        scale = abs_hist(bins, g, h, w, leaf, 1, 2, B)
        d2 = check_hist(got2, ch.build_children_histograms(
            bins, g, h, w, leaf, 1, 2, B), scale, f"wide K2 {label}")
        root = counted(ch.launch_counts, "children_histograms",
                       lambda: ch.root_histogram(bins, g, h, w, B))
        zero = torch.zeros(N, dtype=torch.int32, device=dev)
        d2r = check_hist(root, ch.build_root_histogram(bins, g, h, w, B),
                         abs_hist(bins, g, h, w, zero, 0, -2, B)[0],
                         f"wide K2 root {label}")
        nb = torch.full((F,), B, dtype=torch.int32, device=dev)
        nb[col] = B + WIDE_EXTRA
        cat = torch.zeros(F, dtype=torch.bool, device=dev)
        cat[col] = True
        totals = child_totals(g, h, w, leaf)
        args = (bins, g, h, w, leaf, 1, 2, totals, nb, cat,
                torch.ones(F, dtype=torch.bool, device=dev), B, sp)
        got3 = counted(ch.launch_counts, "fused_split_candidates",
                       lambda: ch.fused_split_candidates(*args))
        d3, r3 = check_candidates(got3, ch.fused_split_candidates_plain(
            *args), scale, totals, cat, f"wide K3 {label}", ties)
        errs["children_histograms"] = max(errs["children_histograms"], d2,
                                          d2r)
        errs["fused_split_candidates"] = max(
            errs["fused_split_candidates"], d3)
        out[label] = {"k1": 0.0, "k2": d2, "k2_root": d2r, "k3_gain": d3,
                      "k3_gain_over_tolerance": r3}
        del bins, scale, zero

    pb, pdig = pd.make_inputs(pd.N)
    n = pb.shape[0]
    pb = pb % WIDE_P2_MAX_BIN
    dmat = torch.from_numpy(pdig).to(dev)
    win = torch.tensor([pd.FIRST_OFF, n // 2], dtype=torch.int32,
                       device=dev)
    for col in (0, pd.F - 1):
        b8 = pb.copy()
        widen_column(rng, b8, col, 1, WIDE_P2_MAX_BIN)
        bw = og.pack_u8_words(torch.from_numpy(b8).to(dev))
        want = wh.window_digit_histogram_plain(bw, dmat, win, pd.F,
                                               WIDE_P2_MAX_BIN)
        lo, hi = wh.clamp_window(pd.FIRST_OFF, n // 2, n)
        check(torch.equal(want, lh.digit_histogram_plain(
            torch.from_numpy(b8).to(dev), dmat, WIDE_P2_MAX_BIN, lo,
            hi - lo)), f"wide P2 plain col{col}: not equal to K1's plain")
        got = counted(wh.launch_counts, "window_digit_histogram",
                      lambda: wh.window_digit_histogram(
                          bw, dmat, win, pd.F, WIDE_P2_MAX_BIN))
        check(torch.equal(got, want), f"wide P2 col{col}: not bit-equal to "
                                      f"the plain version")
        out[f"p2_col{col}"] = 0.0
    return {"max_abs_diff": out, "near_ties": ties,
            "codes": {"k1_k2_k3": [B, B + WIDE_EXTRA - 1],
                      "p2": [WIDE_P2_MAX_BIN,
                             WIDE_P2_MAX_BIN + WIDE_EXTRA - 1]}}


def children_inputs(rng, rows: int, F: int, max_bin: int, dtype, dev):
    """Feature-major bins [F, rows], f32 g/h/w and int32 leaf ids in
    {0, 1, 2} (a third each: 1 is the split leaf, 2 the right leaf, 0
    elsewhere), on ``dev``."""
    bins = torch.from_numpy(rng.randint(0, max_bin, size=(F, rows))
                            .astype(dtype)).to(dev)
    g = torch.from_numpy(rng.normal(size=rows).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.uniform(0.01, 0.25, size=rows)
                         .astype(np.float32)).to(dev)
    w = torch.ones(rows, dtype=torch.float32, device=dev)
    leaf = torch.from_numpy(rng.randint(0, 3, size=rows)
                            .astype(np.int32)).to(dev)
    return bins, g, h, w, leaf


def occupancy_leaves(seed, N: int, occ: int, dev):
    """[N] int32 leaf ids with min(occ, N) rows in the two children (half
    in the split leaf 1, half in the right leaf 2) at rows drawn from the
    seed, and the rest in leaf 3."""
    occ = min(occ, N)
    perm = np.random.RandomState(seed + 16).permutation(N)
    leaf = np.full(N, 3, dtype=np.int32)
    leaf[perm[:occ // 2]] = 1
    leaf[perm[occ // 2:occ]] = 2
    return torch.from_numpy(leaf).to(dev)


def child_totals(g, h, w, leaf):
    """[2, 3] (g, h, w sums) of the children leaf 1 and leaf 2."""
    return torch.stack([torch.stack([(g * m).sum(), (h * m).sum(),
                                     (w * m).sum()])
                        for m in (leaf == 1, leaf == 2)])


def abs_hist(bins, g, h, w, leaf, parent, right, max_bin):
    """The sums of |g|, |h|, |w| of every histogram entry: the scale of
    its f32 rounding error in any summation order."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    return ch.build_children_histograms(bins, g.abs(), h.abs(), w.abs(),
                                        leaf, parent, right, max_bin)


def check_hist(got, want, scale, label):
    """K2 against its plain version: within HIST_RTOL of each entry's sum
    of absolute values plus HIST_ATOL.  Returns the max absolute
    difference."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    if not got.numel():
        return 0.0
    d = (got - want).abs()
    bad = d > ch.HIST_RTOL * scale + ch.HIST_ATOL
    check(not bool(bad.any()), f"{label}: {int(bad.sum())} entries beyond "
          f"the tolerance, max abs diff {float(d.max())}")
    return float(d.max())


def check_candidates(got, want, scale, totals, is_cat, label, ties):
    """K3's [2, F, 8] against its plain version: the same finite set;
    each gain within ``gain_tolerance`` of the plain version's (the
    left-sum tolerance carried through the gain; ``scale`` [2, F, B, 3]
    from ``abs_hist``, ``totals`` [2, 3]); thresholds equal except at
    near-ties, where the two gains differ by less than the sum of both
    candidates' tolerances (appended to ``ties``); and where the
    thresholds agree, the left sums within HIST_RTOL of their sums of
    absolute values plus HIST_ATOL.  Returns (max gain difference, max
    of difference over tolerance)."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    g, w = got.cpu().double(), want.cpu().double()
    tot = totals.cpu().double()
    # prefix sums for numerical features, the bin itself for categorical
    scale = torch.where(is_cat.cpu()[None, :, None, None], scale.cpu(),
                        scale.cpu().cumsum(dim=2)).double()
    fin = torch.isfinite(w[..., 0])
    check(torch.equal(torch.isfinite(g[..., 0]), fin),
          f"{label}: finite candidates differ")

    def tol(out, c, f):
        t = int(out[c, f, 1])
        return float(ch.gain_tolerance(out[c, f, 2], out[c, f, 3],
                                       tot[c, 0], tot[c, 1],
                                       scale[c, f, t, 0], scale[c, f, t, 1]))

    worst = ratio = 0.0
    for c, f in torch.nonzero(fin).tolist():
        dg = abs(float(g[c, f, 0] - w[c, f, 0]))
        t, same = int(w[c, f, 1]), int(g[c, f, 1]) == int(w[c, f, 1])
        bound = tol(w, c, f) + (0.0 if same else tol(g, c, f))
        worst, ratio = max(worst, dg), max(ratio, dg / bound)
        check(dg <= bound, f"{label} child {c} feature {f}: gain "
                           f"{float(g[c, f, 0])} vs plain {float(w[c, f, 0])} "
                           f"(tolerance {bound})")
        if not same:
            ties.append({"at": label, "child": c, "feature": f,
                         "threshold": [int(g[c, f, 1]), t],
                         "gain": [float(g[c, f, 0]), float(w[c, f, 0])]})
            continue
        for k in range(3):
            d = abs(float(g[c, f, 2 + k] - w[c, f, 2 + k]))
            check(d <= ch.HIST_RTOL * float(scale[c, f, t, k])
                  + ch.HIST_ATOL,
                  f"{label} child {c} feature {f}: left sum {k} "
                  f"{float(g[c, f, 2 + k])} vs plain {float(w[c, f, 2 + k])}")
    return worst, ratio


def compare_children_hist(seed, dev, errs):
    """K2 and K3 against their plain versions on the grid: uint8 with 255
    bins and uint16 with 1000, F in {5, 28, 30}, N in HIST_SIZES, a third
    of the rows in each child; plus the root forms at 1M rows, and the
    1M-row full pass with OCCUPANCIES rows in the children.  Each call adds
    exactly one to its counter."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops.split import SplitParams
    rng = np.random.RandomState(seed + 15)
    sp = SplitParams(TRAIN_PARAMS["min_data_in_leaf"], 1e-3)
    out, ties = {}, []

    def counted(name, fn):
        before = ch.launch_counts()[name]
        res = fn()
        torch.cuda.synchronize()
        check(ch.launch_counts()[name] == before + 1,
              f"{name}: launch counter did not move by one")
        return res

    for dtype, max_bin in ((np.uint8, 255), (np.uint16, 1000)):
        for F in HIST_FEATURES:
            for N in HIST_SIZES:
                label = f"{dtype.__name__}/F{F}/N{N}"
                bins, g, h, w, leaf = children_inputs(rng, N, F, max_bin,
                                                      dtype, dev)
                got = counted("children_histograms",
                              lambda: ch.children_histograms(
                                  bins, g, h, w, leaf, 1, 2, max_bin))
                want = ch.build_children_histograms(bins, g, h, w, leaf, 1,
                                                    2, max_bin)
                scale = abs_hist(bins, g, h, w, leaf, 1, 2, max_bin)
                d2 = check_hist(got, want, scale, f"K2 {label}")
                totals = child_totals(g, h, w, leaf)
                nb = torch.full((F,), max_bin, dtype=torch.int32, device=dev)
                cat = torch.zeros(F, dtype=torch.bool, device=dev)
                cat[0] = True
                fm = torch.ones(F, dtype=torch.bool, device=dev)
                args = (bins, g, h, w, leaf, 1, 2, totals, nb, cat, fm,
                        max_bin, sp)
                got3 = counted("fused_split_candidates",
                               lambda: ch.fused_split_candidates(*args))
                d3, r3 = check_candidates(
                    got3, ch.fused_split_candidates_plain(*args), scale,
                    totals, cat, f"K3 {label}", ties)
                errs["children_histograms"] = max(
                    errs["children_histograms"], d2)
                errs["fused_split_candidates"] = max(
                    errs["fused_split_candidates"], d3)
                out[label] = {"k2": d2, "k3_gain": d3,
                              "k3_gain_over_tolerance": r3}
                del bins, g, h, w, leaf
    # the root forms: every row in the left child, no right child
    N, F, max_bin = max(HIST_SIZES), 28, 255
    bins, g, h, w, _ = children_inputs(rng, N, F, max_bin, np.uint8, dev)
    got = counted("children_histograms",
                  lambda: ch.root_histogram(bins, g, h, w, max_bin))
    leaf = torch.zeros(N, dtype=torch.int32, device=dev)
    scale = abs_hist(bins, g, h, w, leaf, 0, -2, max_bin)
    d2 = check_hist(got, ch.build_root_histogram(bins, g, h, w, max_bin),
                    scale[0], "K2 root")
    totals = torch.stack([torch.stack([g.sum(), h.sum(), w.sum()]),
                          torch.zeros(3, device=dev)])
    cat = torch.zeros(F, dtype=torch.bool, device=dev)
    args = (bins, g, h, w, leaf, 0, -2, totals,
            torch.full((F,), max_bin, dtype=torch.int32, device=dev), cat,
            torch.ones(F, dtype=torch.bool, device=dev), max_bin, sp)
    got3 = counted("fused_split_candidates",
                   lambda: ch.fused_split_candidates(*args))
    d3, r3 = check_candidates(got3[:1],
                              ch.fused_split_candidates_plain(*args)[:1],
                              scale[:1], totals[:1], cat, "K3 root", ties)
    check(not bool(torch.isfinite(got3[1, :, 0]).any()),
          "K3 root: the absent right child has a finite candidate")
    errs["children_histograms"] = max(errs["children_histograms"], d2)
    errs["fused_split_candidates"] = max(errs["fused_split_candidates"], d3)
    out["root"] = {"k2": d2, "k3_gain": d3, "k3_gain_over_tolerance": r3}
    # the fused grower's full pass at each leaf occupancy
    for occ in OCCUPANCIES:
        leaf = occupancy_leaves(seed, N, occ, dev)
        scale = abs_hist(bins, g, h, w, leaf, 1, 2, max_bin)
        got = counted("children_histograms",
                      lambda: ch.children_histograms(bins, g, h, w, leaf, 1,
                                                     2, max_bin))
        d2 = check_hist(got, ch.build_children_histograms(
            bins, g, h, w, leaf, 1, 2, max_bin), scale, f"K2 occ{occ}")
        totals = child_totals(g, h, w, leaf)
        args = (bins, g, h, w, leaf, 1, 2, totals,
                torch.full((F,), max_bin, dtype=torch.int32, device=dev),
                cat, torch.ones(F, dtype=torch.bool, device=dev), max_bin,
                sp)
        got3 = counted("fused_split_candidates",
                       lambda: ch.fused_split_candidates(*args))
        d3, r3 = check_candidates(
            got3, ch.fused_split_candidates_plain(*args), scale, totals, cat,
            f"K3 occ{occ}", ties)
        errs["children_histograms"] = max(errs["children_histograms"], d2)
        errs["fused_split_candidates"] = max(
            errs["fused_split_candidates"], d3)
        out[f"occupancy{occ}"] = {"k2": d2, "k3_gain": d3,
                                  "k3_gain_over_tolerance": r3}
    return {"max_abs_diff": out, "near_ties": ties,
            "tolerance": {"hist_rtol_of_abs_sums": ch.HIST_RTOL,
                          "hist_atol": ch.HIST_ATOL,
                          "gain": "children_hist.gain_tolerance"}}


def probe_windows(n: int):
    """P2's windows at ``n`` rows as (off, count): the probe's first, an
    empty one, one row, one ending at ``n``, one whose off is not a
    multiple of any probe nb, one clamped past ``n``."""
    return ((5, n // 2), (7, 0), (12345, 1), (n - 100_000, 100_000),
            (3001, 70_000), (n - 1000, 5000))


def roll_inputs(seed):
    """P1's inputs: the probe's seeded block, two more seeds, and keys
    made to break a key-and-source formulation: all equal, only INT_MIN
    and INT_MAX, already sorted ascending and descending."""
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.tools import probe_roll as pr

    def seeded(k):
        return np.random.RandomState(k).randint(
            -2**31, 2**31 - 1, (rc.WORDS, rc.NB), np.int64).astype(np.int32)
    out = {"probe_input": pr.make_input(),
           **{f"seed{seed + k}": seeded(seed + k) for k in (1, 2)}}
    base = seeded(seed + 3)
    keys = {"keys_equal": np.full(rc.NB, 7, np.int32),
            "keys_int_min_max": np.where(
                np.random.RandomState(seed + 4).rand(rc.NB) < 0.5,
                np.int32(-2**31), np.int32(2**31 - 1)).astype(np.int32),
            "keys_ascending": np.arange(rc.NB, dtype=np.int32) * 1000 - 10**6,
            "keys_descending": -np.arange(rc.NB, dtype=np.int32)}
    for label, k in keys.items():
        x = base.copy()
        x[0] = k
        out[label] = x
    return out


def device_activities(fn, tries: int = 10):
    """{name: count} of the device activities (kernels, memsets, copies)
    that ``torch.profiler`` records over one call of ``fn``, or None
    where it records none in ``tries`` attempts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            if t and t > 0:
                out[e.key[:120]] = e.count
        if out:
            return out
        time.sleep(0.2)
    return None


def compare_probes(seed, dev, errs):
    """P1 bit-equal to its plain version on ``roll_inputs`` (the probe's
    input, two more seeds, adversarial keys), and after the probe's
    50-call chain.  P2 on the probe's inputs (2^20 rows) bit-equal to its
    plain version and to K1 on the same window, for both digit layouts,
    on ``probe_windows``; one call records its one kernel and no other
    device activity (no memset, no fill; a profile that records nothing
    fails); then the probe's 10-call chained loop
    (every run: the TPU's nb sets nothing on the card) under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host read in the
    wrapper raises), replayed through the plain version.  Each call adds
    exactly one to its counter."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    from lightgbm_tpu_torch.tools import probe_dynhist as pd
    from lightgbm_tpu_torch.tools import probe_roll as pr
    out = {"roll_chain": {}, "window_digit_histogram": {}}
    for label, x in roll_inputs(seed).items():
        xt = torch.from_numpy(x).to(dev)
        before = rc.launch_counts()["roll_chain"]
        got = rc.roll_chain(xt)
        torch.cuda.synchronize()
        check(rc.launch_counts()["roll_chain"] == before + 1,
              f"P1 {label}: launch counter did not move by one")
        check(torch.equal(got, rc.roll_chain_plain(xt)),
              f"P1 {label}: not bit-equal to the plain version")
        out["roll_chain"][label] = 0.0
    xt = torch.from_numpy(pr.make_input()).to(dev)
    want = xt
    for _ in range(pr.CHAIN):
        want = rc.roll_chain_plain(want) ^ 1
    check(torch.equal(pr.chain(xt), want),
          "P1: the 50-call chain is not bit-equal to the plain chain")
    out["roll_chain"]["chain50"] = 0.0

    bins, digits = pd.make_inputs(pd.N)
    bins[pd.N - 1, 5] = bins[6000, 0] = pd.B - 1      # bin 255 lands too
    n = bins.shape[0]
    bw, dw, dmat = pd.device_inputs(bins, digits, dev)
    tb = torch.from_numpy(bins).to(dev)
    for off, count in probe_windows(n):
        win = torch.tensor([off, count], dtype=torch.int32, device=dev)
        lo, hi = wh.clamp_window(off, count, n)
        k1 = lh.digit_histogram(tb, dmat, pd.B, lo, hi - lo)
        for layout, dig in (("words", dw), ("matrix", dmat)):
            want = wh.window_digit_histogram_plain(bw, dig, win, pd.F, pd.B)
            check(torch.equal(want, k1), f"P2 plain {layout} ({off}, "
                                         f"{count}): not equal to K1")
            before = wh.launch_counts()["window_digit_histogram"]
            got = wh.window_digit_histogram(bw, dig, win, pd.F, pd.B)
            torch.cuda.synchronize()
            check(wh.launch_counts()["window_digit_histogram"]
                  == before + 1, "P2: launch counter did not move by one")
            check(torch.equal(got, want),
                  f"P2 {layout} window ({off}, {count}): not bit-equal to "
                  f"the plain version and K1")
            out["window_digit_histogram"][f"{layout}/{off}+{count}"] = 0.0
    win = torch.tensor([pd.FIRST_OFF, n // 2], dtype=torch.int32, device=dev)
    one_call = {}
    for layout, dig in (("words", dw), ("matrix", dmat)):
        acts = device_activities(lambda: wh.window_digit_histogram(
            bw, dig, win, pd.F, pd.B))
        check(acts is not None, f"P2 {layout}: the profiler recorded no "
                                f"device activity in a call")
        check(list(acts.values()) == [1]
              and all("window_hist_kernel" in k for k in acts),
              f"P2 {layout}: a call ran other than its one kernel: {acts}")
        one_call[layout] = acts
    out["one_call_device_activities"] = one_call
    count = torch.tensor(n // 2, dtype=torch.int32, device=dev)
    chained = {}
    for name, nb, matrix in pd.RUNS:
        dig = dmat if matrix else dw
        start = torch.tensor([pd.FIRST_OFF, n // 2], dtype=torch.int32,
                             device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            win, acc = pd.loop(bw, dig, start, count)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        pwin, pacc = start, 0
        for _ in range(pd.CALLS):
            o = wh.window_digit_histogram_plain(bw, dig, pwin, pd.F, pd.B)
            pwin = torch.stack([torch.remainder(o[0, 0, 0], 128), count])
            pacc += int(o[0, 0, 1])
        check(torch.equal(win, pwin) and int(acc) == pacc,
              f"P2 chained loop {name} nb={nb}: window {win.tolist()} acc "
              f"{int(acc)} against the plain replay's {pwin.tolist()} "
              f"{pacc}")
        chained[f"{name}/nb{nb}"] = {"last_window": win.tolist(),
                                     "acc": int(acc)}
    out["chained_under_sync_debug_error"] = chained
    return out


def phase_probes(reps):
    """The probes' own main path: ``python -m
    lightgbm_tpu_torch.tools.probe_roll`` and ``probe_dynhist`` as a user
    runs them (their ``main``), each with its launch counter set to 0
    just before and read just after; returns those counts."""
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    from lightgbm_tpu_torch.tools import probe_dynhist as pd
    from lightgbm_tpu_torch.tools import probe_roll as pr
    rc.reset_launch_counts()
    roll = pr.main(["--reps", str(reps)])
    torch.cuda.synchronize()
    launches = rc.launch_counts()
    wh.reset_launch_counts()
    dyn = pd.main([])
    torch.cuda.synchronize()
    launches.update(wh.launch_counts())
    check(all(v > 0 for v in launches.values()),
          f"a probe kernel was not launched on its path: {launches}")
    want_dyn = 2 * pd.CALLS * len(pd.RUNS)
    check(launches["window_digit_histogram"] == want_dyn,
          f"P2 launches {launches['window_digit_histogram']} != {want_dyn}")
    check(len({(r["last_off"], r["acc"]) for r in dyn["runs"]}) == 1,
          f"the probe's layouts disagree: {dyn['runs']}")
    emit({"phase": "probes", "launches": launches, "roll_chain": roll,
          "window_digit_histogram": dyn})
    return launches


def started(srv, timeout_s: float = 300.0):
    """``srv.start()``, then its background warm: ``serve_from_config``
    binds at once and answers 503 ``warming`` until the K4 warm ends."""
    srv.start()
    check(srv._ready.wait(timeout_s),
          f"the server's background warm did not end in {timeout_s} s")
    return srv


def _post_rows(base: str, rows: np.ndarray):
    body = json.dumps({"rows": rows.tolist()}).encode()
    req = urllib.request.Request(base + "/predict", data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    t0 = time.perf_counter()
    resp = json.loads(urllib.request.urlopen(req, timeout=120).read())
    return resp, (time.perf_counter() - t0) * 1e3


def phase_serve(seed, dev, higgs_model, higgs_grid, workdir, errs):
    """The main path; returns the launch counts it made."""
    from lightgbm_tpu_torch import Booster, obs
    from lightgbm_tpu_torch.config import Config, parse_cli_args
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.serve.server import serve_from_config

    path = f"{workdir}/higgs_model.txt"
    with open(path, "w") as fh:
        fh.write(higgs_model.save_model_to_string())
    rng = np.random.RandomState(seed + 20)
    plans = [[random_rows(rng, n, higgs_grid, tie_frac=0.02)
              for n in SERVE_SIZES] for _ in range(SERVE_CLIENTS)]
    Xb = random_rows(rng, 2000, higgs_grid, tie_frac=0.02)

    fw.reset_launch_counts()
    obs.reset()
    t0 = time.perf_counter()
    cfg = Config(parse_cli_args([
        "task=serve", f"input_model={path}", "serve_port=0",
        "serve_max_batch=4096", "serve_max_delay_ms=2"]))
    srv = serve_from_config(cfg).start()
    bound_s = time.perf_counter() - t0
    check(srv._ready.wait(300.0), "the background warm did not end")
    startup_s = time.perf_counter() - t0
    try:
        host, port = srv.address
        base = f"http://{host}:{port}"
        got = [[None] * len(SERVE_SIZES) for _ in range(SERVE_CLIENTS)]
        lat = {n: [] for n in SERVE_SIZES}
        failures = []

        def client(c):
            try:
                for j, X in enumerate(plans[c]):
                    resp, ms = _post_rows(base, X)
                    check(resp["num_rows"] == len(X), "num_rows mismatch")
                    got[c][j] = np.asarray(resp["predictions"], np.float64)
                    lat[len(X)].append(ms)
            except BaseException as exc:       # re-raised below
                failures.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not failures, f"client failures: {failures}")
        solo = [_post_rows(base, plans[0][0])[1] for _ in range(SOLO)]
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=60).read())
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=60).read())
        booster = Booster(model_file=path)
        pred = booster.predict(Xb, raw_score=True)
        torch.cuda.synchronize()
        launches = {k: v for k, v in fw.launch_counts().items()
                    if k in ("forest_walk", "forest_walk_raw")}
        check(sum(fw.launch_counts().values()) == sum(launches.values()),
              "the constant f32 forest launched another walk variant")
    finally:
        srv.stop()
    check(not any(rep.batcher._worker.is_alive()
                  for rep in srv.fleet._primary.replicas),
          "batcher worker still alive")
    try:
        urllib.request.urlopen(base + "/healthz", timeout=2)
        closed = False
    except OSError:
        closed = True
    check(closed, "server still answers after stop()")

    # every response against the plain version on the card
    from lightgbm_tpu_torch.ops.forest_walk import forest_walk_raw_plain
    cf = srv.forest
    Xall = np.concatenate([X for p in plans for X in p], axis=0)
    raw = forest_walk_raw_plain(cf.walk_tables, *cf.cut_tables(),
                                cf.device_rows(Xall))
    want = cf.transform_scores(raw)[0].double().cpu().numpy()
    flat = np.concatenate([g for row in got for g in row])
    check(flat.shape == want.shape and np.isfinite(flat).all(),
          "responses have the wrong shape or non-finite values")
    d_serve = float(np.abs(flat - want).max())
    check(d_serve <= TOL, f"served predictions vs plain: {d_serve}")
    errs["forest_walk_raw"] = max(errs["forest_walk_raw"], d_serve)
    host = booster._booster.predict_raw(Xb)[0]
    d_host = float(np.abs(pred - host).max())
    check(d_host <= 1e-5, f"Booster.predict vs f64 host walk: {d_host}")
    counters = stats["counters"]
    check(counters["serve_requests"] == SERVE_CLIENTS * len(SERVE_SIZES)
          + SOLO, f"/stats requests {counters['serve_requests']}")
    check(1 <= counters["serve_batches"] <= counters["serve_requests"],
          f"/stats batches {counters['serve_batches']} > requests")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    emit({"phase": "serve", "model": {**HIGGS, "seed": seed},
          "startup_s": startup_s, "bound_s": bound_s,
          "requests": counters["serve_requests"],
          "batches": counters["serve_batches"],
          "rows": counters["serve_rows"],
          "launches": launches,
          "latency_ms_median": {str(n): float(np.median(v))
                                for n, v in lat.items()},
          "solo_latency_ms_median_1row": float(np.median(solo)),
          "max_abs_diff_vs_plain": d_serve,
          "booster_vs_host_f64": d_host,
          "healthz": {k: health[k] for k in ("num_trees", "max_cuts",
                                             "bin_dtype", "device")}})
    return launches


def phase_serve_linear(seed, dev, lin_model, lin_grid, higgs_model,
                       workdir, errs):
    """The linear Higgs forest over HTTP, then three freezes with
    ``serve_quantize_leaves=true``; returns the launch counts of the
    linear and bf16 variants, every one of which must have run."""
    from lightgbm_tpu_torch import Booster
    from lightgbm_tpu_torch.config import Config, parse_cli_args
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.serve.forest import CompiledForest
    from lightgbm_tpu_torch.serve.server import serve_from_config
    from lightgbm_tpu_torch.utils import log

    paths = {}
    for name, g in (("linear", lin_model),
                    ("linear_tiny", scaled(lin_model, TINY_LEAVES)),
                    ("tiny", scaled(higgs_model, TINY_LEAVES))):
        paths[name] = f"{workdir}/higgs_{name}.txt"
        with open(paths[name], "w") as fh:
            fh.write(g.save_model_to_string())
    rng = np.random.RandomState(seed + 70)

    def rows(n):
        return random_rows(rng, n, lin_grid, LINEAR_CAT, 8, nan_frac=0.02,
                           tie_frac=0.02)
    plans = [[rows(n) for n in SERVE_SIZES] for _ in range(SERVE_CLIENTS)]
    Xb = rows(2000)

    def serve_config(path, *extra):
        return Config(parse_cli_args([
            "task=serve", f"input_model={path}", "serve_port=0",
            "serve_max_batch=4096", "serve_max_delay_ms=2",
            "serve_nonfinite_policy=propagate", *extra]))

    fw.reset_launch_counts()
    t0 = time.perf_counter()
    srv = started(serve_from_config(serve_config(paths["linear"])))
    startup_s = time.perf_counter() - t0
    try:
        host, port = srv.address
        base = f"http://{host}:{port}"
        got = [[None] * len(SERVE_SIZES) for _ in range(SERVE_CLIENTS)]
        lat = {n: [] for n in SERVE_SIZES}
        failures = []

        def client(c):
            try:
                for j, X in enumerate(plans[c]):
                    resp, ms = _post_rows(base, X)
                    check(resp["num_rows"] == len(X), "num_rows mismatch")
                    got[c][j] = np.asarray(resp["predictions"], np.float64)
                    lat[len(X)].append(ms)
            except BaseException as exc:       # re-raised below
                failures.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not failures, f"client failures: {failures}")
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=60).read())
        booster = Booster(model_file=paths["linear"])
        pred = booster.predict(Xb, raw_score=True)
        torch.cuda.synchronize()
    finally:
        srv.stop()
    cf = srv.forest
    Xall = np.concatenate([X for p in plans for X in p], axis=0)
    want = cf.transform_scores(fw.forest_walk_raw_plain(
        cf.walk_tables, *cf.cut_tables(), cf.device_rows(Xall)))[0]
    flat = np.concatenate([g for row in got for g in row])
    check(flat.shape == (Xall.shape[0],) and np.isfinite(flat).all(),
          "linear responses have the wrong shape or non-finite values")
    d_serve = float(np.abs(flat - want.double().cpu().numpy()).max())
    check(d_serve <= TOL, f"served linear predictions vs plain: {d_serve}")
    errs["forest_walk_raw_linear"] = max(errs["forest_walk_raw_linear"],
                                         d_serve)
    d_host = float(np.abs(pred - booster._booster.predict_raw(Xb)[0]).max())
    check(d_host <= 1e-5, f"linear Booster.predict vs f64 host walk: "
                          f"{d_host}")
    check(health["linear"] is True and health["linear_k"] == LINEAR_K
          and health["leaf_dtype"] == "float32",
          f"/healthz of the linear forest: {health}")

    # serve_quantize_leaves=true: two forests the pin accepts, one it
    # refuses (the real Higgs leaves: their summed bf16 error)
    frozen = {}
    atol = CompiledForest.QUANTIZE_LEAF_ATOL + 1e-5
    for name in ("tiny", "linear_tiny", "linear"):
        b32 = Booster(model_file=paths[name])
        f32 = CompiledForest.from_booster(b32, quantize_leaves=False)
        fell = log.counter("forest_quantize_fallback")
        qsrv = serve_from_config(serve_config(paths[name],
                                              "serve_quantize_leaves=true"))
        fell = log.counter("forest_quantize_fallback") - fell
        qsrv.stop()
        qf = qsrv.forest
        dtype = qf.info()["leaf_dtype"]
        check(dtype == ("float32" if name == "linear" else "bfloat16")
              and fell == (name == "linear"),
              f"quantize {name}: leaf_dtype {dtype}, fallbacks {fell}")
        # host f64 binning against the f64 host walk; the f32 binning of
        # the serving path against the f32 table's, which bins the same
        host = b32._booster.predict_raw(Xb)[0]
        d_bin = float(np.abs(qf.predict(Xb, raw_score=True) - host).max())
        d_dev = float(np.abs(
            qf.predict(Xb, raw_score=True, device_binning=True)
            - f32.predict(Xb, raw_score=True, device_binning=True)).max())
        check(max(d_bin, d_dev) <= atol,
              f"quantize {name}: {d_bin} from the f64 host walk, {d_dev} "
              f"from the f32 table")
        frozen[name] = {"leaf_dtype": dtype, "fallbacks": fell,
                        "binned_vs_host_f64": d_bin,
                        "raw_vs_f32_table": d_dev}
    torch.cuda.synchronize()
    launches = {k: v for k, v in fw.launch_counts().items()
                if k not in ("forest_walk", "forest_walk_raw")}
    check(all(v > 0 for v in launches.values()),
          f"a linear or bf16 walk was not launched on the main path: "
          f"{launches}")
    emit({"phase": "serve_linear", "startup_s": startup_s,
          "launches": launches,
          "latency_ms_median": {str(n): float(np.median(v))
                                for n, v in lat.items()},
          "max_abs_diff_vs_plain": d_serve,
          "booster_vs_host_f64": d_host, "quantize": frozen,
          "healthz": {k: health[k] for k in ("linear", "linear_k",
                                             "leaf_dtype", "bin_dtype",
                                             "num_features")}})
    return launches


FLEET_SHIFT = 3.0                    # the drift step's shift, in sigmas
FLEET_DRIFT_FEATURE = 5
FLEET_SPLIT = 200                    # sequential requests of the split
FLEET_LABELLED = 400                 # labelled requests of the rollback
GATHER_SIZES = (1, 256, 4096)
DELTA_ROWS = 100_000


def fingerprinted(g, grid, seed):
    """``g`` carrying a training fingerprint of ``random_rows`` from its
    own grid (the rows the drift step calls in-distribution)."""
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    X = random_rows(np.random.RandomState(seed), 50_000, grid)
    g.data_fingerprint = BinnedDataset.from_matrix(
        X, None, max_bin=255).data_fingerprint
    return g


def _request(base, path, payload=None, timeout=120):
    """(status, json body, headers, ms) of one POST (a GET without
    ``payload``); errors included."""
    req = base + path if payload is None else urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        body, code, headers = json.loads(resp.read()), resp.status, \
            resp.headers
    except urllib.error.HTTPError as err:
        body, code, headers = json.loads(err.read() or b"{}"), err.code, \
            err.headers
    return code, body, headers, (time.perf_counter() - t0) * 1e3


def _plain_answers(cf, X):
    """[N] f64 answers of ``cf``'s plain walk on the card (the serving
    path's f32 binning)."""
    from lightgbm_tpu_torch.ops.forest_walk import forest_walk_raw_plain
    raw = forest_walk_raw_plain(cf.walk_tables, *cf.cut_tables(),
                                cf.device_rows(np.asarray(X, np.float32)))
    return cf.transform_scores(raw)[0].double().cpu().numpy()


def _until(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _progress(step, t0):
    """One stderr line a step of a long phase (where a slow run is)."""
    print(f"fleet: {step} done at {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)


def _p99(ms):
    return float(np.percentile(ms, 99)) if ms else None


# a client process of the reload step: posts its rows (1, 64 and 4096 of
# them in turn, from its own offset) until the stop file appears, then
# writes (size index, generation, start time, ms, answers) per response
FLEET_CLIENT = r"""
import json, os, sys, time, urllib.error, urllib.request
import numpy as np
base, rows_path, stop, out, c = sys.argv[1:6]
plans = np.load(rows_path)
plans = [plans[f"p{j}"] for j in range(len(plans.files))]
got, failed, i = [], [], 0
while not os.path.exists(stop) or i < len(plans):
    j = (int(c) + i) % len(plans)
    req = urllib.request.Request(
        base + "/predict", data=json.dumps({"rows": plans[j].tolist()})
        .encode(), headers={"Content-Type": "application/json"})
    t0 = time.time()
    try:
        body = json.loads(urllib.request.urlopen(req, timeout=300).read())
        got.append([j, body["generation"], t0, (time.time() - t0) * 1e3,
                    body["predictions"]])
    except urllib.error.HTTPError as err:
        failed.append([j, err.code])
    i += 1
with open(out, "w") as fh:
    json.dump({"got": got, "failed": failed}, fh)
"""


def fleet_reload(seed, base, srv, grid, path_b, workdir):
    """Four client processes send 1, 64 and 4096 rows in turn while
    ``POST /reload`` swaps ``path_b`` in (processes, so that the clients'
    JSON work does not share the server's interpreter); every response
    against the plain walk of the generation it names.  Returns the
    phase line's reload part and the two generations' forests."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.serve.forest import CompiledForest
    rng = np.random.RandomState(seed + 80)
    plans = [random_rows(rng, n, grid, tie_frac=0.02) for n in SERVE_SIZES]
    rows_path = f"{workdir}/reload_rows.npz"
    np.savez(rows_path, **{f"p{j}": p for j, p in enumerate(plans)})
    stop = f"{workdir}/reload_stop"
    forests = {srv.fleet.generation: srv.forest}
    old_set = srv.fleet._primary
    load_s = []
    manager = srv.manager
    loader = manager._loader

    def timed_loader(path):
        t0 = time.perf_counter()
        out = loader(path)
        load_s.append(time.perf_counter() - t0)
        return out
    manager._loader = timed_loader
    drain0 = obs.get_histogram("phase_seconds_serve_drain") or {"sum": 0.0}
    outs = [f"{workdir}/reload_client{c}.json" for c in range(SERVE_CLIENTS)]
    procs = [subprocess.Popen([sys.executable, "-c", FLEET_CLIENT, base,
                               rows_path, stop, outs[c], str(c)])
             for c in range(SERVE_CLIENTS)]
    try:
        time.sleep(2.0)
        with _timed_calls("warmup", owner=CompiledForest) as warm:
            t_reload = time.time()
            code, body, _, reload_ms = _request(base, "/reload",
                                                {"model": path_b})
            t_done = time.time()
        manager._loader = loader
        check(code == 200, f"/reload answered {code}: {body}")
        forests[body["generation"]] = srv.forest
        time.sleep(1.0)
        open(stop, "w").close()
        for proc in procs:
            check(proc.wait(timeout=600) == 0, "a reload client failed")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    got, failures = [], []
    for out in outs:
        with open(out) as fh:
            res = json.load(fh)
        got += res["got"]
        failures += res["failed"]
    check(not failures, f"requests failed across the reload: {failures[:3]}")
    gens = sorted({g[1] for g in got})
    check(gens == sorted(forests), f"generations answered {gens}")
    want = {gen: [_plain_answers(cf, p) for p in plans]
            for gen, cf in forests.items()}
    worst = 0.0
    for j, gen, _, _, preds in got:
        preds = np.asarray(preds, np.float64)
        check(preds.shape == want[gen][j].shape and np.isfinite(preds).all(),
              "reload responses: wrong shape or non-finite")
        worst = max(worst, float(np.abs(preds - want[gen][j]).max()))
    check(worst <= TOL, f"responses vs their generation's plain walk: "
                        f"{worst}")
    check(all(not rep.batcher._worker.is_alive()
              for rep in old_set.replicas), "the old generation's "
          "batchers are still running")
    drain = obs.get_histogram("phase_seconds_serve_drain")
    drain_s = float(drain["sum"]) - float(drain0["sum"])
    during = [ms for _, _, t0, ms, _ in got
              if t0 <= t_done and t0 + ms / 1e3 >= t_reload]
    by_size = {str(n): [ms for j, _, _, ms, _ in got if j == k]
               for k, n in enumerate(SERVE_SIZES)}
    build_s, warm_s = sum(load_s), sum(warm.seconds)
    return {"requests": len(got), "failed": len(failures),
            "generations": gens, "max_abs_diff_vs_plain": worst,
            "reload_s": reload_ms / 1e3, "reload_build_s": build_s,
            "reload_warm_s": warm_s, "reload_drain_s": drain_s,
            "reload_swap_and_rest_s": reload_ms / 1e3 - build_s - warm_s
            - drain_s,
            "p99_ms_during_reload": _p99(during),
            "p99_ms_steady": _p99([ms for _, _, t0, ms, _ in got
                                   if t0 + ms / 1e3 < t_reload]),
            "requests_during_reload": len(during),
            "latency_ms_median": {n: float(np.median(v))
                                  for n, v in by_size.items()}}, forests


def fleet_latency(seed, base, grid):
    """The serve phase's protocol against the fleet (drift, lifecycle and
    a canary slot on, no canary yet): four client threads send 1, 64
    and 4096 rows once each; medians by size."""
    rng = np.random.RandomState(seed + 79)
    plans = [[random_rows(rng, n, grid, tie_frac=0.02) for n in SERVE_SIZES]
             for _ in range(SERVE_CLIENTS)]
    lat = {n: [] for n in SERVE_SIZES}
    failures = []

    def client(c):
        for X in plans[c]:
            code, _, _, ms = _request(base, "/predict", {"rows": X.tolist()})
            if code != 200:
                failures.append(code)
            lat[len(X)].append(ms)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not failures, f"fleet latency requests failed: {failures}")
    return {str(n): float(np.median(v)) for n, v in lat.items()}


def fleet_canary(seed, base, srv, grid, path_a):
    """The canary at 0.25: the exact split over sequential requests,
    ``/metrics`` with the canary's latency histogram, then the promote."""
    from lightgbm_tpu_torch.obs import prom
    code, body, _, _ = _request(base, "/reload",
                                {"model": path_a, "target": "canary"})
    check(code == 200, f"canary /reload answered {code}: {body}")
    canary_gen = body["generation"]
    primary_gen = srv.fleet.generation
    rng = np.random.RandomState(seed + 81)
    rows = random_rows(rng, FLEET_SPLIT, grid)
    models = []
    for i in range(FLEET_SPLIT):
        code, body, _, _ = _request(base, "/predict",
                                    {"rows": rows[i:i + 1].tolist()})
        check(code == 200, f"canary traffic answered {code}")
        models.append((body["model"], body["generation"]))
    # the requests routed while the canary was live (the controller may
    # promote it before the last): every fourth is the canary's
    live = [m for m, g in models if g in (primary_gen, canary_gen)]
    split = live.count("canary")
    check(len(live) >= FLEET_SPLIT // 2 and split == len(live) // 4
          and all(g == canary_gen for m, g in models if m == "canary"),
          f"canary took {split} of {len(live)} requests at 0.25")
    parsed = prom.parse_text(urllib.request.urlopen(
        base + "/metrics", timeout=60).read().decode())
    hist = prom.histogram_series(parsed, "lightgbm_tpu_serve_latency_seconds",
                                 {"model": "canary"})
    check(hist["count"] and hist["count"] >= split,
          f"/metrics canary latency histogram: {hist}")
    check(_until(lambda: (srv.controller.stats()["last_verdict"] or {})
                 .get("outcome") == "promote", 30),
          f"the good canary was not promoted: {srv.controller.stats()}")
    return {"split": f"{split}/{len(live)}",
            "canary_latency_count": hist["count"],
            "promoted_generation": srv.fleet.generation}


def fleet_rollback(seed, base, srv, grid, path_b):
    """A canary skewed by ``skew_predictions``, labels through
    ``/feedback``: rolled back for its quality; shadow scoring on."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.testing import faults
    rng = np.random.RandomState(seed + 82)
    rows = random_rows(rng, FLEET_LABELLED, grid)
    labels = (_plain_answers(srv.forest, rows) > 0.5).astype(float)
    # a window long enough for the labels (the quality gate abstains
    # until both models have lifecycle_min_samples of them)
    srv.controller.window_s = srv.controller.max_window_s = 120.0
    code, body, _, _ = _request(base, "/reload",
                                {"model": path_b, "target": "canary"})
    check(code == 200, f"canary /reload answered {code}: {body}")
    shadow0 = obs.get_counter("lifecycle_shadow_total")
    failed = 0
    with faults.skew_predictions(srv.fleet, 0.9, model="canary"):
        for i in range(FLEET_LABELLED):
            code, body, _, _ = _request(base, "/predict",
                                        {"rows": rows[i:i + 1].tolist()})
            if code != 200:
                failed += 1
                continue
            _request(base, "/feedback", {"request_id": body["request_id"],
                                         "label": labels[i]})
            if srv.controller.stats()["consecutive_rollbacks"]:
                break
        rolled = _until(lambda: srv.controller.stats()
                        ["consecutive_rollbacks"] == 1, 30)
    verdict = srv.controller.stats()["last_verdict"] or {}
    check(rolled and verdict.get("outcome") == "rollback"
          and verdict.get("reason") == "quality",
          f"the skewed canary was not rolled back for quality: {verdict}")
    check(failed == 0, f"{failed} primary/canary requests failed")
    check(not srv.fleet.has_canary(), "the canary is still routed")
    gates = (verdict.get("verdict") or {}).get("gates", {})
    return {"rollback_reason": verdict["reason"],
            "quality_gate": gates.get("quality"),
            "labelled_requests": i + 1,
            "shadow_batches": obs.get_counter("lifecycle_shadow_total")
            - shadow0,
            "shadow_dropped": obs.get_counter(
                "lifecycle_shadow_dropped_total"),
            "shadow_errors": obs.get_counter(
                "lifecycle_shadow_errors_total")}


def fleet_drift(seed, base, srv, grid, fp):
    """Rows from the training distribution, then rows with one feature
    shifted: the collector's PSI against a host recomputation."""
    from lightgbm_tpu_torch.obs import drift
    json.loads(urllib.request.urlopen(base + "/stats", timeout=60).read())
    col = srv.drift["primary"]
    col.flush()
    rng = np.random.RandomState(seed + 83)
    out = {}
    for name, shift in (("in_distribution", 0.0), ("shifted", FLEET_SHIFT)):
        X = random_rows(rng, 2048, grid)
        X[:, FLEET_DRIFT_FEATURE] += shift
        for lo in range(0, len(X), 256):
            code, _, _, _ = _request(base, "/predict",
                                     {"rows": X[lo:lo + 256].tolist()})
            check(code == 200, f"drift traffic answered {code}")
        win = col.flush()
        check(win is not None and win["rows"] == len(X),
              f"drift window rows: {win and win['rows']}")
        sent = X.astype(np.float32).astype(np.float64)
        worst = 0.0
        for feat, cnt in zip(fp.features, fp.rebin_counts(sent)):
            eg, ag = drift.coarsen(feat["counts"], cnt)
            want = round(drift.psi(eg, ag), 6)
            got = win["features"][feat["name"]]["psi"]
            worst = max(worst, abs(got - want))
        check(worst == 0.0, f"collector PSI vs host recomputation: {worst}")
        out[name] = {"top": [(f, win["features"][f]["psi"])
                             for f in win["top"]],
                     "max_psi": max(r["psi"]
                                    for r in win["features"].values())}
    lead = out["shifted"]["top"][0][0]
    check(lead == f"Column_{FLEET_DRIFT_FEATURE}",
          f"the shifted feature does not lead the top-k: {out['shifted']}")
    check(out["in_distribution"]["max_psi"] < 0.25 < out["shifted"]["top"]
          [0][1], f"drift windows: {out}")
    return out


def fleet_admission(base, srv, grid):
    """``serve_queue_depth=2`` and ``slow_replica``: 429s with a
    ``Retry-After``, the admitted requests' p99 bounded."""
    from lightgbm_tpu_torch.testing import faults
    rows = random_rows(np.random.RandomState(7), 1, grid).tolist()
    got = []
    stop = time.monotonic() + 2.0

    def client():
        while time.monotonic() < stop:
            code, _, headers, ms = _request(base, "/predict",
                                            {"rows": rows})
            got.append((code, headers.get("Retry-After"), ms))

    with faults.slow_replica(srv.fleet, 0, 0.05):
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    shed = [h for c, h, _ in got if c == 429]
    admitted = [ms for c, _, ms in got if c == 200]
    check({c for c, _, _ in got} <= {200, 429}, f"codes {set(got)}")
    check(shed and all(h is not None and int(h) >= 1 for h in shed),
          f"no 429 with Retry-After: {len(shed)} shed")
    stats = json.loads(urllib.request.urlopen(base + "/stats",
                                              timeout=60).read())
    # the server's own account (enqueue to answer, the batcher's
    # histogram); the clients' p99 adds the connection backlog's
    # retries, which the listener, not admission, decides
    p99 = stats["histograms"]["serve_latency_seconds"]["p99"] * 1e3
    check(admitted and p99 < 1000.0, f"admitted p99 {p99} ms")
    return {"requests": len(got), "shed_429": len(shed),
            "admitted": len(admitted), "admitted_p99_ms": p99,
            "admitted_p99_ms_client": _p99(admitted),
            "retry_after_s": sorted({int(h) for h in shed}),
            "serve_shed_total": stats["counters"].get("serve_shed_total")}


def fleet_watchdog(base, srv, grid):
    """``wedge_replica`` on the lone replica: ejected, 503 (never a
    hang), re-admitted on probation by the probe, healthy after clean
    requests."""
    from lightgbm_tpu_torch.testing import faults
    rows = random_rows(np.random.RandomState(8), 2, grid)
    rep = srv.fleet._primary.replicas[0]
    blocked = []
    with faults.wedge_replica(srv.fleet, 0):
        t = threading.Thread(target=lambda: blocked.append(
            _request(base, "/predict", {"rows": rows.tolist()})[0]))
        t0 = time.perf_counter()
        t.start()
        check(_until(lambda: rep.health == "ejected", 30),
              "the wedged replica was not ejected")
        eject_s = time.perf_counter() - t0
        t.join(30)
        code, _, _, ms = _request(base, "/predict", {"rows": rows.tolist()})
        check(blocked == [503] and code == 503 and ms < 5000,
              f"requests at zero healthy replicas: {blocked}, {code}, "
              f"{ms} ms")
    check(_until(lambda: rep.health == "probation", 30),
          f"the probe did not re-admit the replica: {rep.health}")
    for _ in range(3):
        code, body, _, _ = _request(base, "/predict",
                                    {"rows": rows.tolist()})
        check(code == 200, f"probation request answered {code}")
        d = float(np.abs(np.asarray(body["predictions"])
                         - _plain_answers(srv.forest, rows)).max())
        check(d <= TOL, f"probation answers vs plain: {d}")
    check(rep.health == "healthy", f"after probation: {rep.health}")
    return {"eject_s": eject_s, "zero_healthy_503_ms": ms,
            "health": rep.health}


def fleet_gather(path, fused, X):
    """``serve_walk=gather`` on the card against K4's answers (``fused``,
    the same model served by K4), both timed (host clock, synchronized;
    the gather walk syncs every level)."""
    from lightgbm_tpu_torch import Booster
    from lightgbm_tpu_torch.serve.forest import CompiledForest
    gather = CompiledForest.from_booster(Booster(model_file=path),
                                         buckets=fused.ladder.sizes,
                                         serve_walk="gather")
    check(gather.info()["serve_walk"] == "gather", "gather not selected")
    rows, worst = [], 0.0
    for n in GATHER_SIZES:
        timings = {}
        for name, cf in (("fused", fused), ("gather", gather)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cf.predict(X[:n], device_binning=True)
            torch.cuda.synchronize()
            timings[name] = ((time.perf_counter() - t0) * 1e3, out)
            print(f"fleet: {name} walk at B={n}: {timings[name][0]:.1f} ms",
                  file=sys.stderr, flush=True)
        d = float(np.abs(timings["gather"][1] - timings["fused"][1]).max())
        worst = max(worst, d)
        rows.append({"B": n, "fused_ms": timings["fused"][0],
                     "gather_ms": timings["gather"][0], "max_abs_diff": d})
    check(worst <= TOL, f"gather vs K4 answers: {worst}")
    return rows


@contextlib.contextmanager
def _cold_walk_build(workdir, tag, seconds):
    """K4's library built anew at its first use inside the block, as in a
    fresh process: an empty build directory and no loaded handle; each
    nvcc build's wall seconds are appended to ``seconds``.  The script's own build and
    handle come back after."""
    from lightgbm_tpu_torch.ops import _build
    import pathlib
    saved_dir, saved_lib = _build.BUILD_DIR, _build._libs.pop("forest_walk",
                                                              None)
    build_all = _build.build_all

    def timed(names=_build.SOURCES):
        secs = build_all(names)
        if any(secs.values()):
            seconds.append(sum(secs.values()))
        return secs

    _build.BUILD_DIR = pathlib.Path(workdir) / f"walk_build_{tag}"
    _build.build_all = timed
    try:
        yield
    finally:
        _build.build_all = build_all
        _build.BUILD_DIR = saved_dir
        _build._libs.pop("forest_walk", None)
        if saved_lib is not None:
            _build._libs["forest_walk"] = saved_lib


def _first_healthz(base, t0, timeout_s=300.0):
    """Seconds from ``t0`` to the first 200 from ``/healthz``, and its
    body."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            code, body = _request(base, "/healthz", timeout=5)[:2]
            if code == 200:
                return time.perf_counter() - t0, body
        except OSError:
            pass
        check(time.monotonic() < deadline, "/healthz never answered")
        time.sleep(0.005)


def fleet_background_warm(seed, path, grid, workdir):
    """The Higgs forest (500 trees, 255 leaves) served as ``task=serve``
    serves it, warming in the background, against the order before it
    (the warm in the foreground, then the bind).  Each mode builds K4's
    library anew at first use (``_cold_walk_build``).  In the background
    mode ``/healthz`` answers 200 ``ready: false`` and ``/readyz`` and
    ``/predict`` 503 ``warming`` while the warm is held on an event (as
    tests/test_serve_chaos.py's ``SlowWarmForest`` holds its stub), with
    no K4 launch; released, the warm launches K4 binned and raw once a
    bucket, and ``/predict`` answers equal ``Booster.predict`` on the
    same rows (TOL).  A second server stopped while its warm is held in
    the first bucket exits cleanly after that bucket's two launches and
    launches nothing more.  Returns (fields, K4 launches)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.serve.batcher import default_ladder
    from lightgbm_tpu_torch.serve.fleet import Fleet
    from lightgbm_tpu_torch.serve.server import PredictServer

    t_phase = time.perf_counter()
    max_batch = 4096
    buckets = [b for b in default_ladder() if b <= max_batch]
    booster = lt.Booster(model_file=path)
    t0 = time.perf_counter()
    forest = booster.compile(buckets=buckets)
    torch.cuda.synchronize()
    freeze_s = time.perf_counter() - t0
    # f32-exact rows: the server's f32 binning and Booster.predict's f64
    # binning then agree at every cut
    X = random_rows(np.random.RandomState(seed + 89), 64, grid).astype(
        np.float32).astype(np.float64)
    real_warmup = forest.warmup
    launches, builds = {}, []

    def take_launches():
        torch.cuda.synchronize()
        got = {k: v for k, v in fw.launch_counts().items() if v}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        fw.reset_launch_counts()
        return got

    def hold(release, started, warmed):
        def warmup(buckets=None, max_bucket=None):
            started.set()
            check(release.wait(120.0), "the held warm was never released")
            warmed.extend(buckets or [])
            return real_warmup(buckets=buckets, max_bucket=max_bucket)
        return warmup

    fw.reset_launch_counts()
    try:
        # before: the fleet warms (the build, then each bucket), then binds
        with _cold_walk_build(workdir, "foreground", builds):
            t0 = time.perf_counter()
            fleet = Fleet.build(forest, devices=[None], max_batch=max_batch,
                                max_delay_s=0.002, warm=True)
            srv = PredictServer(fleet, port=0, max_batch=max_batch,
                                max_delay_ms=2.0).start()
            try:
                healthz_fg, _ = _first_healthz(
                    f"http://{srv.address[0]}:{srv.address[1]}", t0)
            finally:
                srv.stop()
        fg = take_launches()
        check(fg == {"forest_walk": len(buckets),
                     "forest_walk_raw": len(buckets)},
              f"the foreground warm's K4 launches {fg}")
        # after: bind, then the warm on its own thread
        release, started, warmed = (threading.Event(), threading.Event(),
                                    [])
        forest.warmup = hold(release, started, warmed)
        with _cold_walk_build(workdir, "background", builds):
            t0 = time.perf_counter()
            srv = PredictServer(forest, port=0, max_batch=max_batch,
                                max_delay_ms=2.0,
                                warm_in_background=True).start()
            base = f"http://{srv.address[0]}:{srv.address[1]}"
            try:
                healthz_bg, health = _first_healthz(base, t0)
                check(health["ready"] is False,
                      f"/healthz while warming: {health}")
                check(started.wait(60.0), "the background warm never began")
                ready = _request(base, "/readyz")
                check(ready[0] == 503 and ready[1]["status"] == "warming",
                      f"/readyz while warming: {ready[:2]}")
                held = _request(base, "/predict", {"rows": X[:4].tolist()})
                check(held[0] == 503 and held[1]["error"]
                      == "server warming",
                      f"/predict while warming: {held[:2]}")
                check(not take_launches(), "K4 launched before the warm")
                t_rel = time.perf_counter()
                release.set()
                check(srv._ready.wait(300.0), "the background warm failed")
                warm_s = time.perf_counter() - t_rel
                warm = take_launches()
                check(warmed == buckets and warm == {
                    "forest_walk": len(buckets),
                    "forest_walk_raw": len(buckets)},
                    f"the background warm: buckets {warmed}, K4 {warm}")
                check(_request(base, "/readyz")[1]["status"] == "ready",
                      "/readyz after the warm")
                code, resp = _request(base, "/predict",
                                      {"rows": X.tolist()})[:2]
                check(code == 200, f"/predict after the warm: {code}")
                want = booster.predict(X)
                d_pred = float(np.abs(np.asarray(resp["predictions"])
                                      - want).max())
                check(d_pred <= TOL, f"/predict against Booster.predict: "
                                     f"{d_pred}")
            finally:
                release.set()
                srv.stop()
        take_launches()
        # a shutdown while the warm is held in its first bucket
        release, started, warmed = (threading.Event(), threading.Event(),
                                    [])
        forest.warmup = hold(release, started, warmed)
        srv = PredictServer(forest, port=0, max_batch=max_batch,
                            warm_in_background=True).start()
        check(started.wait(60.0), "the second warm never began")
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        check(_until(srv._stop_requested.is_set, 30.0), "stop() not asked")
        release.set()
        stopper.join(120.0)
        check(not stopper.is_alive() and not srv._warm_thread.is_alive(),
              "the server stopped mid-warm did not exit")
        aborted = take_launches()
        check(warmed == buckets[:1] and not srv._ready.is_set()
              and aborted == {"forest_walk": 1, "forest_walk_raw": 1},
              f"stopped mid-warm: buckets {warmed}, K4 {aborted}")
    finally:
        forest.warmup = real_warmup
    fields = {"model": {**HIGGS, "seed": seed}, "buckets": buckets,
              "freeze_s": freeze_s,
              "healthz_after_start_s": {"foreground_warm": healthz_fg,
                                        "background_warm": healthz_bg},
              "background_warm_s": warm_s, "nvcc_s": builds,
              "k4_warm_launches": warm, "predict_vs_booster": d_pred,
              "stopped_mid_warm": {"buckets": warmed,
                                   "k4_launches": aborted},
              "seconds": time.perf_counter() - t_phase}
    return fields, launches


def phase_fleet(seed, dev, higgs_model, higgs_grid, workdir):
    """The serving fleet on the card (see the module docstring); returns
    the K4 launches it made."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.config import Config, parse_cli_args
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.serve.server import serve_from_config

    t_phase = time.perf_counter()
    model_a = fingerprinted(copy.deepcopy(higgs_model), higgs_grid,
                            seed + 84)
    model_b, grid_b = random_model(seed + 1, **HIGGS)
    model_b = fingerprinted(model_b, higgs_grid, seed + 85)
    paths = {}
    for name, g in (("a", model_a), ("b", model_b)):
        paths[name] = f"{workdir}/fleet_{name}.txt"
        with open(paths[name], "w") as fh:
            fh.write(g.save_model_to_string())
    state = f"{workdir}/serve_state.json"

    def config(path, *extra):
        return Config(parse_cli_args([
            "task=serve", f"input_model={path}", "serve_port=0",
            "serve_max_batch=4096", "serve_max_delay_ms=2", *extra]))

    obs.reset()
    fw.reset_launch_counts()
    t0 = time.perf_counter()
    srv = started(serve_from_config(config(
        paths["a"], "serve_canary_weight=0.25", "lifecycle_window_s=3",
        "lifecycle_min_samples=50", "lifecycle_latency_ratio=5",
        "serve_shadow=0.5", "drift=on", "drift_window=3600",
        f"serve_state_file={state}")))
    startup_s = time.perf_counter() - t0
    base = f"http://{srv.address[0]}:{srv.address[1]}"
    try:
        latency = fleet_latency(seed, base, higgs_grid)
        _progress("startup", t_phase)
        reload, forests = fleet_reload(seed, base, srv, higgs_grid,
                                       paths["b"], workdir)
        _progress("reload", t_phase)
        canary = fleet_canary(seed, base, srv, higgs_grid, paths["a"])
        _progress("canary", t_phase)
        rollback = fleet_rollback(seed, base, srv, higgs_grid, paths["b"])
        _progress("rollback", t_phase)
        drift = fleet_drift(seed, base, srv, higgs_grid,
                            model_a.data_fingerprint)
        _progress("drift", t_phase)
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=60).read())
    finally:
        srv.stop()
    # a restart with the state file serves the last-good primary (the
    # promoted canary), not input_model
    srv = serve_from_config(config(paths["b"], f"serve_state_file={state}"))
    try:
        X = random_rows(np.random.RandomState(seed + 86), 64, higgs_grid)
        _, out = srv.forest.batched_fn()(X.astype(np.float32))
        want = {name: _plain_answers(forests[gen], X)
                for name, gen in (("a", 1), ("b", 2))}
        d_a = float(np.abs(out[0] - want["a"]).max())
        d_b = float(np.abs(out[0] - want["b"]).max())
        check(d_a <= TOL < d_b, f"restart with the state file serves "
                                f"{d_a} from fleet_a, {d_b} from fleet_b")
    finally:
        srv.stop()
    _progress("restart", t_phase)
    small = ("serve_max_batch=64", "predict_buckets=16,64")
    obs.reset()
    srv = started(serve_from_config(config(paths["a"],
                                           "serve_queue_depth=2", *small)))
    try:
        admission = fleet_admission(
            f"http://{srv.address[0]}:{srv.address[1]}", srv, higgs_grid)
    finally:
        srv.stop()
    _progress("admission", t_phase)
    srv = started(serve_from_config(config(paths["a"], "serve_watchdog_ms=20",
                                           "serve_stall_ms=300",
                                           "serve_retry_limit=0", *small)))
    try:
        watchdog = fleet_watchdog(
            f"http://{srv.address[0]}:{srv.address[1]}", srv, higgs_grid)
    finally:
        srv.stop()
    _progress("watchdog", t_phase)
    torch.cuda.synchronize()
    launches = {k: v for k, v in fw.launch_counts().items() if v}
    check(set(launches) == {"forest_walk", "forest_walk_raw"}
          and all(launches.values()),
          f"K4 launches in the fleet phase: {launches}")
    background, warm_launches = fleet_background_warm(
        seed, paths["a"], higgs_grid, workdir)
    for k, v in warm_launches.items():
        launches[k] += v
    _progress("background warm", t_phase)
    gather = fleet_gather(paths["a"], forests[1], random_rows(
        np.random.RandomState(seed + 87), 4096, higgs_grid))
    emit({"phase": "fleet", "startup_s": startup_s,
          "latency_ms_median": latency, "reload": reload,
          "canary": canary, "rollback": rollback, "drift": drift,
          "restored_primary": "promoted canary (fleet_a)",
          "admission": admission, "watchdog": watchdog, "gather": gather,
          "background_warm": background,
          "generation": stats["fleet"]["generation"],
          "counters": {k: v for k, v in stats["counters"].items()
                       if "{" not in k and k.startswith(("serve_", "life"))},
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    return launches


def fleet_train_delta(seed, workdir):
    """``train_delta`` on the training cell's ordered model with shifted
    fresh rows: the skew warning counted, the fresh fingerprint carried,
    K1 launched."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.ops import leafhist as lh
    base = f"{workdir}/higgs_ordered.txt"
    Xf, yf = make_higgs_like(DELTA_ROWS, seed=seed + 88)
    Xf[:, 0] += 2.0
    fresh = lt.Dataset(Xf, yf, params=TRAIN_PARAMS)
    warnings0 = obs.get_counter("drift_skew_warnings_total")
    lh.reset_launch_counts()
    t0 = time.perf_counter()
    booster = lt.train_delta(base, fresh, num_trees=5, params=TRAIN_PARAMS,
                             verbose_eval=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = lh.launch_counts()["digit_histogram"]
    warned = obs.get_counter("drift_skew_warnings_total") - warnings0
    fp = booster._booster.data_fingerprint
    check(warned == 1, f"skew warnings counted: {warned}")
    check(fp is not None and fp is fresh._binned.data_fingerprint
          and fp.num_rows == DELTA_ROWS, "the delta model's fingerprint")
    check("\ndata_fingerprint\n" in booster.model_to_string(),
          "the delta model text has no fingerprint section")
    check(k1 > 0, "K1 was not launched by train_delta")
    base_trees = lt.Booster(model_file=base).num_trees()
    check(booster.num_trees() == base_trees + 5, "delta tree count")
    emit({"phase": "train_delta", "rows": DELTA_ROWS, "seconds": seconds,
          "skew_warnings": warned, "launches": {"digit_histogram": k1}})
    return {"digit_histogram": k1}


class _timed_calls:
    """Record the synchronized wall time of every call of ``owner``'s
    attribute ``name`` made inside the block; ``owner`` defaults to
    ``Booster``: ``update`` (one boosting round each), ``predict``
    (``train(init_model=)``'s init scores)."""

    def __init__(self, name="update", owner=None):
        self.name, self.owner = name, owner
        self.seconds = []

    def __enter__(self):
        if self.owner is None:
            from lightgbm_tpu_torch.basic import Booster
            self.owner = Booster
        self._orig = orig = getattr(self.owner, self.name)
        rec = self.seconds

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            rec.append(time.perf_counter() - t0)
            return out
        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._orig)


def train_datasets(seed):
    """The training cell's datasets from ``seed``: (the training set, its
    valid set, the training rows, the valid rows)."""
    import lightgbm_tpu_torch as lt
    t0 = time.perf_counter()
    X, y = make_higgs_like(TRAIN_ROWS, seed=seed + 40)
    Xv, yv = make_higgs_like(VALID_ROWS, seed=seed + 41)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # raw values kept for the linear run (the constant runs ignore them);
    # the raw rows kept for the engine phase, whose init models bin them
    # again
    train_set = lt.Dataset(X, y, params={**TRAIN_PARAMS,
                                         "linear_tree": True},
                           free_raw_data=False).construct()
    valid_set = lt.Dataset(Xv, yv, reference=train_set).construct()
    binning_s = time.perf_counter() - t0
    emit({"phase": "train_data", "rows": TRAIN_ROWS,
          "valid_rows": VALID_ROWS, "features": X.shape[1], "seed": seed,
          "generate_s": gen_s, "binning_s": binning_s})
    return train_set, valid_set, X, Xv


def phase_train(seed, dev, workdir):
    """The training path at full width, once per grower of GROWERS on
    the same constructed datasets; returns the launches of each kernel
    summed over the runs that have it on their path, the launches by
    window class, (the datasets, the training and valid rows) for the
    sampling and engine phases, and the ordered run's median seconds a
    round."""
    train_set, valid_set, X, Xv = datasets = train_datasets(seed)
    launches, windows = {}, {}
    ordered = None
    for name, extra, kernel in GROWERS:
        run = train_run(name, extra, kernel, train_set, valid_set, X,
                        workdir, ordered)
        if ordered is None:
            ordered = run
        launches[kernel] = launches.get(kernel, 0) + run["launches"][kernel]
        for cls, n in run["windows"].get(kernel, {}).items():
            per = windows.setdefault(kernel, {})
            per[cls] = per.get(cls, 0) + n
    windows = {k: dict(sorted(v.items(), key=lambda kv: int(kv[0])))
               for k, v in windows.items()}
    emit({"phase": "train_windows", "runs": [g[0] for g in GROWERS],
          "launches_by_window_rows": windows})
    return launches, windows, datasets, ordered["round_s_median"]


def train_model_layer(dev, datasets, workdir):
    """The model layer's own loop on the training cell (the ordered
    grower): ``create_boosting`` + ``add_valid_dataset`` +
    ``GBDT.train(MODEL_LAYER_ROUNDS)``, its model text byte-equal to
    ``lt.train``'s with the same parameters and rounds, K1 launched once
    a leaf grown; then ``save_model_to_file``, the file loaded by a
    Booster and the valid rows predicted through K4, against the loop's
    own f64 host walk (``GBDT.predict``, 1e-5).  Returns the launches."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models import create_boosting
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    train_set, valid_set, _, Xv = datasets
    params = {**TRAIN_PARAMS, **CONST}
    ref = lt.train(params, train_set, MODEL_LAYER_ROUNDS,
                   valid_sets=[valid_set], verbose_eval=False)
    lh.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gb = create_boosting(Config({**train_set.params, **params,
                                 "task": "train"}), train_set._binned,
                         device=dev)
    gb.add_valid_dataset(valid_set._binned)
    gb.train(MODEL_LAYER_ROUNDS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = lh.launch_counts()["digit_histogram"]
    leaves = sum(int(ta.num_leaves) for ta in gb.tree_arrays)
    check(gb.iter_ == MODEL_LAYER_ROUNDS and gb.grow_kind == "ordered"
          and k1 == leaves, f"GBDT.train: {gb.iter_} rounds "
                            f"({gb.grow_kind}), K1 {k1} for {leaves} leaves")
    text = gb.save_model_to_string()
    check(text == ref.model_to_string(), "GBDT.train's model text against "
          "lt.train's: " + first_line_diff(text, ref.model_to_string()))
    path = f"{workdir}/model_layer.txt"
    gb.save_model_to_file(path)
    with open(path) as fh:
        check(fh.read() == text, "save_model_to_file wrote another text")
    fw.reset_launch_counts()
    pred = lt.Booster(model_file=path).predict(Xv)
    torch.cuda.synchronize()
    k4 = fw.launch_counts()["forest_walk"]
    d_host = float(np.abs(pred - gb.predict(Xv)[0]).max())
    check(k4 > 0 and d_host <= 1e-5,
          f"the saved model through K4 ({k4} launches) against "
          f"GBDT.predict: {d_host}")
    emit({"phase": "model_layer", "rounds": MODEL_LAYER_ROUNDS,
          "seconds_train": seconds, "k1_launches": k1,
          "text_equals_lt_train": True, "k4_launches": k4,
          "predicted_rows": len(Xv), "booster_vs_gbdt_predict": d_host,
          "best_iteration": gb.best_iteration})
    return {"digit_histogram": k1, "forest_walk": k4}


def leaf_rows_hist(bins, g, h, w, leaf_id, parent_leaf, right_leaf,
                   max_bin, acc):
    """K2's plain scatter over the two children's rows alone, added in
    dtype ``acc`` and rounded once to f32: [2, F, B, 3] (``leaf_id``
    None: every row in the left child, K2's root form).  In f64 each
    entry is its exact sum, correctly rounded.  In f32 it is the plain
    version's sum (``build_children_histograms`` also adds every row of
    neither child into one dump slot: F x N contended adds a step)."""
    F, N = bins.shape
    B, dev = max_bin, bins.device
    if leaf_id is None:
        rows = torch.arange(N, device=dev)
        child = torch.zeros(N, dtype=torch.int64, device=dev)
    else:
        right = leaf_id == right_leaf
        rows = torch.nonzero((leaf_id == parent_leaf) | right).squeeze(1)
        child = right[rows].long()
    vals = torch.stack([g, h, w], dim=-1)[rows].to(acc)
    out = torch.zeros((2 * F * B, 3), dtype=acc, device=dev)
    step = max(1, (1 << 24) // max(rows.numel(), 1))
    for f0 in range(0, F, step):
        sub = bins[f0:f0 + step]
        if sub.dtype == torch.uint16:
            sub = sub.view(torch.int16)
        sub = sub.index_select(1, rows).long() & 0xFFFF
        feat = torch.arange(f0, f0 + sub.shape[0], device=dev)[:, None]
        seg = child[None, :] * (F * B) + feat * B + sub
        out.index_add_(0, seg.reshape(-1), vals.repeat(sub.shape[0], 1))
    return out.to(torch.float32).reshape(2, F, B, 3)


class _plain_kernels:
    """Inside the block every kernel wrapper of the training path runs
    its plain PyTorch version instead (on the card, uncounted).  With
    ``acc`` the f32 histograms (K2, and K3's before its scan) are
    ``leaf_rows_hist``'s in that dtype."""

    def __init__(self, acc=None):
        self.acc = acc

    def __enter__(self):
        from lightgbm_tpu_torch.ops import children_hist as ch
        from lightgbm_tpu_torch.ops import leafhist as lh
        self._saved = (lh.digit_histogram, ch.children_histograms,
                       ch.root_histogram, ch.fused_split_candidates,
                       ch.build_children_histograms)
        lh.digit_histogram = lh.digit_histogram_plain
        ch.children_histograms = ch.build_children_histograms
        ch.root_histogram = ch.build_root_histogram
        ch.fused_split_candidates = ch.fused_split_candidates_plain
        acc = self.acc
        if acc is not None:
            def children(bins, g, h, w, leaf_id, parent, right, max_bin):
                return leaf_rows_hist(bins, g, h, w, leaf_id, parent, right,
                                      max_bin, acc)

            def root(bins, g, h, w, max_bin):
                return leaf_rows_hist(bins, g, h, w, None, 0, -2, max_bin,
                                      acc)[0]
            # K3's plain version reads build_children_histograms
            ch.children_histograms = ch.build_children_histograms = children
            ch.root_histogram = root
        return self

    def __exit__(self, *exc):
        from lightgbm_tpu_torch.ops import children_hist as ch
        from lightgbm_tpu_torch.ops import leafhist as lh
        (lh.digit_histogram, ch.children_histograms, ch.root_histogram,
         ch.fused_split_candidates, ch.build_children_histograms) = \
            self._saved


def first_flip(a, b):
    """The first node where trees ``a`` and ``b`` split otherwise: its
    index and both choices with their gains, or None."""
    for k in range(len(a.split_feature)):
        x = (int(a.split_feature[k]), int(a.split_bin[k]))
        z = (int(b.split_feature[k]), int(b.split_bin[k]))
        if x != z:
            return {"node": k,
                    "kernel": {"feature": x[0], "bin": x[1],
                               "gain": float(a.split_gain[k])},
                    "plain": {"feature": z[0], "bin": z[1],
                              "gain": float(b.split_gain[k])}}
    return None


def compare_regrown(a, b, label, exact):
    """Tree ``a`` (kernel run) against ``b`` (re-grown through the plain
    versions).  ``exact``: bit-identical.  Otherwise the structure must be
    equal up to the first near-tie flip, a node where the two runs chose
    different splits whose gains differ by less than TREE_TIE_RTOL of the
    larger (reported, and nothing after it compared); the values of an
    equal tree within 1e-3 of each field's largest magnitude.  Returns
    (flip or None, max value diff over the field's largest magnitude)."""
    from lightgbm_tpu_torch.ops.grow import pack_tree_arrays
    if exact:
        pa, pb = pack_tree_arrays(a), pack_tree_arrays(b)
        check(torch.equal(pa[0], pb[0]) and torch.equal(pa[1], pb[1]),
              f"{label}: re-grown through the plain versions, not "
              f"bit-identical")
        return None, 0.0
    flip = first_flip(a, b)
    if flip is not None:
        ga, gb = flip["kernel"]["gain"], flip["plain"]["gain"]
        check(abs(ga - gb) <= TREE_TIE_RTOL * max(abs(ga), abs(gb)),
              f"{label}: split {flip['node']} differs beyond a near-tie: "
              f"{flip}")
        return flip, 0.0
    na = [(int(a.split_feature[k]), int(a.split_bin[k]),
           int(a.left_child[k]), int(a.right_child[k]))
          for k in range(len(a.split_feature))]
    nb = [(int(b.split_feature[k]), int(b.split_bin[k]),
           int(b.left_child[k]), int(b.right_child[k]))
          for k in range(len(b.split_feature))]
    check(na == nb and int(a.num_leaves) == int(b.num_leaves)
          and torch.equal(a.leaf_count, b.leaf_count)
          and torch.equal(a.internal_count, b.internal_count),
          f"{label}: re-grown tree structure differs")
    # f32 sums in another order: a value whose sums cancel to near zero
    # keeps a small absolute error that is large beside itself, so each
    # field is held against its largest magnitude in the tree
    worst = 0.0
    for field in ("leaf_value", "internal_value", "split_gain"):
        x = getattr(a, field).double()
        z = getattr(b, field).double()
        top = float(z.abs().max())
        if top > 0:
            worst = max(worst, float((x - z).abs().max()) / top)
    check(worst <= 1e-3, f"{label}: re-grown values differ by {worst} of "
                         f"their largest magnitude")
    return None, worst


class _window_classes:
    """Inside the block, count every histogram kernel call (K1, K2, K3)
    by the power-of-two class of the rows it scans (``2^k`` counts
    windows of ``2^(k-1) + 1`` to ``2^k`` rows): K1 its window, K2 and
    K3 every row of the full pass (``root_histogram``, K2's root form,
    counts as K2).  A printed count only."""

    WRAPPED = (("leafhist", "digit_histogram", "digit_histogram"),
               ("children_hist", "children_histograms",
                "children_histograms"),
               ("children_hist", "root_histogram", "children_histograms"),
               ("children_hist", "fused_split_candidates",
                "fused_split_candidates"))

    def __init__(self):
        self.counts = {}

    def __enter__(self):
        from lightgbm_tpu_torch.ops import children_hist as ch
        from lightgbm_tpu_torch.ops import leafhist as lh
        mods = {"leafhist": lh, "children_hist": ch}
        self._saved = [(mods[m], attr, getattr(mods[m], attr))
                       for m, attr, _ in self.WRAPPED]
        for (mod, attr, fn), (_, _, name) in zip(self._saved, self.WRAPPED):
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            if name == "digit_histogram":
                start = args[3] if len(args) > 3 else kwargs.get("start", 0)
                count = args[4] if len(args) > 4 else kwargs.get("count")
                rows = args[0].shape[0] - start if count is None \
                    else int(count)
            else:
                rows = args[0].shape[1]
            cls = str(1 << (rows - 1).bit_length()) if rows > 0 else "0"
            per = self.counts.setdefault(name, {})
            per[cls] = per.get(cls, 0) + 1
            return fn(*args, **kwargs)
        return counted

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def train_run(name, extra, kernel, train_set, valid_set, X, workdir,
              ordered):
    """10 rounds of one grower.  Launch counts: the ordered grower runs
    K1 once per root and once per split, Σ over trees of the leaves
    grown; the fixed-trip ``grow_tree`` runs its kernel once for the root
    and once in each of its L - 1 steps, stop or not, so rounds × L (K3
    for fused, K2 for nocache, K1 for cached); no other histogram kernel
    runs.  Checks the re-grow of the first two trees through the plain
    versions, the saved model against
    the training score buffer, the AUC and, beside the ordered run, the
    cached trees and every constant grower's final valid AUC.  The
    ``linear`` run grows with the ordered grower and fits its leaves:
    its trees are re-grown from the run's own scores and re-fit
    (structure-equal: the fit's ``index_add_`` adds in no fixed order),
    and its saved model is also held against the f64 host walk with its
    affine part."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import grow as gr
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    params = {**TRAIN_PARAMS, **extra}
    L = params["num_leaves"]
    linear = name == "linear"
    kind = "ordered" if linear else name
    evals = {}
    lh.reset_launch_counts()
    ch.reset_launch_counts()
    og.reset_host_syncs()
    gr.reset_host_syncs()
    t0 = time.perf_counter()
    with _timed_calls() as rounds, _window_classes() as windows:
        booster = lt.train(params, train_set, TRAIN_ROUNDS,
                           valid_sets=[train_set, valid_set],
                           valid_names=["train", "valid"],
                           evals_result=evals, verbose_eval=False)
    torch.cuda.synchronize()
    launches = {**lh.launch_counts(), **ch.launch_counts()}
    check(all(sum(windows.counts.get(k, {}).values()) == v
              for k, v in launches.items()),
          f"{name}: launches by window class {windows.counts} do not add "
          f"up to {launches}")
    syncs = og.host_syncs() + gr.host_syncs()
    train_s = time.perf_counter() - t0

    gbdt = booster._booster
    check(gbdt.grow_kind == kind, f"{name}: the booster grew with "
                                  f"{gbdt.grow_kind}")
    check((gbdt._linear is not None) == linear,
          f"{name}: linear_tree setting not taken")
    grown = list(gbdt.tree_arrays)
    leaves = [int(ta.num_leaves) for ta in grown]
    check(booster.num_trees() == TRAIN_ROUNDS,
          f"{name}: {booster.num_trees()} trees after {TRAIN_ROUNDS} rounds")
    want = sum(leaves) if kind == "ordered" else TRAIN_ROUNDS * L
    check(launches[kernel] == want,
          f"{name}: {kernel} launches {launches[kernel]} != {want}")
    check(all(v == 0 for k, v in launches.items() if k != kernel),
          f"{name}: another histogram kernel ran: {launches}")

    # the first two trees again from the same gradients, through the
    # plain versions of every kernel (the first tree's gradients, +-0.5
    # and hessians 0.25, sum exactly in f32 in any order; the second's
    # do not)
    score = torch.zeros_like(gbdt.train_data.score)
    regrow = []
    for i in range(2):
        grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
        with _plain_kernels():
            ta, leaf_id, delta = gbdt._grow(grad[0], hess[0])
        if linear:
            ta = gbdt._fit_linear(ta, leaf_id, grad[0], hess[0])[0]
            # the next gradients from the run's own fitted tree (its delta
            # bit for bit), so the re-fit's atomic sums do not compound
            gbdt._add_host_tree_to(types.SimpleNamespace(
                score=score, bins=gbdt.train_data.bins,
                raw=gbdt.train_data.raw), gbdt.models[i], 0)
        else:
            score[0] += delta
        flip, rel = compare_regrown(grown[i], ta, f"{name} tree {i}",
                                    exact=name in ("ordered", "cached"))
        regrow.append({"tree": i, "near_tie_flip": flip,
                       "max_value_diff_of_field_max": rel})

    path = f"{workdir}/higgs_{name}.txt"
    booster.save_model(path)
    pred = lt.Booster(model_file=path).predict(X[:4096], raw_score=True)
    buf = gbdt.train_data.score[0, :4096].double().cpu().numpy()
    check(pred.shape == buf.shape and np.isfinite(pred).all(),
          f"{name}: saved-model predictions have the wrong shape or "
          f"non-finite values")
    d_pred = float(np.abs(pred - buf).max())
    check(d_pred <= 1e-5, f"{name}: saved model vs training score buffer: "
                          f"{d_pred}")
    beside = {}
    if linear:
        loaded = lt.Booster(model_file=path)
        d_host = float(np.abs(loaded._booster.predict_raw(X[:4096])[0]
                              - pred).max())
        check(d_host <= 1e-5, f"{name}: kernel vs f64 host walk: {d_host}")
        n_lin = sum(t.has_linear() for t in loaded._booster.models)
        check(n_lin == len(grown), f"{name}: {n_lin} linear trees saved")
        beside.update(kernel_vs_host_f64=d_host,
                      linear_fallbacks=gbdt.linear_fallbacks,
                      valid_auc_ordered=ordered["auc"]["valid"])

    auc = {k: v["auc"] for k, v in evals.items()}
    for key in ("train", "valid"):
        a = auc[key]
        check(len(a) == TRAIN_ROUNDS and all(np.isfinite(a))
              and min(a) > 0.5 and a[-1] > a[0],
              f"{name}: {key} AUC {a} is not finite, above 0.5 and rising")
    if ordered is not None and not linear:
        d_auc = abs(auc["valid"][-1] - ordered["auc"]["valid"][-1])
        check(d_auc <= 1e-3, f"{name}: valid AUC {auc['valid'][-1]} vs the "
                             f"ordered run's {ordered['auc']['valid'][-1]}")
        beside["valid_auc_diff_vs_ordered"] = d_auc
    if name == "cached":
        beside["max_rel_value_diff_vs_ordered"] = same_trees(
            grown, ordered["trees"])

    phases = profile_round(booster, name)
    out = {"phase": "train", "grower": name, "params": params,
           "rounds": TRAIN_ROUNDS, "train_s": train_s,
           "round_s": rounds.seconds,
           "round_s_median_3_10": float(np.median(rounds.seconds[2:])),
           "leaves_per_tree": leaves,
           "host_syncs_per_tree": syncs / len(grown),
           "launches": launches,
           "launches_by_window_rows": windows.counts, "regrown": regrow,
           "saved_model_vs_score_buffer": d_pred,
           "auc_train": auc["train"], "auc_valid": auc["valid"],
           **beside, "profile_round": phases}
    emit(out)
    return {"launches": launches, "auc": auc, "trees": grown,
            "windows": windows.counts,
            "round_s_median": out["round_s_median_3_10"]}


def same_trees(trees, ref):
    """Every tree structure-equal to the reference run's, values within
    1e-6 relative (the JAX package's ordered-against-cached tolerance);
    returns the largest relative value difference."""
    exact = ("num_leaves", "split_feature", "split_bin", "left_child",
             "right_child", "internal_count", "leaf_count", "leaf_parent",
             "leaf_depth")
    worst = 0.0
    for i, (a, b) in enumerate(zip(trees, ref)):
        for field in exact:
            check(torch.equal(getattr(a, field), getattr(b, field)),
                  f"cached tree {i}: {field} differs from the ordered run's")
        for field in ("leaf_value", "internal_value", "split_gain"):
            x, z = getattr(a, field).double(), getattr(b, field).double()
            d = (x - z).abs()
            check(bool((d <= 1e-6 * z.abs() + 1e-7).all()),
                  f"cached tree {i}: {field} beyond 1e-6 of the ordered "
                  f"run's")
            worst = max(worst, float((d / z.abs().clamp(min=1e-12)).max()))
    return worst


def profile_round(booster, name):
    """One extra boosting round with CUDA events around every histogram
    kernel call (K1, K2 or K3), every split scan (``find_best_split``, or
    the across-feature ``combine_feature_candidates`` after K3) and, for
    the ordered grower, every partition: the summed event times of each,
    beside the round's synchronized wall time."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import grow as gr
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    spans = {}

    def wrap(fn, key):
        spans.setdefault(key, [])

        def timed(*args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kwargs)
            e.record()
            spans[key].append((s, e))
            return out
        return timed

    targets = {"ordered": ((lh, "digit_histogram", "k1"),
                           (og, "_partition", "partition"),
                           (og, "find_best_split", "split_scan")),
               "cached": ((lh, "digit_histogram", "k1"),
                          (gr, "find_best_split", "split_scan")),
               "cached_bundled": ((lh, "digit_histogram", "k1"),
                                  (gr, "expand_digit_sums", "expansion"),
                                  (gr, "find_best_split", "split_scan"),
                                  (gr, "_feature_bins", "partition_bins")),
               "linear": ((lh, "digit_histogram", "k1"),
                          (og, "_partition", "partition"),
                          (og, "find_best_split", "split_scan"),
                          (booster._booster, "_fit_linear", "linear_fit")),
               "fused": ((ch, "fused_split_candidates", "k3"),
                         (gr, "combine_feature_candidates", "split_scan")),
               "nocache": ((ch, "children_histograms", "k2"),
                           (ch, "root_histogram", "k2"),
                           (gr, "find_best_split", "split_scan"))}[name]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for mod, attr, key in targets:
        setattr(mod, attr, wrap(getattr(mod, attr), key))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    out = {"round_s": wall}
    rest = wall * 1e3
    for key, pairs in spans.items():
        ms = sum(s.elapsed_time(e) for s, e in pairs)
        rest -= ms
        out[key] = {"calls": len(pairs), "ms": ms,
                    "share": ms * 1e-3 / wall}
    out["rest"] = {"ms": rest, "share": rest * 1e-3 / wall}
    return out


# ---------------------------------------------------------------------------
# the repo's example confs through the CLI, card against CPU


@contextlib.contextmanager
def in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def run_main(main, argv) -> str:
    """``main(argv)`` (a CLI's entry point) with its log captured; it
    must exit 0.  Returns the log."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        check(main(argv) == 0, f"cli {argv}: exit code")
    return buf.getvalue()


def _cli(argv) -> str:
    from lightgbm_tpu_torch import cli
    return run_main(cli.main, argv)


def copy_example(name: str, folder: str, work: str) -> str:
    """The files of ``examples/<folder>`` copied into ``work``; returns
    the train conf to run, ``train.conf`` as written."""
    shutil.copytree(os.path.join(REPO, "examples", folder), work,
                    dirs_exist_ok=True)
    return "train.conf"


_ROUND_LINE = re.compile(r"\[(\d+)\]\t(.*)")


def round_metrics(log_text: str) -> dict:
    """{(round, data, metric): value} of a CLI's round lines
    (``print_evaluation``'s ``[i]\t<data>'s <metric>: <value>\t...``,
    the same in both packages)."""
    out = {}
    for ln in log_text.splitlines():
        m = _ROUND_LINE.search(ln)
        if m is None:
            continue
        for part in m.group(2).split("\t"):
            who, value = part.rsplit(": ", 1)
            data, metric = who.split("'s ")
            out[(int(m.group(1)), data, metric)] = float(value)
    return out


def tree_sections(text: str):
    """[{field: value}] of every tree of a model text."""
    out, cur = [], None
    for ln in text.splitlines():
        if ln.startswith("Tree="):
            cur = {}
            out.append(cur)
        elif ln.startswith("feature importances"):
            cur = None
        elif cur is not None and "=" in ln:
            k, v = ln.split("=", 1)
            cur[k] = v
    return out


def trees_text(model_text: str, first: int, last: int) -> str:
    """The text of trees ``first`` to ``last - 1`` of a model."""
    start = model_text.index(f"Tree={first}\n")
    end = (model_text.index(f"Tree={last}\n") if f"Tree={last}\n"
           in model_text else model_text.index("\nfeature importances"))
    return model_text[start:end]


def _field(tree, name):
    return np.array(tree[name].split(), dtype=np.float64) \
        if tree.get(name) else np.zeros(0)


def compare_model_texts(a_text: str, b_text: str, label: str,
                        names=("card", "cpu"), tie_rtol=TREE_TIE_RTOL,
                        leaf_rtol=EXAMPLE_LEAF_RTOL):
    """Trees of model ``a`` against the reference ``b``: structure-equal
    (thresholds to 1e-9 relative), leaf values within ``leaf_rtol`` of
    the tree's largest, up to the first split where the two choices
    differ, which must be an f32 near-tie (gains within ``tie_rtol``,
    the nodes before it equal; reported under ``names``, and no later
    tree compared: every later score depends on it).  Returns (trees
    compared, the flip or None, the largest leaf-value difference over
    the tree's largest leaf)."""
    ta, tb = tree_sections(a_text), tree_sections(b_text)
    check(len(ta) == len(tb) > 0, f"{label}: {len(ta)} vs {len(tb)} trees")
    worst = 0.0
    for i, (a, b) in enumerate(zip(ta, tb)):
        fa, fb = _field(a, "split_feature"), _field(b, "split_feature")
        ha, hb = _field(a, "threshold"), _field(b, "threshold")
        n = min(len(fa), len(fb))
        differ = [k for k in range(n) if fa[k] != fb[k]
                  or not np.isclose(ha[k], hb[k], rtol=1e-9, atol=0)]
        if differ or len(fa) != len(fb):
            k = differ[0] if differ else n
            check(k < n, f"{label} tree {i}: leaf counts differ with no "
                         f"split that does")
            ga, gb = _field(a, "split_gain")[k], _field(b, "split_gain")[k]
            flip = {"tree": i, "node": k,
                    names[0]: {"feature": int(fa[k]), "gain": float(ga)},
                    names[1]: {"feature": int(fb[k]), "gain": float(gb)}}
            for name in ("left_child", "right_child", "decision_type"):
                check(_field(a, name)[:k].tolist()
                      == _field(b, name)[:k].tolist(),
                      f"{label}: {name} before the flip {flip}")
            check(abs(ga - gb) <= tie_rtol * max(abs(ga), abs(gb)),
                  f"{label}: split differs beyond a near-tie: {flip}")
            print(f"{label}: near-tie flip {flip}", file=sys.stderr)
            return i, flip, worst
        for name in ("num_leaves", "left_child", "right_child",
                     "decision_type", "leaf_count", "internal_count"):
            check(a.get(name) == b.get(name), f"{label} tree {i}: {name}")
        la, lb = _field(a, "leaf_value"), _field(b, "leaf_value")
        rel = float(np.abs(la - lb).max() / max(np.abs(lb).max(), 1e-12))
        check(rel <= leaf_rtol, f"{label} tree {i}: leaf values {rel}")
        worst = max(worst, rel)
    return len(ta), None, worst


def rank_metric_from_models(work, conf, key, models, digits=None):
    """The ranking metric ``key`` = (round, data, name) recomputed on the
    CPU from each model's raw scores after ``round`` rounds (scores
    rounded to ``digits`` significant digits first, when given), by the
    port's metric on the port's reading of the data file."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config, parse_config_file
    from lightgbm_tpu_torch.io.parser import parse_file
    from lightgbm_tpu_torch.metric import create_metric
    rnd, data, name = key
    with in_dir(work):
        params = parse_config_file(conf)
        cfg = Config(params)
        path = cfg.data if data == "training" else \
            cfg.valid_data[int(data.split("_")[1]) - 1]
        ds = lt.Dataset(path, params=params).construct()._binned
        X = parse_file(path, cfg.has_header, 0, ds.num_total_features)[1]
        out = []
        for model in models:
            raw = lt.Booster(model_file=model, device="cpu").predict(
                X, num_iteration=rnd, raw_score=True).reshape(1, -1)
            if digits is not None:
                raw = np.array([[float(f"{v:.{digits}g}") for v in raw[0]]])
            m = create_metric(name.split("@")[0], cfg)
            m.init(ds.metadata, ds.num_data)
            out.append(dict(zip(m.names, m.eval(raw)))[name])
    return out


def compare_round_metrics(a, b, work, conf, label, models,
                          names=("card", "cpu")):
    """Every round's every metric of log ``a`` against the reference
    ``b`` (``round_metrics`` dicts) within 1e-4.  A ranking metric (auc,
    ndcg, map) jumps where two scores tie, and rows that score alike in
    exact arithmetic tie or not by the last bit of f32 sums summed in
    another order; such a metric beyond 1e-4 passes only when its
    recomputation from the two ``models`` (a's, b's) gives the two
    logged values (1e-5) and agrees within 1e-4 once the scores are
    rounded to 6 significant digits, which merges such ties.  Returns
    (max difference within 1e-4, the ties so explained)."""
    check(set(a) == set(b) and b, f"{label}: metric sets differ")
    worst, ties = 0.0, []
    for key in sorted(b):
        d = abs(a[key] - b[key])
        if d <= 1e-4:
            worst = max(worst, d)
            continue
        check(key[2].split("@")[0] in ("auc", "ndcg", "map"),
              f"{label}: {key} {names[0]} {a[key]} {names[1]} {b[key]}")
        exact = rank_metric_from_models(work, conf, key, models)
        check(abs(exact[0] - a[key]) <= 1e-5
              and abs(exact[1] - b[key]) <= 1e-5,
              f"{label}: {key} recomputed {exact}")
        rounded = rank_metric_from_models(work, conf, key, models, 6)
        check(abs(rounded[0] - rounded[1]) <= 1e-4,
              f"{label}: {key} beyond 1e-4 after rounding: {rounded}")
        ties.append({"metric": list(key), names[0]: a[key],
                     names[1]: b[key], "rounded_6_digits": rounded})
        print(f"{label}: ranking metric at a near-tie of scores "
              f"{ties[-1]}", file=sys.stderr)
    return worst, ties


# ---------------------------------------------------------------------------
# the device-memory gate


@contextlib.contextmanager
def memory_override(limit):
    """``LGBT_DEVICE_MEMORY_BYTES=limit`` inside the block (the gate's
    budget), unset after it."""
    os.environ["LGBT_DEVICE_MEMORY_BYTES"] = str(int(limit))
    try:
        yield
    finally:
        os.environ.pop("LGBT_DEVICE_MEMORY_BYTES", None)


def _mem_params(extra):
    return {**TRAIN_PARAMS, **extra}


def _tree_arrays(booster):
    return list(booster._booster.tree_arrays)


def memory_growers(train_set, dev):
    """Each grower's gate estimate beside the peak its construction and
    MEM_ROUNDS rounds allocate; returns {grower: (estimate, peak,
    steady, tree arrays)}."""
    import gc
    import lightgbm_tpu_torch as lt
    out = {}
    for name, extra, _ in MEM_GROWERS:
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        b = lt.Booster(params=_mem_params(extra), train_set=train_set,
                       device=dev)
        steady = torch.cuda.memory_allocated(dev) - base
        for _ in range(MEM_ROUNDS):
            b.update()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        est = b._booster._train_mem_est
        check(peak > 0, f"memory: {name} measured no allocation")
        check(est >= peak, f"memory: {name}'s estimate {est} B is below "
                           f"its measured peak {peak} B")
        check(est <= 64 * peak, f"memory: {name}'s estimate {est} B is "
                                f"over 64x its measured peak {peak} B")
        out[name] = (est, peak, steady, _tree_arrays(b),
                     b._booster.grow_kind)
        del b
    return out


def fill_cache_slack(dev, ballast, smallest: int = 512) -> None:
    """Tensors (appended to ``ballast``) into the caching allocator's
    reserved but free blocks, largest first, so that later allocations
    find no cached room.  A size no cached block holds is served from a
    new segment; the loop then halves the size and ends below
    ``smallest`` bytes."""
    size = 1 << 30
    while size >= smallest:
        slack = (torch.cuda.memory_reserved(dev)
                 - torch.cuda.memory_allocated(dev))
        if slack < size:
            size //= 2
            continue
        before = torch.cuda.memory_reserved(dev)
        ballast.append(torch.empty(size, dtype=torch.uint8, device=dev))
        if torch.cuda.memory_reserved(dev) > before:
            size //= 2


def memory_real_oom(train_set, dev, transient):
    """A real CUDA OOM: a ballast tensor leaves the card nearly full, an
    override admits the run, one round raises DeviceOOM; freed, the same
    booster trains on."""
    import gc
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.utils import resource
    with memory_override(1 << 50):
        b = lt.Booster(params=_mem_params(CONST), train_set=train_set,
                       device=dev)
        b.update()
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        leave = min(MEM_LEAVE_MAX, max(transient // 2, 1 << 20))
        # first the allocator's reserved but free blocks (earlier phases
        # leave some that empty_cache cannot return), else the round finds
        # its room there; then the card in 1 GiB pieces, then the rest
        # rounded down to 2 MiB
        ballast = []
        slack = (torch.cuda.memory_reserved(dev)
                 - torch.cuda.memory_allocated(dev))
        fill_cache_slack(dev, ballast)
        while True:
            room = torch.cuda.mem_get_info(dev)[0] - leave
            if room < (2 << 20):
                break
            size = min(room, 1 << 30) & ~((2 << 20) - 1)
            ballast.append(torch.empty(size, dtype=torch.uint8, device=dev))
        free_left = torch.cuda.mem_get_info(dev)[0]
        err = None
        try:
            b.update()
        except resource.DeviceOOM as exc:
            err = exc
        check(err is not None, f"memory: a round with {free_left} B free "
                               f"raised no DeviceOOM")
        msg = str(err)
        check(err.program in ("bag_mask", "train_gradients", "train_step",
                              "score_update", "valid_replay")
              and err.shapes and "admission estimate:" in msg
              and "bins_device=" in msg and "memwatch: device_in_use=" in msg,
              f"memory: the DeviceOOM lacks its diagnosis: {msg[:600]}")
        it0 = b._booster.iter_
        del ballast
        gc.collect()
        torch.cuda.empty_cache()
        b.update()
        torch.cuda.synchronize(dev)
        check(b._booster.iter_ == it0 + 1 and it0 == 1,
              f"memory: after the OOM the booster did not train on "
              f"(iterations {it0} -> {b._booster.iter_})")
    return {"free_bytes_left": int(free_left),
            "cache_slack_bytes": int(slack), "program": err.program,
            "shapes": err.shapes, "message": msg[:900],
            "iterations_after": int(b._booster.iter_)}


def phase_memory(datasets, dev):
    """The device-memory gate on the train phase's datasets (module
    docstring, ``memory``)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.gbdt import _device_memory_limit
    from lightgbm_tpu_torch.utils import resource
    train_set, valid_set, _, _ = datasets
    t0 = time.perf_counter()
    runs = memory_growers(train_set, dev)
    total = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    budget = _device_memory_limit(dev)
    # refused before training allocates
    full = runs["ordered"][0]
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    refused = None
    with memory_override(full // 2):
        try:
            lt.Booster(params=_mem_params(CONST), train_set=train_set,
                       device=dev)
        except resource.MemoryBudgetExceeded as exc:
            refused = exc
    check(refused is not None, "memory: an override of half the estimate "
                               "was admitted")
    check(torch.cuda.memory_allocated(dev) == before,
          "memory: the refused construction allocated on the card")
    check("exceeds the device budget" in str(refused)
          and "histogram_cache=" in str(refused),
          f"memory: the refusal lacks its table: {refused}")
    # between the no-cache floor and the full estimate: hist_cache
    floor = runs["nocache"][0]
    check(floor < full, f"memory: no-cache floor {floor} B not below the "
                        f"estimate {full} B")
    with memory_override((floor + full) // 2):
        b = lt.Booster(params=_mem_params({**CONST,
                                           "memory_policy": "degrade"}),
                       train_set=train_set, device=dev)
        check(b._booster._degrade_steps == ("hist_cache",)
              and b._booster.grow_kind == "nocache",
              f"memory: the ladder took {b._booster._degrade_steps}")
        for _ in range(MEM_ROUNDS):
            b.update()
    for i, (x, z) in enumerate(zip(_tree_arrays(b), runs["nocache"][3])):
        compare_regrown(x, z, f"memory: degraded tree {i}", exact=False)
    del b
    # the real OOM: the ordered run's transient bytes set the ballast
    est_o, peak_o, steady_o = runs["ordered"][:3]
    oom = memory_real_oom(train_set, dev, peak_o - steady_o)
    # a valid set past the budget
    with memory_override(full + 1000):
        b = lt.Booster(params=_mem_params(CONST), train_set=train_set,
                       device=dev)
        msg = None
        try:
            b.add_valid(valid_set, "valid")
        except lt.LightGBMError as exc:
            msg = str(exc)
        check(msg is not None and "attaching this validation set" in msg
              and "over the budget" in msg,
              f"memory: the valid set past the budget was attached: {msg}")
        del b
    emit({"phase": "memory", "rounds": MEM_ROUNDS,
          "growers": {name: {"estimate_bytes": r[0], "peak_bytes": r[1],
                             "construction_bytes": r[2],
                             "estimate_over_peak": r[0] / r[1],
                             "grow_kind": r[4]}
                      for name, r in runs.items()},
          "budget_bytes": budget, "nvidia_smi_memory_total": total,
          "refused_at_bytes": full // 2, "refusal": str(refused)[:400],
          "degrade_budget_bytes": (floor + full) // 2, "oom": oom,
          "valid_refusal": msg[:300], "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# the distributed learners


def _dist_data(seed):
    import lightgbm_tpu_torch as lt
    X, y = make_higgs_like(TRAIN_ROWS, seed=seed + 40)
    Xv, yv = make_higgs_like(VALID_ROWS, seed=seed + 41)
    train_set = lt.Dataset(X, y, params=TRAIN_PARAMS).construct()
    valid_set = lt.Dataset(Xv, yv, reference=train_set).construct()
    return train_set, valid_set


def _timed_rounds(b, dev, rounds):
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        b.update()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return times


def dist_k2_shard(gb, rank, world):
    """K2 (children and root form) on this rank's row shard of the
    booster's bins and its next round's gradients, against its plain
    version added in f64 and rounded once."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    bins = gb.train_data.bins
    N = bins.shape[1]
    n_loc = -(-N // world)
    lo, hi = rank * n_loc, min((rank + 1) * n_loc, N)
    shard = bins[:, lo:hi].contiguous()
    g, h = gb._gradients()
    g, h = g[0, lo:hi].contiguous(), h[0, lo:hi].contiguous()
    w = torch.ones_like(g)
    B = gb.grow_params.max_bin
    leaf = shard[0].to(torch.int32) % 3
    out = {}
    for form, args in (("children", (leaf, 0, 1)), ("root", (None, 0, -2))):
        before = ch.launch_counts()["children_histograms"]
        if args[0] is None:
            got = ch.root_histogram(shard, g, h, w, B)[None]
        else:
            got = ch.children_histograms(shard, g, h, w, *args, B)
        torch.cuda.synchronize()
        check(ch.launch_counts()["children_histograms"] == before + 1,
              f"distributed: K2 ({form}) on the shard launched no kernel")
        want = leaf_rows_hist(shard, g, h, w, *args, B, torch.float64)
        if args[0] is None:
            want = want[:1]
            scale = abs_hist(shard, g, h, w, torch.zeros_like(leaf), 0, -2,
                             B)[:1]
        else:
            scale = abs_hist(shard, g, h, w, *args, B)
        label = f"distributed: K2 ({form}) on rank {rank}'s shard"
        err = check_hist(got, want, scale, label)
        equal = int((got == want).sum())
        check(equal == got.numel(), f"{label}: {got.numel() - equal} of "
                                    f"{got.numel()} sums are not bit-equal "
                                    f"to the f64 sum rounded once")
        out[form] = {"rows": hi - lo, "max_abs_diff": err,
                     "entries": int(got.numel()), "bit_equal_entries": equal}
    return out


@contextlib.contextmanager
def data_hist_reduce(mode):
    """The booster's data-parallel grower built by
    ``make_parallel_grow(..., hist_reduce=mode)`` (the learner's
    ``reduce_scatter`` by default; ``psum`` is a grower argument, not a
    config key, in both packages)."""
    import functools
    from lightgbm_tpu_torch import parallel
    orig = parallel.make_parallel_grow
    parallel.make_parallel_grow = functools.partial(orig, hist_reduce=mode)
    try:
        yield
    finally:
        parallel.make_parallel_grow = orig


def profile_dist_round(booster):
    """One extra distributed round: CUDA events around every K2 call and
    every split scan of the rank's strategy, and every collective timed
    on the host clock between two synchronizations of the card, so that
    its time holds no queued kernel: the collective itself and the wait
    for the peer rank.  Returns the sums beside the round's synchronized
    wall time, and each collective's kind and ms in call order (the same
    order on every rank)."""
    from lightgbm_tpu_torch.parallel import comm
    spans = {"k2": [], "split_scan": []}
    colls = []

    def evented(fn, key):
        def timed(*args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            res = fn(*args, **kwargs)
            e.record()
            spans[key].append((s, e))
            return res
        return timed

    def synced(fn):
        def timed(kind, run, nbytes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(kind, run, nbytes)
            torch.cuda.synchronize()
            colls.append((kind, (time.perf_counter() - t0) * 1e3))
        return timed

    targets = (("children_histograms", "k2"), ("root_histogram", "k2"),
               ("find_best_split", "split_scan"),
               ("per_feature_scan", "split_scan"))
    saved = [(attr, getattr(comm, attr)) for attr, _ in targets] \
        + [("_collective", comm._collective)]
    for attr, key in targets:
        setattr(comm, attr, evented(getattr(comm, attr), key))
    comm._collective = synced(comm._collective)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for attr, fn in saved:
            setattr(comm, attr, fn)
    out = {"round_s": wall, "collective_ms": sum(ms for _, ms in colls),
           "collective_calls": [[k, ms] for k, ms in colls]}
    for key, pairs in spans.items():
        out[key] = {"calls": len(pairs),
                    "ms": sum(s.elapsed_time(e) for s, e in pairs)}
    return out


def dist_rank(job_path) -> int:
    """One rank of the distributed phase (``--dist-rank JOB``)."""
    import lightgbm_tpu_torch as lt
    import torch.distributed as dist
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.parallel import comm
    from lightgbm_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed, process_rank_world)
    with open(job_path) as fh:
        job = json.load(fh)
    cfg = Config({"num_machines": 2, "tree_learner": "data",
                  "machine_list_file": job["mlist"],
                  "distributed_heartbeat_ms": 0})
    check(maybe_initialize_distributed(cfg), "distributed: no group")
    rank, world = process_rank_world()
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    train_set, valid_set = _dist_data(job["seed"])
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev), "data_s": time.perf_counter() - t0,
           "runs": {}}
    for name, extra, reduce in DIST_RUNS:
        ch.reset_launch_counts()
        comm.reset_stats()
        with data_hist_reduce(reduce):
            b = lt.Booster(params={**TRAIN_PARAMS, **extra,
                                   "num_machines": 2},
                           train_set=train_set, device=dev)
        b.add_valid(valid_set, "valid")
        times = _timed_rounds(b, dev, DIST_ROUNDS)
        st = comm.stats()
        gb = b._booster
        check(gb.grow_kind == "parallel_" + extra["tree_learner"],
              f"distributed: {name} grew with {gb.grow_kind}")
        tree_bytes = sum(v for k, v in st["bytes"].items()
                         if k in gb._comm_traffic) / DIST_ROUNDS
        out["runs"][name] = {
            "round_s": times,
            "k2_launches": ch.launch_counts()["children_histograms"],
            "collective_bytes_per_tree": tree_bytes,
            "traffic_per_tree_bytes": gb._comm_traffic_totals[1],
            "calls": st["calls"], "bytes": st["bytes"],
            "valid_auc": dict((n, v) for n, v, _ in
                              gb.eval_set("valid_1"))["auc"]}
        with open(os.path.join(job["workdir"],
                               f"dist_{name}_r{rank}.txt"), "w") as fh:
            fh.write(b.model_to_string())
        torch.save([ta._asdict() for ta in gb.tree_arrays],
                   os.path.join(job["workdir"], f"dist_{name}_r{rank}.pt"))
        if name == "data_reduce_scatter":
            out["k2_shard"] = dist_k2_shard(gb, rank, world)
        # after the model is written: the profiled round is a 4th tree
        out["runs"][name]["profile"] = profile_dist_round(b)
        del b, gb
    with open(os.path.join(job["workdir"], f"dist_rank{rank}.json"),
              "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()
    return 0


def _dist_cli(workdir):
    """``examples/parallel_learning/train.conf`` through the CLI: as
    written but for DIST_CLI_TREES trees (in this process), then as two
    CLI processes with a machine list."""
    from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks
    root = os.path.join(workdir, "parallel_cli")
    work = os.path.join(root, "parallel_learning")
    copy_example("parallel_learning", "parallel_learning", work)
    copy_example("binary", "binary_classification",
                 os.path.join(root, "binary_classification"))
    t0 = time.perf_counter()
    # in this process (without a machine list the CLI joins no group):
    # a process of its own would cost the run a torch import and a CUDA
    # context
    with in_dir(work):
        one = _cli(["config=train.conf", f"num_trees={DIST_CLI_TREES}"])
    one_s = time.perf_counter() - t0
    check("requested but only 1 device(s) available; falling back to "
          "serial" in one,
          "distributed: the conf as written did not warn of the serial "
          "fallback")
    mlist = machine_list(os.path.join(work, "mlist.txt"), 2)
    argv = [[sys.executable, "-m", "lightgbm_tpu_torch", "config=train.conf",
             "num_machines=2", f"machine_list_file={mlist}",
             f"num_trees={DIST_CLI_TREES}", f"output_model=model_{r}.txt"]
            for r in range(2)]
    t0 = time.perf_counter()
    codes, outs = run_ranks(argv, timeout=DIST_CLI_TIMEOUT_S,
                            env=dict(os.environ, PYTHONPATH=REPO), cwd=work)
    two_s = time.perf_counter() - t0
    check(codes == [0, 0], f"distributed: the two CLI ranks exited "
                           f"{codes}: {outs[0][-1500:]} {outs[1][-1500:]}")
    texts = [open(os.path.join(work, f"model_{r}.txt")).read()
             for r in range(2)]
    check(texts[0] == texts[1], "distributed: the two CLI ranks wrote "
                                "different models")
    check("Using data-parallel tree learner over 2 ranks" in outs[0],
          "distributed: the CLI ranks did not train data-parallel")
    return {"as_written_s": one_s, "two_process_s": two_s,
            "two_process_trees": DIST_CLI_TREES,
            "backend_line": [ln for ln in outs[0].splitlines()
                             if "torch.distributed: rendezvous" in ln][:1]}


def dist_profile(per):
    """The ranks' profiled rounds side by side: each one's round, K2,
    split-scan and collective ms, and the collectives' ms summed over
    calls of the smaller of the two ranks' times for each call (the
    rank that came later waited least: the nearest this run gets to
    the collectives' own cost)."""
    prof = [rr["profile"] for rr in per]
    calls = [p["collective_calls"] for p in prof]
    check(all([k for k, _ in c] == [k for k, _ in calls[0]] for c in calls),
          "distributed: the ranks' collectives ran in different orders")
    return {"round_s": [p["round_s"] for p in prof],
            "k2_ms": [p["k2"]["ms"] for p in prof],
            "k2_calls": [p["k2"]["calls"] for p in prof],
            "split_scan_ms": [p["split_scan"]["ms"] for p in prof],
            "collective_ms": [p["collective_ms"] for p in prof],
            "collective_calls": len(calls[0]),
            "collective_ms_min_over_ranks": sum(
                min(ms) for ms in zip(*([m for _, m in c] for c in calls)))}


def phase_distributed(seed, datasets, dev, workdir):
    """The distributed learners on two ranks of the one card (module
    docstring, ``distributed``); returns K2's launches."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops.grow import TreeArrays
    from lightgbm_tpu_torch.parallel import comm
    from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks
    t_start = time.perf_counter()
    probe = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.tools.probe_gloo"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    check(probe.returncode == 0, f"distributed: probe_gloo failed: "
                                 f"{probe.stderr[-2000:]}")
    found = json.loads(probe.stdout.strip().splitlines()[-1])
    takes = {k for k, v in found["cuda"].items() if v is True}
    check(takes == set(comm.GLOO_CUDA_COLLECTIVES),
          f"distributed: gloo takes CUDA tensors in {sorted(takes)}, the "
          f"comm layer's rule says {sorted(comm.GLOO_CUDA_COLLECTIVES)}")
    job = os.path.join(workdir, "dist_job.json")
    with open(job, "w") as fh:
        json.dump({"seed": seed, "workdir": workdir,
                   "mlist": machine_list(os.path.join(workdir,
                                                      "dist_mlist.txt"), 2)},
                  fh)
    env = {k: v for k, v in os.environ.items()
           if k != "LGBT_DEVICE_MEMORY_BYTES"}
    t0 = time.perf_counter()
    codes, outs = run_ranks([[sys.executable, os.path.abspath(__file__),
                              "--dist-rank", job]] * 2,
                            timeout=DIST_TIMEOUT_S, env=env, cwd=REPO)
    ranks_s = time.perf_counter() - t0
    for r, text in enumerate(outs):
        with open(os.path.join(workdir, f"dist_rank{r}.log"), "w") as fh:
            fh.write(text)
    check(codes == [0, 0], f"distributed: the ranks exited {codes} (a "
                           f"timeout is -9): {outs[0][-2000:]} "
                           f"{outs[1][-2000:]}")
    res = []
    for r in range(2):
        with open(os.path.join(workdir, f"dist_rank{r}.json")) as fh:
            res.append(json.load(fh))
    # the serial full-pass grower on the same cell, in this process
    train_set, valid_set, _, _ = datasets
    b = lt.Booster(params={**TRAIN_PARAMS, **CONST,
                           "histogram_pool_size": 1,
                           "memory_policy": "degrade"},
                   train_set=train_set, device=dev)
    b.add_valid(valid_set, "valid")
    serial_s = _timed_rounds(b, dev, DIST_ROUNDS)
    serial_auc = dict((n, v) for n, v, _ in
                      b._booster.eval_set("valid_1"))["auc"]
    serial_trees = _tree_arrays(b)
    check(b._booster.grow_kind == "nocache", "distributed: the serial "
                                             "reference is not nocache")
    del b
    runs = {}
    for name, extra, _ in DIST_RUNS:
        texts = [open(os.path.join(workdir, f"dist_{name}_r{r}.txt")).read()
                 for r in range(2)]
        check(texts[0] == texts[1], f"distributed: {name}: the ranks' "
                                    f"model texts differ")
        flips = []
        if name in DIST_EXACT:
            trees = [TreeArrays(**d) for d in torch.load(
                os.path.join(workdir, f"dist_{name}_r0.pt"))]
            check(len(trees) == len(serial_trees) == DIST_ROUNDS,
                  f"distributed: {name} grew {len(trees)} trees")
            for i, (x, z) in enumerate(zip(trees, serial_trees)):
                flip, _ = compare_regrown(x, z, f"distributed: {name} "
                                                f"tree {i}", exact=False)
                if flip is not None:
                    flips.append({"tree": i, **flip})
        per = [rr["runs"][name] for rr in res]
        for rr in per:
            check(rr["k2_launches"] > 0, f"distributed: {name}: a rank "
                                         f"launched no K2")
            check(rr["collective_bytes_per_tree"]
                  == rr["traffic_per_tree_bytes"],
                  f"distributed: {name}: {rr['collective_bytes_per_tree']} "
                  f"collective bytes a tree against the account's "
                  f"{rr['traffic_per_tree_bytes']}")
        auc = per[0]["valid_auc"]
        if name == "voting_top20":
            check(abs(auc - serial_auc) <= DIST_AUC_PIN,
                  f"distributed: voting top_k=20 valid AUC {auc} against "
                  f"serial {serial_auc}")
        runs[name] = {
            "round_s_median": float(np.median(per[0]["round_s"])),
            "round_s": [rr["round_s"] for rr in per],
            "profiled_round": dist_profile(per),
            "k2_launches_per_rank": [rr["k2_launches"] for rr in per],
            "collective_bytes_per_tree": per[0]["collective_bytes_per_tree"],
            "calls_per_tree": {k: v / DIST_ROUNDS
                               for k, v in per[0]["calls"].items()},
            "valid_auc": auc, "near_tie_flips": flips}
    for rr in res:
        check(rr["backend"] == "gloo" and rr["device"] == "cuda:0",
              f"distributed: rank {rr['rank']} ran {rr['backend']} on "
              f"{rr['device']}")
    cli_line = _dist_cli(workdir)
    emit({"phase": "distributed", "world": 2, "backend": res[0]["backend"],
          "rounds": DIST_ROUNDS, "gloo_cuda": found,
          "serial_nocache_round_s_median": float(np.median(serial_s)),
          "serial_round_s": serial_s, "serial_valid_auc": serial_auc,
          "runs": runs, "k2_shard": [rr["k2_shard"] for rr in res],
          "rank_data_s": [rr["data_s"] for rr in res], "ranks_s": ranks_s,
          "cli": cli_line, "seconds": time.perf_counter() - t_start})
    # K2 launches of the main path: both ranks' runs
    return {"children_histograms": sum(
        rr["runs"][n]["k2_launches"] for rr in res for n, _, _ in DIST_RUNS)}


def _snapshot_timer():
    """Wrap ``snapshot.save_snapshot``, ``load_latest_snapshot`` and
    ``restore_booster_state`` (the engine looks them up at each call);
    returns (the records, undo)."""
    from lightgbm_tpu_torch import snapshot as snapmod
    rec = {"writes": [], "loads": [], "restores": []}
    save, restore = snapmod.save_snapshot, snapmod.restore_booster_state
    load = snapmod.load_latest_snapshot

    def timed_save(directory, booster, rounds_done, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(directory, booster, rounds_done, **kw)
        ms = 1e3 * (time.perf_counter() - t0)
        rec["writes"].append({"rounds": rounds_done, "ms": ms,
                              "bytes": os.path.getsize(path)
                              if path else None})
        return path

    def timed_restore(booster, state):
        t0 = time.perf_counter()
        out = restore(booster, state)
        torch.cuda.synchronize()
        rec["restores"].append(1e3 * (time.perf_counter() - t0))
        return out

    def timed_load(directory):
        t0 = time.perf_counter()
        out = load(directory)
        rec["loads"].append(1e3 * (time.perf_counter() - t0))
        return out

    snapmod.save_snapshot = timed_save
    snapmod.restore_booster_state = timed_restore
    snapmod.load_latest_snapshot = timed_load

    def undo():
        snapmod.save_snapshot = save
        snapmod.restore_booster_state = restore
        snapmod.load_latest_snapshot = load
    return rec, undo


def resilience_serial(datasets, workdir):
    """(a) ``RES_ROUNDS`` rounds of the ordered grower on the train
    phase's datasets, uninterrupted; then with a snapshot every
    ``RES_SNAP_FREQ`` rounds, an ``InjectedCrash`` after round
    ``RES_CRASH_AT``, the newest snapshot torn, and a resume, which must
    fall back to the one before it by name and end byte-equal (model
    text, the training score buffer)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch import snapshot as snapmod
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.testing import faults
    train_set, valid_set, _, _ = datasets
    params = {**TRAIN_PARAMS, **CONST}
    common = dict(valid_sets=[valid_set], valid_names=["valid"],
                  verbose_eval=False)
    plain = lt.train(params, train_set, RES_ROUNDS, **common)
    snaps = os.path.join(workdir, "resilience_snaps")
    snap = {**params, "snapshot_dir": snaps, "snapshot_freq": RES_SNAP_FREQ}

    def crash(env):
        if env.iteration == RES_CRASH_AT:
            raise faults.InjectedCrash(f"crash after round {RES_CRASH_AT}")
    crash.order = 99
    rec, undo = _snapshot_timer()
    try:
        lh.reset_launch_counts()
        try:
            lt.train(snap, train_set, RES_ROUNDS, callbacks=[crash],
                     **common)
            check(False, "resilience: the injected crash did not fire")
        except faults.InjectedCrash:
            pass
        crashed_k1 = lh.launch_counts()["digit_histogram"]
        on_disk = [r for r, _ in snapmod.list_snapshots(snaps)]
        newest = RES_CRASH_AT - RES_CRASH_AT % RES_SNAP_FREQ
        check(on_disk[0] == newest, f"resilience: snapshots {on_disk} at "
                                    f"the crash")
        faults.truncate_file(snapmod.snapshot_path(snaps, newest))
        skipped = obs.get_counter("snapshot_corrupt_skipped_total")
        found = snapmod.load_latest_snapshot(snaps)
        check(found is not None and found[0] == snapmod.snapshot_path(
            snaps, newest - RES_SNAP_FREQ)
            and obs.get_counter("snapshot_corrupt_skipped_total")
            == skipped + 1, f"resilience: the torn snapshot of round "
                            f"{newest} did not fall back by name: {found}")
        lh.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = lt.train(snap, train_set, RES_ROUNDS, **common)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resumed_k1 = lh.launch_counts()["digit_histogram"]
    finally:
        undo()
    check(resumed.model_to_string() == plain.model_to_string(),
          "resilience: the resumed model text differs from the "
          "uninterrupted run's")
    check(torch.equal(resumed._booster.train_data.score,
                      plain._booster.train_data.score),
          "resilience: the resumed training scores differ")
    leaves = sum(t.num_leaves for t in resumed._booster.models[
        (newest - RES_SNAP_FREQ):])
    check(resumed_k1 == leaves and resumed_k1 > 0,
          f"resilience: {resumed_k1} K1 launches in the resumed rounds "
          f"against {leaves} leaves grown")
    return {"rounds": RES_ROUNDS, "crash_after_round": RES_CRASH_AT,
            "torn": newest, "resumed_from": newest - RES_SNAP_FREQ,
            "snapshot_writes": rec["writes"], "load_ms": rec["loads"],
            "restore_ms": rec["restores"],
            "resumed_run_s": resume_s, "k1_launches_crashed_run": crashed_k1,
            "k1_launches_resumed_run": resumed_k1}, crashed_k1 + resumed_k1


def _res_launch(scenario, job, workdir, env):
    """Two ranks of ``chip_smoke.py --resilience-rank`` on a fresh machine
    list; returns (exit codes, outputs, seconds), the outputs kept in
    ``workdir``."""
    from lightgbm_tpu_torch.parallel.launch import machine_list, run_ranks
    mlist = machine_list(os.path.join(workdir, f"res_{scenario}.txt"), 2)
    path = os.path.join(workdir, f"res_{scenario}.json")
    with open(path, "w") as fh:
        json.dump({**job, "scenario": scenario, "mlist": mlist,
                   "workdir": workdir}, fh)
    t0 = time.perf_counter()
    codes, outs = run_ranks([[sys.executable, os.path.abspath(__file__),
                              "--resilience-rank", path]] * 2,
                            timeout=RES_LAUNCH_TIMEOUT_S, env=env, cwd=REPO,
                            wait_all=True)
    secs = time.perf_counter() - t0
    for r, text in enumerate(outs):
        with open(os.path.join(workdir, f"res_{scenario}_r{r}.log"),
                  "w") as fh:
            fh.write(text)
    return codes, outs, secs


def _res_result(workdir, scenario, rank):
    with open(os.path.join(workdir, f"res_{scenario}_r{rank}.json")) as fh:
        return json.load(fh)


def phase_resilience(seed, datasets, workdir):
    """Crash-safe training on the card (module docstring,
    ``resilience``); returns K1's and K2's launches."""
    t_start = time.perf_counter()
    serial, k1 = resilience_serial(datasets, workdir)
    serial_s = time.perf_counter() - t_start
    env = {k: v for k, v in os.environ.items()
           if k != "LGBT_DEVICE_MEMORY_BYTES"}
    job = {"seed": seed}
    # (b) the kill, then the restart on fresh ports
    codes, outs_kill, kill_s = _res_launch("kill", job, workdir, env)
    outs = outs_kill
    check(codes == [75, -9], f"resilience: the kill's ranks exited "
                             f"{codes}: {outs[0][-2000:]} {outs[1][-2000:]}")
    check("distributed training aborted in phase 'Comm::grow'" in outs[0]
          and "rank 1 last seen" in outs[0],
          f"resilience: rank 0's abort names no phase and rank: "
          f"{outs[0][-2000:]}")
    kill = _res_result(workdir, "kill", 0)
    from lightgbm_tpu_torch.snapshot import list_snapshots
    kill_snaps = [r for r, _ in list_snapshots(
        os.path.join(workdir, "res_dist_snaps"))]
    check(kill_snaps and kill_snaps[0] == RES_KILL_AT,
          f"resilience: snapshots {kill_snaps} after the kill")
    with open(os.path.join(workdir, "res_killed_at.txt")) as fh:
        killed_at = float(fh.read())
    abort_s = kill["aborted_at"] - killed_at
    check(abort_s <= RES_KILL_TIMEOUT_S + RES_ABORT_SLACK_S,
          f"resilience: rank 0 aborted {abort_s:.1f} s after the kill")
    codes, outs, resume_s = _res_launch("resume", job, workdir, env)
    check(codes == [0, 0], f"resilience: the restarted ranks exited "
                           f"{codes}: {outs[0][-2000:]} {outs[1][-2000:]}")
    resumed = [_res_result(workdir, "resume", r) for r in range(2)]
    texts = [open(os.path.join(workdir, f"res_resume_r{r}.txt")).read()
             for r in range(2)]
    check(texts[0] == texts[1], "resilience: the resumed ranks' models "
                                "differ")
    # (c) and (d) in one launch: the desync, then the hang
    codes, outs, small_s = _res_launch("desync_hang", job, workdir, env)
    check(codes == [75, 75], f"resilience: the desync/hang ranks exited "
                             f"{codes}: {outs[0][-2000:]} "
                             f"{outs[1][-2000:]}")
    check("distributed training aborted in phase 'Comm::grow'" in outs[0]
          and "deadline" in outs[0]
          and "heartbeat lost" not in outs[0],
          f"resilience: rank 0 did not leave through the deadline path: "
          f"{outs[0][-2000:]}")
    small = [_res_result(workdir, "desync_hang", r) for r in range(2)]
    texts = [open(os.path.join(workdir, f"res_desync_r{r}.txt")).read()
             for r in range(2)]
    check(texts[0] == texts[1], "resilience: the resynced ranks' models "
                                "differ")
    with open(os.path.join(workdir, "res_hung_at.txt")) as fh:
        hung_at = float(fh.read())
    hang_abort_s = small[0]["aborted_at"] - hung_at
    check(hang_abort_s <= 2 * RES_HANG_TIMEOUT_S + RES_ABORT_SLACK_S,
          f"resilience: rank 0 aborted {hang_abort_s:.1f} s into the hang")
    k2 = sum(r["k2_launches"] for r in [kill, *resumed, *small])
    check(all(r["k2_launches"] > 0 for r in [kill, *resumed, *small]),
          "resilience: a rank launched no K2")
    emit({"phase": "resilience", "serial": serial, "serial_s": serial_s,
          "kill": {"abort_s_after_kill": abort_s,
                   "collective_timeout_s": RES_KILL_TIMEOUT_S,
                   "rank0_abort": [ln for ln in outs_kill[0].splitlines()
                                   if "distributed training aborted" in ln],
                   "launch_s": kill_s, "snapshot_rounds": kill_snaps},
          "resume": {"consensus_ms": [r["consensus_ms"] for r in resumed],
                     "resumed_run_s": [r["resumed_run_s"]
                                       for r in resumed],
                     "reference_run_s": [r["reference_run_s"]
                                         for r in resumed],
                     "launch_s": resume_s},
          "desync": {"fail_fast": small[0]["fail_fast"],
                     "resync_ms": [r["resync_ms"] for r in small],
                     "resyncs": [r["resyncs"] for r in small]},
          "hang": {"abort_s_after_hang": hang_abort_s,
                   "collective_timeout_s": RES_HANG_TIMEOUT_S,
                   "rank0_abort": [ln for ln in outs[0].splitlines()
                                   if "distributed training aborted" in ln],
                   "heartbeat_ages_at_abort": small[0]["ages"]},
          "desync_hang_launch_s": small_s,
          "rank_stage_s": {"kill": kill["stage_s"],
                           "resume": [r["stage_s"] for r in resumed],
                           "desync_hang": [r["stage_s"] for r in small]},
          "k1_launches": k1, "k2_launches": k2,
          "seconds": time.perf_counter() - t_start})
    return {"digit_histogram": k1, "children_histograms": k2}


def resilience_rank(job_path) -> int:
    """One rank of the resilience phase (``--resilience-rank JOB``)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.parallel import watchdog
    from lightgbm_tpu_torch.parallel.multihost import (
        maybe_initialize_distributed, process_rank_world)
    from lightgbm_tpu_torch.snapshot import coordinated_resume
    from lightgbm_tpu_torch.testing import faults
    with open(job_path) as fh:
        job = json.load(fh)
    scenario, workdir = job["scenario"], job["workdir"]
    small = scenario == "desync_hang"
    timeout_s = RES_HANG_TIMEOUT_S if small else RES_KILL_TIMEOUT_S
    cfg = Config({"num_machines": 2, "tree_learner": "data",
                  "machine_list_file": job["mlist"],
                  "distributed_heartbeat_ms": RES_HEARTBEAT_MS,
                  "collective_timeout_s": timeout_s})
    check(maybe_initialize_distributed(cfg), "resilience: no group")
    rank, _ = process_rank_world()
    wd = watchdog.active_watchdog()
    check(wd is not None, "resilience: the watchdog is not armed")
    t_start = time.perf_counter()
    out = {"rank": rank, "scenario": scenario, "stage_s": {}}
    out_path = os.path.join(workdir, f"res_{scenario}_r{rank}.json")

    def dump():
        with open(out_path, "w") as fh:
            json.dump(out, fh)

    def note_abort(message=None):
        out["stage_s"]["abort"] = time.perf_counter() - t_start
        out["aborted_at"] = time.time()
        out["message"] = message
        out["ages"] = {str(k): v for k, v in wd.mesh.peer_ages().items()}
        out["k2_launches"] = ch.launch_counts()["children_histograms"]
        dump()
    # the hard abort runs the registered flushes before it exits
    wd.register_flush(note_abort)
    X, y = make_higgs_like(RES_SMALL_ROWS if small else RES_DIST_ROWS,
                           seed=job["seed"] + 60)
    train_set = lt.Dataset(X, y, params=RES_DIST_PARAMS).construct()
    out["stage_s"]["data"] = time.perf_counter() - t_start
    rounds = RES_SMALL_ROUNDS if small else RES_DIST_ROUNDS
    snaps = os.path.join(workdir, "res_dist_snaps")
    snap = {**RES_DIST_PARAMS, "snapshot_dir": snaps, "snapshot_freq": 1}
    ch.reset_launch_counts()

    def train(params, callbacks=None):
        return lt.train(params, train_set, rounds, verbose_eval=False,
                        callbacks=callbacks)

    def stamp(name, at):
        def cb(env):
            if env.iteration == at and rank == 1:
                with open(os.path.join(workdir, name), "w") as fh:
                    fh.write(repr(time.time()))
        cb.before_iteration = True
        cb.order = -100                  # before the injector's -99
        return cb

    def abort_on(params, callbacks):
        try:
            train(params, callbacks)
        except watchdog.DistributedAborted as e:
            note_abort(str(e))
            print(f"resilience rank abort: {e}", flush=True)
            os._exit(watchdog.DISTRIBUTED_ABORT_EXIT_CODE)
        print("UNEXPECTED_COMPLETION", flush=True)
        return 1

    if scenario == "kill":
        return abort_on(snap, [stamp("res_killed_at.txt", RES_KILL_AT),
                               faults.kill_rank(RES_KILL_AT, rank=1)])
    if scenario == "resume":
        t0 = time.perf_counter()
        found = coordinated_resume(snaps)
        out["consensus_ms"] = 1e3 * (time.perf_counter() - t0)
        check(found is not None
              and int(found[1]["rounds_done"]) == RES_KILL_AT
              and int(found[1]["world"]["num_processes"]) == 2,
              f"resilience: the consensus found {found and found[0]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = train(snap)
        torch.cuda.synchronize()
        out["resumed_run_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = train(RES_DIST_PARAMS)
        torch.cuda.synchronize()
        out["reference_run_s"] = time.perf_counter() - t0
        out["k2_launches"] = ch.launch_counts()["children_histograms"]
        check(resumed.model_to_string() == ref.model_to_string(),
              f"resilience: rank {rank}'s resumed model differs from the "
              f"uninterrupted two-rank run's (first differing split: "
              f"{first_text_diff(resumed, ref)})")
        with open(os.path.join(workdir, f"res_resume_r{rank}.txt"),
                  "w") as fh:
            fh.write(resumed.model_to_string())
        dump()
        return 0
    # (d) the desync: fail_fast, then resync, then the clean run; the
    # resyncing check timed
    checks = []
    orig = GBDT._check_distributed_consistency

    def timed_check(self, r, w):
        t0 = time.perf_counter()
        healed = orig(self, r, w)
        checks.append((healed, 1e3 * (time.perf_counter() - t0)))
        return healed
    GBDT._check_distributed_consistency = timed_check
    base = {**RES_DIST_PARAMS, "distributed_consistency_check": 1}
    try:
        train({**base, "desync_policy": "fail_fast"},
              [faults.corrupt_rank_state(RES_CORRUPT_AT, rank=1,
                                         field="score")])
        check(False, "resilience: fail_fast did not trip on the desync")
    except lt.LightGBMError as e:
        out["fail_fast"] = str(e)
    check("field 'score' diverged on rank(s) [1]" in out["fail_fast"],
          f"resilience: fail_fast said {out['fail_fast']}")
    del checks[:]
    healed = train({**base, "desync_policy": "resync"},
                   [faults.corrupt_rank_state(RES_CORRUPT_AT, rank=1,
                                              field="score")])
    GBDT._check_distributed_consistency = orig
    out["resyncs"] = sum(1 for h, _ in checks if h)
    out["resync_ms"] = [ms for h, ms in checks if h]
    check(out["resyncs"] == 1, f"resilience: {out['resyncs']} resyncs")
    ref = train(RES_DIST_PARAMS)
    check(healed.model_to_string() == ref.model_to_string(),
          f"resilience: rank {rank}'s resynced model differs from the "
          f"clean run's (first differing split: "
          f"{first_text_diff(healed, ref)})")
    with open(os.path.join(workdir, f"res_desync_r{rank}.txt"), "w") as fh:
        fh.write(healed.model_to_string())
    out["stage_s"]["desync"] = time.perf_counter() - t_start
    dump()
    # (c) the hang: rank 1 is released once rank 0's heartbeat has
    # stopped (rank 0 left through its deadline), then leaves itself
    hang = faults.hang_rank(RES_HANG_AT, rank=1,
                            hang_s=2 * RES_HANG_TIMEOUT_S
                            + RES_ABORT_SLACK_S)

    def release_when_peer_gone():
        while not hang.release.is_set():
            if wd.mesh.peer_ages().get(0, 0.0) > 1.0:
                hang.release.set()
            time.sleep(0.1)
    if rank == 1:
        threading.Thread(target=release_when_peer_gone, daemon=True).start()
    return abort_on(RES_DIST_PARAMS,
                    [stamp("res_hung_at.txt", RES_HANG_AT), hang])


def first_text_diff(a, b):
    """The first tree and field where two boosters' model texts differ,
    or None."""
    ta = tree_sections(a.model_to_string())
    tb = tree_sections(b.model_to_string())
    for i, (x, z) in enumerate(zip(ta, tb)):
        for key in x:
            if x[key] != z.get(key):
                return {"tree": i, "field": key, "a": x[key][:200],
                        "b": str(z.get(key))[:200]}
    return None if len(ta) == len(tb) else {"trees": [len(ta), len(tb)]}


def phase_examples(workdir):
    """Each example conf through ``lightgbm_tpu_torch.cli.main``, on the
    card and on the CPU, in a copy of its directory: EXAMPLE_ROUNDS
    rounds, then the conf's ``predict.conf`` (raw scores) on its test
    file with each model, and the card once more with the CPU's model.
    K1 must launch Σ over trees of (1 + splits) times in the card's
    training run, and K4 in every card prediction.  Returns the
    launches."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    total = {}
    for name, folder in EXAMPLES:
        work = f"{workdir}/example_{name}"
        conf = copy_example(name, folder, work)
        runs = {}
        with in_dir(work):
            for dev in ("cuda", "cpu"):
                lh.reset_launch_counts()
                t0 = time.perf_counter()
                text = _cli([f"config={conf}", f"num_trees={EXAMPLE_ROUNDS}",
                             f"device={dev}", f"output_model=model_{dev}.txt"])
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                with open(f"model_{dev}.txt") as fh:
                    model = fh.read()
                trees = tree_sections(model)
                runs[dev] = {
                    "text": model, "trees": len(trees), "train_s": train_s,
                    "leaves": sum(int(t["num_leaves"]) for t in trees),
                    "k1": lh.launch_counts()["digit_histogram"],
                    "metrics": round_metrics(text),
                    "preds": {}}
            for dev, model_dev in (("cuda", "cuda"), ("cuda", "cpu"),
                                   ("cpu", "cpu")):
                fw.reset_launch_counts()
                out = f"pred_{dev}_on_{model_dev}.txt"
                _cli(["config=predict.conf", f"device={dev}",
                      f"input_model=model_{model_dev}.txt",
                      "is_predict_raw_score=true", f"output_result={out}"])
                runs[dev]["preds"][model_dev] = (
                    np.loadtxt(out, ndmin=1),
                    sum(fw.launch_counts().values()))
        card, cpu = runs["cuda"], runs["cpu"]
        check(card["k1"] == card["leaves"],
              f"{name}: K1 launches {card['k1']} != {card['leaves']}")
        check(cpu["k1"] == 0, f"{name}: K1 launched in the CPU run")
        check(all(n > 0 for _, n in card["preds"].values()),
              f"{name}: a card prediction launched no K4")
        check(all(n == 0 for _, n in cpu["preds"].values()),
              f"{name}: K4 launched in the CPU prediction")
        compared, flip, leaf_rel = compare_model_texts(
            card["text"], cpu["text"], f"examples {name}")
        worst, ties = compare_round_metrics(
            card["metrics"], cpu["metrics"], work, conf, f"examples {name}",
            ("model_cuda.txt", "model_cpu.txt"))
        # the card's predict path on the CPU's model always; the two
        # models' own predictions unless a near-tie flipped a split
        want = cpu["preds"]["cpu"][0]
        same_model = float(np.abs(card["preds"]["cpu"][0] - want).max())
        check(np.allclose(card["preds"]["cpu"][0], want, rtol=1e-5,
                          atol=1e-5),
              f"{name}: card predict of the CPU model: {same_model}")
        own = float(np.abs(card["preds"]["cuda"][0] - want).max())
        if flip is None:
            check(np.allclose(card["preds"]["cuda"][0], want, rtol=1e-5,
                              atol=1e-5), f"{name}: predictions {own}")
        check(np.isfinite(card["preds"]["cuda"][0]).all(),
              f"{name}: non-finite predictions")
        emit({"phase": "examples", "conf": f"examples/{folder}/train.conf",
              "rounds": EXAMPLE_ROUNDS, "trees": card["trees"],
              "train_s": {"cuda": card["train_s"], "cpu": cpu["train_s"]},
              "k1_launches": card["k1"],
              "k4_launches": {m: n for m, (_, n) in card["preds"].items()},
              "trees_structure_equal": compared, "near_tie_flip": flip,
              "max_leaf_value_diff_of_tree_max": leaf_rel,
              "metrics_compared": len(cpu["metrics"]),
              "max_metric_diff": worst, "ranking_metric_ties": ties,
              "final_metrics": {f"{k[1]} {k[2]}": v for k, v in
                                card["metrics"].items()
                                if k[0] == EXAMPLE_ROUNDS},
              "max_pred_diff_card_vs_cpu": own,
              "max_pred_diff_same_model": same_model,
              "predictions": int(want.shape[0])})
        total["digit_histogram"] = total.get("digit_histogram", 0) \
            + card["k1"]
        total["forest_walk"] = total.get("forest_walk", 0) + sum(
            n for _, n in card["preds"].values())
    return total


# ---------------------------------------------------------------------------
# the new objectives at full width on the card


def mslr_like(num_data: int, seed: int):
    """A stand-in for MSLR-WEB10K at its published shape: 136 dense
    features, relevance labels 0-4, and query sizes drawn from ``seed``
    between 1 and 1024 with a mean of about 120 (a clipped log-normal);
    a few features carry the relevance."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(np.round(np.exp(rng.normal(4.5, 0.75, size=num_data))),
                    1, 1024).astype(np.int64)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), num_data) + 1]
    sizes[-1] -= sizes.sum() - num_data
    sizes = sizes[sizes > 0]
    X = rng.normal(size=(num_data, RANK_FEATURES)).astype(np.float32)
    latent = X[:, :8] @ rng.uniform(0.2, 1.0, size=8) \
        + rng.normal(scale=1.5, size=num_data)
    label = np.digitize(latent, np.quantile(latent, [0.45, 0.7, 0.88,
                                                     0.97]))
    return X.astype(np.float64), label.astype(np.float64), sizes


def objective_data(seed):
    """{kind: (Dataset, X)} of the objectives phase: the Higgs-like
    features with multiclass, continuous and count labels from one
    seeded latent, and the MSLR-like ranking set."""
    import lightgbm_tpu_torch as lt
    X, _ = make_higgs_like(OBJ_ROWS, seed=seed + 60)
    rng = np.random.RandomState(seed + 61)
    latent = 0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.5 * X[:, 14] \
        + 0.3 * X[:, 7] * X[:, 2] + rng.normal(scale=0.8, size=OBJ_ROWS)
    labels = {
        "multiclass": np.digitize(latent, np.quantile(
            latent, [0.2, 0.4, 0.6, 0.8])).astype(np.float64),
        "continuous": latent,
        "counts": rng.poisson(np.exp(0.4 * latent)).astype(np.float64)}
    t0 = time.perf_counter()
    higgs = lt.Dataset(X, labels["continuous"],
                       params=dict(OBJ_PARAMS)).construct()
    Xr, yr, sizes = mslr_like(OBJ_ROWS, seed + 62)
    rank = lt.Dataset(Xr, yr, group=sizes,
                      params=dict(OBJ_PARAMS)).construct()
    emit({"phase": "objectives_data", "rows": OBJ_ROWS,
          "higgs_features": X.shape[1], "rank_features": RANK_FEATURES,
          "queries": int(len(sizes)), "query_size_mean": float(sizes.mean()),
          "query_size_max": int(sizes.max()),
          "relevance_counts": np.bincount(yr.astype(int)).tolist(),
          "binning_s": time.perf_counter() - t0})
    return higgs, X, labels, rank, Xr


class _timed_gradients:
    """CUDA events around every ``gradients_with`` of ``objective``
    inside the block."""

    def __init__(self, objective):
        self.objective, self.spans = objective, []

    def __enter__(self):
        fn = self.objective.gradients_with

        def timed(arrays, score):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(arrays, score)
            e.record()
            self.spans.append((s, e))
            return out
        self.objective.gradients_with = timed
        return self

    def __exit__(self, *exc):
        del self.objective.gradients_with

    def ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.spans]


def k1_on_run(gbdt, grad, hess, label):
    """K1 on a training run's own card bins and digits (``grad``/``hess``
    of one class, the row weights), held bit-equal to its plain version:
    the root window (all rows), and windows of the rows ordered by the
    last feature, which carries no signal in the objectives phase's sets,
    as the ordered grower orders a leaf's rows, at sizes that take each
    of the wrapper's paths.  Returns the windows."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    bins, w = gbdt.train_data.bins_rm, gbdt._row_weight
    g, h = grad * w, hess * w
    dig = lh.quantize_digits(g, h, w, lh.compute_scales(g, h, w))
    B = gbdt.grow_params.max_bin
    N, F = bins.shape
    order = torch.sort(bins[:, F - 1].to(torch.int32), stable=True).indices
    store = bins.view(torch.int16) if bins.dtype == torch.uint16 else bins
    ordered = store.index_select(0, order).view(bins.dtype)
    ordered_dig = dig.index_select(0, order)
    windows = [("root", bins, dig, 0, N)] + [
        ("ordered", ordered, ordered_dig, start, min(S, N - start))
        for start, S in ((N // 2 - 3, 4097), (5, lh.SMALL_WINDOW_MAX_ROWS),
                         (7, lh.SMALL_WINDOW_MAX_ROWS + 1),
                         (N - N // 3 - 1, N // 3))]
    for kind, b, d, start, S in windows:
        before = lh.launch_counts()["digit_histogram"]
        got = lh.digit_histogram(b, d, B, start, S)
        torch.cuda.synchronize()
        check(lh.launch_counts()["digit_histogram"] == before + 1,
              f"{label}: K1 on the run's bins launched no kernel")
        want = lh.digit_histogram_plain(b, d, B, start, S)
        check(torch.equal(got, want),
              f"{label}: K1 on the run's bins, {kind} window "
              f"[{start}, {start + S}) of {F} features, not bit-equal to "
              f"the plain version")
    return [[kind, start, S] for kind, _, _, start, S in windows]


def objective_run(name, extra, rounds, train_set, X, workdir):
    """``rounds`` rounds of one objective on the card: K1's launches,
    the first tree of each class re-grown through the plain versions
    (bit-identical), K1 on the run's own bins bit-equal to its plain
    version (``k1_on_run``), the saved model through K4 against the score
    buffer, the training metric's direction, the card's gradients
    against the same function on the CPU, and each round's seconds and
    gradient share."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    params = {**OBJ_PARAMS, "objective": name, **extra}
    booster = lt.Booster(params=params, train_set=train_set)
    gbdt = booster._booster
    lh.reset_launch_counts()
    evals = []
    seconds = []
    with _timed_gradients(gbdt.objective) as grads:
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            booster.update()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            evals.append(booster.eval_train())
        grad_ms = grads.ms()
    k1 = lh.launch_counts()["digit_histogram"]
    grown = list(gbdt.tree_arrays)
    K = gbdt.num_class
    check(len(grown) == rounds * K, f"{name}: {len(grown)} trees")
    want = sum(int(ta.num_leaves) for ta in grown)
    check(k1 == want, f"{name}: K1 launches {k1} != {want}")

    # (b) the first tree of each class from the round-0 gradients
    score = torch.zeros_like(gbdt.train_data.score)
    grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
    for c in range(K):
        with _plain_kernels():
            ta, _, _ = gbdt._grow(grad[c], hess[c])
        compare_regrown(grown[c], ta, f"{name} class {c} tree 1", exact=True)
    k1_windows = k1_on_run(gbdt, grad[0], hess[0], name)
    # the card's gradients against the CPU's on the final scores
    cpu_arrays = gbdt.objective.gradient_arrays(torch.device("cpu"))
    final = gbdt.train_data.score
    g_card, h_card = gbdt.objective.gradients_with(gbdt._grad_arrays, final)
    g_cpu, h_cpu = gbdt.objective.gradients_with(cpu_arrays, final.cpu())
    tol = GRAD_RTOL
    grad_err = {}
    for what, a, b in (("grad", g_card, g_cpu), ("hess", h_card, h_cpu)):
        a, b = a.double().cpu(), b.double()
        err = float(((a - b).abs() / (b.abs() + b.abs().max())).max())
        check(bool(((a - b).abs() <= tol * b.abs()
                    + tol * b.abs().max()).all()),
              f"{name}: card {what} against the CPU's: {err}")
        grad_err[what] = err

    path = f"{workdir}/objective_{name}.txt"
    booster.save_model(path)
    fw.reset_launch_counts()
    pred = lt.Booster(model_file=path).predict(X[:4096], raw_score=True)
    k4 = sum(fw.launch_counts().values())
    check(k4 > 0, f"{name}: the saved model's prediction launched no K4")
    buf = gbdt.train_data.score[:, :4096].double().cpu().numpy()
    pred = pred.T if pred.ndim == 2 else pred[None]
    d_pred = float(np.abs(pred - buf).max())
    check(np.isfinite(pred).all() and d_pred <= 1e-5,
          f"{name}: saved model vs score buffer: {d_pred}")

    curve = {}
    for per_round in evals:
        for _, metric, value, bigger in per_round:
            curve.setdefault(metric, ([], bigger))[0].append(value)
    for metric, (values, bigger) in curve.items():
        check(all(np.isfinite(values))
              and (values[-1] > values[0] if bigger
                   else values[-1] < values[0]),
              f"{name}: training {metric} {values} does not improve")
    round_ms = [s * 1e3 for s in seconds]
    share = [g / r for g, r in zip(grad_ms, round_ms)]
    emit({"phase": "objectives", "objective": name, "params": params,
          "rows": train_set.num_data(), "features": X.shape[1],
          "rounds": rounds, "trees": len(grown),
          "leaves_per_tree": [int(ta.num_leaves) for ta in grown],
          "k1_launches": k1, "k4_launches": k4,
          "k1_bit_equal_on_run_bins": k1_windows,
          "round_s": seconds,
          "round_s_median_after_2": float(np.median(seconds[2:])),
          "gradient_ms": grad_ms,
          "gradient_share_median": float(np.median(share)),
          "gradient_vs_cpu_max_rel_err": grad_err,
          "saved_model_vs_score_buffer": d_pred,
          "training_metric": {m: v for m, (v, _) in curve.items()}})
    return {"digit_histogram": k1, "forest_walk": k4}


def phase_objectives(seed, workdir):
    """Every objective the port added, at full width on the card
    (OBJECTIVE_RUNS); returns the launches and (the Higgs-like Dataset
    with its 5-class labels, its rows) for the sampling phase."""
    higgs, X, labels, rank, Xr = objective_data(seed)
    total = {}
    for name, extra, rounds, kind in OBJECTIVE_RUNS:
        if kind == "rank":
            ds, rows = rank, Xr
        else:
            ds, rows = higgs.set_label(labels[kind]), X
        got = objective_run(name, extra, rounds, ds, rows, workdir)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return total, (higgs.set_label(labels["multiclass"]), X)

# ---------------------------------------------------------------------------
# row and feature sampling, GOSS and DART at full width on the card


class _draw_recorder:
    """Inside the block, record what one booster's sampling drew on the
    card: every bag mask (``device_bag_mask``'s inputs and output), every
    GOSS draw (its gradients, key and outputs, copied to the host), every
    DART drop selection, and for every tree the feature mask and row
    weight it grew with and the rows of each K1 window.  ``capture(gbdt)``
    picks the first tree whose inputs (gradients, mask, shrinkage) are
    kept for the plain re-grow."""

    def __init__(self, gbdt, capture):
        self.gbdt, self.capture = gbdt, capture
        self.bags, self.goss, self.drops = [], [], []
        self.trees, self.k1_rows, self.kept = [], [], None

    def __enter__(self):
        from lightgbm_tpu_torch.models import dart as dart_mod
        from lightgbm_tpu_torch.models import gbdt as gbdt_mod
        from lightgbm_tpu_torch.models import goss as goss_mod
        from lightgbm_tpu_torch.ops import leafhist as lh
        g = self.gbdt
        self._saved = [(gbdt_mod, "device_bag_mask"),
                       (lh, "digit_histogram"),
                       (goss_mod.GOSS, "_sample"),
                       (dart_mod.DART, "_select_dropping_trees")]
        self._saved = [(m, a, getattr(m, a)) for m, a in self._saved]
        bag, k1, sample, select = (fn for _, _, fn in self._saved)

        def bag_mask(key, n, cnt, n_real, device):
            out = bag(key, n, cnt, n_real, device)
            self.bags.append((key, n, cnt, n_real, out.cpu()))
            return out

        def k1_counted(bins, digits, max_bin, start=0, count=None, **kw):
            self.k1_rows.append(bins.shape[0] - start if count is None
                                else int(count))
            return k1(bins, digits, max_bin, start, count, **kw)

        def goss_sample(booster, grad, hess):
            key = booster._goss_key
            out = sample(booster, grad, hess)
            self.goss.append((key, grad.cpu(), hess.cpu(),
                              *(t.cpu() for t in out)))
            return out

        def drop_select(booster):
            select(booster)
            self.drops.append((list(booster.drop_index),
                               booster.shrinkage_rate))

        gbdt_mod.device_bag_mask = bag_mask
        lh.digit_histogram = k1_counted
        goss_mod.GOSS._sample = goss_sample
        dart_mod.DART._select_dropping_trees = drop_select
        grow = self._grow = g._grow

        def grow_recorded(grad, hess):
            self.trees.append({"round": g.iter_,
                               "feat_mask": g._feat_mask.cpu(),
                               "weight": g._round_weight,
                               "k1_first": len(self.k1_rows)})
            if self.kept is None and self.capture(g):
                self.kept = {"tree": len(self.trees) - 1,
                             "grad": grad.clone(), "hess": hess.clone(),
                             "weight": g._round_weight,
                             "feat_mask": g._feat_mask,
                             "lr": g.shrinkage_rate}
            return grow(grad, hess)
        g._grow = grow_recorded
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self.gbdt._grow = self._grow


def goss_cpu_replay(gbdt, key, grad, hess):
    """The GOSS draw of ``gbdt`` (a card booster) recomputed on the CPU
    from the same key and host gradients."""
    from lightgbm_tpu_torch.models.goss import GOSS
    ns = types.SimpleNamespace(
        num_data=gbdt.num_data, top_rate=gbdt.top_rate,
        other_rate=gbdt.other_rate, _padded_rows=gbdt._padded_rows,
        _goss_key=key, _ones_weight=torch.ones(gbdt.num_data))
    return GOSS._sample(ns, grad, hess)


def dart_cpu_replay(cfg, rounds):
    """(drop index, shrinkage) of each of ``rounds`` DART rounds and the
    final tree weights, replayed on the host from ``drop_seed``: the
    drop selection of ``DART`` on a fresh generator, and the
    reference's weight bookkeeping (dart.hpp Normalize)."""
    from lightgbm_tpu_torch.models.dart import DART
    ns = types.SimpleNamespace(
        drop_rate=cfg.drop_rate, max_drop=cfg.max_drop,
        skip_drop=cfg.skip_drop, uniform_drop=cfg.uniform_drop,
        xgboost_dart_mode=cfg.xgboost_dart_mode, config=cfg,
        _drop_rng=np.random.RandomState(cfg.drop_seed), tree_weights=[],
        sum_weight=0.0, drop_index=[], iter_=0)
    lr, out = cfg.learning_rate, []
    for _ in range(rounds):
        DART._select_dropping_trees(ns)
        out.append((list(ns.drop_index), ns.shrinkage_rate))
        ns.tree_weights.append(ns.shrinkage_rate)
        ns.sum_weight += ns.shrinkage_rate
        k = float(len(ns.drop_index))
        plus = lr if cfg.xgboost_dart_mode else 1.0
        for it in ns.drop_index:
            if not cfg.uniform_drop:
                ns.sum_weight -= ns.tree_weights[it] / (k + plus)
                ns.tree_weights[it] *= k / (k + plus)
        ns.iter_ += 1
    return out, ns.tree_weights


def sampling_run(name, params, rounds, kind, kernel, train_set, X, workdir,
                 capture):
    """``rounds`` rounds of one sampled configuration through
    ``Booster.update`` on the card, the launch counters set to 0 first.
    Checks (a) every bag mask, GOSS draw (mask and amplified gradients)
    and feature mask against the same draw on the CPU, bit for bit;
    (b) the histogram kernel's launches (the ordered grower: Σ over
    trees of the leaves; a fixed-trip grower: rounds × L); (c) for the
    ordered grower, each tree's root window is its sample (compacted)
    and no window is larger; (d) the first tree ``capture`` picks,
    re-grown from its gradients, mask and shrinkage through the plain
    versions (bit-identical for the ordered grower; the fixed-trip
    growers as the train phase holds them); (e) DART's drops and
    shrinkage against the host replay; (f) the saved model through K4
    against the score buffer; (g) the training metric improves.
    Returns (the fields to print, the launches)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.gbdt import device_bag_mask
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    booster = lt.Booster(params=params, train_set=train_set)
    gbdt = booster._booster
    check(gbdt.grow_kind == kind, f"{name}: grew with {gbdt.grow_kind}")
    N, K, L = gbdt.num_data, gbdt.num_class, params["num_leaves"]
    lh.reset_launch_counts()
    ch.reset_launch_counts()
    fw.reset_launch_counts()
    seconds, evals = [], []
    with _draw_recorder(gbdt, capture) as rec:
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            booster.update()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            evals.append(booster.eval_train())
    launches = {**lh.launch_counts(), **ch.launch_counts()}
    grown = list(gbdt.tree_arrays)
    check(len(grown) == rounds * K == len(rec.trees),
          f"{name}: {len(grown)} trees grown, {len(rec.trees)} recorded")

    # (a) the draws against the CPU's
    for key, n, cnt, n_real, got in rec.bags:
        want = device_bag_mask(key, n, cnt, n_real, "cpu")
        check(torch.equal(got, want) and int(got.sum()) == cnt,
              f"{name}: a bag mask differs from its CPU draw")
    for key, g, h, mask, g2, h2 in rec.goss:
        want = goss_cpu_replay(gbdt, key, g, h)
        check(all(torch.equal(a, b) for a, b in zip((mask, g2, h2), want)),
              f"{name}: a GOSS draw differs from its CPU draw")
    frac = gbdt.config.feature_fraction
    rng = np.random.RandomState(gbdt.config.feature_fraction_seed)
    F = gbdt.num_features
    for t in rec.trees:
        want = torch.ones(F, dtype=torch.bool)
        if frac < 1.0:
            want = torch.zeros(F, dtype=torch.bool)
            want[torch.from_numpy(rng.choice(F, max(1, int(F * frac)),
                                             replace=False))] = True
        check(torch.equal(t["feat_mask"], want),
              f"{name}: round {t['round']}'s feature mask differs from "
              f"the CPU's draw order")

    # (b) launches
    leaves = [int(ta.num_leaves) for ta in grown]
    want = sum(leaves) if kind == "ordered" else len(grown) * L
    check(launches[kernel] == want and len(rec.k1_rows)
          == launches["digit_histogram"],
          f"{name}: {kernel} launches {launches[kernel]} != {want}")
    check(all(v == 0 for k, v in launches.items() if k != kernel),
          f"{name}: another histogram kernel ran: {launches}")

    # (c) the ordered grower's windows
    for t in rec.trees:
        t["sample_rows"] = int((t.pop("weight") > 0).sum())
    classes, roots = {}, []
    for rows in rec.k1_rows:
        cls = str(1 << (rows - 1).bit_length()) if rows > 0 else "0"
        classes[cls] = classes.get(cls, 0) + 1
    if kind == "ordered":
        ends = [t["k1_first"] for t in rec.trees[1:]] + [len(rec.k1_rows)]
        for t, end in zip(rec.trees, ends):
            root = rec.k1_rows[t["k1_first"]]
            roots.append(root)
            check(root == t["sample_rows"]
                  and max(rec.k1_rows[t["k1_first"]:end]) <= root,
                  f"{name}: round {t['round']}'s root window {root} is not "
                  f"its sample of {t['sample_rows']} rows")

    # (d) the captured tree re-grown through the plain versions
    kept = rec.kept
    check(kept is not None, f"{name}: no tree was captured")
    saved = (gbdt._round_weight, gbdt._feat_mask, gbdt.shrinkage_rate)
    gbdt._round_weight, gbdt._feat_mask, gbdt.shrinkage_rate = (
        kept["weight"], kept["feat_mask"], kept["lr"])
    with _plain_kernels():
        ta, _, _ = gbdt._grow(kept["grad"], kept["hess"])
    gbdt._round_weight, gbdt._feat_mask, gbdt.shrinkage_rate = saved
    flip, rel = compare_regrown(grown[kept["tree"]], ta,
                                f"{name} tree {kept['tree']}",
                                exact=kind == "ordered")

    # (e) DART's drops
    dart = {}
    if rec.drops:
        replay, weights = dart_cpu_replay(gbdt.config, rounds)
        check(rec.drops == replay and weights == gbdt.tree_weights,
              f"{name}: drops {rec.drops} differ from the CPU replay "
              f"{replay}")
        dart = {"drops": [d for d, _ in rec.drops],
                "shrinkage": [s for _, s in rec.drops],
                "tree_weights": gbdt.tree_weights}

    # (f) the saved model through K4
    path = f"{workdir}/sampling_{name}.txt"
    booster.save_model(path)
    fw.reset_launch_counts()
    pred = lt.Booster(model_file=path).predict(X[:4096], raw_score=True)
    k4 = sum(fw.launch_counts().values())
    pred = pred.T if pred.ndim == 2 else pred[None]
    buf = gbdt.train_data.score[:, :4096].double().cpu().numpy()
    d_pred = float(np.abs(pred - buf).max())
    check(k4 > 0 and np.isfinite(pred).all() and d_pred <= 1e-5,
          f"{name}: saved model vs score buffer: {d_pred} ({k4} K4 "
          f"launches)")

    # (g) the training metric
    curve = {}
    for per_round in evals:
        for _, metric, value, bigger in per_round:
            curve.setdefault(metric, ([], bigger))[0].append(value)
    for metric, (values, bigger) in curve.items():
        check(all(np.isfinite(values))
              and (values[-1] > values[0] if bigger
                   else values[-1] < values[0]),
              f"{name}: training {metric} {values} does not improve")
    fields = {
        "run": name, "grower": kind, "rounds": rounds, "trees": len(grown),
        "params": {k: v for k, v in params.items()
                   if k not in TRAIN_PARAMS or TRAIN_PARAMS[k] != v},
        "round_s": seconds,
        "round_s_median_after_2": float(np.median(seconds[2:])),
        "leaves_per_tree": leaves, "launches": launches,
        "k4_launches": k4, "bag_draws": len(rec.bags),
        "goss_draws": len(rec.goss), "sample_rows_per_tree":
        [t["sample_rows"] for t in rec.trees], "root_windows": roots,
        "k1_launches_by_window_rows": dict(
            sorted(classes.items(), key=lambda kv: int(kv[0]))),
        "regrown_tree": kept["tree"], "regrown_near_tie_flip": flip,
        "regrown_max_value_diff_of_field_max": rel, **dart,
        "saved_model_vs_score_buffer": d_pred,
        "training_metric": {m: v for m, (v, _) in curve.items()}}
    return fields, {**launches, "forest_walk": k4}, gbdt


def phase_sampling(seed, datasets, multiclass, workdir, ordered_round_s,
                   reps):
    """Row and feature sampling, GOSS and DART on the card, at the train
    phase's width (1M Higgs-like rows, 28 features, 63 leaves, 255 bins):
    bagging at the regression example conf's settings (ordered, then a
    few rounds of the fused and nocache growers, so that K3 and K2 see a
    bag mask), GOSS (its warmup of int(1 / learning_rate) rounds, then
    sampling rounds), DART with the JAX defaults, and the objectives
    phase's 5-class set with a feature fraction (the per-class draw
    order).  Prints each run's seconds a round beside the train phase's
    unsampled ordered round, and the CUDA-event ms of one bag draw and
    one GOSS draw.  Returns the launches."""
    from lightgbm_tpu_torch.models.gbdt import device_bag_mask
    from lightgbm_tpu_torch.utils import random as jrandom
    train_set, _, X, _ = datasets
    mc_set, mc_rows = multiclass
    base = {**TRAIN_PARAMS, **CONST}
    N = train_set.num_data()
    runs = (
        ("bagging", {**base, **SAMPLING_BAG}, SAMPLING_ROUNDS, "ordered",
         "digit_histogram", train_set, X, lambda g: g._bag_cnt < N),
        ("bagging_fused", {**base, **SAMPLING_BAG, "serial_grow": "fused"},
         SAMPLING_SHORT_ROUNDS, "fused", "fused_split_candidates",
         train_set, X, lambda g: g._bag_cnt < N),
        ("bagging_nocache", {**base, **SAMPLING_BAG,
                             "histogram_pool_size": 1,
                             "memory_policy": "degrade"},
         SAMPLING_SHORT_ROUNDS, "nocache", "children_histograms",
         train_set, X, lambda g: g._bag_cnt < N),
        ("goss", {**base, **SAMPLING_GOSS}, SAMPLING_GOSS_ROUNDS, "ordered",
         "digit_histogram", train_set, X, lambda g: g._bag_cnt < N),
        ("dart", {**base, "boosting_type": "dart"}, SAMPLING_ROUNDS,
         "ordered", "digit_histogram", train_set, X,
         lambda g: bool(g.drop_index)),
        ("multiclass", {**OBJ_PARAMS, **SAMPLING_MULTICLASS},
         SAMPLING_MULTICLASS_ROUNDS, "ordered", "digit_histogram", mc_set,
         mc_rows, lambda g: True))
    total, out, boosters = {}, [], {}
    t0 = time.perf_counter()
    for name, params, rounds, kind, kernel, ds, rows, capture in runs:
        fields, launches, gbdt = sampling_run(
            name, params, rounds, kind, kernel, ds, rows, workdir, capture)
        fields["unsampled_ordered_round_s"] = ordered_round_s
        emit({"phase": "sampling", **fields})
        out.append(fields)
        boosters[name] = gbdt
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    # one draw of each, by CUDA events
    dev = torch.device("cuda", 0)
    bag = boosters["bagging"]
    cnt = int(bag.config.bagging_fraction * N)
    key = jrandom.split(jrandom.prng_key(seed))[1]
    bag_ms = cuda_ms(lambda: device_bag_mask(key, bag._padded_rows, cnt, N,
                                             dev), reps)
    goss = boosters["goss"]
    g, h = goss.objective.gradients_with(goss._grad_arrays,
                                         goss.train_data.score)
    goss_ms = cuda_ms(lambda: goss._sample(g, h), reps)
    emit({"phase": "sampling_summary", "rows": N,
          "round_s_median_after_2": {f["run"]: f["round_s_median_after_2"]
                                     for f in out},
          "unsampled_ordered_round_s": ordered_round_s,
          "bag_draw_ms": bag_ms, "goss_draw_ms": goss_ms,
          "launches": total, "seconds": time.perf_counter() - t0})
    return total


# ---------------------------------------------------------------------------
# the engine: continued training, rollback, early stopping, leaf-index
# predict, merge and cv on the train phase's datasets


class _score_snapshots:
    """Callbacks for ``train``: a copy of every score buffer (training,
    then each valid set) at the start and after each round, by the
    model's iteration count."""

    def __init__(self):
        self.at = {}

    def _take(self, env, it):
        gb = env.model._booster
        self.at[it] = [dd.score.clone()
                       for dd in [gb.train_data] + gb.valid_data]

    def callbacks(self):
        def start(env):
            if env.iteration == env.begin_iteration:
                self._take(env, env.iteration)
        start.before_iteration = True

        def after(env):
            self._take(env, env.iteration + 1)
        return [start, after]


def _launches():
    """(K1 launches, K4 launches by variant) since the last reset."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    return lh.launch_counts()["digit_histogram"], fw.launch_counts()


def _reset_launches():
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    lh.reset_launch_counts()
    fw.reset_launch_counts()


def engine_base(name, params, rounds, train_set, valid_set, workdir):
    """``rounds`` rounds (kept in memory, and saved) and an uninterrupted
    ``2 * rounds`` run (saved), on a training set without init scores.
    Returns (the base Booster, its file, the long run's file, the
    base's seconds a round)."""
    import lightgbm_tpu_torch as lt
    common = dict(valid_sets=[valid_set], valid_names=["valid"],
                  verbose_eval=False)
    with _timed_calls() as base_rounds:
        base = lt.train(params, train_set, rounds, **common)
    base_path = f"{workdir}/engine_{name}_base.txt"
    base.save_model(base_path)
    full_path = f"{workdir}/engine_{name}_full.txt"
    lt.train(params, train_set, 2 * rounds, **common).save_model(full_path)
    return base, base_path, full_path, base_rounds.seconds


def engine_continued(name, params, rounds, train_set, valid_set, X,
                     workdir, bases):
    """``rounds`` more rounds from the base's saved file and from the
    in-memory base Booster (``bases``: ``engine_base``'s result).  Each
    continued run: its init scores from K4 (the variant of the model's
    leaves) within 1e-5 of the f64 host walk on the first HOST_WALK_ROWS
    rows, its carried trees' text byte-equal to the init model's, every
    tree structure-equal to the uninterrupted run's up to a reported
    near-tie, K1 launched once per leaf grown, and its saved model
    against its score buffer (1e-5).  Returns (the continued Boosters
    and their score snapshots by source, the summed K1 and K4 launches,
    the phase line's fields)."""
    import lightgbm_tpu_torch as lt
    base, base_path, full_path, base_round_s = bases
    with open(base_path) as fh:
        base_file = fh.read()
    with open(full_path) as fh:
        full_text = fh.read()
    variant = "forest_walk_linear" if params.get("linear_tree") \
        else "forest_walk"
    k1_total, k4_total, runs, boosters = 0, {}, {}, {}
    for src, init, init_text in (("file", base_path, base_file),
                                 ("booster", base, base.model_to_string())):
        snaps = _score_snapshots()
        _reset_launches()
        with _timed_calls() as cont_rounds, \
                _timed_calls("predict") as init_s:
            booster = lt.train(params, train_set, rounds, init_model=init,
                               valid_sets=[valid_set], valid_names=["valid"],
                               verbose_eval=False,
                               callbacks=snaps.callbacks())
        torch.cuda.synchronize()
        k1, k4 = _launches()
        gb = booster._booster
        new = gb.models[rounds:]
        check(booster.num_trees() == 2 * rounds
              and booster.current_iteration() == 2 * rounds,
              f"engine {name} {src}: {booster.num_trees()} trees")
        check(k1 == sum(t.num_leaves for t in new),
              f"engine {name} {src}: K1 launches {k1} != the "
              f"{sum(t.num_leaves for t in new)} leaves grown")
        check(k4[variant] > 0 and sum(k4.values()) == k4[variant],
              f"engine {name} {src}: init scores launched {k4}")
        predictor = (lt.Booster(model_file=base_path) if src == "file"
                     else base)
        init = np.asarray(train_set.get_init_score(), np.float64)
        host = predictor._booster.predict_raw(X[:HOST_WALK_ROWS])[0]
        d_init = float(np.abs(init[:HOST_WALK_ROWS] - host).max())
        check(d_init <= 1e-5, f"engine {name} {src}: init scores vs the f64 "
                              f"host walk: {d_init}")
        text = booster.model_to_string()
        check(trees_text(text, 0, rounds) == trees_text(init_text, 0, rounds),
              f"engine {name} {src}: carried trees' text differs")
        compared, flip, leaf_rel = compare_model_texts(
            text, full_text, f"engine {name} {src}",
            names=("continued", "uninterrupted"),
            leaf_rtol=LINEAR_LEAF_RTOL if params.get("linear_tree")
            else EXAMPLE_LEAF_RTOL)
        path = f"{workdir}/engine_{name}_{src}.txt"
        booster.save_model(path)
        pred = lt.Booster(model_file=path).predict(X[:4096], raw_score=True)
        buf = gb.train_data.score[0, :4096].double().cpu().numpy()
        d_pred = float(np.abs(pred - buf).max())
        check(d_pred <= 1e-5, f"engine {name} {src}: saved model vs score "
                              f"buffer: {d_pred}")
        k1_total += k1
        for k, v in k4.items():
            k4_total[k] = k4_total.get(k, 0) + v
        boosters[src] = (booster, snaps)
        runs[src] = {
            "round_s": cont_rounds.seconds,
            "round_s_median": float(np.median(cont_rounds.seconds)),
            "init_score_ms": [t * 1e3 for t in init_s.seconds],
            "k1_launches": k1,
            "k4_launches": {k: v for k, v in k4.items() if v},
            "init_vs_host_f64": d_init, "trees_compared": compared,
            "near_tie_flip": flip, "max_leaf_value_diff_of_tree_max":
            leaf_rel, "saved_model_vs_score_buffer": d_pred}
    fields = {"base_round_s": base_round_s,
              "base_round_s_median": float(np.median(base_round_s)),
              "continued": runs}
    return boosters, k1_total, k4_total, fields


def engine_rollback(booster, snaps, base_path, X, Xv, rounds):
    """ENGINE_ROLLBACKS rollbacks from the end of a continued run of
    ``rounds`` + ``rounds``: each score buffer within 1e-6 of the largest
    of the buffers that run recorded at that round, or, inside the init
    model's rounds, of the init model's own predictions (K4) on the first
    HOST_WALK_ROWS training rows and on the valid rows."""
    import lightgbm_tpu_torch as lt
    gb = booster._booster
    init = lt.Booster(model_file=base_path)
    worst = 0.0
    for _ in range(ENGINE_ROLLBACKS):
        booster.rollback_one_iter()
        it = gb.iter_
        got = [gb.train_data.score, gb.valid_data[0].score]
        if it in snaps.at:
            want = snaps.at[it]
        else:
            want = [torch.from_numpy(init.predict(
                rows, num_iteration=it, raw_score=True)).float()[None]
                for rows in (X[:HOST_WALK_ROWS], Xv)]
            got = [got[0][:, :HOST_WALK_ROWS], got[1]]
        for g, w in zip(got, want):
            w = w.to(g.device)
            d = float((g - w).abs().max() / w.abs().max())
            check(d <= 1e-6, f"engine rollback to round {it}: {d} of the "
                             f"largest score")
            worst = max(worst, d)
    check(gb.iter_ == 2 * rounds - ENGINE_ROLLBACKS < rounds
          and booster.num_trees() == gb.iter_,
          f"engine rollback: at round {gb.iter_}")
    return {"rollbacks": ENGINE_ROLLBACKS, "to_round": gb.iter_,
            "into_init_model_rounds": rounds - gb.iter_,
            "max_diff_of_largest_score": worst}


def engine_pred_leaf(booster, Xv):
    """``predict(pred_leaf=True)`` (the f64 host walk) on the valid rows
    ``Xv`` against the card's plain binned walk of each tree on the
    booster's valid set's bins: equal leaf ids."""
    from lightgbm_tpu_torch.ops.predict import predict_binned_tree
    gb = booster._booster
    leaves = booster.predict(Xv, pred_leaf=True)
    check(leaves.shape == (Xv.shape[0], booster.num_trees())
          and leaves.dtype == np.int32, f"pred_leaf shape {leaves.shape}")
    bins = gb.valid_data[0].bins
    ts = gb.train_set

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(bins.device)
    for i, tree in enumerate(gb.models):
        check(tree.ensure_inner(ts.real_to_inner, ts.mappers),
              f"pred_leaf tree {i}: no bins")
        _, leaf = predict_binned_tree(
            dev(tree.split_feature_inner.astype(np.int64)),
            dev(tree.threshold_in_bin), dev(tree.decision_type == 1),
            dev(tree.left_child), dev(tree.right_child),
            dev(tree.leaf_value.astype(np.float32)), bins, tree.num_leaves)
        check(np.array_equal(leaf.cpu().numpy(), leaves[:, i]),
              f"pred_leaf tree {i}: the host walk's leaves differ from the "
              f"binned walk's")
    return {"rows": int(leaves.shape[0]), "trees": int(leaves.shape[1])}


def engine_merge(base_path, other_path, Xv):
    """``merge(shrinkage_decay=0.5)`` predicts base + 0.5 * other (1e-5),
    through K4."""
    import lightgbm_tpu_torch as lt
    base = lt.Booster(model_file=base_path)
    other = lt.Booster(model_file=other_path)
    want = base.predict(Xv, raw_score=True) \
        + 0.5 * other.predict(Xv, raw_score=True)
    got = base.merge(other, shrinkage_decay=0.5).predict(Xv, raw_score=True)
    d = float(np.abs(got - want).max())
    check(d <= 1e-5 and np.isfinite(got).all(),
          f"merge: base + 0.5 * other off by {d}")
    return {"trees": base.num_trees(), "max_diff": d}


def engine_early_stop(train_set, valid_set):
    """A run that stops: its stop round and ``best_iteration``, the best
    round of its recorded valid history, ES_PATIENCE rounds before the
    last."""
    import lightgbm_tpu_torch as lt
    ev = {}
    booster = lt.train({**TRAIN_PARAMS, **CONST, **ES_PARAMS}, train_set,
                       ES_ROUNDS, valid_sets=[valid_set],
                       valid_names=["valid"],
                       early_stopping_rounds=ES_PATIENCE, evals_result=ev,
                       verbose_eval=False)
    hist = ev["valid"]["binary_logloss"]
    stop = booster.num_trees()
    check(stop < ES_ROUNDS and len(hist) == stop,
          f"early stopping: no stop in {ES_ROUNDS} rounds")
    best = 1 + int(np.argmin(hist))
    check(booster.best_iteration == best and stop - best == ES_PATIENCE,
          f"early stopping: best_iteration {booster.best_iteration}, best "
          f"recorded round {best}, stop round {stop}")
    return {"params": {**TRAIN_PARAMS, **CONST, **ES_PARAMS},
            "patience": ES_PATIENCE, "stop_round": stop,
            "best_iteration": booster.best_iteration,
            "valid_logloss": hist}


def engine_cv(seed, train_set):
    """HIGGS_CV_FOLDS-fold stratified ``cv`` at 1M rows, ENGINE_ROUNDS
    rounds, timed; K1 in every fold's rounds."""
    import lightgbm_tpu_torch as lt
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lt.cv({**TRAIN_PARAMS, **CONST}, train_set, ENGINE_ROUNDS,
                nfold=HIGGS_CV_FOLDS, stratified=True, seed=seed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1, k4 = _launches()
    auc = res["valid auc-mean"]
    check(len(auc) == ENGINE_ROUNDS and np.all(np.isfinite(auc))
          and auc[-1] > auc[0] > 0.5, f"cv: AUC means {auc}")
    check(k1 >= HIGGS_CV_FOLDS * ENGINE_ROUNDS and sum(k4.values()) == 0,
          f"cv: K1 {k1}, K4 {k4}")
    return {"folds": HIGGS_CV_FOLDS, "rounds": ENGINE_ROUNDS, "seconds": secs,
            "k1_launches": k1, "auc_mean": auc,
            "auc_stdv": res["valid auc-stdv"]}, k1


class _fold_scores:
    """A ``cv`` callback keeping each round's valid scores of every fold
    and the folds' Boosters."""

    def __init__(self):
        self.rounds = []
        self.boosters = None

    def __call__(self, env):
        self.boosters = env.model.boosters
        self.rounds.append([b._booster.valid_data[0].host_score()
                            for b in self.boosters])


def cv_ranking_metric(folds, rnd, name, digits=None):
    """(mean, stdv) over the folds of the ranking metric ``name`` from
    the valid scores the folds had after round ``rnd`` (1-based),
    rounded to ``digits`` significant digits first when given, as
    ``cv`` aggregates it."""
    from lightgbm_tpu_torch.metric import create_metric
    values = []
    for b, score in zip(folds.boosters, folds.rounds[rnd - 1]):
        if digits is not None:
            score = np.array([[float(f"{v:.{digits}g}") for v in score[0]]])
        vs = b._valid_sets[0].construct()._binned
        m = create_metric(name.split("@")[0], b.config)
        m.init(vs.metadata, vs.num_data)
        values.append(dict(zip(m.names, m.eval(score)))[name])
    return float(np.mean(values)), float(np.std(values))


def compare_cv(a, b, folds_a, folds_b, label):
    """Every round's mean and stdv of ``cv`` result ``a`` (the card's)
    against ``b`` (the CPU's) within 1e-4.  As in
    ``compare_round_metrics``, a ranking metric beyond it passes only
    when its recomputation from each run's fold scores gives the two
    results (1e-9) and the two agree within 1e-4 once the scores are
    rounded to 6 significant digits, which merges scores that tie in
    exact arithmetic.  Returns (max difference within 1e-4, the ties so
    explained)."""
    check(a.keys() == b.keys() and b, f"{label}: keys {a.keys()}")
    worst, ties = 0.0, []
    for key in sorted(b):
        for r, (x, z) in enumerate(zip(a[key], b[key]), start=1):
            d = abs(x - z)
            if d <= 1e-4:
                worst = max(worst, d)
                continue
            name, stat = key.split(" ", 1)[1].rsplit("-", 1)
            check(name.split("@")[0] in ("auc", "ndcg", "map"),
                  f"{label}: {key} round {r}: card {x}, CPU {z}")
            idx = 0 if stat == "mean" else 1
            exact = [cv_ranking_metric(f, r, name)[idx]
                     for f in (folds_a, folds_b)]
            check(abs(exact[0] - x) <= 1e-9 and abs(exact[1] - z) <= 1e-9,
                  f"{label}: {key} round {r} recomputed {exact}")
            rounded = [cv_ranking_metric(f, r, name, 6)[idx]
                       for f in (folds_a, folds_b)]
            check(abs(rounded[0] - rounded[1]) <= 1e-4,
                  f"{label}: {key} round {r} beyond 1e-4 after rounding: "
                  f"{rounded}")
            ties.append({"key": key, "round": r, "card": x, "cpu": z,
                         "rounded_6_digits": rounded})
            print(f"{label}: ranking metric at a near-tie of scores "
                  f"{ties[-1]}", file=sys.stderr)
    return worst, ties


def engine_example(workdir):
    """On the binary example conf's data, the card against the CPU: a
    CV_FOLDS-fold stratified ``cv`` of the conf's parameters
    (ENGINE_ROUNDS rounds; every
    mean and stdv as ``compare_cv`` holds them) and the conf through the
    CLI with ``early_stopping_round=3`` (learning rate EXAMPLE_ES_LR):
    the same stop round and best round, every round's metrics as
    ``compare_round_metrics`` holds them, the trees structure-equal up
    to a reported near-tie.  Returns (K1 launches on the card, fields)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import parse_config_file
    work = f"{workdir}/engine_example"
    conf = copy_example("binary", "binary_classification", work)
    out, k1_card = {}, 0
    with in_dir(work):
        params = {k: v for k, v in parse_config_file(conf).items()
                  if k not in ("task", "data", "valid_data", "output_model",
                               "num_trees", "metric_freq",
                               "is_training_metric")}
        cvs, folds, logs, best = {}, {}, {}, {}
        for dev in ("cuda", "cpu"):
            _reset_launches()
            folds[dev] = _fold_scores()
            cvs[dev] = lt.cv(params, lt.Dataset("binary.train",
                                                params=params),
                             ENGINE_ROUNDS, nfold=CV_FOLDS, stratified=True,
                             device=dev, callbacks=[folds[dev]])
            logs[dev] = _cli([f"config={conf}", f"device={dev}",
                              "early_stopping_round=3",
                              f"learning_rate={EXAMPLE_ES_LR}",
                              f"output_model=es_{dev}.txt"])
            k1, _ = _launches()
            check((k1 > 0) == (dev == "cuda"),
                  f"example engine: K1 launches {k1} on {dev}")
            k1_card += k1 if dev == "cuda" else 0
            lines = logs[dev].splitlines()
            at = [i for i, ln in enumerate(lines) if "Early stopping" in ln]
            check(len(at) == 1, f"example engine: no early stop on {dev}")
            best[dev] = int(lines[at[0] + 1].split("]")[0].lstrip("["))
        d_cv, cv_ties = compare_cv(cvs["cuda"], cvs["cpu"], folds["cuda"],
                                   folds["cpu"], "example cv")
        metrics = {d: round_metrics(logs[d]) for d in logs}
        stop = {d: max(k[0] for k in metrics[d]) for d in metrics}
        check(stop["cuda"] == stop["cpu"] and best["cuda"] == best["cpu"],
              f"example early stop: stop {stop}, best {best}")
        worst, ties = compare_round_metrics(
            metrics["cuda"], metrics["cpu"], work, conf,
            "example early stop", ("es_cuda.txt", "es_cpu.txt"))
        with open("es_cuda.txt") as a, open("es_cpu.txt") as b:
            compared, flip, _ = compare_model_texts(
                a.read(), b.read(), "example early stop")
    out = {"cv_max_diff_card_vs_cpu": d_cv, "cv_ranking_metric_ties": cv_ties,
           "cv_auc_mean": cvs["cuda"]["valid auc-mean"],
           "es_stop_round": stop["cuda"], "es_best_round": best["cuda"],
           "es_max_metric_diff": worst, "es_ranking_metric_ties": ties,
           "es_trees_compared": compared, "es_near_tie_flip": flip}
    return k1_card, out


def phase_engine(seed, datasets, workdir):
    """The engine on the train phase's datasets (the Higgs training
    cell): the early-stopped run, ``cv`` and the base runs first (the
    training set has no init scores yet), then continued training
    (constant 6 + 6, linear 3 + 3; ``engine_continued``), ``pred_leaf``
    of the file-continued constant run, 8 rollbacks from its round 12,
    ``merge``, and the binary example conf card against CPU.  The launch counters are set to
    0 before each counted run and read after it.  Returns the launches."""
    train_set, valid_set, X, Xv = datasets
    k1_total, k4_total = 0, {}
    t0 = time.perf_counter()
    early = engine_early_stop(train_set, valid_set)
    cv_fields, k1 = engine_cv(seed, train_set)
    k1_total += k1
    configs = (("constant", {**TRAIN_PARAMS, **CONST}, ENGINE_ROUNDS),
               ("linear", {**TRAIN_PARAMS, **LINEAR_PARAMS},
                ENGINE_LINEAR_ROUNDS))
    # every run from scratch before the first continued one bins the
    # training set again with its init model's scores
    bases = {name: engine_base(name, params, rounds, train_set, valid_set,
                               workdir)
             for name, params, rounds in configs}
    runs = {}
    for name, params, rounds in configs:
        boosters, k1, k4, fields = engine_continued(
            name, params, rounds, train_set, valid_set, X, workdir,
            bases[name])
        k1_total += k1
        for k, v in k4.items():
            k4_total[k] = k4_total.get(k, 0) + v
        runs[name] = fields
        if name == "constant":
            _, base_path, full_path, _ = bases[name]
            booster, snaps = boosters["file"]
            leaf = engine_pred_leaf(booster, Xv)
            rollback = engine_rollback(booster, snaps, base_path, X, Xv,
                                       rounds)
            _reset_launches()
            merged = engine_merge(base_path, full_path, Xv)
            k4 = _launches()[1]
            check(k4["forest_walk"] > 0, f"merge: K4 launches {k4}")
            merged["k4_launches"] = k4["forest_walk"]
            k4_total["forest_walk"] += k4["forest_walk"]
    k1, example = engine_example(workdir)
    k1_total += k1
    emit({"phase": "engine", "rows": train_set.num_data(),
          "valid_rows": valid_set.num_data(), "params": TRAIN_PARAMS,
          "runs": runs, "rollback": rollback, "pred_leaf": leaf,
          "merge": merged, "early_stopping": early, "cv": cv_fields,
          "binary_example": example, "k1_launches": k1_total,
          "k4_launches": k4_total,
          "seconds": time.perf_counter() - t0})
    return {"digit_histogram": k1_total, **k4_total}


# ---------------------------------------------------------------------------
# causal tracing and the run's record


TEL_ROUNDS = 10
TEL_SCRAPE_S = 0.2             # the scraper's period
# a serving client's requests a server, sizes in turn: 4 servers x 4
# clients x 32, so each mode takes 2 x 4 x 32 = 256 requests
TEL_REQUESTS = 16
TEL_FAMILY = "lightgbm_tpu_phase_seconds_gbdt_iteration"


class _timed_exports:
    """The seconds of every ``TRACER.maybe_export()`` made inside the
    block (the export at the end of a run or at a server's stop)."""

    def __enter__(self):
        from lightgbm_tpu_torch.obs import tracing
        self.tracer, self.seconds = tracing.TRACER, []
        orig = self.tracer.maybe_export

        def timed():
            t0 = time.perf_counter()
            out = orig()
            self.seconds.append(time.perf_counter() - t0)
            return out
        self.tracer.maybe_export = timed
        return self

    def __exit__(self, *exc):
        del self.tracer.maybe_export


def _scrape_metrics(port):
    """One ``/metrics`` scrape: (ms, the text)."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        text = resp.read().decode()
    return (time.perf_counter() - t0) * 1e3, text


# a scraper in a process of its own, as Prometheus scrapes a training job:
# standard library only, so that its fetches take nothing of the training
# process but the listener's render.  One JSON line a scrape, {"ms",
# "text"}, or {"error"} for a failure after the first answer.
SCRAPER = r"""
import json, sys, time, urllib.error, urllib.request
port, out, period = int(sys.argv[1]), sys.argv[2], float(sys.argv[3])
answered = False
with open(out, "w") as fh:
    while True:
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
                text = resp.read().decode()
        except (urllib.error.URLError, OSError) as exc:
            if answered:
                fh.write(json.dumps({"error": repr(exc)}) + "\n")
                fh.flush()
            time.sleep(0.01 if not answered else period)
            continue
        answered = True
        fh.write(json.dumps({"ms": (time.perf_counter() - t0) * 1e3,
                             "text": text}) + "\n")
        fh.flush()
        time.sleep(period)
"""


class _Scraper:
    """The SCRAPER process against the training listener, every
    TEL_SCRAPE_S from the moment it answers; ``final`` (the run's last
    round's callback) stops it and makes the last scrape from this
    process.  ``results`` parses every text after ``train`` (timed: the
    seconds a scrape's parse would take in the training process)."""

    def __init__(self, port, path):
        self.port, self.path, self.final_scrape = port, path, None
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SCRAPER, str(port), path,
             str(TEL_SCRAPE_S)], stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
        self.proc.wait(30)

    def final(self, env):
        if env.iteration != env.end_iteration - 1:
            return
        self.stop()
        self.final_scrape = _scrape_metrics(self.port)

    def results(self):
        from lightgbm_tpu_torch.obs import prom
        lines = []          # a run shorter than the process's start has none
        if os.path.exists(self.path):
            with open(self.path) as fh:
                lines = [json.loads(ln) for ln in fh if ln.endswith("\n")]
        scrapes = [ln for ln in lines if "text" in ln]
        if self.final_scrape is not None:
            ms, text = self.final_scrape
            scrapes.append({"ms": ms, "text": text})
        out = {"scrape_ms": [], "scrape_counts": [], "parse_ms": [],
               "scrape_bytes": [], "scrape_errors": [
                   ln["error"] for ln in lines if "error" in ln]}
        for sc in scrapes:
            t0 = time.perf_counter()
            try:
                parsed = prom.parse_text(sc["text"])
            except ValueError as exc:      # checked by the phase
                out["scrape_errors"].append(repr(exc))
                continue
            out["parse_ms"].append((time.perf_counter() - t0) * 1e3)
            out["scrape_ms"].append(sc["ms"])
            out["scrape_bytes"].append(len(sc["text"]))
            out["scrape_counts"].append(
                prom.histogram_series(parsed, TEL_FAMILY)["count"] or 0)
        return out


def telemetry_run(name, params, rounds, train_set, valid_set, workdir):
    """``rounds`` rounds of the training cell, bare or (``name`` ending
    in ``instrumented``) with ``events_file``, ``trace_events_file`` and a
    ``metrics_port`` scraped from a process of its own.  The launch and
    host-read counters set to 0 before, read after."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import metrics_server
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import grow as gr
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    from lightgbm_tpu_torch.parallel.launch import free_port
    out = {"name": name}
    callbacks, scraper = [], None
    if "instrumented" in name:
        port = free_port()
        out.update(events=f"{workdir}/tel_{name}.jsonl",
                   trace=f"{workdir}/tel_{name}_trace.json", port=port)
        params = {**params, "events_file": out["events"],
                  "trace_events_file": out["trace"], "metrics_port": port}
        hist = obs.get_histogram("phase_seconds_gbdt_iteration")
        out["count0"] = hist["count"] if hist else 0
        scraper = _Scraper(port, f"{workdir}/tel_{name}_scrapes.jsonl")
        callbacks.append(scraper.final)
    lh.reset_launch_counts()
    ch.reset_launch_counts()
    og.reset_host_syncs()
    gr.reset_host_syncs()
    torch.cuda.synchronize()
    try:
        with _timed_calls() as timer, _timed_exports() as exports:
            booster = lt.train(params, train_set, rounds,
                               valid_sets=[valid_set],
                               valid_names=["valid"], verbose_eval=False,
                               callbacks=callbacks)
    finally:
        if scraper is not None:
            scraper.stop()
    torch.cuda.synchronize()
    out.update(booster=booster, round_s=timer.seconds,
               k1=lh.launch_counts()["digit_histogram"],
               k3=ch.launch_counts()["fused_split_candidates"],
               syncs_per_tree=(og.host_syncs() + gr.host_syncs())
               / booster.num_trees(), export_s=exports.seconds,
               listener_after=metrics_server.active_server())
    if scraper is not None:
        out.update(scraper.results())
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=2)
            out["port_open_after"] = True
        except OSError:
            out["port_open_after"] = False
    return out


def _load(base, bodies, clients):
    """``clients`` threads, each sending TEL_REQUESTS requests, the
    sizes of SERVE_SIZES in turn (bodies encoded beforehand); the
    latency ms of each request by size."""
    lat = {n: [] for n in SERVE_SIZES}
    failures = []

    def client(c):
        try:
            for i in range(TEL_REQUESTS):
                n = SERVE_SIZES[(i + c) % len(SERVE_SIZES)]
                req = urllib.request.Request(
                    base + "/predict", data=bodies[n],
                    headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                resp = json.loads(urllib.request.urlopen(
                    req, timeout=120).read())
                lat[n].append((time.perf_counter() - t0) * 1e3)
                check(resp["num_rows"] == n, "num_rows mismatch")
        except BaseException as exc:        # re-raised below
            failures.append(repr(exc))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not failures, f"telemetry serving clients: {failures}")
    return lat


def _percentiles(lat):
    every = [v for vs in lat.values() for v in vs]
    return {"p50_ms": float(np.percentile(every, 50)),
            "p99_ms": float(np.percentile(every, 99)),
            **{str(n): {"p50_ms": float(np.percentile(v, 50)),
                        "p99_ms": float(np.percentile(v, 99))}
               for n, v in lat.items()}}


def _serve_pass(model_path, bodies, trace=None):
    """One server of the Higgs forest from ``serve_from_config``, with
    ``trace_events_file=trace`` in its configuration when ``trace`` is
    given (no key disarms the tracer): one warm-up request a size from
    one client, then the measured load; ``stop()`` exports the trace.
    Returns the load's latencies, the K4 launches of the warm-up and the
    load, and the export's seconds."""
    from lightgbm_tpu_torch.config import Config, parse_cli_args
    from lightgbm_tpu_torch.obs import tracing
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.serve.server import serve_from_config
    argv = ["task=serve", f"input_model={model_path}", "serve_port=0",
            "serve_max_batch=4096", "serve_max_delay_ms=2"]
    if trace:
        argv.append(f"trace_events_file={trace}")
    srv = started(serve_from_config(Config(parse_cli_args(argv))))
    try:
        check(tracing.TRACER.enabled == bool(trace),
              f"serve_from_config left the tracer enabled="
              f"{tracing.TRACER.enabled} with trace_events_file={trace}")
        host, port = srv.address
        base = f"http://{host}:{port}"
        fw.reset_launch_counts()
        for n in SERVE_SIZES:
            urllib.request.urlopen(urllib.request.Request(
                base + "/predict", data=bodies[n],
                headers={"Content-Type": "application/json"}),
                timeout=120).read()
        lat = _load(base, bodies, SERVE_CLIENTS)
        torch.cuda.synchronize()
        k4 = {k: v for k, v in fw.launch_counts().items() if v}
    finally:
        with _timed_exports() as exports:
            srv.stop()
    return lat, k4, exports.seconds


def _check_serve_trace(trace, k4):
    """Every request of one traced server (the warm-ups included) has
    ``Serve::queue -> Serve::batch -> Predict::forest`` on its critical
    path, and the ``Predict::forest`` spans are the server's K4
    launches.  Returns the trace's counts."""
    from lightgbm_tpu_torch.obs import tracing
    events = tracing.read_trace(trace)
    tree = tracing.span_trees(events)
    spans = tree["spans"]
    requests = [s for s, e in spans.items() if e["name"] == "Serve::request"]
    n_req = SERVE_CLIENTS * TEL_REQUESTS + len(SERVE_SIZES)
    check(len(requests) == n_req,
          f"{len(requests)} Serve::request spans for {n_req} requests")
    margins = []
    for r in requests:
        path_names = [st["name"] for st in tracing.critical_path(tree, r)]
        check(path_names[0] == "Serve::request" and path_names[-3:] == [
            "Serve::queue", "Serve::batch", "Predict::forest"],
            f"request {spans[r]['args']['request_id']}: critical path "
            f"{path_names}")
        kids = {spans[k]["name"]: spans[k]["dur"]
                for k in tree["children"][r]}
        margins.append(kids["Serve::queue"] - kids["Serve::dispatch"])
    forests = sum(1 for e in spans.values()
                  if e["name"] == "Predict::forest")
    check(forests == sum(k4.values()),
          f"{forests} Predict::forest spans, K4 launches {k4}")
    return {"requests": n_req, "predict_forest_spans": forests,
            "spans_per_request": sum(1 for e in events if e.get("ph") == "X")
            / n_req, "queue_minus_dispatch_us_min": float(min(margins)),
            "export_bytes": os.path.getsize(trace)}


def telemetry_serving(seed, higgs_model, higgs_grid, workdir):
    """The Higgs forest served with the same load from four servers in
    turn, untraced, traced, traced, untraced (the traced ones with
    ``trace_events_file`` in their configuration, as a user sets it), so
    that warm-up and order weigh on both modes alike.  Returns the
    phase's serving fields and its K4 launches."""
    from lightgbm_tpu_torch.obs import tracing
    path = f"{workdir}/tel_higgs_model.txt"
    with open(path, "w") as fh:
        fh.write(higgs_model.save_model_to_string())
    rng = np.random.RandomState(seed + 70)
    bodies = {n: json.dumps({"rows": random_rows(
        rng, n, higgs_grid, tie_frac=0.02).tolist()}).encode()
        for n in SERVE_SIZES}
    lat = {"untraced": [], "traced": []}
    passes, k4_all = [], {}
    for i, mode in enumerate(("untraced", "traced", "traced", "untraced")):
        trace = f"{workdir}/tel_serve_trace{i}.json" \
            if mode == "traced" else None
        got, k4, export_s = _serve_pass(path, bodies, trace)
        lat[mode].append(got)
        one = {"mode": mode, **_percentiles(got), "k4_launches": k4}
        if trace:
            one.update(_check_serve_trace(trace, k4), export_s=export_s,
                       summary_roots=tracing.summarize_traces(
                           [trace], top_k=3)["roots"])
        passes.append(one)
        for k, v in k4.items():
            k4_all[k] = k4_all.get(k, 0) + v
    check(not tracing.TRACER.enabled, "the tracer armed after the last "
          "untraced server")
    traces = [f"{workdir}/tel_serve_trace{i}.json" for i in (1, 2)]
    summary = tracing.summarize_traces(traces, top_k=3)
    check(summary["traces"] >= 2 * SERVE_CLIENTS * TEL_REQUESTS,
          "summarize_traces lost traces")
    pooled = {mode: _percentiles({n: [v for got in runs for v in got[n]]
                                  for n in SERVE_SIZES})
              for mode, runs in lat.items()}
    return {**pooled, "order": [p["mode"] for p in passes],
            "passes": passes, "batches": summary["coalesce"],
            "roots": summary["roots"]}, k4_all


def _check_instrumented(inst):
    """One instrumented run's record: the events file's records are the
    model's trees (leaves, depths) with their valid AUC, the trace's
    GBDT::iteration roots one a round, every scrape parsed and the last
    counting every round, the listener closed after ``train``."""
    from lightgbm_tpu_torch.obs import read_events, tracing
    name = inst["name"]
    records = read_events(inst["events"])
    models = inst["booster"]._booster.models
    check([r["iter"] for r in records] == list(range(TEL_ROUNDS)),
          f"{name}: event records {[r['iter'] for r in records]}")
    check([r["trees"] for r in records] == [
        [{"num_leaves": int(t.num_leaves), "max_depth": int(t.max_depth())}]
        for t in models], f"{name}: event trees differ from the model's")
    check(all("auc" in r["eval"]["valid"] for r in records),
          f"{name}: a record without its valid AUC")
    tree = tracing.span_trees(tracing.read_trace(inst["trace"]))
    roots = [tree["spans"][s]["name"] for s in tree["roots"]]
    check(roots == ["GBDT::iteration"] * TEL_ROUNDS,
          f"{name}: trace roots {roots}")
    check(not inst["scrape_errors"],
          f"{name}: scrapes failed: {inst['scrape_errors']}")
    done = [c - inst["count0"] for c in inst["scrape_counts"]]
    check(len(done) >= 2 and done[-1] == TEL_ROUNDS
          and done == sorted(done), f"{name}: scraped rounds {done}")
    check(inst["listener_after"] is None and not inst["port_open_after"],
          f"{name}: the /metrics listener outlived train()")


def phase_telemetry(seed, datasets, higgs_model, higgs_grid, workdir):
    """Causal tracing and the run's record on the card.  The training
    cell (the train phase's datasets; ordered grower), TEL_ROUNDS rounds
    four times in turn: bare, with ``events_file``, ``trace_events_file``
    and ``metrics_port`` scraped every TEL_SCRAPE_S from a process of its
    own (``SCRAPER``), so
    instrumented again, and bare again (order and warm-up weigh on both
    modes alike).  The four model texts byte-equal, the host reads a
    tree and K1's launches unchanged, each instrumented run's record
    checked (``_check_instrumented``), and ``python -m lightgbm_tpu_torch
    obs-report`` over the first one's two files exits 0.  One
    fused-grower round bare and with ``events_file``: one host read a
    tree (K3).  Then ``telemetry_serving``.  Returns the launches."""
    train_set, valid_set, _, _ = datasets
    t_phase = time.perf_counter()
    params = {**TRAIN_PARAMS, **CONST}
    runs = [telemetry_run(name, params, TEL_ROUNDS, train_set, valid_set,
                          workdir)
            for name in ("bare", "instrumented", "instrumented_2",
                         "bare_2")]
    text = runs[0]["booster"].model_to_string()
    for run in runs[1:]:
        check(run["booster"].model_to_string() == text,
              f"telemetry: the {run['name']} model text differs from the "
              f"bare")
        check(run["k1"] == runs[0]["k1"] > 0,
              f"telemetry: K1 launches {run['k1']} against {runs[0]['k1']}")
        check(run["syncs_per_tree"] == runs[0]["syncs_per_tree"],
              f"telemetry {run['name']}: host reads a tree "
              f"{run['syncs_per_tree']} against {runs[0]['syncs_per_tree']}")
    insts = [run for run in runs if "instrumented" in run["name"]]
    for inst in insts:
        _check_instrumented(inst)
    inst = insts[0]
    # the two reports in two processes at once (each imports torch)
    t0 = time.perf_counter()
    procs = {flag: subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "obs-report",
         "--format=json", *([flag] if flag else []), path], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for flag, path in (("", inst["events"]),
                           ("--traces", inst["trace"]))}
    reports = {}
    for flag, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"obs-report {flag}: {err[-2000:]}")
        reports[flag or "events"] = json.loads(out)
    check(reports["events"]["iterations"] == TEL_ROUNDS,
          "obs-report: rounds")
    check(reports["--traces"]["roots"]["GBDT::iteration"]["count"]
          == TEL_ROUNDS, "obs-report --traces: rounds")
    report_s = time.perf_counter() - t0
    fused = [telemetry_run(name, {**params, "serial_grow": "fused"}, 1,
                           train_set, valid_set, workdir)
             for name in ("fused_bare", "fused_instrumented")]
    for run in fused:
        check(run["syncs_per_tree"] == 1 and run["k3"] > 0,
              f"telemetry {run['name']}: {run['syncs_per_tree']} host "
              f"reads a tree, K3 {run['k3']}")
    check(fused[0]["booster"].model_to_string()
          == fused[1]["booster"].model_to_string(),
          "telemetry: the fused model texts differ")
    serving, k4 = telemetry_serving(seed, higgs_model, higgs_grid, workdir)
    # rounds 3-10 of each run, pooled by mode and run by run
    median = {mode: float(np.median([v for run in runs
                                     if run["name"].startswith(mode)
                                     for v in run["round_s"][2:]]))
              for mode in ("bare", "instrumented")}
    k1 = sum(run["k1"] for run in runs)
    scrape_ms = [v for run in insts for v in run["scrape_ms"]]
    parse_ms = [v for run in insts for v in run["parse_ms"]]
    emit({"phase": "telemetry", "rows": train_set.num_data(),
          "params": params, "rounds": TEL_ROUNDS,
          "order": [run["name"] for run in runs],
          "round_s_median_3_10": median,
          "round_s_median_3_10_by_run": {
              run["name"]: float(np.median(run["round_s"][2:]))
              for run in runs},
          "round_s": {run["name"]: run["round_s"] for run in runs},
          "host_syncs_per_tree": {run["name"]: run["syncs_per_tree"]
                                  for run in (*runs, *fused)},
          "k1_launches": k1,
          "k3_launches": sum(run["k3"] for run in fused),
          "scrapes": len(scrape_ms),
          "scrape_ms_median": float(np.median(scrape_ms)),
          "scrape_ms_max": float(max(scrape_ms)),
          "scrape_parse_ms_median": float(np.median(parse_ms)),
          "scrape_parse_ms_max": float(max(parse_ms)),
          "scrape_bytes_max": max(v for run in insts
                                  for v in run["scrape_bytes"]),
          "train_export_s": [s for run in insts for s in run["export_s"]],
          "train_trace_bytes": os.path.getsize(inst["trace"]),
          "events_bytes": os.path.getsize(inst["events"]),
          "obs_report_s": report_s, "serving": serving,
          "seconds": time.perf_counter() - t_phase})
    return {"digit_histogram": k1,
            "fused_split_candidates": sum(run["k3"] for run in fused),
            **k4}


# ---------------------------------------------------------------------------
# device-time attribution: devprof, the trace window, TIMETAG, memwatch,
# the compile ledger, the last fault injectors


ATTR_ROUNDS = 10               # ordered rounds a devprof mode
ATTR_FULL_ROUNDS = 3           # fused and nocache rounds under devprof=full
ATTR_TIMETAG_ROUNDS = 5
ATTR_POISON_UPDATES = 6
DEVPROF_SERIES = ("devprof_", "device_seconds", "memwatch_",
                  "compile_count", "nan_iterations_dropped")
# a subprocess builds P1's source into an empty directory with the ledger
# armed (nvcc for roll_chain, a plain C interface, takes seconds)
LEDGER_BUILD = r"""
import json, pathlib, sys, time
from lightgbm_tpu_torch.obs import compile_ledger
from lightgbm_tpu_torch.ops import _build
_build.BUILD_DIR = pathlib.Path(sys.argv[1])
compile_ledger.configure(sys.argv[2])
t0 = time.perf_counter()
secs = _build.build_all(("roll_chain",))
print(json.dumps({"seconds": secs, "wall_s": time.perf_counter() - t0}))
"""


def _series_delta(before, after):
    """The attribution series of a block: counters and histograms
    ([count, sum]) by difference, gauges by their value after (a sample
    sets its program's gauges anew)."""
    def keep(n):
        return n.startswith(DEVPROF_SERIES)
    out = {"counters": {}, "histograms": {}, "gauges": {}}
    for n, v in after["counters"].items():
        d = v - before["counters"].get(n, 0)
        if keep(n) and d:
            out["counters"][n] = d
    for n, h in after["histograms"].items():
        h0 = before["histograms"].get(n, {"count": 0, "sum": 0.0})
        if keep(n) and h["count"] != h0["count"]:
            out["histograms"][n] = [h["count"] - h0["count"],
                                    h["sum"] - h0["sum"]]
    for n, v in after["gauges"].items():
        if keep(n):
            out["gauges"][n] = v
    return out


def attribution_run(name, params, rounds, train_set, valid_set,
                    callbacks=()):
    """``rounds`` rounds of the training cell through ``lt.train`` with
    ``params`` (a devprof mode among them), devprof's accumulators and
    the launch and host-read counters set to 0 before and read after;
    the synchronized seconds of each round and the attribution series
    the run changed."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import devprof
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import grow as gr
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import ordered_grow as og
    devprof.reset()
    lh.reset_launch_counts()
    ch.reset_launch_counts()
    og.reset_host_syncs()
    gr.reset_host_syncs()
    torch.cuda.synchronize()
    before = obs.snapshot()
    with _timed_calls() as timer:
        booster = lt.train(params, train_set, rounds,
                           valid_sets=[valid_set] if valid_set else None,
                           valid_names=["valid"] if valid_set else None,
                           verbose_eval=False, callbacks=list(callbacks))
    torch.cuda.synchronize()
    delta = _series_delta(before, obs.snapshot())
    k = {**lh.launch_counts(), **ch.launch_counts()}
    return {"name": name, "booster": booster, "round_s": timer.seconds,
            "launches": {n: v for n, v in k.items() if v},
            "syncs_per_tree": (og.host_syncs() + gr.host_syncs())
            / booster.num_trees(), "est": devprof.estimates(),
            "delta": delta}


def _program_rows(run):
    """Per program of a devprof run: the estimate, samples, dispatches,
    the last sample's kernel bytes and roofline against the card's
    capability row."""
    g = run["delta"]["gauges"]
    return {p: {**e, "roofline_pct": g.get(f"devprof_roofline_pct_{p}")}
            for p, e in sorted(run["est"].items())}


def _round_split(run):
    h = run["delta"]["histograms"]
    host = h.get("devprof_round_host_seconds", [0, 0.0])
    dev = h.get("devprof_round_device_seconds", [0, 0.0])
    return {"rounds": host[0], "host_s": host[1], "device_s": dev[1],
            "device_share": dev[1] / (host[1] + dev[1])
            if host[1] + dev[1] > 0 else None}


def _check_sampled(run, stride):
    """Every program of a ``stride`` run has dispatches // stride samples
    (less any discarded during a build), and no sample's own wait was
    counted as a forced sync."""
    c = run["delta"]["counters"]
    skipped = c.get("devprof_samples_skipped_compile", 0)
    for prog, e in run["est"].items():
        want = e["dispatches"] // stride
        check(want - skipped <= e["samples"] <= want,
              f"attribution {run['name']}: {prog} {e['samples']} samples "
              f"of {e['dispatches']} dispatches at stride {stride}")
    check(c.get("devprof_forced_syncs_total", 0) == 0,
          f"attribution {run['name']}: forced syncs "
          f"{c.get('devprof_forced_syncs_total')}")
    check("train_step" in run["est"] and run["est"]["train_step"][
        "bytes_accessed"], f"attribution {run['name']}: no train_step "
          f"kernel bytes")


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_window_summary(path):
    """One exported window: the device busy share (the union of kernel,
    memcpy and memset intervals over the window's wall, first event to
    last), K1's kernels, and the time under each grower range (the host
    ``record_function`` ranges and, where the profiler recorded them,
    their device-side projections)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    first = min(e["ts"] for e in dev) if dev else t0
    last = max(e["ts"] + e["dur"] for e in dev) if dev else t1
    k1 = [e for e in dev if e.get("cat") == "kernel"
          and "digit_hist_kernel" in e.get("name", "")]
    ranges = {}
    for cat in ("user_annotation", "gpu_user_annotation"):
        for name in ("hist", "find_split", "split"):
            sel = [e for e in events if e.get("cat") == cat
                   and e.get("name") == name]
            if sel:
                ranges.setdefault(cat, {})[name] = {
                    "count": len(sel),
                    "ms": sum(e["dur"] for e in sel) / 1e3}
    return {"wall_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (t1 - t0),
            "device_span_ms": (last - first) / 1e3,
            "device_busy_share_of_span": busy / max(last - first, 1e-9),
            "device_events": len(dev),
            "kernels": sum(1 for e in dev if e.get("cat") == "kernel"),
            "k1_kernels": len(k1),
            "k1_kernel_ms": sum(e["dur"] for e in k1) / 1e3,
            "ranges": ranges}


def attribution_serving(model_path, seed, higgs_grid):
    """The Higgs forest through ``serve_from_config`` with
    ``devprof=full`` in its configuration: one warm-up request a size,
    then 4 clients x TEL_REQUESTS requests of 1, 64 and 4096 rows.  The
    ``serve_forest_walk`` bucket series, samples against dispatches, and
    the program's roofline beside K4's bound at B = 4096 (the timing
    phase's: ``forest_walk.launch_cost`` over the card's bandwidth)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.config import Config, parse_cli_args
    from lightgbm_tpu_torch.obs import devprof
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.serve.forest import CompiledForest
    from lightgbm_tpu_torch.serve.server import serve_from_config
    rng = np.random.RandomState(seed + 75)
    bodies = {n: json.dumps({"rows": random_rows(
        rng, n, higgs_grid, tie_frac=0.02).tolist()}).encode()
        for n in SERVE_SIZES}
    devprof.reset()
    fw.reset_launch_counts()
    before = obs.snapshot()
    srv = started(serve_from_config(Config(parse_cli_args([
        "task=serve", f"input_model={model_path}", "serve_port=0",
        "serve_max_batch=4096", "serve_max_delay_ms=2",
        "devprof=full"]))))
    try:
        check(devprof.MODE == "full", f"serve_from_config left devprof "
              f"{devprof.MODE}")
        host, port = srv.address
        base = f"http://{host}:{port}"
        for n in SERVE_SIZES:
            urllib.request.urlopen(urllib.request.Request(
                base + "/predict", data=bodies[n],
                headers={"Content-Type": "application/json"}),
                timeout=120).read()
        lat = _load(base, bodies, SERVE_CLIENTS)
        torch.cuda.synchronize()
        k4 = {k: v for k, v in fw.launch_counts().items() if v}
    finally:
        srv.stop()
    delta = _series_delta(before, obs.snapshot())
    est = devprof.estimates()
    walk = est.get("serve_forest_walk")
    check(walk is not None and walk["samples"] == walk["dispatches"] > 0,
          f"attribution serving: serve_forest_walk {walk}")
    prefix = "device_seconds_serve_forest_walk_bucket_"
    buckets = {int(k[len(prefix):]): {"samples": v[0],
                                      "mean_ms": v[1] / v[0] * 1e3}
               for k, v in delta["histograms"].items()
               if k.startswith(prefix)}
    # 1-row requests land in the ladder's smallest bucket
    check(4096 in buckets and len(buckets) >= 2,
          f"attribution serving: bucket series {sorted(buckets)}")
    cf = CompiledForest.from_booster(lt.Booster(model_file=model_path),
                                     device="cuda")
    bound_ms = fw.launch_cost(cf.walk_tables, cf.num_features, 4096, True,
                              cut_cols=cf.cut_tables()[0].shape[1]) \
        / HBM_BYTES_PER_S * 1e3
    return {"programs": {p: {**e, "roofline_pct": delta["gauges"].get(
        f"devprof_roofline_pct_{p}")} for p, e in sorted(est.items())},
        "buckets": dict(sorted(buckets.items())),
        "k4_bound_ms_b4096": bound_ms,
        "b4096_mean_over_bound": buckets[4096]["mean_ms"] / bound_ms,
        "k4_launches": k4, **_percentiles(lat)}


def attribution_ledger(proc, ledger, events_file):
    """Join the ledger's build subprocess: one line, ``roll_chain``,
    whose seconds are the nvcc wall the build returned, read back by
    ``obs-report --compile``."""
    from lightgbm_tpu_torch.obs import compile_ledger
    from lightgbm_tpu_torch.obs.report import main as obs_report_main
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"ledger build: {err[-2000:]}")
    built = json.loads(out.strip().splitlines()[-1])
    rows = compile_ledger.read_ledger(ledger)
    check(len(rows) == 1 and rows[0]["program"] == "roll_chain",
          f"ledger: {rows}")
    check(abs(rows[0]["seconds"] - built["seconds"]["roll_chain"]) < 1e-5,
          f"ledger seconds {rows[0]['seconds']} against nvcc's "
          f"{built['seconds']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(obs_report_main([events_file, f"--compile={ledger}",
                               "--format=json"]) == 0,
              "obs-report --compile")
    section = json.loads(buf.getvalue())["compile"]
    check(section["count"] == 1, f"obs-report --compile: {section}")
    return {"line": rows[0], "build_wall_s": built["wall_s"],
            "report": section}


def attribution_poison(train_set, off_text, workdir):
    """``poison_gradients(at_iteration=2)`` under ``nan_policy=skip_tree``
    over ATTR_POISON_UPDATES updates of the training cell: one tree
    fewer, ``nan_iterations_dropped`` up by one, the event record naming
    iteration 2, and the trees those of the clean run (the retry grows
    from the same gradients)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.testing import faults
    path = f"{workdir}/attr_poison.jsonl"
    b = lt.Booster(params={**TRAIN_PARAMS, **CONST,
                           "nan_policy": "skip_tree"}, train_set=train_set)
    rec = obs.EventRecorder(path)
    b.set_event_recorder(rec)
    d0 = obs.get_counter("nan_iterations_dropped")
    t0 = time.perf_counter()
    with faults.poison_gradients(b, at_iteration=2):
        for _ in range(ATTR_POISON_UPDATES):
            b.update()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec.close()
    b.set_event_recorder(None)
    n = ATTR_POISON_UPDATES - 1
    hit = [r for r in obs.read_events(path) if r.get("nan_poisoned")]
    check(b.num_trees() == n, f"poison: {b.num_trees()} trees")
    check(obs.get_counter("nan_iterations_dropped") == d0 + 1,
          "poison: nan_iterations_dropped")
    check([(r["iter"], r["nan_poisoned"]) for r in hit]
          == [(2, "gradients/hessians")], f"poison: records {hit}")
    check(trees_text(b.model_to_string(), 0, n) == trees_text(off_text, 0, n),
          "poison: the retried trees differ from the clean run's")
    return {"updates": ATTR_POISON_UPDATES, "trees": n, "dropped": 1,
            "record": hit[0], "seconds": seconds}


def phase_attribution(seed, datasets, higgs_model, higgs_grid, workdir):
    """Device-time attribution on the card, on the training cell (the
    train phase's datasets; ordered grower) and the Higgs forest.
    ATTR_ROUNDS rounds with ``devprof`` off, ``full`` and ``sample:4``:
    model texts byte-equal, host reads a tree and K1's launches
    unchanged; under ``full`` every dispatch a sample, under ``sample:4``
    a quarter; no forced sync in either; per program the estimate,
    samples and roofline against the H100 row, and the rounds' host and
    device split.  The fused and nocache growers ATTR_FULL_ROUNDS rounds
    under ``full`` (K3's and K2's bytes in ``train_step``).  A trace
    window over 2 rounds after CUPTI's initialization outside it: the
    device busy share of the window, K1's kernels against its launches,
    the time under hist / find_split / split.  TIMETAG over 5 rounds (the
    phase totals, the forced-sync seconds, the round time beside the
    bare), memwatch over 2 (the ``GBDT::iteration`` watermark beside
    ``torch.cuda.max_memory_allocated``), one devprof server
    (``attribution_serving``), one ledger line from a build in a
    subprocess (``attribution_ledger``) and ``poison_gradients``
    (``attribution_poison``).  Returns the launches."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import compile_ledger, devprof, memwatch
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.utils import timetag
    train_set, valid_set, _, _ = datasets
    t_phase = time.perf_counter()
    ledger = f"{workdir}/attr_compile_ledger.jsonl"
    ledger_proc = subprocess.Popen(
        [sys.executable, "-c", LEDGER_BUILD, f"{workdir}/attr_build",
         ledger], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    launches = {}

    def count(run):
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n

    try:
        params = {**TRAIN_PARAMS, **CONST}
        modes = {}
        for mode in ("off", "full", "sample:4"):
            modes[mode] = run = attribution_run(
                f"ordered_{mode}", {**params, "devprof": mode},
                ATTR_ROUNDS, train_set, valid_set)
            count(run)
        off = modes["off"]
        off_text = off["booster"].model_to_string()
        for mode, run in modes.items():
            check(run["booster"].model_to_string() == off_text,
                  f"attribution: the devprof={mode} model text differs")
            check(run["syncs_per_tree"] == off["syncs_per_tree"]
                  and run["launches"] == off["launches"],
                  f"attribution {mode}: host reads a tree "
                  f"{run['syncs_per_tree']}, launches {run['launches']} "
                  f"against off's {off['syncs_per_tree']}, "
                  f"{off['launches']}")
        check(off["est"] == {} and not any(
            k.startswith("devprof_dispatches")
            for k in off["delta"]["counters"]),
            f"attribution off: devprof counted {off['delta']['counters']}")
        _check_sampled(modes["full"], 1)
        _check_sampled(modes["sample:4"], 4)
        median = {mode: float(np.median(run["round_s"][2:]))
                  for mode, run in modes.items()}
        growers = {}
        for name, extra, _ in GROWERS[2:4]:
            run = attribution_run(name, {**TRAIN_PARAMS, **extra,
                                         "devprof": "full"},
                                  ATTR_FULL_ROUNDS, train_set, None)
            count(run)
            _check_sampled(run, 1)
            growers[name] = {"programs": _program_rows(run),
                             "round_split": _round_split(run),
                             "launches": run["launches"],
                             "round_s": run["round_s"]}
        # the trace window: CUPTI initialized by a window of its own
        # first, outside the timed rounds
        t0 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        cupti_s = time.perf_counter() - t0
        trace_dir = f"{workdir}/attr_trace"
        k1_after = []

        def after_round(env):
            k1_after.append(lh.launch_counts()["digit_histogram"])
        traced = attribution_run(
            "trace", {**params, "trace_dir": trace_dir,
                      "trace_start_iter": 1, "trace_num_iters": 2}, 3,
            train_set, None, callbacks=(after_round,))
        count(traced)
        check(trees_text(traced["booster"].model_to_string(), 0, 3)
              == trees_text(off_text, 0, 3),
              "attribution: the traced trees differ")
        files = sorted(os.listdir(trace_dir))
        check(files == ["trace_iter1.json"], f"trace window files {files}")
        window = trace_window_summary(os.path.join(trace_dir, files[0]))
        window["k1_launches"] = k1_after[2] - k1_after[0]
        window["round_s"] = traced["round_s"]
        window["cupti_init_s"] = cupti_s
        check(0 < window["k1_kernels"] <= window["k1_launches"],
              f"trace window: {window['k1_kernels']} K1 kernels for "
              f"{window['k1_launches']} launches")
        check({"hist", "find_split", "split"} <= set(
            window["ranges"].get("user_annotation", {})),
            f"trace window ranges {window['ranges']}")
        # TIMETAG, with an events file (each record's phases)
        timetag.reset()
        timetag.enable(True)
        events_file = f"{workdir}/attr_timetag.jsonl"
        try:
            tt = attribution_run("timetag", {**params,
                                             "events_file": events_file},
                                 ATTR_TIMETAG_ROUNDS, train_set, valid_set)
        finally:
            timetag.enable(False)
        count(tt)
        totals, calls = timetag.get_timings(), timetag.get_counts()
        timetag.reset()
        check(trees_text(tt["booster"].model_to_string(), 0,
                         ATTR_TIMETAG_ROUNDS)
              == trees_text(off_text, 0, ATTR_TIMETAG_ROUNDS),
              "attribution: the TIMETAG trees differ")
        records = obs.read_events(events_file)
        check(len(records) == ATTR_TIMETAG_ROUNDS and all(
            {"GBDT::tree", "GBDT::host_tree"} <= set(r["phases"])
            for r in records), "attribution: TIMETAG event phases")
        fs = tt["delta"]["histograms"].get("devprof_forced_sync_seconds",
                                           [0, 0.0])
        # memwatch over 2 rounds, peaks restarted
        memwatch.reset_peak()
        torch.cuda.reset_peak_memory_stats()
        check(obs.get_gauge("memwatch_device_bytes_in_use_gbdt_iteration")
              is None, "attribution memwatch: sampled before it was on")
        mw = attribution_run("memwatch", {**params, "memwatch": True}, 2,
                             train_set, valid_set)
        count(mw)
        g = mw["delta"]["gauges"]
        mark = g.get("memwatch_device_bytes_in_use_gbdt_iteration")
        check(mark is not None and g.get("memwatch_device_peak_bytes"),
              f"attribution memwatch: gauges {sorted(g)}")
        memory = {"gbdt_iteration_bytes_in_use": mark,
                  "peak_bytes": g["memwatch_device_peak_bytes"],
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "reserved_bytes": g.get("memwatch_device_reserved_bytes")}
        check(memory["peak_bytes"] <= memory["max_memory_allocated"],
              f"attribution memwatch: {memory}")
        devprof.configure(None)
        memwatch.configure(None)
        model_path = f"{workdir}/attr_higgs_model.txt"
        with open(model_path, "w") as fh:
            fh.write(higgs_model.save_model_to_string())
        serving = attribution_serving(model_path, seed, higgs_grid)
        for name, n in serving["k4_launches"].items():
            launches[name] = launches.get(name, 0) + n
        devprof.configure(None)
        memwatch.configure(None)
        compile_ledger.configure(None)
        poison = attribution_poison(train_set, off_text, workdir)
        ledger_out = attribution_ledger(ledger_proc, ledger, events_file)
    finally:
        if ledger_proc.poll() is None:
            ledger_proc.kill()
        devprof.configure(None)
        memwatch.configure(None)
        timetag.enable(False)
    emit({"phase": "attribution", "rows": train_set.num_data(),
          "params": params, "rounds": ATTR_ROUNDS,
          "device": obs.devcaps.capabilities(torch.device("cuda", 0)),
          "round_s_median_3_10": median,
          "full_over_off": median["full"] / median["off"],
          "sample4_over_off": median["sample:4"] / median["off"],
          "host_syncs_per_tree": off["syncs_per_tree"],
          "k1_launches": {m: r["launches"].get("digit_histogram")
                          for m, r in modes.items()},
          "programs": {m: _program_rows(modes[m])
                       for m in ("full", "sample:4")},
          "round_split": {m: _round_split(modes[m])
                          for m in ("full", "sample:4")},
          "samples_skipped_compile": {
              m: r["delta"]["counters"].get(
                  "devprof_samples_skipped_compile", 0)
              for m, r in modes.items()},
          "growers": growers, "trace_window": window,
          "timetag": {"rounds": ATTR_TIMETAG_ROUNDS, "totals_s": totals,
                      "calls": calls, "forced_syncs": fs[0],
                      "forced_sync_s": fs[1],
                      "round_s_median_3_5": float(
                          np.median(tt["round_s"][2:])),
                      "bare_round_s_median_3_10": median["off"]},
          "memwatch": memory, "serving": serving, "ledger": ledger_out,
          "poison": poison, "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# the scikit-learn estimators, and the guarded data boundary


EST_ROWS = 250_000
EST_EVAL_ROWS = 50_000
EST_PARAMS = {"num_leaves": 63, "n_estimators": 20}
EST_PATIENCE = 5
EST_PROBA_TOL = 1e-6
GRID_ROWS = 30_000
GRID = {"learning_rate": [0.05, 0.1], "n_estimators": [10, 20]}
GRID_CV = 2
RANKER_ROWS = 100_000
RANKER_ROUNDS = 10
BOUNDARY_ROWS = 100_000        # below bin_construct_sample_cnt = 200000
BOUNDARY_MANGLE = 0.01
BOUNDARY_RAGGED = 0.005
BOUNDARY_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 63,
                   "max_bin": 255, "learning_rate": 0.1,
                   "min_data_in_leaf": 50}
BOUNDARY_GUARD = {"use_two_round_loading": True,
                  "bad_data_policy": "quarantine",
                  "max_bad_row_fraction": 0.05}
BOUNDARY_ROUNDS = 20
BOUNDARY_APPEND_ROWS = 5_000
BOUNDARY_MAX_BAD_ROWS = 10
LOAD_PROBE_CAL_MB = 256
LOAD_PROBE = r"""
import json, os, sys, threading, time
import numpy as np
import lightgbm_tpu_torch as lt

PAGE_KB = os.sysconf("SC_PAGE_SIZE") // 1024


def rss_kb():
    # the resident set now (/proc/self/statm's second field, in pages)
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * PAGE_KB
    except (OSError, ValueError, IndexError):
        return None


def used_kb():
    # the whole machine's memory in use (/proc/meminfo), to tell the two
    # readings apart
    try:
        with open("/proc/meminfo") as fh:
            f = {k: int(v.split()[0]) for k, v in
                 (ln.split(":", 1) for ln in fh)}
        return f["MemTotal"] - f["MemAvailable"]
    except (OSError, ValueError, KeyError):
        return None


path, params = sys.argv[1], json.loads(sys.argv[2])
cal_mb = int(sys.argv[3])
# the reading's rise over a known allocation, written and freed
before = rss_kb()
block = np.ones(cal_mb << 17)
after = rss_kb()
del block
cal = (None if None in (before, after) else (after - before) / 1024)
base, used = rss_kb(), used_kb()
peak = [base]
done = threading.Event()


def sample():
    while not done.wait(0.002):
        now = rss_kb()
        if now is not None and peak[0] is not None:
            peak[0] = max(peak[0], now)


sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
t0 = time.perf_counter()
ds = lt.Dataset(path, params=params).construct()
seconds = time.perf_counter() - t0
done.set()
sampler.join()
print(json.dumps({"seconds": seconds, "rows": ds.num_data(),
                  "baseline_rss_kb": base, "peak_rss_kb": peak[0],
                  "machine_used_kb_at_baseline": used,
                  "calibration_alloc_mb": cal_mb,
                  "calibration_rss_rise_mb": cal}))
"""


def rebuilt(est):
    """``est``'s class built again from ``get_params()`` (what
    scikit-learn's ``clone`` does)."""
    return type(est)(**est.get_params(deep=False))


def grid_search(est, grid, X, y, folds):
    """``GridSearchCV(est, grid, cv=folds).fit(X, y)`` without
    scikit-learn, which the script does not need: each combination
    fitted on ``folds`` contiguous folds of estimators rebuilt from
    ``get_params()`` and given the combination by ``set_params``, scored
    by R^2 on the held-out fold, and the best refitted on every row.
    Returns (the refitted estimator, its combination, and for every fit
    the estimator's ``device`` and the device its booster trained on)."""
    import itertools
    bounds = np.linspace(0, len(y), folds + 1).astype(int)
    keys = sorted(grid)
    scores, fits = [], []
    for values in itertools.product(*(grid[k] for k in keys)):
        combo = dict(zip(keys, values))
        r2 = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            keep = np.r_[0:lo, hi:len(y)]
            fold = rebuilt(est).set_params(**combo).fit(
                X[keep], y[keep], verbose=False)
            fits.append((fold.device, fold.booster_.device.type))
            err = fold.predict(X[lo:hi]) - y[lo:hi]
            r2.append(1 - np.sum(err ** 2)
                      / np.sum((y[lo:hi] - y[lo:hi].mean()) ** 2))
        scores.append((float(np.mean(r2)), combo))
    best = max(scores, key=lambda s: s[0])[1]
    refit = rebuilt(est).set_params(**best).fit(X, y, verbose=False)
    fits.append((refit.device, refit.booster_.device.type))
    return refit, best, fits


def first_line_diff(a: str, b: str) -> str:
    """The first line where two texts differ, both sides."""
    for i, (x, z) in enumerate(zip(a.splitlines(), b.splitlines())):
        if x != z:
            return f"line {i + 1}: {x[:160]!r} against {z[:160]!r}"
    return f"{len(a.splitlines())} against {len(b.splitlines())} lines"


def k1_on_booster(booster, label):
    """K1 on a trained booster's own card bins with its round-0
    gradients, bit-equal to its plain version (``k1_on_run``)."""
    gbdt = booster._booster
    score = torch.zeros_like(gbdt.train_data.score)
    grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
    return k1_on_run(gbdt, grad[0], hess[0], label)


def phase_estimators(seed, workdir, errs):
    """The scikit-learn estimators on the card at the Higgs cell's width
    (28 features, 63 leaves, 255 bins).  ``LGBMClassifier`` on 250k rows
    with a 50k-row ``eval_set`` and early stopping: its model text
    byte-equal to ``train`` with the parameters ``_params_for_engine``
    gives, ``predict_proba`` (K4) within 1e-6 of that booster's
    ``predict``, K1 on the fit's bins and K4 on the eval rows held
    against their plain versions; ``LGBMRegressor`` over a 2 x 2 grid
    with 3 folds on 30k rows (``grid_search``: GridSearchCV's protocol,
    so that the script needs no scikit-learn), ``device="cuda"`` in
    every rebuilt estimator's fit; ``LGBMRanker`` on 100k MSLR-like
    rows and their query groups, 10 rounds.  The launch counters are set
    to 0 before each counted call and read after it.  Returns the
    launches."""
    import lightgbm_tpu_torch as lt
    t_phase = time.perf_counter()
    X, y = make_higgs_like(EST_ROWS + EST_EVAL_ROWS, seed=seed + 160)
    Xt, yt = X[:EST_ROWS], y[:EST_ROWS]
    Xe, ye = X[EST_ROWS:], y[EST_ROWS:]
    clf = lt.LGBMClassifier(**EST_PARAMS, device="cuda")
    check(rebuilt(clf).device == "cuda", "a rebuilt estimator lost device")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf.fit(Xt, yt, eval_set=[(Xe, ye)],
            early_stopping_rounds=EST_PATIENCE, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1_fit = _launches()[0]
    trees = clf.booster_.num_trees()
    check(k1_fit > 0 and k1_fit == sum(
        int(ta.num_leaves) for ta in clf.booster_._booster.tree_arrays),
        f"classifier fit: K1 launches {k1_fit}")
    # the same run through train, with the estimator's parameters
    params = clf._params_for_engine()
    yt_enc = clf._le.transform(yt)
    ds = lt.Dataset(Xt, label=yt_enc, params=params)
    direct = lt.train(params, ds, clf.n_estimators,
                      valid_sets=[ds.create_valid(Xe, clf._le.transform(
                          ye))],
                      early_stopping_rounds=EST_PATIENCE,
                      verbose_eval=False)
    text = clf.booster_.model_to_string()
    check(text == direct.model_to_string(),
          "classifier: model text differs from train's: "
          + first_line_diff(text, direct.model_to_string()))
    check(clf.best_iteration_ == direct.best_iteration,
          f"classifier best_iteration {clf.best_iteration_} != "
          f"{direct.best_iteration}")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proba = clf.predict_proba(Xe)
    predict_ms = (time.perf_counter() - t0) * 1e3
    k4_pred = _launches()[1]
    check(sum(k4_pred.values()) > 0, "predict_proba launched no K4")
    want = direct.predict(Xe)
    d_proba = float(np.abs(proba[:, 1] - want).max())
    check(proba.shape == (EST_EVAL_ROWS, 2) and np.isfinite(proba).all()
          and d_proba <= EST_PROBA_TOL,
          f"predict_proba against train's booster: {d_proba}")
    labels = clf.predict(Xe)
    check(set(np.unique(labels)) <= {0.0, 1.0}, "predict's labels")
    k1_windows = k1_on_booster(clf.booster_, "classifier")
    walk = compare_kernels(clf.booster_._compiled(-1), Xe,
                           (4096, EST_EVAL_ROWS), "classifier", errs)

    # a 2 x 2 grid, 2 folds: every rebuilt estimator keeps device="cuda"
    Xg, yg = make_higgs_like(GRID_ROWS, seed=seed + 161)
    target = Xg[:, 0] - 0.5 * Xg[:, 1] + 0.3 * Xg[:, 14] + yg
    _reset_launches()
    t0 = time.perf_counter()
    best, best_params, fits = grid_search(lt.LGBMRegressor(device="cuda"),
                                          GRID, Xg, target, GRID_CV)
    grid_s = time.perf_counter() - t0
    k1_grid, k4_grid = _launches()
    n_fits = GRID_CV * len(GRID["learning_rate"]) * len(
        GRID["n_estimators"]) + 1
    check(len(fits) == n_fits and all(f == ("cuda", "cuda") for f in fits),
          f"grid search fits: {fits}")
    check(best.device == "cuda" and k1_grid > 0
          and sum(k4_grid.values()) > 0,
          f"grid search: K1 {k1_grid}, K4 {k4_grid}")

    # LGBMRanker on the objectives phase's MSLR-like groups
    Xr, yr, sizes = mslr_like(RANKER_ROWS, seed + 62)
    ranker = lt.LGBMRanker(num_leaves=63, n_estimators=RANKER_ROUNDS,
                           device="cuda")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranker.fit(Xr, yr, group=sizes, verbose=False)
    torch.cuda.synchronize()
    rank_fit_s = time.perf_counter() - t0
    k1_rank = _launches()[0]
    _reset_launches()
    scores = ranker.predict(Xr[:4096])
    k4_rank = _launches()[1]
    check(ranker.booster_.num_trees() == RANKER_ROUNDS and k1_rank > 0
          and sum(k4_rank.values()) > 0 and np.isfinite(scores).all(),
          f"ranker: trees {ranker.booster_.num_trees()}, K1 {k1_rank}, "
          f"K4 {k4_rank}")
    k1_total = k1_fit + k1_grid + k1_rank
    k4_total = {name: k4_grid.get(name, 0) + k4_pred.get(name, 0)
                + k4_rank.get(name, 0)
                for name in {*k4_grid, *k4_pred, *k4_rank}}
    emit({"phase": "estimators",
          "classifier": {"rows": EST_ROWS, "eval_rows": EST_EVAL_ROWS,
                         "params": EST_PARAMS, "trees": trees,
                         "best_iteration": clf.best_iteration_,
                         "fit_s": fit_s, "predict_proba_ms": predict_ms,
                         "model_text_equal_to_train": True,
                         "predict_proba_max_abs_diff": d_proba,
                         "k1_launches": k1_fit, "k4_launches": k4_pred,
                         "k1_bit_equal_on_run_bins": k1_windows,
                         "walk_vs_plain": walk},
          "grid_search": {"rows": GRID_ROWS, "grid": GRID, "cv": GRID_CV,
                          "fits": len(fits), "seconds": grid_s,
                          "best_params": best_params,
                          "k1_launches": k1_grid, "k4_launches": k4_grid},
          "ranker": {"rows": RANKER_ROWS, "queries": int(len(sizes)),
                     "rounds": RANKER_ROUNDS, "fit_s": rank_fit_s,
                     "k1_launches": k1_rank, "k4_launches": k4_rank},
          "k1_launches": k1_total, "k4_launches": k4_total,
          "seconds": time.perf_counter() - t_phase})
    return {"digit_histogram": k1_total, **k4_total}


def boundary_load_probe(path, params):
    """Seconds and peak host RSS of one ``Dataset(path).construct()`` in
    a process of its own: the resident set after its imports, and the
    largest a thread reading ``/proc/self/statm`` every 2 ms saw during
    the load (some kernels' ``/proc`` has no ``VmHWM``, and a child's
    ``ru_maxrss`` keeps its parent's peak).  Before the load the reading
    is checked against a known allocation (``LOAD_PROBE_CAL_MB`` written
    and freed), and the machine's memory in use is read beside it, so
    that the rise is seen to be the process's own."""
    out = subprocess.run(
        [sys.executable, "-c", LOAD_PROBE, path, json.dumps(params),
         str(LOAD_PROBE_CAL_MB)],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    check(out.returncode == 0, f"load probe {params}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_boundary(seed, workdir):
    """The guarded data boundary on the card.  A 100k x 28 Higgs-like TSV
    (below ``bin_construct_sample_cnt``, so both loaders bin from every
    row), damaged by the port's injectors (``mangle_rows`` 1%,
    ``ragged_rows`` 0.5%), loaded in two rounds under
    ``bad_data_policy=quarantine`` and trained 20 rounds (K1): the
    quarantine file's lines equal the injected ones, the
    ``bad_rows_total`` counter their number, and the model text equals
    that of a one-round fail-fast load of the clean file with those
    lines deleted (read through the Python parser, as the two-round
    loader reads), trained the same way, up to the one-round load's
    drift fingerprint section, which the two-round loader does not build
    (nor does the JAX package's).  A ``concurrent_append`` during a
    two-round load raises the named drift error; ``max_bad_rows`` below
    the injected count raises the budget error.  Prints each load's
    seconds and peak host RSS (two rounds beside one, the same dirty
    file, each in a process of its own).  Returns the launches."""
    from unittest import mock
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.io import native
    from lightgbm_tpu_torch.io.guard import read_quarantine
    from lightgbm_tpu_torch.obs.drift import SECTION_HEADER
    from lightgbm_tpu_torch.testing import faults
    from lightgbm_tpu_torch.utils.log import LightGBMError
    t_phase = time.perf_counter()
    X, y = make_higgs_like(BOUNDARY_ROWS, seed=seed + 170)
    t0 = time.perf_counter()
    fmt = "%g" + "\t%.6g" * X.shape[1]
    rows = [fmt % tuple(r) for r in np.column_stack([y, X]).tolist()]
    dirty = os.path.join(workdir, "boundary.tsv")
    with open(dirty, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    mangled = faults.mangle_rows(dirty, fraction=BOUNDARY_MANGLE, seed=seed)
    ragged = faults.ragged_rows(dirty, fraction=BOUNDARY_RAGGED,
                                seed=seed + 1)
    bad = sorted(set(mangled) | set(ragged))
    check(1 not in bad, "the first data row was damaged: it sets the "
                        "field count, pick another seed")
    drop = set(bad)
    clean = os.path.join(workdir, "boundary_clean.tsv")
    with open(clean, "w") as fh:
        fh.write("\n".join(r for i, r in enumerate(rows, start=1)
                           if i not in drop) + "\n")
    write_s = time.perf_counter() - t0

    guarded = {**BOUNDARY_PARAMS, **BOUNDARY_GUARD}
    loads = {"two_round": boundary_load_probe(dirty, guarded),
             "one_round": boundary_load_probe(
                 dirty, {**guarded, "use_two_round_loading": False})}
    for kind, load in loads.items():
        check(load["rows"] == BOUNDARY_ROWS - len(bad),
              f"{kind} load kept {load['rows']} rows")
        load["load_peak_mb"] = (
            (load["peak_rss_kb"] - load["baseline_rss_kb"]) / 1024
            if load["peak_rss_kb"] is not None else "not measured")

    before = obs.get_counter("bad_rows_total")
    t0 = time.perf_counter()
    dirty_set = lt.Dataset(dirty, params=guarded).construct()
    load_s = time.perf_counter() - t0
    counted = obs.get_counter("bad_rows_total") - before
    quarantined = [r["line"] for r in read_quarantine(dirty)]
    check(quarantined == bad and counted == len(bad),
          f"quarantine: {len(quarantined)} lines, {counted} counted, "
          f"{len(bad)} injected")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster = lt.train(BOUNDARY_PARAMS, dirty_set, BOUNDARY_ROUNDS,
                       verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k1_dirty = _launches()[0]
    _reset_launches()
    # the clean file through the Python parser, the two-round loader's
    # value source (the native loader's decimals can differ in the last
    # bits, in the JAX package too)
    with mock.patch.object(native, "parse_file_native", return_value=None):
        clean_set = lt.Dataset(clean, params=BOUNDARY_PARAMS).construct()
    clean_booster = lt.train(BOUNDARY_PARAMS, clean_set, BOUNDARY_ROUNDS,
                             verbose_eval=False)
    k1_clean = _launches()[0]
    a = booster.model_to_string()
    b = clean_booster.model_to_string()
    head = "\n" + SECTION_HEADER
    check(head not in a and head in b,
          "boundary: the fingerprint sections are not as expected")
    check(a == b.split(head)[0],
          "boundary: the quarantined model differs from the clean one: "
          + first_line_diff(a, b.split(head)[0]))
    check(k1_dirty == k1_clean > 0, f"boundary: K1 {k1_dirty}, {k1_clean}")
    k1_windows = k1_on_booster(booster, "boundary")
    _reset_launches()
    pred = booster.predict(X[:4096])
    k4 = _launches()[1]
    check(sum(k4.values()) > 0 and np.isfinite(pred).all(),
          f"boundary: K4 {k4}")

    # a producer still appending: the named drift error
    small = os.path.join(workdir, "boundary_append.tsv")
    with open(small, "w") as fh:
        fh.write("\n".join(rows[:BOUNDARY_APPEND_ROWS]) + "\n")
    try:
        with faults.concurrent_append(small, rows[0] + "\n") as state:
            lt.Dataset(small, params=guarded).construct()
        drift = None
    except LightGBMError as exc:
        drift = str(exc)
    check(drift is not None and "changed between rounds" in drift
          and state["appended"], f"concurrent append: {drift}")
    # a budget below the injected count
    try:
        lt.Dataset(dirty, params={**guarded, "max_bad_rows":
                                  BOUNDARY_MAX_BAD_ROWS}).construct()
        budget = None
    except LightGBMError as exc:
        budget = str(exc)
    check(budget is not None
          and f"max_bad_rows={BOUNDARY_MAX_BAD_ROWS}" in budget,
          f"max_bad_rows: {budget}")
    emit({"phase": "boundary", "rows": BOUNDARY_ROWS,
          "features": X.shape[1], "mangled": len(mangled),
          "ragged": len(ragged), "quarantined": len(bad),
          "write_s": write_s, "load_s_in_process": load_s,
          "loads": loads, "train_s": train_s, "rounds": BOUNDARY_ROUNDS,
          "model_equal_to_clean_one_round": True,
          "k1_launches": k1_dirty + k1_clean, "k4_launches": k4,
          "k1_bit_equal_on_run_bins": k1_windows,
          "drift_error": drift[:160], "budget_error": budget[:160],
          "seconds": time.perf_counter() - t_phase})
    return {"digit_histogram": k1_dirty + k1_clean, **k4}


# ---------------------------------------------------------------------------
# wide-sparse data: EFB bundles and gain screening at the JAX package's
# wide-sparse operating point (bench.py:505-531)


def make_ctr_like(num_data: int, num_features: int = 2000,
                  block_size: int = 20, seed: int = 9):
    """The bench's wide-sparse CTR-style synthetic (a copy, as
    ``make_higgs_like`` is): blocks of ``block_size`` features, at most
    one of which is non-zero on a row (a one-hot of small integer
    levels), so the features of a block are exclusive; the label a
    logistic read-out of a sparse set of (feature, level) weights."""
    rng = np.random.RandomState(seed)
    num_blocks = max(num_features // block_size, 1)
    F = num_blocks * block_size
    X = np.zeros((num_data, F))
    logit = rng.normal(scale=0.6, size=num_data)
    w = rng.normal(scale=1.0, size=F) * (rng.rand(F) < 0.15)
    idx = np.arange(num_data)
    for b in range(num_blocks):
        act = rng.rand(num_data) < 0.6          # block fires on 60% of rows
        choice = b * block_size + rng.randint(0, block_size, num_data)
        level = rng.randint(1, 5, num_data).astype(np.float64)
        rows = idx[act]
        X[rows, choice[act]] = level[act]
        logit[rows] += w[choice[act]] * level[act] * 0.25
    y = (logit > np.median(logit)).astype(np.float32)
    return X, y


def sparse_data(seed):
    """The sparse cell's datasets: ``make_ctr_like`` of SPARSE_ROWS
    training and SPARSE_VALID_ROWS valid rows (one draw, so both share
    the label's weights), the training rows handed to ``Dataset`` as a
    scipy CSR matrix, binned once bundled (the default
    ``enable_bundle=true``) and once not, each with its valid set on its
    own mappers and plan; raw values kept for the linear runs.  Returns
    ({bundled: (train, valid)}, the valid rows and labels, the fields to
    print)."""
    import scipy.sparse
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.io import dataset as ds_mod
    t0 = time.perf_counter()
    X, y = make_ctr_like(SPARSE_ROWS + SPARSE_VALID_ROWS, SPARSE_FEATURES,
                         seed=9 + seed)
    Xv, yv = X[SPARSE_ROWS:].copy(), y[SPARSE_ROWS:].copy()
    csr = scipy.sparse.csr_matrix(X[:SPARSE_ROWS])
    y = y[:SPARSE_ROWS].copy()
    del X
    fields = {"generate_s": time.perf_counter() - t0, "csr_nnz": csr.nnz,
              "density": csr.nnz / (SPARSE_ROWS * SPARSE_FEATURES)}
    sets = {}
    for bundled in (True, False):
        params = {**SPARSE_PARAMS, "enable_bundle": bundled,
                  "linear_tree": True}
        with _timed_calls("plan_bundles", ds_mod) as planner:
            t0 = time.perf_counter()
            train_set = lt.Dataset(csr, y, params=params).construct()
            bin_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        valid_set = train_set.create_valid(Xv, yv).construct()
        key = "bundled" if bundled else "unbundled"
        fields[key] = {"binning_s": bin_s,
                       "planning_s": sum(planner.seconds),
                       "valid_binning_s": time.perf_counter() - t0,
                       "columns": train_set._binned.num_columns}
        sets[bundled] = (train_set, valid_set)
    del csr
    b = sets[True][0]._binned
    plan = b.bundle_plan
    check(plan is not None, "sparse: the CTR set built no bundle plan")
    per_bundle = [len(m) for m in plan.bundles]
    nb = b.num_bin_per_feature()
    sparse_rate = np.asarray([m.sparse_rate for m in b.mappers])
    fields.update(
        features=b.num_features, columns=plan.num_columns,
        bundles=len(plan.bundles), features_bundled=plan.features_bundled,
        sample_conflicts=plan.sample_conflicts,
        members_per_bundle=sorted(set(per_bundle)),
        num_bin_per_feature=sorted(set(nb.tolist())),
        column_slots=sorted(set(1 + 4 * n for n in per_bundle)),
        sparse_rate_min=float(sparse_rate.min()),
        sparse_rate_mean=float(sparse_rate.mean()))
    blocks = SPARSE_FEATURES // 20
    check(plan.num_columns == len(plan.bundles) == blocks
          and set(per_bundle) == {20} and plan.sample_conflicts == 0
          and set(nb.tolist()) == {5},
          f"sparse: expected {blocks} bundles of 20 features with 4 "
          f"non-default bins each and no conflict: {fields}")
    return sets, (Xv, yv), fields


class _column_widths:
    """Inside the block, the columns every K1 call (``bins_rm``'s width)
    and every K2 call (``bins``' rows) scans, in call order."""

    def __enter__(self):
        from lightgbm_tpu_torch.ops import children_hist as ch
        from lightgbm_tpu_torch.ops import leafhist as lh
        self.k1, self.k2 = [], []
        self._saved = [(lh, "digit_histogram", lh.digit_histogram, self.k1,
                        lambda a: a[0].shape[1]),
                       (ch, "children_histograms", ch.children_histograms,
                        self.k2, lambda a: a[0].shape[0]),
                       (ch, "root_histogram", ch.root_histogram, self.k2,
                        lambda a: a[0].shape[0])]
        for mod, attr, fn, rec, width in self._saved:
            setattr(mod, attr, self._wrap(fn, rec, width))
        return self

    @staticmethod
    def _wrap(fn, rec, width):
        def recorded(*args, **kwargs):
            rec.append(width(args))
            return fn(*args, **kwargs)
        return recorded

    def __exit__(self, *exc):
        for mod, attr, fn, _, _ in self._saved:
            setattr(mod, attr, fn)


def sparse_run(name, params, rounds, train_set, valid_set, snap_at=None):
    """``rounds`` rounds through ``Booster.update`` with the valid set,
    the launch counters set to 0 first.  Returns (the booster, the
    fields to print, the launches, the train and valid score buffers
    after round ``snap_at``)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import leafhist as lh
    booster = lt.Booster(params=params, train_set=train_set)
    booster.add_valid(valid_set, "valid")
    gbdt = booster._booster
    lh.reset_launch_counts()
    ch.reset_launch_counts()
    seconds, auc, widths, snap = [], [], [], None
    with _column_widths() as cols:
        for r in range(rounds):
            k1_first = len(cols.k1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            booster.update()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            widths.append(sorted(set(cols.k1[k1_first:])))
            auc.append(booster.eval_valid()[0][2])
            if r + 1 == snap_at:
                snap = [dd.score.clone()
                        for dd in [gbdt.train_data] + gbdt.valid_data]
    launches = {**lh.launch_counts(), **ch.launch_counts()}
    check(len(cols.k1) == launches["digit_histogram"]
          and len(cols.k2) == launches["children_histograms"],
          f"sparse {name}: widths recorded {len(cols.k1)} / {len(cols.k2)}"
          f" != launches {launches}")
    check(all(np.isfinite(auc)) and auc[-1] > 0.5,
          f"sparse {name}: valid AUC {auc}")
    fields = {"run": name, "grower": gbdt.grow_kind, "rounds": rounds,
              "bundled": train_set._binned.bundle_plan is not None,
              "round_s": seconds,
              "round_s_median_after_2": float(np.median(seconds[2:])),
              "launches": launches,
              "k1_columns": sorted(set(cols.k1)),
              "k2_columns": sorted(set(cols.k2)),
              "root_window_columns": cols.k1[0] if cols.k1 else
              (cols.k2[0] if cols.k2 else None),
              "k1_columns_by_round": widths, "valid_auc": auc,
              "leaves_per_tree": [int(ta.num_leaves)
                                  for ta in gbdt.tree_arrays]}
    return booster, fields, launches, snap


def same_tree_arrays(a_list, b_list, label):
    """Two runs' trees bit-identical, every field."""
    check(len(a_list) == len(b_list) > 0,
          f"{label}: {len(a_list)} vs {len(b_list)} trees")
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        compare_regrown(a, b, f"{label}: tree {i}", exact=True)


def node_rows(ta, k, bins, bundle):
    """[N] bool: the rows of the leaf that node ``k`` of tree ``ta``
    splits, as it stood then: a walk that stops at the first node >= k
    (node indices grow down every path).  Numerical splits only (the
    sparse set has no categorical feature)."""
    from lightgbm_tpu_torch.ops.bundle import decode_feature_bins
    sf, sb, lc, rc = (t.long().to(bins.device) for t in (
        ta.split_feature, ta.split_bin, ta.left_child, ta.right_child))
    node = torch.zeros(bins.shape[1], dtype=torch.int64, device=bins.device)
    for _ in range(k):
        live = (node >= 0) & (node < k)
        idx = node.clamp(min=0)
        if bundle is not None:
            fbin = decode_feature_bins(bins, sf[idx], bundle)
        else:
            fbin = bins.gather(0, sf[idx][None])[0].long()
        node = torch.where(live, torch.where(fbin <= sb[idx], lc[idx],
                                             rc[idx]), node)
    return node == k


def gain_f64(ta, k, bins, bundle, g, h):
    """Node ``k``'s split of tree ``ta`` scored in f64 on its leaf's rows:
    G_L^2/H_L + G_R^2/H_R - G^2/H (lambda_l1 = lambda_l2 = 0, as the
    sparse runs train), the sums of the f32 gradients in f64."""
    from lightgbm_tpu_torch.ops.bundle import decode_feature_bins
    rows = node_rows(ta, k, bins, bundle)
    f = int(ta.split_feature[k])
    if bundle is not None:
        fbin = decode_feature_bins(
            bins, torch.tensor(f, device=bins.device), bundle)
    else:
        fbin = bins[f].long()
    left = rows & (fbin <= int(ta.split_bin[k]))
    G, H = g[rows].double().sum(), h[rows].double().sum()
    GL, HL = g[left].double().sum(), h[left].double().sum()
    GR, HR = G - GL, H - HL
    return float(GL * GL / HL + GR * GR / HR - G * G / H)


def regrow_against_f64(gbdt, label):
    """Trees 0 and 1 of a nocache or fused run re-grown from the same
    gradients through the plain versions twice: with the f32 histograms
    (the port's plain scatter bundled, ``leaf_rows_hist`` in f32
    unbundled) and with the histograms added in f64 and rounded once.
    Tree 0's gradients (+-0.5) and hessians (0.25) sum exactly in f32
    in any order: both re-grows bit-identical.  Tree 1 held against the
    f64 re-grow as the train phase holds its tree 1 (a split may differ
    only at a near-tie of TREE_TIE_RTOL; values within 1e-3).  Where
    tree 1 and the f32 re-grow first split otherwise, both choices are
    scored in f64 on their leaf's rows, and the kernel run's must score
    no worse, up to the same near-tie.  Returns what was found."""
    score = torch.zeros_like(gbdt.train_data.score)
    bins, dec = gbdt.train_data.bins, gbdt._bundle
    f32 = None if dec is not None else torch.float32
    out = []
    for i in range(2):
        grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
        g, h = grad[0], hess[0]
        with _plain_kernels(f32):
            t32, _, delta = gbdt._grow(g, h)
        with _plain_kernels(torch.float64):
            t64, _, _ = gbdt._grow(g, h)
        kern = gbdt.tree_arrays[i]
        if i == 0:
            compare_regrown(kern, t32, f"{label} tree 0 (f32 re-grow)",
                            exact=True)
            compare_regrown(kern, t64, f"{label} tree 0 (f64 re-grow)",
                            exact=True)
            out.append({"tree": 0, "bit_identical": True})
        else:
            rec = {"tree": 1}
            for key, other in (("f64", t64), ("f32", t32)):
                diff = first_flip(kern, other)
                if diff is not None:
                    k = diff["node"]
                    diff["kernel"]["gain_f64"] = gk = gain_f64(
                        kern, k, bins, dec, g, h)
                    diff["plain"]["gain_f64"] = gp = gain_f64(
                        other, k, bins, dec, g, h)
                    check(gk >= gp - TREE_TIE_RTOL * abs(gp),
                          f"{label} tree 1: at node {k} the plain {key} "
                          f"re-grow's split scores better in f64: {diff}")
                rec[key] = {"first_difference": diff}
            rec["f64"]["max_value_diff_of_field_max"] = compare_regrown(
                kern, t64, f"{label} tree 1 (f64 re-grow)", exact=False)[1]
            out.append(rec)
        score[0] += delta
    return out


def screen_replay(params, gbdt, rounds):
    """The active columns of each period from a CPU replay of the
    screener's schedule on the card's trees' gains, each round's trees
    folded in a round late (after the next round chose its view), as
    the JAX package's pipelined booster folds them."""
    from lightgbm_tpu_torch.models.screening import GainScreener
    scr = GainScreener(gbdt.num_features, gbdt.num_columns,
                       gbdt._feature_col,
                       ratio=params["feature_screen_ratio"],
                       refresh=params["feature_screen_refresh"],
                       warmup=params["feature_screen_warmup"],
                       decay=gbdt.config.feature_screen_decay)
    out, period = [], -1
    for it in range(rounds):
        if scr.round_mode(it) == "screened" and scr.period(it) != period:
            period = scr.period(it)
            out.append((it, scr.active_columns()))
        if it >= 1:
            scr.observe_trees([gbdt.models[it - 1]])
    return out


def second_round_gradients(gbdt):
    """Round 1's gradients and hessians (after tree 0), whose f32 sums
    round: the score buffer rebuilt from the run's first tree."""
    score = torch.zeros_like(gbdt.train_data.score)
    gbdt._add_host_tree_to(types.SimpleNamespace(
        score=score, bins=gbdt.train_data.bins, raw=None), gbdt.models[0], 0)
    grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
    return grad[0], hess[0]


def k2_on_run(gbdt, g, h, label):
    """K2 on the run's own bins and the given gradients, held within its
    stated tolerance of its plain version added in f64 and rounded once
    (``leaf_rows_hist``); the plain f32 scatter's distance from that is
    printed beside it, each as its largest share of the tolerance."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    bins = gbdt.train_data.bins
    w = gbdt._ones_weight
    B = gbdt.grow_params.max_bin
    # the left child the rows of the first column's codes 0, 3, 6, ..., the
    # right child 1, 4, 7, ...: most rows left and few right on a sparse
    # feature, a third each on a bundled column
    leaf = (bins[0].to(torch.int32) % 3)
    before = ch.launch_counts()["children_histograms"]
    got = ch.children_histograms(bins, g, h, w, leaf, 0, 1, B)
    torch.cuda.synchronize()
    check(ch.launch_counts()["children_histograms"] == before + 1,
          f"{label}: K2 on the run's bins launched no kernel")
    want = leaf_rows_hist(bins, g, h, w, leaf, 0, 1, B, torch.float64)
    plain = ch.build_children_histograms(bins, g, h, w, leaf, 0, 1, B)
    scale = abs_hist(bins, g, h, w, leaf, 0, 1, B)
    err = check_hist(got, want, scale, f"{label}: K2 on the run's bins")
    tol = ch.HIST_RTOL * scale + ch.HIST_ATOL
    return {"columns": bins.shape[0], "k2_max_abs_diff": err,
            "k2_max_share_of_tolerance": float(
                ((got - want).abs() / tol).max()),
            "plain_f32_max_abs_diff": float((plain - want).abs().max()),
            "plain_f32_max_share_of_tolerance": float(
                ((plain - want).abs() / tol).max()),
            "largest_entry_abs_sum": float(scale.max())}


def sparse_timing(bundled_gbdt, unbundled_gbdt, reps):
    """CUDA-event medians of K1 at the root (all rows) over the bundled
    columns and over the unbundled features, and of the two expansions
    of a split's pair of children (digit sums and f32 histograms), on
    the runs' own bins and round-0 gradients."""
    from lightgbm_tpu_torch.ops import bundle as ob
    from lightgbm_tpu_torch.ops import leafhist as lh
    out = {}
    for key, gbdt in (("bundled", bundled_gbdt),
                      ("unbundled", unbundled_gbdt)):
        score = torch.zeros_like(gbdt.train_data.score)
        grad, hess = gbdt.objective.gradients_with(gbdt._grad_arrays, score)
        w = gbdt._ones_weight
        g, h = grad[0] * w, hess[0] * w
        dig = lh.quantize_digits(g, h, w, lh.compute_scales(g, h, w))
        bins = gbdt.train_data.bins_rm
        B = gbdt.grow_params.max_bin
        out[f"k1_root_ms_{key}"] = cuda_ms(
            lambda: lh.digit_histogram(bins, dig, B), reps)
        out[f"k1_root_columns_{key}"] = bins.shape[1]
    gbdt = bundled_gbdt
    dec, C = gbdt._bundle, gbdt.num_columns
    B = gbdt.grow_params.max_bin
    dev = gbdt.train_data.bins.device
    sums = torch.randint(-1000, 1000, (2, C, 9, B), dtype=torch.int32,
                         device=dev)
    hist = torch.rand((2, C, B, 3), dtype=torch.float32, device=dev)
    out["expand_digit_sums_ms"] = cuda_ms(
        lambda: ob.expand_digit_sums(sums, dec), reps)
    out["expand_histogram_ms"] = cuda_ms(
        lambda: ob.expand_histogram(hist, dec), reps)
    return out


def phase_sparse(seed, workdir, reps):
    """The wide-sparse cell on the card: the ``make_ctr_like`` set
    through the scipy CSR adapter, bundled and not; the cached grower on
    both (bit-identical trees and score buffers), ordered (the cached
    fallback), nocache and fused unbundled and over the bundled columns
    (K2 on 100 columns, no K3), each held against its re-grow
    (``regrow_against_f64``), bagging, GOSS and DART bundled against unbundled
    twins, linear leaves within the linear tolerance, screening (valid
    AUC, active columns against a CPU replay, K1 over the compacted
    view), predictions through K4, K1 and K2 on the run's own bins, and
    the bundled set through a binary file.  Returns the launches."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.utils import log
    t_phase = time.perf_counter()
    sets, (Xv, yv), data_fields = sparse_data(seed)
    emit({"phase": "sparse_data", "rows": SPARSE_ROWS,
          "valid_rows": SPARSE_VALID_ROWS, **data_fields})
    (bset, bvalid), (uset, uvalid) = sets[True], sets[False]
    base = {**SPARSE_PARAMS, "linear_tree": False}
    cached = {**base, "serial_grow": "cached"}
    total = {"digit_histogram": 0, "children_histograms": 0,
             "fused_split_candidates": 0, "forest_walk": 0}
    runs, out = {}, {}

    def run(name, params, rounds, bundled, snap_at=None):
        ds, dv = (bset, bvalid) if bundled else (uset, uvalid)
        booster, fields, launches, snap = sparse_run(
            name, params, rounds, ds, dv, snap_at)
        for k, v in launches.items():
            total[k] += v
        out[name] = fields
        runs[name] = (booster, snap)
        return booster, fields

    # cached: unbundled (15 rounds, the screening run's reference too)
    # and bundled, bit-identical over the first 10
    ub, uf = run("cached_unbundled", cached, SPARSE_SCREEN_ROUNDS, False,
                 snap_at=SPARSE_ROUNDS)
    bb, bf = run("cached", cached, SPARSE_ROUNDS, True, snap_at=SPARSE_ROUNDS)
    L = SPARSE_PARAMS["num_leaves"]
    C = bset._binned.num_columns
    F = bset._binned.num_features
    check(uf["k1_columns"] == [F] and bf["k1_columns"] == [C],
          f"sparse: K1 scanned {uf['k1_columns']} / {bf['k1_columns']} "
          f"columns")
    same_tree_arrays(bb._booster.tree_arrays,
                     ub._booster.tree_arrays[:SPARSE_ROUNDS],
                     "sparse cached bundled against unbundled")
    for a, b in zip(runs["cached"][1], runs["cached_unbundled"][1]):
        check(torch.equal(a, b), "sparse: bundled score buffer differs "
                                 "from the unbundled run's")
    check(trees_text(bb.model_to_string(), 0, SPARSE_ROUNDS)
          == trees_text(ub.model_to_string(), 0, SPARSE_ROUNDS),
          "sparse: the bundled model's trees differ from the unbundled's "
          "as text")
    # K1 and K2 on the runs' own bins with the second round's gradients
    g1, h1 = second_round_gradients(bb._booster)
    k1_windows = k1_on_run(bb._booster, g1, h1, "sparse cached")
    k2_err = {"bundled": k2_on_run(bb._booster, g1, h1, "sparse cached"),
              "unbundled": k2_on_run(ub._booster,
                                     *second_round_gradients(ub._booster),
                                     "sparse cached_unbundled")}
    del g1, h1
    timing = sparse_timing(bb._booster, ub._booster, reps)
    # predictions through K4: the bundled model against the unbundled
    fw.reset_launch_counts()
    pred_b = bb.predict(Xv[:4096], raw_score=True)
    pred_u = ub.predict(Xv[:4096], raw_score=True,
                        num_iteration=SPARSE_ROUNDS)
    k4 = sum(fw.launch_counts().values())
    total["forest_walk"] += k4
    check(k4 >= 2 and np.array_equal(pred_b, pred_u),
          f"sparse: bundled predictions differ from the unbundled's "
          f"({k4} K4 launches)")
    buf = bb._booster.valid_data[0].score[0, :4096].double().cpu().numpy()
    d_pred = float(np.abs(pred_b - buf).max())
    check(d_pred <= 1e-5, f"sparse: K4 against the valid score buffer "
                          f"{d_pred}")
    # after the comparisons: each takes one more round
    profiles = {"cached": profile_round(bb, "cached_bundled"),
                "cached_unbundled": profile_round(ub, "cached")}
    del runs["cached_unbundled"]

    # ordered: the cached fallback with the JAX package's warning
    log._warned_once.discard("serial_grow_decode")
    ob, of = run("ordered", base, SPARSE_SHORT_ROUNDS, True)
    check(ob._booster.grow_kind == "cached"
          and "serial_grow_decode" in log._warned_once,
          "sparse: ordered did not fall back to cached with its warning")
    same_tree_arrays(ob._booster.tree_arrays,
                     bb._booster.tree_arrays[:SPARSE_SHORT_ROUNDS],
                     "sparse ordered (cached fallback) against cached")
    del runs["ordered"]

    # nocache and fused, unbundled (K2, K3 on the F features) and over
    # the bundled columns (K2 on C columns, no K3): the first two trees
    # re-grown through the plain versions in f32 and f64
    regrown = {}
    nocache = {"histogram_pool_size": 1, "memory_policy": "degrade"}
    for name, extra, kind, bundled in (
            ("nocache_unbundled", nocache, "nocache", False),
            ("fused_unbundled", {"serial_grow": "fused"}, "fused", False),
            ("nocache", nocache, "nocache", True),
            ("fused", {"serial_grow": "fused"}, "fused", True)):
        booster, fields = run(name, {**base, **extra}, SPARSE_SHORT_ROUNDS,
                              bundled)
        gbdt = booster._booster
        check(gbdt.grow_kind == kind, f"sparse {name}: {gbdt.grow_kind}")
        k3 = kind == "fused" and not bundled
        want = {"digit_histogram": 0,
                "children_histograms": 0 if k3 else SPARSE_SHORT_ROUNDS * L,
                "fused_split_candidates": SPARSE_SHORT_ROUNDS * L if k3
                else 0}
        check(fields["launches"] == want
              and fields["k2_columns"] == ([] if k3 else [C if bundled
                                                         else F]),
              f"sparse {name}: launches {fields['launches']}, K2 columns "
              f"{fields['k2_columns']}")
        regrown[name] = regrow_against_f64(gbdt, f"sparse {name}")
        del runs[name]

    # bagging, GOSS and DART (the cached grower) against unbundled twins
    sampled = {"bagging": {"bagging_fraction": 0.8, "bagging_freq": 5},
               "goss": {"boosting_type": "goss", "top_rate": 0.2,
                        "other_rate": 0.1, **SPARSE_GOSS_LR},
               "dart": {"boosting_type": "dart"}}
    for name, extra in sampled.items():
        params = {**cached, **extra}
        tb, _ = run(name, params, SPARSE_SAMPLED_ROUNDS, True)
        tu, _ = run(f"{name}_unbundled", params, SPARSE_SAMPLED_ROUNDS,
                    False)
        same_tree_arrays(tb._booster.tree_arrays, tu._booster.tree_arrays,
                         f"sparse {name} bundled against unbundled")
        check(torch.equal(tb._booster.train_data.score,
                          tu._booster.train_data.score),
              f"sparse {name}: score buffers differ")
        if name == "dart":
            out[name]["tree_weights"] = tb._booster.tree_weights
        del runs[name], runs[f"{name}_unbundled"]

    # linear leaves: bundled against unbundled within the linear tolerance
    lin = {**cached, "linear_tree": True, "linear_max_leaf_features": 5,
           "linear_lambda": 0.01}
    lb, _ = run("linear", lin, SPARSE_SHORT_ROUNDS, True)
    lu, _ = run("linear_unbundled", lin, SPARSE_SHORT_ROUNDS, False)
    linear_cmp = []
    for i, (a, b) in enumerate(zip(lb._booster.tree_arrays,
                                   lu._booster.tree_arrays)):
        flip, rel = compare_regrown(a, b, f"sparse linear tree {i}",
                                    exact=False)
        check(rel <= LINEAR_LEAF_RTOL, f"sparse linear tree {i}: {rel}")
        linear_cmp.append({"tree": i, "near_tie_flip": flip,
                           "max_value_diff_of_field_max": rel})
        if flip is not None:
            break
    del runs["linear"], runs["linear_unbundled"]

    # screening on the bundled set
    screened = {**base, **SPARSE_SCREEN}
    sb, sf = run("screening", screened, SPARSE_SCREEN_ROUNDS, True)
    gbdt = sb._booster
    periods = [(it, cols.tolist()) for it, cols in gbdt.screen_periods]
    replay = [(it, cols.tolist())
              for it, cols in screen_replay(screened, gbdt,
                                            SPARSE_SCREEN_ROUNDS)]
    check(periods and periods == replay,
          f"sparse screening: active columns {periods} != the CPU replay "
          f"{replay}")
    keep = gbdt._screener.keep_cols
    modes = [gbdt._screener.round_mode(it)
             for it in range(SPARSE_SCREEN_ROUNDS)]
    for it, (mode, width) in enumerate(zip(modes,
                                           sf["k1_columns_by_round"])):
        want = [keep] if mode == "screened" else [C]
        check(width == want, f"sparse screening: round {it} ({mode}) ran "
                             f"K1 over {width} columns, not {want}")
    d_auc = abs(sf["valid_auc"][-1] - uf["valid_auc"][-1])
    check(d_auc <= SPARSE_AUC_PIN,
          f"sparse screening: valid AUC {sf['valid_auc'][-1]} against the "
          f"unbundled run's {uf['valid_auc'][-1]}")
    del runs["screening"]

    # the bundled set through a binary file (the raw values the linear
    # runs keep are left out of the file), then one round
    path = f"{workdir}/ctr_bundled.bin"
    binned = copy.copy(bset._binned)
    binned.raw = None
    t0 = time.perf_counter()
    binned.save_binary(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = lt.Dataset(path, params=cached).construct()
    load_s = time.perf_counter() - t0
    check(loaded._binned.bundle_plan.signature()
          == binned.bundle_plan.signature()
          and np.array_equal(loaded._binned.bins, binned.bins),
          "sparse: the binary file's bins or plan differ")
    lh.reset_launch_counts()
    one = lt.Booster(params=cached, train_set=loaded)
    one.update()
    total["digit_histogram"] += lh.launch_counts()["digit_histogram"]
    same_tree_arrays(one._booster.tree_arrays, bb._booster.tree_arrays[:1],
                     "sparse binary file: one round")

    medians = {k: v["round_s_median_after_2"] for k, v in out.items()}
    emit({"phase": "sparse", "params": SPARSE_PARAMS,
          "rows": SPARSE_ROWS, "features": F, "columns": C,
          "runs": out, "round_s_median_after_2": medians,
          "regrown": regrown, "linear_vs_unbundled": linear_cmp,
          "screen_periods": periods, "screen_keep_columns": keep,
          "valid_auc_screened_vs_unbundled": d_auc,
          "k1_bit_equal_on_run_bins": k1_windows,
          "k2_on_run_bins": k2_err,
          "k4_launches": k4, "k4_vs_valid_score_buffer": d_pred,
          "timing": timing, "profile_round": profiles,
          "binary_file": {"save_s": save_s, "load_s": load_s,
                          "bytes": os.path.getsize(path)},
          "launches": total, "seconds": time.perf_counter() - t_phase,
          "card": nvidia_smi_line()})
    return total



def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def phase_rule2(seed, dev, reps, at, windows, launches):
    """The order in which to redesign the kernels: first those that lose
    to the PyTorch call computing the same function at the sizes the
    main path launches them, then by launches x (ms - bound_ms); each
    entry names the PR that redesigned the kernel (REDESIGNED), if one
    did.  K1 is
    timed, beside ``index_add_`` and its bound, at each power-of-two
    window class the train phase counted (at the class's top size, the
    1M-row root for the largest); every other kernel at its kernels-line
    shape (K2/K3 run only at the training root, the full pass)."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    F, B = 28, 255
    bins, dig = hist_inputs(np.random.RandomState(seed + 52), TRAIN_ROWS, F,
                            B, np.uint8, dev)
    k1 = []
    for cls, n in windows.get("digit_histogram", {}).items():
        S = min(int(cls), TRAIN_ROWS)
        nbytes = lh.launch_cost(S, F, bins.element_size(), B)
        ops = int((dig[:S] != 0).sum()) * F
        k1.append({"window_class": int(cls), "S": S, "launches": n,
                   "ms": cuda_ms(lambda: lh.digit_histogram(bins, dig, B, 0,
                                                            S), reps),
                   "library_ms": cuda_ms(index_add_call(bins, dig, S, F, B),
                                         5),
                   "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                   ops / F32_OPS_PER_S) * 1e3})
    order = []
    for name, r in at.items():
        if name == "digit_histogram" and k1:
            gap = sum(c["launches"] * (c["ms"] - c["bound_ms"]) for c in k1)
            losing = sum(c["launches"] for c in k1
                         if c["ms"] > c["library_ms"])
        else:
            gap = launches[name] * (r["ms"] - r["bound_ms"])
            lib = r.get("library_ms")
            losing = launches[name] if lib is not None and r["ms"] > lib \
                else 0
        order.append({"kernel": name, "launches": launches[name],
                      "launches_losing_to_library": losing,
                      "launch_ms_over_bound": gap,
                      "redesigned_in_pr": REDESIGNED.get(name)})
    order.sort(key=lambda o: (o["launches_losing_to_library"] == 0,
                              -o["launch_ms_over_bound"]))
    emit({"phase": "rule2", "k1_by_window_class": k1, "order": order})


def back_to_back_ms(fn, reps: int, per: int = 50) -> float:
    """Median over ``reps`` CUDA-event timings of ``per`` calls of ``fn``
    enqueued back to back, divided by ``per``: a kernel's time without
    the host's launch cost where the kernel is the longer of the two."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per)
    return float(np.median(times))


def graph_ms(fn, per: int = 50, reps: int = 10) -> float:
    """Median over ``reps`` CUDA-event timings of one replay of a CUDA
    graph that holds ``per`` calls of ``fn``, divided by ``per``: a
    call's device time back to back, with no host launch path between
    the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    return cuda_ms(graph.replay, reps) / per


def phase_timing(seed, dev, higgs_model, higgs_grid, lin_model, lin_grid,
                 reps):
    """Every walk variant at each B of TIMING_SIZES: the constant f32 and
    bf16 tables on the Higgs forest's trees, the linear f32 and bf16 ones
    on the linear Higgs forest's, beside the constant walk over the same
    trees (``const_walk_ms``), each timed as ``timed`` does (``ms`` is
    its ``single_ms``; ``device_us`` names pass 0, the raw rows'
    bucketize, pass 1 and pass 2), with its launch plan.  Plain versions
    at every B for the constant f32 walks, at B = 4096 for the others.
    Bound: bins (or raw rows) plus the linear binned walk's covariates
    plus the output plus the forest tables (nodes, leaves, affine
    tables) and the raw walk's cut tables once, over 3.35 TB/s; ops: this
    data's node visits, 4 Kahan operations a tree a row, the raw walk's
    binary searches and, for linear leaves, a multiply and an add a used
    slot plus one add."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import forest_walk as fw

    def freeze(g, quantize=False):
        return lt.CompiledForest.from_booster(g, device=dev,
                                              quantize_leaves=quantize)

    structures = (
        ("higgs", (freeze(higgs_model),
                   freeze(scaled(higgs_model, TINY_LEAVES), True)),
         higgs_grid, (), 0),
        ("higgs_linear", (freeze(lin_model),
                          freeze(scaled(lin_model, TINY_LEAVES), True)),
         lin_grid, LINEAR_CAT, 8))
    rng = np.random.RandomState(seed + 30)
    rows = []
    for struct, cfs, grid, cat, ncat in structures:
        base = cfs[0].walk_tables
        const = base._replace(coeff=None, feat=None, max_feat=-1)
        bnd, cats, is_cat = cfs[0].cut_tables()
        depth = torch.from_numpy(leaf_depths(base)).to(dev)
        K, T = base.num_class, base.trees_per_class
        search_steps = int(np.ceil(np.log2(bnd.shape[1] + 1)))
        for B in TIMING_SIZES:
            X = random_rows(rng, B, grid, cat, ncat, tie_frac=0.02)
            bins = cfs[0].device_bins(X)
            xr = cfs[0].device_rows(X)
            xt = cfs[0].device_covariates(X)
            F = xr.shape[0]
            leaves = fw.walk_plain(const, bins)[1]
            leaves_r = fw.walk_plain(const, fw.bucketize_plain(
                bnd, cats, is_cat, xr, const.nan_bin))[1]
            const_ms = (cuda_ms(lambda: fw.forest_walk(const, bins), reps),
                        cuda_ms(lambda: fw.forest_walk_raw(
                            const, bnd, cats, is_cat, xr), reps))
            for cf in cfs:
                t = cf.walk_tables
                cov = xt if t.linear else None
                slots = None
                if t.linear:
                    slots = (t.feat >= 0).sum(dim=2).reshape(K, T, -1)
                for raw in (False, True):
                    name = t.variant(raw)
                    lv = leaves_r if raw else leaves
                    if raw:
                        def run():
                            return fw.forest_walk_raw(t, bnd, cats, is_cat,
                                                      xr)

                        def plain():
                            return fw.forest_walk_raw_plain(
                                t, bnd, cats, is_cat, xr)
                        nbytes = fw.launch_cost(t, F, B, True,
                                                cut_cols=bnd.shape[1])
                    else:
                        def run():
                            return fw.forest_walk(t, bins, cov)

                        def plain():
                            return fw.forest_walk_plain(t, bins, cov)
                        nbytes = fw.launch_cost(t, F, B, False,
                                                bins.element_size())
                    visits = int(depth.gather(2, lv).sum())
                    ops = visits + 4 * K * T * B + (
                        B * F * search_steps if raw else 0)
                    if t.linear:
                        ops += int((2 * slots.gather(2, lv) + 1).sum())
                    t4 = timed(run, reps)
                    ms = t4["single_ms"]
                    const_f32 = name in ("forest_walk", "forest_walk_raw")
                    plain_ms = (cuda_ms(plain, 1) if const_f32 or B == 4096
                                else None)
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = ops / F32_OPS_PER_S * 1e3
                    row = {"kernel": name, "forest": struct, "B": B,
                           "ms": ms, "plain_ms": plain_ms,
                           "rows_per_s": B / (ms * 1e-3),
                           "node_visits": visits,
                           "bytes": int(nbytes), "ops": int(ops),
                           "bound_ms": max(bytes_ms, ops_ms),
                           "bound_by": "bytes" if bytes_ms >= ops_ms
                           else "operations"}
                    if not const_f32:
                        row["const_walk_ms"] = const_ms[int(raw)]
                    row.update(t4)
                    row["plan"] = fw.walk_plan(t, F, B, raw)._asdict()
                    rows.append(row)
    rows += leaf_hist_timing(seed, dev, reps)
    rows += children_hist_timing(seed, dev, reps)
    rows += probe_timing(dev, reps)
    emit({"phase": "timing", "reps": reps, "rows": rows})
    return rows


def leaf_hist_timing(seed, dev, reps):
    """K1 at the root of the training cell (28 features, 255 bins, uint8)
    and at smaller windows: kernel, plain version and the one
    ``index_add_`` call the plain version is built on, beside the bound.
    Bytes: every input row read once and the output written once; ops:
    one add per non-zero digit per feature (this data's count)."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    rng = np.random.RandomState(seed + 50)
    F, B = 28, 255
    bins, dig = hist_inputs(rng, max(HIST_TIMING_SIZES), F, B, np.uint8,
                            dev)
    rows = []
    for S in HIST_TIMING_SIZES:
        k_ms = cuda_ms(lambda: lh.digit_histogram(bins, dig, B, 0, S), reps)
        p_ms = cuda_ms(lambda: lh.digit_histogram_plain(bins, dig, B, 0, S),
                       2)
        lib_ms = cuda_ms(index_add_call(bins, dig, S, F, B), 2)
        nbytes = lh.launch_cost(S, F, bins.element_size(), B)
        ops = int((dig[:S] != 0).sum()) * F
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        rows.append({"kernel": "digit_histogram", "S": S, "F": F,
                     "max_bin": B,
                     "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                     "rows_per_s": S / (k_ms * 1e-3), "bytes": int(nbytes),
                     "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations"})
    return rows


def children_hist_timing(seed, dev, reps):
    """K2 and K3 in their root form (every row in the left child) at S
    rows, 28 features, 255 bins, uint8: kernel, plain version and, for
    K2, the one f32 ``index_add_`` its plain version is built on (no
    PyTorch call computes K3's candidates: null), beside the bound.
    Bytes: bins, g, h, w and leaf ids read once, the output written once
    (K3's scratch stays in L2); ops: three adds per row per feature (this
    data puts every row in a child), plus for K3 about 20 operations per
    (child, feature, bin) of the scan."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops.split import SplitParams
    rng = np.random.RandomState(seed + 51)
    F, B = 28, 255
    Smax = max(HIST_TIMING_SIZES)
    bins_all, g_all, h_all, w_all, _ = children_inputs(rng, Smax, F, B,
                                                       np.uint8, dev)
    sp = SplitParams(TRAIN_PARAMS["min_data_in_leaf"], 1e-3)
    nb = torch.full((F,), B, dtype=torch.int32, device=dev)
    cat = torch.zeros(F, dtype=torch.bool, device=dev)
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    rows = []
    for S in HIST_TIMING_SIZES:
        bins = bins_all[:, :S].contiguous()
        g, h, w = g_all[:S], h_all[:S], w_all[:S]
        leaf = torch.zeros(S, dtype=torch.int32, device=dev)
        totals = torch.stack([torch.stack([g.sum(), h.sum(), w.sum()]),
                              torch.zeros(3, device=dev)])
        k2 = (bins, g, h, w, leaf, 0, -2, B)
        k3 = (bins, g, h, w, leaf, 0, -2, totals, nb, cat, fm, B, sp)
        k2_ms = cuda_ms(lambda: ch.children_histograms(*k2), reps)
        k3_ms = cuda_ms(lambda: ch.fused_split_candidates(*k3), reps)
        p2_ms = cuda_ms(lambda: ch.build_children_histograms(*k2), 2)
        p3_ms = cuda_ms(lambda: ch.fused_split_candidates_plain(*k3), 2)
        seg = (torch.arange(F, device=dev)[:, None] * B
               + bins.long()).reshape(-1)
        vals = torch.stack([g, h, w], dim=-1)[None].expand(F, S, 3) \
            .reshape(-1, 3)
        acc = torch.zeros((2 * F * B + 1, 3), dtype=torch.float32,
                          device=dev)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, seg, vals), 2)
        del seg, vals, acc
        for name, ms, plain_ms, lib, scan, ops in (
                ("children_histograms", k2_ms, p2_ms, lib_ms, False,
                 3 * S * F),
                ("fused_split_candidates", k3_ms, p3_ms, None, True,
                 3 * S * F + 20 * 2 * F * B)):
            nbytes = ch.launch_cost(S, F, bins.element_size(), B, scan)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            rows.append({"kernel": name, "S": S, "F": F, "max_bin": B,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
                         "rows_per_s": S / (ms * 1e-3),
                         "bytes": int(nbytes), "ops": int(ops),
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": "bytes" if bytes_ms >= ops_ms
                         else "operations"})
        del bins, leaf
    return rows


def host_enqueue_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (no
    synchronize inside the loop): the host part of a call's time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_us(fn, calls: int = 10, tries: int = 5):
    """Device-only microseconds a call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``calls`` calls, or "not measured" where the
    profiler shows no device time in ``tries`` attempts (0.2 s apart).  Each timed call
    launches each of its kernels once, so a kernel's time a call is the
    mean over the launches the profiler recorded (it does not always
    record all of them, nor always any)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0)
            if t and t > 0 and e.count > 0:
                out[e.key[:120]] = t / e.count
        if out:
            return out
        time.sleep(0.2)
    return "not measured"


def timed(fn, reps: int):
    """A call's time three ways: alone (CUDA events around one call,
    host enqueue included), back to back (``back_to_back_ms``) and its
    host enqueue; plus its device-only time by kernel name."""
    dev_us = device_us(fn)
    row = {"single_ms": cuda_ms(fn, reps),
           "back_to_back_ms": back_to_back_ms(fn, max(1, reps // 2), 20),
           "host_enqueue_us": host_enqueue_us(fn), "device_us": dev_us}
    if isinstance(dev_us, dict):
        row["device_ms_total"] = sum(dev_us.values()) * 1e-3
    return row


def index_add_call(bins, dig, S: int, F: int, B: int):
    """The one ``index_add_`` call that computes K1's function over the
    first S rows (its inputs built outside the timed call)."""
    dev = bins.device
    seg = (torch.arange(F, device=dev)[None, :] * B
           + bins[:S].long()).reshape(-1)
    vals = dig[:S].to(torch.int32)[:, None, :].expand(S, F, 9).reshape(-1, 9)
    acc = torch.zeros((F * B, 9), dtype=torch.int32, device=dev)
    return lambda: acc.index_add_(0, seg, vals)


def k1_window_timing(seed, dev, reps):
    """K1 at every window class of the train phase (uint8, 28 features,
    255 bins, the class's top size, the 1M-row root for 2^20): the small
    path, the large path, the wrapper as the growers call it (its own
    choice of path) and the ``index_add_`` library call, each timed
    alone, back to back, by its host enqueue and by its device time.
    The crossover: the smallest class from which the large path's
    device time (back to back where the profiler shows none) is below the
    small path's at every larger class."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    F, B = 28, 255
    rng = np.random.RandomState(seed + 53)
    bins, dig = hist_inputs(rng, TRAIN_ROWS, F, B, np.uint8, dev)
    classes = []
    for cls in WINDOW_CLASSES:
        S = min(cls, TRAIN_ROWS)
        calls = {
            "small": lambda: lh.digit_histogram(bins, dig, B, 0, S,
                                                path="small"),
            "large": lambda: lh.digit_histogram(bins, dig, B, 0, S,
                                                path="large"),
            "wrapper": lambda: lh.digit_histogram(bins, dig, B, 0, S),
            "index_add_": index_add_call(bins, dig, S, F, B)}
        row = {"window_class": cls, "S": S,
               "plan": lh.plan(S, F, B, lh.sm_count(dev.index))._asdict(),
               **{name: timed(fn, reps) for name, fn in calls.items()}}
        classes.append(row)

    def device_ms(t):
        return t.get("device_ms_total", t["back_to_back_ms"])

    crossover = None
    for row in reversed(classes):
        if device_ms(row["large"]) >= device_ms(row["small"]):
            break
        crossover = row["window_class"]
    return {"classes": classes, "crossover_class": crossover,
            "small_window_max_rows": lh.SMALL_WINDOW_MAX_ROWS}


def children_index_add(bins, g, h, w, leaf, max_bin: int):
    """The one ``index_add_`` call that computes K2's function, as its
    plain version builds it: (child, feature, bin) keys with a dump slot
    for rows of neither child (leaf 1 left, leaf 2 right; its inputs built
    outside the timed call)."""
    F, N = bins.shape
    dev = bins.device
    child = (leaf == 2).long()
    seg = (child[None, :] * (F * max_bin)
           + torch.arange(F, device=dev)[:, None] * max_bin + bins.long())
    seg = torch.where(((leaf == 1) | (leaf == 2))[None, :], seg,
                      torch.full_like(seg, 2 * F * max_bin)).reshape(-1)
    vals = torch.stack([g, h, w], dim=-1)[None].expand(F, N, 3) \
        .reshape(-1, 3)
    acc = torch.zeros((2 * F * max_bin + 1, 3), dtype=torch.float32,
                      device=dev)
    return lambda: acc.index_add_(0, seg, vals)


def k3_occupancy_timing(seed, dev, reps):
    """K3 and K2 on the fused grower's 1M-row full pass
    (28 features, 255 bins, uint8) with OCCUPANCIES rows in the two
    children (``occupancy_leaves``), each timed as ``timed`` does, beside
    the ``index_add_`` call computing K2's function (``library_ms``,
    CUDA events); and K2's root form (``root_histogram``, no leaf
    array) over all rows."""
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops.split import SplitParams
    N, F, B = TRAIN_ROWS, 28, 255
    bins, g, h, w, _ = children_inputs(np.random.RandomState(seed + 54), N,
                                       F, B, np.uint8, dev)
    sp = SplitParams(TRAIN_PARAMS["min_data_in_leaf"], 1e-3)
    nb = torch.full((F,), B, dtype=torch.int32, device=dev)
    cat = torch.zeros(F, dtype=torch.bool, device=dev)
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    rows = []
    for occ in OCCUPANCIES:
        leaf = occupancy_leaves(seed, N, occ, dev)
        k3 = (bins, g, h, w, leaf, 1, 2, child_totals(g, h, w, leaf), nb,
              cat, fm, B, sp)
        lib = children_index_add(bins, g, h, w, leaf, B)
        row = {"occupancy": min(occ, N), "rows": N,
               "k2": timed(lambda: ch.children_histograms(
                   bins, g, h, w, leaf, 1, 2, B), reps),
               "k3": timed(lambda: ch.fused_split_candidates(*k3), reps),
               "library_ms": cuda_ms(lib, 5)}
        del lib
        rows.append(row)
    return {"occupancies": rows,
            "k2_root": timed(lambda: ch.root_histogram(bins, g, h, w, B),
                             reps)}


def probe_timing(dev, reps):
    """P1 on the probe's input: the kernel alone (launched back to back;
    also as single launches, which include the host's launch cost, and
    by its host enqueue), the plain version and one call of the probe's
    50-call chain (kernel + ``^ 1``) and a CUDA graph of 50 launches
    replayed (``graph_ms``: the device's time a launch, no host path),
    beside three launch floors: an empty kernel launched back to back
    from one C loop (``launch_floor_ms``), from one Python call a launch
    through the same host path as the wrapper
    (``python_launch_floor_ms``) and in a replayed graph
    (``graph_launch_floor_ms``).  Bytes: the block read once and
    written once; ops: per stage and column one compare, one select per
    word and the 13 roll reads (the count the JAX probe's comment
    implies), 2 x 13 a column.  No PyTorch call computes a roll-select
    chain (library null).

    P2 on the probe's inputs and first window (5, N/2): each of the
    probe's five runs as the probe calls it (the TPU's nb sets nothing on
    the card, so the words runs and the matrix runs each time one call),
    each timed as ``timed`` does (``ms`` is ``single_ms``: events around
    one call), beside K1 on the same window timed the same ways in the
    same run (``over_k1``: the ratios), the plain version (which reads
    the window on the host and unpacks it) and the ``index_add_`` its
    plain version is built on, on the already unpacked window (the unpack
    not timed).
    Bytes: the window's bin and digit words (or matrix rows) read once,
    the window and the output; ops: one add per non-zero digit per
    feature (this data's count).  The kernels line takes laneconcat at
    nb = 2048, the probe's first run."""
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    from lightgbm_tpu_torch.tools import probe_dynhist as pd
    from lightgbm_tpu_torch.tools import probe_roll as pr

    def bound(nbytes, ops):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        return {"bytes": int(nbytes), "ops": int(ops),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    x = torch.from_numpy(pr.make_input()).to(dev)
    floor_calls = 1000
    p1 = timed(lambda: rc.roll_chain(x), reps)
    rows = [{"kernel": "roll_chain", "stages": rc.STAGES,
             "words": rc.WORDS, "nb": rc.NB,
             "ms": back_to_back_ms(lambda: rc.roll_chain(x), reps),
             **p1, "plain_ms": cuda_ms(lambda: rc.roll_chain_plain(x), reps),
             "library_ms": None,
             "chain_ms_per_call": cuda_ms(lambda: pr.chain(x), 5) / pr.CHAIN,
             "launch_floor_ms": cuda_ms(
                 lambda: rc.empty_launches(dev, floor_calls), 5)
             / floor_calls,
             "python_launch_floor_ms": back_to_back_ms(
                 lambda: rc.empty_launches(dev), reps),
             "graph_ms": graph_ms(lambda: rc.roll_chain(x)),
             "graph_launch_floor_ms": graph_ms(
                 lambda: rc.empty_launches(dev)),
             # one SM's shared-memory traffic: per stage and column one
             # 8-byte (key, source) read and one 8-byte write
             "smem_bytes": rc.STAGES * rc.NB * 16,
             **bound(rc.launch_cost(x.numel()),
                     rc.STAGES * rc.NB * 2 * (rc.WORDS + 1)),
             "kernels_line": True}]

    bins, digits = pd.make_inputs(pd.N)
    n = bins.shape[0]
    bw, dw, dmat = pd.device_inputs(bins, digits, dev)
    off, count = pd.FIRST_OFF, n // 2
    win = torch.tensor([off, count], dtype=torch.int32, device=dev)
    tb = torch.from_numpy(bins).to(dev)
    k1 = timed(lambda: lh.digit_histogram(tb, dmat, pd.B, off, count), reps)
    ops = int((dmat[off:off + count] != 0).sum()) * pd.F
    seg = (torch.arange(pd.F, device=dev)[None, :] * pd.B
           + tb[off:off + count].long()).reshape(-1)
    vals = dmat[off:off + count].to(torch.int32)[:, None, :] \
        .expand(count, pd.F, 9).reshape(-1, 9)
    acc = torch.zeros((pd.F * pd.B, 9), dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, seg, vals), 2)
    del seg, vals, acc
    plain = {m: cuda_ms(lambda: wh.window_digit_histogram_plain(
        bw, dmat if m else dw, win, pd.F, pd.B), 2) for m in (False, True)}

    def p2_row(name, nb, matrix):
        dig = dmat if matrix else dw
        t = timed(lambda: wh.window_digit_histogram(
            bw, dig, win, pd.F, pd.B), reps)
        nbytes = wh.launch_cost(count, len(bw), matrix, pd.F, pd.B)
        return {"kernel": "window_digit_histogram", "layout": name,
                "nb": nb, "digits": "matrix" if matrix else "words",
                "plan": wh.card_plan(bw, dig, pd.F, pd.B)._asdict(),
                "S": count, "F": pd.F, "max_bin": pd.B,
                "ms": t["single_ms"], **t,
                "plain_ms": plain[matrix], "library_ms": lib_ms,
                "k1_same_window": k1,
                "over_k1": {k: t[k] / k1[k] for k in
                            ("single_ms", "back_to_back_ms",
                             "device_ms_total") if k in t and k in k1},
                "rows_per_s": count / (t["single_ms"] * 1e-3),
                **bound(nbytes, ops),
                "kernels_line": name == "laneconcat" and nb == 2048}

    for name, nb, matrix in pd.RUNS:
        rows.append(p2_row(name, nb, matrix))
    return rows


# the capi phase: the C-host flow's rows, rounds and test rows; the
# GetCurrentIteration round trips a host times; the demo's time limit
CAPI_SLICE_ROWS, CAPI_C_ROUNDS, CAPI_C_TEST_ROWS = 100_000, 5, 4096
CAPI_CALL_REPS = 1000
CAPI_DEMO_TIMEOUT_S = 300
CAPI_LEAF_ROWS = 5


class CApiCalls:
    """The port's C library through ``ctypes`` (``cdef.declare``'s
    prototypes), with the calls the ``capi`` phase makes."""

    def __init__(self, lib):
        self.lib = lib

    def ok(self, rc, what):
        check(rc == 0, f"capi: {what}: "
              f"{self.lib.LGBM_GetLastError().decode()}")

    def dataset(self, X, y, params):
        import ctypes
        X = np.ascontiguousarray(X, np.float64)
        y = np.ascontiguousarray(y, np.float32)
        h = ctypes.c_void_p()
        self.ok(self.lib.LGBM_DatasetCreateFromMat(
            X.ctypes.data, 1, X.shape[0], X.shape[1], 1, params.encode(),
            None, ctypes.byref(h)), "LGBM_DatasetCreateFromMat")
        self.ok(self.lib.LGBM_DatasetSetField(
            h, b"label", y.ctypes.data, len(y), 0), "LGBM_DatasetSetField")
        return h

    def booster(self, ds, params):
        import ctypes
        b = ctypes.c_void_p()
        self.ok(self.lib.LGBM_BoosterCreate(ds, params.encode(),
                                            ctypes.byref(b)),
                "LGBM_BoosterCreate")
        return b

    def update(self, b):
        import ctypes
        self.ok(self.lib.LGBM_BoosterUpdateOneIter(
            b, ctypes.byref(ctypes.c_int())), "LGBM_BoosterUpdateOneIter")

    def predict(self, b, X, predict_type=0):
        import ctypes
        X = np.ascontiguousarray(X, np.float64)
        per = ctypes.c_int64()
        self.ok(self.lib.LGBM_BoosterCalcNumPredict(
            b, 1, predict_type, -1, ctypes.byref(per)),
            "LGBM_BoosterCalcNumPredict")
        out = np.zeros(X.shape[0] * per.value)
        n = ctypes.c_int64()
        self.ok(self.lib.LGBM_BoosterPredictForMat(
            b, X.ctypes.data, 1, X.shape[0], X.shape[1], 1, predict_type, -1,
            ctypes.byref(n), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_double))),
            "LGBM_BoosterPredictForMat")
        check(n.value == len(out), f"capi: predicted {n.value} values")
        return out

    def model_text(self, b):
        import ctypes
        n = ctypes.c_int()
        self.ok(self.lib.LGBM_BoosterSaveModelToString(
            b, -1, 0, ctypes.byref(n), None), "LGBM_BoosterSaveModelToString")
        buf = ctypes.create_string_buffer(n.value)
        self.ok(self.lib.LGBM_BoosterSaveModelToString(
            b, -1, n.value, ctypes.byref(n), buf),
            "LGBM_BoosterSaveModelToString")
        return buf.value.decode()

    def call_us(self, b):
        """Mean microseconds of a GetCurrentIteration round trip."""
        import ctypes
        it = ctypes.c_int()
        t0 = time.perf_counter()
        for _ in range(CAPI_CALL_REPS):
            self.lib.LGBM_BoosterGetCurrentIteration(b, ctypes.byref(it))
        return (time.perf_counter() - t0) / CAPI_CALL_REPS * 1e6


def _label_hist_free(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("label_hist="))


def _median_from_third(times):
    return float(np.median(times[2:]))


def _timed_round(step):
    """Seconds of one boosting round, to the card's end, and its K1
    launches."""
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _launches()[0]


def phase_capi(seed, workdir):
    """The C API on the card (``lightgbm_tpu_torch/capi/``): the library
    built from its C shim by the host compiler, then two hosts.
    The Python host (``ctypes`` in this process) at the Higgs cell's
    width: 1M x 28 rows through ``LGBM_DatasetCreateFromMat`` and
    ``SetField("label")``, ``LGBM_BoosterCreate`` with ``TRAIN_PARAMS``
    and ``device=cuda``, ``TRAIN_ROUNDS`` x ``UpdateOneIter`` (K1, the
    ordered grower), the 100k valid rows through ``PredictForMat`` (K4)
    and leaf indices of 5 rows.  Held against ``lt.Booster`` trained the
    same rounds on the card: the model text byte-equal to the Booster's
    whose Dataset got its label after construction (the C API's route),
    and to ``lt.Dataset(X, y)``'s but for the fingerprint's
    ``label_hist`` line (the C API builds its dataset before it has a
    label); predictions and leaf indices bit-equal; K1 launches equal;
    one K4 launch a bucket of the predict ladder; ``SetLeafValue`` then
    ``PredictForMat`` moves exactly the rows that reach that leaf.  The
    C host: ``capi/demo.c`` compiled and run in a process of its own,
    which boots its own interpreter, on a 100k-row slice written as a
    raw .f64 file, 5 rounds and 4096 predicted rows: its model file and
    predictions byte-equal to the same calls from this process.
    Returns the launches of the counted runs."""
    import ctypes
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.capi import build as capi_build
    from lightgbm_tpu_torch.capi import cdef
    from lightgbm_tpu_torch.capi import impl
    t_phase = time.perf_counter()
    try:
        import cffi  # noqa: F401
        has_cffi = True
    except ImportError:
        has_cffi = False
    t0 = time.perf_counter()
    lib_path = capi_build.build_library(force=True)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    demo = capi_build.build_demo()
    demo_build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    cdef.declare(lib)
    api = CApiCalls(lib)
    t0 = time.perf_counter()
    lib.LGBM_DatasetGetNumData(None, ctypes.byref(ctypes.c_int()))
    boot_s = time.perf_counter() - t0
    check(impl.bind_library(lib_path) == len(cdef.API_NAMES) - 1,
          "capi: the library did not take every callback")

    X, y = make_higgs_like(TRAIN_ROWS, seed=seed + 40)
    Xv, yv = make_higgs_like(VALID_ROWS, seed=seed + 41)
    params = " ".join(f"{k}={v}" for k, v in TRAIN_PARAMS.items())
    card = f"{params} device=cuda"
    t0 = time.perf_counter()
    ds = api.dataset(X, y, params)
    dataset_s = time.perf_counter() - t0
    b = api.booster(ds, card)
    # the Python API on the same rows, its label set after binning (the
    # C API's route); the two boosters' rounds alternate (C API first in
    # even rounds), so that a drift of the host reads on both
    late_set = lt.Dataset(X, params=TRAIN_PARAMS)
    late_set.construct().set_label(y)
    late = lt.Booster(params=TRAIN_PARAMS, train_set=late_set)
    steps = {"capi": lambda: api.update(b), "python_api": late.update}
    round_s = {name: [] for name in steps}
    k1 = dict.fromkeys(steps, 0)
    for r in range(TRAIN_ROUNDS):
        for name in (("capi", "python_api") if r % 2 == 0
                     else ("python_api", "capi")):
            sec, n = _timed_round(steps[name])
            round_s[name].append(sec)
            k1[name] += n
    capi_rounds, py_rounds = round_s["capi"], round_s["python_api"]
    k1_capi, k1_py = k1["capi"], k1["python_api"]
    check(k1_py == k1_capi, f"capi: K1 launches {k1_capi} against the "
                            f"Python API's {k1_py}")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = api.predict(b, Xv)
    predict_s = time.perf_counter() - t0
    k4_capi = _launches()[1]
    buckets = len(impl._handles[b.value].forest(-1).ladder.chunks(
        VALID_ROWS))
    check(sum(k4_capi.values()) == buckets,
          f"capi: K4 launches {k4_capi} for {buckets} buckets")
    leaves = api.predict(b, Xv[:CAPI_LEAF_ROWS], 2)
    text = api.model_text(b)
    py_call_us = api.call_us(b)
    check(text == late.model_to_string(),
          "capi: model text differs from the Python API's: "
          + first_line_diff(text, late.model_to_string()))
    _reset_launches()
    want = late.predict(Xv)
    k4_py = _launches()[1]
    check(np.array_equal(pred, want), "capi: predictions differ from "
          f"Booster.predict by {np.abs(pred - want).max()}")
    check(np.array_equal(leaves, late.predict(
        Xv[:CAPI_LEAF_ROWS], pred_leaf=True).reshape(-1)),
          "capi: leaf indices differ from the Python API's")
    del late, late_set, steps
    labelled = lt.Booster(params=TRAIN_PARAMS,
                          train_set=lt.Dataset(X, y, params=TRAIN_PARAMS))
    for _ in range(TRAIN_ROUNDS):
        labelled.update()
    other = labelled.model_to_string()
    del labelled
    extra = [ln for ln in other.splitlines() if ln not in text.splitlines()]
    check([ln.split("=")[0] for ln in extra] == ["label_hist"]
          and _label_hist_free(other) == _label_hist_free(text),
          "capi: against lt.Dataset(X, y): " + first_line_diff(text, other))

    # SetLeafValue, then PredictForMat: exactly the rows of that leaf move
    rows = Xv[:4096]
    before = api.predict(b, rows, 1)
    leaf_of = api.predict(b, rows, 2).reshape(len(rows), -1)[:, 0]
    leaf = int(np.bincount(leaf_of.astype(np.int64)).argmax())
    old = ctypes.c_double()
    api.ok(lib.LGBM_BoosterGetLeafValue(b, 0, leaf, ctypes.byref(old)),
           "LGBM_BoosterGetLeafValue")
    api.ok(lib.LGBM_BoosterSetLeafValue(b, 0, leaf, old.value + 0.5),
           "LGBM_BoosterSetLeafValue")
    _reset_launches()
    after = api.predict(b, rows, 1)
    k4_leaf = _launches()[1]
    hit = leaf_of == leaf
    check(hit.any() and np.array_equal(after[~hit], before[~hit])
          and np.allclose(after[hit] - before[hit], 0.5, rtol=0, atol=1e-5),
          "capi: a predict after SetLeafValue did not move exactly that "
          "leaf's rows")

    # the C host: demo.c on a 100k-row slice, and the same calls here
    train_f64 = os.path.join(workdir, "capi_train.f64")
    test_f64 = os.path.join(workdir, "capi_test.f64")
    np.column_stack([y[:CAPI_SLICE_ROWS], X[:CAPI_SLICE_ROWS]]).astype(
        np.float64).tofile(train_f64)
    np.column_stack([yv[:CAPI_C_TEST_ROWS], Xv[:CAPI_C_TEST_ROWS]]).astype(
        np.float64).tofile(test_f64)
    model_c = os.path.join(workdir, "capi_model_c.txt")
    pred_c = os.path.join(workdir, "capi_pred_c.f64")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [demo, lib_path, train_f64, test_f64, str(X.shape[1]), card,
         str(CAPI_C_ROUNDS), model_c, pred_c], capture_output=True,
        text=True, timeout=CAPI_DEMO_TIMEOUT_S, cwd=workdir)
    c_wall_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"capi: the C host exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    c_host = json.loads(proc.stdout.strip().splitlines()[-1])
    ds_s = api.dataset(X[:CAPI_SLICE_ROWS], y[:CAPI_SLICE_ROWS], params)
    b_s = api.booster(ds_s, card)
    slice_rounds = [_timed_round(lambda: api.update(b_s))[0]
                    for _ in range(CAPI_C_ROUNDS)]
    slice_text = api.model_text(b_s)
    slice_pred = api.predict(b_s, Xv[:CAPI_C_TEST_ROWS])
    with open(model_c) as fh:
        check(fh.read() == slice_text, "capi: the C host's model differs "
              "from the Python host's")
    check(np.array_equal(np.fromfile(pred_c, np.float64), slice_pred),
          "capi: the C host's predictions differ from the Python host's")
    for h in (b, b_s):
        api.ok(lib.LGBM_BoosterFree(h), "LGBM_BoosterFree")
    for h in (ds, ds_s):
        api.ok(lib.LGBM_DatasetFree(h), "LGBM_DatasetFree")

    k4 = {name: k4_capi.get(name, 0) + k4_py.get(name, 0)
          + k4_leaf.get(name, 0) for name in {*k4_capi, *k4_py, *k4_leaf}}
    emit({"phase": "capi", "cffi_imports": has_cffi,
          "compiler": capi_build.compiler(), "library": lib_path,
          "build_s": build_s, "demo_build_s": demo_build_s,
          "python_host": {
              "boot_s": boot_s, "dataset_s": dataset_s,
              "rows": TRAIN_ROWS, "rounds": TRAIN_ROUNDS,
              "round_s": capi_rounds,
              "round_s_median_3_10": _median_from_third(capi_rounds),
              "python_api_round_s": py_rounds,
              "python_api_round_s_median_3_10":
                  _median_from_third(py_rounds),
              "capi_over_python_api": _median_from_third(capi_rounds)
              / _median_from_third(py_rounds),
              "predict_rows": VALID_ROWS, "predict_s": predict_s,
              "call_us": py_call_us, "k1_launches": k1_capi,
              "k4_launches": k4_capi, "k4_buckets": buckets,
              "model_text_equal_to_python_api": True,
              "predictions_bit_equal": True},
          "c_host": {**c_host, "wall_s": c_wall_s,
                     "round_s_median_3_5": _median_from_third(
                         c_host["round_s"]),
                     "python_host_round_s": slice_rounds,
                     "python_host_round_s_median_3_5":
                         _median_from_third(slice_rounds),
                     "model_text_equal": True,
                     "predictions_bit_equal": True},
          "seconds": time.perf_counter() - t_phase})
    return {"digit_histogram": k1_capi + k1_py, **k4}


# the loader phase: the Higgs-like file's rows (cut from the Higgs cell's
# 1M for time: the Python read of 1M rows alone takes ~25 s), the largest
# distance of a natively parsed feature from its correctly rounded value
# (the loader's parse_double is not correctly rounded; 6 ulps measured),
# the 300-category file's rows, columns and rounds
LOADER_ROWS = 250_000
LOADER_MAX_ULPS = 8
LOADER_CAT_ROWS, LOADER_CAT_FEATURES, LOADER_CAT_ROUNDS = 100_000, 28, 10
LOADER_CATEGORIES = 300


def write_repr_csv(path, y, X):
    """Label then features, every value as ``repr`` writes it."""
    with open(path, "w") as fh:
        for lab, row in zip(y.tolist(), X.tolist()):
            fh.write(",".join(map(repr, [lab, *row])) + "\n")


def max_ulps(a, b):
    """Units in the last place between two f64 arrays of like signs."""
    return int(np.abs(np.ascontiguousarray(a, np.float64).view(np.int64)
                      - np.ascontiguousarray(b, np.float64).view(np.int64)
                      ).max())


def phase_loader(seed, workdir):
    """The native host loader on the card's host (``io/native.py``).
    Builds the library (a timed compile of its own into the workdir, and
    the one ``parse_file`` loads); a 250k x 28 Higgs-like CSV written
    with ``repr``; ``parse_file`` natively and through Python (its native
    read patched away), labels equal and features within
    ``LOADER_MAX_ULPS``; ``value_to_bin`` native against
    ``searchsorted``; 10 rounds through ``lt.Dataset(path)`` on the card
    (K1) against ``lt.Dataset(X, y)`` on the parsed arrays, model texts
    byte-equal; the file predicted through K4 by ``Booster.predict`` and
    by ``LGBM_BoosterPredictForFile``; a 300-category CSV trained on the
    card and on the CPU.  Returns the launches of the counted runs."""
    import ctypes
    from pathlib import Path
    from unittest import mock
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.capi import impl as capi
    from lightgbm_tpu_torch.io import native
    from lightgbm_tpu_torch.io import parser
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = native.get_lib()
    first_use_s = time.perf_counter() - t0
    status = native.status()
    check(lib is not None and status in ("built", "loaded"),
          f"loader: the native library is unavailable: {status}")
    cxx = native.compiler()
    probe = Path(workdir) / "libdata_loader-timed.so"
    t0 = time.perf_counter()
    why = native._build(cxx, probe)
    build_s = time.perf_counter() - t0
    check(why is None, f"loader: the timed build failed: {why}")
    compiler_version = subprocess.run(
        [cxx, "--version"], capture_output=True, text=True
    ).stdout.splitlines()[0]

    # the Higgs-like file, natively and through Python
    X, y = make_higgs_like(LOADER_ROWS, seed=seed + 70)
    path = os.path.join(workdir, "higgs_like.csv")
    t0 = time.perf_counter()
    write_repr_csv(path, y, X)
    write_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    native.reset_counts()
    t0 = time.perf_counter()
    yn, Xn, _ = parser.parse_file(path)
    native_s = time.perf_counter() - t0
    check(native.counts()["parse"] == 1,
          f"loader: parse_file did not read natively: {native.counts()}")
    with mock.patch.object(native, "parse_file_native", return_value=None):
        t0 = time.perf_counter()
        yp, Xp, _ = parser.parse_file(path)
        python_s = time.perf_counter() - t0
    check(np.array_equal(yn, yp), "loader: labels differ between the "
                                  "native and the Python read")
    check(np.array_equal(Xp, X), "loader: the Python read is not the "
                                 "written values")
    ulps = np.abs(Xn.view(np.int64) - Xp.view(np.int64))
    worst = int(ulps.max())
    check(worst <= LOADER_MAX_ULPS, f"loader: a feature {worst} ulps from "
                                    f"its correctly rounded value")

    # value_to_bin, native against searchsorted, on a mapper of the file
    params = {**TRAIN_PARAMS, "verbose": -1}
    ds = lt.Dataset(path, params=params)
    mapper = ds.construct()._binned.mappers[0]
    col = Xn[:, 0]
    native.reset_counts()
    t0 = time.perf_counter()
    got = mapper.value_to_bin(col)
    bin_native_s = time.perf_counter() - t0
    check(native.counts()["bins"] == 1,
          "loader: value_to_bin did not bin natively")
    t0 = time.perf_counter()
    want = np.searchsorted(mapper.bin_upper_bound[:-1], col, side="left")
    want = np.where(np.isnan(col), 0, want)
    bin_search_s = time.perf_counter() - t0
    check(np.array_equal(got, want), "loader: native codes differ from "
                                     "searchsorted's")

    # 10 rounds through Dataset(path) on the card, and Dataset(X, y)
    _reset_launches()
    from_file = lt.train(params, ds, TRAIN_ROUNDS, device="cuda",
                         verbose_eval=False)
    torch.cuda.synchronize()
    k1_file = _launches()[0]
    check(k1_file > 0, "loader: Dataset(path) trained without K1")
    _reset_launches()
    from_arrays = lt.train(params, lt.Dataset(Xn, yn), TRAIN_ROUNDS,
                           device="cuda", verbose_eval=False)
    k1_arrays = _launches()[0]
    text = from_file.model_to_string()
    check(text == from_arrays.model_to_string(),
          "loader: Dataset(path)'s model differs from Dataset(X, y)'s: "
          + first_line_diff(text, from_arrays.model_to_string()))
    del from_arrays
    _reset_launches()
    t0 = time.perf_counter()
    pred = from_file.predict(path)
    predict_s = time.perf_counter() - t0
    k4_file = _launches()[1]
    check(sum(k4_file.values()) > 0, "loader: the file's predict ran no K4")
    check(np.array_equal(pred, from_file.predict(Xn)),
          "loader: the file's predictions differ from the arrays'")
    model_path = os.path.join(workdir, "loader_model.txt")
    from_file.save_model(model_path)
    out_path = os.path.join(workdir, "loader_pred.txt")
    booster = [0]
    native.reset_counts()
    check(capi.LGBM_BoosterCreateFromModelfile(
        ctypes.c_char_p(model_path.encode()), [0], booster) == 0,
        "loader: LGBM_BoosterCreateFromModelfile failed")
    _reset_launches()
    try:
        check(capi.LGBM_BoosterPredictForFile(
            booster[0], ctypes.c_char_p(path.encode()), 0, 0, -1,
            ctypes.c_char_p(out_path.encode())) == 0,
            "loader: LGBM_BoosterPredictForFile failed")
    finally:
        capi.LGBM_BoosterFree(booster[0])
    k4_capi = _launches()[1]
    check(native.counts()["parse"] == 1, "loader: the C API's file "
                                         "predict did not read natively")
    check(sum(k4_capi.values()) > 0, "loader: the C API's file predict "
                                     "ran no K4")
    capi_pred = np.loadtxt(out_path)
    check(np.allclose(capi_pred, pred, rtol=1e-5, atol=1e-6),
          "loader: LGBM_BoosterPredictForFile differs from "
          "Booster.predict beyond the file's %g digits")
    del from_file, ds, X, Xn, Xp, yp

    # 300 equally frequent categories at max_bin 255: a 294-bin mapper
    rng = np.random.RandomState(seed + 71)
    Xc = rng.normal(size=(LOADER_CAT_ROWS, LOADER_CAT_FEATURES))
    cats = np.arange(LOADER_CAT_ROWS) % LOADER_CATEGORIES
    rng.shuffle(cats)
    Xc[:, 0] = cats
    yc = ((np.sin(cats / 17.0) + 0.5 * Xc[:, 1]
           + rng.normal(scale=0.5, size=LOADER_CAT_ROWS)) > 0).astype(
               np.float64)
    cat_path = os.path.join(workdir, "categories300.csv")
    write_repr_csv(cat_path, yc, Xc)
    texts, widths = {}, {}
    for where in ("cuda", "cpu"):
        native.reset_counts()
        _reset_launches()
        cset = lt.Dataset(cat_path, params=params)
        b = lt.train(params, cset, LOADER_CAT_ROUNDS,
                     categorical_feature=[0], device=where,
                     verbose_eval=False)
        check(native.counts()["parse"] == 1,
              f"loader: the 300-category file was not read natively "
              f"({where})")
        widths[where] = [m.num_bin for m in cset._binned.mappers]
        if where == "cuda":
            k1_cat = _launches()[0]
        texts[where] = b.model_to_string()
        del b, cset
    check(widths["cuda"][0] == 294 and widths["cuda"] == widths["cpu"],
          f"loader: the 300-category mappers are {widths['cuda'][:3]}...")
    check(k1_cat > 0, "loader: the 300-category run ran no K1")
    trees, flip, leaf_rel = compare_model_texts(
        texts["cuda"], texts["cpu"], "loader 300 categories")
    check(flip is None, f"loader: the 300-category trees flipped: {flip}")
    emit({"phase": "loader", "status": status, "compiler": cxx,
          "compiler_version": compiler_version, "library": native.get_lib()
          ._name, "first_use_s": first_use_s, "build_s": build_s,
          "file": {"rows": LOADER_ROWS, "features": HIGGS["num_features"],
                   "mb": mb, "write_s": write_s,
                   "cut": "rows 1M -> 250k (time)"},
          "parse": {"native_s": native_s, "python_s": python_s,
                    "native_mb_s": mb / native_s,
                    "python_mb_s": mb / python_s,
                    "python_over_native": python_s / native_s,
                    "labels_equal": True, "max_ulps": worst,
                    "share_differing": float((ulps > 0).mean()),
                    "mean_ulps": float(ulps.mean())},
          "value_to_bin": {"values": len(col), "native_s": bin_native_s,
                           "searchsorted_s": bin_search_s,
                           "codes_equal": True},
          "train": {"rounds": TRAIN_ROUNDS, "k1_launches": k1_file,
                    "k1_launches_arrays": k1_arrays,
                    "model_text_equal_to_arrays": True},
          "predict": {"rows": LOADER_ROWS, "s": predict_s,
                      "k4_launches": k4_file,
                      "equal_to_arrays": True,
                      "capi_k4_launches": k4_capi},
          "categories300": {"rows": LOADER_CAT_ROWS,
                            "mapper_bins": widths["cuda"][0],
                            "max_bin": TRAIN_PARAMS["max_bin"],
                            "trees": trees, "k1_launches": k1_cat,
                            "leaf_rel_max": leaf_rel},
          "seconds": time.perf_counter() - t_phase})
    k4 = {name: k4_file.get(name, 0) + k4_capi.get(name, 0)
          for name in {*k4_file, *k4_capi}}
    return {"digit_histogram": k1_file + k1_arrays + k1_cat, **k4}


# the side process (``--side JOB``): the phases that need none of the main
# sequence's datasets and models, run in order in a process of their own
# beside ``distributed``, ``resilience``, ``objectives``, ``sampling`` and
# ``engine`` (started after ``memory``, whose real OOM must have the card
# to itself, and joined before ``telemetry``, whose round times compare
# two modes); its torch threads, and how long the main process waits
SIDE_PHASES = ("examples", "estimators", "boundary", "sparse", "capi",
               "loader")
SIDE_THREADS = 4
SIDE_TIMEOUT_S = 900


def side_main(job_path) -> int:
    """The side process: SIDE_PHASES in order in the job's workdir, each
    phase's lines on stdout (the main process prints them when it joins),
    then one line with their launches, the largest kernel errors and
    each phase's wall seconds."""
    with open(job_path) as fh:
        job = json.load(fh)
    torch.set_num_threads(SIDE_THREADS)
    seed, workdir, reps = job["seed"], job["workdir"], job["reps"]
    errs = {name: 0.0 for name in SOURCE}
    launches = {}
    clock = PhaseClock("side:")
    runs = {"examples": lambda: phase_examples(workdir),
            "estimators": lambda: phase_estimators(seed, workdir, errs),
            "boundary": lambda: phase_boundary(seed, workdir),
            "sparse": lambda: phase_sparse(seed, workdir, reps),
            "capi": lambda: phase_capi(seed, workdir),
            "loader": lambda: phase_loader(seed, workdir)}
    for name in SIDE_PHASES:
        for kernel, n in runs[name]().items():
            launches[kernel] = launches.get(kernel, 0) + n
        clock.lap(name)
    emit({"side": {"launches": launches, "errs": errs,
                   "walls": clock.walls}})
    return 0


class SideProcess:
    """``chip_smoke.py --side`` started in a session of its own, its
    stdout into a file of the workdir; ``join`` waits for it and returns
    its last line's result, ``kill`` ends it wherever it is."""

    def __init__(self, seed, reps, workdir):
        side_dir = os.path.join(workdir, "side")
        os.makedirs(side_dir)
        job = os.path.join(side_dir, "job.json")
        with open(job, "w") as fh:
            json.dump({"seed": seed, "workdir": side_dir, "reps": reps}, fh)
        self.out_path = os.path.join(workdir, "side_stdout.jsonl")
        self.out = open(self.out_path, "w")
        env = {k: v for k, v in os.environ.items()
               if k != "LGBT_DEVICE_MEMORY_BYTES"}
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side", job],
            cwd=REPO, stdout=self.out, env=env, start_new_session=True)

    def join(self) -> dict:
        try:
            rc = self.proc.wait(timeout=SIDE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.kill()
            check(False, f"side: still running after {SIDE_TIMEOUT_S} s")
        self.out.close()
        with open(self.out_path) as fh:
            lines = fh.read().splitlines()
        for ln in lines[:-1]:
            print(ln, flush=True)
        check(rc == 0 and lines and lines[-1].startswith('{"side"'),
              f"side: the side process exited {rc}")
        return json.loads(lines[-1])["side"]

    def kill(self):
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()
        self.out.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timing-reps", type=int, default=20)
    ap.add_argument("--dist-rank", default=None,
                    help="run one rank of the distributed phase (its job "
                         "file); the phase starts these itself")
    ap.add_argument("--resilience-rank", default=None,
                    help="run one rank of the resilience phase (its job "
                         "file); the phase starts these itself")
    ap.add_argument("--side", default=None,
                    help="run the side process's phases (its job file); "
                         "the script starts it itself")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.dist_rank:
        return dist_rank(args.dist_rank)
    if args.resilience_rank:
        return resilience_rank(args.resilience_rank)
    if args.side:
        return side_main(args.side)
    from lightgbm_tpu_torch.ops import children_hist as ch
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.ops import leafhist as lh
    from lightgbm_tpu_torch.ops import roll_chain as rc
    from lightgbm_tpu_torch.ops import window_hist as wh
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    clock = PhaseClock()
    smi = phase_build()
    clock.lap("build")
    higgs_model, higgs_grid = random_model(args.seed, **HIGGS)
    lin_model, lin_grid, linear_set = linear_forests(args.seed, higgs_model,
                                                     higgs_grid)
    errs = {name: 0.0 for name in SOURCE}
    clock.lap("forests")
    phase_kernels(args.seed, dev, higgs_model, higgs_grid, linear_set, errs)
    clock.lap("kernels")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        served = phase_serve(args.seed, dev, higgs_model, higgs_grid,
                             workdir, errs)
        launches = dict(served)
        clock.lap("serve")
        launches.update(phase_serve_linear(args.seed, dev, lin_model,
                                           lin_grid, higgs_model, workdir,
                                           errs))
        clock.lap("serve_linear")
        for name, n in phase_fleet(args.seed, dev, higgs_model, higgs_grid,
                                   workdir).items():
            launches[name] += n
        clock.lap("fleet")
        trained, windows, datasets, ordered_round_s = phase_train(
            args.seed, dev, workdir)
        launches.update(trained)
        for name, n in train_model_layer(dev, datasets, workdir).items():
            launches[name] += n
        clock.lap("train")
        for name, n in fleet_train_delta(args.seed, workdir).items():
            launches[name] += n
        clock.lap("train_delta")
        phase_memory(datasets, dev)
        clock.lap("memory")
        side = SideProcess(args.seed, args.timing_reps, workdir)
        try:
            for name, n in phase_distributed(args.seed, datasets, dev,
                                             workdir).items():
                launches[name] += n
            clock.lap("distributed")
            for name, n in phase_resilience(args.seed, datasets,
                                            workdir).items():
                launches[name] += n
            clock.lap("resilience")
            objectives, multiclass = phase_objectives(args.seed, workdir)
            clock.lap("objectives")
            # sampling before the engine phase, whose continued runs give
            # the training set init scores
            sampled = phase_sampling(args.seed, datasets, multiclass,
                                     workdir, ordered_round_s,
                                     args.timing_reps)
            del multiclass
            clock.lap("sampling")
            for name, n in [*objectives.items(), *sampled.items(),
                            *phase_engine(args.seed, datasets,
                                          workdir).items()]:
                launches[name] += n
            clock.lap("engine")
            done = side.join()
        finally:
            side.kill()
        for name, n in done["launches"].items():
            launches[name] += n
        for name, e in done["errs"].items():
            errs[name] = max(errs[name], e)
        clock.lap("side_join")
        for name, n in phase_telemetry(args.seed, datasets, higgs_model,
                                       higgs_grid, workdir).items():
            launches[name] += n
        clock.lap("telemetry")
        for name, n in phase_attribution(args.seed, datasets, higgs_model,
                                         higgs_grid, workdir).items():
            launches[name] = launches.get(name, 0) + n
        clock.lap("attribution")
        del datasets
    launches.update(phase_probes(args.timing_reps))
    clock.lap("probes")
    timing = phase_timing(args.seed, dev, higgs_model, higgs_grid,
                          lin_model, lin_grid, args.timing_reps)
    clock.lap("timing")
    emit({"phase": "k1_windows",
          **k1_window_timing(args.seed, dev, args.timing_reps)})
    clock.lap("k1_windows")
    emit({"phase": "k3_occupancy",
          **k3_occupancy_timing(args.seed, dev, args.timing_reps)})
    clock.lap("k3_occupancy")
    # the walks at B=4096, the histograms at the training root (S = 1M),
    # the probes at the probe's shapes
    at = {r["kernel"]: r for r in timing
          if r.get("B") == 4096 or r.get("S") == TRAIN_ROWS
          or r.get("kernels_line")}
    check(set(fw.LAUNCHES) | set(lh.LAUNCHES) | set(ch.LAUNCHES)
          | set(rc.LAUNCHES) | set(wh.LAUNCHES) == set(REPLACES),
          "a kernel is missing a row")
    phase_rule2(args.seed, dev, args.timing_reps, at, windows, launches)
    clock.lap("rule2")
    emit({"phase": "walls", "seconds": clock.walls,
          "side": done["walls"]})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": at[name]["ms"],
         "plain_ms": at[name]["plain_ms"], "bound_ms": at[name]["bound_ms"],
         "bound_by": at[name]["bound_by"],
         "library_ms": at[name].get("library_ms")}
        for name in SOURCE]})
    print(f"seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
