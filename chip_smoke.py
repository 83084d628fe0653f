#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (orange3_spark_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py [--rows 11000000]

It builds the CUDA kernels from ``orange3_spark_tpu_torch/ops/csrc`` (nvcc,
``sm_90a``, into the git-ignored ``orange3_spark_tpu_torch/_build/``), then
prints one JSON line per phase:

  env      torch / CUDA versions, the card's name and power limit
  build    nvcc wall seconds, ptxas' register / shared-memory report and
           the atomic opcodes of the kernels' SASS (cuobjdump)
  check    each kernel against its plain PyTorch version on the card: a
           randomized sweep, zero-weight rows, a 20-tree batch, regression
           stats [wy, wy², w] with y in [1e4, 1e5], and the shapes the
           HIGGS fits give it at every level 0-4, with uint8 and int32
           bins, with and without per-tree feature masks (bitwise for
           integer stats; for float stats each stat within 1e-5 of its own
           max|H| of the plain version summed in float64)
  timing   kernel time at every level of both fits (uint8 and int32 bins;
           the forest also with its masks), beside the memory-bound least
           time and the adds per second; plain version and one library
           call at level 4; an estimate of the histogram time of one fit
           (launch-weighted level times)
  parity   the fits on the card against the port's CPU path on a small
           table (same random draws for the forest); then the seeded fits
           with no injected draws (JAX's stream, ``ops/prng``): a 4-tree
           forest field by field, GBT with subsampling 0.8 (same-split
           fraction, AUC within 0.005), and the Poisson counts of the
           card against the CPU's (a share of the lanes, at most 1e-6)
  gbt, rf  the HIGGS proxy (BASELINE config 3) at full width:
           GBTClassifier(max_iter=20) and RandomForestClassifier(
           num_trees=20), max_depth=5, max_bins=32, 28 features, 11M rows
           with a 262,144-row holdout: a warm-up fit and a timed fit,
           holdout AUC, histogram launches of the timed fit
  profile  one more fit of each under torch.profiler: device time by
           kernel, the device's idle share of the fit, and the histogram's
           device time in the fit: its kernel and finalize pass, and the
           PyTorch ops under the wrapper's ``node_histograms`` profiler range
  rf_draws the forest's draws at its fit's shapes (``draw_forest``: one
           ``poisson_knuth`` launch, a Bernoulli mask a tree), eager, beside
           the timed fit's wall, its wall before the draws moved and its
           wall on the one-lane-a-thread ``poisson_knuth``
  prng     ``threefry_bits`` (at a 10M draw and a tree's row count) and
           ``poisson_knuth`` (the forest's 20 trees x 10,737,856 rows at
           lam 1, and GBT's subsampled round: one key at lam 0.8)
           bitwise their plain versions, timed captured and eager beside
           the plain versions and each bound (4 B written a lane; 73
           integer operations a hash at SMs x 128 issue lanes x the max
           SM clock; for ``poisson_knuth`` also the instructions its
           function needs, counted in the SASS of
           ``probes/knuth_work.cu``), the share of its issued lane-slots
           that did an iteration, and the one-lane-a-thread kernel's time

then the dense linear family (BASELINE config 1 and ``bench.py --config
dense_logreg``; PyTorch ops, no kernel of the package: the products are
``torch.mm``, as the reference's are XLA's dot):

  linear_check    the card against the port's CPU path at a small size
                  (Iris; ``make_classification`` 4096 x 16, 2 and 3
                  classes): ``fit_linear`` for logistic, hinge,
                  squared_hinge, squared and OWLQN, with and without the
                  column scale, after 1, 2 and 3 iterations (1e-4) and
                  converged (1e-3, the same predictions, the same zero
                  set); LinearRegression 'normal' with p-values; the three
                  evaluators; a Pipeline of one LogisticRegression; the
                  fitted model served through a 64..2048 ladder (direct and
                  micro-batched), predict and transform bitwise equal to
                  raw; TF32 off
  iris            BASELINE config 1: LogisticRegression(max_iter=200,
                  reg_param=1e-4), a warm-up fit and a timed fit: accuracy
                  (floor 0.96), iterations, objective evaluations, host
                  reads
  dense_logreg    bench_dense_logreg at full width (4,000,000 x 40,
                  ``default_rng(0)``, 20 iterations, tol 0, reg 1e-6), its
                  bf16 arm and an f32 arm: ``value`` (bench's
                  logreg_fit_rows_per_sec_per_chip), evaluations and host
                  reads per iteration, the device's busy and idle share of
                  a profiled fit, one objective evaluation's device time
                  beside its byte bound (X read twice), training accuracy

then the taxi feature pipeline (BASELINE config 5: OWTable ->
OWStandardScaler(with_mean) -> OWPCA(k=4) -> OWKMeans(k=10, max_iter=10) as
a widget graph; PyTorch ops, no kernel of the package: the products are
``torch.mm`` or per-row sums, as the reference's are XLA's dot):

  taxi_check      200,000 x 8 rows of ``datasets.make_taxi_proxy`` on the
                  card against the port's CPU path: scaler shift and scale
                  within 1e-6 relative; each principal component, sign-
                  aligned, within 1e-5 or, where its eigenvalue lies close to
                  another, within the Davis–Kahan bound of the two
                  covariances' difference; KMeans on the same input seeded
                  bitwise, centers within 1e-4, cluster ids equal on 99.99 %;
                  Lloyd's fixed-trip form bitwise the eager loop; two fits
                  of the graph bitwise; the staged transform bitwise the
                  eager walk; two replays of the staged refit bitwise and its
                  KMeans the eager run of the same device init;
                  StreamingKMeans' cached (captured) replay bitwise the
                  re-streamed fit; served fused = stage by stage = raw,
                  bitwise, at a request size in every rung of a 64..512
                  ladder (1 and 3 dispatches)
  taxi_pipeline   ``bench_suite.py:193-238`` at 10,000,000 x 8
                  (``default_rng(2)``, ``--taxi-rows``) with bench's keys: the
                  eager fit walk after a warm-up (``workflow_fit_s``), the
                  staged transform and refit (captured graphs;
                  ``graph_segments``, ``refit_fallbacks``), the eager
                  transform, bench.py's streaming arm (2^16-row chunks,
                  ``StreamingKMeans(k=10, epochs=2)``) and its serving A/B
                  (24 requests of 256 rows, ``default_rng(11)``, interleaved:
                  p50s, dispatches, parity, gated); launches, busy time and
                  idle share of one profiled eager walk and staged call

then the ALS recommender (BASELINE config 4; one kernel of the package,
``ops/csrc/normal_equations.cu``: ``normal_equations_sorted``, every
entity's A, b and rating count of one half-step in one launch):

  als_check       the kernel on the card against its plain version run on
                  the CPU from the same inputs (``NE_CASES``: ranks 1, 8,
                  16, 48, 64 and 128, a 100,000-rating segment whole and
                  cut into ~100 pieces at its chunk changes, explicit and
                  implicit, entity counts that are no multiple of a warp's,
                  empty entities, a tenth of the weights zero, several
                  reference chunks): the layout equal, A, b and cnt
                  bitwise, two launches bitwise; ``ALS(rank=16, max_iter=5)`` on 200,000
                  ratings fitted on the card and on the CPU from the same
                  initial factors (within ``ALS_FIT_ATOL``), two card fits
                  bitwise; top-10 from the same factors on both, one user's
                  and one item's factors zeroed (ties): ids equal on every
                  row, the zero user's 0..9; every ranking and multilabel
                  metric of the same id matrices on both within 1e-6
  movielens_als   ``bench_suite.py:134-184`` at full width: 25,000,000
                  ratings of ``make_movielens_proxy`` (162,541 users x
                  59,047 items), the last 262,144 held out, ``ALS(rank=16,
                  max_iter=10, reg_param=0.05, seed=2)`` with explicit dims:
                  a warm-up fit, the timed fit (``fit_s``,
                  ``ratings_per_sec_per_chip``; the kernel's launches, which
                  must be 20), ``train_rmse`` and ``holdout_rmse`` (ceiling
                  0.40), a profiled fit (device ms by stage: the kernel, the
                  sort, the LU solve, the rest; the idle share),
                  ``recommend_for_all_users(10)`` and ndcg@10 against each
                  user's held-out items; then the kernel at the timed fit's
                  inputs, each side, and at an item side drawn 1/rank^0.9
                  from ``--seed`` (its longest segment, the segments cut,
                  their pieces): held to the plain version on the card
                  within float32 summation's bound (``_ne_tolerance``), two
                  launches bitwise, its time beside its bounds (bytes of
                  the 12-byte layout; operations at the float32 peak and,
                  ``issue_bound_ms``, at half of it: products and adds that
                  may not contract), the plain version and the yardstick
                  (materialised outer products + ``index_add_``)

then the Criteo path (BASELINE config 2, ``bench.py --config criteo`` on an
accelerator): PyTorch ops and two kernels of the package
(``ops/csrc/segment_sum.cu``): ``segment_update_sorted``, the whole
touched-row update of the 'sort' lowering after its sort (sums, lazy decay,
rule, write-back of the live rows) in one launch a step, and
``segment_sum_sorted``, the deterministic segment sum of the dense table
gradient (the adam rule) and the 'plan' lowering:

  criteo_check    on the card against the port's CPU path: the hash
                  bitwise at 1..2^22 dims; bit packing at widths 1..31 and
                  a packed Criteo chunk (22 bits × 26 columns, its plan)
                  decoded on the card against the hash of its f32 codes;
                  theta after small packed, deferred sparse_adagrad fits
                  (2^16 dims, 4 chunks of 4096 rows, 3 epochs): the captured
                  graph replay against the eager per-chunk replay on the
                  card and against 'plan' and 'sort' on the CPU; a fit whose
                  cache budget is below its data, replayed from the disk
                  spill in captured groups, against the cache replay; adam
                  (the update, and two fit steps); the eval accumulators of
                  one theta on both
  criteo_data     ``gen_criteo_csv`` at bench.py's 8,000,000 rows into a
                  temporary directory outside the checkout
  criteo          bench.py's warm-up (one chunk parsed, ``warm_replay``,
                  the eval path), then the timed fit at full width (2^22
                  dims, 13 + 26 columns, 2^18-row chunks, sparse_adagrad
                  with the in-step 'sort', the packed cache, epoch 1
                  deferred, 100 epochs as one captured CUDA graph replayed
                  100 times, 2 holdout chunks) and ``evaluate_device`` on
                  the packed holdout: value (rows / (fit + eval) / 1 card,
                  as bench.py), bench.py's keys, pure_step_ms (eager steps,
                  CUDA events) and its A/B arms pure_step_ms_dense (adam)
                  and pure_step_ms_f32cache (the head re-cached at f32),
                  holdout AUC (floor 0.73); the update kernel's launches
                  over the timed fit, the segment sum's over the adam arm;
                  the timed fit's goodput (obs/prof.py: five fractions
                  summing to 1 within 0.02, each epoch window's
                  bottleneck, the replay's not framework-bound) and its
                  device-memory ledger (a ``model_state`` entry the
                  table's bytes, ``cache_chunks`` = ``cache_bytes``, the
                  peak at least table + slots + cache, the CUDA allocator
                  at least the ledger)
  criteo_profile  eager steps under torch.profiler: device time by kernel,
                  ATen op and stage, the idle share, launches and
                  ``nonzero`` calls per step; then the captured replay:
                  device busy time, idle share and launches per epoch
  segment_sum     the kernel at the inputs the dense table gradient of
                  one adam step gives it (the fit's first cached chunk,
                  i32 segment ids): five launches bitwise equal, against its
                  plain version on the card (max |err|: float atomics) and
                  on a CPU copy (bitwise on every segment of at most
                  ``walk_max()`` rows), captured against eager, one 2^20-row
                  segment within 1e-6·Σ|g|; its time (captured, eager and
                  the host's time to issue a call) beside the bound, the
                  plain version, ``index_add_`` and ``index_add_`` under
                  deterministic mode (and whether a graph captures it)
  segment_update  the fused update at one sparse_adagrad step's own inputs
                  (the first cached chunk, fresh optimizer state, the fitted
                  theta; recorded by wrapping the function the step calls):
                  five launches from copies of the same state bitwise
                  equal; bitwise equal on every row of emb, acc and t to the
                  chain it replaced (the plain version with the segment-sum
                  kernel's sums); bitwise equal to the plain version with
                  the CPU's index-order sums on t and on every row of a
                  segment of at most ``walk_max()`` occurrences; the sums
                  alone (sgd, lr 1, a zero table) bitwise there and within
                  1e-6·Σ|g| on longer segments, a check shown to fail the
                  plain version with one occurrence dropped or doubled;
                  untouched rows unchanged; captured equal to eager; the
                  same checks for sgd and ftrl at the same inputs and for
                  one 2^20-row segment, and with per-pair values (drawn from
                  a seed, a seventh zero) at the step and on the long
                  segment; the kernel's, the chain's and the
                  plain version's times (captured, eager and the host's
                  time to issue a call), bytes, the bound and the ratio to
                  it (and the 32-byte-sector bytes)
  criteo_resume   the full-width fit with ``replay_granularity='epoch'``,
                  snapshots every 2 epochs, ``--resume-epochs`` (10): a
                  clean fit, a fit whose checkpointer crashes after its
                  3rd snapshot, a fresh estimator resuming from it; theta,
                  the optimizer state at the end, the steps and the holdout
                  AUC must be bitwise the clean fit's; ``snapshot_s`` per
                  save, the resume's fit_s, the replay epochs it skipped
  criteo_fault    the same fit clean and under bench.py's fault spec
                  (transient reads, stragglers; 0.02 s backoff): bitwise
                  parity, retries, ``recovery_overhead_pct``; then a wedged
                  dispatch under a 0.25 s watchdog budget must raise
                  ``DispatchWedgedError`` within 2 s

then the serving path (``bench.py --config serving``; PyTorch ops in captured
CUDA graphs, no kernel of the package), on the Criteo CSV:

  serving_check   a 2^16-dim model fit on the CSV's head, served through a
                  64..2048 ladder, bitwise against its eager raw logits at
                  one request size in every rung (again after allocator churn:
                  a repeat captures nothing and gives the same bits); 32
                  requests from 8 threads; 48 micro-batched requests from
                  16 threads (coalesced, scattered right); a hot reload
                  (one fresh graph) and an in-place theta update (none);
                  RF and GBT through the ``predict-pad`` route, bitwise
  serving         bench.py's configuration: a 2^18-dim model fit for one
                  epoch on 4 chunks of 2^18 rows, a 2^19-row request pool,
                  120 requests log-uniform on [16, 8192] run raw, bucketed
                  (ladder 256..16384 warmed rung by rung: seconds and device
                  bytes per rung) and coalesced (16 threads); then the
                  ``criteo`` phase's full-width model through the same
                  ladder; bench.py's keys, graph captures (7, then 0 on a
                  repeat), every bucketed request a graph replay, no
                  breaker, served bitwise equal to raw over the whole trace;
                  the coalesced arm's dispatch time against its wall
  serving_profile one bucketed request at 256 and 8192 rows: the served
                  call, the host copy in (host clock and CUDA events), the
                  pad zeroing, the graph's device time, the copy back, the
                  Python around them; the launches in the graph

then the dense streaming fit (``StreamingLinearEstimator``: PyTorch ops
and captured CUDA graphs, no kernel of the package) and the value-weighted
hashed fit (``segment_update_sorted`` given the pairs' values):

  fault           ``bench.py --config fault`` (bench.py:1316-1419) at bench's
                  sizes: 262,144 x 16 rows of ``default_rng(0)``, logistic,
                  4 epochs, step 0.05, 2^14-row chunks, the device cache; a
                  warm, a clean and a faulted fit (bench's spec, 0.02 s
                  backoff): the coef bitwise the clean fit's, faults injected
                  and retried; ``wedge:at=1,hold_s=30`` under a 0.25 s budget
                  raises ``DispatchWedgedError`` within 2 s;
                  ``recovery_overhead_pct``, the walls, rows/s
  streaming_linear  bench.py's dense_logreg table (4,000,000 x 40) through
                  ``array_chunk_source`` in 2^18-row chunks, logistic, 10
                  epochs: the default schedule, ``defer_epoch1``, 'epoch'
                  granularity with 3 epochs a call, ``cache_dtype='bf16'``
                  (and deferred): bitwise the default of their dtype;
                  ``evaluate_binary_stream`` on the last 2^18 rows within
                  2/n_bins of the in-memory evaluator; at 2^14 rows the card
                  against the CPU (1e-4 x max|theta|) and the captured replay
                  bitwise the eager one; ``fit_s``, the replay's ms an
                  epoch, a profiled fit's busy and idle share and events
  libsvm_hashed   a 524,288-row libsvm file of 26 pairs a row written by
                  numpy (Zipf-drawn indices below 2^24, values in (0, 2])
                  into a temporary directory outside the checkout, read by
                  ``libsvm_chunk_source(nnz_per_row=26)``, a value-weighted
                  fit at 2^22 dims (sparse_adagrad, 'sort', the captured
                  replay, 10 epochs, one 2^17-row holdout chunk): the parse,
                  fit and evaluation walls, holdout AUC (floor 0.55), the
                  kernel's launches over the fit; the kernel at one step
                  of this fit (its first chunk, the pairs' own values and
                  dead pads) bitwise the chain and the plain version,
                  timed there; at 2^14 rows the card
                  against the CPU for every emb_update x {adam,
                  dense_adagrad, sparse_adagrad} and bf16 compute;
                  ``missing='keep'`` with a NaN dense cell raises

then bench.py's overload config (admission control, breakers, the brownout
ladder, the flight recorder and the telemetry endpoint; the CTR model's
adam fit through ``segment_sum_sorted``):

  overload        ``bench.py --config overload`` at bench's sizes: a 2^14-dim
                  CTR model fit on 16,384 rows, 64 open-loop requests
                  (64-256 rows, 2 ms apart) under a 25 ms injected service
                  delay, raw (``OTPU_RESILIENCE=0``) and admitted (0.1 s
                  deadline) with the endpoint bound (``OTPU_OBS_PORT=0``):
                  bench's fields (p50/p99 of both arms, sheds all typed,
                  no hung or lost future, goodput rows/s), the first
                  shed's ``overload_shed`` bundle, /readyz 503 then 200
                  across the warm-up, /healthz, /metrics, /debug/flight,
                  a ~200 ms ``POST /debug/profile`` over served requests
                  whose trace holds CUDA kernels; the breaker re-admitted
                  half-open; the brownout drill at rung 3 (coefficients
                  bitwise the unpressured fit's, the cache's ledger entry
                  0, ``memory_allocated`` falling by the dropped bytes)

then bench.py's fleet, tenancy and online configs at bench's sizes, every
replica serving on the card (bench pins its replicas to the CPU):

  fleet           a 2^12-dim CTR model published; replica processes
                  (``python -m orange3_spark_tpu_torch.fleet.replica
                  --device cuda``) under ``OTPU_ADMISSION_MAX_INFLIGHT=1``
                  and ``overload:delay_ms=30``: 64 requests on 1 replica
                  against 4 (scaling >= 2.5x), the collector's A/B and the
                  SLO burn drill (one fleet bundle), a SIGKILL mid-burst
                  (nothing lost or hung, the replica restarted and
                  re-admitted), a rolling swap under traffic (0 failed)
                  and a poisoned version rolled back, a 400 ms straggler
                  (hedged p99 <= 0.5x unhedged), the wire's fresh,
                  keep-alive and fast-path arms (>= 3x), trace coverage 1,
                  ``OTPU_FLEET=0`` bitwise; each replica's start (spawn to
                  ready) and device
  tenancy         the fairness A/B on the card (light p99 >= 3x tighter
                  under weighted-fair tenancy, the burster shed typed),
                  the autoscaler growing a fleet on the card to >= 2
                  replicas and draining it back with 0 failed requests,
                  both kill switches bitwise
  online          an in-process two-replica fleet on the card and bench's
                  five claims: learn and promote (AUC over the frozen
                  model's), drift rejected typed (CURRENT untouched), an
                  SLO burn rolled back, a trainer crash resumed bitwise,
                  the unguarded loop shipping the bad model and
                  ``OTPU_ONLINE=0`` bitwise; then the trainer on the card
                  against the CPU (``_theta_err``) for bench's adam model
                  and a sparse_adagrad one (``segment_update_sorted`` a
                  step); both segment kernels' launches over the phase

then data wrangling and the canvas (``ops/relational``, ``ops/window``,
the readers, ``workflow/ows``; the grouped passes through
``segment_sum_sorted``):

  wrangle         10,000,000 TLC-shaped yellow-taxi trips
                  (``datasets.make_tlc_trips``, 400 MB on the card) and the
                  265-zone lookup: ``join``, ``group_by`` by pickup zone and
                  by (Borough, payment_type), ``pivot``, ``cube``,
                  ``rollup``, ``crosstab``, ``value_counts``,
                  ``freq_items``, ``sort``, a ``Window`` (row number, lag,
                  lead, the running fare), ``sample``, ``sample_by``,
                  ``random_split``, ``train_test_split``, ``with_column``,
                  ``drop``; on the first 2,000,000 rows (host-bound)
                  ``join_expand`` (fan-out 2), ``join_host``, ``union``,
                  ``distinct`` and ``write_csv`` -> ``read_csv_native``
                  (bitwise the written numbers); each call's wall on the
                  card after a warm-up pass, held against the same call on
                  the CPU (sums and means within 2^-12, running sums within
                  64·2^-24 of the global prefix, the rest bitwise); then
                  the segment-sum kernel at ``group_by``'s own inputs
  ows             an Orange canvas scheme (``canvas_ows``: SQL Table ->
                  Select Rows -> Aggregate Columns -> Merge Data with the
                  zone lookup a borough -> Save Data; Pivot Table -> Save
                  Data) over a SQLite database of 1,000,000 trips, loaded by
                  ``workflow/ows.read_ows`` and run on the card, then on the
                  CPU: every node's output held card against CPU

then MLlib's supervised estimators (PyTorch ops; their seeded draws
through ``threefry_bits``):

  supervised      at full width, each fit timed after a warm-up (its cut
                  fit on the card) with its held-out metric: on the HIGGS
                  proxy (10,737,856 rows, 262,144 held out) NaiveBayes
                  (gaussian), GLM binomial, the MLP (28, 64, 64, 2) and
                  FMClassifier (factor 8), AUC; on the dense_logreg X
                  (4,000,000 x 40) GLM poisson, gamma and tweedie
                  (vp 1.5) on seeded log-linear targets (mean deviance) and
                  AFT on seeded Weibull times, 30 % right-censored (mean
                  negative log-likelihood); OneVsRest(LogisticRegression)
                  on make_classification at UCI Covertype's shape (581,012
                  x 54, 7 classes; accuracy); RFormula over the 10M TLC
                  trips then a gaussian GLM (RMSE); CrossValidator of
                  LogisticRegression over 2 reg_params x 3 folds on the
                  first 1M HIGGS rows (7 fits; AUC); IsotonicRegression on
                  1M rows (cut: the PAV is a host loop; RMSE). Each is also
                  fitted on the CPU path on a 200,000-row cut: the card's
                  cut fit within the CPU tests' tolerance of it (the MLP
                  after 5 iterations and FM after 60 steps, where their
                  paths still follow float32 order noise), the full fit's
                  held-out metric no worse than the cut's by 0.005, a served
                  request bitwise raw, CV's fold ids bitwise the CPU's

then MLlib's unsupervised, text, pattern and statistics modules (PyTorch
ops; the grouped passes, Spearman's ranks, PIC's edge sums and Word2Vec's
table gradients through ``segment_sum_sorted``; Word2Vec's negatives
through ``categorical_gumbel``):

  unsupervised    the card's float32 sqrt against the float64 root
                  rounded (the premise of ``core/fmath.sqrt32``);
                  GaussianMixture(k=10) and BisectingKMeans(k=10) on
                  config 5's 10M x 8 taxi table after StandardScaler, both
                  LSH families' approx_nearest_neighbors there; on the
                  HIGGS proxy (11M x 28) Correlation (pearson, spearman),
                  Summarizer, ANOVATest, FValueTest, MultivariateGaussian's
                  logpdf, RobustScaler, VarianceThresholdSelector and
                  UnivariateFeatureSelector; ChiSquareTest and
                  ChiSqSelector of the 10M TLC trips' categorical columns
                  against payment_type; PowerIterationClustering(k=2,
                  max_iter=20, degree start) on a planted-partition graph
                  of com-LiveJournal's size (3,997,962 nodes, 34,681,189
                  edges, the denser community sourcing 60 % of them), held
                  to the planted partition; on a Zipf corpus of 20 Newsgroups' 18,846
                  documents Tokenizer, StopWordsRemover, NGram(2),
                  HashingTF(2^18), CountVectorizer(10000), IDF, LDA(k=20,
                  max_iter=20) and Word2Vec(100, min_count=5, window 5,
                  negative 5; max_pairs cut to 2^16); FPGrowth(
                  min_support=0.01) on T10I4D100K-shaped transactions and
                  PrefixSpan (MLlib's defaults) on 10,000 of them. Each
                  fit or call is timed
                  (after a warm-up where its shapes ran first) and held to
                  the CPU path on a cut (20,000 rows; 500 documents for
                  LDA, 300 for Word2Vec; 10,000 transactions); then
                  ``categorical_gumbel`` bitwise its plain version on the
                  first and the last 4,096 pairs' draws, its bound table
                  equal to the CPU's and to the kernel's own gumbel's
                  bucket maxima, the share of elements it evaluated (its
                  measurement build), and timed at the fit's draw beside
                  the function's floor (the SASS of
                  ``probes/categorical_work.cu``'s hash-only loop) and a
                  full evaluation's count, at the issue rate

then the ``kernels`` line of seven kernels (``node_histograms``: launches
counted over the gbt and rf phases, ``per_fit`` from the timed fits' launch
counts and the profile; ``segment_sum_sorted``: launches counted over the
``criteo`` phase's adam arm (the ``overload`` fit's and the ``online``
phase's beside them), the
times of the ``segment_sum`` phase, and ``group_by``: its launches over the
``wrangle`` phase, its times at ``group_by``'s inputs;
``segment_update_sorted``: launches counted over the ``criteo`` phase's
timed fit, the times of the ``segment_update`` phase, the chain's time as
its yardstick, its launches over the ``online`` phase beside them, and ``with_values``: one step of the ``libsvm_hashed`` fit
at its own inputs (its time, its bound with the 4 B a value more, bitwise
the chain; launches over that fit), the criteo step given per-pair values
beside it as ``criteo_shape``); ``normal_equations_sorted``: launches counted over the
``movielens_als`` phase's timed fit, the times of its user half-step, the
item and skewed item half-steps beside; ``threefry_bits`` and
``poisson_knuth``: launches over the gbt and rf phases (and, for the
words, the ``wrangle`` phase), the times of the ``prng`` phase;
``categorical_gumbel``: launches over the ``unsupervised`` phase's timed
Word2Vec fit, its times there; each fails the run if it counted no
launch),
the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
``ok`` line, as does a machine without CUDA or a directory without the
package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HOLDOUT = 1 << 18
GBT_AUC_FLOOR, RF_AUC_FLOOR = 0.72, 0.82
# the Criteo configuration of bench.py (:87-97, :404-428)
CRITEO_ROWS, CRITEO_EPOCHS, CRITEO_AUC_FLOOR = 8_000_000, 100, 0.73
# (on an accelerator: the packed cache, epoch 1 deferred into the fused replay)
CRITEO = dict(n_dims=1 << 22, n_dense=13, n_cat=26, chunk_rows=1 << 18, step_size=0.04,
              reg_param=1e-5, loss="logistic", label_in_chunk=True, prefetch_depth=2,
              optim_update="sparse_adagrad", missing="zero", cache_dtype="packed",
              defer_epoch1=True, fused_replay=True)
CRITEO_HOLDOUT_CHUNKS = 2
# H100 rates from NVIDIA's data sheets: memory bytes/s and fp32 (non tensor
# core) FLOP/s, by the form factor in the card's name
RATES = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12), "SXM": (3.35e12, 67e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_rates(name: str) -> tuple[str, float, float]:
    for form in ("PCIe", "NVL"):
        if form in name:
            return (form,) + RATES[form]
    return ("SXM",) + RATES["SXM"]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 0) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events,
    after ``warmup`` calls left out."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds to issue one ``fn()``, the device not waited
    for (it is waited for before and after): what a call costs the host."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of one ``fn()``: ``reps`` calls captured
    into one CUDA graph, its replays timed by CUDA events. Unlike
    ``cuda_ms`` this leaves out the host's time to issue a call, which for
    a call of tens of microseconds can exceed the device's."""
    import torch

    from orange3_spark_tpu_torch.utils.graphs import capture_graph

    graph, _, _ = capture_graph(lambda: [fn() for _ in range(reps)],
                                torch.device("cuda", torch.cuda.current_device()))
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_ms(graph.replay, 3) / reps
    del graph
    return ms


# ------------------------------------------------------------------ phases
def sass_text(lib_path) -> str:
    """The SASS of a built library, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_atomics(lib_path) -> dict[str, list[str]]:
    """{kernel: its atomic SASS opcodes}, from ``cuobjdump -sass``."""
    text = sass_text(lib_path)
    found: dict[str, set[str]] = {}
    fn = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn is not None:
            for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDS|REDG|RED)(?:\.[A-Z0-9_]+)*)",
                                 line):
                found.setdefault(fn, set()).add(op)
    return {k: sorted(v) for k, v in found.items()}


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def sass_functions(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """{function: [(address, opcode, instruction)]} of a ``cuobjdump -sass``
    listing; a label (``.L_x_N:``) becomes the address of the instruction
    after it, in the instructions' branch targets."""
    funcs: dict[str, list[tuple[int, str, str]]] = {}
    labels: dict[str, int] = {}
    pending: list[str] = []
    fn = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSN.search(line)
        if fn is None or not m or line.lstrip().startswith("/* 0x"):
            continue
        addr, insn = int(m.group(1), 16), m.group(2).strip()
        for name in pending:
            labels[name] = addr
        pending = []
        op = re.sub(r"^@!?U?P[T0-9]+\s+", "", insn).split()[0]
        funcs[fn].append((addr, op, insn))
    for name, insns in funcs.items():
        funcs[name] = [(a, op, re.sub(r"`\((\.L_x_\d+)\)",
                                      lambda m: hex(labels.get(m.group(1), -1)), insn))
                       for a, op, insn in insns]
    return funcs


def _branch_target(op: str, insn: str) -> int | None:
    if not op.startswith("BRA"):
        return None
    hits = [m.group(2) for m in _SASS_TARGET.finditer(insn) if m.group(2)]
    return int(hits[-1], 16) if hits else None


def sass_loop(insns: list[tuple[int, str, str]], innermost: bool = False) -> dict:
    """The instructions a pass of a function's main loop issues: the span
    of its longest backward branch (``innermost``: its shortest), split into
    basic blocks at branch targets and after branches, less every block
    that holds a ``CALL`` (a call out of line, off the common path) and the
    ``NOP`` padding; with the span's opcodes (less their modifiers) by
    count."""
    targets = {t for a, op, insn in insns if (t := _branch_target(op, insn)) is not None}
    back = [(a - t, t, a) for a, op, insn in insns
            if (t := _branch_target(op, insn)) is not None and t < a]
    if not back:
        raise ValueError("no loop in the function's SASS")
    _, lo, hi = min(back) if innermost else max(back)
    blocks: list[list[tuple[int, str, str]]] = [[]]
    for a, op, insn in insns:
        if not lo <= a <= hi:
            continue
        if a in targets and blocks[-1]:
            blocks.append([])
        blocks[-1].append((a, op, insn))
        if op.startswith(("BRA", "EXIT", "RET")):
            blocks.append([])
    kept = [b for b in blocks if b and not any(op.startswith("CALL") for _, op, _ in b)]
    calls = [insn for b in blocks for _, op, insn in b if op.startswith("CALL")]
    ops: dict[str, int] = {}
    for b in kept:
        for _, op, _ in b:
            if op != "NOP":
                base = op.split(".")[0]
                ops[base] = ops.get(base, 0) + 1
    return {"instructions": sum(ops.values()), "span": [hex(lo), hex(hi)],
            "blocks": len(kept), "call_blocks_left_out": len(blocks) - len(kept)
            - sum(1 for b in blocks if not b), "calls": calls,
            "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def sass_callee(funcs: dict, insns: list[tuple[int, str, str]], call: str) -> int:
    """The instructions one ``call`` (a ``CALL`` of ``insns``) runs: its
    target's function in ``funcs``, or, where the callee sits in the
    caller's own listing, from the target address to the first ``RET``."""
    m = re.search(r"`\(([^)]+)\)", call)
    name = m.group(1) if m else None
    if name in funcs:
        return sum(op != "NOP" for _, op, _ in funcs[name])
    hits = re.findall(r"\b0x[0-9a-f]+\b", call)
    if not hits:
        raise ValueError(f"no target in {call!r}")
    start, n = int(hits[-1], 16), 0
    for a, op, _ in insns:
        if a < start or op == "NOP":
            continue
        n += 1
        if op.startswith("RET"):
            return n
    raise ValueError(f"no RET after the call target {hits[-1]}")


def phase_build():
    from orange3_spark_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    info = cuda_build.build()
    nvcc_s = time.perf_counter() - t0
    ptxas = {name: re.findall(r"ptxas info\s*: (Used [^\n]*)|(\d+ bytes stack frame[^\n]*)",
                              v["log"]) for name, v in info.items()}
    ptxas = {name: [a or b for a, b in lines] for name, lines in ptxas.items()}
    sass = {p.stem: sass_atomics(cuda_build.library_path(p.stem))
            for p in sorted(cuda_build.CSRC.glob("*.cu"))}
    shared_add = sorted({op for kernels in sass.values() for ops in kernels.values()
                         for op in ops if op.startswith("ATOMS")})
    return {"nvcc_s": round(nvcc_s, 3),
            "per_source_s": {k: round(v["seconds"], 3) for k, v in info.items()},
            "ptxas": ptxas, "sass_atomics": sass, "shared_add_sass": shared_add}


def _hist_inputs(gen, N, d, s, T, nodes, n_bins, integer, dev):
    import torch

    B = torch.randint(0, n_bins, (N, d), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.randint(0, nodes, (T, N), generator=gen, device=dev, dtype=torch.int32)
    if integer:   # forest gini stats: class one-hot × Poisson bootstrap weight
        cls = torch.randint(0, s, (T, N), generator=gen, device=dev)
        boot = torch.poisson(torch.ones((T, N), device=dev), generator=gen)
        S = torch.nn.functional.one_hot(cls, s).float() * boot[..., None]
    elif s == 3:  # boosting stats [g, h, w]
        S = torch.stack([torch.rand((T, N), generator=gen, device=dev) * 2 - 1,
                         torch.rand((T, N), generator=gen, device=dev) * 0.25,
                         torch.ones((T, N), device=dev)], dim=2)
    else:
        S = torch.randn((T, N, s), generator=gen, device=dev)
    return B, S.contiguous(), pos


# the two fits of the HIGGS config, as the histogram sees them
FITS = {"gbt": {"T": 1, "s": 3, "integer": False},
        "rf": {"T": 20, "s": 2, "integer": True}}
D, N_BINS, DEPTH = 28, 32, 5


def _fit_inputs(name, N, dev):
    """(B int32, B uint8, S, masks f32[T, DEPTH, D]) of a fit at full rows.
    The forest's stats and masks are the fit's own draws (``draw_forest``
    with the default seed, sqrt feature subsets); boosting gets random
    masks of the same density, since its fit passes none."""
    import torch

    from orange3_spark_tpu_torch.models.random_forest import draw_forest

    f = FITS[name]
    gen = torch.Generator(device=dev).manual_seed(1234)
    B = torch.randint(0, N_BINS, (N, D), generator=gen, device=dev, dtype=torch.int32)
    keep_p = float(D ** 0.5 / D)
    if name == "rf":
        boot, keep = draw_forest(N, D, num_trees=f["T"], depth=DEPTH, keep_p=keep_p,
                                 subsample=1.0, seed=0, device=dev)
        keep = torch.where(keep.sum(-1, keepdim=True) > 0, keep, 1.0)
        cls = torch.randint(0, f["s"], (N,), generator=gen, device=dev)
        S = torch.nn.functional.one_hot(cls, f["s"]).float()[None] * boot[..., None]
    else:
        S = _hist_inputs(gen, N, 1, 3, 1, 1, N_BINS, False, dev)[1]
        keep = (torch.rand((1, DEPTH, D), generator=gen, device=dev) < keep_p).float()
    return B, B.to(torch.uint8), S.contiguous(), keep


def _compare(got, ref, integer):
    """(agrees, max |got - ref|, max |ref| of each stat, the largest
    |got - ref| of a stat over its max |ref|). Integer stats:
    bitwise against the fp32 plain version. Float stats: ``ref`` is the
    plain version summed in float64, and each stat must be within 1e-5 of
    its own max|ref| (the kernel's fixed-point sums are within
    n·2^(e_c-25) of the exact ones, far inside that; one tolerance over all
    stats would hide a small stat beside a large one)."""
    import torch

    if not got.numel():
        return True, 0.0, [], 0.0
    lead = tuple(range(ref.ndim - 1))
    err = (got.double() - ref.double()).abs().amax(dim=lead)
    scale = ref.double().abs().amax(dim=lead)
    ok = torch.equal(got, ref) if integer else bool((err <= 1e-5 * scale).all())
    rel = float((err / scale.clamp_min(1e-300)).max())
    return ok, float(err.max()), scale.tolist(), rel


def phase_check(train_rows, dev):
    """Kernel vs plain version: bitwise on integer stats, 1e-5·max|H| on
    float stats. Returns (line, the largest |got - ref| at the fits' shapes)."""
    import random

    import torch

    from orange3_spark_tpu_torch.ops import histogram as th

    gen = torch.Generator(device=dev).manual_seed(1234)
    results, worst, failed = {}, 0.0, []

    def plain(B, S, pos, integer, **kw):   # the reference _compare expects
        return th.node_histograms_reference(B, S if integer else S.double(), pos, **kw)

    def record(name, shape, got, ref, integer, extra_ok=True):
        nonlocal worst
        torch.cuda.synchronize()
        ok, err, scale, rel = _compare(got, ref, integer)
        if name.startswith(tuple(FITS)):   # the main path's shapes
            worst = max(worst, err)
        results[name] = {"shape": shape, "bitwise": integer, "max_abs_err": err,
                         "max_abs_H": scale, "max_rel_err": rel, "ok": ok and extra_ok}
        if not (ok and extra_ok):
            failed.append(name)

    for seed in range(8):   # randomized shapes, ragged row counts, masks
        r = random.Random(100 + seed)
        nodes, n_bins = r.choice([1, 2, 3, 5, 8, 16]), r.choice([4, 8, 16, 32, 64])
        s, T, d = r.choice([1, 2, 3, 5]), r.choice([1, 3]), r.choice([1, 5, 28, 40])
        N = r.randint(1, 300_000)
        B, S, pos = _hist_inputs(gen, N, d, s, T, nodes, n_bins, False, dev)
        if seed % 2:
            B = B.to(torch.uint8)
        features = (torch.rand((T, d), generator=gen, device=dev) < 0.3) if seed % 4 >= 2 else None
        got = th.node_histograms(B, S, pos, nodes=nodes, n_bins=n_bins, features=features)
        ref = plain(B, S, pos, False, nodes=nodes, n_bins=n_bins, features=features)
        record(f"sweep{seed}", [T, N, d, s, nodes, n_bins, str(B.dtype), features is not None],
               got, ref, False)
    # dead rows add nothing: the same as the live rows alone
    N, n = 200_000, 200_000 // 3
    B, S, pos = _hist_inputs(gen, N, 28, 3, 1, 4, 32, False, dev)
    S[:, n:] = 0.0
    got = th.node_histograms(B, S, pos, nodes=4, n_bins=32)
    alone = plain(B[:n], S[:, :n].contiguous(), pos[:, :n].contiguous(), False,
                  nodes=4, n_bins=32)
    record("zero_weight_rows", [1, N, 28, 3, 4, 32], got, alone, False)
    B, S, pos = _hist_inputs(gen, 500_000, 28, 2, 20, 8, 32, True, dev)
    got = th.node_histograms(B, S, pos, nodes=8, n_bins=32)
    ref = th.node_histograms_reference(B, S, pos, nodes=8, n_bins=32)
    record("forest_T20", [20, 500_000, 28, 2, 8, 32], got, ref, True)
    # regression stats [wy, wy², w], y in [1e4, 1e5]: y² in the 1e10s beside
    # a weight column of Poisson counts, each stat on its own scale
    N, T = 2_000_000, 4
    B, _, pos = _hist_inputs(gen, N, 28, 1, T, 16, 32, False, dev)
    yv = torch.rand((T, N), generator=gen, device=dev) * 9e4 + 1e4
    w = torch.poisson(torch.ones((T, N), device=dev), generator=gen)
    S = torch.stack([w * yv, w * yv * yv, w], dim=2).contiguous()
    got = th.node_histograms(B.to(torch.uint8), S, pos, nodes=16, n_bins=32)
    ref = plain(B, S, pos, False, nodes=16, n_bins=32)
    record("regression_stats", [T, N, 28, 3, 16, 32], got, ref, False,
           torch.equal(got[..., 2], ref[..., 2].float()))
    del B, S, pos, got, ref, alone, yv, w

    # every level of both fits at full rows: uint8 and int32 bins, with and
    # without masks; the masked plain result is the full one with the
    # features that are not built zeroed
    for fit, f in FITS.items():
        B32, B8, S, masks = _fit_inputs(fit, train_rows, dev)
        for level in range(DEPTH):
            nodes = 2 ** level
            pos = torch.randint(0, nodes, (f["T"], train_rows), generator=gen,
                                device=dev, dtype=torch.int32)
            ref = plain(B32, S, pos, f["integer"], nodes=nodes, n_bins=N_BINS)
            keep = masks[:, level]
            built = th.kept_features(keep, f["T"], D)
            ref_masked = torch.where(built[:, :, None, None], ref, 0.0)
            for bname, B in (("u8", B8), ("i32", B32)):
                for masked in (False, True):
                    got = th.node_histograms(B, S, pos, nodes=nodes, n_bins=N_BINS,
                                             features=keep if masked else None)
                    name = f"{fit}_level{level}_{bname}{'_masked' if masked else ''}"
                    zero_ok = not masked or not bool(got[~built].any())
                    record(name, [f["T"], train_rows, D, f["s"], nodes, N_BINS],
                           got, ref_masked if masked else ref, f["integer"], zero_ok)
                    del got
            del pos, ref, ref_masked
        del B32, B8, S, masks
        torch.cuda.empty_cache()
    line = {"cases": results, "max_abs_err": worst, "failed": failed}
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version: {failed}: {line}")
    return line, worst


def _library_ms(B, S, pos, nodes, n_bins):
    """One index_add_ over the flattened [T·d·nodes·n_bins] keys: the
    library yardstick. Needs the keys and the stats expanded to every
    (tree, row, feature) cell, so it runs only if they fit in memory."""
    import torch

    T, N, s = S.shape
    d = B.shape[1]
    nb = nodes * n_bins
    need = T * N * d * (4 + 4 * s)
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    if need + (2 << 30) > free:
        return None, f"needs {need / 1e9:.1f} GB of expanded keys and stats, {free / 1e9:.1f} GB free"
    try:
        keys = torch.empty((T, N, d), dtype=torch.int32, device=B.device)
        keys.copy_(B.expand(T, N, d))
        keys.add_((pos * n_bins)[:, :, None])
        offs = (torch.arange(T, device=B.device)[:, None] * d
                + torch.arange(d, device=B.device)) * nb
        keys.add_(offs.to(torch.int32)[:, None, :])
        src = S[:, :, None, :].expand(T, N, d, s).reshape(-1, s)
        out = torch.zeros((T * d * nb, s), device=B.device)
        keys = keys.view(-1)
        out.index_add_(0, keys, src)
        ms = cuda_ms(lambda: out.index_add_(0, keys, src), 3)
        del keys, src, out
        return ms, None
    except torch.OutOfMemoryError as e:   # a yardstick, not the port's path
        return None, f"out of memory: {e}"
    finally:
        torch.cuda.empty_cache()


def phase_timing(train_rows, dev, mem_bw, fp32_peak):
    """Every level of both fits at full rows, timed as the fit calls the
    kernel (the wrapper's max|S| pass included). The bound counts each
    input byte read once (B at the width passed) and H written once, and
    the adds this run's data needs (non-zero stats of live rows, times the
    features built). The per-fit figure is an estimate: the level times on
    these uniform random inputs, weighted by the launches a fit makes; the
    fits' own histogram time is read in the profile phase."""
    import torch

    from orange3_spark_tpu_torch.ops import histogram as th

    gen = torch.Generator(device=dev).manual_seed(99)
    shapes, estimate = {}, {}
    for fit, f in FITS.items():
        T, s = f["T"], f["s"]
        B32, B8, S, masks = _fit_inputs(fit, train_rows, dev)
        live = (S != 0).sum((1, 2)).double()                        # [T]
        fit_ms = 0.0
        for level in range(DEPTH):
            nodes = 2 ** level
            nb = nodes * N_BINS
            pos = torch.randint(0, nodes, (T, train_rows), generator=gen, device=dev,
                                dtype=torch.int32)
            variants = [("u8", B8, None), ("i32", B32, None)]
            if fit == "rf":   # the forest's main path: uint8 bins, its masks
                variants.insert(0, ("u8_masked", B8, masks[:, level]))
            for vname, B, keep in variants:
                run = lambda: th.node_histograms(B, S, pos, nodes=nodes, n_bins=N_BINS,
                                                 features=keep)
                run()
                torch.cuda.synchronize()
                ms = cuda_ms(run, 10 if T > 1 else 20)
                F = (th.kept_features(keep, T, D).sum(1).double() if keep is not None
                     else torch.full((T,), float(D), dtype=torch.float64, device=dev))
                adds = int((live * F).sum())
                n_bytes = (B.numel() * B.element_size() + S.numel() * 4 + pos.numel() * 4
                           + T * D * nb * s * 4
                           + (keep.numel() * keep.element_size() if keep is not None else 0))
                bytes_ms, ops_ms = n_bytes / mem_bw * 1e3, adds / fp32_peak * 1e3
                shapes[f"{fit}_level{level}_{vname}"] = {
                    "T": T, "N": train_rows, "d": D, "s": s, "nodes": nodes,
                    "n_bins": N_BINS, "B_dtype": str(B.dtype), "masked": keep is not None,
                    "ms": ms, "bytes": n_bytes, "adds": adds,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "achieved_GBps": n_bytes / ms / 1e6, "G_adds_per_s": adds / ms / 1e6}
            main = f"{fit}_level{level}_{'u8_masked' if fit == 'rf' else 'u8'}"
            fit_ms += shapes[main]["ms"]
            if level == DEPTH - 1:   # the plain version and the library call at level 4
                top = shapes[f"{fit}_level{level}_u8"]
                p = lambda: th.node_histograms_reference(B32, S, pos, nodes=nodes,
                                                         n_bins=N_BINS)
                p()
                torch.cuda.synchronize()
                top["plain_ms"] = cuda_ms(p, 2)
                top["library_ms"], top["library_note"] = _library_ms(B32, S, pos, nodes,
                                                                     N_BINS)
            del pos
        # launches per fit: GBT one tree per round, 20 rounds; the forest
        # once; each grow adds two small launches (importances, leaf sums)
        # that hist_ms leaves out
        rounds = 20 if fit == "gbt" else 1
        estimate[fit] = {"launches": rounds * (DEPTH + 2), "hist_ms": rounds * fit_ms,
                         "variant": "u8" if fit == "gbt" else "u8_masked"}
        del B32, B8, S, masks
        torch.cuda.empty_cache()
    return shapes, estimate


def phase_parity():
    """The port on the card against its CPU path on a small HIGGS table."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchSession, TorchTable
    from orange3_spark_tpu_torch.datasets import auc, higgs_domain, make_higgs_proxy
    from orange3_spark_tpu_torch.models import _tree
    from orange3_spark_tpu_torch.models.gbt import GBTClassifier
    from orange3_spark_tpu_torch.models.random_forest import grow_forest

    X, y = make_higgs_proxy(40_000, seed=7)
    rng = np.random.default_rng(7)
    T, depth, n_bins = 4, 5, 32
    boot = rng.poisson(1.0, (T, len(X))).astype(np.float32)
    keep = (rng.random((T, depth, 28)) < 0.19).astype(np.float32)
    forests, gbt, tables = {}, {}, {}
    for name in ("cpu", "cuda"):
        sess = TorchSession(name)
        tab = TorchTable.from_numpy(higgs_domain(), X, y, session=sess)
        tables[name] = tab
        edges = _tree.compute_bin_edges(tab.X, tab.W, n_bins)
        B = _tree.bin_features(tab.X, edges)
        Ystats = _tree.class_one_hot(tab.y, 2)
        forest, _ = grow_forest(
            B, edges, Ystats, tab.W, torch.from_numpy(boot).to(sess.device),
            torch.from_numpy(keep).to(sess.device), 0.0, depth=depth,
            n_bins=n_bins, gain_mode="gini", min_instances=1.0)
        forests[name] = [x.cpu() for x in forest]
        gbt[name] = GBTClassifier(max_iter=5).fit(tab)
    forest_equal = all(torch.equal(a, b) for a, b in zip(forests["cpu"], forests["cuda"]))
    p_cpu = gbt["cpu"].predict_proba(tables["cpu"])
    p_gpu = gbt["cuda"].predict_proba(tables["cuda"])
    same_splits = float(np.mean(
        (gbt["cpu"].forest.feature.numpy() == gbt["cuda"].forest.feature.cpu().numpy())
        & (gbt["cpu"].forest.split_bin.numpy() == gbt["cuda"].forest.split_bin.cpu().numpy())))
    auc_cpu, auc_gpu = auc(p_cpu[:, 1], y), auc(p_gpu[:, 1], y)
    line = {"rows": len(X), "forest_bitwise_equal": forest_equal,
            "gbt_same_split_fraction": same_splits,
            "gbt_proba_max_abs_diff": float(np.abs(p_cpu - p_gpu).max()),
            "gbt_auc_cpu": auc_cpu, "gbt_auc_cuda": auc_gpu}
    if not forest_equal:
        raise AssertionError(f"forest on the card differs from the CPU path: {line}")
    if not (np.isfinite(p_gpu).all() and abs(auc_cpu - auc_gpu) < 0.005):
        raise AssertionError(f"GBT on the card disagrees with the CPU path: {line}")
    line["seeded"] = _parity_draws(tables)
    return line


def phase_fit(name, est, table, eval_table, y_eval, floor):
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import auc
    from orange3_spark_tpu_torch.ops import prng
    from orange3_spark_tpu_torch.ops.histogram import node_histograms

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est.fit(table)                               # warm-up: first-use costs
    warm_s = time.perf_counter() - t0
    before = node_histograms.launches
    draws_before = (prng.threefry_bits.launches, prng.poisson_knuth.launches)
    t0 = time.perf_counter()
    model = est.fit(table)
    table.session.synchronize()
    fit_s = time.perf_counter() - t0
    launches = node_histograms.launches - before
    draw_launches = {"threefry_bits": prng.threefry_bits.launches - draws_before[0],
                     "poisson_knuth": prng.poisson_knuth.launches - draws_before[1]}
    proba = model.predict_proba(eval_table)
    if proba.shape != (len(y_eval), 2) or not np.isfinite(proba).all():
        raise AssertionError(f"{name}: bad probabilities, shape {proba.shape}")
    if np.abs(proba.sum(1) - 1).max() > 1e-5:
        raise AssertionError(f"{name}: probabilities do not sum to 1")
    a = auc(proba[:, 1], y_eval)
    line = {"fit_s": fit_s, "warmup_fit_s": warm_s,
            "rows_per_s": table.n_rows / fit_s, "holdout_auc": a,
            "hist_launches": launches, "draw_launches": draw_launches,
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30}
    if a < floor:
        raise AssertionError(f"{name}: holdout AUC {a:.4f} below {floor}: {line}")
    return line


def _rf_draw_line(est, table) -> dict:
    """The forest's draws inside its fit: ``draw_forest`` at the fit's
    shapes (all trees' Poisson bootstrap in one ``poisson_knuth`` launch, a
    Bernoulli mask a tree), eager by CUDA events, beside the fit's wall
    before the draws moved to JAX's stream and on the one-lane-a-thread
    ``poisson_knuth``."""
    from orange3_spark_tpu_torch.models.random_forest import _subset_fraction, draw_forest

    p = est.params
    keep_p = _subset_fraction(p.feature_subset_strategy, table.n_attrs, True)

    def draw():
        return draw_forest(table.n_pad, table.n_attrs, num_trees=p.num_trees,
                           depth=p.max_depth, keep_p=keep_p, subsample=p.subsampling_rate,
                           seed=p.seed, device=table.X.device)

    return {"draw_ms": cuda_ms(draw, 3, warmup=1), "fit_s_before_the_draws_moved":
            RF_FIT_S_BEFORE, "fit_s_one_lane_a_thread": RF_FIT_S_ONE_LANE,
            "draw_shape": [p.num_trees, table.n_pad]}


def phase_profile(est, table):
    """One more fit under torch.profiler: device time by kernel, the
    device's busy and idle share of the fit's wall time (the profiler's own
    cost is in that wall), and the histogram's share of the fit: the device
    time of the kernel and its finalize pass by name, and of the PyTorch ops
    under the wrapper's ``node_histograms`` profiler range (the accumulator
    fill, the max|S| pass and the mask lists)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.fit(table)
        table.session.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events, less the range's own span on the device timeline
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name != "node_histograms"]
    if not kernels:
        return {"fit_wall_s": wall_us / 1e6,
                "device_time": "not measured: the profiler saw no device events"}
    # demangled names: "void (anonymous namespace)::node_hist_kernel<...>(...)"
    hist_us = sum(e.time_range.elapsed_us() for e in kernels
                  if "node_hist_kernel" in e.name or "node_hist_finalize" in e.name)
    hist_launches = sum("node_hist_kernel" in e.name for e in kernels)
    ranges = [e for e in prof.events()
              if e.name == "node_histograms" and e.device_type == DeviceType.CPU]
    range_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                   else e.cuda_time_total for e in ranges)
    # the range's device time holds the PyTorch ops inside it (the max|S|
    # pass, the accumulator fill, the mask lists); the kernels launched by
    # ctypes are in it only if the profiler linked them to the range
    linked = any("node_hist_kernel" in k.name for e in ranges for k in e.kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = _busy_us(kernels)
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"fit_wall_s": wall_us / 1e6, "device_busy_s": busy / 1e6,
            "device_idle_share": 1 - busy / wall_us,
            "device_kernels": len(kernels),
            "hist_kernel_launches": hist_launches,
            "hist_kernel_ms": hist_us / 1e3,
            "hist_torch_ops_ms": (range_us - hist_us if linked else range_us) / 1e3,
            "hist_ms": (range_us if linked else range_us + hist_us) / 1e3,
            "top_kernels": [{"name": n[:90], "ms": us / 1e3, "share": us / total}
                            for n, us in top]}


def _busy_us(events) -> float:
    """Microseconds of the union of the events' device time ranges."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


# ------------------------------------------------------------- Criteo path
# theta of the card against the CPU path: CUDA's index_add_ sums a row's
# occurrences with atomics in no fixed order, so the two agree to float32
# rounding carried through the steps, not bitwise
THETA_ATOL, THETA_RTOL = 1e-5, 1e-4


def _criteo_estimator(**kw):
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    return StreamingHashedLinearEstimator(**{**CRITEO, **kw})


def _theta_err(got, want) -> tuple[dict, bool]:
    """Per-parameter max |got - want| and whether every entry is within
    THETA_ATOL + THETA_RTOL·|want|."""
    errs, ok = {}, True
    for k, w in want.items():
        w = w.cpu()
        err = (got[k].cpu() - w).abs()
        errs[k] = float(err.max())
        ok &= bool((err <= THETA_ATOL + THETA_RTOL * w.abs()).all())
    return errs, ok


def _bf16_grad_err(got, want, lr, n_steps) -> tuple[dict, bool]:
    """``_theta_err`` for a fit whose gradients are rounded to bf16 ('adam'
    and the dense twins at compute dtype bf16): a float32 ulp of the card's
    logits gradient against the CPU's can flip the bf16 rounding of an
    occurrence's gradient, moving that step's update of its row by a bf16
    unit (2^-8 of at most ``lr``). So: every entry within THETA_ATOL +
    n_steps·lr·2^-8, and at most 1 % of the touched entries (nonzero on
    the CPU) past THETA_ATOL + THETA_RTOL·|want|; a fit that kept float32
    gradients puts nearly every touched entry past it."""
    errs, ok = {}, True
    flip = THETA_ATOL + n_steps * lr * 2.0 ** -8
    beyond = {}
    for k, w in want.items():
        w = w.cpu()
        err = (got[k].cpu() - w).abs()
        errs[k] = float(err.max())
        touched = w != 0
        far = (err > THETA_ATOL + THETA_RTOL * w.abs()) & touched
        beyond[k] = float(far.sum()) / max(int(touched.sum()), 1)
        ok &= bool((err <= flip).all()) and beyond[k] <= 0.01
    return {"max_abs_err": errs, "share_past_f32_tolerance": beyond, "flip_bound": flip}, ok


def _check_codec_on_card(rng, path):
    """Bit packing on the card at every width and at the Criteo width
    (22 bits × 26 columns), and a packed chunk decoded on the card against
    the hash of its float32 codes on the card."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.io.codec import (
        pack_flat_np, pack_rows_np, unpack_flat, unpack_rows,
    )
    from orange3_spark_tpu_torch.io.native import NativeCsvReader
    from orange3_spark_tpu_torch.models import hashed_linear as hl
    from orange3_spark_tpu_torch.ops.hashing import hash_columns, salts_tensor
    from orange3_spark_tpu_torch.optim.sparse import build_plan_np, pack_plan_np, unpack_plan

    def card(words):
        return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).cuda()

    bad = {}
    for bits in range(1, 32):
        vals = rng.integers(0, 1 << bits, size=(4099, 26), dtype=np.int64)
        rows = unpack_rows(card(pack_rows_np(vals, bits)), bits, 26).cpu().numpy()
        flat = unpack_flat(card(pack_flat_np(vals[:, 3], bits)), bits, 4099).cpu().numpy()
        bad[bits] = int((rows != vals).sum() + (flat != vals[:, 3]).sum())
    # a Criteo chunk: encoded on the host as the fit encodes it, decoded on
    # the card; its indices against hash_columns of the f32 codes there
    with NativeCsvReader(path) as r:
        X = r.read_all(chunk_rows=1 << 14)[:4096]
    p = _criteo_estimator().params
    codec = hl.resolve_chunk_codec(p)
    salts = hl.column_salts(p.n_cat, p.seed)
    enc = hl._encode_chunk_np(codec, X, salts)
    h2d = hl._HostToDevice(torch.device("cuda"))
    enc_d = h2d.ready(h2d.put(enc), h2d.done())
    s_d = salts_tensor(salts, "cuda")
    yv, dense, idx, wv = hl._decode_chunk(codec, enc_d, 4000, None, None, s_d)
    Xd = torch.from_numpy(X).cuda()
    cats = Xd[:, 1 + p.n_dense:]
    want = hash_columns(torch.where(torch.isnan(cats), 0.0, cats), s_d, p.n_dims)
    plan = build_plan_np(X[:, 1 + p.n_dense:], salts, p.n_dims, 4000)
    got_plan = unpack_plan(h2d.ready(h2d.put(pack_plan_np(plan, 4096, p.n_cat, p.n_dims)),
                                     h2d.done()), 4096, p.n_cat, p.n_dims)
    return {"pack_mismatches_by_width": bad,
            "criteo_width": {"bits": codec.idx_bits, "words_per_row": codec.cat_words,
                             "index_mismatches": int((idx != want).sum()),
                             "label_mismatches": int((yv.cpu() != Xd[:, 0].cpu()).sum()),
                             "live_rows": float(wv.sum()),
                             "plan_mismatches": sum(int((got_plan[k].cpu().numpy()
                                                         != plan[k]).sum()) for k in plan)}}


def phase_criteo_check(tmp):
    """On the card against the CPU path: the hash; bit packing and the
    packed decode; small packed, deferred fits (the captured graph replay,
    the eager per-chunk replay, the CPU's 'plan' and 'sort'); a fit that
    replays from the disk spill against the cache replay; adam; the eval
    accumulators of one theta."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import (
        HashedLinearModel, estimate_cached_chunk_bytes,
    )
    from orange3_spark_tpu_torch.ops.hashing import column_salts, hash_columns, hash_columns_np

    rng = np.random.default_rng(0)
    salts = column_salts(26, seed=0)
    codes = rng.integers(-(1 << 24), 1 << 24, size=(1 << 18, 26)).astype(np.float32)
    codes[:3] = [[0.0], [-1.0], [float((1 << 24) - 1)]]
    on_card = torch.from_numpy(codes).cuda()
    hash_mismatches = {str(d): int((hash_columns(on_card, salts, d).cpu().numpy()
                                    != hash_columns_np(codes, salts, d)).sum())
                       for d in (1, 256, 1 << 20, 1 << 22)}

    path = os.path.join(tmp, "criteo_check.csv")
    gen_criteo_csv(path, 4 * 4096, seed=1)
    codec = _check_codec_on_card(rng, path)
    codec_ok = (not any(codec["pack_mismatches_by_width"].values())
                and not codec["criteo_width"]["index_mismatches"]
                and not codec["criteo_width"]["label_mismatches"]
                and not codec["criteo_width"]["plan_mismatches"]
                and codec["criteo_width"]["live_rows"] == 4000)

    small = dict(n_dims=1 << 16, chunk_rows=4096, epochs=3)
    fits, st_graph = {}, {}
    for name, dev, lowering, fused in (("cuda_graph", "cuda", "sort", True),
                                       ("cuda_eager", "cuda", "sort", False),
                                       ("cpu_plan", "cpu", "plan", True),
                                       ("cpu_sort", "cpu", "sort", True)):
        fits[name] = _criteo_estimator(sparse_lowering=lowering, fused_replay=fused,
                                       **small).fit_stream(
            csv_raw_chunk_source(path, chunk_rows=4096), session=TorchSession(dev),
            cache_device=True, stage_times=st_graph if name == "cuda_graph" else None)
    gpu = fits["cuda_graph"]
    theta_err, theta_ok = {}, st_graph["replay_source"] == "fused"
    for name in ("cuda_eager", "cpu_plan", "cpu_sort"):
        errs, ok = _theta_err(gpu.theta, fits[name].theta)
        theta_err.update({f"{name}.{k}": v for k, v in errs.items()})
        theta_ok &= ok
    # the disk spill: 12 chunks of 1024 rows, a budget of 9 chunks, so the
    # cache overflows and the replay trains groups of 2 records as one
    # captured graph; against the same fit replayed from the cache
    spill_path = os.path.join(tmp, "criteo_spill.csv")
    gen_criteo_csv(spill_path, 12 * 1024, seed=2)
    spill_kw = dict(n_dims=1 << 16, chunk_rows=1024, epochs=3)
    budget = 9 * estimate_cached_chunk_bytes(_criteo_estimator(**spill_kw).params,
                                             TorchSession("cuda"))
    st_spill: dict = {}
    spill_dir = os.path.join(tmp, "spill")
    spilled = _criteo_estimator(**spill_kw).fit_stream(
        csv_raw_chunk_source(spill_path, chunk_rows=1024), session=TorchSession("cuda"),
        cache_device=True, cache_device_bytes=budget, cache_spill_dir=spill_dir,
        stage_times=st_spill)
    cached = _criteo_estimator(**spill_kw).fit_stream(
        csv_raw_chunk_source(spill_path, chunk_rows=1024), session=TorchSession("cuda"),
        cache_device=True)
    spill_err, spill_ok = _theta_err(spilled.theta, cached.theta)
    spill_ok &= (st_spill["replay_source"] == "disk"
                 and st_spill.get("disk_replay_group") == 2
                 and spilled.n_steps_ == cached.n_steps_ == 36 and not os.listdir(spill_dir))
    adam = _check_adam(path)
    # one theta (the CPU fit's), its eval accumulators on the card's cached
    # chunks and on the CPU's: the same rows on both
    cpu = fits["cpu_sort"]
    on_gpu = HashedLinearModel(cpu.params, {k: v.cuda() for k, v in cpu.theta.items()},
                               cpu.salts, cpu.class_values)
    on_gpu.cache_codec_ = gpu.cache_codec_
    a = [x.cpu().numpy() for x in on_gpu.eval_accumulators(gpu.device_chunks_)]
    b = [x.cpu().numpy() for x in cpu.eval_accumulators(cpu.device_chunks_)]
    ev_gpu, ev_cpu = on_gpu.evaluate_device(gpu.device_chunks_), cpu.evaluate_device(
        cpu.device_chunks_)
    evals = {"loss_sum_rel_err": float(abs(a[0] - b[0]) / abs(b[0])),
             "correct_diff": float(abs(a[1] - b[1])), "weight_diff": float(abs(a[2] - b[2])),
             "hist_rows_moved": float(np.abs(a[3] - b[3]).sum() + np.abs(a[4] - b[4]).sum()),
             "auc_diff": abs(ev_gpu["auc"] - ev_cpu["auc"]), "rows": float(b[2])}
    ev_ok = (evals["loss_sum_rel_err"] <= 1e-5 and evals["correct_diff"] <= 2
             and evals["weight_diff"] == 0 and evals["hist_rows_moved"] <= 8
             and evals["auc_diff"] <= 1e-4)
    line = {"hash_mismatches": hash_mismatches, "hash_rows": len(codes), "codec": codec,
            "fit": {"n_dims": 1 << 16, "chunks": 4, "chunk_rows": 4096, "epochs": 3,
                    "optim_update": "sparse_adagrad", "cache_dtype": "packed",
                    "defer_epoch1": True},
            "graph_replay": {"replay_source": st_graph["replay_source"],
                             "graph_capture_s": st_graph.get("graph_capture_s")},
            "theta_max_abs_err": theta_err,
            "theta_tolerance": f"|card - other| <= {THETA_ATOL} + {THETA_RTOL}*|other|",
            "spill": {"replay_source": st_spill["replay_source"],
                      "disk_replay_group": st_spill.get("disk_replay_group"),
                      "steps": spilled.n_steps_, "theta_max_abs_err_vs_cache": spill_err,
                      "ok": spill_ok},
            "adam": adam,
            "eval": evals,
            "eval_tolerance": "loss_sum rel <= 1e-5, correct <= 2 rows, weights equal, "
                              "<= 8 rows in another AUC bin, AUC <= 1e-4"}
    if (any(hash_mismatches.values()) or not codec_ok or not theta_ok or not spill_ok
            or not adam["ok"] or not ev_ok):
        raise AssertionError(f"the Criteo path on the card disagrees with the CPU path: {line}")
    return line


def _check_adam(path):
    """'adam' on the card against the CPU: the update on the same inputs
    (within 1e-7 + 1e-6·|θ|: pow may round an ulp apart), and two fit steps
    (losses within 1e-5 relative; θ within the atomics tolerance on all but
    1e-4 of the entries and within 2·lr·steps everywhere: adam divides by
    sqrt(v) + 1e-8, so a row whose first gradient is a near-cancelled sum
    can move by up to lr when the card sums it in another order)."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
    from orange3_spark_tpu_torch.optim.sparse import adam_update, init_adam_state

    rng = np.random.default_rng(4)
    theta = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in (("emb", (1 << 16, 1)), ("coef", (13, 1)), ("intercept", (1,)))}
    grads = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
             for k, v in theta.items()}
    upd = {}
    for dev in ("cpu", "cuda"):
        th = {k: torch.from_numpy(v).to(dev) for k, v in theta.items()}
        state = init_adam_state(th)
        for _ in range(3):
            th, state = adam_update(th, {k: torch.from_numpy(v).to(dev)
                                         for k, v in grads.items()}, state, 0.04)
        upd[dev] = th
    update_err = {k: float((upd["cuda"][k].cpu() - upd["cpu"][k]).abs().max()) for k in theta}
    update_ok = all(bool(((upd["cuda"][k].cpu() - upd["cpu"][k]).abs()
                          <= 1e-7 + 1e-6 * upd["cpu"][k].abs()).all()) for k in theta)
    fits = {dev: _criteo_estimator(optim_update="adam", n_dims=1 << 16, chunk_rows=4096,
                                   epochs=1, defer_epoch1=False).fit_stream(
        csv_raw_chunk_source(path, chunk_rows=4096), session=TorchSession(dev),
        cache_device=True, holdout_chunks=2) for dev in ("cuda", "cpu")}
    lr = CRITEO["step_size"]
    steps = fits["cuda"].n_steps_
    off, worst = {}, {}
    for k, want in fits["cpu"].theta.items():
        err = (fits["cuda"].theta[k].cpu() - want).abs()
        off[k] = int((err > THETA_ATOL + THETA_RTOL * want.abs()).sum())
        worst[k] = float(err.max())
    loss_rel = abs(fits["cuda"].final_loss_ - fits["cpu"].final_loss_) / abs(
        fits["cpu"].final_loss_)
    fit_ok = (steps == 2 and loss_rel <= 1e-5
              and all(off[k] <= 1e-4 * fits["cpu"].theta[k].numel() for k in off)
              and all(w <= 2 * lr * steps for w in worst.values()))
    return {"update_max_abs_err": update_err, "steps": steps, "loss_rel_err": loss_rel,
            "theta_max_abs_err": worst, "entries_outside_tolerance": off,
            "ok": update_ok and fit_ok}


def phase_criteo_data(tmp, rows):
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv

    path = os.path.join(tmp, f"criteo_{rows}.csv")
    t0 = time.perf_counter()
    gen_criteo_csv(path, rows, seed=0)
    return path, {"rows": rows, "GB": os.path.getsize(path) / 1e9,
                  "seconds": time.perf_counter() - t0}


def _fresh_state(params, theta, sess):
    """A step's inputs as a new fit of ``params`` would have them, with
    ``theta``: (theta, opt_state, salts, static_kw, (reg, lr, l1))."""
    import numpy as np

    from orange3_spark_tpu_torch.models.hashed_linear import _init_fit_state

    _, opt, _, salts, kw = _init_fit_state(params, sess)
    theta = {k: v.clone() for k, v in theta.items()}
    hyper = tuple(float(np.float32(v)) for v in (params.reg_param, params.step_size,
                                                 params.l1_param))
    return theta, opt, salts, kw, hyper


def _replay_steps(state, chunks):
    """One eager step per chunk, as a per-chunk replay epoch runs them."""
    from orange3_spark_tpu_torch.models.hashed_linear import _step_into

    theta, opt, salts, kw, hyper = state
    loss = None
    for c in chunks:
        loss = _step_into(theta, opt, c, salts, hyper, kw)
    return loss


def _step_ms(params, theta, chunks, sess, n_steps):
    """Mean time of ``n_steps`` eager steps cycling over ``chunks`` (CUDA
    events around them all, one warm step first), from fresh optimizer
    state of ``params``' rule: bench.py's ``step_rate``."""
    state = _fresh_state(params, theta, sess)
    _replay_steps(state, chunks[:1])
    sess.synchronize()
    steps = [chunks[i % len(chunks)] for i in range(n_steps)]
    return cuda_ms(lambda: _replay_steps(state, steps), 1) / n_steps


def phase_criteo(path, rows, epochs, sess):
    """bench.py's Criteo fit on an accelerator, at full width: warm-up as
    bench.py:508-531 does it (one chunk parsed, ``warm_replay`` over the
    train chunk count, the eval path on a zero chunk), the timed fit,
    ``evaluate_device`` on the holdout, then the A/B arms."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.io.codec import force_cache_dtype
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import (
        HashedLinearModel, resolve_chunk_codec, warm_eval_chunk,
    )
    from orange3_spark_tpu_torch.ops.segment_sum import (
        segment_sum_sorted, segment_update_sorted,
    )

    chunk = CRITEO["chunk_rows"]
    budget = 8 << 30
    source = csv_raw_chunk_source(path, chunk_rows=chunk)
    n_chunks = -(-rows // chunk)
    holdout_chunks = max(min(CRITEO_HOLDOUT_CHUNKS, n_chunks - 1), 0)
    t0 = time.perf_counter()
    next(iter(source()))                 # the reader and the parse, once
    est_w = _criteo_estimator(epochs=epochs)
    theta_w, salts_w = est_w.warm_replay(n_chunks - holdout_chunks, session=sess)
    m0 = HashedLinearModel(est_w.params, theta_w, salts_w, ("0", "1"))
    m0.cache_codec_ = resolve_chunk_codec(est_w.params, sess)
    m0.evaluate_device([warm_eval_chunk(est_w.params, sess)])
    warm_s = time.perf_counter() - t0
    del est_w, theta_w, m0
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    st: dict = {}
    est = _criteo_estimator(epochs=epochs)
    # ---- the main path: the fused update's count starts at 0 here
    segment_update_sorted.launches = 0
    t0 = time.perf_counter()
    model = est.fit_stream(source, session=sess, cache_device=True, cache_device_bytes=budget,
                           holdout_chunks=holdout_chunks, stage_times=st)
    sess.synchronize()
    fit_s = time.perf_counter() - t0
    update_launches = segment_update_sorted.launches
    # ----
    plane = _criteo_plane(model, est.params, st, sess)
    t0 = time.perf_counter()
    ev = model.evaluate_device(model.holdout_chunks_)
    eval_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    holdout_rows = sum(int(c[1]) for c in model.holdout_chunks_)
    train_rows = rows - holdout_rows

    # the probes (bench.py:650-857): eager steps over cached chunks from
    # fresh optimizer state, timed by CUDA events after one warm step
    chunks = model.device_chunks_[:4]
    pure_step_ms = _step_ms(est.params, model.theta, chunks, sess, 20)
    # ---- the adam arm: the dense table gradient's segment sums, counted
    segment_sum_sorted.launches = 0
    dense_ms = _step_ms(est.params.replace(optim_update="adam"), model.theta, chunks, sess, 6)
    seg_launches = segment_sum_sorted.launches
    # ----
    # the f32-cache arm: the same head re-cached at f32 within the same
    # budget, stepped with the fit's rule
    def head():
        for i, c in enumerate(source()):
            if i >= len(chunks):
                break
            yield c

    with force_cache_dtype("f32"):    # the arm's fit and its steps
        m_f32 = _criteo_estimator(epochs=1, defer_epoch1=False).fit_stream(
            head, session=sess, cache_device=True, cache_device_bytes=budget)
        f32_ms = _step_ms(m_f32.params, model.theta, m_f32.device_chunks_, sess, 6)
    f32_chunk_bytes = m_f32.device_chunks_[0][0].numel() * 4
    del m_f32

    walls = st["epoch_s"]
    n_rep = epochs if est.params.defer_epoch1 else epochs - 1
    replay_steps = n_rep * len(model.device_chunks_)
    line = {"rows": rows, "train_rows": train_rows, "holdout_rows": holdout_rows,
            "epochs": epochs, "cached_chunks": len(model.device_chunks_),
            "steps": model.n_steps_, "fit_s": fit_s, "eval_s": eval_s,
            # the wrappers' counts: one launch a step run eagerly or
            # recorded into the captured epoch (a graph replay re-runs the
            # recorded launches without the wrapper, so it counts none);
            # the update's over the timed fit, the sum's over the adam arm
            "segment_update_launches": update_launches,
            "segment_sum_launches": seg_launches,
            "value": rows / (fit_s + eval_s) / 1,
            "train_rows_x_epochs_per_sec": train_rows * epochs / fit_s,
            "pure_step_ms": pure_step_ms, "pure_step_probe_steps": 20,
            "pure_step_ms_dense": dense_ms, "pure_step_ms_f32cache": f32_ms,
            "ab_probe_steps": 6, "f32_chunk_bytes": f32_chunk_bytes,
            "optim_update": st["optim_update"], "sparse_lowering": st["sparse_lowering"],
            "cache_dtype": st["cache_dtype"], "defer_epoch1": est.params.defer_epoch1,
            "replay_source": st["replay_source"], "replay_fused_s": st.get("replay_fused_s"),
            "graph_capture_s": st.get("graph_capture_s"),
            "replay_step_ms": ((st["replay_fused_s"] - st["graph_capture_s"]) * 1e3
                               / replay_steps if st.get("replay_fused_s") else None),
            "epoch1_s": walls[0], "parse_s": st["parse_s"], "encode_s": st["encode_s"],
            "h2d_s": st["h2d_s"], "overlap_pct": st.get("overlap_pct"),
            "cache_bytes": st.get("cache_bytes"), "cache_raw_bytes": st.get("cache_raw_bytes"),
            "compression_ratio": st["cache_raw_bytes"] / st["cache_bytes"],
            "auc": ev.get("auc"), "logloss": ev["logloss"], "accuracy": ev["accuracy"],
            "final_loss": model.final_loss_, "peak_mem_GiB": peak / 2**30,
            "warmup_s": warm_s, "auc_floor": CRITEO_AUC_FLOOR,
            **plane,
            "cuts": {"epochs": f"{CRITEO_EPOCHS} -> {epochs}" if epochs != CRITEO_EPOCHS
                     else None,
                     "rows": f"{CRITEO_ROWS} -> {rows}" if rows != CRITEO_ROWS else None}}
    if not (np.isfinite([ev["logloss"], model.final_loss_]).all()
            and ev.get("auc") is not None):
        raise AssertionError(f"criteo: non-finite or missing results: {line}")
    if (st["cache_dtype"], st["replay_source"]) != ("packed", "fused"):
        raise AssertionError(f"criteo: not the accelerator configuration: {line}")
    if ev["auc"] < CRITEO_AUC_FLOOR:
        raise AssertionError(f"criteo: holdout AUC {ev['auc']:.4f} below "
                             f"{CRITEO_AUC_FLOOR}: {line}")
    if plane["plane_failed"]:
        raise AssertionError(f"criteo: the goodput and memory plane failed "
                             f"{plane['plane_failed']}: {line}")
    return model, line


def _criteo_plane(model, params, st, sess) -> dict:
    """The timed fit's goodput and device-memory plane (obs/prof.py), read
    from its ``run_report_``: the five fractions (summing to 1 within
    0.02) and each epoch window's bottleneck (the replay's not
    ``framework_bound``: at full size the device's seconds in the replays,
    read from their CUDA events, outweigh the capture and the host's
    launches); a ``model_state``
    ledger entry equal to the table's bytes (the slots die with the fit),
    the fit's peak at least the table, the slots and the cache; the
    ``cache_chunks`` entry equal to ``stage_times['cache_bytes']``; the
    CUDA allocator's allocated bytes at least the ledger's total."""
    import gc

    from orange3_spark_tpu_torch.models.hashed_linear import _init_fit_state
    from orange3_spark_tpu_torch.obs import prof

    rep = model.run_report_.to_dict()
    gp, dm = rep["goodput"], rep["device_memory"]
    rec = dm["reconciliation"]
    table_bytes = prof.tree_device_bytes(model.theta)
    theta0, opt0 = _init_fit_state(params, sess)[:2]
    state_bytes = prof.tree_device_bytes((theta0, opt0))
    del theta0, opt0
    gc.collect()
    live = prof.LEDGER.reconcile()
    frac_sum = sum(gp["fractions"].values())
    epochs = [(e["epoch"], e["bottleneck"], e["wall_s"], e["fractions"])
              for e in gp["epochs"]]
    # every live entry (the report keeps the 64 largest of the process)
    model_state = [e["bytes"] for e in prof.LEDGER.snapshot(max_entries=1 << 20)["entries"]
                   if e["owner"] == "model_state"]
    failed = [name for name, ok in (
        ("fractions_sum_to_1", abs(frac_sum - 1.0) <= 0.02),
        ("replay_not_framework_bound", len(epochs) >= 2
         and epochs[-1][1] != "framework_bound"),
        ("model_state_is_the_table", table_bytes in model_state),
        ("peak_holds_table_slots_cache",
         dm["peak_bytes_fit"] >= state_bytes + st["cache_bytes"]),
        ("cache_entry_is_cache_bytes", dm.get("cache_entry_bytes") == st["cache_bytes"]),
        ("allocator_at_least_ledger", rec["allocator"] is not None
         and rec["allocated_bytes"] >= rec["ledger_bytes"]),
    ) if not ok]
    return {"goodput": {"fractions": gp["fractions"], "fraction_sum": frac_sum,
                        "seconds": gp["seconds"], "bottleneck": gp["bottleneck"],
                        "epochs": epochs},
            "ledger": {"owners_at_fit_end": dm["owners"], "table_bytes": table_bytes,
                       "table_and_slots_bytes": state_bytes,
                       "model_state_entries": model_state,
                       "cache_entry_bytes": dm.get("cache_entry_bytes"),
                       "peak_bytes_fit": dm["peak_bytes_fit"],
                       "reconciliation_at_fit_end": rec,
                       "reconciliation_after": live},
            "plane_failed": failed}


def _device_profile(prof, exclude=()):
    """Device events of a profile: (events, by name [us, count], busy us)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.name not in exclude]
    by_name: dict[str, list] = {}
    for e in events:
        slot = by_name.setdefault(e.name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us()
        slot[1] += 1
    return events, by_name, (_busy_us(events) if events else 0.0)


def phase_criteo_profile(model, sess, epochs=3):
    """Under torch.profiler: (1) eager steps over the cached (packed)
    chunks: device time by kernel, by ATen op and by stage of the step
    (with each stage's host time), the device's busy and idle share,
    launches per step, and the ``nonzero`` calls a step makes (none: the
    step never waits for the device); (2) the captured graph replay of the
    same chunks: device busy time, idle share and launches per replay
    epoch, beside CUDA-event times of a replay epoch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orange3_spark_tpu_torch.models.hashed_linear import STEP_STAGES, _Replay, _step_into

    chunks = model.device_chunks_
    state = _fresh_state(model.params, model.theta, sess)
    _replay_steps(state, chunks[:2])
    sess.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(epochs):
            _replay_steps(state, chunks)
        sess.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = epochs * len(chunks)
    # the stage ranges show on the device timeline too, as spans from their
    # first kernel to their last: kept apart from the kernels
    events, by_name, busy = _device_profile(prof, exclude=STEP_STAGES)
    nonzero = sum(a.count for a in prof.key_averages() if a.key == "aten::nonzero")
    if not events:
        eager = {"wall_s": wall_us / 1e6, "steps": steps,
                 "device_time": "not measured: the profiler saw no device events"}
    else:
        total = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        stages = {name: {"device_ms_per_step": 0.0, "device_span_ms_per_step": 0.0,
                         "host_ms_per_step": 0.0} for name in STEP_STAGES}
        for e in prof.events():
            if e.name not in stages:
                continue
            if e.device_type == DeviceType.CUDA:
                stages[e.name]["device_span_ms_per_step"] += (
                    e.time_range.elapsed_us() / 1e3 / steps)
            else:
                dev_us = getattr(e, "device_time_total", None)
                stages[e.name]["device_ms_per_step"] += (
                    e.cuda_time_total if dev_us is None else dev_us) / 1e3 / steps
                stages[e.name]["host_ms_per_step"] += e.cpu_time_total / 1e3 / steps
        ops = []
        for a in prof.key_averages():
            self_us = getattr(a, "self_device_time_total", None)
            self_us = a.self_cuda_time_total if self_us is None else self_us
            if self_us > 0 and a.key.startswith("aten::"):
                ops.append({"op": a.key, "ms_per_step": self_us / 1e3 / steps,
                            "calls_per_step": a.count / steps, "share": self_us / total})
        ops.sort(key=lambda o: -o["ms_per_step"])
        eager = {"wall_s": wall_us / 1e6, "steps": steps, "chunks": len(chunks),
                 "step_wall_ms": wall_us / 1e3 / steps,
                 "device_busy_ms_per_step": busy / 1e3 / steps,
                 "device_idle_share": 1 - busy / wall_us,
                 "device_launches_per_step": len(events) / steps,
                 "stages": stages, "top_ops": ops[:12],
                 "top_kernels": [{"name": n[:110], "ms_per_step": v[0] / 1e3 / steps,
                                  "launches_per_step": v[1] / steps, "share": v[0] / total}
                                 for n, v in top]}
    eager["nonzero_calls_per_step"] = nonzero / steps

    # the captured replay of the same chunks, from fresh state
    theta, opt, salts, kw, hyper = _fresh_state(model.params, model.theta, sess)
    replay = _Replay(theta, opt, chunks,
                     lambda th, op, c: _step_into(th, op, c, salts, hyper, kw))
    t0 = time.perf_counter()
    replay.capture()
    capture_s = time.perf_counter() - t0
    replay.run(1, timed=False)
    sess.synchronize()
    epoch_ms = cuda_ms(lambda: replay.run(1, timed=False), epochs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay.run(epochs, timed=False)
        sess.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events, by_name, busy = _device_profile(prof)
    graph = {"capture_s": capture_s, "replay_epoch_ms": epoch_ms,
             "replay_step_ms": epoch_ms / len(chunks), "epochs": epochs,
             "wall_s": wall_us / 1e6}
    if events:
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        graph.update(device_busy_ms_per_epoch=busy / 1e3 / epochs,
                     device_idle_share=1 - busy / wall_us,
                     device_launches_per_epoch=len(events) / epochs,
                     top_kernels=[{"name": n[:110], "ms_per_epoch": v[0] / 1e3 / epochs,
                                   "launches_per_epoch": v[1] / epochs}
                                  for n, v in top])
    else:
        graph["device_time"] = ("not measured: the profiler saw no device events "
                                "inside the graph replays")
    del replay
    return {"eager": eager, "graph": graph}


# ------------------------------------------------------ recovery of the fit
#: the resume drill's epochs (``--resume-epochs``), cut from bench.py's 100
#: so the three fits stay a small part of the script's time
RESUME_EPOCHS, RESUME_EVERY_EPOCHS = 10, 2
FAULT_SPEC = "source_io:every=7,fails=2;slow_source:every=8,delay_ms=5"


class _Killed(RuntimeError):
    """The injected crash of the resume drill."""


def _drill_checkpointer(path, die_after=None):
    """A ``StreamCheckpointer`` that times each save (``save_s``: the host
    copies and the pickle to disk), keeps a host copy of its last save
    (outside the timing) and raises right after ``die_after`` saves."""
    from orange3_spark_tpu_torch.utils.fault import StreamCheckpointer, host_tree

    class Drill(StreamCheckpointer):
        def __init__(self):
            super().__init__(path)
            self.save_s, self.last, self.nbytes = [], None, 0

        def save(self, step, state, meta=None):
            t0 = time.perf_counter()
            super().save(step, state, meta)
            self.save_s.append(time.perf_counter() - t0)
            self.nbytes = os.path.getsize(self.path)
            self.last = (step, host_tree(state))
            if die_after is not None and len(self.save_s) >= die_after:
                raise _Killed(f"injected crash after save {len(self.save_s)}")

    return Drill()


def _resume_fit(path, rows, epochs, sess, checkpointer=None, stage_times=None):
    """The ``criteo`` phase's fit at full width, with epoch-granular replay
    and epoch snapshots every RESUME_EVERY_EPOCHS: (model, fit seconds)."""
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source

    chunk = CRITEO["chunk_rows"]
    holdout = max(min(CRITEO_HOLDOUT_CHUNKS, -(-rows // chunk) - 1), 0)
    est = _criteo_estimator(epochs=epochs, replay_granularity="epoch",
                            checkpoint_every_epochs=RESUME_EVERY_EPOCHS)
    t0 = time.perf_counter()
    model = est.fit_stream(csv_raw_chunk_source(path, chunk_rows=chunk), session=sess,
                           cache_device=True, cache_device_bytes=8 << 30,
                           holdout_chunks=holdout, checkpointer=checkpointer,
                           stage_times=stage_times)
    sess.synchronize()
    return model, time.perf_counter() - t0


def _fit_result(model):
    """Host copies of theta, the step count and the holdout evaluation."""
    return ({k: v.cpu() for k, v in model.theta.items()}, model.n_steps_,
            model.evaluate_device(model.holdout_chunks_))


def _trees_equal(a, b) -> bool:
    import numpy as np

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def phase_criteo_resume(tmp, path, rows, epochs, sess):
    """The full-width fit made recoverable: a clean fit with epoch
    snapshots; a fit whose checkpointer crashes right after its 3rd
    snapshot (mid-replay); a fresh estimator that resumes from that
    snapshot. The resumed fit must equal the clean one bit for bit: theta,
    the optimizer state at the last snapshot (the fit's end), the step
    count and the holdout AUC."""
    import torch

    from orange3_spark_tpu_torch.utils.fault import StreamCheckpointer

    clean_ck = _drill_checkpointer(os.path.join(tmp, "clean.ckpt"))
    st: dict = {}
    model, clean_s = _resume_fit(path, rows, epochs, sess, clean_ck, st)
    spe = len(model.device_chunks_)
    clean = _fit_result(model)
    del model
    torch.cuda.empty_cache()
    ck_path = os.path.join(tmp, "killed.ckpt")
    killed_ck = _drill_checkpointer(ck_path, die_after=3)
    t0 = time.perf_counter()
    try:
        _resume_fit(path, rows, epochs, sess, killed_ck)
        raise AssertionError("criteo_resume: the crashing checkpointer never crashed")
    except _Killed:
        killed_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    step, _ = StreamCheckpointer(ck_path).load()
    resumed_ck = _drill_checkpointer(ck_path)
    model, resume_s = _resume_fit(path, rows, epochs, sess, resumed_ck)
    resumed = _fit_result(model)
    final_loss = model.final_loss_
    del model
    torch.cuda.empty_cache()
    checks = {
        "theta_bitwise": all(torch.equal(resumed[0][k], clean[0][k]) for k in clean[0]),
        "opt_state_bitwise": (resumed_ck.last is not None and clean_ck.last is not None
                              and resumed_ck.last[0] == clean_ck.last[0] == clean[1]
                              and _trees_equal(resumed_ck.last[1], clean_ck.last[1])),
        "n_steps_equal": resumed[1] == clean[1],
        "auc_bitwise": resumed[2].get("auc") == clean[2].get("auc"),
    }
    save_s = clean_ck.save_s + killed_ck.save_s + resumed_ck.save_s
    line = {"epochs": epochs, "checkpoint_every_epochs": RESUME_EVERY_EPOCHS,
            "steps_per_epoch": spe, "steps": clean[1], "replay_source": st["replay_source"],
            "clean_fit_s": clean_s, "killed_fit_s": killed_s, "resume_fit_s": resume_s,
            "killed_at_step": step, "replay_epochs_skipped": step // spe,
            "saves": {"clean": len(clean_ck.save_s), "killed": len(killed_ck.save_s),
                      "resumed": len(resumed_ck.save_s)},
            "snapshot_s": save_s, "snapshot_s_mean": sum(save_s) / len(save_s),
            "snapshot_bytes": clean_ck.nbytes,
            "replay_epoch_ms": ((st["replay_fused_s"] - st["graph_capture_s"]) * 1e3
                                / epochs),
            "auc": clean[2].get("auc"), "resumed_auc": resumed[2].get("auc"),
            "final_loss": final_loss, **checks,
            "cuts": {"epochs": f"{CRITEO_EPOCHS} -> {epochs}"}}
    if not all(checks.values()) or st["replay_source"] != "fused_epoch" or step % spe:
        raise AssertionError(f"criteo_resume: the resumed fit differs: {line}")
    return line, clean[0]


def _wedge_demo(path, sess):
    """``wedge:at=1,hold_s=30`` under a 0.25 s budget on a small eager fit
    of the CSV's head (24 steps; the guarded wait comes every 4th): the fit
    must raise ``DispatchWedgedError`` within 2 s instead of hanging."""
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.resilience import DispatchWedgedError, inject_faults
    from orange3_spark_tpu_torch.resilience.overload import reset_wedge_breaker

    def head():
        for i, c in enumerate(csv_raw_chunk_source(path, chunk_rows=1 << 12)()):
            if i >= 24:
                break
            yield c

    est = StreamingHashedLinearEstimator(
        n_dims=1 << 16, n_dense=13, n_cat=26, epochs=1, chunk_rows=1 << 12,
        label_in_chunk=True, optim_update="sparse_adagrad")
    est.fit_stream(head, session=sess)          # warm: first-use costs off the clock
    old = os.environ.get("OTPU_DISPATCH_BUDGET_S")
    os.environ["OTPU_DISPATCH_BUDGET_S"] = "0.25"
    reset_wedge_breaker()
    out = {"raised": False}
    try:
        with inject_faults("wedge:at=1,hold_s=30"):
            t0 = time.perf_counter()
            try:
                est.fit_stream(head, session=sess)
            except DispatchWedgedError as e:
                out.update(raised=True, step=e.step, waited_s=e.waited_s)
            out["seconds"] = time.perf_counter() - t0
    finally:
        reset_wedge_breaker()
        if old is None:
            os.environ.pop("OTPU_DISPATCH_BUDGET_S", None)
        else:
            os.environ["OTPU_DISPATCH_BUDGET_S"] = old
    return out


def phase_criteo_fault(path, rows, epochs, sess, clean_theta):
    """bench.py's fault protocol (bench.py:1316-1360) on the full-width
    fit: the ``criteo_resume`` configuration fitted clean and then under
    transient source faults (every 7th chunk fails twice) and stragglers
    (every 8th waits 5 ms), with 0.02 s backoff. The recovered fit must
    equal the clean one bitwise (and the resume drill's clean theta);
    ``recovery_overhead_pct`` is what surviving the faults cost in wall
    time. Then the watchdog demo."""
    import torch

    from orange3_spark_tpu_torch.resilience import inject_faults
    from orange3_spark_tpu_torch.utils.profiling import (
        reset_resilience_counters, resilience_counters,
    )

    model, wall_clean = _resume_fit(path, rows, epochs, sess)
    clean = {k: v.cpu() for k, v in model.theta.items()}
    del model
    torch.cuda.empty_cache()
    reset_resilience_counters()
    old = os.environ.get("OTPU_RETRY_BASE_S")
    os.environ["OTPU_RETRY_BASE_S"] = "0.02"
    st: dict = {}
    try:
        with inject_faults(FAULT_SPEC):
            model, wall_fault = _resume_fit(path, rows, epochs, sess, stage_times=st)
    finally:
        if old is None:
            os.environ.pop("OTPU_RETRY_BASE_S", None)
        else:
            os.environ["OTPU_RETRY_BASE_S"] = old
    res = resilience_counters()
    faulted = {k: v.cpu() for k, v in model.theta.items()}
    del model
    torch.cuda.empty_cache()
    parity = all(torch.equal(faulted[k], clean[k]) for k in clean)
    same_as_drill = all(torch.equal(clean[k], clean_theta[k]) for k in clean)
    wedge = _wedge_demo(path, sess)
    line = {"spec": FAULT_SPEC, "epochs": epochs, "wall_clean_s": wall_clean,
            "wall_fault_s": wall_fault,
            "recovery_overhead_pct": 100.0 * (wall_fault - wall_clean) / wall_clean,
            "retries": st["retries"], "faults_injected": res["faults_injected"],
            "retry_wait_s": res["retry_wait_s"], "parity_bitwise": parity,
            "clean_equals_resume_drill": same_as_drill, "watchdog": wedge,
            "cuts": {"epochs": f"{CRITEO_EPOCHS} -> {epochs}"}}
    if not (parity and same_as_drill and st["retries"] > 0 and wedge["raised"]
            and wedge["seconds"] < 2.0):
        raise AssertionError(f"criteo_fault: recovery failed its checks: {line}")
    return line


# --------------------------------------------------------- the segment sum
#: rows of the one long segment the check sums (a heavy hitter)
SEG_LONG_ROWS = 1 << 20


def _record_call(module, name, model, sess, optim_update, snapshot=None):
    """The arguments one step of the fit passes to ``module.name`` on its
    first cached chunk, from fresh optimizer state of ``optim_update`` and
    the fitted theta: recorded by wrapping the function the step calls, so
    they are the step's own. ``snapshot(args)`` copies what the call
    updates in place before it runs."""
    from orange3_spark_tpu_torch.models.hashed_linear import _step_into

    seen = []
    real = getattr(module, name)

    def record(*args, **kw):
        seen.append((snapshot(args) if snapshot else args, kw))
        return real(*args, **kw)

    params = model.params.replace(optim_update=optim_update)
    theta, opt, salts, kw, hyper = _fresh_state(params, model.theta, sess)
    setattr(module, name, record)
    try:
        _step_into(theta, opt, model.device_chunks_[0], salts, hyper, kw)
    finally:
        setattr(module, name, real)
    sess.synchronize()
    return seen[0]


def _step_segment_inputs(model, sess):
    """The arguments of ``segment_sum_sorted`` in one 'adam' step (the
    dense table gradient, ``dense_table_grad``, of bench.py's
    ``pure_step_ms_dense`` arm): the sorted gradients, the segment ids and
    the slot count."""
    from orange3_spark_tpu_torch.optim import sparse

    (g, seg, n_slots), kws = _record_call(sparse, "segment_sum_sorted", model, sess, "adam")
    return g, seg, n_slots, kws.get("skip_last")


def _step_update_inputs(model, sess):
    """The arguments of ``segment_update_sorted`` in one ``sparse_adagrad``
    step of the fit (the sorted keys, the order, C, dl, and copies of the
    table, slots, last-seen steps and step counter as the call found
    them), with the hyper-parameters; ``use_decay``; the pairs' values of
    a value-weighted fit (else None)."""
    from orange3_spark_tpu_torch.optim import sparse

    def snapshot(args):
        kind, s_idx, order, C, dl, emb, slots, t, step, *rest = args
        return (kind, s_idx, order, C, dl, emb.clone(), {n: v.clone() for n, v in
                                                         slots.items()},
                t.clone(), step.clone(), *rest)

    args, kws = _record_call(sparse, "segment_update_sorted", model, sess,
                             model.params.optim_update, snapshot)
    return args, kws["use_decay"], kws.get("vals")


def _time_deterministic_index_add(g, seg, n_slots):
    """``index_add_`` under ``torch.use_deterministic_algorithms(True)``:
    its time, whether two calls agree bitwise, and whether a CUDA graph
    can capture it (a yardstick only; the port never calls it)."""
    import torch

    from orange3_spark_tpu_torch.utils.graphs import capture_graph

    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        run = lambda: torch.zeros((n_slots, g.shape[1]), device=g.device).index_add_(
            0, seg, g)
        a, b = run(), run()
        out["bitwise_repeat"] = bool(torch.equal(a, b))
        out["ms"] = cuda_ms(run, 10)
        try:
            graph, static, _ = capture_graph(run, g.device)
            graph.replay()
            torch.cuda.synchronize()
            out["capturable"] = bool(torch.equal(static, a))
        except Exception as e:  # noqa: BLE001 - the yardstick's own failure is a finding
            out["capturable"] = False
            out["capture_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    except Exception as e:  # noqa: BLE001 - as above
        out["error"] = f"{type(e).__name__}: {str(e)[:200]}"
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def phase_segment_sum(inputs, mem_bw):
    """``segment_sum_sorted`` on the card at the step's inputs: five
    launches bitwise equal; against its plain version on the card
    (``index_add_`` with float atomics: max |err|) and on a CPU copy (the
    index order: bitwise on every segment of at most ``walk_max()`` rows);
    a captured launch against the eager one; one segment of 2^20 rows
    (spread over the card) within 1e-6·Σ|g| of the float64 sum; the
    rounded mode (``round_to=torch.bfloat16``) bitwise the CPU's. Times of
    the kernel, its rounded mode, the plain version, the library call
    (``index_add_`` alone) and ``index_add_`` under deterministic mode,
    beside the bound."""
    import torch

    from orange3_spark_tpu_torch.ops import segment_sum as ss
    from orange3_spark_tpu_torch.utils.graphs import capture_graph

    g, seg, n_slots, skip = inputs
    run = lambda: ss.segment_sum_sorted(g, seg, n_slots, skip_last=skip)
    outs = [run() for _ in range(5)]
    torch.cuda.synchronize()
    got = outs[0]
    deterministic = all(torch.equal(got, o) for o in outs[1:])
    plain = ss.segment_sum_sorted_reference(g, seg, n_slots, skip_last=skip)
    max_abs_err = float((got - plain).abs().max())
    cpu = ss.segment_sum_sorted_reference(
        g.cpu(), seg.cpu(), n_slots, skip_last=None if skip is None else skip.cpu())
    seg_rows = torch.bincount(seg, minlength=n_slots)[:n_slots].cpu()
    short = seg_rows <= ss.walk_max()
    cpu_mismatch = int((got.cpu() != cpu)[short].sum())
    graph, static, _ = capture_graph(run, g.device)
    graph.replay()
    torch.cuda.synchronize()
    graph_equal = bool(torch.equal(static, got))
    del graph, static, outs

    # one long segment between short ones, spread over the card
    gen = torch.Generator(device=g.device).manual_seed(5)
    n_long = SEG_LONG_ROWS
    lens = torch.cat([torch.full((1000,), 3, device=g.device),
                      torch.tensor([n_long], device=g.device),
                      torch.full((1000,), 2, device=g.device)])
    lseg = torch.repeat_interleave(torch.arange(len(lens), device=g.device), lens)
    lg = torch.randn((lseg.numel(), 1), generator=gen, device=g.device)
    lgot = ss.segment_sum_sorted(lg, lseg, len(lens))
    lref = torch.zeros((len(lens), 1), dtype=torch.float64, device=g.device).index_add_(
        0, lseg, lg.double())
    labs = torch.zeros_like(lref).index_add_(0, lseg, lg.double().abs())
    long_err = float((lgot.double() - lref).abs()[1000])
    long_ok = bool(((lgot.double() - lref).abs() <= 1e-6 * labs).all())
    long_repeat = bool(torch.equal(lgot, ss.segment_sum_sorted(lg, lseg, len(lens))))
    del lens, lseg, lg, lgot, lref, labs

    # the rounded mode (round_to=bfloat16, the bf16 dense rules' table
    # gradient) on the occurrences' gradients rounded to bf16: bitwise the
    # plain version on a CPU copy, and its time
    gb = g.to(torch.bfloat16).to(torch.float32)
    run_bf16 = lambda: ss.segment_sum_sorted(gb, seg, n_slots, skip_last=skip,
                                             round_to=torch.bfloat16)
    bf16_cpu = ss.segment_sum_sorted_reference(
        gb.cpu(), seg.cpu(), n_slots, skip_last=None if skip is None else skip.cpu(),
        round_to=torch.bfloat16)
    bf16_equal = bool(torch.equal(run_bf16().cpu(), bf16_cpu))
    bf16_ms = graph_ms(run_bf16, 20)
    del bf16_cpu, run_bf16, gb

    plain = lambda: ss.segment_sum_sorted_reference(g, seg, n_slots, skip_last=skip)
    library = lambda: torch.zeros((n_slots, g.shape[1]), device=g.device).index_add_(0, seg, g)
    # device times from captured launches; beside them the eager calls'
    # times, which include the host's time to issue each call
    ms, plain_ms, library_ms = (graph_ms(f, 20) for f in (run, plain, library))
    timed = (("kernel", run), ("plain", plain), ("library", library))
    eager_ms = {name: cuda_ms(f, 20, warmup=1) for name, f in timed}
    issue_ms = {name: host_ms(f, 20) for name, f in timed}
    # each input read once (g, the segment ids, the one-byte skip flag),
    # the output written once
    n_bytes = (g.numel() * 4 + seg.numel() * seg.element_size() + n_slots * g.shape[1] * 4
               + (0 if skip is None else skip.numel()))
    bytes_ms = n_bytes / mem_bw * 1e3
    line = {"M": g.shape[0], "k": g.shape[1], "n_slots": n_slots,
            "seg_dtype": str(seg.dtype), "skip_last": None if skip is None else bool(skip),
            "segments": int((seg_rows > 0).sum()), "max_segment_rows": int(seg_rows.max()),
            "deterministic": deterministic, "max_abs_err": max_abs_err,
            "cpu_order_mismatches": cpu_mismatch, "graph_equal_eager": graph_equal,
            "long_segment": {"rows": n_long, "abs_err_vs_f64": long_err,
                             "within_1e-6_sum_abs": long_ok, "bitwise_repeat": long_repeat},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "eager_ms": eager_ms,
            "host_issue_ms": issue_ms,
            "deterministic_index_add": _time_deterministic_index_add(g, seg, n_slots),
            "bytes": n_bytes, "bound_ms": bytes_ms, "bound_by": "bytes",
            "round_to_bf16": {"ms": bf16_ms, "bound_ms": bytes_ms, "bound_by": "bytes",
                              "x_bound": bf16_ms / bytes_ms, "bitwise_cpu": bf16_equal,
                              "timed": "captured launches (20 in a graph)"},
            "tolerance": "max_abs_err against the card's atomic index_add_ is float32 "
                         "rounding of its run-dependent order; bitwise against the CPU's "
                         "index order on segments of at most walk_max() rows"}
    if not (deterministic and graph_equal and cpu_mismatch == 0 and long_ok
            and long_repeat and bf16_equal):
        raise AssertionError(f"segment_sum_sorted failed its checks: {line}")
    return line


def _update_copy(args, kind=None):
    """The update's arguments with fresh copies of what it writes in place
    (the table, the slots, ``t``); ``kind`` swaps the rule, with zero
    (fresh) slots for it."""
    import torch

    from orange3_spark_tpu_torch.ops.segment_sum import RULE_SLOTS

    k0, s_idx, order, C, dl, emb, slots, t, step, *hyper = args
    if kind is None:
        slots = {n: v.clone() for n, v in slots.items()}
    else:
        slots = {n: torch.zeros_like(emb) for n in RULE_SLOTS[kind]}
    return (kind or k0, s_idx, order, C, dl, emb.clone(), slots, t.clone(), step, *hyper)


def _update_state_equal(a, b) -> bool:
    import torch

    return (torch.equal(a[5], b[5]) and torch.equal(a[7], b[7]) and a[6].keys() == b[6].keys()
            and all(torch.equal(a[6][n], b[6][n]) for n in a[6]))


def _cpu_sums(g, seg, n_slots, *, skip_last=None):
    """``segment_sum_sorted_reference`` on a CPU copy, where ``index_add_``
    adds each segment's rows in index order from +0.0 (the order the
    kernels keep on segments of at most ``walk_max()`` rows); the sums come
    back to the inputs' device."""
    from orange3_spark_tpu_torch.ops.segment_sum import segment_sum_sorted_reference

    return segment_sum_sorted_reference(
        g.cpu(), seg.cpu(), n_slots,
        skip_last=None if skip_last is None else skip_last.cpu()).to(g.device)


def _plain_update(args, use_decay, segment_sum, vals=None):
    """The plain version of the update on fresh copies of ``args``' state,
    its segment sums by ``segment_sum``: ``segment_sum_sorted`` gives the
    chain the kernel replaced, ``_cpu_sums`` sums independent of the
    kernels' device code (the rule as torch ops on the card, whose library
    functions the kernel calls). ``vals``: per-pair values."""
    from orange3_spark_tpu_torch.ops.segment_sum import segment_update_sorted_reference

    out = _update_copy(args)
    segment_update_sorted_reference(*out, use_decay=use_decay, vals=vals,
                                    segment_sum=segment_sum)
    return out


def _long_rows(s_idx, D):
    """bool[D]: the live rows whose segment has more than ``walk_max()``
    occurrences (summed in the kernels' block order, not the CPU's)."""
    import torch

    from orange3_spark_tpu_torch.ops.segment_sum import walk_max

    keys, counts = torch.unique_consecutive(s_idx, return_counts=True)
    rows = torch.zeros(D, dtype=torch.bool, device=s_idx.device)
    rows[keys[(counts > walk_max()) & (keys < D)].long()] = True
    return rows


def _bits_differ(a, b):
    import torch

    return a.view(torch.int32) != b.view(torch.int32)


def _plain_mismatches(got, want, long_rows) -> int:
    """Entries where the kernel's state and the plain version's differ in
    their bits: ``t`` on every row; the table and the slots on every row
    but ``long_rows``."""
    short = ~long_rows
    n = int(_bits_differ(got[7], want[7]).sum()) + int(_bits_differ(got[5], want[5])[short].sum())
    return n + sum(int(_bits_differ(got[6][m], want[6][m])[short].sum()) for m in got[6])


def _sum_probe(args):
    """``args`` made into an update whose result is minus the segment sums:
    sgd with lr 1, no regularisation and decay 1 on a zero table (0 - 1·s
    and 0·1^dt round to nothing), so a row holds -(its segment's sum)."""
    import torch

    _, s_idx, order, C, dl, emb, _, t, step, *_ = args
    return ("sgd", s_idx, order, C, dl, torch.zeros_like(emb), {}, t, step, 1.0, 1.0, 0.0, 0.0)


def _probe_check(kernel, args, use_decay, long_rows, vals=None) -> dict:
    """The kernel's sums through ``_sum_probe`` against the plain version's
    with the CPU's sums: bitwise on every row of a segment of at most
    ``walk_max()`` occurrences and on ``t``; on the other rows |Δsum| within
    1e-6·Σ|g| of the segment. Also whether that comparison fails a plain
    version with one occurrence dropped and one with it doubled (the
    occurrence of largest |g| in a short segment): the check's power."""
    import torch

    probe = _sum_probe(args)
    got = kernel(_update_copy(probe))
    want = _plain_update(probe, use_decay, _cpu_sums, vals)
    line = {"mismatches": _plain_mismatches(got, want, long_rows), "long_rel_err": None,
            "long_err_over_bound": None}
    _, s_idx, order, C, dl, emb, *_ = probe
    D = emb.shape[0]
    if bool(long_rows.any()):
        abs_sum = -_plain_update(probe[:4] + (dl.abs(),) + probe[5:], use_decay, _cpu_sums,
                                 None if vals is None else vals.abs())[5]
        err = (got[5] - want[5]).abs()[long_rows]
        line["long_rel_err"] = float((err / abs_sum[long_rows]).max())
        # float32 summation's bound for any two orders of a row's n terms:
        # 2g/(1-g)·Σ|g|, g = n·2^-24/(1 - n·2^-24)
        keys, counts = torch.unique_consecutive(s_idx, return_counts=True)
        n = torch.zeros(D, dtype=torch.float64, device=s_idx.device)
        live = keys < D
        n[keys[live].long()] = counts[live].double()
        gam = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
        bound = (2 * gam / (1 - gam))[long_rows, None] * abs_sum[long_rows].double()
        line["long_err_over_bound"] = float((err.double() / bound).max())
    g = dl.index_select(0, order // C).abs().sum(1)
    if vals is not None:
        g = g * vals.index_select(0, order).abs()
    short = (s_idx < D) & ~long_rows[s_idx.clamp(max=D - 1).long()]
    i = int(torch.where(short, g, -1.0).argmax())
    mutated_order = order.clone()
    mutated_order[i] = dl.shape[0] * C                 # the appended row of dl
    # the appended occurrence's value: the one it stands in for
    mvals = None if vals is None else torch.cat([vals, vals[order[i]][None]])
    caught = {}
    for name, extra in (("dropped", torch.zeros_like(dl[:1])),
                        ("doubled", 2 * dl[order[i] // C][None])):
        mutated = probe[:2] + (mutated_order, C, torch.cat([dl, extra])) + probe[5:]
        caught[name] = _plain_mismatches(
            got, _plain_update(mutated, use_decay, _cpu_sums, mvals), long_rows) > 0
    line["mutation_caught"] = caught
    return line


def _update_checks(kernel, chain, args, use_decay, long_rows, vals=None) -> dict:
    """One case: two launches bitwise equal, equal to the chain bitwise and
    held to the plain version with the CPU's sums (``_plain_mismatches``;
    ``_probe_check`` for the sums themselves). With ``vals`` the kernel and
    the chain are given the per-pair values (``kernel(a)`` and
    ``chain(a)`` take them from their closure), and so is the plain
    version."""
    a, b = kernel(_update_copy(args)), kernel(_update_copy(args))
    return {"bitwise_repeat": _update_state_equal(a, b),
            "equal_chain": _update_state_equal(a, chain(_update_copy(args))),
            "plain_mismatches": _plain_mismatches(
                a, _plain_update(args, use_decay, _cpu_sums, vals), long_rows),
            "sum_probe": _probe_check(kernel, args, use_decay, long_rows, vals)}


def _draw_vals(M, dev, seed):
    """f32[M] per-pair values: uniform on (0, 2], a seventh of them zero
    (a value-weighted chunk's pads)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    v = 2.0 - 2.0 * torch.rand(M, generator=gen, device=dev)
    return torch.where(torch.rand(M, generator=gen, device=dev) < 1 / 7, 0.0, v)


def _vals_update_case(args, use_decay, vals):
    """``_update_checks`` of the kernel and the chain given ``vals``."""
    from orange3_spark_tpu_torch.ops import segment_sum as ss

    def kernel(a):
        ss.segment_update_sorted(*a, use_decay=use_decay, vals=vals)
        return a

    def chain(a):
        ss.segment_update_sorted_reference(*a, use_decay=use_decay, vals=vals,
                                           segment_sum=ss.segment_sum_sorted)
        return a

    return _update_checks(kernel, chain, args, use_decay,
                          _long_rows(args[1], args[5].shape[0]), vals), kernel


def _update_case_ok(line, long_bound=False) -> bool:
    """A case's checks all held. Long segments' sums: within 1e-6·Σ|g| of
    the CPU's (random inputs), or with ``long_bound`` within float32
    summation's bound for the row's length (a fit's own gradients, whose
    partial sums drift one way, where the CPU's index-order sum itself
    strays further than 1e-6)."""
    probe = line["sum_probe"]
    long_ok = (probe["long_rel_err"] is None
               or (probe["long_err_over_bound"] <= 1.0 if long_bound
                   else probe["long_rel_err"] <= 1e-6))
    return (line["bitwise_repeat"] and line["equal_chain"] and line["plain_mismatches"] == 0
            and probe["mismatches"] == 0 and all(probe["mutation_caught"].values())
            and long_ok)


def _long_update_case(dev, n_long):
    """An update whose keys hold one segment of ``n_long`` occurrences
    between short ones (C = 1, a random sort order, adagrad with history):
    its arguments."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)
    lens = torch.cat([torch.full((1000,), 3, device=dev), torch.tensor([n_long], device=dev),
                      torch.full((1000,), 2, device=dev)])
    keys = torch.repeat_interleave(torch.arange(len(lens), device=dev, dtype=torch.int32) * 7,
                                   lens)
    M, D = keys.numel(), 7 * len(lens) + 1
    order = torch.randperm(M, generator=gen, device=dev)
    dl = torch.randn((M, 1), generator=gen, device=dev) * 0.01
    emb = torch.randn((D, 1), generator=gen, device=dev)
    slots = {"acc": torch.rand((D, 1), generator=gen, device=dev)}
    t = torch.randint(0, 10, (D,), generator=gen, device=dev, dtype=torch.int32)
    step = torch.tensor(9, dtype=torch.int32, device=dev)
    return ("adagrad", keys, order, 1, dl, emb, slots, t, step, 0.04, 0.9999996, 1e-5, 0.0)


def _warp_tree(v):
    """The kernels' ``warp_sum`` over dim -2 (32 lanes): five xor-shuffle
    levels, lane l adding lane l ^ o; lane 0's result."""
    import torch

    lane = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o, :]
    return v[..., 0, :]


def _long_order_sums(g, seg, n_slots):
    """The kernels' float32 sums of every segment of more than
    ``walk_max()`` rows, in plain PyTorch (f32[n_slots, k]; +0.0 on the
    other slots): the rows cut into 32-row chunks at multiples of 32, a
    chunk's rows of the segment added by ``_warp_tree`` (+0.0 off the
    segment): partial A for the segment through the chunk's first row, B
    for one that starts past it; then lane l adds the segment's chunk
    partials c0 + l, c0 + l + 32, ... from +0.0 in order (B for its first
    chunk when it starts past that chunk's first row), and the tree adds
    the lanes. ``seg`` non-decreasing; slots past ``n_slots`` dropped."""
    import torch

    from orange3_spark_tpu_torch.ops.segment_sum import walk_max

    M, k = g.shape
    dev = g.device
    keys, counts = torch.unique_consecutive(seg.long(), return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    long = counts > walk_max()
    n_chunks = -(-M // 32)
    pad = n_chunks * 32 - M
    gl = torch.where(torch.repeat_interleave(long, counts)[:, None], g, 0.0)
    gp = torch.cat([gl, g.new_zeros((pad, k))]).view(n_chunks, 32, k)
    sp = torch.cat([seg.long(), seg.new_full((pad,), -1).long()]).view(n_chunks, 32)
    first = (sp == sp[:, :1])[..., None]
    part_a = _warp_tree(torch.where(first, gp, 0.0))
    part_b = _warp_tree(torch.where(first, 0.0, gp))
    out = g.new_zeros((n_slots, k))
    live = long & (keys < n_slots)
    if not bool(live.any()):
        return out
    s, e = starts[live], (starts + counts)[live]
    c0, c1 = s // 32, (e - 1) // 32
    lane = torch.arange(32, device=dev)
    acc = g.new_zeros((s.numel(), 32, k))
    for i in range(int(((c1 - c0) // 32).max()) + 1):
        c = c0[:, None] + lane + 32 * i
        use_b = ((c == c0[:, None]) & (s % 32 != 0)[:, None])[..., None]
        cc = c.clamp(max=n_chunks - 1)
        acc = torch.where((c <= c1[:, None])[..., None],
                          acc + torch.where(use_b, part_b[cc], part_a[cc]), acc)
    out[keys[live]] = _warp_tree(acc)
    return out


def _long_order_equal(got, g, seg, n_slots, long_slots) -> bool:
    """``got`` (a segment sum's slots) bitwise ``_long_order_sums`` on
    ``long_slots``."""
    import torch

    return bool(torch.equal(got[long_slots], _long_order_sums(g, seg, n_slots)[long_slots]))


def _update_bytes(args, use_decay, vals=None):
    """(live rows, bytes, sector bytes) of one update: each input read once
    (the keys, the order, dl, and with ``vals`` 4 B more an occurrence),
    each live row's table, slot and t entries read and written once; the
    sector bytes count instead the 32-byte sectors those rows fall in (what
    the card moves at least)."""
    _, s_idx, _, _, dl, emb, slots, *_ = args
    D, k = emb.shape
    M = s_idx.numel()
    rows = s_idx.unique()
    rows = rows[rows < D].long()
    n_state = 1 + len(slots)
    row_bytes = n_state * k * 4 + (4 if use_decay else 0)
    inputs = M * 4 + M * 8 + dl.numel() * 4 + (0 if vals is None else M * 4)
    sectors = (n_state * (rows * k * 4 // 32).unique().numel()
               + ((rows * 4 // 32).unique().numel() if use_decay else 0))
    return (rows.numel(), inputs + 2 * rows.numel() * row_bytes,
            inputs + 2 * 32 * sectors)


# the criteo_zipf case: the Criteo step's shape with each column's codes
# Zipf-law distributed (numpy zipf(1.2), a fixed seed), folded into
# gen_criteo_csv's 200,000 codes a column
ZIPF_A, ZIPF_SEED, CRITEO_CODES = 1.2, 13, 200_000


def _criteo_zipf_keys(N, C, n_dims, salts, dev, seed=ZIPF_SEED):
    """The stably sorted keys and sort order of N x C occurrences whose
    codes are heavy-tailed as a real click log's: each column's codes
    drawn with numpy ``zipf(ZIPF_A)`` from ``seed``, minus 1, folded into
    ``CRITEO_CODES``, hashed by ``ops/hashing.hash_columns`` with the fit's
    ``salts`` into ``n_dims`` rows."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.ops.hashing import hash_columns

    rng = np.random.default_rng(seed)
    codes = ((rng.zipf(ZIPF_A, size=(N, C)) - 1) % CRITEO_CODES).astype(np.int32)
    idx = hash_columns(torch.from_numpy(codes).to(dev), salts, n_dims)
    return torch.sort(idx.reshape(-1), stable=True)


def _long_stats(s_idx, D) -> dict:
    """The live segments of more than ``walk_max()`` occurrences: how many,
    their occurrences, the longest live segment."""
    import torch

    from orange3_spark_tpu_torch.ops.segment_sum import walk_max

    keys, counts = torch.unique_consecutive(s_idx, return_counts=True)
    live = keys < D
    long_counts = counts[live & (counts > walk_max())]
    return {"long_segments": long_counts.numel(), "long_occurrences": int(long_counts.sum()),
            "longest_segment": int(counts[live].max())}


def _criteo_zipf_case(args, use_decay, mem_bw, salts) -> dict:
    """``phase_segment_update``'s ``criteo_zipf`` case: the Criteo step's own
    state, dl and rule (``args``) on ``_criteo_zipf_keys`` (all rows live),
    without values and with values drawn from a seed: ``_update_checks``
    (long sums within float32 summation's bound, ``long_bound``), a
    captured launch bitwise the eager one, and the long segments' sums
    bitwise the kernels' order (``_long_order_sums``) through
    ``segment_sum_sorted`` at the chain's inputs. The kernel's, the chain's
    and the plain version's captured times beside the byte and sector
    bounds; ``segment_sum_sorted`` at the dense table gradient's inputs on
    these keys (i32 ids), float32 and rounded to bf16, beside its bound."""
    import torch

    from orange3_spark_tpu_torch.ops import segment_sum as ss
    from orange3_spark_tpu_torch.utils.graphs import capture_graph

    kind, _, _, C, dl, emb0, slots0, t0, step, *hyper = args
    N, (D, k), dev = dl.shape[0], emb0.shape, emb0.device
    s_idx, order = _criteo_zipf_keys(N, C, D, salts, dev)
    M = s_idx.numel()
    zargs = (kind, s_idx, order, C, dl, emb0, slots0, t0, step, *hyper)
    vals = _draw_vals(M, dev, seed=5)

    def kernel(a, v=None):
        ss.segment_update_sorted(*a, use_decay=use_decay, vals=v)
        return a

    def chain(a, v=None):
        ss.segment_update_sorted_reference(*a, use_decay=use_decay, vals=v,
                                           segment_sum=ss.segment_sum_sorted)
        return a

    long_rows = _long_rows(s_idx, D)
    case = _update_checks(kernel, chain, zargs, use_decay, long_rows)
    vals_case, kernel_v = _vals_update_case(zargs, use_decay, vals)
    eager = kernel(_update_copy(zargs))
    cap = _update_copy(zargs)

    def captured():
        cap[5].copy_(emb0)
        cap[7].copy_(t0)
        for n, v in slots0.items():
            cap[6][n].copy_(v)
        return kernel(cap)

    graph, _, _ = capture_graph(captured, dev)
    cap[5].fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    graph_equal = _update_state_equal(cap, eager)
    del graph, eager, cap

    # the chain's sums: the kernels' long order on every long live segment
    start = torch.ones_like(s_idx, dtype=torch.bool)
    torch.ne(s_idx[1:], s_idx[:-1], out=start[1:])
    seg = torch.cumsum(start, 0) - 1
    U = min(M, D) + 1
    seg_rows = torch.bincount(seg, minlength=U)
    long_slots = seg_rows > ss.walk_max()
    g = dl.index_select(0, order // C)
    gv = g * vals.index_select(0, order)[:, None]
    long_order = {name: _long_order_equal(ss.segment_sum_sorted(x, seg, U), x, seg, U,
                                          long_slots)
                  for name, x in (("no_values", g), ("values", gv))}
    del seg, seg_rows, long_slots, gv

    work = [_update_copy(zargs) for _ in range(6)]
    timed = (("kernel", lambda: kernel(work[0])), ("chain", lambda: chain(work[1])),
             ("plain", lambda: ss.segment_update_sorted_reference(*work[2],
                                                                  use_decay=use_decay)),
             ("kernel_vals", lambda: kernel_v(work[3])),
             ("chain_vals", lambda: chain(work[4], vals)),
             ("plain_vals", lambda: ss.segment_update_sorted_reference(
                 *work[5], use_decay=use_decay, vals=vals)))
    ms = {name: graph_ms(f, 20) for name, f in timed}
    del work
    n_live, n_bytes, sector_bytes = _update_bytes(zargs, use_decay)
    v_bytes, v_sectors = _update_bytes(zargs, use_decay, vals)[1:]

    # segment_sum_sorted at the dense table gradient's inputs on these keys
    # (optim/sparse._dense_table_grad_sorted: the same stable sort, i32 ids,
    # a slot a table row)
    dg, dseg = g, torch.cumsum(start, 0, dtype=torch.int32) - 1
    sum_bytes = dg.numel() * 4 + dseg.numel() * 4 + D * k * 4
    run_sum = lambda: ss.segment_sum_sorted(dg, dseg, D)
    gb = dg.to(torch.bfloat16).to(torch.float32)
    run_bf16 = lambda: ss.segment_sum_sorted(gb, dseg, D, round_to=torch.bfloat16)
    seg_sum = {"ms": graph_ms(run_sum, 20), "bf16_ms": graph_ms(run_bf16, 5),
               "bitwise_repeat": bool(torch.equal(run_sum(), run_sum())),
               "bytes": sum_bytes, "bound_ms": sum_bytes / mem_bw * 1e3, "bound_by": "bytes",
               "at": "the dense table gradient's inputs on these keys: i32 ids, "
                     f"{D} slots; bf16_ms: round_to=bfloat16 (long segments one "
                     "thread each, in order)"}
    del g, dg, dseg, gb, start
    bound_ms, v_bound_ms = n_bytes / mem_bw * 1e3, v_bytes / mem_bw * 1e3
    line = {"M": M, "N": N, "C": C, "D": D, "k": k, "rule": kind, "use_decay": use_decay,
            "zipf_a": ZIPF_A, "zipf_seed": ZIPF_SEED, "codes_per_column": CRITEO_CODES,
            "live_rows": n_live, **_long_stats(s_idx, D), "long_rows": int(long_rows.sum()),
            **case, "graph_equal_eager": graph_equal, "long_order_bitwise": long_order,
            "ms": ms["kernel"], "chain_ms": ms["chain"], "plain_ms": ms["plain"],
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": "bytes",
            "x_bound": ms["kernel"] / bound_ms, "sector_bytes": sector_bytes,
            "sector_bound_ms": sector_bytes / mem_bw * 1e3,
            "values": {**vals_case, "ms": ms["kernel_vals"], "chain_ms": ms["chain_vals"],
                       "plain_ms": ms["plain_vals"], "bytes": v_bytes, "bound_ms": v_bound_ms,
                       "bound_by": "bytes", "x_bound": ms["kernel_vals"] / v_bound_ms,
                       "sector_bound_ms": v_sectors / mem_bw * 1e3},
            "segment_sum": seg_sum,
            "timed": "captured launches (20 in a graph; bf16_ms 5)",
            "tolerance": "as the step's case; long segments' sums within float32 "
                         "summation's bound for two orders (the step's own gradients), "
                         "and bitwise the kernels' documented order"}
    line["ok"] = (_update_case_ok(case, long_bound=True)
                  and _update_case_ok(vals_case, long_bound=True) and graph_equal
                  and all(long_order.values()) and seg_sum["bitwise_repeat"]
                  and line["long_segments"] > 0)
    return line


def phase_segment_update(inputs, mem_bw, salts=None):
    """``segment_update_sorted`` on the card at one ``sparse_adagrad``
    step's own inputs (the fit's first cached chunk, fresh optimizer state,
    the fitted theta): five launches from copies of the same state bitwise
    equal; bitwise equal to the chain it replaced (the plain version with
    ``segment_sum_sorted``'s sums) on every row of emb, acc and t; bitwise
    equal to the plain version with the CPU's sums on every row of a
    segment of at most ``walk_max()`` occurrences, the sums themselves
    checked through ``_sum_probe`` (the tolerance there fails a dropped or
    doubled occurrence, shown on the data); rows no occurrence touches
    unchanged; a captured launch equal to the eager one. The same checks
    for sgd and ftrl (fresh slots) at the same inputs and for one
    2^20-occurrence segment (its sum within 1e-6·Σ|g| of the CPU's). Times
    of the kernel, the chain and the plain version, beside the bound. Then
    ``_criteo_zipf_case`` on Zipf-law keys hashed with ``salts`` (the fit's;
    by default the estimator's, seed 0)."""
    import torch

    from orange3_spark_tpu_torch.ops import segment_sum as ss
    from orange3_spark_tpu_torch.utils.graphs import capture_graph

    args, use_decay, _ = inputs
    s_idx, emb0, slots0, t0 = args[1], args[5], args[6], args[7]
    D, k = emb0.shape
    dev = emb0.device

    def kernel(a):
        ss.segment_update_sorted(*a, use_decay=use_decay)
        return a

    def chain(a):
        ss.segment_update_sorted_reference(*a, use_decay=use_decay,
                                           segment_sum=ss.segment_sum_sorted)
        return a

    long_rows = _long_rows(s_idx, D)
    outs = [kernel(_update_copy(args)) for _ in range(5)]
    torch.cuda.synchronize()
    got = outs[0]
    deterministic = all(_update_state_equal(got, o) for o in outs[1:])
    chain_equal = _update_state_equal(got, chain(_update_copy(args)))
    touched = torch.zeros(D, dtype=torch.bool, device=dev)
    touched[s_idx[s_idx < D].long()] = True
    untouched_equal = (torch.equal(got[5][~touched], emb0[~touched])
                       and torch.equal(got[7][~touched], t0[~touched])
                       and all(torch.equal(got[6][n][~touched], v[~touched])
                               for n, v in slots0.items()))
    plain = _plain_update(args, use_decay, _cpu_sums)
    step_case = {"bitwise_repeat": deterministic, "equal_chain": chain_equal,
                 "plain_mismatches": _plain_mismatches(got, plain, long_rows),
                 "sum_probe": _probe_check(kernel, args, use_decay, long_rows)}
    max_abs_err = max(float((got[5] - plain[5]).abs().max()),
                      *(float((got[6][n] - plain[6][n]).abs().max()) for n in got[6]))
    cap = _update_copy(args)

    def captured():
        cap[5].copy_(emb0)
        cap[7].copy_(t0)
        for n, v in slots0.items():
            cap[6][n].copy_(v)
        return kernel(cap)

    graph, _, _ = capture_graph(captured, dev)
    cap[5].fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    graph_equal = _update_state_equal(cap, got)
    del graph, outs, plain
    rules = {rule: _update_checks(kernel, chain, _update_copy(args, rule), use_decay, long_rows)
             for rule in ("sgd", "ftrl")}

    long_args = _long_update_case(dev, SEG_LONG_ROWS)
    long_line = {"rows": SEG_LONG_ROWS,
                 **_update_checks(kernel, chain, long_args, use_decay,
                                  _long_rows(long_args[1], long_args[5].shape[0]))}
    # per-pair values (a value-weighted fit): at the step's inputs and on
    # the long segment, the same checks against the chain and the plain
    # version given the same values
    vals = _draw_vals(s_idx.numel(), dev, seed=3)
    vals_step, kernel_v = _vals_update_case(args, use_decay, vals)
    long_vals = _draw_vals(long_args[1].numel(), dev, seed=4)
    vals_long = {"rows": SEG_LONG_ROWS,
                 **_vals_update_case(long_args, use_decay, long_vals)[0]}
    del long_args, long_vals

    work = [_update_copy(args) for _ in range(5)]
    timed = (("kernel", lambda: kernel(work[0])), ("chain", lambda: chain(work[1])),
             ("plain", lambda: ss.segment_update_sorted_reference(*work[2],
                                                                  use_decay=use_decay)),
             ("kernel_vals", lambda: kernel_v(work[3])),
             ("plain_vals", lambda: ss.segment_update_sorted_reference(
                 *work[4], use_decay=use_decay, vals=vals)))
    # device times from captured launches (the fit runs it in a captured
    # graph); beside them the eager calls' times, host included, and the
    # host's own time to issue one call
    ms, chain_ms, plain_ms, vals_ms, vals_plain_ms = (graph_ms(f, 20) for _, f in timed)
    eager_ms = {name: cuda_ms(f, 20, warmup=1) for name, f in timed}
    issue_ms = {name: host_ms(f, 20) for name, f in timed}
    del work
    M = s_idx.numel()
    n_live, n_bytes, sector_bytes = _update_bytes(args, use_decay)
    bound_ms = n_bytes / mem_bw * 1e3
    vals_bytes, vals_sectors = _update_bytes(args, use_decay, vals)[1:]
    vals_line = {"step": vals_step, "long_segment": vals_long, "ms": vals_ms,
                 "eager_ms": eager_ms["kernel_vals"], "plain_ms": vals_plain_ms,
                 "plain_eager_ms": eager_ms["plain_vals"], "bytes": vals_bytes,
                 "bound_ms": vals_bytes / mem_bw * 1e3,
                 "x_bound": vals_ms / (vals_bytes / mem_bw * 1e3),
                 "sector_bound_ms": vals_sectors / mem_bw * 1e3,
                 "zero_values": int((vals == 0).sum()),
                 "tolerance": "as without values: bitwise against the chain given the "
                              "same values, bitwise against the plain version with the "
                              "CPU's sums on short segments"}
    line = {"M": M, "k": k, "D": D, "rule": args[0], "use_decay": use_decay,
            "live_rows": n_live, "long_rows": int(long_rows.sum()),
            **step_case, "untouched_rows_equal": untouched_equal,
            "graph_equal_eager": graph_equal, "rules": rules, "long_segment": long_line,
            "vals": vals_line, "max_abs_err": max_abs_err,
            "ms": ms, "chain_ms": chain_ms, "plain_ms": plain_ms, "library_ms": None,
            "eager_ms": eager_ms, "host_issue_ms": issue_ms,
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": "bytes",
            "x_bound": ms / bound_ms, "sector_bytes": sector_bytes,
            "sector_bound_ms": sector_bytes / mem_bw * 1e3,
            "tolerance": "bitwise against the chain it replaced on every row; bitwise "
                         "against the plain version with the CPU's index-order sums on t "
                         "and on every row of a segment of at most walk_max() occurrences "
                         "(max_abs_err over all rows); the sums alone (sgd, lr 1, zero "
                         "table) bitwise there and within 1e-6*sum|g| on longer segments, "
                         "a tolerance shown to fail a dropped or doubled occurrence"}
    if salts is None:
        from orange3_spark_tpu_torch.ops.hashing import column_salts

        salts = column_salts(CRITEO["n_cat"], 0)
    line["criteo_zipf"] = _criteo_zipf_case(args, use_decay, mem_bw, salts)
    if not (untouched_equal and graph_equal and line["criteo_zipf"]["ok"]
            and all(map(_update_case_ok, (step_case, *rules.values(), long_line,
                                          vals_step, vals_long)))):
        raise AssertionError(f"segment_update_sorted failed its checks: {line}")
    return line


def phase_values_update(model, sess, mem_bw):
    """``segment_update_sorted`` given per-pair values at the inputs of one
    step of a value-weighted fit (``_step_update_inputs``: its first cached
    chunk, the pairs' own values, the dead pads' sentinel keys, fresh
    optimizer state, the fitted theta): ``_update_checks`` against the
    chain and the plain version given the same values (long segments'
    sums within float32 summation's bound, ``_update_case_ok``); the
    kernel's, the chain's and the plain version's device times from
    captured launches, beside the bound with the 4 B a value counted."""
    import torch

    from orange3_spark_tpu_torch.ops import segment_sum as ss

    args, use_decay, vals = _step_update_inputs(model, sess)
    if vals is None:
        raise AssertionError("the value-weighted step passed no values to the update")
    case, kernel = _vals_update_case(args, use_decay, vals)
    s_idx, D = args[1], args[5].shape[0]

    def chain(a):
        ss.segment_update_sorted_reference(*a, use_decay=use_decay, vals=vals,
                                           segment_sum=ss.segment_sum_sorted)

    work = [_update_copy(args) for _ in range(3)]
    timed = (("kernel", lambda: kernel(work[0])), ("chain", lambda: chain(work[1])),
             ("plain", lambda: ss.segment_update_sorted_reference(
                 *work[2], use_decay=use_decay, vals=vals)))
    ms, chain_ms, plain_ms = (graph_ms(f, 5) for _, f in timed)
    eager_ms = {name: cuda_ms(f, 3, warmup=1) for name, f in timed}
    del work
    n_live, n_bytes, sector_bytes = _update_bytes(args, use_decay, vals)
    keys, counts = torch.unique_consecutive(s_idx, return_counts=True)
    live = keys < D
    long_counts = counts[live & (counts > ss.walk_max())]
    bound_ms = n_bytes / mem_bw * 1e3
    line = {"M": s_idx.numel(), "k": args[5].shape[1], "D": D, "rule": args[0],
            "use_decay": use_decay, "live_rows": n_live,
            "dead_pairs": int(counts[~live].sum()),
            "zero_values": int((vals == 0).sum()),
            "long_segments": long_counts.numel(),
            "long_occurrences": int(long_counts.sum()),
            "longest_segment": int(counts[live].max()),
            **case, "ms": ms, "chain_ms": chain_ms, "plain_ms": plain_ms,
            "eager_ms": eager_ms, "bytes": n_bytes, "bound_ms": bound_ms,
            "bound_by": "bytes", "x_bound": ms / bound_ms, "sector_bytes": sector_bytes,
            "sector_bound_ms": sector_bytes / mem_bw * 1e3,
            "tolerance": "bitwise against the chain given the same values on every row; "
                         "bitwise against the plain version with the CPU's index-order "
                         "sums on t and on every row of a segment of at most walk_max() "
                         "occurrences; the sums of longer segments within float32 "
                         "summation's bound for two orders, 2g/(1-g) x sum|g|, "
                         "g = n*2^-24/(1 - n*2^-24)"}
    if not _update_case_ok(case, long_bound=True):
        raise AssertionError(f"segment_update_sorted with values failed its checks: {line}")
    return line


# ------------------------------------------------------------------ serving
# bench.py --config serving (bench.py:1104-1214): the CTR model, its request
# pool and its mixed-size trace
SERVE_DIMS, SERVE_FIT_CHUNKS, SERVE_POOL_ROWS = 1 << 18, 4, 1 << 19
SERVE_REQUESTS, SERVE_MIN_REQ, SERVE_MAX_REQ, SERVE_TRACE_SEED = 120, 16, 8192, 11
SERVE_LADDER = dict(min_bucket=256, max_bucket=1 << 14)
# served logits are held to eager raw logits bitwise on the card (as in
# tests/test_torch_cuda.py): the graph runs the raw path's ops at the
# bucket's row count, and on the H100 none of them rounded a live row apart
# there. If one ever does, that is a finding (ROADMAP queue 3: the op and
# its measured max |Δ|), and the bound to hold the card to is that one.


def _serve_model(path, sess, n_dims, chunk_rows, n_chunks):
    """bench_serving's model: StreamingHashedLinearEstimator's defaults,
    one epoch over the first ``n_chunks`` chunks of the CSV."""
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

    def head():
        for i, c in enumerate(csv_raw_chunk_source(path, chunk_rows=chunk_rows)()):
            if i >= n_chunks:
                break
            yield c

    est = StreamingHashedLinearEstimator(n_dims=n_dims, n_dense=13, n_cat=26, epochs=1,
                                         step_size=CRITEO["step_size"],
                                         chunk_rows=chunk_rows, label_in_chunk=True)
    return est.fit_stream(head, session=sess), head


def _request_pool(head, rows):
    """The first ``rows`` parsed rows, label column stripped (bench.py)."""
    import numpy as np

    pool, n = [], 0
    for c in head():
        pool.append(np.asarray(c)[:, 1:])
        n += c.shape[0]
        if n >= rows:
            break
    return np.ascontiguousarray(np.concatenate(pool)[:rows].astype(np.float32))


def _serve_err(served, raw) -> dict:
    """Served against eager raw logits: max |Δ| and whether they are
    bitwise equal (same shape, same bits), which every check requires."""
    import numpy as np

    same_shape = served.shape == raw.shape
    d = np.abs(served.astype(np.float64) - raw) if same_shape else np.array([np.inf])
    return {"max_abs_err": float(d.max()) if d.size else 0.0,
            "bitwise": bool(same_shape and np.array_equal(served, raw))}


def phase_serving_check(path, sess):
    """The serving path on the card at small sizes: served vs raw logits at
    a request size in every rung of a 64..2048 ladder; 32 requests from 8
    threads by direct dispatch; micro-batched requests from 16 threads; a
    hot reload and an in-place theta update; capture counts; an RF and a
    GBT model through the ``predict-pad`` route."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.datasets import higgs_domain, make_higgs_proxy
    from orange3_spark_tpu_torch.models.gbt import GBTClassifier
    from orange3_spark_tpu_torch.models.random_forest import RandomForestClassifier
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
    from orange3_spark_tpu_torch.serve.context import _raw_calls
    from orange3_spark_tpu_torch.utils.profiling import (
        graph_capture_count, reset_serve_counters, serve_counters,
    )

    model, head = _serve_model(path, sess, 1 << 16, 1 << 14, 4)
    pool = _request_pool(head, 1 << 14)
    ladder = BucketLadder(min_bucket=64, max_bucket=2048)
    failed = []

    def check(name, cond):
        if not cond:
            failed.append(name)

    # one request size in every rung, twice (the repeat captures nothing)
    sizes = (50, 100, 200, 300, 700, 1500)
    raws = {n: model._logits(pool[:n]) for n in sizes}
    reqs = [(int(37 * i), int((61 * i) % 900 + 5)) for i in range(32)]
    raw_reqs = [model._logits(pool[o:o + n]) for o, n in reqs]
    reset_serve_counters()
    with ServingContext(ladder) as ctx:
        c0 = graph_capture_count()
        served = {n: model._logits(pool[:n]) for n in sizes}
        captures = graph_capture_count() - c0
        # churn the allocator: a tensor a graph reads but no one holds
        # would be handed out and overwritten here
        junk = [torch.full((1 << 18,), -7, dtype=torch.int64, device=sess.device)
                for _ in range(64)]
        del junk
        again = {n: model._logits(pool[:n]) for n in sizes}
        repeat_captures = graph_capture_count() - c0 - captures
        one_thread = [model._logits(pool[o:o + n]) for o, n in reqs]
        with ThreadPoolExecutor(8) as ex:
            threaded = list(ex.map(lambda r: model._logits(pool[r[0]:r[0] + r[1]]), reqs))
        direct_breakers = ctx.breaker_states()
        rung_bytes = ctx.cache.device_bytes() / max(len(ctx.cache), 1)
    direct = serve_counters()
    rungs = {n: _serve_err(served[n], raws[n]) for n in sizes}
    threads = [_serve_err(a, b) for a, b in zip(threaded, raw_reqs)]
    check("rungs", all(r["bitwise"] for r in rungs.values()))
    check("repeat_bitwise", all(np.array_equal(served[n], again[n]) for n in sizes))
    check("captures", captures == len({ladder.bucket_for(n) for n in sizes}) and
          repeat_captures == 0)
    check("threads", all(t["bitwise"] for t in threads) and all(
        np.array_equal(a, b) for a, b in zip(threaded, one_thread)))
    dispatches = direct["bucket_hits"] + direct["bucket_misses"]
    check("graph_replays", direct["graph_replays"] == dispatches == 2 * len(sizes) + 64)

    # micro-batched: 48 small requests from 16 threads, coalesced
    mb_reqs = [(int(53 * i), int((29 * i) % 120 + 1)) for i in range(48)]
    raw_mb = [model._logits(pool[o:o + n]) for o, n in mb_reqs]
    with ServingContext(ladder, micro_batch=True, max_batch=2048, max_wait_ms=5.0) as ctx:
        ctx.warmup(model, n_cols=pool.shape[1])
        reset_serve_counters()
        with ThreadPoolExecutor(16) as ex:
            got_mb = list(ex.map(lambda r: model._logits(pool[r[0]:r[0] + r[1]]), mb_reqs))
        mb_breakers = ctx.breaker_states()
    mb = serve_counters()
    mb_errs = [_serve_err(a, b) for a, b in zip(got_mb, raw_mb)]
    check("micro_batch", all(e["bitwise"] for e in mb_errs)
          and mb["mb_requests"] == len(mb_reqs) and 1 <= mb["mb_batches"] < mb["mb_requests"]
          and mb["graph_replays"] == mb["mb_batches"])

    # hot reload keys a fresh graph; an in-place update reaches the same graph
    with ServingContext(ladder) as ctx:
        before = model._logits(pool[:300])
        c0 = graph_capture_count()
        model.load_state_pytree({k: v * 0.5 for k, v in model.theta.items()})
        reloaded = model._logits(pool[:300])
        with _raw_calls():
            raw_reloaded = model._logits(pool[:300])
        reload_captures = graph_capture_count() - c0
        model.theta["intercept"].add_(1.0)
        in_place = model._logits(pool[:300])
        with _raw_calls():
            raw_in_place = model._logits(pool[:300])
        in_place_captures = graph_capture_count() - c0 - reload_captures
        reload_breakers = ctx.breaker_states()
    reload = {"reloaded": _serve_err(reloaded, raw_reloaded),
              "in_place": _serve_err(in_place, raw_in_place),
              "captures_on_reload": reload_captures,
              "captures_on_in_place_update": in_place_captures,
              "moved": bool(not np.allclose(before, reloaded))}
    check("hot_reload", reload["reloaded"]["bitwise"] and reload["in_place"]["bitwise"]
          and reload_captures == 1 and in_place_captures == 0 and reload["moved"])
    check("breakers", not (direct_breakers or mb_breakers or reload_breakers)
          and direct["build_failures"] == mb["build_failures"] == 0)

    # tree models: predict-pad (the table bucket-padded, the raw predict run)
    X, y = make_higgs_proxy(20_000, seed=3)
    table = TorchTable.from_numpy(higgs_domain(), X, y, session=sess)
    trees = {"rf": RandomForestClassifier(num_trees=5, max_depth=5).fit(table),
             "gbt": GBTClassifier(max_iter=5, max_depth=4).fit(table)}
    tree_lines = {}
    for name, m in trees.items():
        eq = []
        for k in (9, 300, 5000):
            t = TorchTable.from_numpy(higgs_domain(), X[:k], y[:k], session=sess)
            raw = m.predict(t)
            with ServingContext(BucketLadder(min_bucket=16, max_bucket=8192)) as ctx:
                got = m.predict(t)
                pad = [key[0] for key in ctx.cache.keys()] == ["predict-pad"]
            eq.append(bool(np.array_equal(got, raw) and pad and got.shape == (k,)))
        tree_lines[name] = {"sizes": [9, 300, 5000], "bitwise_equal": eq}
        check(f"{name}_predict_pad", all(eq))
    line = {"model": {"n_dims": 1 << 16, "fit_chunks": 4, "chunk_rows": 1 << 14},
            "ladder": list(ladder.buckets()),
            "rungs": {str(n): r for n, r in rungs.items()},
            "served_bitwise_equal_raw": all(r["bitwise"] for r in rungs.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rungs.values()),
            "tolerance": "bitwise",
            "captures": captures, "repeat_captures": repeat_captures,
            "device_bytes_per_rung": rung_bytes,
            "threads": {"requests": len(reqs), "threads": 8,
                        "max_abs_err": max(t["max_abs_err"] for t in threads)},
            "direct_counters": direct,
            "micro_batch": {"requests": mb["mb_requests"], "batches": mb["mb_batches"],
                            "merge_factor": mb["mb_merge_factor"],
                            "max_abs_err": max(e["max_abs_err"] for e in mb_errs)},
            "hot_reload": reload, "trees": tree_lines, "failed": failed}
    if failed:
        raise AssertionError(f"serving on the card failed {failed}: {line}")
    return line


def _traced_requests_total() -> int:
    from orange3_spark_tpu_torch.obs.registry import REGISTRY

    m = REGISTRY.get("otpu_traced_requests_total")
    return int(m.total()) if m is not None else 0


def _serve_trace(pool_rows):
    """bench.py's trace: log-uniform sizes on [16, 8192], default_rng(11)."""
    import numpy as np

    rng = np.random.default_rng(SERVE_TRACE_SEED)
    max_req = min(SERVE_MAX_REQ, pool_rows)
    sizes = np.exp(rng.uniform(np.log(SERVE_MIN_REQ), np.log(max_req),
                               SERVE_REQUESTS)).astype(np.int64)
    offs = rng.integers(0, pool_rows - int(sizes.max()) + 1, len(sizes))
    return [(int(o), int(s)) for o, s in zip(offs, sizes)]


def _run_trace(model, pool, trace):
    """Per-request latency (ms) of ``model.predict``, the wall, the outputs."""
    lat, outs = [], []
    t0 = time.perf_counter()
    for off, sz in trace:
        t1 = time.perf_counter()
        out = model.predict(pool[off:off + sz])
        lat.append((time.perf_counter() - t1) * 1e3)
        outs.append(out)
    return lat, time.perf_counter() - t0, outs


def _pctl(lat, q):
    import numpy as np

    return float(np.percentile(np.asarray(lat), q))


def _trace_check(model, pool, trace, got, want, ctx) -> dict:
    """Served against raw over a trace: the served predictions equal the
    raw ones, and the served logits (one more pass through ``ctx``) equal
    the raw ones bitwise. Names the first request that differs."""
    from orange3_spark_tpu_torch.serve.context import _raw_calls

    flips, worst = 0, {"max_abs_err": 0.0, "bitwise": True}
    with ctx:
        for (off, sz), a, b in zip(trace, got, want):
            X = pool[off:off + sz]
            served = model._logits(X)
            with _raw_calls():
                raw = model._logits(X)
            err = _serve_err(served, raw)
            flips += int((a != b).sum()) if a.shape == b.shape else sz
            if not err["bitwise"]:
                worst = {**err, "rows": sz, "offset": off,
                         "bucket": ctx.ladder.bucket_for(sz)}
                break
    return {"prediction_flips": flips, "first_difference": worst,
            "ok": flips == 0 and worst["bitwise"]}


def _time_dispatches(ctx):
    """Wrap ``ctx._dispatch`` (what the micro-batcher's worker calls once
    per flush) to record each call's host seconds and rows."""
    seconds, rows = [], []
    inner = ctx._dispatch

    def timed(kind, rec, arrays, n, *, meta):
        t0 = time.perf_counter()
        try:
            return inner(kind, rec, arrays, n, meta=meta)
        finally:
            seconds.append(time.perf_counter() - t0)
            rows.append(n)

    ctx._dispatch = timed
    return seconds, rows


def phase_serving(path, sess, full_model):
    """bench.py's serving configuration on the card: a 2^18-dim CTR model fit
    for one epoch on the CSV's first 4 chunks of 2^18 rows, a 2^19-row
    request pool, 120 requests log-uniform on [16, 8192] (default_rng(11))
    run raw, bucketed through the warmed 256..16384 ladder, and coalesced
    (the requests of <= 1024 rows, twice, from 16 threads); then the
    full-width model of the ``criteo`` phase through the same ladder."""
    from concurrent.futures import ThreadPoolExecutor

    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
    from orange3_spark_tpu_torch.utils.profiling import (
        graph_capture_count, reset_serve_counters, serve_counters,
    )

    chunk = CRITEO["chunk_rows"]
    model, head = _serve_model(path, sess, SERVE_DIMS, chunk, SERVE_FIT_CHUNKS)
    pool = _request_pool(head, SERVE_POOL_ROWS)
    trace = _serve_trace(pool.shape[0])
    total_rows = sum(s for _, s in trace)
    ladder = BucketLadder(**SERVE_LADDER)

    c0 = graph_capture_count()
    lat_raw, wall_raw, out_raw = _run_trace(model, pool, trace)
    captures_raw = graph_capture_count() - c0

    reset_serve_counters()
    traced0 = _traced_requests_total()
    rung_bytes, rung_s = {}, {}
    with ServingContext(ladder) as ctx:
        c0 = graph_capture_count()
        t0 = time.perf_counter()
        warmed = 0
        for b in ladder.buckets():    # one rung at a time: its bytes and seconds
            b0, t1 = ctx.cache.device_bytes(), time.perf_counter()
            warmed += ctx.warmup(model, n_cols=pool.shape[1], buckets=[b])["compiled"]
            rung_s[b], rung_bytes[b] = time.perf_counter() - t1, ctx.cache.device_bytes() - b0
        warmup_s = time.perf_counter() - t0
        lat_b, wall_b, out_b = _run_trace(model, pool, trace)
        captures_b = graph_capture_count() - c0
        sc = serve_counters()
        traced = _traced_requests_total() - traced0
        c1 = graph_capture_count()
        _run_trace(model, pool, trace)
        repeat_captures = graph_capture_count() - c1
        breakers = ctx.breaker_states()

    small = [(o, s) for o, s in trace if s <= 1024] * 2
    mb_rows = sum(s for _, s in small)
    with ServingContext(ladder, micro_batch=True, max_batch=8192, max_wait_ms=2.0) as ctx_mb:
        ctx_mb.warmup(model, n_cols=pool.shape[1])
        mb_dispatch_s, mb_flush_rows = _time_dispatches(ctx_mb)
        reset_serve_counters()
        with ThreadPoolExecutor(16) as ex:
            t0 = time.perf_counter()
            futs = [ex.submit(model.predict, pool[o:o + s]) for o, s in small]
            mb_out = [f.result() for f in futs]
            wall_mb = time.perf_counter() - t0
        breakers_mb = ctx_mb.breaker_states()
        mb_wait_ms_end = ctx_mb.micro_batcher._adapt.current_wait_s() * 1e3
    mb = serve_counters()

    # the full-width model of the criteo phase through the same ladder
    with ServingContext(ladder) as ctx_full:
        t0 = time.perf_counter()
        warm_full = ctx_full.warmup(full_model, n_cols=pool.shape[1])
        warmup_full_s = time.perf_counter() - t0
        reset_serve_counters()
        lat_f, wall_f, out_f = _run_trace(full_model, pool, trace)
        sc_full = serve_counters()
        breakers_full = ctx_full.breaker_states()
    _, _, out_f_raw = _run_trace(full_model, pool, trace)

    vs_raw = {"n_dims_%d" % m.params.n_dims: _trace_check(m, pool, trace, got, want,
                                                         ServingContext(ladder))
              for m, got, want in ((model, out_b, out_raw), (full_model, out_f, out_f_raw))}
    predictions_ok = (all(v["ok"] for v in vs_raw.values())
                      and all(o.shape == (s,) for (_, s), o in zip(small, mb_out)))
    line = {
        "metric": "criteo_serving_predict_rows_per_sec_per_chip",
        "value": total_rows / wall_b / 1, "unit": "rows/s/chip",
        "requests": len(trace), "distinct_sizes": len({s for _, s in trace}),
        "trace_rows": total_rows, "n_dims": SERVE_DIMS, "fit_chunks": SERVE_FIT_CHUNKS,
        "pool_rows": pool.shape[0], "ladder": list(ladder.buckets()),
        "cuts": ({"pool_rows": f"{SERVE_POOL_ROWS} -> {pool.shape[0]} (--criteo-rows)"}
                 if pool.shape[0] < SERVE_POOL_ROWS else None),
        "graph_captures": captures_b, "graph_captures_unbucketed": captures_raw,
        "graph_captures_repeat": repeat_captures,
        "compile_reduction": ("no ratio: the eager raw path captures no graph (and "
                              "compiles nothing); the bucketed path captures one "
                              "graph per rung, warm-up included"),
        "p50_ms": _pctl(lat_b, 50), "p99_ms": _pctl(lat_b, 99), "wall_s": wall_b,
        "warmup_s": warmup_s, "warmup_buckets": warmed,
        "warmup_s_per_rung": {str(b): v for b, v in rung_s.items()},
        "device_bytes_per_rung": {str(b): v for b, v in rung_bytes.items()},
        "bucket_hits": sc["bucket_hits"], "bucket_misses": sc["bucket_misses"],
        "aot_hits": sc["aot_hits"], "graph_replays": sc["graph_replays"],
        "pad_overhead": sc["pad_overhead"],
        "p50_ms_unbucketed": _pctl(lat_raw, 50), "p99_ms_unbucketed": _pctl(lat_raw, 99),
        "wall_s_unbucketed": wall_raw,
        "unbucketed_rows_per_sec_per_chip": total_rows / wall_raw / 1,
        "mb_requests": mb["mb_requests"], "mb_batches": mb["mb_batches"],
        "mb_merge_factor": mb["mb_merge_factor"],
        "mb_rows_per_sec_per_chip": mb_rows / wall_mb / 1,
        # one worker thread flushes: its wall is the dispatches plus the
        # coalescing windows (and the concatenation and scatter around them)
        "mb_wall_s": wall_mb, "mb_dispatch_s": sum(mb_dispatch_s),
        "mb_dispatch_ms_per_batch": 1e3 * sum(mb_dispatch_s) / max(len(mb_dispatch_s), 1),
        "mb_rest_ms_per_batch": 1e3 * (wall_mb - sum(mb_dispatch_s)) / max(len(mb_dispatch_s), 1),
        "mb_rows_per_batch": sum(mb_flush_rows) / max(len(mb_flush_rows), 1),
        "mb_max_wait_ms_at_end": mb_wait_ms_end,
        "traced_requests": traced, "trace_coverage": traced / len(trace),
        "full_width": {"n_dims": full_model.params.n_dims, "value": total_rows / wall_f / 1,
                       "p50_ms": _pctl(lat_f, 50), "p99_ms": _pctl(lat_f, 99),
                       "wall_s": wall_f, "warmup_s": warmup_full_s,
                       "warmup_buckets": warm_full["compiled"],
                       "graph_replays": sc_full["graph_replays"]},
        "breakers": {**breakers, **breakers_mb, **breakers_full},
        "served_vs_raw": vs_raw,
        "tolerance": "bitwise",
        "predictions_equal_raw": predictions_ok,
    }
    dispatches = sc["bucket_hits"] + sc["bucket_misses"]
    problems = [name for name, bad in (
        ("warmup_buckets", warmed != len(ladder.buckets())),
        ("graph_captures", captures_b > len(ladder.buckets()) or repeat_captures != 0),
        ("graph_replays", sc["graph_replays"] != dispatches or dispatches != len(trace)
         or sc_full["graph_replays"] != len(trace)),
        ("mb_merge_factor", not (mb["mb_merge_factor"] or 0) > 1),
        ("mb_graph_replays", mb["graph_replays"] != mb["mb_batches"]),
        ("breakers", bool(line["breakers"])),
        ("build_failures", sc["build_failures"] + mb["build_failures"]
         + sc_full["build_failures"] != 0),
        ("predictions", not predictions_ok)) if bad]
    if problems:
        raise AssertionError(f"serving: {problems}: {line}")
    return model, pool, line


def phase_serving_profile(model, pool):
    """Where one bucketed request's time goes, at 256 and 8192 rows: the
    whole served call (host clock), and inside it the host copy of the
    request into the bucket's static input (host clock and CUDA events),
    the pad zeroing, the graph's device time, the copy of the result back,
    and the rest (Python: routing, the cache, counters); the launches in
    the graph (torch.profiler over one replay)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
    from orange3_spark_tpu_torch.serve.context import _fingerprint, _rows

    ladder = BucketLadder(**SERVE_LADDER)
    reps = 50
    out = {}
    with ServingContext(ladder) as ctx:
        for n in (256, 8192):
            ctx.warmup(model, n_cols=pool.shape[1], buckets=[ladder.bucket_for(n)])
            key = ("array", _fingerprint(model), ladder.bucket_for(n), pool.shape[1],
                   "float32", str(model.device))
            prog = ctx.cache.get_or_build(key, lambda: None)
            X = pool[:n]
            total = []
            for _ in range(reps):
                t0 = time.perf_counter()
                model.predict(X)
                total.append((time.perf_counter() - t0) * 1e3)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            stages = {k: [] for k in ("host_prep_ms", "h2d_host_ms", "h2d_ms", "pad_zero_ms",
                                      "graph_ms", "d2h_ms", "d2h_host_ms", "parts_host_ms")}
            buf, outs = prog.inputs[0], prog.outputs
            for _ in range(reps):
                t0 = time.perf_counter()
                src = _rows(X, n)
                t1 = time.perf_counter()
                ev[0].record()
                buf[:n].copy_(src)
                ev[1].record()
                t2 = time.perf_counter()
                if n < prog.n_pad:
                    buf[n:].zero_()
                ev[2].record()
                prog.graph.replay()
                ev[3].record()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                res = outs[:n].cpu().numpy()
                ev[4].record()
                t4 = time.perf_counter()
                torch.cuda.synchronize()
                stages["host_prep_ms"].append((t1 - t0) * 1e3)
                stages["h2d_host_ms"].append((t2 - t1) * 1e3)
                stages["h2d_ms"].append(ev[0].elapsed_time(ev[1]))
                stages["pad_zero_ms"].append(ev[1].elapsed_time(ev[2]))
                stages["graph_ms"].append(ev[2].elapsed_time(ev[3]))
                stages["d2h_ms"].append(ev[3].elapsed_time(ev[4]))
                stages["d2h_host_ms"].append((t4 - t3) * 1e3)
                stages["parts_host_ms"].append((t4 - t0) * 1e3)
            assert res.shape == (n, 1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prog.graph.replay()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            by_name: dict = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            med = {k: float(np.median(v)) for k, v in stages.items()}
            served_ms = float(np.median(total))
            out[str(n)] = {"bucket": prog.n_pad, "served_ms_median": served_ms,
                           "served_ms_p99": float(np.percentile(total, 99)), **med,
                           "python_overhead_ms": served_ms - med["parts_host_ms"],
                           "graph_launches": len(kernels) if kernels else "not measured",
                           "graph_kernels_us": {k[:90]: v for k, v in sorted(
                               by_name.items(), key=lambda kv: -kv[1])[:8]},
                           "reps": reps}
    return out


# ------------------------------------------------------ the dense linear family
# (BASELINE config 1 and bench.py --config dense_logreg: PyTorch ops, no
# kernel of the package: the products are torch.mm, as the reference's are
# XLA's dot)
# card against the port's CPU path: the first iterations agree to float32
# summation order (cuBLAS against MKL), converged fits at the optimum
LINEAR_FIRST_RTOL, LINEAR_CONVERGED_RTOL, LINEAR_LOSS_RTOL = 1e-4, 1e-3, 1e-5
LINEAR_NORMAL_RTOL, LINEAR_PVALUE_ATOL, LINEAR_METRIC_ATOL = 1e-4, 1e-5, 1e-5
IRIS_ACC_FLOOR = 0.96
# bench_dense_logreg (bench.py:1268-1312)
DENSE_LOGREG = dict(rows=4_000_000, features=40, max_iter=20, tol=0.0, reg_param=1e-6)
# the converging settings of tests/test_torch_linear.py: (loss, classes,
# reg_l2, reg_l1, tol); hinge and OWLQN stop on looser tols: a non-smooth
# objective's gradient never falls below 1e-5, and OWLQN's iterate freezes
# once its Armijo test sees the loss flat to a float32 ulp, at a
# pseudo-gradient floor that float32 sums set (1.4e-6 to 1.4e-5 across the
# devices and the reference: probes/owlqn_trace.py), so whether a run stops
# at 1e-5 is chance
LINEAR_LOSSES = [("logistic", 3, 1e-2, None, 1e-5), ("logistic", 2, 1e-2, None, 1e-5),
                 ("hinge", 2, 1e-2, None, 1e-2), ("squared_hinge", 2, 1e-2, None, 1e-5),
                 ("squared", 2, 1e-2, None, 1e-5), ("logistic", 3, 0.05, 0.05, 1e-3)]
# the bf16 arm's card-only products (torch.mm with an f32 result, G's
# three-part split) against the CPU's widened ones, first iterations only:
# (classes, reg_l2); converged bf16 fits are not compared: the loss that
# bf16-rounded coefficients give is flat there
LINEAR_BF16 = [(3, 1e-2), (2, 1e-2)]
OWLQN_TOL = 1e-3


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (both moved to the host)."""
    import numpy as np

    got, want = (np.asarray(v.detach().cpu() if hasattr(v, "detach") else v, np.float64)
                 for v in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _linear_fit_pair(tables, loss, k, reg_l2, reg_l1, tol, max_iter, scale,
                     dtype="float32"):
    """fit_linear on the card and on the CPU: (card, cpu) results."""
    from orange3_spark_tpu_torch.models import _linear as lin

    out = []
    for t in tables:
        y = t.y if loss in ("logistic", "squared") else (t.y > 0).float()
        s = lin.column_inv_std(t.X, t.W) if scale else None
        out.append(lin.fit_linear(t.X, y, t.W, reg_l2, tol, max_iter, s, reg_l1,
                                  loss_kind=loss, k=k, compute_dtype=dtype))
    return out


def _first_iterations_line(card, host, iters) -> dict:
    """A card fit against the CPU's after ``iters`` iterations: the errors
    beside LINEAR_FIRST_RTOL, and ``ok``."""
    line = {"iters": iters, "n_iter": [card.n_iter, host.n_iter],
            "coef_err": _rel_err(card.coef, host.coef),
            "intercept_err": _rel_err(card.intercept, host.intercept),
            "loss_err": abs(card.final_loss - host.final_loss) / max(abs(host.final_loss), 1e-30),
            "rtol": LINEAR_FIRST_RTOL, "loss_rtol": LINEAR_FIRST_RTOL}
    line["ok"] = bool(max(line["coef_err"], line["intercept_err"], line["loss_err"])
                      <= LINEAR_FIRST_RTOL and card.n_iter == host.n_iter == iters)
    return line


def _linear_predictions(res, X, loss):
    """Class (or value, for 'squared') of each row from a fit's coefficients."""
    import numpy as np

    z = X @ res.coef.cpu().numpy() + res.intercept.cpu().numpy()
    if loss == "logistic":
        return np.argmax(z, axis=1)
    return z[:, 0] if loss == "squared" else z[:, 0] > 0


def _served_equal(model, tables, sess, ctx_kw) -> dict:
    """A LogisticRegressionModel's predict and transform through a
    ServingContext against its raw calls on the card, at one request size
    in every rung of a 64..2048 ladder, again after allocator churn."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
    from orange3_spark_tpu_torch.utils.profiling import graph_capture_count

    raw = {n: (model.predict(t), model.transform(t).X.cpu().numpy())
           for n, t in tables.items()}
    with ServingContext(BucketLadder(min_bucket=64, max_bucket=2048), **ctx_kw) as ctx:
        c0 = graph_capture_count()
        served = {n: (model.predict(t), model.transform(t).X.cpu().numpy())
                  for n, t in tables.items()}
        captures = graph_capture_count() - c0
        junk = [torch.full((1 << 18,), -7, dtype=torch.int64, device=sess.device)
                for _ in range(64)]
        del junk
        again = {n: (model.predict(t), model.transform(t).X.cpu().numpy())
                 for n, t in tables.items()}
        repeat = graph_capture_count() - c0 - captures
        routes = sorted({key[0] for key in ctx.cache.keys()})
        breakers = ctx.breaker_states()
    out = {"sizes": sorted(tables), "graph_captures": captures,
           "graph_captures_repeat": repeat, "routes": routes, "breakers": breakers}
    for name, got in (("served", served), ("after_churn", again)):
        out[name] = {str(n): {"predict_bitwise": bool(np.array_equal(got[n][0], raw[n][0])),
                              "transform_bitwise": bool(np.array_equal(got[n][1], raw[n][1])),
                              "transform_max_abs_err": float(np.abs(
                                  got[n][1].astype(np.float64) - raw[n][1]).max())}
                     for n in tables}
    out["bitwise"] = all(v["predict_bitwise"] and v["transform_bitwise"]
                         for name in ("served", "after_churn") for v in out[name].values())
    return out


def phase_linear_check(sess):
    """The dense linear family on the card against the port's CPU path at a
    small size (Iris; ``make_classification`` 4096 x 16, 2 and 3 classes):
    ``fit_linear`` for each loss with and without the column scale after
    1, 2 and 3 iterations and converged (coef, intercept, loss; converged:
    the same predictions); the bf16 arm (2 and 3 classes, with and
    without the scale) after 1, 2 and 3 iterations; OWLQN at
    elastic_net_param=0.5 (the same exactly-zero coefficients); LinearRegression 'normal' with its
    p-values; the three evaluators; a Pipeline of one LogisticRegression;
    the fitted LogisticRegressionModel served at every rung of a ladder,
    predict and transform bitwise equal to raw. Each max |err| stands
    beside its tolerance; TF32 must be off for the f32 products."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchSession, TorchTable
    from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
    from orange3_spark_tpu_torch.datasets import load_iris, make_classification
    from orange3_spark_tpu_torch.models.base import Pipeline
    from orange3_spark_tpu_torch.models.evaluation import (
        BinaryClassificationEvaluator, MulticlassClassificationEvaluator,
        RegressionEvaluator,
    )
    from orange3_spark_tpu_torch.models.linear_regression import LinearRegression
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matmuls; the f32 fits need it off")
    cpu = TorchSession("cpu")
    both = (sess, cpu)
    data = {"iris": [load_iris(s) for s in both],
            2: [make_classification(4096, 16, 2, seed=0, session=s) for s in both],
            3: [make_classification(4096, 16, 3, seed=1, session=s) for s in both]}
    failed, fits = [], []

    def check(name, ok):
        if not ok:
            failed.append(name)

    for loss, k, reg_l2, reg_l1, tol in LINEAR_LOSSES:
        for scale in (False, True):
            for iters in (1, 2, 3, 500):
                card, host = _linear_fit_pair(data[k], loss, k if loss == "logistic" else 1,
                                              reg_l2, reg_l1, tol, iters, scale)
                conv = iters == 500
                tol_c = LINEAR_CONVERGED_RTOL if conv else LINEAR_FIRST_RTOL
                line = {"loss": loss, "k": k, "l1": reg_l1, "scale": scale,
                        "iters": "converged" if conv else iters,
                        "n_iter": [card.n_iter, host.n_iter],
                        "coef_err": _rel_err(card.coef, host.coef),
                        "intercept_err": _rel_err(card.intercept, host.intercept),
                        "loss_err": abs(card.final_loss - host.final_loss)
                        / max(abs(host.final_loss), 1e-30), "rtol": tol_c,
                        "loss_rtol": LINEAR_LOSS_RTOL if conv else LINEAR_FIRST_RTOL}
                ok = (line["coef_err"] <= tol_c and line["intercept_err"] <= tol_c
                      and line["loss_err"] <= line["loss_rtol"])
                if conv:
                    ok = ok and card.n_iter < 500 and host.n_iter < 500
                    X = data[k][1].X.numpy()
                    pc, ph = (_linear_predictions(r, X, loss) for r in (card, host))
                    line["predictions_equal"] = bool(
                        np.allclose(pc, ph, rtol=1e-4, atol=1e-5) if loss == "squared"
                        else np.array_equal(pc, ph))
                    ok = ok and line["predictions_equal"]
                else:
                    ok = ok and card.n_iter == host.n_iter == iters
                if reg_l1 is not None:
                    line["zeros"] = [int((r.coef == 0).sum()) for r in (card, host)]
                    line["zero_set_equal"] = bool(np.array_equal(
                        card.coef.cpu().numpy() == 0, host.coef.numpy() == 0))
                    ok = ok and line["zero_set_equal"]
                line["ok"] = bool(ok)
                check(f"fit_linear {loss} k={k} scale={scale} iters={iters}", ok)
                fits.append(line)
    # the bf16 arm step for step: the card's products against the CPU's
    for k, reg_l2 in LINEAR_BF16:
        for scale in (False, True):
            for iters in (1, 2, 3):
                card, host = _linear_fit_pair(data[k], "logistic", k, reg_l2, None, 1e-6,
                                              iters, scale, dtype="bfloat16")
                line = {"loss": "logistic", "k": k, "dtype": "bfloat16", "scale": scale,
                        **_first_iterations_line(card, host, iters)}
                check(f"fit_linear bf16 k={k} scale={scale} iters={iters}", line["ok"])
                fits.append(line)
    # Iris, BASELINE config 1's setting, step for step
    for iters in (1, 2, 3):
        card, host = _linear_fit_pair(data["iris"], "logistic", 3, 1e-4, None, 1e-6,
                                      iters, True)
        err = _rel_err(card.coef, host.coef)
        fits.append({"loss": "logistic", "data": "iris", "iters": iters, "coef_err": err,
                     "rtol": LINEAR_FIRST_RTOL, "ok": err <= LINEAR_FIRST_RTOL})
        check(f"iris iters={iters}", err <= LINEAR_FIRST_RTOL)

    # OWLQN through the estimator: the same exactly-zero coefficients
    en = [LogisticRegression(reg_param=0.1, elastic_net_param=0.5, max_iter=500,
                             tol=OWLQN_TOL).fit(t) for t in data[3]]
    owlqn = {"zeros": [int((m.coef == 0).sum()) for m in en],
             "zero_set_equal": bool(np.array_equal(en[0].coef.cpu().numpy() == 0,
                                                   en[1].coef.numpy() == 0)),
             "coef_err": _rel_err(en[0].coef, en[1].coef), "rtol": LINEAR_CONVERGED_RTOL,
             "n_iter": [en[0].n_iter_, en[1].n_iter_], "tol": OWLQN_TOL}
    check("owlqn zero set", owlqn["zero_set_equal"] and owlqn["zeros"][1] > 0
          and owlqn["coef_err"] <= LINEAR_CONVERGED_RTOL and max(owlqn["n_iter"]) < 500)

    # LinearRegression 'normal' with its inference statistics
    rng = np.random.default_rng(5)
    Xr = rng.standard_normal((4096, 16)).astype(np.float32)
    yr = (Xr @ rng.standard_normal(16) + 0.3 + rng.standard_normal(4096)).astype(np.float32)
    dom = Domain([ContinuousVariable(f"x{i}") for i in range(16)], ContinuousVariable("y"))
    reg = [TorchTable.from_numpy(dom, Xr, yr, session=s) for s in both]
    lr = [LinearRegression().fit(t) for t in reg]
    normal = {"coef_err": _rel_err(lr[0].coef, lr[1].coef),
              "p_value_max_abs_err": float((lr[0].p_values_.cpu() - lr[1].p_values_).abs().max()),
              "t_value_err": _rel_err(lr[0].t_values_, lr[1].t_values_),
              "rtol": LINEAR_NORMAL_RTOL, "p_atol": LINEAR_PVALUE_ATOL,
              "p_values_card": lr[0].p_values_.cpu().tolist()}
    check("normal equations", normal["coef_err"] <= LINEAR_NORMAL_RTOL
          and normal["t_value_err"] <= LINEAR_NORMAL_RTOL
          and normal["p_value_max_abs_err"] <= LINEAR_PVALUE_ATOL)

    # the evaluators on each device's own scored tables
    kw = dict(max_iter=500, reg_param=1e-2, tol=1e-5)
    binom = [LogisticRegression(**kw).fit(t).transform(t) for t in data[2]]
    multi = [LogisticRegression(**kw).fit(t).transform(t) for t in data[3]]
    scored_reg = [m.transform(t) for m, t in zip(lr, reg)]
    evals = {}
    for name, ev, tabs in (
            ("areaUnderROC", BinaryClassificationEvaluator(metric_name="areaUnderROC"), binom),
            ("areaUnderPR", BinaryClassificationEvaluator(metric_name="areaUnderPR"), binom),
            *((m, MulticlassClassificationEvaluator(metric_name=m), multi)
              for m in ("accuracy", "f1", "weightedPrecision", "weightedRecall")),
            *((m, RegressionEvaluator(metric_name=m), scored_reg)
              for m in ("rmse", "mse", "mae", "r2"))):
        card_v, host_v = (ev.evaluate(t) for t in tabs)
        evals[name] = {"card": card_v, "cpu": host_v, "abs_err": abs(card_v - host_v)}
        check(f"evaluator {name}", abs(card_v - host_v) <= LINEAR_METRIC_ATOL)

    # a Pipeline of one LogisticRegression: its transform is the model's
    pipe = Pipeline([LogisticRegression(**kw)]).fit(data[3][0])
    direct = LogisticRegression(**kw).fit(data[3][0])
    pipeline = {"transform_bitwise_vs_direct_fit": bool(torch.equal(
        pipe.transform(data[3][0]).X, direct.transform(data[3][0]).X))}
    check("pipeline", pipeline["transform_bitwise_vs_direct_fit"])

    # the fitted model served at every rung, bitwise
    dom3 = data[3][0].domain
    X3 = data[3][1].X.numpy()
    tables = {n: TorchTable.from_numpy(dom3, X3[:n], data[3][1].y[:n].numpy(), session=sess)
              for n in (50, 100, 200, 300, 700, 1500)}
    serving = _served_equal(direct, tables, sess, {})
    check("served equal to raw", serving["bitwise"] and serving["graph_captures_repeat"] == 0
          and not serving["breakers"])
    serving_mb = _served_equal(direct, tables, sess, {"micro_batch": True, "max_batch": 2048})
    check("micro-batched served equal to raw", serving_mb["bitwise"])
    out = {"fits": fits, "owlqn": owlqn, "normal": normal, "evaluators": evals,
           "evaluator_atol": LINEAR_METRIC_ATOL, "pipeline": pipeline,
           "serving": serving, "serving_micro_batch": {"bitwise": serving_mb["bitwise"],
                                                       "breakers": serving_mb["breakers"]},
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "failed": failed}
    if failed:
        emit({"phase": "linear_check", **out})
        raise AssertionError(f"linear_check failed: {failed}")
    return out


def phase_iris(sess):
    """BASELINE config 1 on the card: LogisticRegression(max_iter=200,
    reg_param=1e-4) on Iris, a warm-up fit, then the timed fit: accuracy
    (floor 0.96), iterations, objective evaluations and host reads."""
    import numpy as np

    from orange3_spark_tpu_torch.datasets import load_iris
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression

    iris = load_iris(sess)
    est = LogisticRegression(max_iter=200, reg_param=1e-4)
    est.fit(iris)
    sess.synchronize()
    t0 = time.perf_counter()
    model = est.fit(iris)
    sess.synchronize()
    fit_s = time.perf_counter() - t0
    acc = float(np.mean(model.predict(iris) == iris.y.cpu().numpy()))
    if acc < IRIS_ACC_FLOOR:
        raise AssertionError(f"Iris accuracy {acc} below {IRIS_ACC_FLOOR}")
    return {"accuracy": acc, "accuracy_floor": IRIS_ACC_FLOOR, "n_iter": model.n_iter_,
            "fit_s": fit_s, "n_evals": model.n_evals_, "host_reads": model.host_reads_,
            "evals_per_iter": model.n_evals_ / model.n_iter_,
            "host_reads_per_iter": model.host_reads_ / model.n_iter_,
            "ms_per_host_read": fit_s * 1e3 / model.host_reads_}


def _dense_logreg_arm(table, y, dtype, mem_bw):
    """One arm of dense_logreg: a warm-up fit, the timed fit, a profiled
    fit, one objective evaluation at the fitted coefficients, accuracy, and
    the fitted model's predict over the whole table."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orange3_spark_tpu_torch.models._linear import (
        LinearObjective, column_inv_std, dense_logits,
    )
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression

    cfg = DENSE_LOGREG
    sess = table.session
    est = LogisticRegression(max_iter=cfg["max_iter"], tol=cfg["tol"],
                             reg_param=cfg["reg_param"], compute_dtype=dtype)
    est.fit(table)
    sess.synchronize()
    t0 = time.perf_counter()
    model = est.fit(table)
    sess.synchronize()
    wall = time.perf_counter() - t0
    iters = model.n_iter_
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.fit(table)
        sess.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    events, by_name, busy = _device_profile(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    # one evaluation of the objective (value and gradient) at the fit's end
    s = column_inv_std(table.X, table.W)
    obj = LinearObjective(table.X, table.y, table.W, cfg["reg_param"], s,
                          loss_kind="logistic", k=2, fit_intercept=True,
                          compute_dtype=getattr(torch, dtype))
    theta = torch.cat([(model.coef / s[:, None]).reshape(-1), model.intercept])
    eval_ms = graph_ms(lambda: obj.value_and_grad(theta), 10)
    eval_eager_ms = cuda_ms(lambda: obj.value_and_grad(theta), 20, warmup=3)
    x_bytes = obj.Xc.numel() * obj.Xc.element_size()
    del obj
    # predict over all rows: its wall (the D2H of the predictions included),
    # the temporary it needs, and the logits' device time beside their byte
    # bound and beside the library's product
    pred = model.predict(table)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = model.predict(table)
    predict_s = time.perf_counter() - t0
    predict_temp = torch.cuda.max_memory_allocated() - base
    acc = float(np.mean(pred == y))
    coef = model.coef
    logits_bytes = table.X.numel() * 4 + table.n_rows * coef.shape[1] * 4
    predict = {"predict_s": predict_s, "predict_temp_bytes": predict_temp,
               "logits_ms": cuda_ms(lambda: dense_logits(table.X, coef), 10, warmup=2),
               "logits_bound_ms": logits_bytes / mem_bw * 1e3,
               "logits_library_ms": cuda_ms(lambda: table.X @ coef, 10, warmup=2),
               "logits_library": "torch.mm (X @ coef, f32, TF32 off)"}
    return {"metric": "logreg_fit_rows_per_sec_per_chip",
            "value": table.n_rows * iters / wall / sess.n_devices, "unit": "rows/s/chip",
            "fit_wall_s": wall, "n_iter": iters, "n_evals": model.n_evals_,
            "iter_evals": list(model.iter_evals_),
            "host_reads": model.host_reads_, "evals_per_iter": model.n_evals_ / iters,
            "host_reads_per_iter": model.host_reads_ / iters,
            "ms_per_iter": wall * 1e3 / iters,
            "profiled_fit_wall_s": prof_wall_us / 1e6, "device_busy_s": busy / 1e6,
            "device_idle_share": (1 - busy / prof_wall_us) if events else "not measured",
            "device_kernels": len(events),
            "top_kernels": [{"name": n[:90], "ms": v[0] / 1e3, "launches": v[1]}
                            for n, v in top],
            "eval_ms": eval_ms, "eval_eager_ms": eval_eager_ms,
            "eval_bytes": 2 * x_bytes, "eval_bound_ms": 2 * x_bytes / mem_bw * 1e3,
            "eval_bound": "X read twice (the forward and the gradient product)",
            "train_accuracy": acc, **predict}


def phase_dense_logreg(sess, mem_bw):
    """``bench.py --config dense_logreg`` at full width on the card (4M x 40
    f32 rows from ``default_rng(0)``, the same labels; LogisticRegression
    max_iter=20, tol=0, reg_param=1e-6): the bf16 arm, as bench.py runs
    it, then an f32 arm. Per arm: ``value`` (rows x iterations / fit wall
    / cards), evaluations (in all and by iteration) and host reads per
    iteration, the device's busy and idle share of a profiled fit, one
    objective evaluation's device time beside its byte bound, training
    accuracy, and predict over the 4M rows (wall, temporary bytes, the
    logits' device time beside their byte bound and ``X @ coef``'s)."""
    import numpy as np

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.core.domain import (
        ContinuousVariable, DiscreteVariable, Domain,
    )

    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matmuls; the f32 arm needs it off")
    cfg = DENSE_LOGREG
    n, d = cfg["rows"], cfg["features"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, d), dtype=np.float32)
    true_w = rng.standard_normal((d,)).astype(np.float32)
    y = (X @ true_w + 0.5 * rng.standard_normal(n).astype(np.float32) > 0).astype(np.float32)
    domain = Domain([ContinuousVariable(f"f{i}") for i in range(d)],
                    DiscreteVariable("click", ("0", "1")))
    table = TorchTable.from_numpy(domain, X, y, session=sess)
    del X
    data_s = time.perf_counter() - t0
    arms = {dtype: _dense_logreg_arm(table, y, dtype, mem_bw)
            for dtype in ("bfloat16", "float32")}
    return {**arms["bfloat16"], "data_s": data_s, "rows": n, "features": d,
            "config": {**cfg, "compute_dtype": "bfloat16"}, "cuts": None,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "f32_arm": arms["float32"]}


# ------------------------------------------------ the taxi feature pipeline
# BASELINE config 5 (bench_suite.py:193-238, bench.py:3203-3411): OWTable ->
# OWStandardScaler(with_mean) -> OWPCA(k=4) -> OWKMeans(k=10, max_iter=10)
TAXI_ROWS = 10_000_000
TAXI_CHECK_ROWS = 200_000
TAXI_LADDER = dict(min_bucket=64, max_bucket=512)
TAXI_STREAM_CHUNK = 1 << 16
# the card against the port's CPU path (taxi_check)
TAXI_SCALER_RTOL, TAXI_PCA_ATOL, TAXI_CENTERS_ATOL, TAXI_IDS_SHARE = 1e-6, 1e-5, 1e-4, 0.9999


def _taxi_graph(table):
    from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY, OWTable
    from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

    g = WorkflowGraph()
    src = g.add(OWTable(table))
    sc = g.add(WIDGET_REGISTRY["OWStandardScaler"](with_mean=True))
    pca = g.add(WIDGET_REGISTRY["OWPCA"](k=4))
    km = g.add(WIDGET_REGISTRY["OWKMeans"](k=10, max_iter=10))
    g.connect(src, "data", sc, "data")
    g.connect(sc, "data", pca, "data")
    g.connect(pca, "data", km, "data")
    return g, src, sc, pca, km


def _sign_aligned(got, ref):
    """``got``'s columns, each negated where that aligns it with ``ref``'s
    (an eigenvector's sign is arbitrary in every solver)."""
    import torch

    s = torch.sign((got * ref).sum(dim=0))
    return got * torch.where(s == 0, 1.0, s)


def _bits_equal(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    # the bits, so NaNs and signed zeros compare as they are stored
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                       b.reshape(-1).contiguous().view(torch.uint8))


def _table_bits_equal(a, b) -> bool:
    return all(_bits_equal(x, y) for x, y in ((a.X, b.X), (a.Y, b.Y), (a.W, b.W)))


def _served_taxi(wf, models, X, dom, sess, ladder):
    """Fused, stage-by-stage and raw at one request size in every rung of
    ``ladder``: {n: {fused_equal_raw, stagewise_equal_raw, transform_equal,
    dispatch_fused, dispatch_staged}}."""
    import numpy as np

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
    from orange3_spark_tpu_torch.utils.profiling import reset_serve_counters, serve_counters

    def dispatches():
        c = serve_counters()
        return c.get("bucket_hits", 0) + c.get("bucket_misses", 0)

    scaler, pca, km = models
    out = {}
    rungs = list(BucketLadder(**ladder).buckets())
    sizes = [1] + [r - r // 3 for r in rungs] + [rungs[-1]]
    for n in sizes:
        t = TorchTable.from_numpy(dom, X[:n], session=sess)
        raw = km.predict(pca.transform(scaler.transform(t)))
        raw_tr = km.transform(pca.transform(scaler.transform(t)))
        with ServingContext(BucketLadder(**ladder)):
            reset_serve_counters()
            fused = wf.predict(t)
            d_fused = dispatches()
            fused_tr = wf.transform(t)
            os.environ["OTPU_WORKFLOW_SERVE"] = "0"
            try:
                reset_serve_counters()
                staged = wf.predict(t)
                d_staged = dispatches()
            finally:
                os.environ.pop("OTPU_WORKFLOW_SERVE", None)
        out[str(n)] = {"fused_equal_raw": bool(np.array_equal(fused, raw)),
                       "stagewise_equal_raw": bool(np.array_equal(staged, raw)),
                       "transform_equal_raw": _bits_equal(fused_tr.X, raw_tr.X),
                       "dispatch_fused": d_fused, "dispatch_staged": d_staged}
    return out


def _pca_agreement(pca_g, pca_c, s_g, s_c) -> dict:
    """The card's principal components against the CPU's, each column
    sign-aligned. A component is held to ``TAXI_PCA_ATOL``, or, where its
    eigenvalue lies close to another, to the Davis–Kahan bound of how far
    an eigenvector may move: sqrt(2)·‖ΔC‖₂ / gap, with ΔC the difference of
    the two covariances (float32 sums in two orders) plus each solver's
    backward error (d·eps32·‖C‖₂). The taxi table standardizes five
    independent columns to unit variance, so PC2-PC4 sit among eigenvalues
    0.993-1.007: there no float32 solver fixes the eigenvector to 1e-5."""
    import numpy as np

    from orange3_spark_tpu_torch.parallel.collectives import distributed_gramian

    def cov(t):
        G, _, tot = distributed_gramian(t.X, t.W)
        return (G / tot).double().cpu().numpy()

    cg, cc = cov(s_g), cov(s_c)
    lam = np.linalg.eigvalsh(cc)[::-1]
    norm = float(np.linalg.norm(cc, 2))
    eps32 = float(np.finfo(np.float32).eps)
    delta = float(np.linalg.norm(cg - cc, 2)) + 2 * cc.shape[0] * eps32 * norm
    comp_c = pca_c.components.double()
    aligned = _sign_aligned(pca_g.components.cpu().double(), comp_c)
    errs, tols, gaps = [], [], []
    for i in range(comp_c.shape[1]):
        gap = float(np.min(np.abs(np.delete(lam, i) - lam[i])))
        errs.append(float((aligned[:, i] - comp_c[:, i]).abs().max()))
        tols.append(max(TAXI_PCA_ATOL, float(np.sqrt(2.0) * delta / gap)))
        gaps.append(gap)
    return {"component_max_abs_err": errs, "component_tolerance": tols,
            "eigengap": gaps, "eigenvalues": lam.tolist(), "cov_delta_2norm": delta,
            "atol": TAXI_PCA_ATOL}


def phase_taxi_check(sess):
    """The feature pipeline on the card held to the port's CPU path at
    200,000 x 8 rows of the taxi generator (see the module docstring)."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchSession, TorchTable
    from orange3_spark_tpu_torch.datasets import make_taxi_proxy, taxi_domain
    from orange3_spark_tpu_torch.io.streaming import StreamingKMeans, array_chunk_source
    from orange3_spark_tpu_torch.models import kmeans as K
    from orange3_spark_tpu_torch.models.pca import PCA
    from orange3_spark_tpu_torch.models.preprocess import StandardScaler
    from orange3_spark_tpu_torch.serve import ServedWorkflow
    from orange3_spark_tpu_torch.workflow.staging import stage_graph

    X = make_taxi_proxy(TAXI_CHECK_ROWS)
    dom = taxi_domain()
    cpu = TorchSession("cpu")
    t_gpu = TorchTable.from_numpy(dom, X, session=sess)
    t_cpu = TorchTable.from_numpy(dom, X, session=cpu)
    failed = []

    def check(name, ok):
        if not ok:
            failed.append(name)

    # the scaler and PCA, fit on each device
    sc_g, sc_c = (StandardScaler(with_mean=True).fit(t) for t in (t_gpu, t_cpu))
    rel = lambda a, b: float(((a.cpu() - b).abs() / b.abs().clamp_min(1e-30)).max())  # noqa: E731
    scaler_err = max(rel(sc_g.shift, sc_c.shift), rel(sc_g.scale, sc_c.scale))
    check("scaler", scaler_err <= TAXI_SCALER_RTOL)
    s_g, s_c = sc_g.transform(t_gpu), sc_c.transform(t_cpu)
    pca_g, pca_c = PCA(k=4).fit(s_g), PCA(k=4).fit(s_c)
    pca_line = _pca_agreement(pca_g, pca_c, s_g, s_c)
    check("pca", all(e <= b for e, b in zip(pca_line["component_max_abs_err"],
                                            pca_line["component_tolerance"])))
    # KMeans on the same input on both devices: the CPU's projection
    z_c = pca_c.transform(s_c)
    z_g = TorchTable(z_c.domain, z_c.X.to(sess.device), None, z_c.W.to(sess.device),
                     None, z_c.n_rows, sess)
    est = K.KMeans(k=10, max_iter=10)
    seeds_g, seeds_c = est._init_centers(z_g), est._init_centers(z_c)
    check("seeded_centers_bitwise", _bits_equal(seeds_g.cpu(), seeds_c))
    km_g, km_c = est.fit(z_g), est.fit(z_c)
    centers_err = float((km_g.centers.cpu() - km_c.centers).abs().max())
    check("centers", centers_err <= TAXI_CENTERS_ATOL)
    ids_share = float(np.mean(km_g.predict(z_g) == km_c.predict(z_c)))
    check("cluster_ids", ids_share >= TAXI_IDS_SHARE)
    # Lloyd's fixed-trip form against the eager loop, on the card
    eager = K._lloyd(z_g.X, z_g.W, seeds_g, 1e-4, k=10, max_iter=10)
    fixed = K._lloyd_fixed(z_g.X, z_g.W, seeds_g, 1e-4, k=10, max_iter=10)
    lloyd_bitwise = (all(_bits_equal(a, b) for a, b in zip(eager[:3], fixed[:3]))
                     and int(fixed[3]) == eager[3])
    check("lloyd_fixed_trip_bitwise", lloyd_bitwise)
    # two fits of the whole graph on the card
    runs = []
    for _ in range(2):
        g, src, sc, pca, km = _taxi_graph(t_gpu)
        runs.append((g, g.run(), src, sc, pca, km))
    (g, outs, src, sc, pca, km), (_, outs2, *_) = runs
    two_fits = all(_bits_equal(outs[n]["model"].state_pytree[k], outs2[n]["model"].state_pytree[k])
                   for n in (sc, pca, km) for k in outs[n]["model"].state_pytree)
    check("two_fits_bitwise", two_fits and _table_bits_equal(outs[km]["data"], outs2[km]["data"]))
    # the staged transform against the eager widget walk, and two replays
    # of the staged refit
    staged = stage_graph(g, km)
    staged_out = staged()
    check("staged_equal_eager", _table_bits_equal(staged_out, outs[km]["data"]))
    refit = stage_graph(g, km, refit=True)
    r1, r2 = refit(), refit()
    check("refit_replays_bitwise", _table_bits_equal(r1, r2))
    check("refit_fallbacks", refit.refit_fallbacks == [])
    refit_ids = r1.X[: r1.n_rows, -1]
    # the staged refit's KMeans (device init) against the eager run of the
    # same init and fit on the card, inside staging(): same centers
    from orange3_spark_tpu_torch.models.base import staging

    with staging():
        dev_km = K.KMeans(k=10, max_iter=10).fit(outs[pca]["data"])
    dev_ids = dev_km.predict(outs[pca]["data"])
    check("refit_kmeans_equals_staged_eager_fit", bool(np.array_equal(
        refit_ids.cpu().numpy().astype(np.int32), dev_ids)))
    # StreamingKMeans: the cached (captured) replay against the re-streamed
    # per-chunk loop
    Z = z_c.X[: z_c.n_rows].numpy()
    skm = [StreamingKMeans(k=10, epochs=3, chunk_rows=TAXI_STREAM_CHUNK, seed=0).fit_stream(
        array_chunk_source(Z, chunk_rows=TAXI_STREAM_CHUNK), n_features=4, session=sess,
        cache_device=cache) for cache in (False, True)]
    check("streaming_cache_bitwise", _bits_equal(skm[0].centers, skm[1].centers)
          and skm[0].n_iter_ == skm[1].n_iter_)
    # served fused = stage by stage = raw at every rung
    models = [outs[n]["model"] for n in (sc, pca, km)]
    wf = ServedWorkflow.from_stages(models, t_gpu, name="taxi-check")
    served = _served_taxi(wf, models, X, dom, sess, TAXI_LADDER)
    check("served_bitwise", all(v["fused_equal_raw"] and v["stagewise_equal_raw"]
                                and v["transform_equal_raw"] for v in served.values()))
    check("served_dispatches", all(v["dispatch_fused"] == 1 and v["dispatch_staged"] == 3
                                   for v in served.values()))
    line = {"rows": TAXI_CHECK_ROWS,
            "scaler_max_rel_err": scaler_err, "scaler_rtol": TAXI_SCALER_RTOL,
            "pca_components_sign_aligned": pca_line,
            "seeded_centers_bitwise": "seeded_centers_bitwise" not in failed,
            "centers_max_abs_err": centers_err, "centers_atol": TAXI_CENTERS_ATOL,
            "cluster_ids_equal_share": ids_share, "cluster_ids_floor": TAXI_IDS_SHARE,
            "kmeans_n_iter": [km_g.n_iter_, km_c.n_iter_],
            "lloyd_fixed_trip_bitwise": lloyd_bitwise, "two_fits_bitwise": two_fits,
            "staged_segments": staged.segments, "refit_segments": refit.segments,
            "refit_graph_segments": refit.graph_segments,
            "streaming_n_iter": skm[0].n_iter_, "served": served, "failed": failed}
    if failed:
        emit({"phase": "taxi_check", **line})
        raise AssertionError(f"taxi_check failed: {failed}")
    del t_cpu, runs, g, outs, outs2, staged, refit
    torch.cuda.empty_cache()
    return line


def _profile_run(fn, exclude=()):
    """(wall us, device events, by name, busy us) of one ``fn()`` under
    torch.profiler; device events named in ``exclude`` (a wrapper's own
    profiler range) left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events, by_name, busy = _device_profile(prof, exclude)
    return wall_us, events, by_name, busy


def phase_taxi_pipeline(sess, X):
    """``bench_suite.py:193-238`` at scale 1.0 plus ``bench.py``'s streaming
    and serving arms, on the card, with bench's key names."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.datasets import taxi_domain
    from orange3_spark_tpu_torch.io.streaming import StreamingKMeans, array_chunk_source
    from orange3_spark_tpu_torch.models.pca import PCA
    from orange3_spark_tpu_torch.models.preprocess import StandardScaler
    from orange3_spark_tpu_torch.serve import BucketLadder, ServedWorkflow, ServingContext
    from orange3_spark_tpu_torch.utils.profiling import reset_serve_counters, serve_counters
    from orange3_spark_tpu_torch.workflow.staging import stage_graph

    n_rows = X.shape[0]
    dom = taxi_domain()
    t0 = time.perf_counter()
    table = TorchTable.from_numpy(dom, X, session=sess)
    sess.synchronize()
    data_s = time.perf_counter() - t0

    def block(t):
        torch.cuda.synchronize()
        return t

    g_warm, *_ = _taxi_graph(table)
    block(g_warm.run())
    g, src, sc, pca, km = _taxi_graph(table)
    t0 = time.perf_counter()
    out_eager = block(g.run()[km]["data"])
    wall_fit_eager = time.perf_counter() - t0

    staged = stage_graph(g, km)
    block(staged())
    t0 = time.perf_counter()
    out_staged = block(staged())
    wall_staged = time.perf_counter() - t0

    refit_staged = stage_graph(g, km, refit=True)
    block(refit_staged())
    t0 = time.perf_counter()
    out_refit = block(refit_staged())
    wall_fit_staged = time.perf_counter() - t0

    def eager_transform():
        t = table
        for nid in (sc, pca, km):
            t = g.nodes[nid].outputs["model"].transform(t)
        return t

    block(eager_transform())
    t0 = time.perf_counter()
    out_e2 = block(eager_transform())
    wall_eager_tr = time.perf_counter() - t0
    staged_bitwise = _table_bits_equal(out_staged, out_e2) and _table_bits_equal(
        out_staged, out_eager)
    if not staged_bitwise:
        raise AssertionError("the staged transform differs from the eager widget walk")
    refit_ids = out_refit.X[:, -1]
    refit_clusters = int(torch.unique(refit_ids).numel())
    if not bool(torch.isfinite(out_refit.X).all()) or refit_clusters < 2:
        raise AssertionError(f"the staged refit's output is not a clustering "
                             f"({refit_clusters} clusters)")

    # launches of one eager walk (a fresh graph: the three fits and
    # transforms) and of one staged call, with the walk's device busy time
    g_prof, *_ = _taxi_graph(table)
    walk_us, walk_events, walk_by_name, walk_busy = _profile_run(lambda: g_prof.run())
    st_us, st_events, _, st_busy = _profile_run(staged)
    rf_us, rf_events, _, rf_busy = _profile_run(refit_staged)
    top = sorted(walk_by_name.items(), key=lambda kv: -kv[1][0])[:8]
    del g_prof, g_warm

    # ---- streaming-fit arm (bench.py:3317-3351): each stage out of core
    # over a chunk stream, the stages chained chunk-wise on the host
    cr = TAXI_STREAM_CHUNK
    t0 = time.perf_counter()
    scaler_s = StandardScaler(with_mean=True).fit_stream(
        array_chunk_source(X, chunk_rows=cr), session=sess, chunk_rows=cr)
    sh = scaler_s.shift.cpu().numpy()
    scl = scaler_s.scale.cpu().numpy()

    def scaled_source():
        for c in array_chunk_source(X, chunk_rows=cr)():
            yield (((c[0] - sh) * scl).astype(np.float32), None, None)

    pca_s = PCA(k=4).fit_stream(scaled_source, session=sess, chunk_rows=cr)
    comp = pca_s.components.cpu().numpy()
    pmean = pca_s.mean.cpu().numpy()

    def proj_source():
        for Xc, _y, _w in scaled_source():
            yield (((Xc - pmean) @ comp).astype(np.float32), None, None)

    km_s = StreamingKMeans(k=10, epochs=2, chunk_rows=cr, seed=0).fit_stream(
        proj_source, n_features=4, session=sess)
    block(km_s.centers)
    wall_fit_stream = time.perf_counter() - t0
    scaler_b = g.nodes[sc].outputs["model"]
    stream_scaler_diff = float(np.max(np.abs(scaler_b.shift.cpu().numpy() - sh)))

    # ---- serving A/B (bench.py:3353-3411): fused vs stage by stage
    models = [g.nodes[nid].outputs["model"] for nid in (sc, pca, km)]
    wf = ServedWorkflow.from_stages(models, table, name="taxi-dag")
    rng2 = np.random.default_rng(11)
    reqs = [TorchTable.from_numpy(dom, X[int(o):int(o) + 256], session=sess)
            for o in rng2.integers(0, n_rows - 256, 24)]
    arms = (("fused", "1"), ("staged", "0"))
    lat: dict = {name: [] for name, _ in arms}
    disp: dict = {}
    outs: dict = {}
    try:
        with ServingContext(BucketLadder(**TAXI_LADDER)):
            for name, flag in arms:   # warm, pin the dispatch counts
                os.environ["OTPU_WORKFLOW_SERVE"] = flag
                wf.predict(reqs[0])
                reset_serve_counters()
                outs[name] = np.asarray(wf.predict(reqs[0]))
                c = serve_counters()
                disp[name] = c.get("bucket_hits", 0) + c.get("bucket_misses", 0)
            parity = True
            for t in reqs:                  # interleaved: drift hits both
                got = {}
                for name, flag in arms:
                    os.environ["OTPU_WORKFLOW_SERVE"] = flag
                    t1 = time.perf_counter()
                    got[name] = wf.predict(t)
                    lat[name].append((time.perf_counter() - t1) * 1e3)
                parity = parity and bool(np.array_equal(got["fused"], got["staged"]))
    finally:
        os.environ.pop("OTPU_WORKFLOW_SERVE", None)
    parity = parity and bool(np.array_equal(outs["fused"], outs["staged"]))
    p50 = {n: float(np.percentile(np.asarray(v), 50)) for n, v in lat.items()}
    if not parity:
        raise AssertionError("served workflow: fused output differs from stage by stage")
    if disp["fused"] != 1 or disp["staged"] != len(models):
        raise AssertionError(f"served workflow dispatches {disp}: fused must be 1, "
                             f"stage by stage {len(models)}")
    del reqs, wf
    line = {
        "metric": "taxi_kmeans_pca_pipeline", "unit": "s", "value": wall_staged,
        "rows": n_rows, "features": X.shape[1], "data_s": data_s,
        "workflow_fit_s": wall_fit_eager, "workflow_fit_staged_s": wall_fit_staged,
        "refit_fallbacks": len(refit_staged.refit_fallbacks),
        "graph_segments": refit_staged.graph_segments,
        "refit_segments": refit_staged.segments,
        "transform_graph_segments": staged.graph_segments,
        "transform_eager_s": wall_eager_tr, "transform_staged_s": wall_staged,
        "staged_speedup": wall_eager_tr / wall_staged,
        "staged_rows_per_sec_per_chip": n_rows / wall_staged / sess.n_devices,
        "staged_equal_eager_bitwise": staged_bitwise,
        "refit_clusters": refit_clusters,
        "streaming_fit_s": wall_fit_stream,
        "streaming_fit_rows_per_s_per_chip": n_rows / wall_fit_stream / sess.n_devices,
        "streaming_scaler_max_abs_diff": stream_scaler_diff,
        "streaming_kmeans_steps": km_s.n_iter_,
        "serve_fused_p50_ms": p50["fused"], "serve_staged_p50_ms": p50["staged"],
        "workflow_fused_speedup": p50["staged"] / p50["fused"],
        "dispatch_fused": disp["fused"], "dispatch_staged": disp["staged"],
        "workflow_parity": parity,
        "eager_walk_kernel_launches": len(walk_events),
        "eager_walk_wall_s": walk_us / 1e6, "eager_walk_device_busy_s": walk_busy / 1e6,
        "eager_walk_device_idle_share": (1 - walk_busy / walk_us) if walk_events
        else "not measured",
        "eager_walk_top_ops": [{"name": n[:90], "ms": v[0] / 1e3, "launches": v[1]}
                               for n, v in top],
        "staged_transform_kernel_launches": len(st_events),
        "staged_transform_device_busy_ms": st_busy / 1e3, "staged_transform_wall_ms": st_us / 1e3,
        "staged_refit_kernel_launches": len(rf_events),
        "staged_refit_device_busy_ms": rf_busy / 1e3, "staged_refit_wall_ms": rf_us / 1e3,
        "config": {"scaler": "with_mean", "pca_k": 4, "kmeans_k": 10, "max_iter": 10,
                   "seed": 2, "ladder": TAXI_LADDER, "requests": 24, "request_rows": 256,
                   "stream_chunk_rows": TAXI_STREAM_CHUNK, "stream_epochs": 2},
    }
    del table, g, staged, refit_staged, out_eager, out_staged, out_refit, out_e2
    torch.cuda.empty_cache()
    return line


# ------------------------------------------------------- ALS (config 4)
# bench_suite.py:134-184: the MovieLens-25M proxy, explicit rank-16 ALS
MOVIELENS_RATINGS, MOVIELENS_HOLDOUT = 25_000_000, 1 << 18
MOVIELENS_ALS = dict(rank=16, max_iter=10, reg_param=0.05, seed=2)
MOVIELENS_RMSE_CEIL = 0.40      # the reference's CPU run: 0.3766 (BASELINE.md:148-152)
# als_check's fit: the card against the port's CPU fit from the same initial
# factors. The normal equations are bitwise; the LU solves may round apart
# (cuBLAS's batched LU against LAPACK's), and ALS contracts. Measured 0.0 on
# an NVIDIA H100 80GB HBM3 with torch 2.11 (the two solves agreed bit for
# bit); the tolerance leaves room for a float32 rounding a solve.
ALS_CHECK = dict(n_users=4000, n_items=3000, n_ratings=200_000, rank=16, max_iter=5,
                 reg_param=0.05, seed=7)
ALS_FIT_ATOL = 1e-5
# normal_equations_sorted against its plain version with the CPU's sums:
# (rank, entities with ratings, entities, other side, ratings, chunk,
# ratings of one heavy entity, implicit). Rank 16 holds 3 entities a warp
# (3500 and 1201 are not multiples), rank 8 ten; the 100,000-rating segment
# at chunk 2^12 is cut into ~100 pieces (explicit and implicit); ranks 48,
# 64 and 128 take 3, 5 and 17 warps an entity.
NE_CASES = [(1, 3000, 3500, 2000, 300_000, 1 << 14, 0, False),
            (16, 3000, 3500, 2000, 300_000, 1 << 14, 100_000, False),
            (16, 3000, 3500, 2000, 300_000, 1 << 12, 100_000, False),
            (16, 3000, 3500, 2000, 200_000, 1 << 12, 100_000, True),
            (16, 3000, 3500, 2000, 200_000, 1 << 16, 0, True),
            (8, 1000, 1201, 900, 100_000, 1 << 13, 0, False),
            (48, 1000, 1200, 700, 100_000, 1 << 14, 0, False),
            (64, 1000, 1201, 700, 60_000, 1 << 14, 20_000, False),
            (128, 300, 401, 500, 30_000, 1 << 13, 0, True)]


def _ne_inputs(k, e_used, E, n_other, M, chunk, heavy, implicit, dev, seed=0):
    """A side's ratings for the normal equations: ``e_used`` of ``E``
    entities rated (the rest empty), a tenth of the weights zero, entity 0
    with ``heavy`` more ratings spread over the whole order; laid out
    (``sort_side``, chunk ``chunk``) on ``dev`` and on the CPU from the
    same numpy draws. Returns (factors, layout on dev, layout on the
    CPU)."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.models import als as A

    rng = np.random.default_rng(seed)
    u = rng.integers(0, e_used, M + heavy).astype(np.int32)
    u[rng.permutation(M + heavy)[:heavy]] = 0
    i = rng.integers(0, n_other, M + heavy).astype(np.int32)
    r = (rng.standard_normal(M + heavy) * 2).astype(np.float32)
    w = (rng.random(M + heavy) >= 0.1).astype(np.float32)
    V = rng.standard_normal((n_other, k)).astype(np.float32)
    cols = [torch.from_numpy(x) for x in (u, i, r, w)]
    plans = [A._side_plan(*(c.to(d) for c in cols), E, n_other, implicit, 1.5)(chunk)
             for d in (dev, "cpu")]
    return torch.from_numpy(V).to(dev), plans[0], plans[1]


def _layouts_equal(a, b) -> bool:
    import torch

    return all((x is None and y is None) or (x is not None and y is not None and (
        x == y if isinstance(x, tuple) else torch.equal(x.cpu(), y.cpu())))
        for x, y in zip(a, b))


def _ne_case(k, e_used, E, n_other, M, chunk, heavy, implicit, dev):
    """The kernel on ``dev`` against its plain version with the CPU's
    index-order sums, on the same sorted ratings: the layout on the card
    equal to the CPU's, A, b and cnt bitwise, two launches bitwise, the
    empty entities zero; the plain version on the card within float32
    rounding (index_add_'s atomics)."""
    import torch

    from orange3_spark_tpu_torch.ops import normal_equations as NE

    V, plan, cplan = _ne_inputs(k, e_used, E, n_other, M, chunk, heavy, implicit, dev)
    got = NE.normal_equations_sorted(V, plan)
    again = NE.normal_equations_sorted(V, plan)
    want = NE.normal_equations_sorted_reference(V.cpu(), cplan)
    on_dev = NE.normal_equations_sorted_reference(V, plan)
    got = [x.cpu() for x in got]
    line = {
        "rank": k, "ratings": M + heavy, "entities": E, "chunk": chunk,
        "heavy_segment": heavy, "implicit": implicit,
        "cut_segments": len(plan.split_first_host) - 1,
        "pieces": plan.split_first_host[-1],
        "sort_equal": _layouts_equal(plan, cplan),
        "bitwise_cpu_order": all(torch.equal(a, b) for a, b in zip(got, want)),
        "bitwise_repeat": all(torch.equal(a, b.cpu()) for a, b in zip(got, again)),
        "empty_zero": all(not x[e_used:].any() for x in got),
        "max_abs_err_vs_plain_on_device": max(float((a - b.cpu()).abs().max())
                                              for a, b in zip(got, on_dev)),
    }
    line["ok"] = all(line[key] for key in ("sort_equal", "bitwise_cpu_order",
                                           "bitwise_repeat", "empty_zero"))
    return line


def _table_pair(ratings, sess):
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.models.als import ratings_table

    return ratings_table(ratings, sess), ratings_table(ratings, TorchSession("cpu"))


def _recommend_agreement(U, V, n, dev):
    """``recommend_for_all_users(n)`` from the same factors on ``dev`` and
    on the CPU, and the rows whose ids differ (ties come in one order on
    both: the lower id first)."""
    import numpy as np

    from orange3_spark_tpu_torch.models.als import ALSModel, ALSParams

    p = ALSParams(rank=U.shape[1])
    on_dev = ALSModel(p, U.to(dev), V.to(dev)).recommend_for_all_users(n)
    on_cpu = ALSModel(p, U.cpu(), V.cpu()).recommend_for_all_users(n)
    diff = int((on_dev != on_cpu).any(axis=1).sum())
    return on_dev, on_cpu, {"rows": len(on_dev), "rows_differ": diff}


def _holdout_truth(users, items, n_users):
    """Each user's held-out items as a -1-padded id matrix, and the users
    that have any."""
    import numpy as np

    order = np.argsort(users, kind="stable")
    u, it = users[order], items[order]
    counts = np.bincount(u, minlength=n_users)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    truth = np.full((n_users, max(int(counts.max()), 1)), -1, np.int32)
    truth[u, np.arange(len(u)) - starts[u]] = it
    return truth, np.flatnonzero(counts > 0)


def phase_als_check(sess):
    """ALS on the card held to the port's CPU path: the kernel against its
    plain version with CPU-order sums (``NE_CASES``), a card fit against the
    CPU fit from the same initial factors, two card fits bitwise,
    recommendations (with tied scores) and ranking metrics against the
    CPU's."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import make_ratings
    from orange3_spark_tpu_torch.models.als import ALS
    from orange3_spark_tpu_torch.models.evaluation import (
        MultilabelClassificationEvaluator, RankingEvaluator,
    )

    dev = sess.device
    cases = [_ne_case(*c, dev) for c in NE_CASES]
    c = ALS_CHECK
    ratings = make_ratings(c["n_users"], c["n_items"], c["n_ratings"], rank=8, seed=3,
                           noise=0.1)
    t_gpu, t_cpu = _table_pair(ratings, sess)
    est = ALS(rank=c["rank"], max_iter=c["max_iter"], reg_param=c["reg_param"], seed=c["seed"])
    m_gpu, m_again, m_cpu = est.fit(t_gpu), est.fit(t_gpu), est.fit(t_cpu)
    fit_err = max(float((m_gpu.user_factors.cpu() - m_cpu.user_factors).abs().max()),
                  float((m_gpu.item_factors.cpu() - m_cpu.item_factors).abs().max()))
    repeat = (torch.equal(m_gpu.user_factors, m_again.user_factors)
              and torch.equal(m_gpu.item_factors, m_again.item_factors))
    # recommendations and metrics from the CPU fit's factors on both devices,
    # with one user's and one item's factors zero (as for an entity no
    # rating reaches), which ties that user's scores and every user's score
    # of that item
    U, V = m_cpu.user_factors.clone(), m_cpu.item_factors.clone()
    U[1], V[2] = 0.0, 0.0
    recs_dev, recs_cpu, agree = _recommend_agreement(U, V, 10, dev)
    truth, _ = _holdout_truth(ratings[:, 0].astype(np.int64), ratings[:, 1].astype(np.int32),
                              c["n_users"])
    metrics = {}
    for ev in ([RankingEvaluator(metric_name=m, k=10) for m in RankingEvaluator.METRICS]
               + [MultilabelClassificationEvaluator(metric_name=m)
                  for m in MultilabelClassificationEvaluator.METRICS]):
        on_dev = ev.evaluate(torch.from_numpy(recs_cpu).to(dev), torch.from_numpy(truth).to(dev))
        on_cpu = ev.evaluate(torch.from_numpy(recs_cpu), torch.from_numpy(truth))
        metrics[ev.params.metric_name] = [on_dev, on_cpu]
    metric_err = max(abs(a - b) for a, b in metrics.values())
    line = {"normal_equations": cases, "fit": {**c, "max_abs_err_vs_cpu": fit_err,
                                               "atol": ALS_FIT_ATOL,
                                               "bitwise_repeat": repeat},
            "recommend": agree, "metrics_card_cpu": metrics,
            "metric_max_abs_err": metric_err}
    failed = [f"normal_equations rank {x['rank']} heavy {x['heavy_segment']}"
              for x in cases if not x["ok"]]
    if not fit_err <= ALS_FIT_ATOL:
        failed.append(f"card fit {fit_err} from the CPU fit (atol {ALS_FIT_ATOL})")
    if not repeat:
        failed.append("two card fits differ")
    if agree["rows_differ"] != 0:
        failed.append(f"recommendations differ on {agree['rows_differ']} rows")
    if not (recs_cpu[1] == np.arange(10)).all():
        failed.append(f"the zero user's ids {recs_cpu[1].tolist()} are not 0..9")
    if not metric_err <= 1e-6:
        failed.append(f"ranking metrics {metric_err} apart")
    if failed:
        raise AssertionError(f"als_check: {failed}; {json.dumps(line)}")
    return line


def _ne_bound(M, E, k, n_other, mem_bw, fp32_peak, n_units, implicit=False):
    """The least time of one half-step's normal equations. Bytes: each
    input read once (the layout in use: key, aw, bw, and cw for implicit
    feedback, 12 or 16 a rating; the offsets; the work list, 20 a unit;
    the other side's factors), each output written once (A, b, cnt).
    Operations: the float32 products and adds the function needs: (V_i
    V_j)·aw and its add on the lower triangle, V_i·bw and its add, the
    count's add. ``bound_ms`` counts them at the card's float32 peak;
    ``issue_bound_ms`` at half of it, the rate of products and adds that
    may not contract into FMAs, as the plain version's bits require."""
    per = 16 if implicit else 12
    bytes_ = (M * per + (E + 1) * 8 + n_units * 20 + n_other * k * 4
              + E * (k * k + k + 1) * 4)
    ops = M * (3 * k * (k + 1) // 2 + 2 * k + 1)
    t_bytes, t_ops = bytes_ / mem_bw * 1e3, ops / fp32_peak * 1e3
    return {"bytes": bytes_, "bytes_per_rating": per, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "issue_bound_ms": max(t_bytes, 2 * t_ops)}


def _outer_index_add(factors, layout):
    """The yardstick: the reference chunks' terms materialised
    (``chunk_terms``) and ``index_add_``ed straight into A, b and cnt
    (float atomics on CUDA)."""
    import torch

    from orange3_spark_tpu_torch.ops.normal_equations import chunk_terms

    k, E = factors.shape[1], layout.offsets.shape[0] - 1
    A = torch.zeros((E + 1, k * k), device=factors.device)
    bc = torch.zeros((E + 1, k + 1), device=factors.device)
    for _j, ent, outer, rhs in chunk_terms(factors, layout, 1 << 18):
        A.index_add_(0, ent, outer)
        bc.index_add_(0, ent, rhs)
    return A, bc


def _ne_tolerance(factors, layout):
    """How far the kernel's A, b and cnt may lie from the plain version's on
    the card, per output (f64, shaped as they are). Both add the same
    float32 terms, each product rounded on its own, in two orders: the
    kernel's, and index_add_'s atomics. Any order of adding an entity's n
    terms lies within g·Σ|terms| of the exact sum, g = n·u/(1 - n·u) and
    u = 2^-24, so the two lie within 2g·Σ|terms| of each other. Σ|terms| is
    the plain version's sum of |V_i|·|V_j|·|aw|, |V_i|·|bw| and |cw|, which
    reads at most g of itself low: hence 2g/(1 - g) times it. One rating
    dropped or summed twice in a segment of n shifts an output by about
    Σ|terms|/n, past this for every n below ~2,900."""
    import torch

    from orange3_spark_tpu_torch.ops.normal_equations import (
        normal_equations_sorted_reference,
    )

    absl = layout._replace(aw=layout.aw.abs(), bw=layout.bw.abs(),
                           cw=None if layout.cw is None else layout.cw.abs())
    S = normal_equations_sorted_reference(factors.abs(), absl)
    off = layout.offsets
    n = (off[1:] - off[:-1]).to(torch.float64) * 2.0 ** -24
    g = n / (1 - n)
    scale = 2 * g / (1 - g)
    return [x.double() * scale.view(-1, *([1] * (x.ndim - 1))) for x in S]


def _als_profile_split(by_name):
    """Device ms of a profiled fit by stage: the kernel; the sort, once a
    fit a side (the radix sort, the segment offsets, the gathers that lay
    the ratings out in sorted order); the batched LU solve (cuBLAS's
    getrf and triangular solves); the rest."""
    stages = {"normal_equations": ("normal_eq_sorted",),
              "sort": ("sort", "radix", "searchsorted", "scatter_gather", "index_select",
                       "indexselect"),
              "solve": ("getr", "trsm", "laswp", "lu_", "pivot", "potr", "magma", "batch")}
    out = {s: 0.0 for s in (*stages, "rest")}
    for name, (us, _n) in by_name.items():
        low = name.lower()
        stage = next((s for s, keys in stages.items() if any(k in low for k in keys)), "rest")
        out[stage] += us / 1e3
    return out


def phase_movielens_als(sess, mem_bw, fp32_peak, ratings, seed=0):
    """BASELINE config 4 at full width (``bench_suite.py:134-184``): a
    warm-up fit, the timed fit (the kernel's launches counted over it), a
    profiled fit, RMSE on the training and holdout ratings, top-10 for
    every user and ndcg@10 against each user's held-out items; then the
    kernel at the timed fit's inputs, both sides, beside its bound, its
    plain version and the yardstick."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import MOVIELENS_ITEMS, MOVIELENS_USERS
    from orange3_spark_tpu_torch.models import als as A
    from orange3_spark_tpu_torch.models.evaluation import RankingEvaluator, RegressionEvaluator
    from orange3_spark_tpu_torch.ops import normal_equations as NE

    holdout = MOVIELENS_HOLDOUT
    t0 = time.perf_counter()
    table = A.ratings_table(ratings[:-holdout], sess)
    eval_table = A.ratings_table(ratings[-holdout:], sess)
    sess.synchronize()
    upload_s = time.perf_counter() - t0
    est = A.ALS(**MOVIELENS_ALS, n_users=MOVIELENS_USERS, n_items=MOVIELENS_ITEMS)
    t0 = time.perf_counter()
    est.fit(table)
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: the kernel's launch count starts at 0 here
    NE.normal_equations_sorted.launches = 0
    model = est.fit(table)
    launches = NE.normal_equations_sorted.launches
    # ----
    fit_s = est.last_fit_metrics["fit_seconds"]
    peak_bytes = torch.cuda.max_memory_allocated()
    if launches != 2 * MOVIELENS_ALS["max_iter"]:
        raise AssertionError(f"the timed fit launched the kernel {launches} times, not "
                             f"{2 * MOVIELENS_ALS['max_iter']}")
    rmse = RegressionEvaluator(metric_name="rmse", label_col="rating")
    train_rmse = rmse.evaluate(model.transform(table))
    holdout_rmse = rmse.evaluate(model.transform(eval_table))
    if not holdout_rmse <= MOVIELENS_RMSE_CEIL:
        raise AssertionError(f"holdout_rmse {holdout_rmse} above {MOVIELENS_RMSE_CEIL}")
    wall_us, events, by_name, busy = _profile_run(lambda: est.fit(table),
                                                  exclude=("normal_equations_sorted",))
    split = _als_profile_split(by_name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    t0 = time.perf_counter()
    recs = model.recommend_for_all_users(10)
    recommend_s = time.perf_counter() - t0
    truth, users = _holdout_truth(ratings[-holdout:, 0].astype(np.int64),
                                  ratings[-holdout:, 1].astype(np.int32), MOVIELENS_USERS)
    ndcg = RankingEvaluator(metric_name="ndcgAtK", k=10).evaluate(
        torch.from_numpy(recs[users]).to(sess.device), torch.from_numpy(truth[users]).to(sess.device))
    line = {
        "ratings": len(ratings), "train_ratings": table.n_rows, "holdout": holdout,
        "users": MOVIELENS_USERS, "items": MOVIELENS_ITEMS, **MOVIELENS_ALS,
        "upload_s": upload_s, "warmup_fit_s": warmup_s, "fit_s": fit_s,
        "ratings_per_sec_per_chip": table.n_rows * MOVIELENS_ALS["max_iter"] * 2 / fit_s,
        "train_rmse": train_rmse, "holdout_rmse": holdout_rmse,
        "holdout_rmse_ceiling": MOVIELENS_RMSE_CEIL, "noise_floor": 0.3,
        "kernel_launches": launches, "peak_device_bytes": peak_bytes,
        "profiled_fit_wall_s": wall_us / 1e6, "device_busy_s": busy / 1e6,
        "device_idle_share": 1 - busy / wall_us, "device_ms_by_stage": split,
        "top_kernels": [{"name": n[:90], "ms": v[0] / 1e3, "launches": v[1]}
                        for n, v in top],
        "recommend_for_all_users_s": recommend_s, "recommend_n": 10,
        "ndcgAtK_10_holdout": ndcg, "users_with_holdout": int(len(users)),
    }
    # the kernel at the timed fit's own inputs, each side, and at a skewed
    # item side, held to its plain version on the card within float32
    # summation's bound
    u = table.column("user").to(torch.int32)
    it = table.column("item").to(torch.int32)
    r = table.column("rating")
    chunk = min(est.params.chunk_size, table.n_pad)
    skew = torch.from_numpy(_skewed_items(table.n_pad, MOVIELENS_ITEMS, seed)).to(it.device)
    kern = {}
    for side, idx, oth, E, factors in (("user", u, it, MOVIELENS_USERS, model.item_factors),
                                       ("item", it, u, MOVIELENS_ITEMS, model.user_factors),
                                       ("item_skewed", skew, u, MOVIELENS_ITEMS,
                                        model.user_factors)):
        plan = A._side_plan(idx, oth, r, table.W, E, factors.shape[0], False, 1.0)(chunk)
        def fn():
            return NE.normal_equations_sorted(factors, plan)
        got, again = fn(), fn()
        plain = NE.normal_equations_sorted_reference(factors, plan)
        tol = _ne_tolerance(factors, plan)
        err = [(a.double() - b.double()).abs() for a, b in zip(got, plain)]
        lengths = plan.offsets[1:] - plan.offsets[:-1]
        kern[side] = {"entities": E, "ms": cuda_ms(fn, 10, warmup=1),
                      "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
                      **_ne_bound(table.n_rows, E, factors.shape[1], factors.shape[0],
                                  mem_bw, fp32_peak, plan.units.shape[0],
                                  implicit=plan.cw is not None),
                      "longest_segment": int(lengths.max()),
                      "blocks_per_sm": NE.blocks_per_sm(factors.shape[1]),
                      "cut_segments": len(plan.split_first_host) - 1,
                      "pieces": plan.split_first_host[-1],
                      "max_abs_err": max(float(e.max()) for e in err),
                      "within_tolerance": all(bool((e <= t).all()) for e, t in zip(err, tol)),
                      "max_err_over_tolerance": max(float((e / t.clamp_min(1e-300)).max())
                                                    for e, t in zip(err, tol)),
                      "plain_ms": cuda_ms(lambda: NE.normal_equations_sorted_reference(
                          factors, plan), 2, 1),
                      "library_ms": cuda_ms(lambda: _outer_index_add(factors, plan), 2, 1)}
        del got, again, plain, tol, err, plan
        torch.cuda.empty_cache()
        if not (kern[side]["within_tolerance"] and kern[side]["deterministic"]):
            raise AssertionError(f"normal_equations_sorted, {side} side at the timed fit's "
                                 f"inputs: {json.dumps(kern[side])}")
    line["kernel"] = kern
    return line


def _skewed_items(n, n_items, seed):
    """``n`` item ids drawn with numpy (``default_rng(seed)``), item i with
    chance proportional to 1 / (i + 1)^0.9: at 25M ratings the longest
    segment holds about 1.2M of them, the 1,000th about 2,400; real
    MovieLens-25M's most rated films have tens of thousands."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cdf = np.cumsum(1.0 / np.arange(1, n_items + 1) ** 0.9)
    return np.minimum(np.searchsorted(cdf, rng.random(n) * cdf[-1]), n_items - 1).astype(
        np.int32)


# ------------------------------------------------ the dense streaming fit
# StreamingLinearEstimator (io/streaming.py): adam over epochs of chunks;
# PyTorch ops (torch.mm) and captured CUDA graphs, no kernel of the package.
# bench.py --config fault (bench.py:1316-1419): its sizes and protocol
FAULT_CFG = dict(rows=262_144, features=16, chunk_rows=1 << 14, epochs=4, step_size=0.05)
# the dense out-of-core fit on bench.py's dense_logreg table (bench.py:1268-1312)
STREAM_LINEAR = dict(rows=4_000_000, features=40, chunk_rows=1 << 18, epochs=10,
                     step_size=0.01, holdout_rows=1 << 18, n_bins=4096)
STREAM_CHECK = dict(rows=1 << 14, chunk_rows=1 << 12, epochs=3)
# the card against the port's CPU path: cuBLAS and MKL sum X^T G in other
# orders; adam's normalised steps carry that float32 rounding along
STREAM_REL_TOL = 1e-4


def _dense_logreg_data(n, d, seed=0):
    """bench.py's dense_logreg rows: X ~ N(0, 1) f32, labels of a noisy
    linear score (``default_rng(seed)``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d), dtype=np.float32)
    true_w = rng.standard_normal((d,)).astype(np.float32)
    y = (X @ true_w + 0.5 * rng.standard_normal(n).astype(np.float32) > 0).astype(np.float32)
    return X, y


def _stream_fit(sess, X, y, *, chunk_rows, stage_times=None, fit_kw=None, **params):
    """A ``StreamingLinearEstimator`` fit over ``array_chunk_source`` with
    the device cache: (model, wall seconds, the device synchronised)."""
    from orange3_spark_tpu_torch.io.streaming import (
        StreamingLinearEstimator, array_chunk_source,
    )

    est = StreamingLinearEstimator(chunk_rows=chunk_rows, **params)
    t0 = time.perf_counter()
    model = est.fit_stream(array_chunk_source(X, y, chunk_rows=chunk_rows),
                           n_features=X.shape[1], session=sess, cache_device=True,
                           stage_times=stage_times, **(fit_kw or {}))
    sess.synchronize()
    return model, time.perf_counter() - t0


def _coef_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.coef.cpu(), b.coef.cpu())
                and torch.equal(a.intercept.cpu(), b.intercept.cpu()))


def streaming_linear_check(sess) -> dict:
    """At 2^14 rows of the dense_logreg draw (2^12-row chunks, 3 epochs):
    the card's fit (its replay one captured graph) against the port's CPU
    fit within ``STREAM_REL_TOL`` of max|θ|; the captured replay bitwise
    the eager one (the cache held, the half-budget gate failed: the same
    steps one by one); a 3-class fit the same way."""
    from orange3_spark_tpu_torch import TorchSession

    cfg = STREAM_CHECK
    X, y3 = _dense_logreg_data(cfg["rows"], 40, seed=1)
    rng = __import__("numpy").random.default_rng(1)
    y3 = (y3 + (rng.random(cfg["rows"]) < 0.3)).astype("float32")    # 3 classes
    cpu = TorchSession("cpu")
    out, ok = {}, True
    for name, y, k in (("k2", (y3 > 0).astype("float32"), 2), ("k3", y3, 3)):
        kw = dict(chunk_rows=cfg["chunk_rows"], epochs=cfg["epochs"], n_classes=k,
                  step_size=0.05, reg_param=1e-4)
        st_graph, st_eager = {}, {}
        card, _ = _stream_fit(sess, X, y, stage_times=st_graph, **kw)
        cache_bytes = st_graph["cache_bytes"]
        eager, _ = _stream_fit(sess, X, y, stage_times=st_eager,
                               fit_kw=dict(cache_device_bytes=int(1.5 * cache_bytes)), **kw)
        host, _ = _stream_fit(cpu, X, y, **kw)
        scale = float(host.coef.abs().max())
        err = max(float((card.coef.cpu() - host.coef).abs().max()),
                  float((card.intercept.cpu() - host.intercept).abs().max()))
        line = {"replay": [st_graph["replay_source"], st_eager["replay_source"]],
                "captured_equals_eager": _coef_equal(card, eager),
                "card_vs_cpu_max_abs_err": err, "max_abs_theta": scale,
                "rel_err": err / scale}
        ok &= (line["replay"] == ["fused", "hbm"] and line["captured_equals_eager"]
               and line["rel_err"] <= STREAM_REL_TOL)
        out[name] = line
    out["tolerance"] = (f"card vs CPU theta within {STREAM_REL_TOL} x max|theta| (cuBLAS "
                        "vs MKL sums); captured replay bitwise the eager replay")
    out["ok"] = bool(ok)
    return out


def phase_fault(sess) -> dict:
    """``bench.py --config fault`` (bench.py:1316-1419) at bench's sizes:
    262,144 x 16 rows of ``default_rng(0)``, logistic, 4 epochs, step 0.05,
    2^14-row chunks, the device cache. A warm fit, a clean fit, then a fit
    under bench's fault spec (every 7th chunk read fails twice, every 8th
    waits 5 ms; ``OTPU_RETRY_BASE_S=0.02``): its coef must be bitwise the
    clean fit's, with faults injected and retried. Then ``wedge:at=1,
    hold_s=30`` under a 0.25 s budget must raise ``DispatchWedgedError``
    within 2 s."""
    import numpy as np

    from orange3_spark_tpu_torch.resilience import DispatchWedgedError, inject_faults
    from orange3_spark_tpu_torch.resilience.overload import reset_wedge_breaker
    from orange3_spark_tpu_torch.utils.profiling import (
        reset_resilience_counters, resilience_counters,
    )

    cfg = FAULT_CFG
    rows, d = cfg["rows"], cfg["features"]
    rng = np.random.default_rng(0)
    X = rng.standard_normal((rows, d)).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32)
    kw = dict(chunk_rows=cfg["chunk_rows"], loss="logistic", epochs=cfg["epochs"],
              step_size=cfg["step_size"])
    _stream_fit(sess, X, y, **kw)                        # warm-up
    clean, wall_clean = _stream_fit(sess, X, y, **kw)
    reset_resilience_counters()
    old = os.environ.get("OTPU_RETRY_BASE_S")
    os.environ["OTPU_RETRY_BASE_S"] = "0.02"
    st: dict = {}
    try:
        with inject_faults(FAULT_SPEC):
            faulted, wall_fault = _stream_fit(sess, X, y, stage_times=st, **kw)
    finally:
        if old is None:
            os.environ.pop("OTPU_RETRY_BASE_S", None)
        else:
            os.environ["OTPU_RETRY_BASE_S"] = old
    res = resilience_counters()
    parity = _coef_equal(clean, faulted)
    # the watchdog: >= 20 steps whatever the sizes, so the period-16 guarded
    # wait runs; no cache (every step eager)
    from orange3_spark_tpu_torch.io.streaming import (
        StreamingLinearEstimator, array_chunk_source,
    )

    wedge_rows = max(256, rows * cfg["epochs"] // 20)
    old = os.environ.get("OTPU_DISPATCH_BUDGET_S")
    os.environ["OTPU_DISPATCH_BUDGET_S"] = "0.25"
    reset_wedge_breaker()
    wedge = {"raised": False}
    try:
        with inject_faults("wedge:at=1,hold_s=30"):
            t0 = time.perf_counter()
            try:
                StreamingLinearEstimator(**dict(kw, chunk_rows=wedge_rows)).fit_stream(
                    array_chunk_source(X, y, chunk_rows=wedge_rows), n_features=d,
                    session=sess)
            except DispatchWedgedError as e:
                wedge.update(raised=True, step=e.step, waited_s=e.waited_s)
            wedge["seconds"] = time.perf_counter() - t0
    finally:
        reset_wedge_breaker()
        if old is None:
            os.environ.pop("OTPU_DISPATCH_BUDGET_S", None)
        else:
            os.environ["OTPU_DISPATCH_BUDGET_S"] = old
    line = {"spec": FAULT_SPEC, **cfg, "wall_clean_s": wall_clean, "wall_fault_s": wall_fault,
            "recovery_overhead_pct": 100.0 * (wall_fault - wall_clean) / wall_clean,
            "rows_per_s": rows * cfg["epochs"] / wall_fault,
            "rows_per_s_clean": rows * cfg["epochs"] / wall_clean,
            "faults_injected": res["faults_injected"], "retries": res["retries"],
            "fit_retries": st["retries"], "retry_wait_s": res["retry_wait_s"],
            "parity_bitwise": parity, "replay_source": st["replay_source"],
            "watchdog": wedge, "cuts": None}
    if not (parity and res["faults_injected"] > 0 and res["retries"] > 0 and wedge["raised"]
            and wedge["seconds"] < 2.0):
        raise AssertionError(f"fault: the recovery failed its checks: {line}")
    return line


def phase_streaming_linear(sess) -> dict:
    """The dense out-of-core fit at full width: bench.py's dense_logreg table
    (4,000,000 x 40 of ``default_rng(0)``) through ``array_chunk_source`` in
    2^18-row chunks (16 chunks, the device cache), logistic, 10 epochs. Four
    arms after a warm-up: the default schedule, ``defer_epoch1``,
    ``replay_granularity='epoch'`` with 3 epochs a call, and ``cache_dtype=
    'bf16'`` (with its own deferred arm): within a dtype every arm's coef
    bitwise the default's. ``evaluate_binary_stream`` on the last 2^18 rows
    against the in-memory ``BinaryClassificationEvaluator`` within 2/n_bins.
    Then ``streaming_linear_check`` at 2^14 rows, and one profiled fit (the
    device's busy and idle share, launches)."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.core.domain import (
        ContinuousVariable, DiscreteVariable, Domain,
    )
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.evaluation import (
        BinaryClassificationEvaluator, evaluate_binary_stream,
    )

    cfg = STREAM_LINEAR
    t0 = time.perf_counter()
    X, y = _dense_logreg_data(cfg["rows"], cfg["features"], seed=0)
    data_s = time.perf_counter() - t0
    kw = dict(chunk_rows=cfg["chunk_rows"], epochs=cfg["epochs"], step_size=cfg["step_size"])
    _stream_fit(sess, X, y, **dict(kw, epochs=2))        # warm-up
    arms_kw = {"default": {}, "defer": dict(defer_epoch1=True),
               "epoch_k3": dict(replay_granularity="epoch", epochs_per_dispatch=3),
               "bf16": dict(cache_dtype="bf16"),
               "bf16_defer": dict(cache_dtype="bf16", defer_epoch1=True)}
    arms, models = {}, {}
    for name, extra in arms_kw.items():
        st: dict = {}
        model, wall = _stream_fit(sess, X, y, stage_times=st, **kw, **extra)
        models[name] = model
        # the replay's wall includes its capture (one epoch's steps recorded
        # and instantiated as a graph): the epoch's time is the rest
        rep = st["epoch_s"][1] if len(st["epoch_s"]) > 1 else None
        n_rep = cfg["epochs"] - (0 if extra.get("defer_epoch1") else 1)
        arms[name] = {"fit_s": wall, "replay_source": st["replay_source"],
                      "epoch1_s": st["epoch_s"][0], "replay_s": rep,
                      "replay_ms_per_epoch": (None if rep is None else
                                              1e3 * (rep - st["graph_capture_s"]) / n_rep),
                      "graph_capture_s": st["graph_capture_s"], "n_steps": model.n_steps_,
                      "cache_bytes": st["cache_bytes"], "final_loss": model.final_loss_,
                      "rows_per_s": cfg["rows"] * cfg["epochs"] / wall}
    bitwise = {"defer": _coef_equal(models["defer"], models["default"]),
               "epoch_k3": _coef_equal(models["epoch_k3"], models["default"]),
               "bf16_defer": _coef_equal(models["bf16_defer"], models["bf16"])}
    bf16_differs = not _coef_equal(models["bf16"], models["default"])
    # the holdout: the last 2^18 rows, streamed and in memory
    model = models["default"]
    H = cfg["holdout_rows"]
    coef, b = model.coef, model.intercept

    def score(Xd):
        return torch.softmax(Xd @ coef + b, dim=-1)[:, 1]

    t0 = time.perf_counter()
    ev = evaluate_binary_stream(score, array_chunk_source(X[-H:], y[-H:], chunk_rows=1 << 16),
                                session=sess, chunk_rows=1 << 16, n_bins=cfg["n_bins"])
    eval_s = time.perf_counter() - t0
    s_all = score(torch.from_numpy(X[-H:]).to(sess.device)).cpu().numpy()
    table = TorchTable.from_numpy(
        Domain([ContinuousVariable("probability_1")], DiscreteVariable("y", ("0", "1"))),
        s_all[:, None], y[-H:], session=sess)
    exact = BinaryClassificationEvaluator().evaluate(table)
    auc_ok = abs(ev["auc"] - exact) <= 2.0 / cfg["n_bins"]
    check = streaming_linear_check(sess)
    # one profiled default fit: the device's share of its wall
    # the fit's own profiler ranges (spans) are not device work
    wall_us, events, by_name, busy = _profile_run(lambda: _stream_fit(sess, X, y, **kw),
                                                  exclude=("epoch", "chunk", "fit"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    prof = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_events": len(events),
            "events_per_step": len(events) / model.n_steps_,
            "top": [{"name": n[:90], "ms": us / 1e3, "count": c} for n, (us, c) in top]}
    line = {**cfg, "data_s": data_s, "fit_s": arms["default"]["fit_s"],
            "replay_ms_per_epoch": arms["default"]["replay_ms_per_epoch"], "arms": arms,
            "bitwise_equal_default": bitwise, "bf16_differs_from_f32": bf16_differs,
            "holdout": {"stream": ev, "eval_s": eval_s, "in_memory_auc": exact,
                        "auc_abs_diff": abs(ev["auc"] - exact),
                        "bound": 2.0 / cfg["n_bins"]},
            "check": check, "profile": prof, "kernels": "none of the package (torch.mm)",
            "cuts": None}
    if not (all(bitwise.values()) and bf16_differs and auc_ok and check["ok"]
            and arms["default"]["replay_source"] == "fused"
            and arms["epoch_k3"]["replay_source"] == "fused_epoch"):
        raise AssertionError(f"streaming_linear failed its checks: {line}")
    return line


# ------------------------------------------ libsvm -> value-weighted fit
LIBSVM = dict(rows=1 << 19, nnz=26, n_dims=1 << 22, chunk_rows=1 << 17, epochs=10,
              step_size=0.04, reg_param=1e-5, holdout_chunks=1)
LIBSVM_CHECK_ROWS = 1 << 14


def _libsvm_draw(rows, nnz, seed=0):
    """(1-based indices i64 [rows, nnz] drawn from a Zipf law of exponent
    1.2 below 2^24 (the discretised power law floor(u^(-1/0.2))), sorted in
    a row; a repeat of the index before it marks a dropped slot; values in
    (0, 2] at four decimals; labels of a noisy sum of per-index effects)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = 1.0 - rng.random((rows, nnz))                  # (0, 1]
    zipf = np.minimum(np.floor(u ** -5.0), (1 << 24) - 1).astype(np.int64)
    idx = np.sort(zipf, axis=1)
    dup = np.zeros((rows, nnz), bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    v_int = np.clip(np.ceil((2.0 - 2.0 * rng.random((rows, nnz))) * 1e4), 1, 20000)
    vals = (v_int / 1e4).astype(np.float32)
    eff = ((idx.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(1 << 32)
           ).astype(np.float64) / 2.0**31 - 1.0
    logit = np.where(dup, 0.0, eff * vals).sum(1)
    y = (logit - np.median(logit) + 0.5 * rng.standard_normal(rows) > 0).astype(np.int64)
    return idx, dup, v_int.astype(np.int64), vals, y


def _write_libsvm_file(path, idx, dup, v_int, y):
    """The draw as a libsvm file, formatted by numpy: each line the label,
    then ' iiiiiiii:d.dddd' a pair (the index zero-padded to 8 digits), a
    dropped slot blank."""
    import numpy as np

    rows, nnz = idx.shape
    i32, v32 = idx.astype(np.int32), v_int.astype(np.int32)
    tok = np.empty((rows, nnz, 16), np.uint8)
    tok[..., 0] = ord(" ")
    digits = 10 ** np.arange(7, -1, -1, dtype=np.int32)
    tok[..., 1:9] = ord("0") + (i32[..., None] // digits) % 10
    tok[..., 9] = ord(":")
    tok[..., 10] = ord("0") + v32 // 10000
    tok[..., 11] = ord(".")
    tok[..., 12:16] = ord("0") + (v32[..., None] // digits[4:]) % 10
    tok[dup] = ord(" ")
    buf = np.empty((rows, 2 + 16 * nnz), np.uint8)
    buf[:, 0] = ord("0") + y
    buf[:, 1:-1] = tok.reshape(rows, 16 * nnz)
    buf[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(buf.tobytes())


def _pair_rows(idx, dup, vals):
    """The draw as value-weighted chunk rows [idx - 1..., val...] with a
    dropped slot as a pad (-1, 0)."""
    import numpy as np

    i = np.where(dup, -1, idx - 1).astype(np.float32)
    return np.concatenate([i, np.where(dup, 0.0, vals).astype(np.float32)], axis=1)


def libsvm_hashed_check(sess, tmp) -> dict:
    """At 2^14 rows of the draw (2^12-row chunks, 3 epochs, 2^18 dims): the
    value-weighted fit on the card (sparse rules: the 'sort' lowering with
    ``segment_update_sorted`` given the values) against the port's CPU path
    ('plan') for each ``emb_update`` x {'adam', 'dense_adagrad',
    'sparse_adagrad'}, and ``compute_dtype='bfloat16'`` (sparse_adagrad, and
    the dense rules' bf16 gradients on each emb_update), within
    THETA_ATOL + THETA_RTOL·|θ|; ``missing='keep'`` on a CSV with one NaN
    dense cell raises ``NumericalDivergenceError``."""
    import numpy as np

    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source, csv_raw_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.resilience.numerics import NumericalDivergenceError

    idx, dup, _, vals, y = _libsvm_draw(LIBSVM_CHECK_ROWS, LIBSVM["nnz"], seed=1)
    Xp, yf = _pair_rows(idx, dup, vals), y.astype(np.float32)
    cpu = TorchSession("cpu")
    base = dict(value_weighted=True, n_dense=0, n_cat=LIBSVM["nnz"], n_dims=1 << 18,
                chunk_rows=1 << 12, epochs=3, step_size=0.04, reg_param=1e-5)

    def fit(session, **kw):
        return StreamingHashedLinearEstimator(**{**base, **kw}).fit_stream(
            array_chunk_source(Xp, yf, chunk_rows=1 << 12), session=session, cache_device=True)

    cases, ok = {}, True
    arms = [(emb, rule, "float32") for emb in ("fused", "per_column", "sorted")
            for rule in ("adam", "dense_adagrad", "sparse_adagrad")]
    # bf16 compute: the sparse rule's gradients float32; the dense rules'
    # rounded to bf16, the table's summed in bf16 (segment_sum_sorted's
    # rounded sums on the card)
    arms += [("fused", "sparse_adagrad", "bfloat16"), ("fused", "adam", "bfloat16"),
             ("per_column", "dense_adagrad", "bfloat16"), ("sorted", "adam", "bfloat16")]
    for emb, rule, dtype in arms:
        kw = dict(emb_update=emb, optim_update=rule, compute_dtype=dtype)
        card, host = fit(sess, **kw), fit(cpu, **kw)
        want = {k: v for k, v in host.theta.items() if v.numel()}     # no dense block
        if dtype == "bfloat16" and rule != "sparse_adagrad":
            line, good = _bf16_grad_err(card.theta, want, base["step_size"], host.n_steps_)
        else:
            errs, good = _theta_err(card.theta, want)
            line = {"max_abs_err": errs}
        cases[f"{emb}/{rule}/{dtype}"] = {**line, "ok": good}
        ok &= good
    # missing='keep': one NaN dense cell in a small CSV
    path = os.path.join(tmp, "keep.csv")
    rng = np.random.default_rng(4)
    n = 2048
    with open(path, "w") as f:
        f.write("label,d0,d1,d2,c0,c1,c2,c3\n")
        for r in range(n):
            dense = ["" if r == 700 and j == 1 else f"{rng.standard_normal():.6g}"
                     for j in range(3)]
            f.write(",".join([str(int(rng.random() < 0.4))] + dense
                             + [str(int(c)) for c in rng.integers(0, 50, 4)]) + "\n")
    raised = False
    try:
        StreamingHashedLinearEstimator(
            n_dims=1 << 12, n_dense=3, n_cat=4, chunk_rows=1024, epochs=2,
            label_in_chunk=True, missing="keep", optim_update="sparse_adagrad").fit_stream(
            csv_raw_chunk_source(path, chunk_rows=1024), session=sess)
    except NumericalDivergenceError:
        raised = True
    ok &= raised
    return {"cases": cases, "keep_nan_raised": raised, "ok": bool(ok),
            "tolerance": f"theta within {THETA_ATOL} + {THETA_RTOL} x |theta| of the CPU "
                         "path (float32 rounding of the card's products and sums); the "
                         "dense rules at bf16: _bf16_grad_err (every entry within "
                         "n_steps x lr x 2^-8, at most 1% of touched entries past the "
                         "float32 tolerance)"}


def phase_libsvm_hashed(sess, tmp, mem_bw) -> dict:
    """A value-weighted Criteo-width fit from a libsvm file: 524,288 rows x
    26 pairs written by numpy (indices Zipf-drawn below 2^24, values in
    (0, 2]), read through ``libsvm_chunk_source(nnz_per_row=26)`` in 2^17-row
    chunks (the last one held out), ``StreamingHashedLinearEstimator(
    value_weighted=True, n_dense=0, n_cat=26, n_dims=2^22, label_in_chunk=
    True, optim_update='sparse_adagrad')`` with the 'sort' lowering (one
    ``segment_update_sorted`` launch a step, given the pairs' values) and
    the captured replay, 10 epochs, then ``evaluate_device`` on the holdout.
    The parse, fit and evaluation walls and the kernel's launches over the
    fit (reset to 0 before it). Then ``phase_values_update`` at one step of
    this fit, and ``libsvm_hashed_check``."""
    from orange3_spark_tpu_torch.io.libsvm import libsvm_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.ops import segment_sum as ss

    cfg = LIBSVM
    t0 = time.perf_counter()
    idx, dup, v_int, _, y = _libsvm_draw(cfg["rows"], cfg["nnz"], seed=0)
    path = os.path.join(tmp, "pairs.svm")
    _write_libsvm_file(path, idx, dup, v_int, y)
    write_s = time.perf_counter() - t0
    pads = int(dup.sum())
    del idx, dup, v_int
    est = StreamingHashedLinearEstimator(
        value_weighted=True, n_dense=0, n_cat=cfg["nnz"], n_dims=cfg["n_dims"],
        label_in_chunk=True, optim_update="sparse_adagrad", sparse_lowering="sort",
        chunk_rows=cfg["chunk_rows"], epochs=cfg["epochs"], step_size=cfg["step_size"],
        reg_param=cfg["reg_param"])
    n_chunks = -(-cfg["rows"] // cfg["chunk_rows"])
    est.warm_replay(n_chunks - cfg["holdout_chunks"], session=sess)
    src = libsvm_chunk_source(path, nnz_per_row=cfg["nnz"], chunk_rows=cfg["chunk_rows"])
    st: dict = {}
    ss.segment_update_sorted.launches = 0
    t0 = time.perf_counter()
    model = est.fit_stream(src, session=sess, cache_device=True,
                           holdout_chunks=cfg["holdout_chunks"], stage_times=st)
    sess.synchronize()
    fit_s = time.perf_counter() - t0
    launches = ss.segment_update_sorted.launches
    t0 = time.perf_counter()
    ev = model.evaluate_device(model.holdout_chunks_)
    eval_s = time.perf_counter() - t0
    update = phase_values_update(model, sess, mem_bw)
    check = libsvm_hashed_check(sess, tmp)
    os.unlink(path)
    n_train = n_chunks - cfg["holdout_chunks"]
    line = {**cfg, "write_s": write_s, "pads": pads, "parse_s": st["parse_s"],
            "fit_s": fit_s, "epoch_s": st["epoch_s"], "replay_source": st["replay_source"],
            "graph_capture_s": st["graph_capture_s"],
            "replay_ms_per_epoch": 1e3 * (st["replay_fused_s"] - st["graph_capture_s"])
            / (cfg["epochs"] - 1),
            "eval_s": eval_s, "holdout": ev, "n_steps": model.n_steps_,
            "segment_update_sorted_launches": launches,
            # the wrapper counts its own calls: epoch 1's eager steps, the
            # capture's warm step and the captured epoch; each replay of the
            # graph then launches the captured kernels without a call
            "launches_expected": n_train + 1 + n_train,
            "graph_replays": cfg["epochs"] - 1, "segment_update": update, "check": check,
            "cuts": None}
    if not (launches == n_train + 1 + n_train and model.n_steps_ == cfg["epochs"] * n_train
            and st["replay_source"] == "fused" and check["ok"] and ev["auc"] > 0.55):
        raise AssertionError(f"libsvm_hashed failed its checks: {line}")
    return line


# bench.py's overload config (bench.py:1422-1631), at bench's sizes
OVERLOAD = dict(requests=64, service_ms=25.0, rows_fit=1 << 14, n_dense=4, n_cat=4,
                n_dims=1 << 14, chunk_rows=4096, seed=7, stagger_s=0.002,
                deadline_s=0.1, min_req=64, max_req=256)
# the brownout drill's fit: 8192 x 8, logistic, 2 epochs, 1024-row chunks
BROWNOUT = dict(rows=8192, d=8, chunk_rows=1024, epochs=2,
                spec="mem_pressure:frac=0.97,after=2")
PROFILE_MS = 200.0


def _http(url, method="GET"):
    """(status, body bytes) of one loopback request to the telemetry
    endpoint; an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _trace_kernel_events(path) -> dict:
    """Events of a capture's Chrome trace (``torch_trace/trace.json`` under
    the capture's directory): all of them, and the CUDA kernels among them
    (category ``kernel``)."""
    with open(os.path.join(path, "torch_trace", "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    return {"events": len(events), "kernel_events": len(kernels),
            "kernel_names": sorted({e.get("name", "")[:60] for e in kernels})[:8]}


def _with_env(env: dict, fn):
    """``fn()`` with ``env`` set in os.environ, restored afterwards."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _overload_fit_check(model, X, y, est_kw, sess) -> dict:
    """The overload phase's CTR fit held on the card: its theta against
    the same fit on the CPU (``_check_adam``'s tolerance: final losses
    within 1e-5 relative; θ within THETA_ATOL + THETA_RTOL·|θ| on all but
    1e-4 of each parameter's entries and within 2·lr·steps everywhere),
    and ``segment_sum_sorted`` at one 'adam' step's inputs of this model
    (2^14 slots; the first cached chunk of the same fit with the device
    cache) against its plain version on a CPU copy: bitwise on every
    segment of at most ``walk_max()`` rows, within 1e-6·Σ|g| of the
    float64 sum on longer ones."""
    import torch

    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.ops import segment_sum as ss

    def fit(session, **kw):
        return StreamingHashedLinearEstimator(**est_kw).fit_stream(
            array_chunk_source(X, y, chunk_rows=est_kw["chunk_rows"]), session=session, **kw)

    cpu = fit(TorchSession("cpu"))
    lr, steps = est_kw["step_size"], model.n_steps_
    off, worst = {}, {}
    for k, want in cpu.theta.items():
        err = (model.theta[k].cpu() - want).abs()
        off[k] = int((err > THETA_ATOL + THETA_RTOL * want.abs()).sum())
        worst[k] = float(err.max())
    loss_rel = (abs(model.final_loss_ - cpu.final_loss_) / abs(cpu.final_loss_)
                if cpu.final_loss_ else None)
    fit_ok = (steps == cpu.n_steps_ and steps > 0
              and (loss_rel is None or loss_rel <= 1e-5)
              and all(off[k] <= 1e-4 * cpu.theta[k].numel() for k in off)
              and all(w <= 2 * lr * steps for w in worst.values()))

    g, seg, n_slots, skip = _step_segment_inputs(fit(sess, cache_device=True), sess)
    got = ss.segment_sum_sorted(g, seg, n_slots, skip_last=skip).cpu()
    skip_cpu = None if skip is None else skip.cpu()
    want = ss.segment_sum_sorted_reference(g.cpu(), seg.cpu(), n_slots, skip_last=skip_cpu)
    rows = torch.bincount(seg.cpu(), minlength=n_slots)[:n_slots]
    short = rows <= ss.walk_max()
    f64 = ss.segment_sum_sorted_reference(g.cpu().double(), seg.cpu(), n_slots,
                                          skip_last=skip_cpu)
    abs64 = ss.segment_sum_sorted_reference(g.cpu().double().abs(), seg.cpu(), n_slots,
                                            skip_last=skip_cpu)
    long_ok = bool(((got.double() - f64).abs() <= 1e-6 * abs64)[~short].all())
    mismatches = int((got != want)[short].sum())
    return {"fit_vs_cpu": {"steps": steps, "loss_rel_err": loss_rel,
                           "theta_max_abs_err": worst, "entries_past_tolerance": off,
                           "ok": fit_ok},
            "segment_sum_at_step": {"M": g.shape[0], "k": g.shape[1], "n_slots": n_slots,
                                    "max_segment_rows": int(rows.max()),
                                    "long_segments": int((~short).sum()),
                                    "max_abs_err": float((got - want).abs().max()),
                                    "cpu_order_mismatches": mismatches,
                                    "long_within_1e-6_sum_abs": long_ok,
                                    "ok": mismatches == 0 and long_ok},
            "tolerance": "theta: _check_adam's; kernel: bitwise the CPU's index order on "
                         "segments of at most walk_max() rows, 1e-6·Σ|g| of f64 beyond"}


def _rung3_drop(chunks, dev) -> dict:
    """The brownout ladder's rung 3 on the fit's own device cache
    (``io/streaming._DeviceCache``) at the drill's chunk shapes, with no
    other thread allocating: the first two offers are cached, the third
    lands on rung 3 and drops the cache. ``memory_allocated`` read just
    before and just after that offer must fall by at least the dropped
    bytes, and the cache's ledger entry must read 0."""
    import torch

    from orange3_spark_tpu_torch.io.streaming import _DeviceCache, _pad_chunk
    from orange3_spark_tpu_torch.obs import prof
    from orange3_spark_tpu_torch.resilience import inject_faults

    cache = _DeviceCache(True, 8 << 30)
    out = {}
    with inject_faults(BROWNOUT["spec"]):
        for i, (X, y) in enumerate(chunks[:3]):
            Xp, yp, wp = _pad_chunk(X, y, None, BROWNOUT["chunk_rows"], BROWNOUT["d"])
            batch = tuple(torch.from_numpy(a).to(dev) for a in (Xp, yp, wp))
            if i == 2:
                torch.cuda.synchronize()
                held = cache.nbytes
                before = torch.cuda.memory_allocated()
                cache.offer(batch)
                torch.cuda.synchronize()
                after = torch.cuda.memory_allocated()
                out = {"cached_bytes": held, "allocated_before": before,
                       "allocated_after": after, "freed_bytes": before - after,
                       "ledger_bytes": prof.LEDGER.get("cache_chunks", cache.ledger_key),
                       "cache_enabled": cache.enabled}
            else:
                cache.offer(batch)
            del batch
    out["ok"] = (out["cached_bytes"] > 0 and out["freed_bytes"] >= out["cached_bytes"]
                 and out["ledger_bytes"] == 0 and not out["cache_enabled"])
    return out


def phase_overload(sess, kind, smi) -> dict:
    """``bench.py --config overload`` (bench.py:1422-1631) at bench's own
    sizes: a ``StreamingHashedLinearEstimator(n_dims=2^14, n_dense=4,
    n_cat=4, epochs=1, step_size=0.05, chunk_rows=4096)`` fit on 16,384 rows
    of ``default_rng(7)`` (adam: its table gradient through
    ``segment_sum_sorted``, counted over the fit; the fit and the kernel
    at its inputs held by ``_overload_fit_check``), then 64 open-loop
    requests, log-uniform on 64-256 rows, 2 ms apart, under
    ``overload:delay_ms=25``, through ``BucketLadder(64, 4096)`` with the
    micro-batcher (max_batch 256, max_wait 1 ms): a raw arm under
    ``OTPU_RESILIENCE=0`` and an admitted arm (0.1 s deadline, 25 ms
    service seed) with the telemetry endpoint bound (``OTPU_OBS_PORT=0``:
    /readyz 503 before the warm-up and 200 after it, /healthz, /metrics,
    /debug/flight, and a ~200 ms ``POST /debug/profile`` over served
    requests whose trace must hold CUDA kernel events); the breaker drill
    (``aot_build:fails=4,key=array`` under a fake clock, then 30 s past);
    the brownout drill (a ``StreamingLinearEstimator`` fit, 8192 x 8, two
    epochs, 1024-row chunks, the device cache, under
    ``mem_pressure:frac=0.97,after=2``: rung 3, coefficients bitwise the
    same fit's without pressure, the cache's ledger entry 0; ``_rung3_drop``
    on the cache at the drill's chunks). Bench's fields, then
    ``telemetry``, ``brownout`` and the checks."""
    import concurrent.futures
    import threading

    import numpy as np
    import torch

    from orange3_spark_tpu_torch.io.streaming import (
        StreamingLinearEstimator, array_chunk_source,
    )
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.obs import flight
    from orange3_spark_tpu_torch.ops.segment_sum import segment_sum_sorted
    from orange3_spark_tpu_torch.resilience import OverloadShedError, inject_faults
    from orange3_spark_tpu_torch.resilience.overload import current_brownout_level, shed_total
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    cfg = OVERLOAD
    n_dense, n_cat, requests = cfg["n_dense"], cfg["n_cat"], cfg["requests"]
    rng = np.random.default_rng(cfg["seed"])
    rows_fit = cfg["rows_fit"]
    X = np.concatenate([
        rng.standard_normal((rows_fit, n_dense)).astype(np.float32),
        rng.integers(0, 1000, (rows_fit, n_cat)).astype(np.float32)], axis=1)
    y = (rng.random(rows_fit) < 0.3).astype(np.float32)
    # ---- the main path: segment_sum_sorted's count starts at 0 here
    segment_sum_sorted.launches = 0
    t0 = time.perf_counter()
    est_kw = dict(n_dims=cfg["n_dims"], n_dense=n_dense, n_cat=n_cat, epochs=1,
                  step_size=0.05, chunk_rows=cfg["chunk_rows"])
    model = StreamingHashedLinearEstimator(**est_kw).fit_stream(
        array_chunk_source(X, y, chunk_rows=cfg["chunk_rows"]), session=sess)
    sess.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = segment_sum_sorted.launches
    # ----
    fit_check = _overload_fit_check(model, X, y, est_kw, sess)
    sizes = np.exp(rng.uniform(np.log(cfg["min_req"]), np.log(cfg["max_req"]),
                               requests)).astype(np.int64)
    offs = rng.integers(0, rows_fit - int(sizes.max()), requests)
    ladder = BucketLadder(min_bucket=64, max_bucket=1 << 12)
    telemetry: dict = {}

    def get(ctx, route, method="GET"):
        code, body = _http(ctx._telemetry.url + route, method)
        return code, body

    def run_arm(label: str, probe: bool) -> dict:
        lat_ok, lat_shed, lost = [], [], 0
        with ServingContext(ladder, micro_batch=True, max_batch=256,
                            max_wait_ms=1.0) as ctx:
            if probe:
                if ctx._telemetry is None:
                    raise AssertionError("overload: OTPU_OBS_PORT=0 bound no endpoint")
                telemetry["url_port"] = ctx._telemetry.port
                telemetry["readyz_before_warmup"] = get(ctx, "/readyz")[0]
            ctx.warmup(model, n_cols=n_dense + n_cat, kinds=("array",))
            if probe:
                telemetry["readyz_after_warmup"] = get(ctx, "/readyz")[0]

            def one(i: int):
                time.sleep(i * cfg["stagger_s"])    # the arrival schedule
                o, sz = int(offs[i]), int(sizes[i])
                t1 = time.perf_counter()
                try:
                    out = model.predict(X[o:o + sz])
                    if out.shape[0] != sz:
                        raise AssertionError(f"{out.shape[0]} rows served for {sz}")
                    return "ok", (time.perf_counter() - t1) * 1e3
                except OverloadShedError:
                    return "shed", (time.perf_counter() - t1) * 1e3

            t1 = time.perf_counter()
            with inject_faults(f"overload:delay_ms={cfg['service_ms']}"):
                # shutdown(wait=False): a hung future is REPORTED as
                # hung_futures, not joined forever
                ex = concurrent.futures.ThreadPoolExecutor(requests)
                try:
                    futs = [ex.submit(one, i) for i in range(requests)]
                    done, pending = concurrent.futures.wait(futs, timeout=120.0)
                    lost = len(pending)
                    for f in done:
                        what, ms = f.result()
                        (lat_ok if what == "ok" else lat_shed).append(ms)
                finally:
                    ex.shutdown(wait=False)
            wall = time.perf_counter() - t1
            # bench's counts cover the burst alone, not the probes below
            counts = {"typed_sheds": shed_total(), "traced": _traced_requests_total()}
            if probe:
                code, body = get(ctx, "/healthz")
                hz = json.loads(body)
                telemetry["healthz"] = {"status": code, "sheds": hz.get("sheds"),
                                        "brownout_level": hz.get("brownout_level"),
                                        "in_flight": hz.get("in_flight")}
                code, body = get(ctx, "/readyz")
                telemetry["readyz_serving"] = code
                code, body = get(ctx, "/metrics")
                text = body.decode()
                telemetry["metrics"] = {"status": code, "bytes": len(body),
                                        "has_shed_total": "otpu_shed_total" in text,
                                        "has_device_bytes": "otpu_device_bytes" in text}
                code, body = get(ctx, "/debug/flight")
                fb = json.loads(body)
                telemetry["debug_flight"] = {
                    "status": code, "flight_schema": fb.get("flight_schema"),
                    "reason": fb.get("reason"), "sheds": fb.get("sheds"),
                    "has_device_memory": "device_memory" in fb,
                    "allocator": (fb.get("device_memory") or {}).get(
                        "reconciliation", {}).get("allocator")}
                # the deep capture: a ~200 ms profile while this thread
                # serves requests (no injected delay: the card's own work)
                res: dict = {}
                th = threading.Thread(target=lambda: res.update(zip(
                    ("code", "body"),
                    get(ctx, f"/debug/profile?duration_ms={PROFILE_MS}", "POST"))))
                th.start()
                served = 0
                t2 = time.perf_counter()
                while th.is_alive() and time.perf_counter() - t2 < 30.0:
                    o, sz = int(offs[served % requests]), int(sizes[served % requests])
                    model.predict(X[o:o + sz])
                    served += 1
                th.join(60.0)
                body = json.loads(res.get("body") or b"{}")
                cap = {"status": res.get("code"), "served_during": served,
                       "duration_ms": body.get("duration_ms")}
                if res.get("code") == 200:
                    cap.update(_trace_kernel_events(body["path"]))
                telemetry["profile"] = cap
        return {"lat_ok": lat_ok, "sheds": len(lat_shed), "lost": lost, "wall_s": wall,
                "completed": len(lat_ok), "rows_total": int(sizes.sum()), **counts}

    def pctl(lat, q):
        return float(np.percentile(np.asarray(lat), q))

    # a phase of its own, as bench's overload is a process of its own: an
    # earlier phase's automatic bundle (the wedge demo's) must not hold the
    # rate slot the first shed's bundle needs
    flight.reset_rate_limit()
    flight0 = flight.bundles_written()
    raw = _with_env({"OTPU_RESILIENCE": "0"}, lambda: run_arm("raw", False))
    shed0 = shed_total()
    traced0 = _traced_requests_total()
    adm = _with_env({"OTPU_RESILIENCE": "1", "OTPU_OBS_PORT": "0",
                     "OTPU_ADMISSION_DEADLINE_S": str(cfg["deadline_s"]),
                     "OTPU_ADMISSION_SERVICE_MS": str(cfg["service_ms"])},
                    lambda: run_arm("admitted", True))
    typed_sheds = adm["typed_sheds"] - shed0
    traced_requests = adm["traced"] - traced0

    # ---- the circuit-breaker drill: a flaky build re-admitted half-open
    def breaker_drill():
        clk = [0.0]
        with ServingContext(ladder, breaker_clock=lambda: clk[0]) as ctx2:
            with inject_faults("aot_build:fails=4,key=array"):
                model.predict(X[:64])         # the build exhausts its retries: open
            was_open = ctx2.breaker_states().get("HashedLinearModel:array") == "open"
            clk[0] += 30.0                    # past the seeded cooldown
            model.predict(X[:64])             # the half-open probe build succeeds
            return was_open and (ctx2.breaker_states().get("HashedLinearModel:array")
                                 == "closed")

    breaker_readmitted = _with_env({"OTPU_RETRY_BASE_S": "0.02"}, breaker_drill)

    # ---- the brownout drill: injected memory pressure degrades, not dies
    Xs = rng.standard_normal((BROWNOUT["rows"], BROWNOUT["d"])).astype(np.float32)
    ys = (Xs @ rng.standard_normal(BROWNOUT["d"]).astype(np.float32) > 0).astype(np.float32)

    def brownout_fit(st):
        return StreamingLinearEstimator(
            loss="logistic", epochs=BROWNOUT["epochs"], step_size=0.05,
            chunk_rows=BROWNOUT["chunk_rows"],
        ).fit_stream(array_chunk_source(Xs, ys, chunk_rows=BROWNOUT["chunk_rows"]),
                     n_features=BROWNOUT["d"], session=sess, cache_device=True,
                     stage_times=st)

    st_p, st_c = {}, {}
    with inject_faults(BROWNOUT["spec"]):
        m_p = brownout_fit(st_p)
        sess.synchronize()
    brownout_reached = current_brownout_level()
    dm = m_p.run_report_.to_dict().get("device_memory", {})
    m_c = brownout_fit(st_c)
    sess.synchronize()
    coef_bitwise = (torch.equal(m_p.coef, m_c.coef)
                    and torch.equal(m_p.intercept, m_c.intercept))
    chunks = [(Xs[i:i + BROWNOUT["chunk_rows"]], ys[i:i + BROWNOUT["chunk_rows"]])
              for i in range(0, BROWNOUT["rows"], BROWNOUT["chunk_rows"])]
    drop = _rung3_drop(chunks, sess.device)
    brownout = {"level_reached": brownout_reached,
                "replay_source": st_p.get("replay_source"),
                "replay_source_without_pressure": st_c.get("replay_source"),
                "coef_bitwise": coef_bitwise,
                "cache_entry_bytes_at_fit_end": dm.get("cache_entry_bytes"),
                "rung3_drop": drop}

    bundles = []
    fdir = os.environ.get("OTPU_FLIGHT_DIR", "")
    for name in sorted(os.listdir(fdir)) if fdir and os.path.isdir(fdir) else ():
        if name.startswith("flight-") and name.endswith("-overload_shed.json"):
            with open(os.path.join(fdir, name)) as f:
                b = json.load(f)
            bundles.append({"file": name, "reason": b.get("reason"),
                            "flight_schema": b.get("flight_schema"),
                            "error": (b.get("error") or {}).get("type")})

    p99_raw = pctl(raw["lat_ok"], 99) if raw["lat_ok"] else None
    p99_adm = pctl(adm["lat_ok"], 99) if adm["lat_ok"] else None
    line = {
        "config": "bench.py --config overload (bench.py:1422-1631), bench's sizes",
        "device": kind, "nvidia_smi": smi,
        "requests": requests, "service_ms_injected": cfg["service_ms"],
        "fit_s": fit_s, "segment_sum_launches": fit_launches, "fit_check": fit_check,
        "p50_ms_raw": pctl(raw["lat_ok"], 50) if raw["lat_ok"] else None,
        "p99_ms_raw": p99_raw,
        "p50_ms_admitted": pctl(adm["lat_ok"], 50) if adm["lat_ok"] else None,
        "p99_ms_admitted": p99_adm,
        "p99_bound_factor": (p99_raw / p99_adm if p99_raw and p99_adm else None),
        "sheds": adm["sheds"], "typed_sheds": typed_sheds,
        "shed_fraction": adm["sheds"] / requests,
        "completed": adm["completed"], "hung_futures": adm["lost"],
        "lost_futures": requests - adm["completed"] - adm["sheds"] - adm["lost"],
        "goodput_rows_per_s_per_chip": ((adm["rows_total"] / requests) * adm["completed"]
                                        / adm["wall_s"] / 1),
        "legacy_unbounded": (raw["sheds"] == 0 and raw["lost"] == 0
                             and raw["completed"] == requests),
        "raw_wall_s": raw["wall_s"], "admitted_wall_s": adm["wall_s"],
        "breaker_readmitted": breaker_readmitted,
        "brownout_level_reached": brownout_reached,
        "traced_requests": traced_requests, "trace_coverage": traced_requests / requests,
        "flight_bundles_written": flight.bundles_written() - flight0,
        "overload_shed_bundles": bundles,
        "telemetry": telemetry, "brownout": brownout,
    }
    prof_line = telemetry.get("profile", {})
    failed = [name for name, ok in (
        ("legacy_unbounded", line["legacy_unbounded"]),
        ("hung_or_lost_futures", line["hung_futures"] == line["lost_futures"] == 0),
        ("typed_sheds", typed_sheds == adm["sheds"]),
        ("p99_admitted_below_raw", p99_adm is not None and p99_raw is not None
         and p99_adm < p99_raw),
        ("breaker_readmitted", breaker_readmitted),
        ("brownout_level_3", brownout_reached == 3),
        ("overload_shed_bundle", any(b["reason"] == "overload_shed"
                                     and b["flight_schema"] == 1 for b in bundles)),
        ("segment_sum_launched", fit_launches > 0),
        ("fit_matches_cpu", fit_check["fit_vs_cpu"]["ok"]),
        ("segment_sum_matches_plain", fit_check["segment_sum_at_step"]["ok"]),
        ("brownout_coef_bitwise", coef_bitwise),
        ("brownout_restreamed", st_p.get("replay_source") == "stream"),
        ("rung3_memory_freed", drop["ok"]),
        ("cache_ledger_zero", dm.get("cache_entry_bytes") == 0),
        ("readyz_503_before_warmup", telemetry.get("readyz_before_warmup") == 503),
        ("readyz_200_after_warmup", telemetry.get("readyz_after_warmup") == 200),
        ("healthz", telemetry.get("healthz", {}).get("status") == 200
         and telemetry["healthz"].get("sheds") is not None
         and telemetry["healthz"].get("brownout_level") is not None),
        ("metrics", telemetry.get("metrics", {}).get("status") == 200
         and telemetry["metrics"]["has_shed_total"]),
        ("debug_flight", telemetry.get("debug_flight", {}).get("status") == 200
         and telemetry["debug_flight"]["flight_schema"] == 1),
        # a CPU-only trace is no capture of the card
        ("profile_cuda_kernels", prof_line.get("status") == 200
         and prof_line.get("kernel_events", 0) > 0),
    ) if not ok]
    line["failed"] = failed
    if failed:
        if "profile_cuda_kernels" in failed:
            print("chip_smoke: the profiler recorded no CUDA kernel event on this "
                  f"machine: {prof_line}", file=sys.stderr)
        raise AssertionError(f"overload failed {failed}: {line}")
    return line


# ------------------------------------------- the serving fleet, tenancy, online
# bench.py's fleet, tenancy and online configs (bench.py:1634-2306,
# 2308-2646, 2648-3001) at bench's sizes. bench pins its replica processes
# to the CPU; here every replica serves on the card (``--device cuda``): a
# fresh interpreter each, spawned by Popen, with its own CUDA context.
FLEET = dict(requests=64, service_ms=30.0, straggler_ms=400.0, replicas=4, seed=7,
             rows_fit=1 << 13, n_dense=4, n_cat=4, n_dims=1 << 12, chunk_rows=2048,
             ladder_max=1 << 9)
TENANCY = dict(service_ms=20.0, n_light=12, n_heavy=96, drill_service_ms=30.0)
ONLINE = dict(rows=4096, n_dims=1 << 10, chunk_rows=1024, seed=3,
              trainer=dict(chunk_rows=256, join_window=64, ckpt_steps=4))
# a replica's start on the card: the interpreter, torch, the CUDA context
# and one captured graph a ladder rung, several replicas at once
FLEET_READY_S = 240.0
# the replicas' own host threads: five processes share the machine's cores
REPLICA_ENV = {"OMP_NUM_THREADS": "1"}


def _ctr_xy(seed: int, rows: int, n_dense: int, n_cat: int, levels: int = 500):
    """bench's CTR rows: normal dense columns, integer codes, 30 % positives."""
    import numpy as np

    r = np.random.default_rng(seed)
    X = np.concatenate([r.standard_normal((rows, n_dense)).astype(np.float32),
                        r.integers(0, levels, (rows, n_cat)).astype(np.float32)], axis=1)
    y = (r.random(rows) < 0.3).astype(np.float32)
    return X, y


@contextlib.contextmanager
def _env(**set_to):
    """Set (a string) or unset (None) environment variables for the block,
    and restore their values after it (the bench arms' convention)."""
    saved = {k: os.environ.get(k) for k in set_to}
    try:
        for k, v in set_to.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _start_fleet(managers, root, n, env, ladder_max, per_replica_env=None) -> tuple:
    """A ``ReplicaManager`` of ``n`` replicas on the card, started and
    ready; returns (manager, the start line: seconds from spawn to the
    first /readyz 200 of each replica, each replica's device from its
    /healthz)."""
    from orange3_spark_tpu_torch.fleet.supervisor import ReplicaManager

    mgr = ReplicaManager(root, n_replicas=n, ladder_max=ladder_max, device="cuda",
                         env={**REPLICA_ENV, **env}, per_replica_env=per_replica_env)
    managers.append(mgr)
    t0 = time.perf_counter()
    mgr.start()
    if not mgr.wait_ready(timeout_s=FLEET_READY_S):
        raise AssertionError(f"{n} replica(s) on the card not ready in {FLEET_READY_S:.0f} s; "
                             f"logs under {mgr.log_dir}")
    devices = {}
    for h in mgr.handles:
        status, body = mgr.client(h.replica_id).get_json("/healthz")
        devices[f"replica-{h.replica_id}"] = body.get("device")
    return mgr, {"ready_s": [h.ready_after_s for h in mgr.handles],
                 "all_ready_s": time.perf_counter() - t0, "devices": devices}


def _counter_total(name) -> int:
    from orange3_spark_tpu_torch.obs.registry import REGISTRY

    m = REGISTRY.get(name)
    return int(m.total()) if m is not None else 0


def phase_fleet(sess) -> dict:
    """``bench.py --config fleet`` (bench.py:1634-2306) at bench's sizes
    with every replica a process on the card: a
    ``StreamingHashedLinearEstimator(n_dims=2^12, n_dense=4, n_cat=4,
    step_size=0.05, chunk_rows=2048)`` fit of 8192 rows (``default_rng(7)``)
    published, then 64 requests log-uniform on 64-256 rows over 8 threads
    under ``OTPU_ADMISSION_MAX_INFLIGHT=1`` and ``overload:delay_ms=30`` in
    each replica: one replica against ``OTPU_FLEET_REPLICAS`` (4; bench's
    one re-measure under 2.5x), the collector's A/B and the SLO burn drill,
    a SIGKILL mid-burst, a rolling swap under traffic and a poisoned
    version, a 400 ms straggler unhedged and hedged, the wire's fresh /
    keep-alive / fast-path arms on a replica without injected service, and
    ``OTPU_FLEET=0``. Bench's fields, each manager's start (seconds from
    spawn to ready a replica) and devices, and bench's bars
    (tests/test_bench_contract.py's fleet assertions) as ``failed``."""
    import concurrent.futures
    import json as _json
    import threading

    import numpy as np

    from orange3_spark_tpu_torch.fleet import FleetFrontend
    from orange3_spark_tpu_torch.fleet.rollout import Rollout, publish_version, read_current
    from orange3_spark_tpu_torch.fleet.router import FleetRouter, HedgeSchedule
    from orange3_spark_tpu_torch.fleet.rpc import (
        NoReplicaAvailableError, ReplicaDrainingError, ReplicaUnavailableError,
    )
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.obs import fleetobs as fobs
    from orange3_spark_tpu_torch.obs import flight
    from orange3_spark_tpu_torch.obs.prof import LEDGER
    from orange3_spark_tpu_torch.obs.registry import REGISTRY

    cfg = FLEET
    requests, service_ms, n_replicas = cfg["requests"], cfg["service_ms"], cfg["replicas"]
    n_dense, n_cat, rows_fit = cfg["n_dense"], cfg["n_cat"], cfg["rows_fit"]
    n_chips = sess.n_devices
    typed = (ReplicaUnavailableError, ReplicaDrainingError, NoReplicaAvailableError)
    X, y = _ctr_xy(cfg["seed"], rows_fit, n_dense, n_cat)

    def fit(epochs):
        return StreamingHashedLinearEstimator(
            n_dims=cfg["n_dims"], n_dense=n_dense, n_cat=n_cat, epochs=epochs,
            step_size=0.05, chunk_rows=cfg["chunk_rows"],
        ).fit_stream(array_chunk_source(X, y, chunk_rows=cfg["chunk_rows"]), session=sess)

    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    managers: list = []
    starts: dict = {}
    rng = np.random.default_rng(cfg["seed"])
    sizes = np.exp(rng.uniform(np.log(64), np.log(256), requests)).astype(np.int64)
    offs = rng.integers(0, rows_fit - int(sizes.max()), requests)
    burst_rows = int(sizes.sum())
    base_env = {"OTPU_ADMISSION_MAX_INFLIGHT": "1",
                "OTPU_FAULT_SPEC": f"overload:delay_ms={service_ms}"}

    def burst(router, n_req=requests, threads=8):
        lat, outcomes = [], []

        def one(i):
            o, s = int(offs[i % requests]), int(sizes[i % requests])
            t0 = time.perf_counter()
            try:
                out = router.predict(X[o:o + s])
            except typed:
                return "typed", (time.perf_counter() - t0) * 1e3
            dt = (time.perf_counter() - t0) * 1e3
            return ("ok" if out.shape[0] == s else "wrong"), dt

        t0 = time.perf_counter()
        ex = concurrent.futures.ThreadPoolExecutor(threads)
        try:
            futs = [ex.submit(one, i) for i in range(n_req)]
            done, pending = concurrent.futures.wait(futs, timeout=300.0)
        finally:
            ex.shutdown(wait=False)
        wall = time.perf_counter() - t0
        for f in done:
            k, ms = f.result()
            outcomes.append(k)
            if k == "ok":
                lat.append(ms)
        return {"lat": lat, "outcomes": outcomes, "wall_s": wall, "pending": len(pending)}

    try:
        with _env(OTPU_FLEET_COALESCE="0"):
            t0 = time.perf_counter()
            model = fit(1)
            sess.synchronize()
            fit_s = time.perf_counter() - t0
            publish_version(model, root, n_cols=n_dense + n_cat)

            # ---- arm 1: one replica
            def single_arm():
                mgr1, st = _start_fleet(managers, root, 1, base_env, cfg["ladder_max"])
                starts.setdefault("single", []).append(st)
                r1 = FleetRouter(mgr1.endpoints(), hedging=False)
                r1.refresh()
                b = burst(r1)
                r1.close()
                mgr1.stop_all()
                if b["outcomes"].count("ok") != requests:
                    raise AssertionError(f"single-replica burst: {b['outcomes']}")
                return b

            b1 = single_arm()
            thr_1 = burst_rows / b1["wall_s"] / n_chips

            # ---- arm 2: N replicas (+ telemetry, kill, rollout on the same fleet)
            mgrN, starts["fleet"] = _start_fleet(managers, root, n_replicas, base_env,
                                                 cfg["ladder_max"])
            rN = FleetRouter(mgrN.endpoints(), hedging=False)
            rN.refresh()
            req0 = _counter_total("otpu_fleet_requests_total")
            prop0 = _counter_total("otpu_fleet_trace_propagated_total")
            bN = burst(rN)
            traced_requests = _counter_total("otpu_fleet_requests_total") - req0
            propagated = _counter_total("otpu_fleet_trace_propagated_total") - prop0
            if bN["outcomes"].count("ok") != requests:
                raise AssertionError(f"fleet burst: {bN['outcomes']}")
            thr_n = burst_rows / bN["wall_s"] / n_chips
            scaling = thr_n / thr_1
            scaling_retried, scaling_first = False, None
            if scaling < 2.5:          # bench's one structured re-measure
                scaling_retried, scaling_first = True, scaling
                b1 = single_arm()
                thr_1 = burst_rows / b1["wall_s"] / n_chips
                bN = burst(rN)
                thr_n = burst_rows / bN["wall_s"] / n_chips
                scaling = thr_n / thr_1

            # ---- the fleet telemetry plane: the collector's A/B, the SLO drill
            col = fobs.FleetCollector(mgrN.endpoints(), router=rN, scrape_s=0.5)
            walls_on, walls_off = [], []
            for _ in range(4):
                col.start()
                walls_on.append(burst(rN)["wall_s"])
                col.stop()
                walls_off.append(burst(rN)["wall_s"])
            wall_on, wall_off = min(walls_on), min(walls_off)
            collector_overhead_pct = (wall_on - wall_off) / wall_off * 100.0
            fleet_digest = col.scrape_once()
            fleetz = col.fleetz()
            ages = [a for a in col.staleness().values() if a is not None]
            scrape_stale_n = len(col.stale_replicas())
            fleet_agg_rpc = fleetz["aggregates"].get("otpu_fleet_rpc_requests_total", 0.0)
            fit_rep = getattr(model, "run_report_", None)
            goodput_rec = (fit_rep.to_dict() if fit_rep is not None else {}).get("goodput")
            ledger_rec = {"parent_owners": LEDGER.owner_bytes(),
                          "replicas": {r.replica: r.device_bytes
                                       for r in fleet_digest.replicas}}
            fobs.reset_fleet_rate_limit()

            def slo_bundles():
                m = REGISTRY.get("otpu_flight_bundles_total")
                if m is None:
                    return 0
                return int(sum(v for k, v in m.per_label("reason").items()
                               if k.startswith("slo_")))

            slo_bundles0 = slo_bundles()
            slo_engine = fobs.SLOEngine(fobs.parse_slo_spec("burn_drill:target=99.0,p99_ms=1"),
                                        fast_s=5.0, slow_s=20.0)
            rS = FleetRouter(mgrN.endpoints(), hedging=False, slo=slo_engine)
            rS.refresh()
            colS = fobs.FleetCollector(mgrN.endpoints(), router=rS, slo=slo_engine,
                                       scrape_s=0.25)
            for _ in range(24):
                rS.predict(X[:64])
            slo_verdicts = slo_engine.evaluate()
            colS.scrape_once()
            colS.join_incident_dump()
            rS.close()
            slo_alerts = len(slo_engine.alerts)
            fleet_incident_bundles = slo_bundles() - slo_bundles0
            fleet_bundle_replicas = None
            if colS.last_incident_path:
                with open(colS.last_incident_path) as f:
                    fleet_bundle_replicas = len(_json.load(f).get("live_replicas", []))
            ref_fobs = np.asarray(rN.predict(X[:128]))
            with _env(OTPU_FLEETOBS="0"):
                off_fobs = np.asarray(rN.predict(X[:128]))
                col_off = fobs.FleetCollector(mgrN.endpoints()).start()
                fleetobs_parity = bool(np.array_equal(ref_fobs, off_fobs)) and not col_off.active

            # ---- kill arm: SIGKILL one replica mid-burst
            expect64 = np.asarray(rN.predict(X[:64]))
            restarts0 = _counter_total("otpu_fleet_replica_restarts_total")
            kill_req = max(24, requests // 2)

            def kone(i):
                time.sleep(i * 0.008)
                try:
                    out = rN.predict(X[:64])
                    return "ok" if np.array_equal(out, expect64) else "wrong"
                except typed:
                    return "typed"
                except Exception:  # noqa: BLE001 - an untyped escape is 'lost'
                    return "lost"

            ex = concurrent.futures.ThreadPoolExecutor(8)
            try:
                t_kill0 = time.perf_counter()
                futs = [ex.submit(kone, i) for i in range(kill_req)]
                time.sleep(0.1)
                mgrN.kill(0)
                done, pending = concurrent.futures.wait(futs, timeout=120.0)
                kill_hung = len(pending)
                kill_outcomes = [f.result() for f in done]
            finally:
                ex.shutdown(wait=False)
            deadline = time.monotonic() + FLEET_READY_S
            readmitted = False
            while time.monotonic() < deadline:
                rN.refresh()
                ep = rN.endpoint(0)
                if ep.ready and ep.breaker.state() != "open":
                    readmitted = True
                    break
                time.sleep(0.25)
            kill_recovery_s = time.perf_counter() - t_kill0
            replica_restarted = _counter_total("otpu_fleet_replica_restarts_total") > restarts0
            restarted_device = mgrN.client(0).get_json("/healthz")[1].get("device")

            # ---- rollout arm: a rolling swap under traffic, a poisoned version
            model2 = fit(2)
            v2 = publish_version(model2, root, n_cols=n_dense + n_cat)
            stop = threading.Event()
            ro_fails: list = []
            ro_oks: list = []

            def traffic():
                while not stop.is_set():
                    try:
                        rN.predict(X[:64])
                        ro_oks.append(1)
                    except Exception as e:  # noqa: BLE001 - the claim is zero
                        ro_fails.append(repr(e))
                    time.sleep(0.01)

            th = threading.Thread(target=traffic)
            th.start()
            try:
                ro_res = Rollout(rN, root, canary_input=X[:16]).roll(v2)
            finally:
                stop.set()
                th.join(timeout=10)
            v2_ref = np.asarray(rN.predict(X[:64]))
            bad = os.path.join(root, ".staging-bad")
            os.makedirs(bad, exist_ok=True)
            with open(os.path.join(bad, "model.pkl"), "wb") as f:
                f.write(b"poisoned payload, not a pickle")
            os.replace(bad, os.path.join(root, "v0099"))
            rb_res = Rollout(rN, root, canary_input=X[:16]).roll("v0099")
            current_after = read_current(root)
            post_ok = bool(np.array_equal(np.asarray(rN.predict(X[:64])), v2_ref))
            rN.close()
            mgrN.stop_all()

            # ---- hedge arm: one straggler replica, unhedged against hedged
            strag_env = {n_replicas - 1: {
                "OTPU_FAULT_SPEC": f"overload:delay_ms={cfg['straggler_ms']}"}}
            mgrH, starts["hedge"] = _start_fleet(managers, root, n_replicas, base_env,
                                                 cfg["ladder_max"], per_replica_env=strag_env)
            rU = FleetRouter(mgrH.endpoints(), hedging=False)
            rU.refresh()
            bU = burst(rU)
            rU.close()
            hedges0 = _counter_total("otpu_fleet_hedges_total")
            wins0 = _counter_total("otpu_fleet_hedge_wins_total")
            rH = FleetRouter(mgrH.endpoints(), hedging=True,
                             schedule=HedgeSchedule(floor_ms=2 * service_ms))
            rH.refresh()
            bH = burst(rH)
            rH.close()
            mgrH.stop_all()
            hedges = _counter_total("otpu_fleet_hedges_total") - hedges0
            hedge_wins = _counter_total("otpu_fleet_hedge_wins_total") - wins0
            p99_u, p99_h = _pctl(bU["lat"], 99), _pctl(bH["lat"], 99)

        # ---- wire arms: fresh TCP, keep-alive, the fast path (no injected service)
        mgrW, starts["wire"] = _start_fleet(managers, root, 1, {}, cfg["ladder_max"])
        wire_arms = {
            "fresh": {"OTPU_FLEET_FASTWIRE": "0"},
            "keepalive": {"OTPU_FLEET_FASTWIRE": "1", "OTPU_FLEET_SHM": "0",
                          "OTPU_FLEET_COALESCE": "0"},
            "fastpath": {"OTPU_FLEET_FASTWIRE": "1", "OTPU_FLEET_SHM": "1",
                         "OTPU_FLEET_COALESCE": "1", "OTPU_FLEET_COALESCE_WAIT_MS": "0.5"},
        }
        wire_keys = sorted({k for e in wire_arms.values() for k in e}
                           | {"OTPU_FLEET_SHM_MIN_BYTES"})

        def wire_burst(threads=16, per_thread=30, rows=64):
            router = FleetRouter(mgrW.endpoints(), hedging=False)
            router.refresh()
            for _ in range(5):
                router.predict(X[:rows])
            lat: list = []
            outcomes: list = []
            lock = threading.Lock()

            def worker():
                mine, outs = [], []
                for _ in range(per_thread):
                    t0 = time.perf_counter()
                    try:
                        out = router.predict(X[:rows])
                        outs.append("ok" if out.shape[0] == rows else "wrong")
                    except typed:
                        outs.append("typed")
                    except Exception:  # noqa: BLE001 - untyped escape = lost
                        outs.append("lost")
                    mine.append((time.perf_counter() - t0) * 1e3)
                with lock:
                    lat.extend(mine)
                    outcomes.extend(outs)

            ts = [threading.Thread(target=worker) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120.0)
            hung = sum(1 for t in ts if t.is_alive())
            co = router.coalescer.stats()
            pool: dict = {}
            for ep in router.endpoints:
                p = getattr(ep.client, "pool", None)
                if p is not None:
                    s = p.stats()
                    for k in ("opened", "reused", "stale_retries"):
                        pool[k] = pool.get(k, 0) + s[k]
            router.close()
            return {"lat": lat, "outcomes": outcomes, "hung": hung, "coalesce": co,
                    "pool": pool}

        def with_arm(env, fn):
            with _env(**{**dict.fromkeys(wire_keys), **env}):
                return fn()

        wire_rounds: dict = {name: [] for name in wire_arms}
        wire_last: dict = {}
        for _round in range(3):
            for name, env in wire_arms.items():
                res = with_arm(env, wire_burst)
                wire_rounds[name].append(_pctl(res["lat"], 50))
                wire_last[name] = res
        wire_p50 = {name: min(v) for name, v in wire_rounds.items()}
        co_fast = wire_last["fastpath"]["coalesce"]
        wire_outcomes = [o for r in wire_last.values() for o in r["outcomes"]]
        wire_hung = sum(r["hung"] for r in wire_last.values())
        conn_reuse = wire_last["fastpath"]["pool"]
        reuse_total = conn_reuse.get("opened", 0) + conn_reuse.get("reused", 0)

        def wire_ref():
            router = FleetRouter(mgrW.endpoints(), hedging=False)
            router.refresh()
            try:
                return np.asarray(router.predict(X[:200]))
            finally:
                router.close()

        ref_legacy = with_arm(wire_arms["fresh"], wire_ref)
        ref_fast = with_arm(dict(wire_arms["fastpath"], OTPU_FLEET_SHM_MIN_BYTES="0"), wire_ref)
        fastwire_parity = bool(np.array_equal(ref_legacy, ref_fast))
        mgrW.stop_all()

        # ---- the kill switch: OTPU_FLEET=0 is the single-process path
        with _env(OTPU_FLEET="0"):
            fe = FleetFrontend(model2)
            kill_switch_parity = bool(np.array_equal(fe.predict(X[:256]),
                                                     model2.predict(X[:256])))
            kill_switch_local = fe.mode == "local" and fe.manager is None
            fe.close()
    finally:
        for m in managers:
            m.stop_all()
        shutil.rmtree(root, ignore_errors=True)

    all_devices = [d for st in starts.values() for s in (st if isinstance(st, list) else [st])
                   for d in s["devices"].values()] + [restarted_device]
    line = {
        "replicas": n_replicas, "requests": requests, "burst_rows": burst_rows,
        "service_ms_injected": service_ms, "fit_s": fit_s,
        "replica_start": starts, "replica_devices_cuda": all(
            str(d).startswith("cuda") for d in all_devices),
        "throughput_single_rows_per_s_per_chip": thr_1,
        "throughput_fleet_rows_per_s_per_chip": thr_n,
        "scaling_factor": scaling, "scaling_retried": scaling_retried,
        "scaling_factor_first": scaling_first,
        "wall_single_s": b1["wall_s"], "wall_fleet_s": bN["wall_s"],
        "straggler_ms_injected": cfg["straggler_ms"],
        "p50_ms_unhedged": _pctl(bU["lat"], 50), "p99_ms_unhedged": p99_u,
        "p50_ms_hedged": _pctl(bH["lat"], 50), "p99_ms_hedged": p99_h,
        "hedged_p99_ratio": p99_h / p99_u if p99_u else None,
        "hedges_issued": hedges, "hedge_wins": hedge_wins,
        "kill_requests": kill_req, "kill_completed": kill_outcomes.count("ok"),
        "kill_typed_failures": kill_outcomes.count("typed"),
        "kill_wrong_results": kill_outcomes.count("wrong"), "kill_hung": kill_hung,
        "kill_lost": kill_outcomes.count("lost"), "replica_restarted": replica_restarted,
        "killed_replica_readmitted": readmitted, "kill_recovery_s": kill_recovery_s,
        "restarted_replica_device": restarted_device,
        "rollout_outcome": ro_res["outcome"], "rollout_failed_requests": len(ro_fails),
        "rollout_traffic_requests": len(ro_oks), "rollout_version": ro_res["version"],
        "rollback_outcome": rb_res["outcome"], "rollback_current_untouched": current_after == v2,
        "rollback_post_traffic_ok": post_ok,
        "traced_requests": traced_requests,
        "trace_coverage": propagated / traced_requests if traced_requests else None,
        "flight_bundles_written": flight.bundles_written(),
        "collector_overhead_pct": collector_overhead_pct,
        "wall_scrape_on_s": wall_on, "wall_scrape_off_s": wall_off,
        "scrape_stale_replicas": scrape_stale_n,
        "scrape_age_max_s": max(ages) if ages else None,
        "fleet_agg_rpc_requests": fleet_agg_rpc,
        "fleet_replicas_scraped": sorted(fleetz["replicas"]),
        "slo_alerts": slo_alerts,
        "slo_burn_long": slo_verdicts[0]["rules"]["fast"]["burn_long"],
        "slo_budget_remaining": slo_verdicts[0]["budget_remaining"],
        "fleet_incident_bundles": fleet_incident_bundles,
        "fleet_bundle_replicas": fleet_bundle_replicas,
        "fleetobs_kill_switch_parity": fleetobs_parity,
        "goodput": goodput_rec, "ledger": ledger_rec,
        "wire_fresh_p50_ms": wire_p50["fresh"], "wire_keepalive_p50_ms": wire_p50["keepalive"],
        "wire_fastpath_p50_ms": wire_p50["fastpath"],
        "wire_keepalive_speedup": wire_p50["fresh"] / wire_p50["keepalive"],
        "wire_fastpath_speedup": wire_p50["fresh"] / wire_p50["fastpath"],
        "coalesce_merge_factor": co_fast["merge_factor"],
        "coalesce_members": co_fast["members"], "coalesce_dispatches": co_fast["dispatches"],
        "coalesce_sheds": co_fast["sheds"], "wire_requests": len(wire_outcomes),
        "wire_ok": wire_outcomes.count("ok"), "wire_typed_failures": wire_outcomes.count("typed"),
        "wire_lost": wire_outcomes.count("lost"), "wire_wrong": wire_outcomes.count("wrong"),
        "wire_hung": wire_hung,
        "wire_conn_reuse_pct": (100.0 * conn_reuse.get("reused", 0) / reuse_total
                                if reuse_total else 0.0),
        "wire_conn_stale_retries": conn_reuse.get("stale_retries", 0),
        "fastwire_kill_switch_parity": fastwire_parity,
        "kill_switch_local_parity": kill_switch_parity,
        "kill_switch_no_subprocesses": kill_switch_local,
    }
    gp = goodput_rec or {}
    led = ledger_rec["replicas"]
    # bench's bars: tests/test_bench_contract.py's fleet assertions
    bars = (
        ("replicas_on_cuda", line["replica_devices_cuda"]),
        ("scaling_2_5x", scaling >= 2.5),
        ("hedged_p99_half", line["hedged_p99_ratio"] is not None
         and line["hedged_p99_ratio"] <= 0.5),
        ("hedges_issued", hedges >= 1),
        ("kill_none_hung_or_lost", kill_hung == 0 and line["kill_lost"] == 0),
        ("kill_no_wrong_result", line["kill_wrong_results"] == 0),
        ("kill_accounted", line["kill_completed"] + line["kill_typed_failures"] == kill_req),
        ("replica_restarted", replica_restarted),
        ("killed_replica_readmitted", readmitted),
        ("rollout_completed", ro_res["outcome"] == "completed"),
        ("rollout_zero_failed", not ro_fails),
        ("poisoned_rolled_back", rb_res["outcome"] == "rolled_back"),
        ("rollback_current_untouched", current_after == v2),
        ("trace_coverage_1", line["trace_coverage"] == 1.0),
        ("kill_switch_bitwise", kill_switch_parity and kill_switch_local),
        ("collector_overhead_under_2pct", collector_overhead_pct < 2.0),
        ("scrape_fresh", scrape_stale_n == 0),
        ("fleet_rpc_aggregate", fleet_agg_rpc >= requests),
        ("slo_alerted", slo_alerts >= 1 and line["slo_burn_long"] >= 14.4),
        ("one_fleet_bundle", fleet_incident_bundles == 1
         and fleet_bundle_replicas == n_replicas),
        ("fleetobs_kill_switch_bitwise", fleetobs_parity),
        ("goodput_fractions", bool(gp) and abs(sum(gp["fractions"].values()) - 1.0) <= 0.02),
        ("ledger_serve_executables", len(led) == n_replicas
         and any("serve_executables" in dev for dev in led.values())),
        ("wire_fastpath_3x", line["wire_fastpath_speedup"] >= 3.0),
        ("coalesce_merge_2x", co_fast["merge_factor"] >= 2.0 and co_fast["dispatches"] >= 1),
        ("wire_none_lost_hung_wrong", line["wire_lost"] == line["wire_hung"]
         == line["wire_wrong"] == 0),
        ("wire_accounted", line["wire_ok"] + line["wire_typed_failures"]
         == line["wire_requests"]),
        ("wire_conn_reuse_over_half", line["wire_conn_reuse_pct"] > 50.0),
        ("fastwire_kill_switch_bitwise", fastwire_parity),
    )
    line["failed"] = [name for name, ok in bars if not ok]
    if line["failed"]:
        raise AssertionError(f"fleet failed {line['failed']}: {line}")
    return line


def phase_tenancy(sess) -> dict:
    """``bench.py --config tenancy`` (bench.py:2308-2646) at bench's sizes:
    the same CTR fit (one epoch of 8192 rows), then the fairness A/B on the
    card in this process (96 heavy and 12 light requests of 64 rows into a
    2-slot admission controller under ``overload:delay_ms=20``: FCFS under
    ``OTPU_TENANCY=0`` against ``light:weight=4;heavy:weight=1,
    max_inflight=1``; bench's one re-measure under 3x), the autoscaler
    drill over a real fleet on the card (one replica under eight loaders,
    grown by the digest-driven ``Autoscaler(min 1, max 3, up 2.0, down
    0.5, cooldown 2 s)``, then drained back under trickle traffic), and
    both kill switches off. Bench's fields, the replicas' starts and
    devices, and bench's bars as ``failed``."""
    import concurrent.futures
    import threading

    import numpy as np

    from orange3_spark_tpu_torch.fleet.control import Autoscaler
    from orange3_spark_tpu_torch.fleet.rollout import publish_version
    from orange3_spark_tpu_torch.fleet.router import FleetRouter
    from orange3_spark_tpu_torch.fleet.rpc import (
        NoReplicaAvailableError, ReplicaDrainingError, ReplicaUnavailableError,
    )
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.obs import fleetobs as fobs
    from orange3_spark_tpu_torch.resilience import OverloadShedError, inject_faults
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext
    from orange3_spark_tpu_torch.serve.tenancy import TenantQuotaShedError, tenant_scope

    fc, cfg = FLEET, TENANCY
    n_dense, n_cat = fc["n_dense"], fc["n_cat"]
    X, y = _ctr_xy(fc["seed"], fc["rows_fit"], n_dense, n_cat)
    model = StreamingHashedLinearEstimator(
        n_dims=fc["n_dims"], n_dense=n_dense, n_cat=n_cat, epochs=1, step_size=0.05,
        chunk_rows=fc["chunk_rows"],
    ).fit_stream(array_chunk_source(X, y, chunk_rows=fc["chunk_rows"]), session=sess)
    ladder = BucketLadder(min_bucket=64, max_bucket=1 << 10)
    n_light, n_heavy = cfg["n_light"], cfg["n_heavy"]
    arm_keys = ("OTPU_RESILIENCE", "OTPU_ADMISSION_MAX_INFLIGHT", "OTPU_ADMISSION_MAX_QUEUE",
                "OTPU_TENANCY", "OTPU_TENANT_SPEC")

    def run_arm(env: dict) -> dict:
        light_lat, heavy_lat, outcomes = [], [], []
        lock = threading.Lock()
        with _env(**{**dict.fromkeys(arm_keys), **env}):
            with ServingContext(ladder, micro_batch=False) as ctx:
                ctx.warmup(model, n_cols=n_dense + n_cat, kinds=("array",))

                def one(tenant: str, i: int):
                    if tenant == "light":
                        time.sleep(i * 0.03)
                    t0 = time.perf_counter()
                    try:
                        with tenant_scope(tenant):
                            out = model.predict(X[:64])
                        kind = "ok" if out.shape[0] == 64 else "lost"
                    except TenantQuotaShedError:
                        kind = "tenant_shed"
                    except OverloadShedError:
                        kind = "shed"
                    except Exception:  # noqa: BLE001 - untyped = lost
                        kind = "lost"
                    ms = (time.perf_counter() - t0) * 1e3
                    with lock:
                        outcomes.append((tenant, kind))
                        if kind == "ok":
                            (light_lat if tenant == "light" else heavy_lat).append(ms)

                with inject_faults(f"overload:delay_ms={cfg['service_ms']}"):
                    ex = concurrent.futures.ThreadPoolExecutor(n_light + 12)
                    try:
                        futs = [ex.submit(one, "heavy", i) for i in range(n_heavy)]
                        futs += [ex.submit(one, "light", i) for i in range(n_light)]
                        done, pending = concurrent.futures.wait(futs, timeout=120.0)
                        hung = len(pending)
                    finally:
                        ex.shutdown(wait=False)
        return {"light_lat": light_lat, "heavy_lat": heavy_lat, "outcomes": outcomes,
                "hung": hung}

    unfair_env = {"OTPU_RESILIENCE": "1", "OTPU_ADMISSION_MAX_INFLIGHT": "2",
                  "OTPU_ADMISSION_MAX_QUEUE": "256", "OTPU_TENANCY": "0"}
    fair_env = dict(unfair_env, OTPU_TENANCY="1",
                    OTPU_TENANT_SPEC="light:weight=4;heavy:weight=1,max_inflight=1")

    def fairness_ab():
        u, f = run_arm(unfair_env), run_arm(fair_env)
        p99_u = _pctl(u["light_lat"], 99) if u["light_lat"] else None
        p99_f = _pctl(f["light_lat"], 99) if f["light_lat"] else None
        return u, f, p99_u, p99_f, (p99_u / p99_f if p99_u and p99_f else None)

    unfair, fair, light_p99_u, light_p99_f, factor = fairness_ab()
    fairness_retried, factor_first = False, None
    if factor is None or factor < 3.0:    # bench's one structured re-measure
        fairness_retried, factor_first = True, factor
        unfair, fair, light_p99_u, light_p99_f, factor = fairness_ab()
    heavy_typed_sheds = sum(1 for t, k in fair["outcomes"] if t == "heavy" and k == "tenant_shed")
    all_outcomes = unfair["outcomes"] + fair["outcomes"]
    lost = sum(1 for _t, k in all_outcomes if k == "lost")
    hung = unfair["hung"] + fair["hung"]

    # ---- elasticity: a real fleet on the card grows and drains back
    root = tempfile.mkdtemp(prefix="chip_smoke_tenancy_")
    managers: list = []
    typed = (ReplicaUnavailableError, ReplicaDrainingError, NoReplicaAvailableError,
             OverloadShedError)
    try:
        publish_version(model, root, n_cols=n_dense + n_cat)
        base_env = {"OTPU_ADMISSION_MAX_INFLIGHT": "1",
                    "OTPU_FAULT_SPEC": f"overload:delay_ms={cfg['drill_service_ms']}"}
        mgr, start1 = _start_fleet(managers, root, 1, base_env, fc["ladder_max"])
        with _env(OTPU_FLEET_COALESCE="0"):
            router = FleetRouter(mgr.endpoints(), hedging=False)
            router.refresh()
            scaler = Autoscaler(mgr, router, min_replicas=1, max_replicas=3, up_x=2.0,
                                down_x=0.5, cooldown_s=2.0)

            def scrape_step():
                col = fobs.FleetCollector(mgr.endpoints(), router=router)
                return scaler.step(col.scrape_once())

            stop = threading.Event()
            load_failures: list = []

            def loader(rows):
                while not stop.is_set():
                    try:
                        router.predict(X[:rows])
                    except typed:
                        pass
                    except Exception as e:  # noqa: BLE001 - untyped = a failure
                        load_failures.append(repr(e))

            threads = [threading.Thread(target=loader, args=(16 + 8 * i,)) for i in range(8)]
            for t in threads:
                t.start()
            peak = 1
            t_up = time.perf_counter()
            deadline = time.monotonic() + FLEET_READY_S
            while time.monotonic() < deadline:
                router.refresh()
                scrape_step()
                peak = max(peak, len(mgr.handles))
                if peak >= 3 and mgr.wait_ready(timeout_s=1):
                    break
                time.sleep(0.5)
            scale_up_s = time.perf_counter() - t_up
            stop.set()
            for t in threads:
                t.join(timeout=30)
            load_hung = sum(1 for t in threads if t.is_alive())
            grown_ready_s = [h.ready_after_s for h in mgr.handles]
            grown_devices = {f"replica-{h.replica_id}": mgr.client(h.replica_id).get_json(
                "/healthz")[1].get("device") for h in mgr.handles}
            trickle_ok, trickle_failures = 0, []
            t_down = time.perf_counter()
            deadline = time.monotonic() + FLEET_READY_S
            while time.monotonic() < deadline:
                try:
                    out = router.predict(X[:64])
                    trickle_ok += int(out.shape[0] == 64)
                except Exception as e:  # noqa: BLE001 - the claim is zero
                    trickle_failures.append(repr(e))
                router.refresh()
                scrape_step()
                if len(mgr.handles) <= scaler.min_replicas:
                    break
                time.sleep(0.3)
            scale_down_s = time.perf_counter() - t_down
            final_replicas = len(mgr.handles)
            decisions = [d.to_dict() for d in scaler.decisions]
            router.close()
            mgr.stop_all()

        # ---- both kill switches off: the fixed fleet, bitwise
        with _env(OTPU_TENANCY="0", OTPU_AUTOSCALE="0"):
            with ServingContext(ladder, micro_batch=False) as ctx:
                ctx.warmup(model, n_cols=n_dense + n_cat, kinds=("array",))
                ref = np.asarray(model.predict(X[:256]))
                with tenant_scope("ghost"):
                    scoped = np.asarray(model.predict(X[:256]))
                fair_never_built = ctx.admission._fair_share is None
            stepped = Autoscaler(mgr, router, min_replicas=1, max_replicas=3, up_x=2.0,
                                 down_x=0.5, cooldown_s=2.0).step(
                {"replicas": {"replica-0": {"up": True, "stale": False, "queue_depth": 99,
                                            "inflight": 9, "shed_total": 9,
                                            "brownout_level": 3}}})
            parity = bool(np.array_equal(ref, scoped)) and fair_never_built and stepped is None
    finally:
        for m in managers:
            m.stop_all()
        shutil.rmtree(root, ignore_errors=True)

    elasticity = peak / max(final_replicas, 1)
    line = {
        "requests": len(all_outcomes), "service_ms_injected": cfg["service_ms"],
        "fairness_p99_bound_factor": factor, "fairness_retried": fairness_retried,
        "fairness_p99_bound_factor_first": factor_first,
        "light_p99_ms_unfair": light_p99_u, "light_p99_ms_fair": light_p99_f,
        "light_p50_ms_fair": _pctl(fair["light_lat"], 50) if fair["light_lat"] else None,
        "heavy_typed_sheds": heavy_typed_sheds,
        "heavy_completed_fair": sum(1 for t, k in fair["outcomes"] if t == "heavy" and k == "ok"),
        "light_completed_fair": sum(1 for t, k in fair["outcomes"] if t == "light" and k == "ok"),
        "completed": sum(1 for _t, k in all_outcomes if k == "ok"), "hung": hung, "lost": lost,
        "replica_start": {"first": start1, "grown_ready_s": grown_ready_s,
                          "grown_devices": grown_devices},
        "autoscale_peak_replicas": peak, "autoscale_final_replicas": final_replicas,
        "autoscale_min_replicas": scaler.min_replicas,
        "autoscale_max_replicas": scaler.max_replicas,
        "autoscale_decisions": len(decisions), "autoscale_decision_log": decisions,
        "autoscale_scale_up_s": scale_up_s, "autoscale_scale_down_s": scale_down_s,
        "autoscale_scaledown_failures": len(trickle_failures),
        "autoscale_scaledown_trickle_ok": trickle_ok,
        "autoscale_load_failures": len(load_failures), "autoscale_load_hung": load_hung,
        "elasticity_factor": elasticity, "tenancy_kill_switch_parity": parity,
    }
    devices = list(start1["devices"].values()) + list(grown_devices.values())
    bars = (
        ("replicas_on_cuda", all(str(d).startswith("cuda") for d in devices)),
        ("fairness_3x", factor is not None and factor >= 3.0),
        ("heavy_typed_sheds", heavy_typed_sheds >= 1),
        ("light_completed", line["light_completed_fair"] >= 1),
        ("none_hung_or_lost", hung == 0 and lost == 0),
        ("grew_to_2", peak >= 2),
        ("drained_to_min", final_replicas == scaler.min_replicas),
        ("scaledown_zero_failed", not trickle_failures and trickle_ok >= 1),
        ("load_none_failed_or_hung", not load_failures and load_hung == 0),
        ("decisions", len(decisions) >= 2),
        ("elasticity_2x", elasticity >= 2.0),
        ("kill_switches_bitwise", parity),
    )
    line["failed"] = [name for name, ok in bars if not ok]
    if line["failed"]:
        raise AssertionError(f"tenancy failed {line['failed']}: {line}")
    return line


def _online_twin_check(model, rlog_path, root, sess, trainer_kw) -> dict:
    """The incremental trainer on the card against the same trainer on the
    CPU: both warm-started from ``model``'s state, both read the log at
    ``rlog_path`` to its end; the candidates' theta within ``_theta_err``'s
    tolerance, the steps and join counts equal."""
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.reqlog import RequestLog
    from orange3_spark_tpu_torch.models.hashed_linear import HashedLinearModel
    from orange3_spark_tpu_torch.online.trainer import IncrementalTrainer

    cpu_model = HashedLinearModel(model.params, {k: v.cpu() for k, v in model.theta.items()},
                                  model.salts, model.class_values)
    out = {}
    for name, m, s in (("card", model, sess), ("cpu", cpu_model, TorchSession("cpu"))):
        log = RequestLog(rlog_path)
        tr = IncrementalTrainer(m, log, session=s,
                                checkpoint_path=os.path.join(
                                    root, f"twin-{model.params.optim_update}-{name}.ckpt"),
                                **trainer_kw)
        t0 = time.perf_counter()
        tr.consume_available()
        s.synchronize()
        out[name] = (tr.status(), tr.candidate_model().state_pytree, time.perf_counter() - t0)
        log.close()
    errs, ok = _theta_err(out["card"][1], out["cpu"][1])
    same = all(out["card"][0][k] == out["cpu"][0][k] for k in ("steps", "examples",
                                                               "join_counts"))
    return {"optim_update": model.params.optim_update, "steps": out["card"][0]["steps"],
            "card_s": out["card"][2], "cpu_s": out["cpu"][2], "theta_max_abs_err": errs,
            "tolerance": f"atol {THETA_ATOL} + rtol {THETA_RTOL}", "ok": ok and same}


def phase_online(sess) -> dict:
    """``bench.py --config online`` (bench.py:2648-3001) at bench's sizes
    on the card: a frozen ``StreamingHashedLinearEstimator(n_dims=2^10,
    n_dense=4, n_cat=4, step_size=0.05, chunk_rows=1024)`` fit (adam, the
    params' default) on 4096 rows (``default_rng(3)``) whose label rule
    then inverts; an in-process two-replica fleet on the card behind the
    router; the five claims (learn and promote, drift rejected, SLO-burn
    rollback, trainer crash and bitwise resume, the unguarded loop and
    ``OTPU_ONLINE=0``). Then the trainer on the card against the same
    trainer on the CPU over the resume arm's log, for bench's model (adam:
    the table gradient through ``segment_sum_sorted``) and for the same fit
    under ``sparse_adagrad`` (the 'sort' lowering: one
    ``segment_update_sorted`` launch a step). Both kernels' launches are
    counted over the phase. Bench's fields and bars as ``failed``."""
    import threading

    import numpy as np

    from orange3_spark_tpu_torch.fleet import rollout as ro
    from orange3_spark_tpu_torch.fleet.replica import ReplicaRuntime
    from orange3_spark_tpu_torch.fleet.router import FleetRouter, ReplicaEndpoint
    from orange3_spark_tpu_torch.io.reqlog import RequestLog
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.obs import fleetobs as fobs
    from orange3_spark_tpu_torch.online import OnlineLoop
    from orange3_spark_tpu_torch.online.trainer import IncrementalTrainer, OnlineTrainerError
    from orange3_spark_tpu_torch.ops import segment_sum as ss
    from orange3_spark_tpu_torch.resilience.faults import inject_faults
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    cfg = ONLINE
    rng = np.random.default_rng(cfg["seed"])
    n_dense = n_cat = 4
    X = np.concatenate([rng.standard_normal((cfg["rows"], n_dense)).astype(np.float32),
                        rng.integers(0, 500, (cfg["rows"], n_cat)).astype(np.float32)], axis=1)
    y0 = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    y1 = 1.0 - y0
    est_kw = dict(n_dims=cfg["n_dims"], n_dense=n_dense, n_cat=n_cat, epochs=1,
                  step_size=0.05, chunk_rows=cfg["chunk_rows"])
    # ---- the main path: both segment kernels' counts start at 0 here
    ss.segment_sum_sorted.launches = 0
    ss.segment_update_sorted.launches = 0
    t_phase = time.perf_counter()
    model = StreamingHashedLinearEstimator(**est_kw).fit_stream(
        array_chunk_source(X, y0, chunk_rows=cfg["chunk_rows"]), session=sess)
    fit_launches = ss.segment_sum_sorted.launches
    root = tempfile.mkdtemp(prefix="chip_smoke_online_")
    store = os.path.join(root, "store")
    holdout_shifted = array_chunk_source(X[2048:], y1[2048:], chunk_rows=cfg["chunk_rows"])
    trainer_kw = dict(cfg["trainer"])
    ladder = BucketLadder(min_bucket=64, max_bucket=512)
    runtimes: list = []
    router = None

    def drive(loop, yv, chunks=8, epochs=1):
        for _ in range(epochs):
            for i in range(0, chunks * 256, 256):
                model.predict(X[i:i + 256])
                rid = loop.tap.last_request_id()
                if rid is not None:
                    loop.tap.tap_label(rid, yv[i:i + 256])

    def wait_steps(loop, n, budget_s=180.0):
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < budget_s and loop.trainer.status()["steps"] < n
               and not loop.trainer.status()["died"]):
            time.sleep(0.1)

    try:
        ro.publish_version(model, store, n_cols=n_dense + n_cat)
        eps = []
        for i in range(2):
            rt = ReplicaRuntime(store, name=f"replica-{i}", session=sess,
                                ladder=BucketLadder(min_bucket=64, max_bucket=512))
            rt.activate()
            runtimes.append(rt)
            eps.append(ReplicaEndpoint(i, "127.0.0.1", rt.serve_background().port))
        router = FleetRouter(eps, hedging=False)
        router.refresh()
        replica_devices = [rt.health()[0]["device"] for rt in runtimes]

        def traffic_during(fn):
            stop = threading.Event()
            oks: list = []
            fails: list = []

            def _t():
                while not stop.is_set():
                    try:
                        router.predict(X[:64])
                        oks.append(1)
                    except Exception as e:  # noqa: BLE001 - the claim is zero
                        fails.append(repr(e))
                    time.sleep(0.01)

            th = threading.Thread(target=_t)
            th.start()
            try:
                res = fn()
            finally:
                stop.set()
                th.join(timeout=10)
            return res, len(oks), fails

        # ---- arm 1: learn + guarded promotion
        loop_a = OnlineLoop(model, store, os.path.join(root, "a.log"), session=sess,
                            reference_X=X, holdout_source=holdout_shifted, router=router,
                            canary_input=X[:16], min_examples=512, trainer_kw=trainer_kw,
                            shadow_kw={"disagree_threshold": 0.95})
        with ServingContext(ladder), loop_a:
            drive(loop_a, y1, epochs=3)
            wait_steps(loop_a, 24)
            metr_frozen = model.evaluate_stream(holdout_shifted)
            metr_cont = loop_a.trainer.candidate_model().evaluate_stream(holdout_shifted)
            res_a, ok_a, fails_a = traffic_during(loop_a.publish_cycle)
            status_a = loop_a.trainer.status()
        current_after_promo = ro.read_current(store)
        router.refresh()

        # ---- arm 2: injected drift rejected before any replica flips
        versions_before = [ep.version for ep in router.endpoints]
        with inject_faults("drift:shift=8,after=4"):
            loop_b = OnlineLoop(model, store, os.path.join(root, "b.log"), session=sess,
                                reference_X=X, holdout_source=holdout_shifted, router=router,
                                canary_input=X[:16], min_examples=512, trainer_kw=trainer_kw)
            with ServingContext(ladder), loop_b:
                drive(loop_b, y0)
                wait_steps(loop_b, 8)
                res_b = loop_b.publish_cycle()
        router.refresh()
        drift_no_flip = [ep.version for ep in router.endpoints] == versions_before
        drift_current_untouched = ro.read_current(store) == current_after_promo

        # ---- arm 3: past the gates, tripped by SLO burn during the roll
        slo = fobs.SLOEngine(fobs.parse_slo_spec("online_drill:target=99.0,p99_ms=1"),
                             fast_s=60.0, slow_s=240.0)
        loop_c = OnlineLoop(model, store, os.path.join(root, "c.log"), session=sess,
                            reference_X=X, holdout_source=array_chunk_source(
                                X[2048:], y0[2048:], chunk_rows=cfg["chunk_rows"]),
                            router=router, canary_input=X[:16], slo_engine=slo,
                            min_examples=512, trainer_kw=trainer_kw,
                            drift_kw={"holdout_drop": 0.2},
                            shadow_kw={"disagree_threshold": 0.95})
        roll_seen = threading.Event()

        def burn_when_rolling():
            while not roll_seen.is_set():
                if any(not ep.admitted for ep in router.endpoints):
                    roll_seen.set()
                time.sleep(0.005)
            for _ in range(64):
                slo.record(True, latency_s=0.5)

        with ServingContext(ladder), loop_c:
            drive(loop_c, y0)
            wait_steps(loop_c, 8)
            burner = threading.Thread(target=burn_when_rolling)
            burner.start()
            try:
                res_c, ok_c, fails_c = traffic_during(loop_c.publish_cycle)
            finally:
                roll_seen.set()
                burner.join(timeout=10)
        slo_current_untouched = ro.read_current(store) == current_after_promo

        # ---- arm 4: trainer crash -> typed death -> checkpoint resume
        rlog_path = os.path.join(root, "r.log")
        rlog = RequestLog(rlog_path)
        for i in range(0, 2048, 256):
            rid = rlog.append_request(X[i:i + 256])
            rlog.append_label(rid, y0[i:i + 256])
        resume_kw = dict(trainer_kw, ckpt_steps=2)
        tref = IncrementalTrainer(model, rlog, session=sess,
                                  checkpoint_path=os.path.join(root, "ref.ckpt"), **resume_kw)
        tref.consume_available()
        ref_leaves = [v.cpu().numpy() for v in tref.candidate_model().state_pytree.values()]
        crash_typed = False
        with inject_faults("trainer_crash:at=3"):
            tcrash = IncrementalTrainer(model, rlog, session=sess,
                                        checkpoint_path=os.path.join(root, "crash.ckpt"),
                                        **resume_kw)
            tcrash.start()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 120 and not tcrash.status()["died"]:
                time.sleep(0.1)
            try:
                tcrash.result()
            except OnlineTrainerError:
                crash_typed = True
        tres = IncrementalTrainer(model, rlog, session=sess,
                                  checkpoint_path=os.path.join(root, "crash.ckpt"), **resume_kw)
        resumed_from = tres.status()["resumed_from_step"]
        tres.consume_available()
        res_leaves = [v.cpu().numpy() for v in tres.candidate_model().state_pytree.values()]
        resume_parity = all(np.array_equal(a, b) for a, b in zip(ref_leaves, res_leaves))
        rlog.close()

        # ---- arm 5: the unguarded loop ships the bad model; the kill switch
        with _env(OTPU_RESILIENCE="0"):
            with inject_faults("drift:shift=8,after=4"):
                loop_u = OnlineLoop(model, os.path.join(root, "ustore"),
                                    os.path.join(root, "u.log"), session=sess, reference_X=X,
                                    holdout_source=holdout_shifted, min_examples=512,
                                    trainer_kw=resume_kw)
                with ServingContext(ladder), loop_u:
                    drive(loop_u, y0)
                    wait_steps(loop_u, 8)
                    res_u = loop_u.publish_cycle()
        unguarded_ships_bad = res_u["outcome"] == "published"
        with _env(OTPU_ONLINE="0"):
            loop_k = OnlineLoop(model, os.path.join(root, "kstore"),
                                os.path.join(root, "k.log"), session=sess, reference_X=X,
                                min_examples=1, trainer_kw=resume_kw)
            with ServingContext(ladder), loop_k:
                ref_out = model.predict(X[:256])
                kill_log_empty = loop_k.log.size_bytes == loop_k.log.data_start
                kill_cycle = loop_k.publish_cycle()["outcome"]
        with ServingContext(ladder):
            kill_parity = bool(np.array_equal(ref_out, model.predict(X[:256])))

        # ---- the trainer on the card against the CPU: bench's model
        # (adam) and the same fit under sparse_adagrad ('sort' lowering)
        twin_adam = _online_twin_check(model, rlog_path, root, sess, resume_kw)
        sparse = StreamingHashedLinearEstimator(
            **est_kw, optim_update="sparse_adagrad").fit_stream(
            array_chunk_source(X, y0, chunk_rows=cfg["chunk_rows"]), session=sess)
        upd0 = ss.segment_update_sorted.launches
        twin_sparse = _online_twin_check(sparse, rlog_path, root, sess, resume_kw)
        sparse_trainer_launches = ss.segment_update_sorted.launches - upd0
        sess.synchronize()
        phase_s = time.perf_counter() - t_phase
        launches = {"segment_sum_sorted": ss.segment_sum_sorted.launches,
                    "segment_update_sorted": ss.segment_update_sorted.launches}
        # ----
        quarantined = ro.list_quarantined(store)
    finally:
        if router is not None:
            router.close()
        for rt in runtimes:
            rt.close()
        shutil.rmtree(root, ignore_errors=True)

    auc_frozen, auc_cont = metr_frozen["auc"], metr_cont["auc"]
    line = {
        "phase_s": phase_s, "replica_devices": replica_devices,
        "auc_frozen": auc_frozen, "auc_continuous": auc_cont, "auc_gain": auc_cont - auc_frozen,
        "online_steps": status_a["steps"], "online_examples": status_a["examples"],
        "label_join_counts": status_a["join_counts"],
        "trainer_examples_per_s": status_a["examples_per_s"],
        "promotion_outcome": res_a["outcome"], "promotion_version": res_a.get("version"),
        "promotion_failed_requests": len(fails_a), "promotion_traffic_requests": ok_a,
        "promotion_current": current_after_promo,
        "drift_outcome": res_b["outcome"], "drift_error": (res_b.get("error") or "")[:200],
        "drift_quarantined": bool(res_b.get("quarantined")),
        "drift_current_untouched": drift_current_untouched,
        "drift_no_replica_flip": drift_no_flip,
        "slo_rollback_outcome": res_c["outcome"],
        "slo_rollback_failed_requests": len(fails_c), "slo_rollback_traffic_requests": ok_c,
        "slo_quarantined": bool(res_c.get("quarantined")),
        "slo_current_untouched": slo_current_untouched,
        "trainer_crash_typed": crash_typed, "trainer_resumed_from_step": resumed_from,
        "resume_parity_bitwise": resume_parity, "unguarded_ships_bad": unguarded_ships_bad,
        "kill_switch_parity": kill_parity, "kill_switch_log_empty": kill_log_empty,
        "kill_switch_cycle": kill_cycle, "quarantined_versions": quarantined,
        "card_vs_cpu": {"adam": twin_adam, "sparse_adagrad": twin_sparse},
        "fit_segment_sum_launches": fit_launches, "launches": launches,
        "sparse_trainer_segment_update_launches": sparse_trainer_launches,
    }
    bars = (
        ("replicas_on_cuda", all(str(d).startswith("cuda") for d in replica_devices)),
        ("learned", auc_cont > auc_frozen and status_a["steps"] >= 1
         and status_a["join_counts"]["joined"] >= 1),
        ("promoted", res_a["outcome"] == "completed" and not fails_a and ok_a >= 1
         and current_after_promo == res_a.get("version")),
        ("drift_rejected", res_b["outcome"] == "rejected_drift"
         and "DriftDetectedError" in line["drift_error"] and line["drift_quarantined"]
         and drift_current_untouched and drift_no_flip),
        ("slo_rolled_back", res_c["outcome"] == "rolled_back" and not fails_c
         and line["slo_quarantined"] and slo_current_untouched),
        ("resume_bitwise", crash_typed and resumed_from >= 1 and resume_parity),
        ("unguarded_ships_bad", unguarded_ships_bad),
        ("kill_switch", kill_parity and kill_log_empty and kill_cycle == "disabled"),
        ("quarantined_two", len(quarantined) >= 2),
        ("card_vs_cpu_adam", twin_adam["ok"]),
        ("card_vs_cpu_sparse_adagrad", twin_sparse["ok"]),
        ("segment_sum_launched", launches["segment_sum_sorted"] > 0),
        ("segment_update_launched", sparse_trainer_launches >= twin_sparse["steps"] > 0),
    )
    line["failed"] = [name for name, ok in bars if not ok]
    if line["failed"]:
        raise AssertionError(f"online failed {line['failed']}: {line}")
    return line


# ------------------------------------------- data wrangling and the canvas
# the wrangle phase: a month of TLC-shaped yellow-taxi trips
# (datasets.make_tlc_trips), 10 columns, 400 MB on the card
WRANGLE_ROWS, WRANGLE_CUT, WRANGLE_SEED = 10_000_000, 2_000_000, 0
WRANGLE_WARM_ROWS = 100_000
# the calls profiled by kernel on the card (the wall's breakdown)
WRANGLE_PROFILED = ("group_by_pu", "group_by_borough_payment", "window", "sample")
# group sums and means, card against CPU: within 2^-12 of the group's sum
# of |terms| (all terms here are >= 0, so of the sum itself). The CPU adds a
# 1.6M-row group one row after another in float32 (~1.1e-5 measured on the
# generator's data); the kernel's order is within (10 + n/1024)·2^-24.
WRANGLE_SUM_RTOL = 2.0**-12
# running sums: within 64·2^-24 of the global prefix of |v| (each value a
# prefix less a base, each from a scan of depth <= log2(n) < 32)
WRANGLE_SCAN_RTOL = 64 * 2.0**-24
# the ows phase: the canvas file over a SQLite database of 1M trips (the
# SQL reader converts cell by cell in Python, as the reference's does)
OWS_TRIPS, OWS_SEED = 1_000_000, 1


def _as_discrete(table, name, values):
    """``table`` with attribute ``name`` re-declared discrete over
    ``values`` (Orange's Edit Domain; metadata only). A join brings the
    right side's columns in continuous, holding the category codes."""
    from orange3_spark_tpu_torch.core.domain import DiscreteVariable, Domain

    attrs = [DiscreteVariable(name, values) if v.name == name else v
             for v in table.domain.attributes]
    return table.with_X(table.X, Domain(attrs, table.domain.class_vars, table.domain.metas))


def _wrangle_tables(X, zdom, Z, sess):
    """(trips, zone lookup, fan-out table) on ``sess``'s device. The
    fan-out table holds each zone twice (a peak and an off-peak surcharge):
    the right side of ``join_expand`` with fan-out 2 and of ``join_host``."""
    import numpy as np

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
    from orange3_spark_tpu_torch.datasets import tlc_domain

    zones = np.arange(Z.shape[0], dtype=np.float32)
    fan = np.stack([np.repeat(zones, 2), np.tile(np.float32([2.5, 1.0]), Z.shape[0])], 1)
    fan_dom = Domain([zdom["PULocationID"], ContinuousVariable("surcharge")])
    return (TorchTable.from_numpy(tlc_domain(), X, session=sess),
            TorchTable.from_numpy(zdom, Z, session=sess),
            TorchTable.from_numpy(fan_dom, fan, session=sess))


def _wrangle_calls():
    """The phase's calls: (name, on the cut?, fn(trips, zones, fan) ->
    result, columns compared within WRANGLE_SUM_RTOL: a predicate on the
    output column's name, None for none)."""
    from orange3_spark_tpu_torch.datasets import TLC_BOROUGHS
    from orange3_spark_tpu_torch.ops import relational as R
    from orange3_spark_tpu_torch.ops import window as Wn

    boroughs = tuple(b for b, _ in TLC_BOROUGHS)
    pu_aggs = [(c, f) for c in ("fare_amount", "tip_amount", "total_amount") for f in R.AGG_FNS]
    bp_aggs = [(c, f) for c in ("fare_amount", "passenger_count", "tip_amount")
               for f in R.AGG_FNS]
    sums = lambda name: name.startswith(("sum_", "mean_"))

    def by_borough(t, z, _):
        joined = _as_discrete(R.join(t, z, "PULocationID"), "Borough", boroughs)
        return R.group_by(joined, ["Borough", "payment_type"], bp_aggs)

    def window(t, *_):
        w = Wn.Window(t, "VendorID", "pickup_s")
        return {"row_number": w.row_number(), "lag": w.lag("fare_amount"),
                "lead": w.lead("fare_amount"), "running_fare": w.running_sum("fare_amount")}

    return [
        ("join", False, lambda t, z, _: R.join(t, z, "PULocationID"), None),
        ("group_by_pu", False, lambda t, *_: R.group_by(t, "PULocationID", pu_aggs), sums),
        ("group_by_borough_payment", False, by_borough, sums),
        ("pivot", False, lambda t, *_: R.pivot(t, "PULocationID", "payment_type",
                                               {"tip_amount": "mean"}),
         lambda name: name not in ("PULocationID",)),
        ("cube", False, lambda t, *_: R.cube(t, ["VendorID", "payment_type"],
                                             [("fare_amount", "sum"), ("tip_amount", "mean"),
                                              ("fare_amount", "count")]), sums),
        ("rollup", False, lambda t, *_: R.rollup(t, ["VendorID", "payment_type"],
                                                 [("total_amount", "max"),
                                                  ("total_amount", "mean")]), sums),
        ("crosstab", False, lambda t, *_: R.crosstab(t, "PULocationID", "DOLocationID"), None),
        ("value_counts", False, lambda t, *_: R.value_counts(t, "payment_type"), None),
        ("freq_items", False, lambda t, *_: R.freq_items(t, ["PULocationID", "payment_type"],
                                                         0.01), None),
        ("sort", False, lambda t, *_: R.sort(t, "fare_amount", ascending=False), None),
        ("window", False, window, None),
        ("sample", False, lambda t, *_: R.sample(t, 0.1, seed=3), None),
        ("sample_by", False, lambda t, *_: R.sample_by(t, "payment_type",
                                                       {"1": 0.05, "2": 0.2, "4": 1.0},
                                                       seed=3), None),
        ("random_split", False, lambda t, *_: R.random_split(t, [0.7, 0.2, 0.1], seed=5), None),
        ("train_test_split", False, lambda t, *_: R.train_test_split(t, 0.25, seed=5), None),
        ("with_column", False, lambda t, *_: R.with_column(t, "fare_per_mile",
                                                           "fare_amount / trip_distance"), None),
        ("drop", False, lambda t, *_: R.drop(t, ["tip_amount", "pickup_s"]), None),
        ("join_expand", True, lambda t, _, f: R.join_expand(t, f, "PULocationID",
                                                            max_matches=2), None),
        ("join_host", True, lambda t, _, f: R.join_host(t, f, "PULocationID"), None),
        ("union", True, lambda t, *_: R.union(t, t), None),
        ("distinct", True, lambda t, *_: R.distinct(t, ["PULocationID", "DOLocationID"]), None),
    ]


def _cells_rel_err(got, want):
    """max |got - want| / |want| over the finite entries (0 where equal)."""
    import numpy as np

    ok = np.isfinite(want) & np.isfinite(got) & (want != got)
    return float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]))) if ok.any() else 0.0


def _wrangle_compare(card, host, close=None) -> dict:
    """The card's result against the CPU's: bitwise (NaN in the same
    places), or within WRANGLE_SUM_RTOL on the columns ``close`` names.
    Returns {"equal": bool, "max_rel_err": x} (the error over the close
    columns)."""
    import numpy as np

    from orange3_spark_tpu_torch import TorchTable

    if isinstance(card, (list, tuple)) and card and isinstance(card[0], TorchTable):
        parts = [_wrangle_compare(a, b) for a, b in zip(card, host)]
        return {"equal": all(p["equal"] for p in parts) and len(card) == len(host),
                "max_rel_err": 0.0}
    if not isinstance(card, TorchTable):
        if isinstance(card, np.ndarray):
            return {"equal": bool(np.array_equal(card, host, equal_nan=True)), "max_rel_err": 0.0}
        return {"equal": card == host, "max_rel_err": 0.0}
    (cX, cY, cW), (hX, hY, hW) = card.to_numpy(), host.to_numpy()
    if card.domain != host.domain or cX.shape != hX.shape:
        return {"equal": False, "max_rel_err": None}
    names = [v.name for v in card.domain.attributes]
    loose = np.asarray([bool(close and close(n)) for n in names], bool)
    exact = (np.array_equal(cX[:, ~loose], hX[:, ~loose], equal_nan=True)
             and np.array_equal(cW, hW) and (cY is None) == (hY is None)
             and (cY is None or np.array_equal(cY, hY, equal_nan=True))
             and ((card.metas is None and host.metas is None)
                  or np.array_equal(card.metas, host.metas)))
    err = _cells_rel_err(cX[:, loose], hX[:, loose]) if loose.any() else 0.0
    nan_same = np.array_equal(np.isnan(cX), np.isnan(hX))
    return {"equal": bool(exact and nan_same and err <= WRANGLE_SUM_RTOL),
            "max_rel_err": err}


def _wrangle_kernel(args, mem_bw) -> dict:
    """``segment_sum_sorted`` at the inputs ``group_by(PULocationID)``
    gave it (``args``: the sorted [W, W·v] rows, their slots, the slot
    count): two launches bitwise; bitwise the kernels' order written out
    (``_long_order_sums``) on the segments of more than ``walk_max()``
    rows and the CPU's index order on the shorter; within (10 +
    ceil(n/1024))·2^-24·Σ|g| of the float64 sums; its max |err| against
    the plain version on the card; its time (captured) beside the byte
    bound, the plain version and ``index_add_``, and its time on the first
    column alone."""
    import torch

    from orange3_spark_tpu_torch.ops import segment_sum as ss

    g, seg, n_slots = args
    run = lambda: ss.segment_sum_sorted(g, seg, n_slots)
    got = run()
    repeat = bool(torch.equal(got, run()))
    rows = torch.bincount(seg.long(), minlength=n_slots)[:n_slots]
    long_slots = rows > ss.walk_max()
    order_equal = _long_order_equal(got, g, seg, n_slots, long_slots)
    cpu = ss.segment_sum_sorted_reference(g.cpu(), seg.cpu(), n_slots)
    short_equal = bool(torch.equal(got.cpu()[~long_slots.cpu()], cpu[~long_slots.cpu()]))
    f64 = torch.zeros((n_slots, g.shape[1]), dtype=torch.float64, device=g.device
                      ).index_add_(0, seg, g.double())
    a64 = torch.zeros_like(f64).index_add_(0, seg, g.double().abs())
    depth = (10 + torch.ceil(rows.double() / 1024))[:, None]
    f64_ok = bool(((got.double() - f64).abs() <= depth * 2.0**-24 * a64).all())
    plain = lambda: ss.segment_sum_sorted_reference(g, seg, n_slots)
    library = lambda: torch.zeros((n_slots, g.shape[1]), device=g.device).index_add_(0, seg, g)
    max_abs_err = float((got - plain()).abs().max())
    ms, plain_ms, library_ms = (graph_ms(f, 20) for f in (run, plain, library))
    # one column of the same rows: whether the time follows the columns
    # (each long segment's last combine walks its chunk partials a column
    # at a time in one warp) or the rows
    g1 = g[:, :1].contiguous()
    ms_k1 = graph_ms(lambda: ss.segment_sum_sorted(g1, seg, n_slots), 20)
    del g1
    n_bytes = g.numel() * 4 + seg.numel() * seg.element_size() + n_slots * g.shape[1] * 4
    line = {"M": g.shape[0], "k": g.shape[1], "n_slots": n_slots,
            "segments": int((rows > 0).sum()), "long_segments": int(long_slots.sum()),
            "longest_segment": int(rows.max()), "bitwise_repeat": repeat,
            "long_order_equal": order_equal, "short_cpu_equal": short_equal,
            "within_f64_bound": f64_ok, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "ms_one_column": ms_k1,
            "bytes": n_bytes, "bound_ms": n_bytes / mem_bw * 1e3, "bound_by": "bytes",
            "timed": "captured launches (20 in a graph)",
            "tolerance": "max_abs_err against the plain version (index_add_ with float "
                         "atomics) on the card; bitwise the kernels' order written out on "
                         "long segments and the CPU's on short ones; within (10 + "
                         "ceil(n/1024))·2^-24·Σ|g| of the float64 sum"}
    if not (repeat and order_equal and short_equal and f64_ok):
        raise AssertionError(f"segment_sum_sorted failed at group_by's inputs: {line}")
    return line


def phase_wrangle(sess, mem_bw, tmp) -> dict:
    """``ops/relational``, ``ops/window`` and the CSV round trip on a
    10M-row TLC-shaped trip table on the card, each call timed (wall,
    synchronized, after a warm-up pass of every call at 100,000 rows) and
    held against the same call on the CPU; the host-bound calls
    (``join_expand``, ``join_host``, ``union``, ``distinct``) and the CSV
    round trip on the first 2,000,000 rows on both sides. A few calls
    profiled by kernel (``WRANGLE_PROFILED``: wall, device busy time, idle
    share, the top kernels). Then the segment-sum kernel at
    ``group_by(PULocationID)``'s own inputs."""
    import numpy as np

    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import make_tlc_trips, tlc_zone_lookup
    from orange3_spark_tpu_torch.io.native import read_csv_native
    from orange3_spark_tpu_torch.io.readers import write_csv
    from orange3_spark_tpu_torch.ops import relational as R
    from orange3_spark_tpu_torch.ops import segment_sum as ss

    t0 = time.perf_counter()
    X = make_tlc_trips(WRANGLE_ROWS, WRANGLE_SEED)
    zdom, Z = tlc_zone_lookup()
    gen_s = time.perf_counter() - t0
    cpu = TorchSession("cpu")
    t0 = time.perf_counter()
    card = _wrangle_tables(X, zdom, Z, sess)
    sess.synchronize()
    to_card_s = time.perf_counter() - t0
    card_cut = _wrangle_tables(X[:WRANGLE_CUT], zdom, Z, sess)
    warm = _wrangle_tables(X[:WRANGLE_WARM_ROWS], zdom, Z, sess)
    calls = _wrangle_calls()
    for _, _, fn, _ in calls:            # warm-up: first-call costs out of the times
        fn(*warm)
    sess.synchronize()

    # ---- the main path: the launch count starts at 0 here
    ss.segment_sum_sorted.launches = 0
    card_out, ms = {}, {}
    for name, cut, fn, _ in calls:
        t0 = time.perf_counter()
        card_out[name] = fn(*(card_cut if cut else card))
        sess.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    launches = ss.segment_sum_sorted.launches
    # ----

    host = _wrangle_tables(X, zdom, Z, cpu)
    host_cut = _wrangle_tables(X[:WRANGLE_CUT], zdom, Z, cpu)
    checks, cpu_ms = {}, {}
    for name, cut, fn, close in calls:
        t0 = time.perf_counter()
        want = fn(*(host_cut if cut else host))
        cpu_ms[name] = (time.perf_counter() - t0) * 1e3
        if name == "window":
            checks[name] = _window_compare(card_out[name], want, X[:, 6])
        else:
            checks[name] = _wrangle_compare(card_out[name], want, close)
        del want
    del host, host_cut

    # the CSV round trip: the native writer's shortest round-trip floats
    path = os.path.join(tmp, "trips.csv")
    t0 = time.perf_counter()
    write_csv(card_cut[0], path)
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = read_csv_native(path, session=sess)
    sess.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    csv_equal = bool(np.array_equal(back.to_numpy()[0].view(np.uint32),
                                    X[:WRANGLE_CUT].view(np.uint32)))
    ms["write_csv"], ms["read_csv_native"] = write_ms, read_ms
    checks["csv_round_trip"] = {"equal": csv_equal, "bytes": os.path.getsize(path)}
    os.remove(path)
    del back

    # where the time goes: a few calls under torch.profiler on the card
    profiled = {}
    if sess.device.type == "cuda":
        for name, cut, fn, _ in calls:
            if name in WRANGLE_PROFILED:
                wall_us, events, by_name, busy = _profile_run(lambda: fn(*card))
                top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
                profiled[name] = {"wall_us": wall_us, "busy_us": busy,
                                  "idle_share": 1.0 - busy / wall_us, "launches": len(events),
                                  "top_device_us": {k[:90]: v[0] for k, v in top}}

    # the kernel at group_by(PULocationID)'s inputs, recorded from the call
    seen = []
    real = R.segment_sum_sorted

    def record(g, seg, n_slots, **kw):
        seen.append((g, seg, n_slots))
        return real(g, seg, n_slots, **kw)

    R.segment_sum_sorted = record
    try:
        R.group_by(card[0], "PULocationID", [("fare_amount", "sum"), ("tip_amount", "sum"),
                                              ("total_amount", "sum")])
    finally:
        R.segment_sum_sorted = real
    kernel = _wrangle_kernel(seen[0], mem_bw)
    del seen, card_out

    failed = sorted(n for n, c in checks.items() if not _all_equal(c))
    line = {"rows": WRANGLE_ROWS, "cut_rows": WRANGLE_CUT, "seed": WRANGLE_SEED,
            "table_bytes": int(card[0].X.numel() * 4 + card[0].W.numel() * 4),
            "generate_s": gen_s, "to_card_s": to_card_s,
            "cuts": {**{n: f"first {WRANGLE_CUT} rows on both sides (host-bound: numpy "
                           "on the host in both packages)" for n, cut, _, _ in calls if cut},
                     "csv_round_trip": f"first {WRANGLE_CUT} rows (the text writer and "
                                       "parser run on the host)"},
            "card_ms": ms, "cpu_ms": cpu_ms, "checks": checks, "profile": profiled,
            "segment_sum_launches": launches,
            "tolerance": {"sums_means": f"rel {WRANGLE_SUM_RTOL} of the group's Σ|terms|",
                          "running_sum": f"{WRANGLE_SCAN_RTOL} x the global prefix of |v|",
                          "else": "bitwise"},
            "kernel": kernel}
    if failed:
        raise AssertionError(f"wrangle: the card disagrees with the CPU on {failed}: {line}")
    if launches == 0 and sess.device.type == "cuda":
        raise AssertionError("wrangle never launched segment_sum_sorted")
    return line


def _window_compare(card, host, v) -> dict:
    """The window's results, card against CPU: row numbers, lag and lead
    bitwise; the running sum within WRANGLE_SCAN_RTOL of the global prefix
    of |v| (NaN in the same places)."""
    import numpy as np

    out = {k: {"equal": bool(np.array_equal(card[k].cpu().numpy(), host[k].numpy(),
                                            equal_nan=True))}
           for k in ("row_number", "lag", "lead")}
    a, b = card["running_fare"].cpu().numpy(), host["running_fare"].numpy()
    tol = WRANGLE_SCAN_RTOL * float(np.nansum(np.abs(v).astype(np.float64)))
    err = float(np.nanmax(np.abs(a - b)))
    out["running_fare"] = {"equal": bool(np.array_equal(np.isnan(a), np.isnan(b)) and err <= tol),
                           "bitwise": bool(np.array_equal(a, b, equal_nan=True)),
                           "max_abs_err": err, "tolerance": tol}
    return out


def _all_equal(c) -> bool:
    if "equal" in c:
        return bool(c["equal"])
    return all(_all_equal(v) for v in c.values())


# the canvas file's queries: the trips with their pickup borough, and the
# zone lookup summarized a borough (the Merge Data node's right side)
OWS_TRIPS_QUERY = (
    "SELECT t.VendorID, t.payment_type, z.Borough, t.passenger_count, t.trip_distance, "
    "t.fare_amount, t.tip_amount, t.total_amount FROM trips t "
    "JOIN zones z ON t.PULocationID = z.LocationID")
OWS_ZONES_QUERY = (
    "SELECT Borough, COUNT(*) AS zones, SUM(service_zone = 'Yellow Zone') AS yellow_zones, "
    "SUM(service_zone = 'Airports') AS airports FROM zones GROUP BY Borough")


def canvas_ows(db: str, out_dir: str) -> str:
    """An Orange canvas scheme, as the canvas saves one (nodes with Orange's
    qualified names and positions, links by channel, ``literal`` node
    properties beside the canvas's own GUI keys, an annotation), over the
    SQLite database ``db`` (``datasets.write_tlc_sqlite``): SQL Table
    (the trips) -> Select Rows (fare and distance > 0) -> Aggregate Columns
    (by Borough and payment_type) -> Merge Data (left, with a second SQL
    Table: the zone lookup a borough) -> Save Data (CSV); Select Rows ->
    Pivot Table (Borough x payment_type, mean tip) -> Save Data (SQLite).
    Merge Data's sinks are named by their port ('Left', 'Right'): the
    reference's channel table maps no other name onto a two-input widget."""
    aggs = tuple((c, f) for c in ("fare_amount", "tip_amount", "passenger_count")
                 for f in ("sum", "mean", "count", "min", "max"))
    gui = {"savedWidgetGeometry": None, "controlAreaVisible": True, "__version__": 2}
    nodes = [
        ("SQL Table", "Orange.widgets.data.owsqltable.OWSqlTable",
         {"query": OWS_TRIPS_QUERY, "database": db, "class_col": "", **gui}),
        ("Select Rows", "Orange.widgets.data.owselectrows.OWSelectRows",
         {"conditions": (("fare_amount", ">", 0.0), ("trip_distance", ">", 0.0)), **gui}),
        ("Aggregate Columns", "Orange.widgets.data.owaggregatecolumns.OWAggregateColumns",
         {"keys": ("Borough", "payment_type"), "aggs": aggs, **gui}),
        ("SQL Table", "Orange.widgets.data.owsqltable.OWSqlTable",
         {"query": OWS_ZONES_QUERY, "database": db, **gui}),
        ("Merge Data", "Orange.widgets.data.owmergedata.OWMergeData",
         {"on": "Borough", "how": "left", "max_matches": 0, **gui}),
        ("Save Data", "Orange.widgets.data.owsave.OWSave",
         {"path": os.path.join(out_dir, "borough_payment.csv"), **gui}),
        ("Pivot Table", "Orange.widgets.data.owpivot.OWPivot",
         {"keys": ("Borough",), "pivot_col": "payment_type",
          "aggs": (("tip_amount", "mean"),), **gui}),
        ("Save Data", "Orange.widgets.data.owsave.OWSave",
         {"path": os.path.join(out_dir, "tip_pivot.db"), "sql_table": "tip_pivot", **gui}),
    ]
    links = [(0, 1, "Data", "Data"), (1, 2, "Data", "Data"), (2, 4, "Data", "Left"),
             (3, 4, "Data", "Right"), (4, 5, "Data", "Data"), (1, 6, "Data", "Data"),
             (6, 7, "Data", "Data")]
    import html

    out = ["<?xml version='1.0' encoding='utf-8'?>",
           '<scheme version="2.0" title="TLC trips by borough" description="wrangling">',
           "  <nodes>"]
    for i, (name, qual, _) in enumerate(nodes):
        out.append(f'    <node id="{i}" name="{name}" qualified_name="{qual}" '
                   f'project_name="Orange3" version="" title="{name}" '
                   f'position="({100 + 150 * i}, {150 + 40 * (i % 2)})" />')
    out.append("  </nodes>\n  <links>")
    for i, (s, d, sc, dc) in enumerate(links):
        out.append(f'    <link id="{i}" source_node_id="{s}" sink_node_id="{d}" '
                   f'source_channel="{sc}" sink_channel="{dc}" enabled="true" />')
    out.append('  </links>\n  <annotations>\n    <text id="0" type="text/plain" '
               'rect="(40.0, 30.0, 200.0, 40.0)" font-family="Sans" font-size="16">'
               'trips by borough</text>\n  </annotations>\n  <thumbnail />\n'
               "  <node_properties>")
    for i, (_, _, props) in enumerate(nodes):
        out.append(f'    <properties node_id="{i}" format="literal">'
                   f"{html.escape(repr(props), quote=False)}</properties>")
    out.append("  </node_properties>\n  <session_state>\n    <window_groups />\n"
               "  </session_state>\n</scheme>\n")
    return "\n".join(out)


def _ows_outputs(graph, outs) -> dict:
    """{node: its output table} of a run graph, the Save Data nodes' files
    read back (CSV by the native reader, SQLite by ``read_sql``) on the
    CPU."""
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.native import read_csv_native
    from orange3_spark_tpu_torch.io.readers import read_sql

    cpu = TorchSession("cpu")
    tables = {}
    for nid, node in graph.nodes.items():
        o = outs[nid]
        if "data" in o:
            tables[nid] = o["data"]
        elif o["path"].endswith(".csv"):
            tables[nid] = read_csv_native(o["path"], session=cpu)
        else:
            tables[nid] = read_sql(f"SELECT * FROM {node.widget.params.sql_table}", o["path"],
                                   session=cpu)
    return tables


def phase_ows(tmp, card_device: str = "cuda") -> dict:
    """The canvas's entry point: ``canvas_ows`` over a SQLite database of
    1,000,000 trips, loaded by ``workflow/ows.read_ows`` (strict) and run
    with the card as the session's device, then with the CPU (the Save
    Data nodes writing to files of their own); every node's output held
    card against CPU (the aggregated sums and means within
    WRANGLE_SUM_RTOL, the rest bitwise), the card's tables on the card.
    ``card_device`` is for a rehearsal on a machine without one."""
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import write_tlc_sqlite
    from orange3_spark_tpu_torch.ops import segment_sum as ss
    from orange3_spark_tpu_torch.workflow.ows import read_ows

    db = os.path.join(tmp, "tlc.db")
    t0 = time.perf_counter()
    write_tlc_sqlite(db, OWS_TRIPS, OWS_SEED)
    db_s = time.perf_counter() - t0
    path = os.path.join(tmp, "tlc.ows")
    with open(path, "w", encoding="utf-8") as f:
        f.write(canvas_ows(db, tmp))
    runs, walls, launches = {}, {}, {}
    try:
        for dev in (card_device, "cpu"):
            sess = TorchSession.builder_get_or_create(dev)
            g = read_ows(path)
            for nid, node in g.nodes.items():
                if node.widget.name == "OWSaveData":
                    base = os.path.basename(node.widget.params.path)
                    g.set_params(nid, path=os.path.join(tmp, f"{dev}_{base}"))
            before = ss.segment_sum_sorted.launches
            t0 = time.perf_counter()
            outs = g.run()
            sess.synchronize()
            walls[dev] = time.perf_counter() - t0
            launches[dev] = ss.segment_sum_sorted.launches - before
            runs[dev] = (g, _ows_outputs(g, outs))
    finally:
        TorchSession.builder_get_or_create(card_device)
    (g, card), (_, host) = runs[card_device], runs["cpu"]
    sums = lambda name: name.startswith(("sum_", "mean_")) or name in ("1", "2", "3", "4", "5",
                                                                       "6")
    checks = {f"{nid}:{g.nodes[nid].widget.name}": _wrangle_compare(card[nid], host[nid], sums)
              for nid in card}
    on_card = all(card[nid].X.device.type == card_device for nid, n in g.nodes.items()
                  if n.widget.name != "OWSaveData")
    failed = sorted(k for k, c in checks.items() if not c["equal"])
    line = {"trips": OWS_TRIPS, "seed": OWS_SEED, "sqlite_s": db_s,
            "nodes": [n.widget.name for _, n in sorted(g.nodes.items())],
            "edges": len(g.edges), "import_report": g.import_report,
            "wall_s": walls, "segment_sum_launches": launches, "tables_on_card": on_card,
            "rows": {k: card[int(k.split(":")[0])].n_rows for k in checks},
            "checks": checks,
            "cut": f"{OWS_TRIPS} trips: the SQL reader converts cell by cell in Python"}
    if failed or not on_card or g.import_report or (card_device == "cuda"
                                                     and launches["cuda"] == 0):
        raise AssertionError(f"ows: the canvas run failed its checks ({failed}): {line}")
    return line


# ------------------------------------------------ JAX's stream: the kernels
# the forest's draw at config 3: 20 trees over the HIGGS fit's rows
PRNG_TREES, PRNG_ROWS, PRNG_UNIFORM_ROWS = 20, 11_000_000 - (1 << 18), 10_000_000
# 32-bit integer operations of one threefry2x32 hash (ops/csrc/prng.cu): 2
# initial key adds; 20 rounds of add, funnel shift and xor; 5 key
# injections of two adds; the xor of the two words
HASH_INT_OPS = 2 + 20 * 3 + 5 * 2 + 1
# 32-bit integer operations one Hopper SM can issue a clock: 4 warp
# schedulers, each one warp instruction (32 lanes) a clock (NVIDIA H100
# Tensor Core GPU Architecture whitepaper); its 64 INT32 units take adds,
# logic and shifts, and integer adds also run as IMAD on the FP32 pipe, so
# the issue width, not the INT32 units, is the ceiling (a first bound at 64
# a clock was beaten by the kernel itself). Times the SMs and the max SM
# clock nvidia-smi reports: the card's integer rate
INT_ISSUE_LANES_PER_SM = 128
# the parity phase's extra Poisson draw, card against CPU: 2 keys x 500,000
PRNG_PARITY_KEYS, PRNG_PARITY_ROWS = 2, 500_000
PRNG_MISMATCH_SHARE = 1e-6
# the RF fit's wall on the card while its draws came from a torch.Generator
# (PERF.md, section 5), printed beside the fit's wall now
RF_FIT_S_BEFORE = 0.1453
# the RF fit's wall on the card with the draws of the one-lane-a-thread
# poisson_knuth that ran one lane a thread to its end (PERF.md, section 5)
RF_FIT_S_ONE_LANE = 0.1475
# poisson_knuth's captured time at the forest's draw while it ran one lane a
# thread to its end (PERF.md, section 6: NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside the redesigned kernel's
POISSON_MS_ONE_LANE = 5.1337
# GBT's subsampled round: one key, the HIGGS fit's rows, lam 0.8
PRNG_GBT_LAM = 0.8


def int32_rate() -> float:
    """The card's 32-bit integer operations a second: SMs x 128 issue lanes x
    the max SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_ISSUE_LANES_PER_SM * mhz * 1e6


def _prng_bound(bytes_, ops, mem_bw, int_rate) -> dict:
    by_bytes, by_ops = bytes_ / mem_bw * 1e3, ops / int_rate * 1e3
    return {"bytes": bytes_, "int_ops": ops, "bytes_ms": by_bytes, "issue_ms": by_ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def _forest_keys(seed: int, n_trees: int):
    """The bootstrap keys of a seeded forest (``draw_forest``'s kb)."""
    from orange3_spark_tpu_torch.ops import prng

    return [prng.split(t)[0] for t in prng.split(prng.PRNGKey(seed), n_trees)]


def knuth_work_sass() -> dict:
    """The instructions ``poisson_knuth``'s function needs, from the SASS of
    ``probes/knuth_work.cu`` (a row's Knuth loop run to its end on prng.cu's
    hash and float steps, with none of the kernel's design), built as a
    cubin with the package's code-generation flags: an iteration (its inner
    loop's pass: the table read, the hash, the uniform's conversion, logf,
    the add, the compare and the count) and a row (its outer loop's pass
    less the inner loop: the counter, the loop's start, the count's store
    and the step to the next row)."""
    from orange3_spark_tpu_torch.ops import cuda_build

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probes", "knuth_work.cu")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = cuda_build.BUILD_DIR / "knuth_work.cubin"
    flags = [f for f in cuda_build.NVCC_FLAGS if f.startswith(("-gencode", "-std", "-O"))]
    subprocess.run([cuda_build.nvcc_path(), *flags, "-cubin", "-o", str(cubin), src],
                   capture_output=True, text=True, timeout=300, check=True)
    funcs = sass_functions(sass_text(cubin))
    if "knuth_work" not in funcs:
        raise AssertionError(f"knuth_work's SASS not found: {sorted(funcs)}")
    rows, iters = sass_loop(funcs["knuth_work"]), sass_loop(funcs["knuth_work"], innermost=True)
    if rows["span"] == iters["span"] or rows["calls"] or iters["calls"]:
        raise AssertionError(f"knuth_work's SASS is not a loop in a loop: {rows}, {iters}")
    return {"iteration": iters["instructions"],
            "row": rows["instructions"] - iters["instructions"],
            "iteration_opcodes": iters["opcodes"], "row_loop_opcodes": rows["opcodes"]}


def knuth_sass() -> dict:
    """The issued instructions of one pass of ``poisson_knuth``'s loop in
    the built library's SASS (``sass_loop``: the function's work and the
    design's: the table's branch, the stage write, the refill and the
    convergence barriers; the call past the table left out), of one
    ``split_chain`` call (two hashes), the production build's, and the
    work its function needs (``knuth_work_sass``)."""
    from orange3_spark_tpu_torch.ops import cuda_build

    funcs = sass_functions(sass_text(cuda_build.library_path("prng")))
    kernel = [f for f in funcs if "poisson_knuthILb0E" in f]
    if len(kernel) != 1:
        raise AssertionError(f"poisson_knuth's SASS not found: {sorted(funcs)}")
    loop = sass_loop(funcs[kernel[0]])
    if len(loop["calls"]) != 1:
        # inlined, the split's two hashes would count in every pass
        raise AssertionError(f"poisson_knuth's loop does not call split_chain once: {loop}")
    return {"loop": loop, "split_chain": sass_callee(funcs, funcs[kernel[0]], loop["calls"][0]),
            "work": knuth_work_sass()}


def _knuth_shares(counts, slots) -> dict:
    """The share of issued lane-slots that did an iteration: this kernel's
    (lane-iterations over 32 x warp-iterations, counted by its measurement
    build), and the one-lane-a-thread design's, worked out from the same
    counts, not measured (a warp of 32 consecutive lanes runs its slowest
    lane's iterations)."""
    import torch

    iters = counts.reshape(-1) + 1
    pad = (-iters.numel()) % 32
    warps = torch.cat([iters, iters.new_zeros(pad)]).reshape(-1, 32)
    warp_iters, lane_iters = (int(v) for v in slots.cpu())
    return {"warp_iterations": warp_iters, "lane_iterations": lane_iters,
            "useful_share": lane_iters / (32 * warp_iters),
            "useful_share_one_lane_a_thread": int(iters.sum()) / (32 * int(warps.amax(1).sum()))}


def _knuth_case(keys, lam, n, sass, mem_bw, int_rate) -> dict:
    """``poisson_knuth`` of ``keys`` x ``n`` rows at ``lam`` on the card:
    bitwise the plain version, the launch captured (10 in a graph, on the
    wrapper's table uploaded once), the wrapper eager, the measurement
    build's useful share of lane-slots, and the bounds: 4 B written a lane,
    and the operations of this run's iterations and rows two ways, the hash
    alone (``HASH_INT_OPS`` a hash, two more hashes an iteration past the
    table) and the instructions the function needs (``knuth_sass``'s work:
    an iteration's and a row's, a ``split_chain`` call more an iteration
    past the table), each at the card's issue rate; beside them the
    instructions of a pass of the kernel's own loop."""
    import torch

    from orange3_spark_tpu_torch.ops import prng

    dev = torch.device("cuda")
    T = len(keys)
    got = prng.poisson_knuth(keys, lam, n, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = prng.poisson_reference(keys, lam, n, dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    equal = torch.equal(got, want)
    del want
    torch.cuda.empty_cache()
    J = prng.chain_table_size(lam)
    packed = prng._knuth_table(keys, J, dev)
    out = torch.empty((T, n), dtype=torch.int32, device=dev)
    kernel_ms = graph_ms(lambda: prng._launch_knuth(packed, lam, out, J), 10)
    eager_ms = cuda_ms(lambda: prng.poisson_knuth(keys, lam, n, dev), 5, warmup=1)
    slots = torch.zeros(2, dtype=torch.int64, device=dev)
    prng._launch_knuth(packed, lam, out, J, slots)
    counts = got.to(torch.int64)
    shares = _knuth_shares(counts, slots)
    # this run's work: count + 1 iterations a lane; past the table an
    # iteration also splits the chain
    iters = int(counts.sum()) + counts.numel()
    past = int(torch.clamp_min(counts + 1 - J, 0).sum())
    equal_build = torch.equal(out, got) and shares["lane_iterations"] == iters
    rows, work = counts.numel(), sass["work"]
    hash_only = _prng_bound(4 * rows, HASH_INT_OPS * (iters + 2 * past), mem_bw, int_rate)
    recount = _prng_bound(4 * rows, work["iteration"] * iters + work["row"] * rows
                          + sass["split_chain"] * past, mem_bw, int_rate)
    line = {"trees": T, "rows": n, "lam": lam, "chain_table": J,
            "tile_rows": prng.KNUTH_TILE_ROWS,
            "bitwise_plain": equal, "measurement_build_equal": equal_build,
            "ms": kernel_ms, "eager_ms": eager_ms,
            "plain_ms": plain_s * 1e3,
            "max_count": int(counts.max()), "lanes_past_table": int((counts + 1 > J).sum()),
            "iterations": iters, "hashes": iters + 2 * past,
            **shares,
            "instructions_per_iteration": sass["loop"]["instructions"],
            "work_instructions_per_iteration": work["iteration"],
            "work_instructions_per_row": work["row"],
            "bytes": recount["bytes"], "bytes_ms": recount["bytes_ms"],
            "issue_ops": recount["int_ops"], "bound_ms": recount["bound_ms"],
            "bound_by": recount["bound_by"], "x_bound": kernel_ms / recount["bound_ms"],
            "int_ops": hash_only["int_ops"], "hash_bound_ms": hash_only["bound_ms"],
            "x_hash_bound": kernel_ms / hash_only["bound_ms"]}
    del got, counts, out
    torch.cuda.empty_cache()
    return line


def phase_prng(mem_bw, int_rate) -> dict:
    """``threefry_bits`` at a 10M uniform and at one tree's row count of
    the forest's draw, ``poisson_knuth`` at the forest's (20 trees x
    10,737,856 rows, lam 1) and at GBT's subsampled round (one key, lam
    0.8): bitwise their plain versions on the card, the kernels timed
    captured (20 launches in a graph; ``poisson_knuth``'s launch on a table
    uploaded once), the wrappers eager, the plain versions, and each bound
    (4 B written a lane; 73 integer operations a hash at the card's issue
    rate; for ``poisson_knuth`` also the instructions its function needs,
    from ``probes/knuth_work.cu``'s SASS, beside its own loop's pass, and
    the share of issued lane-slots that did work)."""
    import torch

    from orange3_spark_tpu_torch.ops import prng

    dev = torch.device("cuda")
    key = prng.PRNGKey(0)
    bits = {}
    for name, n in (("uniform_10M", PRNG_UNIFORM_ROWS), ("forest_rows", PRNG_ROWS)):
        equal = torch.equal(prng.threefry_bits(key, n, dev),
                            prng.threefry_bits_reference(key, n, dev))
        bits[name] = {
            "n": n, "bitwise_plain": equal,
            "ms": graph_ms(lambda n=n: prng.threefry_bits(key, n, dev), 20),
            "eager_ms": cuda_ms(lambda n=n: prng.threefry_bits(key, n, dev), 20, warmup=2),
            "uniform_ms": graph_ms(lambda n=n: prng.uniform(key, n, dev), 20),
            "plain_ms": graph_ms(lambda n=n: prng.threefry_bits_reference(key, n, dev), 3),
            **_prng_bound(4 * n, HASH_INT_OPS * n, mem_bw, int_rate)}
        torch.cuda.empty_cache()
    sass = knuth_sass()
    poisson = {**_knuth_case(_forest_keys(0, PRNG_TREES), 1.0, PRNG_ROWS, sass, mem_bw,
                             int_rate),
               "ms_one_lane_a_thread": POISSON_MS_ONE_LANE}
    gbt = _knuth_case([prng.split(prng.PRNGKey(0))[1]], PRNG_GBT_LAM, PRNG_ROWS, sass,
                      mem_bw, int_rate)
    line = {"threefry_bits": bits, "poisson_knuth": poisson, "poisson_knuth_gbt_round": gbt,
            "knuth_sass": {"loop": sass["loop"], "split_chain_instructions": sass["split_chain"],
                           "work": sass["work"]},
            "int32_ops_per_s": int_rate}
    bad = [n for n, b in bits.items() if not b["bitwise_plain"]]
    bad += [n for n, c in (("forest", poisson), ("gbt_round", gbt))
            if not (c["bitwise_plain"] and c["measurement_build_equal"])]
    if bad:
        raise AssertionError(f"prng kernels differ from their plain versions ({bad}): {line}")
    return line


def _parity_draws(tables) -> dict:
    """The seeded fits with no injected draws, card against CPU: a 4-tree
    forest field by field, GBT with subsampling 0.8 (the same-split
    fraction, AUC within 0.005), and the Poisson counts of the forest's
    draw and of ``PRNG_PARITY_KEYS`` x ``PRNG_PARITY_ROWS`` lanes."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import auc
    from orange3_spark_tpu_torch.models.gbt import GBTClassifier
    from orange3_spark_tpu_torch.models.random_forest import RandomForestClassifier
    from orange3_spark_tpu_torch.ops import prng

    rf = {n: RandomForestClassifier(num_trees=4, max_depth=5, seed=3).fit(t)
          for n, t in tables.items()}
    forest_equal = all(torch.equal(a.cpu(), b) for a, b in zip(rf["cuda"].forest,
                                                               rf["cpu"].forest))
    gbt = {n: GBTClassifier(max_iter=5, subsampling_rate=0.8, seed=1).fit(t)
           for n, t in tables.items()}
    same = float(np.mean(
        (gbt["cpu"].forest.feature.numpy() == gbt["cuda"].forest.feature.cpu().numpy())
        & (gbt["cpu"].forest.split_bin.numpy() == gbt["cuda"].forest.split_bin.cpu().numpy())))
    y = tables["cpu"].y.numpy()
    aucs = {n: auc(m.predict_proba(tables[n])[:, 1], y) for n, m in gbt.items()}
    n = tables["cpu"].n_pad
    keys = _forest_keys(3, 4)
    lanes = [(keys, n), (_forest_keys(11, PRNG_PARITY_KEYS), PRNG_PARITY_ROWS)]
    differ = total = 0
    for ks, rows in lanes:
        card = prng.poisson_knuth(ks, 1.0, rows, "cuda").cpu()
        host = prng.poisson_knuth(ks, 1.0, rows, "cpu")
        differ += int((card != host).sum())
        total += card.numel()
    line = {"seeded_forest_bitwise_equal": forest_equal,
            "gbt_subsample_same_split_fraction": same,
            "gbt_subsample_auc_cpu": aucs["cpu"], "gbt_subsample_auc_cuda": aucs["cuda"],
            "poisson_lanes": total, "poisson_lanes_differ": differ,
            "poisson_differ_share": differ / total}
    if not forest_equal:
        raise AssertionError(f"the seeded forest on the card differs from the CPU's: {line}")
    if not abs(aucs["cpu"] - aucs["cuda"]) < 0.005:
        raise AssertionError(f"the subsampled GBT on the card disagrees with the CPU: {line}")
    if differ / total > PRNG_MISMATCH_SHARE:
        raise AssertionError(f"Poisson counts differ card against CPU: {line}")
    return line


# ------------------------------------------------- the supervised estimators
SUP_CUT = 200_000           # the CPU path's rows of each supervised fit
SUP_METRIC_SLACK = 0.005    # the full fit's held-out metric against the cut's
SUP_REQUEST_ROWS = 1000     # a served request (ladder 256..4096)
SUP_DENSE_ROWS = 4_000_000  # the dense_logreg X (bench.py:1268-1312)
SUP_COVTYPE = dict(rows=581_012, features=54, classes=7)  # UCI Covertype's shape
SUP_CV_ROWS = 1_000_000
SUP_ISOTONIC_ROWS = 1_000_000   # cut: the reference's PAV is a Python loop
SUP_FORMULA = "tip_amount ~ fare_amount + trip_distance + VendorID + VendorID:trip_distance"
# the CPU tests' tolerances (tests/test_torch_supervised.py, test_torch_tuning.py)
SUP_TOL = {"nb": 1e-5, "glm": 2e-4, "aft": 1e-4, "mlp": 2e-4, "fm": 5e-5, "ovr": 1e-4,
           "cv": 1e-4}
# the MLP's and FM's paths amplify float32 order noise on these rows (the
# CPU against itself on row-permuted rows, probes/mlp_card_cpu.py: the
# MLP 1.4e-5 after 6 l-bfgs iterations, 7.4e-4 after 11, 7.2e-2 after 15;
# FM 1.5e-5 after 60 adam steps, 8.4e-5 after its 93), so card and CPU are
# held to the CPU tests' tolerances after the MLP's first 5 iterations and
# FM's first 60 steps (the CPU test's count); the full fits' gap is reported
SUP_CHECK_ITERS = {"mlp": 5, "fm": 60}


def _sup_rel(a, b) -> float:
    import numpy as np
    a = np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, np.float64)
    b = np.asarray(b.detach().cpu() if hasattr(b, "detach") else b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(a)), initial=0.0))


def _sup_state_rel(card, host) -> float:
    """The largest relative difference of two models' state leaves."""
    def leaves(s):
        if isinstance(s, dict):
            return [x for k in sorted(s) for x in leaves(s[k])]
        if isinstance(s, (list, tuple)):
            return [x for v in s for x in leaves(v)]
        return [s]
    return max(_sup_rel(h, c) for c, h in zip(leaves(card.state_pytree),
                                             leaves(host.state_pytree)))


def _sup_proba1(model, table):
    for name in ("predict_proba", "predict_probability"):
        fn = getattr(model, name, None)
        if fn is not None:
            return fn(table)[:, 1]
    return model.predict(table)


def _sup_auc(model, table, y) -> float:
    from orange3_spark_tpu_torch.datasets import auc

    return auc(_sup_proba1(model, table), y)


def _sup_served(model, table) -> bool:
    """The served predictions (``predict``, else ``transform``) of a
    request of the first ``SUP_REQUEST_ROWS`` rows of ``table`` bitwise its
    raw ones."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    X, Y, _ = table.to_numpy()
    req = TorchTable.from_numpy(table.domain, X[:SUP_REQUEST_ROWS],
                                None if Y is None else Y[:SUP_REQUEST_ROWS],
                                session=table.session)

    def out(m):
        if hasattr(m, "predict"):
            return np.asarray(m.predict(req))
        return m.transform(req).X[: req.n_rows].cpu().numpy()

    raw = out(model)
    with ServingContext(BucketLadder(min_bucket=256, max_bucket=4096)):
        served = out(model)
    torch.cuda.synchronize()
    return raw.shape == served.shape and raw.tobytes() == served.tobytes()


def _sup_case(name, est, card_train, card_cut, cpu_cut, card_hold, cpu_hold, metric,
              larger_better, compare, smi, serve_on=None) -> dict:
    """One estimator at full width on the card: the cut fit on the card (the
    warm-up) and on the CPU, held to each other by ``compare(card model,
    CPU model, card cut, CPU cut)`` (an (error, tolerance[, what]) tuple);
    then the timed full fit, its held-out metric against the CPU cut's,
    and a served request bitwise raw (of ``serve_on(model, held-out)``'s
    rows when given)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    card_small = est.fit(card_cut)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_model = est.fit(cpu_cut)
    cpu_s = time.perf_counter() - t0
    err, tol, *what = compare(card_small, cpu_model, card_cut, cpu_cut)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit(card_train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    m_full, m_cut = metric(model, card_hold), metric(cpu_model, cpu_hold)
    served = _sup_served(model, card_hold if serve_on is None else serve_on(model, card_hold))
    ok_metric = (m_full >= m_cut - SUP_METRIC_SLACK if larger_better
                 else m_full <= m_cut + SUP_METRIC_SLACK)
    line = {"rows": card_train.n_rows, "fit_s": fit_s, "warmup_cut_fit_s": warm_s,
            "cpu_cut_fit_s": cpu_s, "holdout_metric": m_full, "cpu_cut_metric": m_cut,
            "larger_is_better": larger_better, "card_vs_cpu_cut": err, "tolerance": tol,
            "served_bitwise_raw": served, "n_iter": getattr(model, "n_iter_", None),
            "nvidia_smi": smi, **({"compared": what[0]} if what else {})}
    failed = []
    if not err <= tol:
        failed.append(f"card cut fit {err} from the CPU's (tolerance {tol})")
    if not ok_metric:
        failed.append(f"held-out metric {m_full} against the cut's {m_cut}")
    if not served:
        failed.append("served predictions differ from raw")
    if not np.isfinite(m_full):
        failed.append("non-finite metric")
    if failed:
        raise AssertionError(f"supervised {name}: {failed}; {json.dumps(line)}")
    return line


def _sup_tables(domain, X, Y, n_hold, sess, cpu, cut=SUP_CUT):
    """(card train, card cut, CPU cut, card held-out, CPU held-out)."""
    from orange3_spark_tpu_torch import TorchTable

    def mk(s, a, b):
        return TorchTable.from_numpy(domain, X[a:b], None if Y is None else Y[a:b], session=s)

    n = X.shape[0] - n_hold
    return (mk(sess, 0, n), mk(sess, 0, cut), mk(cpu, 0, cut), mk(sess, n, None),
            mk(cpu, n, None))


def _sup_deviance(family, vp):
    """Held-out mean unit deviance of a GLM (lower is better)."""
    import numpy as np
    from orange3_spark_tpu_torch.models.glm import _deviance_fn

    dev_f = _deviance_fn(family, vp)

    def metric(model, table):
        import torch

        mu = torch.from_numpy(model.predict(table).astype(np.float64))
        y = table.y[: table.n_rows].cpu().to(torch.float64)
        return float(dev_f(y, mu).mean())
    return metric


def _sup_aft_nll(model, table) -> float:
    """Held-out mean negative Weibull log-likelihood of an AFT model."""
    import numpy as np
    X = table.X[: table.n_rows].cpu().numpy().astype(np.float64)
    t = table.y[: table.n_rows].cpu().numpy().astype(np.float64)
    ci = [i for i in range(X.shape[1]) if i not in model.feature_indices][0]
    eta = np.log(model.predict(table).astype(np.float64))
    sigma = float(model.scale)
    eps = (np.log(t) - eta) / sigma
    return float(np.mean(-(X[:, ci] * (eps - np.log(sigma)) - np.exp(eps))))


def _sup_rmse(model, table) -> float:
    import numpy as np
    p = np.asarray(model.predict(table), np.float64)
    y = table.y[: table.n_rows].cpu().numpy().astype(np.float64)
    return float(np.sqrt(np.mean((p - y) ** 2)))


def _sup_accuracy(model, table) -> float:
    import numpy as np
    y = table.y[: table.n_rows].cpu().numpy()
    return float(np.mean(np.asarray(model.predict(table)) == y))


def _sup_cmp_state(tol):
    return lambda c, h, *_: (_sup_state_rel(c, h), tol)


def _sup_first_flip(card, host, signature) -> int | None:
    """The first iteration at which two fits' signatures (each iteration's
    objective evaluations, or the iteration count) differ, None if never."""
    a, b = signature(card), signature(host)
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _sup_path_cmp(tol, refit, signature, rel=_sup_state_rel):
    """Card against CPU for an iterative fit whose steps take decisions on
    float32 values (a linesearch's conditions, IRLS's stop): while both
    take the same decisions, their iterates differ by the order of float32
    sums and are held to ``tol``; where one flips (another evaluation
    count in an iteration, another iteration count), the two fits go on
    along other paths, so both are refitted to the iterations before the
    flip (``refit(k, table)``) and held to ``tol`` there. Returns (error,
    tol, what was compared)."""
    def compare(card, host, card_tab, cpu_tab):
        k = _sup_first_flip(card, host, signature)
        info = {"first_flip_iteration": k, "full_fit_rel": rel(card, host)}
        if k is None:
            return info["full_fit_rel"], tol, info
        info["compared_at_iterations"] = k
        return rel(refit(k, card_tab), refit(k, cpu_tab)), tol, info
    return compare


def _sup_dense_glm_data(X, seed=0):
    """Log-linear means on the dense_logreg X (``default_rng(seed)``):
    poisson, gamma and tweedie (vp 1.5: a fifth zeros, else gamma) targets."""
    import numpy as np
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal(X.shape[1]) * (0.3 / np.sqrt(X.shape[1]))
    mu = np.exp(X.astype(np.float64) @ beta + 0.5)
    n = X.shape[0]
    return {"poisson": rng.poisson(mu).astype(np.float32),
            "gamma": rng.gamma(2.0, mu / 2.0).astype(np.float32),
            "tweedie": np.where(rng.random(n) < 0.2, 0.0,
                                rng.gamma(2.0, mu / 2.0)).astype(np.float32)}


def _sup_weibull(X, seed=1):
    """Weibull survival times log t = x·b + 1 + 0.7·log Exp(1), 30 %
    right-censored (observed at a uniform fraction of the event time),
    the censor flag (1 = event) appended as the last column."""
    import numpy as np
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal(X.shape[1]) * (0.5 / np.sqrt(X.shape[1]))
    t = np.exp(X.astype(np.float64) @ beta + 1.0 + 0.7 * np.log(rng.exponential(1.0, len(X))))
    event = rng.random(len(X)) >= 0.3
    t = np.where(event, t, t * rng.uniform(0.05, 1.0, len(X)))
    return (np.concatenate([X, event[:, None].astype(np.float32)], 1),
            t.astype(np.float32))


def phase_supervised(sess, higgs, smi) -> dict:
    """The supervised estimators at full width on the card,
    each fit timed after a warm-up (its cut fit on the card) with its
    held-out metric, held to the CPU path's fit of a 200,000-row cut."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.core.domain import ContinuousVariable, DiscreteVariable, Domain
    from orange3_spark_tpu_torch.datasets import (
        higgs_domain, make_classification, make_tlc_trips, tlc_domain,
    )
    from orange3_spark_tpu_torch.models.aft import AFTSurvivalRegression
    from orange3_spark_tpu_torch.models.base import Pipeline
    from orange3_spark_tpu_torch.models.evaluation import BinaryClassificationEvaluator
    from orange3_spark_tpu_torch.models.fm import FMClassifier
    from orange3_spark_tpu_torch.models.glm import GeneralizedLinearRegression as GLM
    from orange3_spark_tpu_torch.models.isotonic import IsotonicRegression
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression
    from orange3_spark_tpu_torch.models.mlp import MultilayerPerceptronClassifier
    from orange3_spark_tpu_torch.models.naive_bayes import NaiveBayes
    from orange3_spark_tpu_torch.models.one_vs_rest import OneVsRest
    from orange3_spark_tpu_torch.models.rformula import RFormula
    from orange3_spark_tpu_torch.models.tuning import CrossValidator

    cpu = TorchSession("cpu")
    t_start = time.perf_counter()
    out = {}
    X, y = higgs
    tabs = _sup_tables(higgs_domain(), X, y, HOLDOUT, sess, cpu)
    y_hold = y[-HOLDOUT:]

    def auc_metric(m, t):
        return _sup_auc(m, t, y_hold)

    def evals_of(m):
        return list(m.iter_evals_)

    def fm(it=100):
        return FMClassifier(factor_size=8, max_iter=it, seed=0)

    def early_cmp(name, make):
        def compare(card, host, card_tab, cpu_tab):
            k = SUP_CHECK_ITERS[name]
            err = _sup_state_rel(make(k).fit(card_tab), make(k).fit(cpu_tab))
            return err, SUP_TOL[name], {"compared_at_iterations": k,
                                        "full_fit_rel": _sup_state_rel(card, host),
                                        "full_fit_iterations": [card.n_iter_, host.n_iter_]}
        return compare

    def glm_cmp(family, kw):
        return _sup_path_cmp(SUP_TOL["glm"],
                             lambda k, t: GLM(family=family, max_iter=k, **kw).fit(t),
                             lambda m: [1] * m.n_iter_)

    def mlp(it=100):
        return MultilayerPerceptronClassifier(layers=(28, 64, 64, 2), max_iter=it, seed=0)

    higgs_cases = [
        ("naive_bayes_gaussian", NaiveBayes(model_type="gaussian"),
         _sup_cmp_state(SUP_TOL["nb"])),
        ("glm_binomial", GLM(family="binomial"), glm_cmp("binomial", {})),
        ("mlp", mlp(), early_cmp("mlp", mlp)),
        ("fm_classifier", fm(), early_cmp("fm", fm)),
    ]
    for name, est, cmp in higgs_cases:
        out[name] = _sup_case(name, est, *tabs, auc_metric, True, cmp, smi)
    del tabs
    torch.cuda.empty_cache()

    # the dense_logreg X: the log-linear GLMs and AFT
    Xd, _ = _dense_logreg_data(SUP_DENSE_ROWS, 40)
    targets = _sup_dense_glm_data(Xd)
    ddom = Domain([ContinuousVariable(f"f{i}") for i in range(40)], ContinuousVariable("y"))
    for fam, kw in (("poisson", {"link": "log"}), ("gamma", {"link": "log"}),
                    ("tweedie", {"variance_power": 1.5})):
        tabs = _sup_tables(ddom, Xd, targets[fam], HOLDOUT, sess, cpu)
        out[f"glm_{fam}"] = _sup_case(f"glm_{fam}", GLM(family=fam, **kw), *tabs,
                                      _sup_deviance(fam, kw.get("variance_power", 0.0)),
                                      False, glm_cmp(fam, kw), smi)
        del tabs
    Xa, ta = _sup_weibull(Xd)
    adom = Domain([ContinuousVariable(f"f{i}") for i in range(40)]
                  + [ContinuousVariable("censor")], ContinuousVariable("time"))
    tabs = _sup_tables(adom, Xa, ta, HOLDOUT, sess, cpu)
    out["aft"] = _sup_case("aft", AFTSurvivalRegression(), *tabs, _sup_aft_nll, False,
                           _sup_path_cmp(SUP_TOL["aft"],
                                         lambda k, t: AFTSurvivalRegression(max_iter=k).fit(t),
                                         evals_of), smi)
    del tabs, Xd, Xa, targets
    torch.cuda.empty_cache()

    # OneVsRest on UCI Covertype's shape, the last tenth held out
    c = SUP_COVTYPE
    ctab = make_classification(c["rows"], c["features"], n_classes=c["classes"], session=cpu)
    Xc, Yc, _ = ctab.to_numpy()
    tabs = _sup_tables(ctab.domain, Xc, Yc, c["rows"] // 10, sess, cpu)

    def ovr_rel(card, host):
        return max(_sup_rel(h.coef, m.coef) for m, h in zip(card.models, host.models))

    def ovr_evals(m):   # the class fits' iterations side by side
        import itertools

        return list(itertools.zip_longest(*(b.iter_evals_ for b in m.models)))

    ovr_cmp = _sup_path_cmp(
        SUP_TOL["ovr"], lambda k, t: OneVsRest(LogisticRegression(max_iter=k)).fit(t),
        ovr_evals, ovr_rel)
    out["one_vs_rest"] = _sup_case("one_vs_rest", OneVsRest(LogisticRegression(max_iter=100)),
                                   *tabs, _sup_accuracy, True, ovr_cmp, smi)
    del tabs, ctab, Xc, Yc

    # RFormula over the TLC trips, a gaussian GLM on its output
    Xt = make_tlc_trips(WRANGLE_ROWS, WRANGLE_SEED)
    tabs = _sup_tables(tlc_domain(), Xt, None, HOLDOUT, sess, cpu)
    formula = RFormula(formula=SUP_FORMULA)

    class _FormulaGLM:
        """RFormula then a gaussian GLM, the GLM the model (its predict
        takes the formula's output)."""

        def fit(self, table):
            rf = formula.fit(table)
            glm = GLM(family="gaussian").fit(rf.transform(table))
            glm.formula_ = rf
            return glm

    def rf_rmse(model, table):
        return _sup_rmse(model, model.formula_.transform(table))

    def rf_cmp(card, host, *_):
        return _sup_state_rel(card, host), SUP_TOL["glm"]

    fcase = _sup_case("rformula_glm", _FormulaGLM(), *tabs, rf_rmse, False, rf_cmp, smi,
                      serve_on=lambda m, t: m.formula_.transform(t))
    card_f = formula.fit(tabs[1]).transform(tabs[1])
    cpu_f = formula.fit(tabs[2]).transform(tabs[2])
    fcase["formula"] = SUP_FORMULA
    fcase["columns"] = [v.name for v in card_f.domain.attributes]
    fcase["columns_bitwise_cpu"] = bool(torch.equal(card_f.X.cpu(), cpu_f.X))
    fcase["served_checked_on"] = "the GLM's predict on the formula's output"
    out["rformula_glm"] = fcase
    if not fcase["columns_bitwise_cpu"]:
        raise AssertionError(f"RFormula's columns differ card against CPU: {fcase}")
    del tabs, Xt, card_f, cpu_f
    torch.cuda.empty_cache()

    # CrossValidator on the first 1M HIGGS rows, scored on the held-out rows
    Xcv = np.concatenate([X[:SUP_CV_ROWS], X[-HOLDOUT:]])
    ycv = np.concatenate([y[:SUP_CV_ROWS], y[-HOLDOUT:]])
    tabs = _sup_tables(higgs_domain(), Xcv, ycv, HOLDOUT, sess, cpu)
    cv = CrossValidator(LogisticRegression(), [{"reg_param": 1e-4}, {"reg_param": 1e-2}],
                        BinaryClassificationEvaluator(), num_folds=3, seed=0)

    def cv_cmp(card, host, *_):
        return (float(np.max(np.abs(np.subtract(card.avg_metrics, host.avg_metrics))))
                if card.best_params == host.best_params else float("inf")), SUP_TOL["cv"]

    def cv_auc(model, table):
        return _sup_auc(model.best_model, table, y_hold)

    cvcase = _sup_case("cross_validator", cv, *tabs, cv_auc, True, cv_cmp, smi)
    from orange3_spark_tpu_torch import TorchTable

    cpu_full = TorchTable.from_numpy(higgs_domain(), Xcv[:SUP_CV_ROWS], ycv[:SUP_CV_ROWS],
                                     session=cpu)
    folds_equal = bool(torch.equal(cv._fold_masks(tabs[0]).cpu(), cv._fold_masks(cpu_full)))
    cvcase.update({"fits": 7, "fold_ids_bitwise_cpu": folds_equal,
                   "grid": [{"reg_param": 1e-4}, {"reg_param": 1e-2}], "num_folds": 3})
    out["cross_validator"] = cvcase
    if not folds_equal:
        raise AssertionError(f"CV fold ids differ card against CPU: {cvcase}")
    del tabs, cpu_full, Xcv, ycv

    # IsotonicRegression on 1M rows (cut: the PAV is a host loop), y on the
    # first feature, held out on the last rows
    Xi = np.concatenate([X[:SUP_ISOTONIC_ROWS], X[-HOLDOUT:]])
    yi = np.concatenate([y[:SUP_ISOTONIC_ROWS], y[-HOLDOUT:]])
    tabs = _sup_tables(higgs_domain(), Xi, yi, HOLDOUT, sess, cpu)

    def iso_cmp(card, host, *_):
        same = (torch.equal(card.boundaries.cpu(), host.boundaries)
                and torch.equal(card.predictions.cpu(), host.predictions))
        return (0.0 if same else float("inf")), 0.0

    out["isotonic"] = _sup_case("isotonic", IsotonicRegression(feature_index=0), *tabs,
                                _sup_rmse, False, iso_cmp, smi)
    out["isotonic"]["cut"] = f"{SUP_ISOTONIC_ROWS} rows (the PAV is a host loop, ~1 us a row)"
    del tabs, Xi, yi
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_start
    return out


# ------------------------------------------- MLlib's unsupervised, text,
# frequent-pattern and statistics modules (ROADMAP queue 1 item 4b)
UNSUP_CUT = 20_000              # the CPU path's rows of each compared fit
UNSUP_TAXI_ROWS = 10_000_000    # config 5's table
UNSUP_W2V_PAIRS = 1 << 16       # Word2Vec's max_pairs, cut from the reference's 2^20
UNSUP_W2V_CHECK_PAIRS = 4096    # the kernel's bitwise check: the first pairs' draws
UNSUP_PREFIXSPAN_SEQS = 10_000  # cut from 100,000: PrefixSpan's recursion is a host loop
UNSUP_TEXT_CUT_DOCS = 500       # the CPU path's documents of the compared LDA fit
UNSUP_W2V_CUT_DOCS, UNSUP_W2V_CUT_PAIRS = 300, 512   # the compared Word2Vec fit
UNSUP_CORPUS_VOCAB = 20_000     # the corpus' word types
# "pic": the share of nodes assigned differently card vs CPU; a node within
# float32's resolution of the two centres' midpoint may flip (12 of the
# 20,000 lie within 1e-4 of it, relative)
UNSUP_TOL = {"gmm": 1e-3, "bkm": 1e-4, "stat": 1e-4, "lda": 1e-3, "w2v": 1e-5, "pic": 1e-3}
UNSUP_PIC_FIRST_SHARE = 0.6     # the denser community's share of the edges' sources
UNSUP_PIC_MIN_PLANTED = 0.99    # every PIC assignment against the planted partition


def categorical_work_sass() -> dict:
    """The instructions ``categorical_gumbel``'s function needs an element,
    from the SASS of ``probes/categorical_work.cu``'s loops, built as a
    cubin with the package's code-generation flags: ``element``, a full
    evaluation (a hash, the uniform, XLA's log twice with each multiply-add
    one FFMA, the logit's add and the first-maximum compare); ``floor``,
    what every element needs whatever the design (the hash, the uniform's
    bits and the logit's read)."""
    from orange3_spark_tpu_torch.ops import cuda_build

    src = os.path.join(ROOT, "probes", "categorical_work.cu")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in cuda_build.NVCC_FLAGS if f.startswith(("-gencode", "-std", "-O"))]
    cubin = cuda_build.BUILD_DIR / "categorical_work.cubin"
    subprocess.run([cuda_build.nvcc_path(), *flags, "-cubin", "-o", str(cubin), src],
                   capture_output=True, text=True, timeout=300, check=True)
    funcs = sass_functions(sass_text(cubin))
    out = {}
    for name, fn in (("element", "categorical_work"), ("floor", "categorical_floor")):
        if fn not in funcs:
            raise AssertionError(f"{fn}'s SASS not found: {sorted(funcs)}")
        loop = sass_loop(funcs[fn])
        if loop["calls"]:
            raise AssertionError(f"{fn}'s loop calls out of line: {loop}")
        out[name] = loop["instructions"]
        out[name.replace("element", "opcodes").replace("floor", "opcodes_floor")] = \
            loop["opcodes"]
    return out


def gumbel_table_check(device) -> dict:
    """``categorical_gumbel``'s bound table on the card against the same
    table built on the CPU, and against each bucket's largest gumbel as the
    kernel's own code computes it (``prng.gumbel_values``: all 2^23
    uniforms)."""
    import math

    import torch

    from orange3_spark_tpu_torch.ops import prng

    card = prng.gumbel_bucket_table(device)
    host = prng.gumbel_bucket_table("cpu")
    own = prng.gumbel_values(device)
    codes = prng.gumbel_bucket(torch.arange(1 << 23, dtype=torch.int32, device=device) << 9)
    own_table = torch.full_like(card, -math.inf).scatter_reduce_(0, codes, own, "amax")
    out = {"card_equals_cpu": torch.equal(card.cpu(), host),
           "card_equals_kernel_own": torch.equal(card, own_table),
           "buckets_used": int(torch.isfinite(card).sum()),
           "largest_slack": float((card[codes] - own).max())}
    out["equal"] = out["card_equals_cpu"] and out["card_equals_kernel_own"]
    return out


def _sqrt_card_check() -> dict:
    """The premise of ``core/fmath.sqrt32`` on CUDA: the card's float32
    ``torch.sqrt`` of 1,000,000 seeded values equals the float64 root
    rounded once."""
    import numpy as np
    import torch

    x = torch.from_numpy(np.random.default_rng(0).uniform(1e-6, 1e6, 1_000_000)
                         .astype(np.float32)).cuda()
    misses = int((torch.sqrt(x) != torch.sqrt(x.double()).float()).sum())
    if misses:
        raise AssertionError(f"the card's float32 sqrt is not correctly rounded: {misses} "
                             "of 1,000,000 differ from the float64 root rounded")
    return {"values": 1_000_000, "misses": misses}


def _unsup_rel(a, b) -> float:
    """The largest |a - b| / max(1, |a|) over paired arrays or tensors."""
    import numpy as np
    import torch

    def host(v):
        return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float64)
    a, b = host(a), host(b)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(a)), initial=0.0))


def _unsup_timed(fn):
    """(result, seconds) of ``fn()`` on the card, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _unsup_check(out: dict, name: str, err, tol, **extra) -> None:
    out[name] = {"card_vs_cpu_cut": err, "tolerance": tol, **extra}
    print(json.dumps({"unsupervised": name, **out[name]}), file=sys.stderr, flush=True)
    if not err <= tol:
        raise AssertionError(f"unsupervised {name}: card cut {err} from the CPU's "
                             f"(tolerance {tol}); {json.dumps(out[name])}")


def _unsup_tables(domain, X, Y, sess, cpu, cut=UNSUP_CUT, metas=None):
    """(card table, card cut, CPU cut) of the same rows."""
    from orange3_spark_tpu_torch import TorchTable

    def mk(s, n):
        return TorchTable.from_numpy(domain, X[:n], None if Y is None else Y[:n],
                                     None if metas is None else metas[:n], session=s)
    return mk(sess, None), mk(sess, cut), mk(cpu, cut)


def _unsup_clusters(sess, cpu, out) -> None:
    """GaussianMixture(k=10) and BisectingKMeans(k=10) on config 5's taxi
    table after StandardScaler, then both LSH families' neighbours."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.datasets import make_taxi_proxy, taxi_domain
    from orange3_spark_tpu_torch.models import feature_extra as FE
    from orange3_spark_tpu_torch.models.bisecting_kmeans import BisectingKMeans
    from orange3_spark_tpu_torch.models.gaussian_mixture import GaussianMixture
    from orange3_spark_tpu_torch.models.preprocess import StandardScaler

    X = make_taxi_proxy(UNSUP_TAXI_ROWS)
    raw = TorchTable.from_numpy(taxi_domain(), X, session=sess)
    del X
    scaled, s_scale = _unsup_timed(lambda: StandardScaler(with_mean=True).fit(raw)
                                   .transform(raw))
    Xs = scaled.X.cpu().numpy()
    full, card_cut, cpu_cut = _unsup_tables(taxi_domain(), Xs, None, sess, cpu)
    del raw, scaled, Xs
    out["taxi"] = {"rows": full.n_rows, "features": full.n_attrs, "scaler_s": s_scale}

    gm_cmp = GaussianMixture(k=10, max_iter=5, seed=0)
    a, b = gm_cmp.fit(card_cut), gm_cmp.fit(cpu_cut)
    err = max(_unsup_rel(getattr(b, f), getattr(a, f)) for f in ("weights", "means", "covs"))
    GaussianMixture(k=10, seed=0).fit(card_cut)                  # warm-up
    gm, fit_s = _unsup_timed(lambda: GaussianMixture(k=10, seed=0).fit(full))
    _unsup_check(out, "gaussian_mixture", err, UNSUP_TOL["gmm"], compared_at_iterations=5,
                 iterations_equal=a.n_iter_ == b.n_iter_, fit_s=fit_s, n_iter=gm.n_iter_,
                 log_likelihood=gm.log_likelihood_,
                 cluster_sizes=gm.cluster_sizes_.cpu().numpy().tolist())
    if not np.isfinite(gm.log_likelihood_) or a.n_iter_ != b.n_iter_:
        raise AssertionError(f"gaussian_mixture: {out['gaussian_mixture']}")

    bk = BisectingKMeans(k=10, seed=0)
    a, b = bk.fit(card_cut), bk.fit(cpu_cut)
    err = _unsup_rel(b.centers, a.centers)
    bm, fit_s = _unsup_timed(lambda: bk.fit(full))
    _unsup_check(out, "bisecting_kmeans", err, UNSUP_TOL["bkm"], fit_s=fit_s,
                 leaves=int(bm.centers.shape[0]), training_cost=bm.training_cost_,
                 cluster_sizes=bm.cluster_sizes_.cpu().numpy().tolist())

    key = full.X[0].cpu().numpy()
    for name, est in (("brp_lsh", FE.BucketedRandomProjectionLSH(bucket_length=2.0,
                                                                  num_hash_tables=3, seed=0)),
                      ("minhash_lsh", FE.MinHashLSH(num_hash_tables=3, seed=0))):
        ic, dc = est.fit(card_cut).approx_nearest_neighbors(card_cut, key, k=10)
        ih, dh = est.fit(cpu_cut).approx_nearest_neighbors(cpu_cut, key, k=10)
        model = est.fit(full)
        model.approx_nearest_neighbors(full, key, k=10)           # warm-up
        (idx, dist), s = _unsup_timed(lambda: model.approx_nearest_neighbors(full, key, k=10))
        _unsup_check(out, name, 0 if np.array_equal(ic, ih) else 1, 0, neighbours_s=s,
                     distance_rel=_unsup_rel(dh, dc), found=len(idx),
                     nearest=[int(i) for i in idx[:3]])
    del full, card_cut, cpu_cut
    torch.cuda.empty_cache()


def _unsup_stats(sess, cpu, higgs, out) -> None:
    """``models/stat`` and the feature selectors on config 3's HIGGS proxy
    (11,000,000 x 28), each held to the CPU path on a cut."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import higgs_domain
    from orange3_spark_tpu_torch.models import feature_extra as FE
    from orange3_spark_tpu_torch.models import stat as S

    X, y = higgs
    full, card_cut, cpu_cut = _unsup_tables(higgs_domain(), X, y, sess, cpu)
    out["higgs"] = {"rows": full.n_rows, "features": full.n_attrs}
    mean = X[:UNSUP_CUT].astype(np.float64).mean(0)
    cov = np.cov(X[:UNSUP_CUT].astype(np.float64), rowvar=False)
    cases = {
        "pearson": lambda t: S.Correlation.corr(t, "pearson"),
        "spearman": lambda t: S.Correlation.corr(t, "spearman"),
        "summarizer": lambda t: np.stack([S.Summarizer.metrics(t).variance,
                                          S.Summarizer.metrics(t).mean]),
        "anova": lambda t: S.ANOVATest.test(t).f_values,
        "fvalue": lambda t: S.FValueTest.test(t).f_values,
        "mvn_logpdf": lambda t: S.MultivariateGaussian(mean, cov, device=t.X.device)
        .logpdf(t.X[: t.n_rows]),
        "robust_scaler": lambda t: FE.RobustScaler().fit(t).iqr,
    }
    for name, fn in cases.items():
        err = _unsup_rel(fn(cpu_cut), fn(card_cut))
        res, s = _unsup_timed(lambda: fn(full))
        finite = bool(np.isfinite(np.asarray(res.detach().cpu() if isinstance(
            res, torch.Tensor) else res)).all())
        _unsup_check(out, name, err, UNSUP_TOL["stat"], s=s, finite=finite)
        if not finite:
            raise AssertionError(f"unsupervised {name}: non-finite output on the card")
        del res
    for name, est in (("variance_threshold", FE.VarianceThresholdSelector(
                           variance_threshold=1.0)),
                      ("univariate_selector", FE.UnivariateFeatureSelector(
                          selection_threshold=10))):
        same = est.fit(card_cut).selected == est.fit(cpu_cut).selected
        model, s = _unsup_timed(lambda: est.fit(full))
        _unsup_check(out, name, 0 if same else 1, 0, fit_s=s, selected=len(model.selected))
    del full, card_cut, cpu_cut
    torch.cuda.empty_cache()


def _unsup_tlc(sess, cpu, out) -> None:
    """ChiSquareTest and ChiSqSelector of the TLC trips' categorical columns
    against payment_type (rows with a missing value weighted 0)."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.core.domain import Domain
    from orange3_spark_tpu_torch.datasets import TLC_COLUMNS, make_tlc_trips, tlc_domain
    from orange3_spark_tpu_torch.models import feature_extra as FE
    from orange3_spark_tpu_torch.models import stat as S

    T = make_tlc_trips(WRANGLE_ROWS)
    cols = ("VendorID", "PULocationID", "DOLocationID", "passenger_count")
    full_dom = tlc_domain()
    dom = Domain([full_dom[c] for c in cols], full_dom["payment_type"])
    idx = [TLC_COLUMNS.index(c) for c in cols]
    X, Y = T[:, idx], T[:, TLC_COLUMNS.index("payment_type")]
    del T
    tabs = [t.dropna() for t in _unsup_tables(dom, X, Y, sess, cpu)]
    full, card_cut, cpu_cut = tabs
    a, b = S.ChiSquareTest.test(card_cut), S.ChiSquareTest.test(cpu_cut)
    same = (np.array_equal(a.statistics, b.statistics)
            and np.array_equal(a.degrees_of_freedom, b.degrees_of_freedom))
    S.ChiSquareTest.test(card_cut)
    res, s = _unsup_timed(lambda: S.ChiSquareTest.test(full))
    _unsup_check(out, "chi_square", 0 if same else 1, 0, rows=full.n_rows, s=s,
                 dof=res.degrees_of_freedom.tolist(), statistics=res.statistics.tolist())
    sel = FE.ChiSqSelector(selection_threshold=2, n_bins=16)
    same = sel.fit(card_cut).selected == sel.fit(cpu_cut).selected
    model, s = _unsup_timed(lambda: sel.fit(full))
    _unsup_check(out, "chisq_selector", 0 if same else 1, 0, fit_s=s,
                 selected=list(model.selected))
    del full, card_cut, cpu_cut, tabs
    torch.cuda.empty_cache()


def _unsup_pic(sess, cpu, out) -> None:
    """PowerIterationClustering(k=2, max_iter=20, init_mode='degree') on a
    planted-partition graph of com-LiveJournal's size whose first community
    is the denser one (it sources ``UNSUP_PIC_FIRST_SHARE`` of the edges),
    so the degree start carries the partition. ``assign_clusters`` is held
    card against CPU on a 20,000-node graph of the same kind, and every
    assignment, the full-size fit's included, to the planted partition.
    (From a random start the pseudo-eigenvector's spread shrinks as
    1/sqrt(nodes), and the reference's float32 1-D k-means, a matmul
    identity, cannot split it at this size.)"""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import (
        LIVEJOURNAL_EDGES, LIVEJOURNAL_NODES, make_planted_graph,
    )
    from orange3_spark_tpu_torch.models.power_iteration import PowerIterationClustering

    def planted(assign) -> float:
        hit = float(np.mean(assign == (np.arange(len(assign)) >= len(assign) // 2)))
        return max(hit, 1.0 - hit)

    pic = PowerIterationClustering(k=2, max_iter=20, init_mode="degree", seed=0)
    n_small = UNSUP_CUT
    small = make_planted_graph(n_small, n_small * LIVEJOURNAL_EDGES // LIVEJOURNAL_NODES,
                               first_share=UNSUP_PIC_FIRST_SHARE)
    card_cut = pic.assign_clusters(small, device=sess.device)      # also the warm-up
    cpu_cut = pic.assign_clusters(small, device=cpu.device)
    err = float(np.mean(card_cut != cpu_cut))
    graph = make_planted_graph(LIVEJOURNAL_NODES, LIVEJOURNAL_EDGES,
                               first_share=UNSUP_PIC_FIRST_SHARE)
    assign, s = _unsup_timed(lambda: pic.assign_clusters(graph, device=sess.device))
    agreement = {"cut_card": planted(card_cut), "cut_cpu": planted(cpu_cut),
                 "full_card": planted(assign)}
    _unsup_check(out, "power_iteration", err, UNSUP_TOL["pic"], nodes=LIVEJOURNAL_NODES,
                 edges=LIVEJOURNAL_EDGES, fit_s=s, init_mode="degree",
                 first_share=UNSUP_PIC_FIRST_SHARE, planted_agreement=agreement,
                 min_planted_agreement=UNSUP_PIC_MIN_PLANTED,
                 sizes=np.bincount(assign, minlength=2).tolist(),
                 compared=f"the share of {n_small} nodes that assign_clusters puts in "
                          "another cluster on the card than on the CPU")
    if min(agreement.values()) < UNSUP_PIC_MIN_PLANTED:
        raise AssertionError(f"power_iteration misses the planted partition: "
                             f"{out['power_iteration']}")
    torch.cuda.empty_cache()


def _text_table(docs, sess):
    import numpy as np

    from orange3_spark_tpu_torch import TorchTable
    from orange3_spark_tpu_torch.core.domain import Domain, StringVariable

    return TorchTable.from_numpy(Domain([], None, [StringVariable("text")]),
                                 np.zeros((len(docs), 0), np.float32), metas=docs, session=sess)


def _unsup_text(sess, cpu, out, mem_bw, int_rate) -> dict:
    """The text path on a seeded Zipf corpus of 20 Newsgroups' 18,846
    documents: the string stages into HashingTF(2^18), CountVectorizer(
    10000) then IDF, LDA(k=20, max_iter=20) on the counts, Word2Vec; then
    ``categorical_gumbel`` held bitwise against its plain version on the
    first and the last pairs' draws, its bound table checked, and timed at
    the fit's full shape. Returns the kernel's line."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import NEWSGROUPS_DOCS, make_zipf_corpus
    from orange3_spark_tpu_torch.models import text as T
    from orange3_spark_tpu_torch.models.lda import LDA
    from orange3_spark_tpu_torch.ops import prng

    docs = make_zipf_corpus(NEWSGROUPS_DOCS, vocab=UNSUP_CORPUS_VOCAB)
    table = _text_table(docs, sess)
    stages = {}
    t = table
    for name, st in (("tokenizer", T.Tokenizer()), ("stop_words", T.StopWordsRemover()),
                     ("ngram", T.NGram(input_col="filtered", output_col="bigrams"))):
        t, stages[name] = _unsup_timed(lambda: st.transform(t))
    tokens = int(sum(len(x) for x in t.metas[:, -1]))
    htf = T.HashingTF(input_col="bigrams", num_features=1 << 18)
    hashed, stages["hashing_tf"] = _unsup_timed(lambda: htf.transform(t))
    cut_rows = 200
    small = T.NGram(input_col="filtered", output_col="bigrams").transform(
        T.StopWordsRemover().transform(T.Tokenizer().transform(_text_table(docs[:cut_rows],
                                                                           cpu))))
    same_hash = torch.equal(hashed.X[:cut_rows].cpu(), htf.transform(small).X)
    hashed_sum = float(hashed.X.sum())
    del hashed
    torch.cuda.empty_cache()
    toks = T.Tokenizer().transform(table)
    cv, stages["count_vectorizer_fit"] = _unsup_timed(
        lambda: T.CountVectorizer(vocab_size=10000).fit(toks))
    counts, stages["count_vectorizer"] = _unsup_timed(lambda: cv.transform(toks))
    idf, stages["idf_fit"] = _unsup_timed(lambda: T.IDF().fit(counts))
    _, stages["idf"] = _unsup_timed(lambda: idf.transform(counts))

    def cut_fits(s):
        """CountVectorizer(10000) then IDF fitted on the first documents."""
        tk = T.Tokenizer().transform(_text_table(docs[:cut_rows], s))
        model = T.CountVectorizer(vocab_size=10000).fit(tk)
        c = model.transform(tk)
        return model.vocabulary, c.X[: c.n_rows].cpu(), T.IDF().fit(c).idf.cpu()

    (voc_card, cnt_card, idf_card), (voc_cpu, cnt_cpu, idf_cpu) = cut_fits(sess), cut_fits(cpu)
    equal_cpu = {"hashing_tf": same_hash, "count_vectorizer_vocabulary": voc_card == voc_cpu,
                 "count_vectorizer_counts": torch.equal(cnt_card, cnt_cpu),
                 "idf_weights": torch.equal(idf_card, idf_cpu)}
    _unsup_check(out, "text_stages", sum(not v for v in equal_cpu.values()), 0, **stages,
                 documents=len(docs), tokens_after_ngram=tokens, hashed_total=hashed_sum,
                 equal_cpu=equal_cpu, compared_documents=cut_rows, vocab=len(cv.vocabulary),
                 compared="stages that differ card vs CPU on the first documents, each "
                          "fitted on its own device and held bitwise")

    lda_small = LDA(k=20, max_iter=3, seed=0)
    cut_docs = UNSUP_TEXT_CUT_DOCS
    card_cut = cv.transform(T.Tokenizer().transform(_text_table(docs[:cut_docs], sess)))
    cpu_cut = cv.transform(T.Tokenizer().transform(_text_table(docs[:cut_docs], cpu)))
    err = _unsup_rel(lda_small.fit(cpu_cut).lam, lda_small.fit(card_cut).lam)
    lda, fit_s = _unsup_timed(lambda: LDA(k=20, max_iter=20, seed=0).fit(counts))
    perplexity = lda.log_perplexity(counts)
    _unsup_check(out, "lda", err, UNSUP_TOL["lda"], fit_s=fit_s, compared_at_iterations=3,
                 matrix=[counts.n_rows, counts.n_attrs],
                 matrix_mb=counts.n_rows * counts.n_attrs * 4 / 1e6,
                 log_perplexity=perplexity)
    if not np.isfinite(perplexity):
        raise AssertionError("lda: non-finite perplexity")
    del counts, card_cut, cpu_cut, lda
    torch.cuda.empty_cache()

    w2v_kw = dict(vector_size=100, min_count=5, window_size=5, negative=5)
    cut_w2v = dict(max_pairs=UNSUP_W2V_CUT_PAIRS, **w2v_kw)
    a = T.Word2Vec(**cut_w2v).fit(
        T.Tokenizer().transform(_text_table(docs[:UNSUP_W2V_CUT_DOCS], sess)))
    b = T.Word2Vec(**cut_w2v).fit(
        T.Tokenizer().transform(_text_table(docs[:UNSUP_W2V_CUT_DOCS], cpu)))
    err = float((a.vectors.cpu() - b.vectors).abs().max())
    prng.categorical_gumbel.launches = 0
    w2v, fit_s = _unsup_timed(lambda: T.Word2Vec(max_pairs=UNSUP_W2V_PAIRS, **w2v_kw)
                              .fit(toks))
    launches = prng.categorical_gumbel.launches
    again = T.Word2Vec(max_pairs=UNSUP_W2V_PAIRS, **w2v_kw).fit(toks)
    bitwise_refit = torch.equal(again.vectors, w2v.vectors)
    V = len(w2v.vocabulary)
    _unsup_check(out, "word2vec", err, UNSUP_TOL["w2v"], fit_s=fit_s, vocab=V,
                 pairs=UNSUP_W2V_PAIRS, steps=10, kernel_launches=launches,
                 two_fits_bitwise=bitwise_refit, compared="max |vectors| difference, "
                 f"{UNSUP_W2V_CUT_DOCS} documents, {UNSUP_W2V_CUT_PAIRS} pairs")
    if launches != 10 or not bitwise_refit:
        raise AssertionError(f"word2vec: {out['word2vec']}")

    # the kernel at the fit's draw: P x negative rows over V
    freq = _w2v_probs(toks, w2v.vocabulary)
    logits = prng._xla_log(torch.from_numpy(freq).to(sess.device))
    key = prng.split(prng.split(prng.PRNGKey(0))[0])[1]
    rows = UNSUP_W2V_PAIRS * w2v_kw["negative"]
    check_rows = UNSUP_W2V_CHECK_PAIRS * w2v_kw["negative"]
    got = prng.categorical_gumbel(key, logits, rows)
    plain, plain_s = _unsup_timed(lambda: prng.categorical_gumbel_reference(key, logits,
                                                                            check_rows))
    last = rows - check_rows
    tail = prng.categorical_gumbel_reference(key, logits, check_rows, first_row=last)
    windows = {"first": torch.equal(got[:check_rows], plain),
               "last": torch.equal(got[last:], tail)}
    bitwise = all(windows.values())
    counts = torch.zeros(2, dtype=torch.int64, device=logits.device)
    counted = torch.empty(rows, dtype=torch.int32, device=logits.device)
    prng._launch_categorical(key, logits, 0, counted, counts)
    evaluated, passes = (int(c) for c in counts.cpu())
    prefix_ms = cuda_ms(lambda: prng.categorical_gumbel(key, logits, check_rows), 5, warmup=1)
    ms = cuda_ms(lambda: prng.categorical_gumbel(key, logits, rows), 5, warmup=1)
    sass = categorical_work_sass()
    elements = rows * V
    bound = _prng_bound(4 * rows + 4 * V, sass["floor"] * elements, mem_bw, int_rate)
    full = _prng_bound(4 * rows + 4 * V, sass["element"] * elements, mem_bw, int_rate)
    line = {"rows": rows, "V": V, "elements": elements, "check_rows": check_rows,
            "checked_windows": {"first": [0, check_rows], "last": [last, rows]},
            "bitwise_plain": bitwise, "bitwise_windows": windows,
            "measurement_build_bitwise": torch.equal(counted, got),
            "max_abs_err": 0 if bitwise else None,
            "ms": ms, "prefix_ms": prefix_ms, "plain_prefix_ms": plain_s * 1e3,
            "plain_ms": plain_s * 1e3, "plain_at": f"the first {check_rows} rows",
            "launches": launches, "evaluated": evaluated, "evaluated_share": evaluated / elements,
            "evaluation_passes": passes, "evaluation_passes_per_row": passes / rows,
            "instructions_per_element_floor": sass["floor"],
            "instructions_per_element_full_evaluation": sass["element"],
            "floor_opcodes": sass["opcodes_floor"], "element_opcodes": sass["opcodes"],
            **bound, "x_bound": ms / bound["bound_ms"],
            "full_evaluation_bound_ms": full["bound_ms"],
            "x_full_evaluation_bound": ms / full["bound_ms"],
            "gumbel_table": gumbel_table_check(logits.device)}
    if not line["measurement_build_bitwise"] or not line["gumbel_table"]["equal"]:
        bitwise = False
    if not bitwise:
        raise AssertionError(f"categorical_gumbel differs from its plain version: {line}")
    del got, plain
    torch.cuda.empty_cache()
    return line


def _w2v_probs(toks, vocab):
    """Word2Vec's unigram^0.75 distribution over ``vocab`` (float32)."""
    import numpy as np

    counts: dict[str, int] = {}
    live = toks.W[: toks.n_rows].cpu().numpy() > 0
    for i, ts in enumerate(toks.metas[:, -1]):
        if live[i]:
            for w in ts:
                counts[w] = counts.get(w, 0) + 1
    freq = np.asarray([counts[w] for w in vocab], dtype=np.float64) ** 0.75
    return (freq / freq.sum()).astype(np.float32)


def _unsup_fpm(sess, cpu, out) -> None:
    """FPGrowth(min_support=0.01) on T10I4D100K-shaped transactions, held
    to the CPU on 10,000 of them; PrefixSpan at MLlib's defaults
    (minSupport 0.1, maxPatternLength 10) on the first
    ``UNSUP_PREFIXSPAN_SEQS`` of them as sequences of 3-item itemsets."""
    import numpy as np

    from orange3_spark_tpu_torch.core.domain import Domain, StringVariable
    from orange3_spark_tpu_torch.datasets import make_transactions
    from orange3_spark_tpu_torch.models.fpm import FPGrowth, PrefixSpan

    tx = make_transactions()
    dom = Domain([], None, [StringVariable("items")])
    X = np.zeros((len(tx), 0), np.float32)
    full, card_cut, cpu_cut = _unsup_tables(dom, X, None, sess, cpu, cut=10_000, metas=tx)
    fp = FPGrowth(items_col="items", min_support=0.01, min_confidence=0.5)
    a, b = fp.fit(card_cut), fp.fit(cpu_cut)
    same = a.freq_itemsets_ == b.freq_itemsets_ and a.association_rules_ == b.association_rules_
    model, fit_s = _unsup_timed(lambda: fp.fit(full))
    pred, tr_s = _unsup_timed(lambda: model.transform(full))
    sizes = np.bincount([len(s) for s, _ in model.freq_itemsets_])
    _unsup_check(out, "fpgrowth", 0 if same else 1, 0, transactions=len(tx),
                 mean_length=float(np.mean([len(t) for t in tx[:, 0]])), fit_s=fit_s,
                 transform_s=tr_s, itemsets_by_size=sizes.tolist(),
                 rules=len(model.association_rules_), predicted_items=pred.n_attrs)
    seqs = np.empty((UNSUP_PREFIXSPAN_SEQS, 1), dtype=object)
    seqs[:, 0] = [[t[i:i + 3] for i in range(0, len(t), 3)]
                  for t in tx[:UNSUP_PREFIXSPAN_SEQS, 0]]
    _, card_seq, cpu_seq = _unsup_tables(Domain([], None, [StringVariable("sequence")]),
                                         X[:UNSUP_PREFIXSPAN_SEQS], None, sess, cpu,
                                         cut=UNSUP_PREFIXSPAN_SEQS, metas=seqs)
    ps = PrefixSpan()
    pats, s = _unsup_timed(lambda: ps.find_frequent_sequential_patterns(card_seq))
    same = pats == ps.find_frequent_sequential_patterns(cpu_seq)
    _unsup_check(out, "prefix_span", 0 if same else 1, 0, sequences=UNSUP_PREFIXSPAN_SEQS,
                 s=s, patterns=len(pats))


def phase_unsupervised(sess, higgs, mem_bw, int_rate) -> dict:
    """ROADMAP queue 1 item 4b at full width on the card, each fit or call
    timed (after a warm-up where the same shapes ran first) and held to
    the CPU path on a cut. ``segment_sum_sorted`` and
    ``categorical_gumbel``'s launches are counted over the phase."""
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.ops import prng
    from orange3_spark_tpu_torch.ops.segment_sum import segment_sum_sorted

    cpu = TorchSession("cpu")
    t_start = time.perf_counter()
    out = {"sqrt_card": _sqrt_card_check()}
    segment_sum_sorted.launches = 0
    prng.categorical_gumbel.launches = 0
    sections = {}

    def section(name, fn):
        t0 = time.perf_counter()
        res = fn()
        sections[name] = time.perf_counter() - t0
        return res

    section("clusters_lsh", lambda: _unsup_clusters(sess, cpu, out))
    section("stats_higgs", lambda: _unsup_stats(sess, cpu, higgs, out))
    section("chi_square_tlc", lambda: _unsup_tlc(sess, cpu, out))
    section("pic", lambda: _unsup_pic(sess, cpu, out))
    kernel = section("text", lambda: _unsup_text(sess, cpu, out, mem_bw, int_rate))
    section("fpm", lambda: _unsup_fpm(sess, cpu, out))
    out["section_s"] = sections
    out["segment_sum_launches"] = segment_sum_sorted.launches
    out["categorical_gumbel"] = kernel
    out["cuts"] = {"word2vec_max_pairs": f"{UNSUP_W2V_PAIRS} (the reference's 2^20)",
                   "prefix_span_sequences": f"{UNSUP_PREFIXSPAN_SEQS} (the corpus' 100,000)",
                   "cpu_cut_rows": UNSUP_CUT}
    out["phase_s"] = time.perf_counter() - t_start
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=11_000_000,
                    help="HIGGS-proxy rows (the config's 11M by default)")
    ap.add_argument("--criteo-rows", type=int, default=CRITEO_ROWS,
                    help="Criteo CSV rows (bench.py's 8M by default)")
    ap.add_argument("--criteo-epochs", type=int, default=CRITEO_EPOCHS,
                    help="Criteo fit epochs (bench.py's 100 by default)")
    ap.add_argument("--taxi-rows", type=int, default=TAXI_ROWS,
                    help="taxi pipeline rows (config 5's 10M by default)")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the skewed item draw of movielens_als")
    ap.add_argument("--resume-epochs", type=int, default=RESUME_EPOCHS,
                    help="epochs of the criteo_resume and criteo_fault fits "
                         f"({RESUME_EPOCHS} by default)")
    args = ap.parse_args(argv)
    if args.resume_epochs < 8 or args.resume_epochs % RESUME_EVERY_EPOCHS:
        # the drill crashes after its 3rd snapshot and compares the last,
        # which must be the fit's end
        ap.error(f"--resume-epochs must be a multiple of {RESUME_EVERY_EPOCHS}, at least 8")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import orange3_spark_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the orange3_spark_tpu_torch package is missing "
              f"next to this script: {e}", file=sys.stderr)
        return 3

    # flight bundles and deep captures of this run go to a directory of its
    # own (removed at the end), never to the knobs' shared defaults
    obs_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    os.environ["OTPU_FLIGHT_DIR"] = os.path.join(obs_dir, "flight")
    os.environ["OTPU_PROF_DIR"] = os.path.join(obs_dir, "prof")
    try:
        return _run(args)
    finally:
        shutil.rmtree(obs_dir, ignore_errors=True)


def _run(args) -> int:
    import torch

    phase = "env"
    try:
        from orange3_spark_tpu_torch import TorchSession, TorchTable
        from orange3_spark_tpu_torch.datasets import higgs_domain, make_higgs_proxy
        from orange3_spark_tpu_torch.models.gbt import GBTClassifier
        from orange3_spark_tpu_torch.models.random_forest import RandomForestClassifier
        from orange3_spark_tpu_torch.ops import histogram as th
        from orange3_spark_tpu_torch.ops import prng

        sess = TorchSession()
        dev = sess.device
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        form, mem_bw, fp32_peak = card_rates(kind)
        emit({"phase": "env", "python": sys.version.split()[0],
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "device": kind, "nvidia_smi": smi, "form_factor": form,
              "mem_bw_Bps": mem_bw, "fp32_peak_flops": fp32_peak,
              "sms": torch.cuda.get_device_properties(0).multi_processor_count})

        phase = "build"
        emit({"phase": phase, **phase_build()})

        train_rows = args.rows - min(HOLDOUT, args.rows // 4)
        phase = "check"
        check, max_err = phase_check(train_rows, dev)
        emit({"phase": phase, **check})

        phase = "timing"
        shapes, estimate = phase_timing(train_rows, dev, mem_bw, fp32_peak)
        emit({"phase": phase, "device": kind, "nvidia_smi": smi,
              "per_fit_estimate": estimate, **shapes})

        phase = "parity"
        emit({"phase": phase, **phase_parity()})

        phase = "data"
        t0 = time.perf_counter()
        X, y = make_higgs_proxy(args.rows, seed=0)
        holdout = min(HOLDOUT, args.rows // 4)
        table = TorchTable.from_numpy(higgs_domain(), X[:-holdout], y[:-holdout], session=sess)
        eval_table = TorchTable.from_numpy(higgs_domain(), X[-holdout:], y[-holdout:],
                                           session=sess)
        y_eval = y[-holdout:]
        higgs = (X, y)      # the supervised phase's table, made once
        del X, y
        emit({"phase": phase, "rows": args.rows, "train_rows": table.n_rows,
              "holdout_rows": eval_table.n_rows, "features": table.n_attrs,
              "seconds": time.perf_counter() - t0})

        # ---- the main path: every launch count starts at 0 here
        th.node_histograms.launches = 0
        prng.threefry_bits.launches = prng.poisson_knuth.launches = 0
        # (name, estimator of the config, AUC floor, launches per fit)
        # launches a fit: one a level, plus the importances and the leaf sums
        # of each grow (the fixed-point sums of models/_tree._bucket_sums):
        # GBT 20 rounds x (5 + 2), the forest's one grow 5 + 2
        fits = [("gbt", GBTClassifier(max_iter=20, max_depth=5, max_bins=32),
                 GBT_AUC_FLOOR, 140),
                ("rf", RandomForestClassifier(num_trees=20, max_depth=5, max_bins=32),
                 RF_AUC_FLOOR, 7)]
        fit_launches, fit_walls = {}, {}
        for phase, est, floor, per_fit in fits:
            line = phase_fit(phase, est, table, eval_table, y_eval, floor)
            fit_walls[phase] = line["fit_s"]
            emit({"phase": phase, **line})
            if line["hist_launches"] != per_fit:
                raise AssertionError(f"{phase} fit launched the histogram kernel "
                                     f"{line['hist_launches']} times, not {per_fit}")
            fit_launches[phase] = line["hist_launches"]
        main_launches = th.node_histograms.launches
        main_draws = {"threefry_bits": prng.threefry_bits.launches,
                      "poisson_knuth": prng.poisson_knuth.launches}
        # ----
        phase = "rf_draws"
        emit({"phase": phase, "rf_fit_s": fit_walls["rf"], **_rf_draw_line(fits[1][1], table)})
        phase = "profile"
        profiles = {name: phase_profile(est, table) for name, est, _, _ in fits}
        emit({"phase": phase, **profiles})
        # the histogram in each fit: the timed fit's launches, and the device
        # time of the profiled fit (the same estimator on the same table)
        per_fit = {name: {"launches": fit_launches[name],
                          **{k: profiles[name].get(k, "not measured") for k in
                             ("hist_kernel_launches", "hist_kernel_ms",
                              "hist_torch_ops_ms", "hist_ms")}}
                   for name in fit_launches}
        del table, eval_table
        torch.cuda.empty_cache()

        # ---- JAX's stream on the card: threefry_bits and poisson_knuth
        phase = "prng"
        prng_line = phase_prng(mem_bw, int32_rate())
        emit({"phase": phase, "device": kind, "nvidia_smi": smi, **prng_line})
        torch.cuda.empty_cache()

        # ---- the dense linear family (no kernel of the package: PyTorch ops)
        phase = "linear_check"
        emit({"phase": phase, "device": kind, **phase_linear_check(sess)})
        phase = "iris"
        emit({"phase": phase, "device": kind, "nvidia_smi": smi, **phase_iris(sess)})
        phase = "dense_logreg"
        emit({"phase": phase, "device": kind, "nvidia_smi": smi,
              **phase_dense_logreg(sess, mem_bw)})
        torch.cuda.empty_cache()

        # ---- the taxi feature pipeline (config 5; no kernel of the package)
        phase = "taxi_check"
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              **phase_taxi_check(sess)})
        phase = "taxi_pipeline"
        from orange3_spark_tpu_torch.datasets import make_taxi_proxy

        t0 = time.perf_counter()
        taxi_X = make_taxi_proxy(args.taxi_rows)
        taxi_gen_s = time.perf_counter() - t0
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              "generate_s": taxi_gen_s, **phase_taxi_pipeline(sess, taxi_X)})
        del taxi_X
        torch.cuda.empty_cache()

        # ---- ALS (config 4): the normal equations' kernel
        phase = "als_check"
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              **phase_als_check(sess)})
        phase = "movielens_als"
        from orange3_spark_tpu_torch.datasets import make_movielens_proxy

        t0 = time.perf_counter()
        ml_ratings = make_movielens_proxy(MOVIELENS_RATINGS)
        ml_gen_s = time.perf_counter() - t0
        als_line = phase_movielens_als(sess, mem_bw, fp32_peak, ml_ratings, args.seed)
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              "generate_s": ml_gen_s, **als_line})
        del ml_ratings
        torch.cuda.empty_cache()

        # ---- the Criteo path (no kernel of the package: PyTorch ops)
        from orange3_spark_tpu_torch.io.native import tune_malloc

        tune_malloc()   # keep parse buffers resident, as bench.py's process does
        tmp = tempfile.mkdtemp(prefix="chip_smoke_criteo_")
        try:
            phase = "criteo_check"
            emit({"phase": phase, **phase_criteo_check(tmp)})
            phase = "criteo_data"
            path, line = phase_criteo_data(tmp, args.criteo_rows)
            emit({"phase": phase, **line})
            phase = "criteo"
            model, line = phase_criteo(path, args.criteo_rows, args.criteo_epochs, sess)
            emit({"phase": phase, "device": kind, "nvidia_smi": smi, **line})
            criteo_line = line
            phase = "criteo_profile"
            emit({"phase": phase, "device": kind, **phase_criteo_profile(model, sess)})
            torch.cuda.empty_cache()
            phase = "segment_sum"
            seg_line = phase_segment_sum(_step_segment_inputs(model, sess), mem_bw)
            emit({"phase": phase, "device": kind, "nvidia_smi": smi, **seg_line})
            torch.cuda.empty_cache()
            phase = "segment_update"
            from orange3_spark_tpu_torch.models.hashed_linear import hashed_salts

            upd_line = phase_segment_update(_step_update_inputs(model, sess), mem_bw,
                                            hashed_salts(model.params))
            emit({"phase": phase, "device": kind, "nvidia_smi": smi, **upd_line})
            torch.cuda.empty_cache()
            phase = "criteo_resume"
            resume_line, clean_theta = phase_criteo_resume(
                tmp, path, args.criteo_rows, args.resume_epochs, sess)
            emit({"phase": phase, "device": kind, "nvidia_smi": smi, **resume_line})
            phase = "criteo_fault"
            emit({"phase": phase, "device": kind, "nvidia_smi": smi,
                  **phase_criteo_fault(path, args.criteo_rows, args.resume_epochs, sess,
                                       clean_theta)})
            del clean_theta
            torch.cuda.empty_cache()
            phase = "serving_check"
            emit({"phase": phase, "device": kind, **phase_serving_check(path, sess)})
            phase = "serving"
            serve_model, pool, line = phase_serving(path, sess, model)
            emit({"phase": phase, "device": kind, "nvidia_smi": smi, **line})
            del model
            phase = "serving_profile"
            emit({"phase": phase, "device": kind, "nvidia_smi": smi,
                  **phase_serving_profile(serve_model, pool)})
            del serve_model, pool
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

        # ---- the dense streaming fit (PyTorch ops) and the value-weighted
        # hashed fit (segment_update_sorted given the pairs' values)
        phase = "fault"
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              **phase_fault(sess)})
        phase = "streaming_linear"
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              **phase_streaming_linear(sess)})
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_libsvm_")
        try:
            phase = "libsvm_hashed"
            libsvm_line = phase_libsvm_hashed(sess, tmp, mem_bw)
            emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
                  **libsvm_line})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

        # ---- bench's overload config: admission, breaker, brownout, the
        # flight recorder, the telemetry endpoint (segment_sum_sorted in
        # the CTR model's adam fit)
        phase = "overload"
        overload_line = phase_overload(sess, kind, nvidia_smi_line())
        emit({"phase": phase, **overload_line})
        torch.cuda.empty_cache()

        # ---- bench's fleet, tenancy and online configs: replica processes
        # on the card behind the router, the autoscaler, the online loop
        # (its trainer's steps through segment_sum_sorted under adam and
        # segment_update_sorted under sparse_adagrad)
        phase = "fleet"
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              **phase_fleet(sess)})
        torch.cuda.empty_cache()
        phase = "tenancy"
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              **phase_tenancy(sess)})
        torch.cuda.empty_cache()
        phase = "online"
        online_line = phase_online(sess)
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(), **online_line})
        torch.cuda.empty_cache()

        # ---- data wrangling (ops/relational, ops/window, the readers; the
        # grouped passes through segment_sum_sorted) and the canvas's entry
        # point (workflow/ows)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_wrangle_")
        try:
            phase = "wrangle"
            before = prng.threefry_bits.launches
            wrangle_line = phase_wrangle(sess, mem_bw, tmp)
            wrangle_draws = prng.threefry_bits.launches - before
            emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
                  **wrangle_line})
            torch.cuda.empty_cache()
            phase = "ows"
            emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
                  **phase_ows(tmp)})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

        # ---- MLlib's supervised estimators at full width (PyTorch ops; the
        # seeded draws through threefry_bits)
        phase = "supervised"
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(),
              **phase_supervised(sess, higgs, nvidia_smi_line())})
        torch.cuda.empty_cache()

        # ---- MLlib's unsupervised, text, pattern and statistics modules
        # (segment_sum_sorted's grouped passes; Word2Vec's negatives on
        # categorical_gumbel)
        phase = "unsupervised"
        unsup_line = phase_unsupervised(sess, higgs, mem_bw, int32_rate())
        emit({"phase": phase, "device": kind, "nvidia_smi": nvidia_smi_line(), **unsup_line})
        del higgs
        torch.cuda.empty_cache()

        phase = "kernels"
        if main_launches == 0:
            raise AssertionError("the main path never launched node_histograms")
        if criteo_line["segment_update_launches"] == 0:
            raise AssertionError("the Criteo fit never launched segment_update_sorted")
        if criteo_line["segment_sum_launches"] == 0:
            raise AssertionError("the adam arm never launched segment_sum_sorted")
        if als_line["kernel_launches"] == 0:
            raise AssertionError("the ALS fit never launched normal_equations_sorted")
        if libsvm_line["segment_update_sorted_launches"] == 0:
            raise AssertionError("the value-weighted fit never launched segment_update_sorted")
        if overload_line["segment_sum_launches"] == 0:
            raise AssertionError("the overload phase's fit never launched segment_sum_sorted")
        if online_line["sparse_trainer_segment_update_launches"] == 0:
            raise AssertionError("the online phase's sparse_adagrad trainer never launched "
                                 "segment_update_sorted")
        if online_line["launches"]["segment_sum_sorted"] == 0:
            raise AssertionError("the online phase never launched segment_sum_sorted")
        if wrangle_line["segment_sum_launches"] == 0:
            raise AssertionError("the wrangle phase never launched segment_sum_sorted")
        for name, n in main_draws.items():
            if n == 0:
                raise AssertionError(f"the main path's forest fit never launched {name}")
        cg = unsup_line["categorical_gumbel"]
        if cg["launches"] == 0:
            raise AssertionError("the Word2Vec fit never launched categorical_gumbel")
        if unsup_line["segment_sum_launches"] == 0:
            raise AssertionError("the unsupervised phase never launched segment_sum_sorted")
        pk, tb = prng_line["poisson_knuth"], prng_line["threefry_bits"]
        gbk = wrangle_line["kernel"]
        ne = als_line["kernel"]["user"]
        vw_upd = libsvm_line["segment_update"]
        zipf = upd_line["criteo_zipf"]
        tail_keys = ("ms", "chain_ms", "plain_ms", "bound_ms", "bound_by", "sector_bound_ms")
        long_keys = ("long_segments", "long_occurrences", "longest_segment")
        top = shapes["gbt_level4_u8"]
        emit({"kernels": [{
            "name": "node_histograms",
            "route": "cuda",
            "source": "orange3_spark_tpu_torch/ops/csrc/histogram.cu",
            "replaces": "orange3_spark_tpu/ops/histogram.py:91",
            "launches": main_launches,
            "max_abs_err": max_err,
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "at": "gbt_level4_u8",
            "per_fit": per_fit,
            "shapes": shapes,
        }, {
            "name": "segment_sum_sorted",
            "route": "cuda",
            "source": "orange3_spark_tpu_torch/ops/csrc/segment_sum.cu",
            # no Pallas kernel: the XLA segment sum of the touched-row update
            "replaces": "orange3_spark_tpu/optim/sparse.py:435",
            "launches": criteo_line["segment_sum_launches"],
            "launches_counted_over": "the criteo phase's adam arm (pure_step_ms_dense)",
            "overload_fit_launches": overload_line["segment_sum_launches"],
            "online_launches": online_line["launches"]["segment_sum_sorted"],
            "online_launches_counted_over": "the online phase (its fits and the adam "
                                            "trainers' steps)",
            "max_abs_err": seg_line["max_abs_err"],
            "deterministic": seg_line["deterministic"],
            "ms": seg_line["ms"], "plain_ms": seg_line["plain_ms"],
            "bound_ms": seg_line["bound_ms"], "bound_by": seg_line["bound_by"],
            "library_ms": seg_line["library_ms"],
            "timed": "ms, plain_ms and library_ms from captured launches; eager_ms beside",
            "eager_ms": seg_line["eager_ms"],
            "deterministic_index_add": seg_line["deterministic_index_add"],
            "at": "the dense table gradient of one adam step on the fit's first cached chunk",
            "round_to_bf16": seg_line["round_to_bf16"],
            "criteo_zipf": {**{k: zipf["segment_sum"][k]
                               for k in ("ms", "bf16_ms", "bound_ms", "bound_by", "bytes")},
                            "long_segments": zipf["long_segments"],
                            "at": "the dense table gradient's inputs on the criteo_zipf keys"},
            "group_by": {**{k: gbk[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "bytes", "max_abs_err", "M", "k",
                                                 "n_slots", "long_segments",
                                                 "longest_segment", "timed")},
                         "launches": wrangle_line["segment_sum_launches"],
                         "launches_counted_over": "the wrangle phase's calls on the card",
                         "bitwise_kernel_order": gbk["long_order_equal"],
                         "at": "group_by(PULocationID)'s grouped pass on the 10M-row TLC "
                               "table: [W, W*fare, W*tip, W*total] in slot order"},
        }, {
            "name": "segment_update_sorted",
            "route": "cuda",
            "source": "orange3_spark_tpu_torch/ops/csrc/segment_sum.cu",
            # no Pallas kernel: the XLA 'sort' lowering after its sort
            "replaces": "orange3_spark_tpu/optim/sparse.py:477-511",
            "launches": criteo_line["segment_update_launches"],
            "launches_counted_over": "the criteo phase's timed fit",
            # bench's online loop trains with adam (segment_sum_sorted); this
            # kernel runs in the incremental trainer only under the sparse rules
            "online_twin_trainer_launches": online_line["sparse_trainer_segment_update_launches"],
            "online_twin_trainer_launches_counted_over": (
                "the online phase's incremental trainer steps on the card for a "
                "sparse_adagrad twin of bench's online model, not bench's adam loop"),
            "online_trainer": {k: online_line["card_vs_cpu"]["sparse_adagrad"][k]
                               for k in ("steps", "theta_max_abs_err", "tolerance", "ok")},
            "max_abs_err": upd_line["max_abs_err"],
            "deterministic": upd_line["bitwise_repeat"],
            "ms": upd_line["ms"], "plain_ms": upd_line["plain_ms"],
            "bound_ms": upd_line["bound_ms"], "bound_by": upd_line["bound_by"],
            "library_ms": upd_line["library_ms"],
            "chain_ms": upd_line["chain_ms"],
            "timed": "ms, plain_ms and chain_ms from captured launches; eager_ms beside",
            "eager_ms": upd_line["eager_ms"],
            "at": "one sparse_adagrad step of the criteo fit on its first cached chunk",
            "with_values": {
                "ms": vw_upd["ms"], "chain_ms": vw_upd["chain_ms"],
                "plain_ms": vw_upd["plain_ms"], "bound_ms": vw_upd["bound_ms"],
                "bound_by": "bytes", "bytes": vw_upd["bytes"], "x_bound": vw_upd["x_bound"],
                "sector_bound_ms": vw_upd["sector_bound_ms"],
                "bitwise_chain": vw_upd["equal_chain"],
                "plain_mismatches": vw_upd["plain_mismatches"],
                "long_err_over_bound": vw_upd["sum_probe"]["long_err_over_bound"],
                "launches": libsvm_line["segment_update_sorted_launches"],
                "launches_counted_over": "the libsvm_hashed phase's value-weighted fit",
                "timed": "captured launches (5 in a graph)",
                "at": (f"one sparse_adagrad step of the libsvm_hashed fit on its first "
                       f"cached chunk: M {vw_upd['M']}, {vw_upd['dead_pairs']} dead pads, "
                       f"longest segment {vw_upd['longest_segment']}"),
                "criteo_shape": {
                    "ms": upd_line["vals"]["ms"], "bound_ms": upd_line["vals"]["bound_ms"],
                    "plain_ms": upd_line["vals"]["plain_ms"],
                    "bytes": upd_line["vals"]["bytes"], "x_bound": upd_line["vals"]["x_bound"],
                    "bitwise_chain": (upd_line["vals"]["step"]["equal_chain"]
                                      and upd_line["vals"]["long_segment"]["equal_chain"]),
                    "plain_mismatches": upd_line["vals"]["step"]["plain_mismatches"],
                    "at": "the criteo step's inputs with per-pair values drawn from a "
                          "seed, a seventh zero"}},
            # the segments of more than walk_max() occurrences, spread over the card
            "long_tail": {
                "criteo_zipf": {**{k: zipf[k] for k in tail_keys + long_keys},
                                "bitwise_chain": zipf["equal_chain"],
                                "at": "the criteo step's state on Zipf(1.2) codes, hashed"},
                "criteo_zipf_values": {**{k: zipf["values"][k] for k in tail_keys},
                                       **{k: zipf[k] for k in long_keys},
                                       "bitwise_chain": zipf["values"]["equal_chain"],
                                       "at": "the same with per-pair values from a seed"},
                "value_weighted_step": {**{k: vw_upd[k] for k in tail_keys + long_keys},
                                        "bitwise_chain": vw_upd["equal_chain"],
                                        "at": "one step of the libsvm_hashed fit"},
                "timed": "captured launches (criteo_zipf 20 in a graph, the step 5)"},
        }, {
            "name": "normal_equations_sorted",
            "route": "cuda",
            "source": "orange3_spark_tpu_torch/ops/csrc/normal_equations.cu",
            # no Pallas kernel: the XLA segment sums of _solve_side
            "replaces": "orange3_spark_tpu/models/als.py:112-130",
            "launches": als_line["kernel_launches"],
            "launches_counted_over": "the movielens_als phase's timed fit",
            "max_abs_err": ne["max_abs_err"],
            "tolerance": ("per output 2g/(1-g) x the plain version's sum of |terms|, "
                          "g = n*2^-24/(1 - n*2^-24), n the entity's ratings; both sides"),
            "max_err_over_tolerance": max(als_line["kernel"][s]["max_err_over_tolerance"]
                                          for s in ("user", "item", "item_skewed")),
            "deterministic": all(als_line["kernel"][s]["deterministic"]
                                 for s in ("user", "item", "item_skewed")),
            "ms": ne["ms"], "plain_ms": ne["plain_ms"],
            "bound_ms": ne["bound_ms"], "bound_by": ne["bound_by"],
            "issue_bound_ms": ne["issue_bound_ms"], "bytes": ne["bytes"],
            "bytes_per_rating": ne["bytes_per_rating"], "blocks_per_sm": ne["blocks_per_sm"],
            "library_ms": ne["library_ms"],
            "library": "outer products per 2^18-rating chunk, materialised, + index_add_",
            **{f"{side}_side": {k: als_line["kernel"][side][k]
                                for k in ("ms", "bound_ms", "bound_by", "issue_bound_ms",
                                          "bytes", "entities", "longest_segment",
                                          "cut_segments", "pieces", "max_abs_err",
                                          "max_err_over_tolerance", "plain_ms",
                                          "library_ms")}
               for side in ("item", "item_skewed")},
            "timed": "CUDA events over 10 launches (plain and library: 2), eager",
            "at": (f"the user half-step of the timed fit: {als_line['train_ratings']} "
                   f"ratings, {als_line['users']} users, rank {als_line['rank']}"),
        }, {
            "name": "threefry_bits",
            "route": "cuda",
            "source": "orange3_spark_tpu_torch/ops/csrc/prng.cu",
            # no Pallas kernel: XLA fuses jax.random's threefry rounds
            "replaces": "none",
            "launches": main_draws["threefry_bits"],
            "launches_counted_over": "the gbt and rf phases (the forest's Bernoulli masks)",
            "wrangle_launches": wrangle_draws,
            "max_abs_err": 0, "bitwise_plain": tb["forest_rows"]["bitwise_plain"],
            **{k: tb["forest_rows"][k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "bytes", "int_ops")},
            "library_ms": None, "library": "no PyTorch call computes JAX's stream",
            "timed": "captured (20 launches in a graph); the plain version 3 in a graph",
            "at": f"{tb['forest_rows']['n']} words under one key (a tree's row count)",
            "uniform_10M": tb["uniform_10M"],
        }, {
            "name": "poisson_knuth",
            "route": "cuda",
            "source": "orange3_spark_tpu_torch/ops/csrc/prng.cu",
            # no Pallas kernel: jax.random.poisson's Knuth while_loop in XLA
            "replaces": "none",
            "launches": main_draws["poisson_knuth"],
            "launches_counted_over": "the gbt and rf phases (the forest's bootstrap)",
            "max_abs_err": 0, "bitwise_plain": pk["bitwise_plain"],
            **{k: pk[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                                  "x_bound", "work_instructions_per_iteration",
                                  "work_instructions_per_row", "instructions_per_iteration",
                                  "issue_ops", "hash_bound_ms", "x_hash_bound", "int_ops",
                                  "bytes", "useful_share", "hashes", "max_count",
                                  "chain_table", "lanes_past_table")},
            "bound": "the instructions the function needs an iteration and a row "
                     "(probes/knuth_work.cu's SASS) at the issue rate; hash_bound_ms: 73 "
                     "integer operations a hash; instructions_per_iteration: a pass of "
                     "the kernel's own loop",
            "library_ms": None, "library": "no PyTorch call computes JAX's stream",
            "timed": "the launch captured (10 in a graph, its table uploaded once); "
                     "eager_ms the wrapper; plain_ms one plain run (a host read an iteration)",
            "at": f"the forest's draw: {pk['trees']} trees x {pk['rows']} rows, lam 1",
            "gbt_round": {k: prng_line["poisson_knuth_gbt_round"][k]
                          for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "x_bound",
                                    "hash_bound_ms", "x_hash_bound", "useful_share",
                                    "bitwise_plain", "tile_rows")},
        }, {
            "name": "categorical_gumbel",
            "route": "cuda",
            "source": "orange3_spark_tpu_torch/ops/csrc/prng.cu",
            # no Pallas kernel: XLA fuses jax.random.categorical's gumbel and argmax
            "replaces": "none",
            "launches": cg["launches"],
            "launches_counted_over": "the unsupervised phase's timed Word2Vec fit",
            "max_abs_err": cg["max_abs_err"], "bitwise_plain": cg["bitwise_plain"],
            **{k: cg[k] for k in ("ms", "prefix_ms", "plain_ms", "plain_at", "bound_ms",
                                  "bound_by", "bytes", "int_ops", "x_bound",
                                  "full_evaluation_bound_ms", "x_full_evaluation_bound",
                                  "evaluated_share", "instructions_per_element_floor",
                                  "instructions_per_element_full_evaluation", "rows", "V",
                                  "elements", "checked_windows")},
            "bound": "the function's floor: the instructions every element needs (the "
                     "hash, the uniform's bits, the logit's read; probes/"
                     "categorical_work.cu's categorical_floor in SASS) x the draw's "
                     "elements at the issue rate; full_evaluation_bound_ms: every element "
                     "also through both logs (its categorical_work)",
            "library_ms": None, "library": "no PyTorch call computes JAX's stream",
            "timed": "CUDA events: ms 5 launches at the fit's draw, prefix_ms 5 at the "
                     "first checked rows, each after a warm-up; plain_ms one plain run "
                     "of the first checked rows",
            "at": f"Word2Vec's negatives: {cg['rows']} rows (2^16 pairs x 5) over "
                  f"{cg['V']} words",
        }]})
        print(nvidia_smi_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception as e:  # noqa: BLE001 - report the failing phase, then fail
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1


if __name__ == "__main__":
    sys.exit(main())
