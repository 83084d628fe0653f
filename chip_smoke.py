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
           table (same random draws for the forest)
  gbt, rf  the HIGGS proxy (BASELINE config 3) at full width:
           GBTClassifier(max_iter=20) and RandomForestClassifier(
           num_trees=20), max_depth=5, max_bins=32, 28 features, 11M rows
           with a 262,144-row holdout: a warm-up fit and a timed fit,
           holdout AUC, histogram launches of the timed fit
  profile  one more fit of each under torch.profiler: device time by
           kernel, the device's idle share of the fit, and the histogram's
           device time in the fit: its kernel and finalize pass, and the
           PyTorch ops under the wrapper's ``node_histograms`` profiler range

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
                  the CPU from the same inputs (``NE_CASES``: ranks 1, 16
                  and 48, a 100,000-rating segment, empty entities, a tenth
                  of the weights zero, several reference chunks, implicit
                  weights): the sort equal, A, b and cnt bitwise, two
                  launches bitwise; ``ALS(rank=16, max_iter=5)`` on 200,000
                  ratings fitted on the card and on the CPU from the same
                  initial factors (within ``ALS_FIT_ATOL``), two card fits
                  bitwise; top-10 from the same factors on both (ids equal
                  but for ties); every ranking and multilabel metric of the
                  same id matrices on both within 1e-6
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
                  inputs, each side: held to the plain version on the card
                  within float32 summation's bound (``_ne_tolerance``), two
                  launches bitwise, its time beside its bound, the plain
                  version and the yardstick (materialised outer products +
                  ``index_add_``)

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
                  over the timed fit, the segment sum's over the adam arm
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
                  one 2^20-row segment; the kernel's, the chain's and the
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

then the ``kernels`` line of four kernels (``node_histograms``: launches
counted over the gbt and rf phases, ``per_fit`` from the timed fits' launch
counts and the profile; ``segment_sum_sorted``: launches counted over the
``criteo`` phase's adam arm, the times of the ``segment_sum`` phase;
``segment_update_sorted``: launches counted over the ``criteo`` phase's
timed fit, the times of the ``segment_update`` phase, the chain's time as
its yardstick; ``normal_equations_sorted``: launches counted over the
``movielens_als`` phase's timed fit, the times of its user half-step; each
fails the run if it counted no launch),
the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
``ok`` line, as does a machine without CUDA or a directory without the
package.
"""

from __future__ import annotations

import argparse
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
def sass_atomics(lib_path) -> dict[str, list[str]]:
    """{kernel: its atomic SASS opcodes}, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
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
    return line


def phase_fit(name, est, table, eval_table, y_eval, floor):
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import auc
    from orange3_spark_tpu_torch.ops.histogram import node_histograms

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est.fit(table)                               # warm-up: first-use costs
    warm_s = time.perf_counter() - t0
    before = node_histograms.launches
    t0 = time.perf_counter()
    model = est.fit(table)
    table.session.synchronize()
    fit_s = time.perf_counter() - t0
    launches = node_histograms.launches - before
    proba = model.predict_proba(eval_table)
    if proba.shape != (len(y_eval), 2) or not np.isfinite(proba).all():
        raise AssertionError(f"{name}: bad probabilities, shape {proba.shape}")
    if np.abs(proba.sum(1) - 1).max() > 1e-5:
        raise AssertionError(f"{name}: probabilities do not sum to 1")
    a = auc(proba[:, 1], y_eval)
    line = {"fit_s": fit_s, "warmup_fit_s": warm_s,
            "rows_per_s": table.n_rows / fit_s, "holdout_auc": a,
            "hist_launches": launches,
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30}
    if a < floor:
        raise AssertionError(f"{name}: holdout AUC {a:.4f} below {floor}: {line}")
    return line


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
    plan = build_plan_np(X[:, 1 + p.n_dense:], salts, p.n_dims, 4000, impute_missing=True)
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
    return model, line


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
    replay.run(1)
    sess.synchronize()
    epoch_ms = cuda_ms(lambda: replay.run(1), epochs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay.run(epochs)
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
    them), with the hyper-parameters and ``use_decay``."""
    from orange3_spark_tpu_torch.optim import sparse

    def snapshot(args):
        kind, s_idx, order, C, dl, emb, slots, t, step, *rest = args
        return (kind, s_idx, order, C, dl, emb.clone(), {n: v.clone() for n, v in
                                                         slots.items()},
                t.clone(), step.clone(), *rest)

    args, kws = _record_call(sparse, "segment_update_sorted", model, sess,
                             model.params.optim_update, snapshot)
    return args, kws["use_decay"]


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
    (summed by a block) within 1e-6·Σ|g| of the float64 sum. Times of the
    kernel, the plain version, the library call (``index_add_`` alone)
    and ``index_add_`` under deterministic mode, beside the bound."""
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

    # one long segment between short ones, summed by a block
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
            "tolerance": "max_abs_err against the card's atomic index_add_ is float32 "
                         "rounding of its run-dependent order; bitwise against the CPU's "
                         "index order on segments of at most walk_max() rows"}
    if not (deterministic and graph_equal and cpu_mismatch == 0 and long_ok
            and long_repeat):
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


def _plain_update(args, use_decay, segment_sum):
    """The plain version of the update on fresh copies of ``args``' state,
    its segment sums by ``segment_sum``: ``segment_sum_sorted`` gives the
    chain the kernel replaced, ``_cpu_sums`` sums independent of the
    kernels' device code (the rule as torch ops on the card, whose library
    functions the kernel calls)."""
    from orange3_spark_tpu_torch.ops.segment_sum import segment_update_sorted_reference

    out = _update_copy(args)
    segment_update_sorted_reference(*out, use_decay=use_decay, segment_sum=segment_sum)
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


def _probe_check(kernel, args, use_decay, long_rows) -> dict:
    """The kernel's sums through ``_sum_probe`` against the plain version's
    with the CPU's sums: bitwise on every row of a segment of at most
    ``walk_max()`` occurrences and on ``t``; on the other rows |Δsum| within
    1e-6·Σ|g| of the segment. Also whether that comparison fails a plain
    version with one occurrence dropped and one with it doubled (the
    occurrence of largest |g| in a short segment): the check's power."""
    import torch

    probe = _sum_probe(args)
    got = kernel(_update_copy(probe))
    want = _plain_update(probe, use_decay, _cpu_sums)
    line = {"mismatches": _plain_mismatches(got, want, long_rows), "long_rel_err": None}
    _, s_idx, order, C, dl, emb, *_ = probe
    D = emb.shape[0]
    if bool(long_rows.any()):
        abs_sum = -_plain_update(probe[:4] + (dl.abs(),) + probe[5:], use_decay, _cpu_sums)[5]
        err = (got[5] - want[5]).abs()[long_rows]
        line["long_rel_err"] = float((err / abs_sum[long_rows]).max())
    g = dl.index_select(0, order // C).abs().sum(1)
    short = (s_idx < D) & ~long_rows[s_idx.clamp(max=D - 1).long()]
    i = int(torch.where(short, g, -1.0).argmax())
    mutated_order = order.clone()
    mutated_order[i] = dl.shape[0] * C                 # the appended row of dl
    caught = {}
    for name, extra in (("dropped", torch.zeros_like(dl[:1])),
                        ("doubled", 2 * dl[order[i] // C][None])):
        mutated = probe[:2] + (mutated_order, C, torch.cat([dl, extra])) + probe[5:]
        caught[name] = _plain_mismatches(got, _plain_update(mutated, use_decay, _cpu_sums),
                                         long_rows) > 0
    line["mutation_caught"] = caught
    return line


def _update_checks(kernel, chain, args, use_decay, long_rows) -> dict:
    """One case: two launches bitwise equal, equal to the chain bitwise and
    held to the plain version with the CPU's sums (``_plain_mismatches``;
    ``_probe_check`` for the sums themselves)."""
    a, b = kernel(_update_copy(args)), kernel(_update_copy(args))
    return {"bitwise_repeat": _update_state_equal(a, b),
            "equal_chain": _update_state_equal(a, chain(_update_copy(args))),
            "plain_mismatches": _plain_mismatches(a, _plain_update(args, use_decay, _cpu_sums),
                                                  long_rows),
            "sum_probe": _probe_check(kernel, args, use_decay, long_rows)}


def _update_case_ok(line) -> bool:
    probe = line["sum_probe"]
    return (line["bitwise_repeat"] and line["equal_chain"] and line["plain_mismatches"] == 0
            and probe["mismatches"] == 0 and all(probe["mutation_caught"].values())
            and (probe["long_rel_err"] is None or probe["long_rel_err"] <= 1e-6))


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


def phase_segment_update(inputs, mem_bw):
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
    of the kernel, the chain and the plain version, beside the bound."""
    import torch

    from orange3_spark_tpu_torch.ops import segment_sum as ss
    from orange3_spark_tpu_torch.utils.graphs import capture_graph

    args, use_decay = inputs
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
    del long_args

    work = [_update_copy(args) for _ in range(3)]
    timed = (("kernel", lambda: kernel(work[0])), ("chain", lambda: chain(work[1])),
             ("plain", lambda: ss.segment_update_sorted_reference(*work[2],
                                                                  use_decay=use_decay)))
    # device times from captured launches (the fit runs it in a captured
    # graph); beside them the eager calls' times, host included, and the
    # host's own time to issue one call
    ms, chain_ms, plain_ms = (graph_ms(f, 20) for _, f in timed)
    eager_ms = {name: cuda_ms(f, 20, warmup=1) for name, f in timed}
    issue_ms = {name: host_ms(f, 20) for name, f in timed}
    del work
    # each input read once (the keys, the order, dl), each live row's
    # table, slot and t entries read and written once; beside it the
    # 32-byte sectors those rows fall in (what the card moves at least)
    M, dl = s_idx.numel(), args[4]
    rows = s_idx.unique()
    rows = rows[rows < D].long()
    n_state = 1 + len(slots0)
    row_bytes = n_state * k * 4 + (4 if use_decay else 0)
    n_bytes = M * 4 + M * 8 + dl.numel() * 4 + 2 * rows.numel() * row_bytes
    sectors = (n_state * (rows * k * 4 // 32).unique().numel()
               + ((rows * 4 // 32).unique().numel() if use_decay else 0))
    sector_bytes = M * 4 + M * 8 + dl.numel() * 4 + 2 * 32 * sectors
    bound_ms = n_bytes / mem_bw * 1e3
    line = {"M": M, "k": k, "D": D, "rule": args[0], "use_decay": use_decay,
            "live_rows": rows.numel(), "long_rows": int(long_rows.sum()),
            **step_case, "untouched_rows_equal": untouched_equal,
            "graph_equal_eager": graph_equal, "rules": rules, "long_segment": long_line, "max_abs_err": max_abs_err,
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
    if not (untouched_equal and graph_equal
            and all(map(_update_case_ok, (step_case, *rules.values(), long_line)))):
        raise AssertionError(f"segment_update_sorted failed its checks: {line}")
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
# ratings of one heavy entity, implicit)
NE_CASES = [(1, 3000, 3500, 2000, 300_000, 1 << 14, 0, False),
            (16, 3000, 3500, 2000, 300_000, 1 << 14, 100_000, False),
            (16, 3000, 3500, 2000, 200_000, 1 << 16, 0, True),
            (48, 1000, 1200, 700, 100_000, 1 << 14, 0, False)]


def _ne_inputs(k, e_used, E, n_other, M, chunk, heavy, implicit, dev, seed=0):
    """A side's ratings for the normal equations: ``e_used`` of ``E``
    entities rated (the rest empty), a tenth of the weights zero, entity 0
    with ``heavy`` more ratings spread over the whole order; sorted on
    ``dev`` and on the CPU from the same numpy draws. Returns (factors,
    plan on dev, plan on the CPU)."""
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
    plans = [A._side_plan(*(c.to(d) for c in cols), E, n_other, implicit, 1.5)
             for d in (dev, "cpu")]
    return torch.from_numpy(V).to(dev), plans[0], plans[1]


def _ne_case(k, e_used, E, n_other, M, chunk, heavy, implicit, dev):
    """The kernel on ``dev`` against its plain version with the CPU's
    index-order sums, on the same sorted ratings: the sort on the card
    equal to the CPU's, A, b and cnt bitwise, two launches bitwise, the
    empty entities zero; the plain version on the card within float32
    rounding (index_add_'s atomics)."""
    import torch

    from orange3_spark_tpu_torch.ops import normal_equations as NE

    V, plan, cplan = _ne_inputs(k, e_used, E, n_other, M, chunk, heavy, implicit, dev)
    got = NE.normal_equations_sorted(V, *plan, chunk)
    again = NE.normal_equations_sorted(V, *plan, chunk)
    want = NE.normal_equations_sorted_reference(V.cpu(), *cplan, chunk)
    on_dev = NE.normal_equations_sorted_reference(V, *plan, chunk)
    got = [x.cpu() for x in got]
    line = {
        "rank": k, "ratings": M + heavy, "entities": E, "chunk": chunk,
        "heavy_segment": heavy, "implicit": implicit,
        "sort_equal": all(torch.equal(a.cpu(), b) for a, b in zip(plan, cplan)),
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
    on the CPU: rows whose ids differ, and whether every such row is a tie
    (the two lists' float64 scores equal within 1e-5 relative)."""
    import numpy as np

    from orange3_spark_tpu_torch.models.als import ALSModel, ALSParams

    p = ALSParams(rank=U.shape[1])
    on_dev = ALSModel(p, U.to(dev), V.to(dev)).recommend_for_all_users(n)
    on_cpu = ALSModel(p, U.cpu(), V.cpu()).recommend_for_all_users(n)
    diff = np.flatnonzero((on_dev != on_cpu).any(axis=1))
    S = U.cpu().double().numpy()[diff] @ V.cpu().double().numpy().T
    a = np.take_along_axis(S, on_dev[diff].astype(np.int64), 1)
    b = np.take_along_axis(S, on_cpu[diff].astype(np.int64), 1)
    ties = bool(np.all(np.abs(a - b) <= 1e-5 * np.maximum(np.abs(b), 1.0)))
    return on_dev, on_cpu, {"rows": len(on_dev), "rows_differ": int(len(diff)),
                            "differing_rows_are_ties": ties}


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
    plain version with CPU-order sums (NE_CASES: ranks 1, 16, 48, a
    100,000-rating segment, empty entities, zero weights, several chunks,
    implicit weights), a card fit against the CPU fit from the same initial
    factors, two card fits bitwise, recommendations and ranking metrics
    against the CPU's."""
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
    # recommendations and metrics from the CPU fit's factors on both devices
    recs_dev, recs_cpu, agree = _recommend_agreement(m_cpu.user_factors, m_cpu.item_factors,
                                                     10, dev)
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
    if not agree["differing_rows_are_ties"]:
        failed.append("recommendations differ beyond ties")
    if not metric_err <= 1e-6:
        failed.append(f"ranking metrics {metric_err} apart")
    if failed:
        raise AssertionError(f"als_check: {failed}; {json.dumps(line)}")
    return line


def _ne_bound(M, E, k, n_other, mem_bw, fp32_peak):
    """The least time of one half-step's normal equations: each input read
    once (oid, pos i32; aw, bw, cw f32; the offsets; the other side's
    factors), each output written once (A, b, cnt), against the float32
    products and adds the function needs: (V_i V_j)·aw and its add on the
    lower triangle, V_i·bw and its add, the count's add. Beside it, the
    bound of a layout with only the bytes explicit feedback needs, 12 a
    rating (oid with a chunk-change bit in place of pos; aw, which is also
    the count's weight; bw)."""
    fixed = (E + 1) * 8 + n_other * k * 4 + E * (k * k + k + 1) * 4
    bytes_, needed = M * 20 + fixed, M * 12 + fixed
    ops = M * (3 * k * (k + 1) // 2 + 2 * k + 1)
    t_bytes, t_ops = bytes_ / mem_bw * 1e3, ops / fp32_peak * 1e3
    return {"bytes": bytes_, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_12B_layout": needed,
            "bound_ms_12B_layout": max(needed / mem_bw * 1e3, t_ops)}


def _outer_index_add(factors, *plan, chunk):
    """The yardstick: each reference chunk's terms materialised
    (``chunk_terms``) and ``index_add_``ed straight into A, b and cnt
    (float atomics on CUDA)."""
    import torch

    from orange3_spark_tpu_torch.ops.normal_equations import chunk_terms

    k, E = factors.shape[1], plan[-1].shape[0] - 1
    A = torch.zeros((E + 1, k * k), device=factors.device)
    bc = torch.zeros((E + 1, k + 1), device=factors.device)
    for ent, outer, rhs in chunk_terms(factors, *plan, chunk):
        A.index_add_(0, ent, outer)
        bc.index_add_(0, ent, rhs)
    return A, bc


def _ne_tolerance(factors, plan, chunk):
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

    oid, pos, aw, bw, cw, offsets = plan
    S = normal_equations_sorted_reference(factors.abs(), oid, pos, aw.abs(), bw.abs(),
                                          cw.abs(), offsets, chunk)
    n = (offsets[1:] - offsets[:-1]).to(torch.float64) * 2.0 ** -24
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


def phase_movielens_als(sess, mem_bw, fp32_peak, ratings):
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
    # the kernel at the timed fit's own inputs, each side, held to its
    # plain version on the card within float32 summation's bound
    u = table.column("user").to(torch.int32)
    it = table.column("item").to(torch.int32)
    r = table.column("rating")
    chunk = min(est.params.chunk_size, table.n_pad)
    kern = {}
    for side, idx, oth, E, factors in (("user", u, it, MOVIELENS_USERS, model.item_factors),
                                       ("item", it, u, MOVIELENS_ITEMS, model.user_factors)):
        plan = A._side_plan(idx, oth, r, table.W, E, factors.shape[0], False, 1.0)
        def fn():
            return NE.normal_equations_sorted(factors, *plan, chunk)
        got, again = fn(), fn()
        plain = NE.normal_equations_sorted_reference(factors, *plan, chunk)
        tol = _ne_tolerance(factors, plan, chunk)
        err = [(a.double() - b.double()).abs() for a, b in zip(got, plain)]
        kern[side] = {"entities": E, "ms": cuda_ms(fn, 10, warmup=1),
                      "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
                      **_ne_bound(table.n_rows, E, factors.shape[1], factors.shape[0],
                                  mem_bw, fp32_peak),
                      "max_abs_err": max(float(e.max()) for e in err),
                      "within_tolerance": all(bool((e <= t).all()) for e, t in zip(err, tol)),
                      "max_err_over_tolerance": max(float((e / t.clamp_min(1e-300)).max())
                                                    for e, t in zip(err, tol)),
                      "plain_ms": cuda_ms(lambda: NE.normal_equations_sorted_reference(
                          factors, *plan, chunk), 2, 1),
                      "library_ms": cuda_ms(lambda: _outer_index_add(
                          factors, *plan, chunk=chunk), 2, 1)}
        del got, again, plain, tol, err, plan
        torch.cuda.empty_cache()
        if not (kern[side]["within_tolerance"] and kern[side]["deterministic"]):
            raise AssertionError(f"normal_equations_sorted, {side} side at the timed fit's "
                                 f"inputs: {json.dumps(kern[side])}")
    line["kernel"] = kern
    return line


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

    phase = "env"
    try:
        from orange3_spark_tpu_torch import TorchSession, TorchTable
        from orange3_spark_tpu_torch.datasets import higgs_domain, make_higgs_proxy
        from orange3_spark_tpu_torch.models.gbt import GBTClassifier
        from orange3_spark_tpu_torch.models.random_forest import RandomForestClassifier
        from orange3_spark_tpu_torch.ops import histogram as th

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
        del X, y
        emit({"phase": phase, "rows": args.rows, "train_rows": table.n_rows,
              "holdout_rows": eval_table.n_rows, "features": table.n_attrs,
              "seconds": time.perf_counter() - t0})

        # ---- the main path: every launch count starts at 0 here
        th.node_histograms.launches = 0
        # (name, estimator of the config, AUC floor, launches per fit)
        # launches a fit: one a level, plus the importances and the leaf sums
        # of each grow (the fixed-point sums of models/_tree._bucket_sums):
        # GBT 20 rounds x (5 + 2), the forest's one grow 5 + 2
        fits = [("gbt", GBTClassifier(max_iter=20, max_depth=5, max_bins=32),
                 GBT_AUC_FLOOR, 140),
                ("rf", RandomForestClassifier(num_trees=20, max_depth=5, max_bins=32),
                 RF_AUC_FLOOR, 7)]
        fit_launches = {}
        for phase, est, floor, per_fit in fits:
            line = phase_fit(phase, est, table, eval_table, y_eval, floor)
            emit({"phase": phase, **line})
            if line["hist_launches"] != per_fit:
                raise AssertionError(f"{phase} fit launched the histogram kernel "
                                     f"{line['hist_launches']} times, not {per_fit}")
            fit_launches[phase] = line["hist_launches"]
        main_launches = th.node_histograms.launches
        # ----
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
        als_line = phase_movielens_als(sess, mem_bw, fp32_peak, ml_ratings)
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
            upd_line = phase_segment_update(_step_update_inputs(model, sess), mem_bw)
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

        phase = "kernels"
        if main_launches == 0:
            raise AssertionError("the main path never launched node_histograms")
        if criteo_line["segment_update_launches"] == 0:
            raise AssertionError("the Criteo fit never launched segment_update_sorted")
        if criteo_line["segment_sum_launches"] == 0:
            raise AssertionError("the adam arm never launched segment_sum_sorted")
        if als_line["kernel_launches"] == 0:
            raise AssertionError("the ALS fit never launched normal_equations_sorted")
        ne = als_line["kernel"]["user"]
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
            "max_abs_err": seg_line["max_abs_err"],
            "deterministic": seg_line["deterministic"],
            "ms": seg_line["ms"], "plain_ms": seg_line["plain_ms"],
            "bound_ms": seg_line["bound_ms"], "bound_by": seg_line["bound_by"],
            "library_ms": seg_line["library_ms"],
            "timed": "ms, plain_ms and library_ms from captured launches; eager_ms beside",
            "eager_ms": seg_line["eager_ms"],
            "deterministic_index_add": seg_line["deterministic_index_add"],
            "at": "the dense table gradient of one adam step on the fit's first cached chunk",
        }, {
            "name": "segment_update_sorted",
            "route": "cuda",
            "source": "orange3_spark_tpu_torch/ops/csrc/segment_sum.cu",
            # no Pallas kernel: the XLA 'sort' lowering after its sort
            "replaces": "orange3_spark_tpu/optim/sparse.py:477-511",
            "launches": criteo_line["segment_update_launches"],
            "launches_counted_over": "the criteo phase's timed fit",
            "max_abs_err": upd_line["max_abs_err"],
            "deterministic": upd_line["bitwise_repeat"],
            "ms": upd_line["ms"], "plain_ms": upd_line["plain_ms"],
            "bound_ms": upd_line["bound_ms"], "bound_by": upd_line["bound_by"],
            "library_ms": upd_line["library_ms"],
            "chain_ms": upd_line["chain_ms"],
            "timed": "ms, plain_ms and chain_ms from captured launches; eager_ms beside",
            "eager_ms": upd_line["eager_ms"],
            "at": "one sparse_adagrad step of the criteo fit on its first cached chunk",
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
                                          for s in ("user", "item")),
            "deterministic": ne["deterministic"] and als_line["kernel"]["item"]["deterministic"],
            "ms": ne["ms"], "plain_ms": ne["plain_ms"],
            "bound_ms": ne["bound_ms"], "bound_by": ne["bound_by"],
            "library_ms": ne["library_ms"],
            "library": "outer products per 2^18-rating chunk, materialised, + index_add_",
            "bound_ms_12B_layout": ne["bound_ms_12B_layout"],
            "item_side": {k: als_line["kernel"]["item"][k]
                          for k in ("ms", "bound_ms", "bound_by", "bound_ms_12B_layout",
                                    "entities", "max_abs_err", "max_err_over_tolerance",
                                    "plain_ms", "library_ms")},
            "timed": "CUDA events over 10 launches (plain and library: 2), eager",
            "at": (f"the user half-step of the timed fit: {als_line['train_ratings']} "
                   f"ratings, {als_line['users']} users, rank {als_line['rank']}"),
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
