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

then the Criteo path (BASELINE config 2, ``bench.py --config criteo`` on an
accelerator), which runs PyTorch ops and no kernel of the package:

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
                  holdout AUC (floor 0.73)
  criteo_profile  eager steps under torch.profiler: device time by kernel,
                  ATen op and stage, the idle share, launches and
                  ``nonzero`` calls per step; then the captured replay:
                  device busy time, idle share and launches per epoch

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

then the ``kernels`` line (launches counted over the gbt and rf phases;
``per_fit`` from the timed fits' launch counts and the profile),
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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
        # launches per fit: GBT one tree per round, 20 rounds; the forest once
        rounds = 20 if fit == "gbt" else 1
        estimate[fit] = {"launches": rounds * DEPTH, "hist_ms": rounds * fit_ms,
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
    t0 = time.perf_counter()
    model = est.fit_stream(source, session=sess, cache_device=True, cache_device_bytes=budget,
                           holdout_chunks=holdout_chunks, stage_times=st)
    sess.synchronize()
    fit_s = time.perf_counter() - t0
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
    dense_ms = _step_ms(est.params.replace(optim_update="adam"), model.theta, chunks, sess, 6)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=11_000_000,
                    help="HIGGS-proxy rows (the config's 11M by default)")
    ap.add_argument("--criteo-rows", type=int, default=CRITEO_ROWS,
                    help="Criteo CSV rows (bench.py's 8M by default)")
    ap.add_argument("--criteo-epochs", type=int, default=CRITEO_EPOCHS,
                    help="Criteo fit epochs (bench.py's 100 by default)")
    args = ap.parse_args(argv)

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
        fits = [("gbt", GBTClassifier(max_iter=20, max_depth=5, max_bins=32),
                 GBT_AUC_FLOOR, 100),
                ("rf", RandomForestClassifier(num_trees=20, max_depth=5, max_bins=32),
                 RF_AUC_FLOOR, 5)]
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
            phase = "criteo_profile"
            emit({"phase": phase, "device": kind, **phase_criteo_profile(model, sess)})
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
