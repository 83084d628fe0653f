#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (orange3_spark_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py [--rows 11000000]

It builds the CUDA kernels from ``orange3_spark_tpu_torch/ops/csrc`` (nvcc,
``sm_90a``, into the git-ignored ``orange3_spark_tpu_torch/_build/``), then
prints one JSON line per phase:

  env      torch / CUDA versions, the card's name and power limit
  build    nvcc wall seconds and ptxas' register / shared-memory report
  check    each kernel against its plain PyTorch version on the card: a
           randomized sweep, zero-weight rows, a 20-tree batch, and the
           shapes the HIGGS fit gives it at levels 0 and 4 (bitwise for
           integer stats, within 1e-5·max|H| for float stats)
  timing   kernel, plain version and one-library-call times at the
           level-4 HIGGS shapes, beside the memory-bound least time
  parity   the fits on the card against the port's CPU path on a small
           table (same random draws for the forest)
  gbt, rf  the HIGGS proxy (BASELINE config 3) at full width:
           GBTClassifier(max_iter=20) and RandomForestClassifier(
           num_trees=20), max_depth=5, max_bins=32, 28 features, 11M rows
           with a 262,144-row holdout: a warm-up fit and a timed fit,
           holdout AUC, histogram launches of the timed fit
  profile  one more fit of each under torch.profiler: device time by
           kernel and the device's idle share of the fit

then the ``kernels`` line (launches counted over the gbt and rf phases),
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
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HOLDOUT = 1 << 18
GBT_AUC_FLOOR, RF_AUC_FLOOR = 0.72, 0.82
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
def phase_build():
    from orange3_spark_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    info = cuda_build.build()
    ptxas = {name: re.findall(r"ptxas info\s*: (Used [^\n]*)", v["log"])
             for name, v in info.items()}
    return {"nvcc_s": round(time.perf_counter() - t0, 3),
            "per_source_s": {k: round(v["seconds"], 3) for k, v in info.items()},
            "ptxas": ptxas}


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


def _compare(got, ref, integer):
    """(agrees, max |got - ref|, max |ref|): bitwise for integer stats, else
    within 1e-5·max|ref| (fp32 atomics add in a run-dependent order)."""
    import torch

    err = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    ok = torch.equal(got, ref) if integer else err <= 1e-5 * scale
    return ok, err, scale


def phase_check(train_rows, dev):
    """Kernel vs plain version: bitwise on integer stats, 1e-5·max|H| on
    float stats. Returns (line, max_abs_err)."""
    import random

    import torch

    from orange3_spark_tpu_torch.ops import histogram as th

    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = []
    for seed in range(8):   # randomized shapes, ragged row counts
        r = random.Random(100 + seed)
        nodes, n_bins = r.choice([1, 2, 3, 5, 8, 16]), r.choice([4, 8, 16, 32, 64])
        s, T, d = r.choice([1, 2, 3, 5]), r.choice([1, 3]), r.choice([1, 5, 28, 40])
        cases.append((f"sweep{seed}", r.randint(1, 300_000), d, s, T, nodes,
                      n_bins, False, False))
    cases += [
        ("zero_weight_rows", 200_000, 28, 3, 1, 4, 32, False, True),
        ("forest_T20", 500_000, 28, 2, 20, 8, 32, True, False),
        ("gbt_level0", train_rows, 28, 3, 1, 1, 32, False, False),
        ("gbt_level4", train_rows, 28, 3, 1, 16, 32, False, False),
        ("rf_level0", train_rows, 28, 2, 20, 1, 32, True, False),
        ("rf_level4", train_rows, 28, 2, 20, 16, 32, True, False),
    ]
    results, worst, failed = {}, 0.0, []
    for name, N, d, s, T, nodes, n_bins, integer, zero_tail in cases:
        B, S, pos = _hist_inputs(gen, N, d, s, T, nodes, n_bins, integer, dev)
        if zero_tail:
            S[:, N // 3:] = 0.0
        got = th.node_histograms(B, S, pos, nodes=nodes, n_bins=n_bins)
        ref = th.node_histograms_reference(B, S, pos, nodes=nodes, n_bins=n_bins)
        if zero_tail:   # dead rows add nothing: same as the live rows alone
            n = N // 3
            alone = th.node_histograms_reference(
                B[:n], S[:, :n].contiguous(), pos[:, :n].contiguous(),
                nodes=nodes, n_bins=n_bins)
            ok2, _, _ = _compare(got, alone, False)
        else:
            ok2 = True
        torch.cuda.synchronize()
        ok, err, scale = _compare(got, ref, integer)
        worst = max(worst, err)
        results[name] = {"shape": [T, N, d, s, nodes, n_bins], "bitwise": integer,
                         "max_abs_err": err, "max_abs_H": scale, "ok": ok and ok2}
        if not (ok and ok2):
            failed.append(name)
        del B, S, pos, got, ref
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
    import torch

    from orange3_spark_tpu_torch.ops import histogram as th

    gen = torch.Generator(device=dev).manual_seed(99)
    shapes = {}
    for name, T, s, integer in (("gbt_level4", 1, 3, False), ("rf_level4", 20, 2, True)):
        N, d, nodes, n_bins = train_rows, 28, 16, 32
        B, S, pos = _hist_inputs(gen, N, d, s, T, nodes, n_bins, integer, dev)
        f = lambda: th.node_histograms(B, S, pos, nodes=nodes, n_bins=n_bins)
        p = lambda: th.node_histograms_reference(B, S, pos, nodes=nodes, n_bins=n_bins)
        f(), p()
        torch.cuda.synchronize()
        kernel_ms = cuda_ms(f, 20)
        plain_ms = cuda_ms(p, 2)
        library_ms, library_note = _library_ms(B, S, pos, nodes, n_bins)
        nb = nodes * n_bins
        n_bytes = N * d * 4 + T * N * s * 4 + T * N * 4 + T * d * nb * s * 4
        n_ops = T * N * d * s               # fp32 adds
        bytes_ms, ops_ms = n_bytes / mem_bw * 1e3, n_ops / fp32_peak * 1e3
        shapes[name] = {
            "T": T, "N": N, "d": d, "s": s, "nodes": nodes, "n_bins": n_bins,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_note": library_note, "bytes": n_bytes, "ops": n_ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "achieved_GBps": n_bytes / kernel_ms / 1e6,
        }
        del B, S, pos
        torch.cuda.empty_cache()
    return shapes


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
    """One more fit under torch.profiler: device time by kernel, and the
    device's busy and idle share of the fit's wall time (the profiler's own
    cost is in that wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.fit(table)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"fit_wall_s": wall_us / 1e6,
                "device_time": "not measured: the profiler saw no device events"}
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:          # union of the kernels' time ranges
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"fit_wall_s": wall_us / 1e6, "device_busy_s": busy / 1e6,
            "device_idle_share": 1 - busy / wall_us,
            "device_kernels": len(kernels),
            "top_kernels": [{"name": n[:90], "ms": us / 1e3, "share": us / total}
                            for n, us in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=11_000_000,
                    help="HIGGS-proxy rows (the config's 11M by default)")
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
        shapes = phase_timing(train_rows, dev, mem_bw, fp32_peak)
        emit({"phase": phase, "device": kind, "nvidia_smi": smi, **shapes})

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
        for phase, est, floor, per_fit in fits:
            line = phase_fit(phase, est, table, eval_table, y_eval, floor)
            emit({"phase": phase, **line})
            if line["hist_launches"] != per_fit:
                raise AssertionError(f"{phase} fit launched the histogram kernel "
                                     f"{line['hist_launches']} times, not {per_fit}")
        main_launches = th.node_histograms.launches
        # ----
        phase = "profile"
        emit({"phase": phase, **{name: phase_profile(est, table)
                                 for name, est, _, _ in fits}})
        phase = "kernels"
        if main_launches == 0:
            raise AssertionError("the main path never launched node_histograms")
        top = shapes["gbt_level4"]
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
            "at": "gbt_level4",
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
