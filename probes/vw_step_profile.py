#!/usr/bin/env python3
"""Where a value-weighted step's time goes on the card: ``chip_smoke.py``'s
``libsvm_hashed`` fit (its libsvm file written by numpy into a temporary
directory, 2^22 dims, sparse_adagrad 'sort', 2^17-row chunks, 3 epochs),
then, on the fit's cached chunks from fresh optimizer state, eager steps
under ``torch.profiler`` (device time by kernel and by ATen op, launches a
step, the idle share) and the captured replay of one epoch timed with CUDA
events; the same for the float32-codec Criteo-shaped step of equal rows
(13 dense + 26 categorical columns) beside it.

    python3 probes/vw_step_profile.py [--rows 524288]

One JSON line a layout. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile_steps(step, state, chunks, n_steps, exclude):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n_steps):
            step(*state, chunks[i % len(chunks)])
        torch.cuda.synchronize()
    events, by_name, busy = cs._device_profile(prof, exclude)
    wall = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    ops = {}
    for e in prof.key_averages():
        if e.key.startswith("aten::") and e.device_time_total > 0:
            ops[e.key] = e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"steps": n_steps, "busy_ms_per_step": busy / 1e3 / n_steps,
            "device_span_ms_per_step": wall / 1e3 / n_steps,
            "launches_per_step": len(events) / n_steps,
            "top_kernels": [{"name": n[:100], "ms_per_step": us / 1e3 / n_steps,
                             "count": c} for n, (us, c) in top],
            "top_ops": sorted(((k, v / n_steps) for k, v in ops.items()),
                              key=lambda kv: -kv[1])[:12]}


def _replay_ms(step, theta, opt, chunks):
    import torch

    from orange3_spark_tpu_torch.models.hashed_linear import _Replay

    replay = _Replay(theta, opt, chunks, step)
    replay.capture()
    replay.run(1)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    replay.run(5)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (5 * len(chunks))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 19)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("vw_step_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.libsvm import libsvm_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import (
        STEP_STAGES, StreamingHashedLinearEstimator, _init_fit_state, _step_into,
    )

    sess = TorchSession()
    cfg = dict(cs.LIBSVM, rows=args.rows, epochs=3)
    idx, dup, v_int, vals, y = cs._libsvm_draw(cfg["rows"], cfg["nnz"], seed=0)
    tmp = tempfile.mkdtemp(prefix="vw_step_profile_")
    try:
        path = os.path.join(tmp, "pairs.svm")
        cs._write_libsvm_file(path, idx, dup, v_int, y)
        common = dict(n_dims=cfg["n_dims"], label_in_chunk=True,
                      optim_update="sparse_adagrad", sparse_lowering="sort",
                      chunk_rows=cfg["chunk_rows"], epochs=cfg["epochs"],
                      step_size=cfg["step_size"], reg_param=cfg["reg_param"])
        layouts = {"value_weighted": (dict(value_weighted=True, n_dense=0, n_cat=cfg["nnz"]),
                                      libsvm_chunk_source(path, nnz_per_row=cfg["nnz"],
                                                          chunk_rows=cfg["chunk_rows"]))}
        # the Criteo-shaped f32 chunk of as many rows: label, 13 dense, 26 codes
        rng = np.random.default_rng(1)
        crit = np.concatenate([y[:, None].astype(np.float32),
                               rng.standard_normal((cfg["rows"], 13)).astype(np.float32),
                               np.where(dup, 0, idx).astype(np.float32)], axis=1)
        layouts["criteo_f32"] = (dict(n_dense=13, n_cat=cfg["nnz"]),
                                 lambda: (c for c in np.array_split(crit, 4)))
        for name, (extra, src) in layouts.items():
            params = dict(common, **extra)
            est = StreamingHashedLinearEstimator(**params)
            model = est.fit_stream(src, session=sess, cache_device=True)
            chunks = model.device_chunks_
            theta, opt, _, salts, kw = _init_fit_state(est.params, sess)
            hyper = tuple(float(np.float32(v)) for v in (params["reg_param"],
                                                          params["step_size"], 0.0))

            def step(th, op, c, salts=salts, kw=kw, hyper=hyper):
                return _step_into(th, op, c, salts, hyper, kw)

            for c in chunks:                      # warm: library handles, workspaces
                step(theta, opt, c)
            line = {"layout": name, "chunks": len(chunks), "rows": cfg["rows"],
                    "eager": _profile_steps(step, (theta, opt), chunks, 2 * len(chunks),
                                            exclude=STEP_STAGES + ("segment_update_sorted",)),
                    "replay_ms_per_step": _replay_ms(step, theta, opt, chunks)}
            cs.emit({"phase": "vw_step_profile", "device": torch.cuda.get_device_name(0),
                     "nvidia_smi": cs.nvidia_smi_line(), **line})
            del model, chunks, theta, opt
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
