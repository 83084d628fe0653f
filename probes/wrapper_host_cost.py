#!/usr/bin/env python3
"""The host's cost of the segment kernels' wrappers, and of the pieces a
call is made of, at the Criteo step's shapes.

    python3 probes/wrapper_host_cost.py [--root DIR] [--reps 200]

A wrapper of ``ops/segment_sum.py`` checks its inputs, allocates its output
and scratch, finds the stream and launches through ctypes. When the kernel
runs for less time than that takes, an eager call costs the host's time,
not the device's. Each entry is the mean host microseconds to issue one
call (``reps`` calls, the device waited for before and after, not between):
the two wrappers, ``index_add_`` into zeros (the segment sum's library
call), and the pieces (an allocation, a ``record_function`` range, the
device properties, a device context, the current stream, a small op).
``--root`` loads ``orange3_spark_tpu_torch`` from another checkout (a
``git archive`` of another commit), to compare two wrappers in one run.
Needs one CUDA device; exits non-zero on a machine without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wrapper_host_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from orange3_spark_tpu_torch.ops import cuda_build
    from orange3_spark_tpu_torch.ops import segment_sum as ss

    cuda_build.build(["segment_sum"])
    dev = torch.device("cuda")
    rows, C, n_dims = 1 << 18, 26, 1 << 22
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, n_dims, (rows * C,), generator=gen, device=dev, dtype=torch.int32)
    s_idx, order = torch.sort(idx, stable=True)
    start = torch.ones_like(s_idx, dtype=torch.bool)
    torch.ne(s_idx[1:], s_idx[:-1], out=start[1:])
    seg = torch.cumsum(start, 0, dtype=torch.int32) - 1
    g = torch.randn((rows * C, 1), generator=gen, device=dev)
    dl = torch.randn((rows, 1), generator=gen, device=dev) * 1e-4
    emb = torch.zeros((n_dims, 1), device=dev)
    acc = torch.zeros((n_dims, 1), device=dev)
    t = torch.zeros(n_dims, dtype=torch.int32, device=dev)
    step = torch.tensor(5, dtype=torch.int32, device=dev)
    decay = float(np.float32(1.0) - np.float32(0.04) * np.float32(1e-5))
    small = torch.zeros(3, dtype=torch.int32, device=dev)

    def record_range():
        with torch.profiler.record_function("probe"):
            pass

    def device_context():
        with torch.cuda.device(dev):
            pass

    calls = {
        "segment_sum_sorted": lambda: ss.segment_sum_sorted(g, seg, n_dims),
        "segment_update_sorted": lambda: ss.segment_update_sorted(
            "adagrad", s_idx, order, C, dl, emb, {"acc": acc}, t, step, 0.04, decay, 1e-5, 0.0,
            use_decay=True),
        "index_add_": lambda: torch.zeros((n_dims, 1), device=dev).index_add_(0, seg, g),
        "torch.empty": lambda: torch.empty(3, dtype=torch.int32, device=dev),
        "record_function": record_range,
        "profiler_enabled": torch._C._autograd._profiler_enabled,
        "get_device_properties": lambda: torch.cuda.get_device_properties(
            dev).multi_processor_count,
        "torch.cuda.device": device_context,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "zero_ (one small op)": small.zero_,
    }
    host_us = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host_us[name] = (t1 - t0) * 1e6 / args.reps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(json.dumps({"probe": "wrapper_host_cost", "root": args.root, "nvidia_smi": smi,
                      "reps": args.reps, "host_us": host_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
