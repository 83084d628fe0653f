#!/usr/bin/env python3
"""Which ops of the taxi pipeline's staged refit a CUDA graph can capture,
and whether cuBLAS rounds a row of a small product apart at another row
count. Run on a machine with a CUDA GPU:

    python3 probes/eigh_capture.py

Prints one JSON line per probe:

  capture   for each op (``torch.linalg.eigh`` of an 8x8 covariance,
            ``topk``, ``searchsorted``, ``index_copy_``, ``argmin``, a
            float ``max`` read on the host as the negative control): does
            a capture in thread-local mode succeed, and does a replay give
            the eager result; after a failed capture, does the next eager
            op and the next capture still work
  rows      ``torch.mm`` of [n, d] @ [d, k] (d, k: PCA 8->4 and the KMeans
            cross term 4x10) at n = 1..512 against the first n rows of the
            512-row product: the row counts where a row's bits differ
"""

from __future__ import annotations

import json
import traceback

import torch


def _capture(fn):
    """Capture ``fn`` (after a warm-up on a side stream, as the package's
    ``utils/graphs.capture_graph``); returns (graph, outputs) or raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        out = fn()
    return g, out


def _probe(name, fn):
    line = {"probe": "capture", "op": name}
    eager = fn()
    try:
        g, out = _capture(fn)
        g.replay()
        torch.cuda.synchronize()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        eag = eager if isinstance(eager, (tuple, list)) else (eager,)
        line["captures"] = True
        line["replay_equals_eager"] = all(torch.equal(a, b) for a, b in zip(outs, eag))
    except Exception as e:  # noqa: BLE001 - the probe reports the failure
        line["captures"] = False
        line["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    # the context after the attempt: an eager op and a fresh capture
    try:
        x = torch.ones(4, device="cuda") * 2
        torch.cuda.synchronize()
        line["eager_after"] = float(x.sum())
        g2, o2 = _capture(lambda: x * 3)
        g2.replay()
        torch.cuda.synchronize()
        line["capture_after"] = float(o2.sum())
    except Exception as e:  # noqa: BLE001
        line["after_error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    print(json.dumps(line), flush=True)


def main() -> int:
    torch.manual_seed(0)
    dev = "cuda"
    X = torch.randn(4096, 8, device=dev)
    cov = (X.T @ X) / 4096
    cov = (cov + cov.T) / 2
    v = torch.randn(100_000, device=dev)
    splits = torch.tensor([-1.0, 0.0, 1.0], device=dev)
    idx = torch.tensor([0, 2, 5], device=dev)
    _probe("linalg.eigh_8x8", lambda: torch.linalg.eigh(cov))
    _probe("topk", lambda: torch.topk(v, 8192))
    _probe("searchsorted", lambda: torch.searchsorted(splits, v, right=True))
    _probe("index_copy_", lambda: torch.zeros(8, device=dev).index_copy_(
        0, idx, torch.ones(3, device=dev)))
    _probe("argmin", lambda: torch.argmin(X, dim=1))
    _probe("host_read_negative_control", lambda: torch.tensor(float(v.max()), device=dev))

    for d, k in ((8, 4), (4, 10)):
        A = torch.randn(512, d, device=dev)
        B = torch.randn(d, k, device=dev)
        full = A @ B
        bad = [n for n in range(1, 513) if not torch.equal((A[:n] @ B), full[:n])]
        print(json.dumps({"probe": "rows", "d": d, "k": k,
                          "rows_differing_from_512": bad[:64], "n_differing": len(bad)}),
              flush=True)
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except SystemExit:
        raise
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        raise SystemExit(1)
