#!/usr/bin/env python3
"""What the deterministic kernels cost the Criteo step, on one card.

    python3 probes/segment_sum_step.py [--rows 1048576] [--steps 20] [--rounds 2]

Fits the ``criteo`` phase's configuration (2^22 dims, 2^18-row chunks,
packed cache) for one epoch on a CSV of ``rows`` rows, then times eager
steps over its cached chunks (``chip_smoke._step_ms``: CUDA events around
``steps`` steps after a warm one) with the step's sums computed two ways,
in turns (kernel, index_add_, index_add_, kernel, ...):

* ``kernel``: the port as it is (``segment_update_sorted`` after the
  sort and, for adam, ``dense_table_grad``'s sort + ``segment_sum_sorted``
  + one write a row);
* ``index_add``: ``segment_update_sorted`` swapped for its plain version
  (the chain over all segment slots, its sums an ``index_add_`` with float
  atomics), and ``dense_table_grad`` for one ``index_add_`` (the port
  before the kernels).

Also the host time of one wrapper call against one ``index_add_`` on a
small input (no device wait), and the captured replay epoch of each
variant. Prints one JSON line. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("segment_sum_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import gen_criteo_csv
    from orange3_spark_tpu_torch.io.streaming import csv_raw_chunk_source
    from orange3_spark_tpu_torch.models import hashed_linear as hl
    from orange3_spark_tpu_torch.models.hashed_linear import _Replay, _step_into
    from orange3_spark_tpu_torch.ops import segment_sum as ss
    from orange3_spark_tpu_torch.optim import sparse

    sess = TorchSession()
    tmp = tempfile.mkdtemp(prefix="segment_sum_step_")
    try:
        path = os.path.join(tmp, "c.csv")
        gen_criteo_csv(path, args.rows, seed=0)
        model = cs._criteo_estimator(epochs=1, defer_epoch1=False).fit_stream(
            csv_raw_chunk_source(path, chunk_rows=cs.CRITEO["chunk_rows"]), session=sess,
            cache_device=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    chunks = model.device_chunks_

    kernel_update, kernel_grad = sparse.segment_update_sorted, hl.dense_table_grad

    def atomic_sum(g, seg, n_slots):
        return torch.zeros((n_slots, g.shape[1]), device=g.device).index_add_(0, seg, g)

    def atomic_grad(idx, dl, n_rows):
        N, C = idx.shape
        return torch.zeros((n_rows, dl.shape[1]), device=dl.device).index_add_(
            0, idx.reshape(-1), dl[:, None, :].expand(N, C, dl.shape[1]).reshape(N * C, -1))

    variants = {"kernel": (kernel_update, kernel_grad),
                "index_add": (ss.segment_update_sorted_reference, atomic_grad)}

    def use(name):
        sparse.segment_update_sorted, hl.dense_table_grad = variants[name]

    def replay_epoch_ms():
        theta, opt, salts, kw, hyper = cs._fresh_state(model.params, model.theta, sess)
        replay = _Replay(theta, opt, chunks,
                         lambda th, op, c: _step_into(th, op, c, salts, hyper, kw))
        replay.capture()
        replay.run(1, timed=False)
        sess.synchronize()
        return cs.cuda_ms(lambda: replay.run(1, timed=False), 5)

    out = {name: {"pure_step_ms": [], "pure_step_ms_dense": [], "replay_epoch_ms": []}
           for name in variants}
    order = []
    for r in range(args.rounds):
        for name in (("kernel", "index_add") if r % 2 == 0 else ("index_add", "kernel")):
            order.append(name)
            use(name)
            try:
                res = out[name]
                res["pure_step_ms"].append(cs._step_ms(model.params, model.theta, chunks,
                                                       sess, args.steps))
                res["pure_step_ms_dense"].append(cs._step_ms(
                    model.params.replace(optim_update="adam"), model.theta, chunks, sess,
                    args.steps))
                res["replay_epoch_ms"].append(replay_epoch_ms())
            finally:
                use("kernel")
            torch.cuda.empty_cache()

    # host time of one call, no device wait: the wrapper against index_add_
    g = torch.randn((1024, 1), device="cuda")
    seg = torch.arange(1024, device="cuda") // 3
    host = {}
    for name, fn in (("segment_sum_sorted", lambda: ss.segment_sum_sorted(g, seg, 400)),
                     ("index_add_", lambda: atomic_sum(g, seg, 400))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host[name] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
    print(json.dumps({"probe": "segment_sum_step", "nvidia_smi": cs.nvidia_smi_line(),
                      "rows": args.rows, "chunks": len(chunks), "steps": args.steps,
                      "order": order, **out, "host_ms_per_call": host}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
