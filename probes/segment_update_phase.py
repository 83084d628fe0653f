#!/usr/bin/env python3
"""Build ``segment_sum.cu`` and run ``chip_smoke.py``'s ``segment_update``
and ``segment_sum`` checks on inputs shaped like the Criteo step's, without
a fit.

    python3 probes/segment_update_phase.py [--rows 262144] [--dead-rows 26000]

The inputs: ``rows`` x 26 occurrences with keys uniform over 2^22 table
rows, the last ``dead-rows`` rows padding (the dead sentinel 2^22), stably
sorted as the step's 'sort' lowering sorts them; dl, the table and the
adagrad slots from a seeded generator, the last-seen steps 0 and the step
counter 5 (a row's first touch catches up five steps of decay); the
update's phase then runs its ``criteo_zipf`` case on that state. The
segment sum gets the chain's inputs (the gathered gradients, i32 segment
ids, the skip flag). Prints the build report (ptxas) and one JSON line per
phase. Needs one CUDA device; exits non-zero on a machine without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--dead-rows", type=int, default=26_000)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("segment_update_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch.ops import cuda_build
    from orange3_spark_tpu_torch.optim.sparse import _sort_segments, plan_slots

    info = cuda_build.build(["segment_sum"])
    print(json.dumps({"build": {k: {"seconds": v["seconds"], "log": v["log"][-2000:]}
                                for k, v in info.items()}}), flush=True)
    dev = torch.device("cuda")
    mem_bw = cs.card_rates(torch.cuda.get_device_name(0))[1]
    n_dims, C = 1 << 22, 26
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, n_dims, (args.rows, C), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[args.rows - args.dead_rows:] = n_dims
    s_idx, order, _, seg = _sort_segments(idx.reshape(-1))
    dl = torch.randn((args.rows, 1), generator=gen, device=dev) * 1e-4
    emb = torch.randn((n_dims, 1), generator=gen, device=dev) * 0.01
    slots = {"acc": torch.rand((n_dims, 1), generator=gen, device=dev)}
    t = torch.zeros(n_dims, dtype=torch.int32, device=dev)
    step = torch.tensor(5, dtype=torch.int32, device=dev)
    lr, reg = 0.04, 1e-5
    decay = float(np.float32(1.0) - np.float32(lr) * np.float32(reg))
    update = (("adagrad", s_idx, order, C, dl, emb, slots, t, step, lr, decay, reg, 0.0),
              True, None)
    cs.emit({"phase": "segment_update_synthetic", "nvidia_smi": cs.nvidia_smi_line(),
             **cs.phase_segment_update(update, mem_bw)})
    inputs = (dl.index_select(0, order // C), seg, plan_slots(args.rows, C, n_dims),
              s_idx[-1:] >= n_dims)
    cs.emit({"phase": "segment_sum_synthetic", "nvidia_smi": cs.nvidia_smi_line(),
             **cs.phase_segment_sum(inputs, mem_bw)})
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
