#!/usr/bin/env python3
"""Run only the ALS recommender's phases of ``chip_smoke.py`` on the card.

    python3 probes/als_phases.py [--skip-check] [--skip-fit] [--seed 0]

Builds ``ops/csrc/normal_equations.cu`` and prints nvcc's report of each
kernel's registers, shared memory and spills; then calls ``chip_smoke.py``'s
``phase_als_check`` (the kernel against its plain version's CPU sums on
``NE_CASES``, card fits against CPU fits, recommendations with tied scores)
and ``phase_movielens_als`` (BASELINE config 4 at full width: 25,000,000
ratings, rank 16, 10 iterations; the kernel at the fit's user and item
half-steps and a skewed item draw from ``--seed``), one JSON line per phase
with its seconds, as the script does. Needs one CUDA device; exits non-zero
on a machine without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-check", action="store_true")
    ap.add_argument("--skip-fit", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("als_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import make_movielens_proxy
    from orange3_spark_tpu_torch.ops import cuda_build

    kind = torch.cuda.get_device_name(0)
    form, mem_bw, fp32_peak = cs.card_rates(kind)
    t0 = time.perf_counter()
    info = cuda_build.build(["normal_equations"])
    log = info.get("normal_equations", {}).get("log", "")
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0, "device": kind,
             "nvidia_smi": cs.nvidia_smi_line(),
             "ptxas": [ln.strip() for ln in log.splitlines()
                       if re.search(r"registers|spill|Compiling entry", ln)]})
    sess = TorchSession()
    if not args.skip_check:
        t0 = time.perf_counter()
        line = cs.phase_als_check(sess)
        cs.emit({"phase": "als_check", "seconds": time.perf_counter() - t0, **line})
    if not args.skip_fit:
        t0 = time.perf_counter()
        ratings = make_movielens_proxy(cs.MOVIELENS_RATINGS)
        line = cs.phase_movielens_als(sess, mem_bw, fp32_peak, ratings, args.seed)
        cs.emit({"phase": "movielens_als", "seconds": time.perf_counter() - t0,
                 "device": kind, "nvidia_smi": cs.nvidia_smi_line(), **line})
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
