#!/usr/bin/env python3
"""Run only the taxi feature pipeline's phases of ``chip_smoke.py`` on the card.

    python3 probes/taxi_phases.py [--rows 10000000] [--skip-check]

Calls ``chip_smoke.py``'s ``phase_taxi_check`` (the card against the port's
CPU path at 200,000 rows: the fits, Lloyd's fixed-trip form, the staged
transform and refit, the cached StreamingKMeans replay, served bits at
every rung) and ``phase_taxi_pipeline`` (BASELINE config 5 at ``--rows``,
config 5's 10M by default) and prints one JSON line per phase with its
seconds, as the script does, without the other phases. No kernel of the
package runs here, so nothing is built. Needs one CUDA device; exits
non-zero on a machine without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--skip-check", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("taxi_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import make_taxi_proxy

    sess = TorchSession()
    kind = torch.cuda.get_device_name(0)
    smi = cs.nvidia_smi_line()
    if not args.skip_check:
        t0 = time.perf_counter()
        line = cs.phase_taxi_check(sess)
        cs.emit({"phase": "taxi_check", "device": kind, "nvidia_smi": smi, **line,
                 "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    X = make_taxi_proxy(args.rows)
    gen_s = time.perf_counter() - t0
    line = cs.phase_taxi_pipeline(sess, X)
    cs.emit({"phase": "taxi_pipeline", "device": kind, "nvidia_smi": smi, "generate_s": gen_s,
             **line, "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
