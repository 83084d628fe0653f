#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases of the dense streaming fit and the
value-weighted hashed fit on the card, without the rest of the smoke:

    python3 probes/streaming_phases.py [--only fault,streaming_linear,libsvm_hashed]

``fault`` (bench.py's fault config on ``StreamingLinearEstimator``),
``streaming_linear`` (the 4M x 40 dense_logreg table out of core, its
schedules bitwise, the streaming evaluator, the card against the CPU) and
``libsvm_hashed`` (a 524,288-row libsvm file written by numpy into a
temporary directory outside the checkout, the value-weighted fit with
``segment_update_sorted`` given the pairs' values; the kernel is built on
first use). One JSON line per phase, then an ``ok`` line. Needs one CUDA
device; exits non-zero on a machine without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("fault", "streaming_linear", "libsvm_hashed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("streaming_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession

    sess = TorchSession()
    kind = torch.cuda.get_device_name(0)
    for phase in args.only.split(","):
        if phase == "fault":
            line = cs.phase_fault(sess)
        elif phase == "streaming_linear":
            line = cs.phase_streaming_linear(sess)
        elif phase == "libsvm_hashed":
            tmp = tempfile.mkdtemp(prefix="streaming_phases_")
            try:
                line = cs.phase_libsvm_hashed(sess, tmp, cs.card_rates(kind)[1])
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            raise SystemExit(f"unknown phase {phase!r}; one of {PHASES}")
        cs.emit({"phase": phase, "device": kind, "nvidia_smi": cs.nvidia_smi_line(), **line})
        torch.cuda.empty_cache()
    print(json.dumps({"ok": True, "device": kind}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
