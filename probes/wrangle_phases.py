#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``wrangle`` and ``ows`` phases on the card,
without the rest of the smoke:

    python3 probes/wrangle_phases.py [--only wrangle|ows]

``wrangle``: ``ops/relational`` and ``ops/window`` on 10,000,000 TLC-shaped
trips, each call timed and held against the CPU, then ``segment_sum_sorted``
(built on first use) at ``group_by``'s inputs; ``ows``: the canvas scheme
over a SQLite database of 1,000,000 trips, run on the card and on the CPU.
Files go to a temporary directory, removed at the end. One JSON line a
phase, then an ``ok`` line. Needs one CUDA device; exits non-zero on a
machine without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("wrangle", "ows"), default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("wrangle_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    tmp = tempfile.mkdtemp(prefix="wrangle_phases_")
    try:
        import chip_smoke as cs
        from orange3_spark_tpu_torch import TorchSession

        sess = TorchSession()
        kind = torch.cuda.get_device_name(0)
        _, mem_bw, _ = cs.card_rates(kind)
        if args.only in (None, "wrangle"):
            cs.emit({"phase": "wrangle", "device": kind, "nvidia_smi": cs.nvidia_smi_line(),
                     **cs.phase_wrangle(sess, mem_bw, tmp)})
            torch.cuda.empty_cache()
        if args.only in (None, "ows"):
            cs.emit({"phase": "ows", "device": kind, "nvidia_smi": cs.nvidia_smi_line(),
                     **cs.phase_ows(tmp)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": kind}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
