#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``overload`` phase on the card, without the rest
of the smoke:

    python3 probes/overload_phase.py [--repeat N]

bench.py's overload config at its sizes (the CTR model's adam fit through
``segment_sum_sorted``, built on first use; the raw and admitted arms; the
telemetry endpoint with a ``POST /debug/profile`` over served requests; the
breaker and brownout drills); the Criteo fit's goodput and ledger plane is
``probes/criteo_phases.py``'s. Flight bundles and captures go to a temporary
directory, removed at the end. One JSON line a run, then
an ``ok`` line. Needs one CUDA device; exits non-zero on a machine without
one.
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
    ap.add_argument("--repeat", type=int, default=1, help="runs of the phase")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("overload_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    obs_dir = tempfile.mkdtemp(prefix="overload_phase_")
    os.environ["OTPU_FLIGHT_DIR"] = os.path.join(obs_dir, "flight")
    os.environ["OTPU_PROF_DIR"] = os.path.join(obs_dir, "prof")
    try:
        import chip_smoke as cs
        from orange3_spark_tpu_torch import TorchSession

        sess = TorchSession()
        kind = torch.cuda.get_device_name(0)
        for i in range(args.repeat):
            line = cs.phase_overload(sess, kind, cs.nvidia_smi_line())
            cs.emit({"phase": "overload", "run": i, **line})
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(obs_dir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": kind}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
