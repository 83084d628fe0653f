#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``fleet``, ``tenancy`` and ``online`` phases
without the rest of the smoke:

    python3 probes/fleet_phases.py [--only fleet,tenancy,online]

bench.py's three configs at its sizes on one CUDA device: replica
processes serving on the card behind the router, the autoscaler, the
online loop with its trainer on the card against the CPU. Flight bundles go to a temporary directory, removed at the end. One JSON
line a phase, then an ``ok`` line; exits non-zero when a phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="fleet,tenancy,online",
                    help="comma-separated phases to run, in this order")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fleet_phases: no CUDA device", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    sys.path.insert(0, ROOT)
    obs_dir = tempfile.mkdtemp(prefix="fleet_phases_")
    os.environ["OTPU_FLIGHT_DIR"] = os.path.join(obs_dir, "flight")
    os.environ["OTPU_PROF_DIR"] = os.path.join(obs_dir, "prof")
    ok = True
    try:
        import chip_smoke as cs
        from orange3_spark_tpu_torch import TorchSession

        sess = TorchSession("cuda")
        phases = {"fleet": cs.phase_fleet, "tenancy": cs.phase_tenancy,
                  "online": cs.phase_online}
        for name in args.only.split(","):
            try:
                line = phases[name](sess)
                cs.emit({"phase": name, "device": kind, "nvidia_smi": cs.nvidia_smi_line(),
                         **line})
            except Exception as e:  # noqa: BLE001 - report, run the next phase
                traceback.print_exc()
                cs.emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"})
                ok = False
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(obs_dir, ignore_errors=True)
    print(json.dumps({"ok": ok, "device": kind}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
