#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``multihost`` and ``multihost_hashed`` phases
without the rest of the smoke:

    python3 probes/multihost_phases.py [--only multihost,multihost_hashed]

Bench's multihost config and the Criteo hashed fit across ranks on one
CUDA device (gangs of rank processes sharing the card). ``multihost_hashed``
reads the first 2^21 rows of a Criteo CSV and the 2^18 after them: the probe
writes a CSV of that many rows (``gen_criteo_csv``, seed 0: the smoke's
first rows) in a temporary directory, removed at the end. One JSON line a
phase, then an ``ok`` line; exits non-zero when a phase fails.

``--only`` may also name, as often as wanted, two host-bound yardsticks of
the smoke, ``libsvm_hashed`` (a libsvm file written and parsed, the
value-weighted fit) and ``ows`` (the canvas on the CPU and on the card), and
``procs`` (this process's threads and every other python process on the
machine): ``--only libsvm_hashed,ows,multihost,procs,libsvm_hashed,ows``
shows whether the gang phases slow the host work after them. Every line
carries ``phase_s``, its wall.
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
    ap.add_argument("--only", default="multihost,multihost_hashed",
                    help="comma-separated phases to run, in this order")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("multihost_phases: no CUDA device", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    sys.path.insert(0, ROOT)
    tmp = tempfile.mkdtemp(prefix="multihost_phases_")
    os.environ["OTPU_FLIGHT_DIR"] = os.path.join(tmp, "flight")
    os.environ["OTPU_PROF_DIR"] = os.path.join(tmp, "prof")
    ok = True
    try:
        import chip_smoke as cs
        from orange3_spark_tpu_torch import TorchSession
        from orange3_spark_tpu_torch.datasets import gen_criteo_csv
        from orange3_spark_tpu_torch.ops import cuda_build

        cuda_build.build()          # the ranks load the libraries this builds
        sess = TorchSession("cuda")
        path = os.path.join(tmp, "criteo.csv")
        phases = {"multihost": lambda: cs.phase_multihost(tmp, sess),
                  "multihost_hashed": lambda: cs.phase_multihost_hashed(path, sess),
                  "libsvm_hashed": lambda: cs.phase_libsvm_hashed(
                      sess, tempfile.mkdtemp(dir=tmp), cs.card_rates(kind)[1]),
                  "ows": lambda: cs.phase_ows(tempfile.mkdtemp(dir=tmp)),
                  "procs": _procs}
        for name in args.only.split(","):
            try:
                if name == "multihost_hashed" and not os.path.exists(path):
                    gen_criteo_csv(path, cs.MHH_ROWS + cs.MHH_HOLDOUT, seed=0)
                line = phases[name]()
                cs.emit({"phase": name, "device": kind, "nvidia_smi": cs.nvidia_smi_line(),
                         **line})
            except Exception as e:  # noqa: BLE001 - report, run the next phase
                traceback.print_exc()
                cs.emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"})
                ok = False
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": ok, "device": kind}))
    return 0 if ok else 1


def _procs() -> dict:
    """This process's threads, and the other python processes running."""
    import subprocess
    import threading

    ps = subprocess.run(["ps", "-eo", "pid,ppid,stat,pcpu,etime,args"], capture_output=True,
                        text=True, timeout=60).stdout.splitlines()
    others = [ln for ln in ps[1:] if "python" in ln and str(os.getpid()) not in ln.split()[:1]]
    return {"threads": threading.active_count(), "tasks": len(os.listdir("/proc/self/task")),
            "other_python_processes": others}


if __name__ == "__main__":
    sys.exit(main())
