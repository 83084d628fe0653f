#!/usr/bin/env python3
"""Run only the Criteo phases of ``chip_smoke.py`` on the card.

    python3 probes/criteo_phases.py [--rows 8000000] [--epochs 100]

Calls ``chip_smoke.py``'s ``phase_criteo_check``, ``phase_criteo_data``,
``phase_criteo``, ``phase_criteo_profile``, ``phase_segment_sum`` and
``phase_segment_update`` (the two kernels of ``ops/csrc/segment_sum.cu`` at
one step's own inputs) in that order and prints one JSON line per phase,
as the script does, without the tree, recovery and serving phases. The
first step builds the segment-sum kernels (seconds). Its CSV goes to a
temporary directory that is removed at the end. Needs one CUDA device;
exits non-zero on a machine without one.
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
    ap.add_argument("--rows", type=int, default=8_000_000)
    ap.add_argument("--epochs", type=int, default=100)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("criteo_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.native import tune_malloc

    sess = TorchSession()
    tune_malloc()      # as chip_smoke.py does before its Criteo phases
    tmp = tempfile.mkdtemp(prefix="criteo_phases_")
    try:
        t0 = time.perf_counter()
        cs.emit({"phase": "criteo_check", **cs.phase_criteo_check(tmp),
                 "s": time.perf_counter() - t0})
        path, line = cs.phase_criteo_data(tmp, args.rows)
        cs.emit({"phase": "criteo_data", **line})
        model, line = cs.phase_criteo(path, args.rows, args.epochs, sess)
        cs.emit({"phase": "criteo", "nvidia_smi": cs.nvidia_smi_line(), **line})
        cs.emit({"phase": "criteo_profile", **cs.phase_criteo_profile(model, sess)})
        mem_bw = cs.card_rates(torch.cuda.get_device_name(0))[1]
        cs.emit({"phase": "segment_sum",
                 **cs.phase_segment_sum(cs._step_segment_inputs(model, sess), mem_bw)})
        cs.emit({"phase": "segment_update",
                 **cs.phase_segment_update(cs._step_update_inputs(model, sess), mem_bw)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
