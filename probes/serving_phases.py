#!/usr/bin/env python3
"""Run only the serving phases of ``chip_smoke.py`` on the card.

    python3 probes/serving_phases.py [--rows 1200000] [--full-dims 4194304]

Writes a Criteo CSV of ``--rows`` rows (at least the 4 chunks of 2^18 rows
and the 2^19-row request pool of bench.py's serving configuration), fits
the full-width stand-in (``--full-dims``, one epoch over the same 4 chunks:
``chip_smoke.py`` serves the model its ``criteo`` phase fitted instead),
then calls ``phase_serving_check``, ``phase_serving`` and
``phase_serving_profile`` and prints one JSON line per phase, without the
tree and Criteo fit phases and without building the CUDA kernels (the
serving path runs PyTorch ops in captured graphs). The CSV goes to a
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
    ap.add_argument("--rows", type=int, default=1_200_000)
    ap.add_argument("--full-dims", type=int, default=1 << 22)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("serving_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession

    sess = TorchSession()
    smi = cs.nvidia_smi_line()
    tmp = tempfile.mkdtemp(prefix="serving_phases_")
    try:
        path, line = cs.phase_criteo_data(tmp, args.rows)
        cs.emit({"phase": "criteo_data", **line})
        full, _ = cs._serve_model(path, sess, args.full_dims, cs.CRITEO["chunk_rows"],
                                  cs.SERVE_FIT_CHUNKS)
        t0 = time.perf_counter()
        cs.emit({"phase": "serving_check", **cs.phase_serving_check(path, sess),
                 "s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        model, pool, line = cs.phase_serving(path, sess, full)
        cs.emit({"phase": "serving", "nvidia_smi": smi, **line,
                 "s": time.perf_counter() - t0})
        cs.emit({"phase": "serving_profile", "nvidia_smi": smi,
                 **cs.phase_serving_profile(model, pool)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
