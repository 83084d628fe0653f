#!/usr/bin/env python3
"""Run only the dense linear family's phases of ``chip_smoke.py`` on the card.

    python3 probes/linear_phases.py

Calls ``chip_smoke.py``'s ``phase_linear_check`` (the card against the
port's CPU path, served predictions against raw ones), ``phase_iris``
(BASELINE config 1) and ``phase_dense_logreg`` (``bench.py --config
dense_logreg`` at its full 4,000,000 x 40, bf16 and f32 arms) and prints
one JSON line per phase with its seconds, as the script does, without the
tree, Criteo and serving phases. No kernel of the
package runs here, so nothing is built. Needs one CUDA device; exits
non-zero on a machine without one.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("linear_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession

    sess = TorchSession()
    kind = torch.cuda.get_device_name(0)
    smi = cs.nvidia_smi_line()
    mem_bw = cs.card_rates(kind)[1]
    for name, fn in (("linear_check", lambda: cs.phase_linear_check(sess)),
                     ("iris", lambda: cs.phase_iris(sess)),
                     ("dense_logreg", lambda: cs.phase_dense_logreg(sess, mem_bw))):
        t0 = time.perf_counter()
        line = fn()
        cs.emit({"phase": name, "device": kind, "nvidia_smi": smi, **line,
                 "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
