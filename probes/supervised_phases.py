#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases of JAX's stream and of MLlib's supervised
estimators on the card, without the rest of the smoke:

    python3 probes/supervised_phases.py [--only parity,prng,rf,supervised]

``parity``: the tree fits card against CPU on a 40,000-row HIGGS table,
seeded forests and subsampled GBT with no injected draws among them;
``prng``: ``threefry_bits`` and ``poisson_knuth`` (built on first use)
bitwise their plain versions at the forest's shapes, timed beside their
bounds; ``rf``: the config-3 RandomForestClassifier fit on the 11M-row
HIGGS proxy (a warm-up, the timed fit, its draws' launches), then the
draws timed at the fit's shapes; ``supervised``: the nine estimators at
full width, each held to the CPU path on a 200,000-row cut. One JSON line
a phase, then an ``ok`` line. Needs one CUDA device; exits non-zero on a
machine without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("parity", "prng", "rf", "supervised")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases of {PHASES}")
    args = ap.parse_args(argv)
    only = args.only.split(",")

    import torch

    if not torch.cuda.is_available():
        print("supervised_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession, TorchTable
    from orange3_spark_tpu_torch.datasets import higgs_domain, make_higgs_proxy
    from orange3_spark_tpu_torch.models.random_forest import RandomForestClassifier

    sess = TorchSession()
    kind = torch.cuda.get_device_name(0)
    smi = cs.nvidia_smi_line()
    _, mem_bw, _ = cs.card_rates(kind)
    cs.emit({"phase": "build", **cs.phase_build()})
    if "parity" in only:
        cs.emit({"phase": "parity", **cs.phase_parity()})
    if "prng" in only:
        cs.emit({"phase": "prng", "device": kind, "nvidia_smi": smi,
                 **cs.phase_prng(mem_bw, cs.int32_rate())})
        torch.cuda.empty_cache()
    if "rf" in only or "supervised" in only:
        t0 = time.perf_counter()
        X, y = make_higgs_proxy(11_000_000, seed=0)
        gen_s = time.perf_counter() - t0
        if "rf" in only:
            h = cs.HOLDOUT
            table = TorchTable.from_numpy(higgs_domain(), X[:-h], y[:-h], session=sess)
            held = TorchTable.from_numpy(higgs_domain(), X[-h:], y[-h:], session=sess)
            est = RandomForestClassifier(num_trees=20, max_depth=5, max_bins=32)
            line = cs.phase_fit("rf", est, table, held, y[-h:], cs.RF_AUC_FLOOR)
            cs.emit({"phase": "rf", "device": kind, "nvidia_smi": smi, "generate_s": gen_s,
                     **line, **cs._rf_draw_line(est, table)})
            del table, held
            torch.cuda.empty_cache()
        if "supervised" in only:
            cs.emit({"phase": "supervised", "device": kind, "nvidia_smi": smi,
                     **cs.phase_supervised(sess, (X, y), smi)})
    print(json.dumps({"ok": True, "device": kind}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
