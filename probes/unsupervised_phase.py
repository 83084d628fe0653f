#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``unsupervised`` phase on the card, without the
rest of the smoke:

    python3 probes/unsupervised_phase.py [--quick]

It builds the kernels, makes the 11M-row HIGGS proxy and runs the phase
(GaussianMixture and BisectingKMeans on the taxi table, the statistics
and selectors on HIGGS, chi-square on the TLC trips, PIC on a graph of
com-LiveJournal's size, the text path with ``categorical_gumbel`` behind
Word2Vec, FPGrowth and PrefixSpan), one JSON line. ``--quick`` instead
checks the new kernel alone: ``categorical_gumbel`` bitwise its plain
version at a few shapes (a window of rows past flat index 2^32 included),
the card's float32 sqrt against the float64 root, and the instruction
count of ``probes/categorical_work.cu``. Needs one CUDA device; exits
non-zero on a machine without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def quick(cs) -> dict:
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.ops import cuda_build, prng

    out = {"ptxas": cuda_build.build_info.get("prng", {}).get("log", "")[-3000:],
           "sqrt_card": cs._sqrt_card_check(), "work": cs.categorical_work_sass(),
           "cases": []}
    for V, n, first, seed in ((1, 7, 0, 0), (255, 300, 0, 1), (20_011, 64, 0, 3),
                              (50_000, 6, 85_897, 4)):
        rng = np.random.default_rng(seed)
        p = rng.random(V).astype(np.float32)
        logits = prng._xla_log(torch.from_numpy(p / p.sum()).cuda())
        key = prng.split(prng.PRNGKey(seed))[1]
        got = prng.categorical_gumbel(key, logits, n, first)
        want = prng.categorical_gumbel_reference(key, logits, n, first)
        torch.cuda.synchronize()
        out["cases"].append({"V": V, "n": n, "first_row": first,
                             "bitwise": bool(torch.equal(got, want))})
    if not all(c["bitwise"] for c in out["cases"]):
        raise AssertionError(f"categorical_gumbel differs from its plain version: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="check the kernel, the sqrt premise and the SASS count only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("unsupervised_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import make_higgs_proxy

    kind = torch.cuda.get_device_name(0)
    smi = cs.nvidia_smi_line()
    _, mem_bw, _ = cs.card_rates(kind)
    cs.emit({"phase": "build", **cs.phase_build()})
    if args.quick:
        cs.emit({"phase": "quick", "device": kind, "nvidia_smi": smi, **quick(cs)})
    else:
        t0 = time.perf_counter()
        higgs = make_higgs_proxy(11_000_000, seed=0)
        gen_s = time.perf_counter() - t0
        line = cs.phase_unsupervised(TorchSession(), higgs, mem_bw, cs.int32_rate())
        cs.emit({"phase": "unsupervised", "device": kind, "nvidia_smi": smi,
                 "higgs_generate_s": gen_s, **line})
    print(cs.nvidia_smi_line(), flush=True)
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
