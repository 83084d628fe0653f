#!/usr/bin/env python3
"""The MLP's l-bfgs fit and FM's adam fit on the card against the CPU path,
iteration by iteration, on ``chip_smoke.py``'s 200,000-row HIGGS cut (the
first rows of the 11M-row proxy):

    python3 probes/mlp_card_cpu.py [--rows 200000] [--iters 3,6,9,11,12,15,100]
                                   [--fm-iters 20,40,60,100]

For each iteration count: the largest relative difference of the two
models' parameters (of max(1, |w|)), both final losses and, for the MLP,
both fits' objective evaluations by iteration (a linesearch that takes
another branch on one device shows as another count). Also the same on
the CPU against a row-permuted copy of the table (the float32 order noise
of the sums alone). One JSON line. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--iters", default="3,6,9,11,12,15,100")
    ap.add_argument("--fm-iters", default="20,40,60,100")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mlp_card_cpu: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from orange3_spark_tpu_torch import TorchSession, TorchTable
    from orange3_spark_tpu_torch.datasets import higgs_domain, make_higgs_proxy
    from orange3_spark_tpu_torch.models import _linear as L
    from orange3_spark_tpu_torch.models.fm import FMClassifier
    from orange3_spark_tpu_torch.models.mlp import MultilayerPerceptronClassifier

    X, y = make_higgs_proxy(11_000_000, seed=0)
    X, y = X[: args.rows].copy(), y[: args.rows].copy()
    perm = np.random.default_rng(0).permutation(len(X))
    tables = {"cuda": TorchTable.from_numpy(higgs_domain(), X, y, session=TorchSession("cuda")),
              "cpu": TorchTable.from_numpy(higgs_domain(), X, y, session=TorchSession("cpu")),
              "cpu_permuted": TorchTable.from_numpy(higgs_domain(), X[perm], y[perm],
                                                    session=TorchSession("cpu"))}
    evals = []
    real = L.AutogradObjective.end_iteration

    def record(self):
        real(self)
        evals.append(self.iter_evals[-1])

    L.AutogradObjective.end_iteration = record

    def fit(name, it):
        evals.clear()
        m = MultilayerPerceptronClassifier(layers=(28, 64, 64, 2), max_iter=it,
                                           seed=0).fit(tables[name])
        w = torch.cat([torch.cat([lay["W"].reshape(-1), lay["b"]]) for lay in m.net])
        return w.cpu().numpy().astype(np.float64), m.final_loss_, list(evals)

    out = []
    for it in (int(x) for x in args.iters.split(",")):
        (a, la, ea), (b, lb, eb), (c, lc, _) = (fit(n, it) for n in tables)
        out.append({"iters": it,
                    "card_vs_cpu": float(np.max(np.abs(a - b) / np.maximum(1, np.abs(b)))),
                    "cpu_vs_permuted": float(np.max(np.abs(c - b) / np.maximum(1, np.abs(b)))),
                    "loss_card": la, "loss_cpu": lb, "loss_cpu_permuted": lc,
                    "evals_card": ea, "evals_cpu": eb})
    fm_out = []
    for it in (int(x) for x in args.fm_iters.split(",")):
        fits = {n: FMClassifier(factor_size=8, max_iter=it, seed=0).fit(t)
                for n, t in tables.items()}
        flat = {n: torch.cat([m.theta[k].reshape(-1) for k in ("V", "w", "w0")])
                .cpu().numpy().astype(np.float64) for n, m in fits.items()}
        b = flat["cpu"]
        fm_out.append({"iters": it, "n_iter": {n: m.n_iter_ for n, m in fits.items()},
                       "card_vs_cpu": float(np.max(np.abs(flat["cuda"] - b)
                                                   / np.maximum(1, np.abs(b)))),
                       "cpu_vs_permuted": float(np.max(np.abs(flat["cpu_permuted"] - b)
                                                       / np.maximum(1, np.abs(b))))})
    print(json.dumps({"rows": args.rows, "device": torch.cuda.get_device_name(0),
                      "by_iterations": out, "fm_by_iterations": fm_out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
