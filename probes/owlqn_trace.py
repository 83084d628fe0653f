#!/usr/bin/env python3
"""OWLQN's pseudo-gradient norm after each iteration, on the card and on
the CPU, for the fit that ``tests/test_torch_cuda.py``'s OWLQN
card-against-CPU case runs: ``make_classification(2048, 12, 3, seed=1)``,
logistic, reg_l2 1e-2, L1 0.05, the column scale.

    python3 probes/owlqn_trace.py [--tol 1e-5] [--max-iter 500] [--devices cuda,cpu]

The pseudo-gradient is taken where the minimizer takes the smooth
gradient: at the start and at each iteration's accepted point. Near the
optimum the backtracking search accepts points that leave the loss flat
to a float32 ulp, the iterate stops moving, and the norm stays at a floor
that float32 rounding sets; whether that floor lies below ``tol`` decides
whether the fit stops. Per device the probe prints one JSON line: the
iterations, the first 30 norms, the floor (the least norm and the norm of
the last 50 iterations), the iteration after which the iterate no longer
moved, the loss and the exactly-zero coefficients.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pseudo_grad_norm(x, g, l1) -> float:
    """The minimizers' pseudo-gradient norm, in float32 on the host."""
    import numpy as np

    right, left = g + l1, g - l1
    pg = np.where(x > 0, right, np.where(x < 0, left, np.where(
        right < 0, right, np.where(left > 0, left, np.float32(0.0)))))
    return float(np.linalg.norm(pg.astype(np.float32)))


def last_move(points) -> int:
    """The index of the last point that differs from the one before."""
    import numpy as np

    i = len(points) - 1
    while i > 0 and np.array_equal(points[i], points[i - 1]):
        i -= 1
    return i


def trace(device: str, tol: float, max_iter: int) -> dict:
    """The port's OWLQN fit on ``device``, with every norm in ``pg_norms``."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.core.session import TorchSession
    from orange3_spark_tpu_torch.datasets import make_classification
    from orange3_spark_tpu_torch.models import _linear as lin

    k, reg_l2, reg_l1 = 3, 1e-2, 0.05
    table = make_classification(2048, 12, k, seed=1, session=TorchSession(device))
    d = table.X.shape[1]
    obj = lin.LinearObjective(table.X, table.y, table.W, reg_l2,
                              lin.column_inv_std(table.X, table.W), loss_kind="logistic",
                              k=k, fit_intercept=True, compute_dtype=torch.float32)
    seen = []
    value_and_grad = obj.value_and_grad

    def recording(theta):
        v, g = value_and_grad(theta)
        seen.append((theta.cpu().numpy(), g.cpu().numpy()))
        return v, g

    obj.value_and_grad = recording
    l1 = torch.cat([torch.full((d * k,), float(np.float32(reg_l1)), device=table.X.device),
                    torch.zeros((k,), device=table.X.device)])
    x, n_iter, loss = lin.owlqn_minimize(obj, torch.zeros((d * k + k,), device=table.X.device),
                                         l1, tol, max_iter)
    l1h = l1.cpu().numpy()
    return {"device": device, "tol": tol, "max_iter": max_iter, "n_iter": n_iter,
            "loss": loss, "zeros": int((x[:d * k] == 0).sum()),
            "pg_norms": [pseudo_grad_norm(xh, gh, l1h) for xh, gh in seen],
            "iterate_last_moved_at_iter": last_move([xh for xh, _ in seen])}


def summary(line: dict) -> dict:
    """A trace with its norms cut to the first 30, the least, and the
    least and largest of the last 50."""
    norms = line.pop("pg_norms")
    return {**line, "pg_norms_first_30": norms[:30], "pg_norm_min": min(norms),
            "pg_norm_last_50_min_max": [min(norms[-50:]), max(norms[-50:])]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--devices", default="cuda,cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    devices = args.devices.split(",")
    if "cuda" in devices and not torch.cuda.is_available():
        print("owlqn_trace: no CUDA device", file=sys.stderr)
        return 2
    for dev in devices:
        print(json.dumps(summary(trace(dev, args.tol, args.max_iter))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
