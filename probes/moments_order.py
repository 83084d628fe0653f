#!/usr/bin/env python3
"""What the port's fixed summation orders cost on the card: XLA:CPU's
reduction order in ``ops/stats.weighted_moments`` (and that it gives the
CPU's bits there), and KMeans' float64 cluster sums in a Lloyd step:

    python3 probes/moments_order.py [--shapes 11000000x28,4000000x40,10000000x8]

For each rows x columns shape (the HIGGS proxy's, dense_logreg's and the
taxi table's by default) a seeded float32 table and weights in [0, 2) are
made on the card; ``weighted_moments`` (its column sums in XLA:CPU's order,
``core/fmath.xla_sum``) and the same moments from ``torch.sum`` are each
timed by CUDA events (5 calls after a warm-up, in turns, twice), and the
card's moments are held bitwise to the CPU path's on the same inputs.
Then one Lloyd step (``models/kmeans._lloyd_step``, k = 10) on the taxi
pipeline's 10,000,000 x 4 projection's shape, with float64 and with
float32 cluster sums, timed the same way. One JSON line; needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def torch_sum_moments(X, w):
    """The moments with torch's own column sums (the form before
    ``xla_sum``), the yardstick of the order's cost."""
    import torch

    from orange3_spark_tpu_torch.ops.stats import EPS_TOTAL_WEIGHT

    tot = torch.clamp_min(w.sum(), EPS_TOTAL_WEIGHT)
    wcol = w[:, None]
    mean = (X * wcol).sum(dim=0) / tot
    var = ((X - mean) ** 2 * wcol).sum(dim=0) / tot
    return mean, var, tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="11000000x28,4000000x40,10000000x8")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("moments_order: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch.models.kmeans import _lloyd_step
    from orange3_spark_tpu_torch.ops.stats import weighted_moments

    line = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line(),
            "timed": "CUDA events, 5 calls after a warm-up, in turns, twice", "shapes": {}}
    ok = True
    for spec in args.shapes.split(","):
        n, d = (int(v) for v in spec.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(n + d)
        X = torch.randn(n, d, generator=gen, device="cuda") * 3.0 + 1.0
        w = torch.rand(n, generator=gen, device="cuda") * 2.0
        times: dict[str, list[float]] = {"xla_order": [], "torch_sum": []}
        for _ in range(2):
            for name, fn in (("xla_order", weighted_moments), ("torch_sum", torch_sum_moments),
                             ("torch_sum", torch_sum_moments), ("xla_order", weighted_moments)):
                times[name].append(cs.cuda_ms(lambda fn=fn: fn(X, w), 5, warmup=1))
        card = [t.cpu() for t in weighted_moments(X, w)]
        cpu = weighted_moments(X.cpu(), w.cpu())
        same = all(torch.equal(a, b) for a, b in zip(card, cpu))
        ok = ok and same
        line["shapes"][spec] = {"ms": times, "card_equals_cpu": same,
                                "extra_ms": min(times["xla_order"]) - min(times["torch_sum"])}
        del X, w
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(4)
    Z = torch.randn(10_000_000, 4, generator=gen, device="cuda")
    ones = torch.ones(Z.shape[0], device="cuda")
    c0 = Z[:10].clone()
    times = {"float64_sums": [], "float32_sums": []}
    for _ in range(2):
        for name, wide in (("float64_sums", True), ("float32_sums", False),
                           ("float32_sums", False), ("float64_sums", True)):
            times[name].append(cs.cuda_ms(
                lambda wide=wide: _lloyd_step(Z, ones, c0, 1e-4, 10, torch.float32, wide),
                5, warmup=1))
    line["lloyd_step_10000000x4_k10"] = {
        "ms": times, "extra_ms": min(times["float64_sums"]) - min(times["float32_sums"])}
    print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
