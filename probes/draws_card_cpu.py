#!/usr/bin/env python3
"""Where the card's ``normal`` and ``gumbel`` draws (``ops/prng.py``) leave
the CPU's: for a few seeds, the count of differing draws and, at the first
differing element, each intermediate of XLA's log / log1p / erf_inv as
written out, on both devices:

    python3 probes/draws_card_cpu.py [--n 65536] [--seeds 0,7,2147483647]

One JSON line. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--seeds", default="0,7,2147483647")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("draws_card_cpu: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from orange3_spark_tpu_torch.ops import prng

    def steps(x):
        """The written-out log's intermediates of x (a float32 tensor)."""
        out = {"x": x}
        xs = x * x
        out["xs"] = xs
        num, den = (torch.full_like(x, float(np.float32(c[0])))
                    for c in (prng._LOG1P_NUM, prng._LOG1P_DEN))
        for a, b in zip(prng._LOG1P_NUM[1:], prng._LOG1P_DEN[1:]):
            num, den = prng._fma32(num, x, a), prng._fma32(den, x, b)
        out["num"], out["den"] = num, den
        out["ratio"] = num / den
        out["log"] = prng._xla_log(x + 1.0)
        out["log1p"] = prng._xla_log1p(x)
        return out

    res = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        key = prng.PRNGKey(seed)
        line = {}
        for name in ("normal", "gumbel"):
            draw = getattr(prng, name)
            a, b = draw(key, args.n, "cuda").cpu(), draw(key, args.n, "cpu")
            bad = (a != b).nonzero().flatten()
            line[name] = {"differ": int(bad.numel())}
            if bad.numel():
                i = int(bad[0])
                lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
                u = prng.uniform(key, args.n, "cpu", *((lo, 1.0) if name == "normal" else
                                                      (prng._F32_TINY, 1.0)))
                x = (-(u * u)) if name == "normal" else u
                xi = x[i:i + 1]
                sc, sg = steps(xi), steps(xi.cuda())
                line[name]["first"] = i
                line[name]["steps"] = {k: [float(sc[k][0]), float(sg[k][0].cpu()),
                                           bool(torch.equal(sc[k], sg[k].cpu()))] for k in sc}
                line[name]["values"] = [float(a[i]), float(b[i])]
        res[seed] = line
    print(json.dumps({"device": torch.cuda.get_device_name(0), "n": args.n, "by_seed": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
