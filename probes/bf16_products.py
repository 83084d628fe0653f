#!/usr/bin/env python3
"""The products of the dense linear fit's bf16 arm, at the width of
``bench.py --config dense_logreg`` (4,000,000 x 40, k = 2).

    python3 probes/bf16_products.py [--rows 4000000]

The fit's objective reads X twice an evaluation: the forward ``X @ B`` and
the coefficient gradient ``X^T G``. With ``compute_dtype='bfloat16'`` the
reference multiplies bf16 X by bf16 B with an f32 result, and f32 G by bf16
X with an f32 result. This probe asks the card's PyTorch:

- whether ``torch.mm(a, b, out_dtype=torch.float32)`` takes bf16 operands;
- how far the bf16 forward with an f32 result lies from the same product
  of the operands widened to f32 (each product of two bf16 values is exact
  in f32, so only the order of the sums differs);
- how far ``X^T G`` through G split into three bf16 parts (hi + lo + lo2 =
  G exactly) lies from ``X.float()^T G``;
- the time of each product and of the f32 ones, by CUDA events, beside
  the bytes each must move.

It prints one JSON line. TF32 stays at PyTorch's default (off for
matmuls), which it prints. Needs one CUDA device; exits non-zero without.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=4_000_000)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bf16_products: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    N, d, k = args.rows, 40, 2
    X32 = torch.randn((N, d), generator=gen, device=dev)
    Xb = X32.to(torch.bfloat16)
    Xw = Xb.float()
    B = (0.1 * torch.randn((d, k), generator=gen, device=dev)).to(torch.bfloat16)
    G = torch.randn((N, k), generator=gen, device=dev) * 2.5e-7

    out = {"probe": "bf16_products", "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "rows": N, "d": d, "k": k,
           "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision()}
    try:
        fwd = torch.mm(Xb, B, out_dtype=torch.float32)
        out["mm_out_dtype"] = str(fwd.dtype)
    except (RuntimeError, TypeError) as e:
        out["mm_out_dtype"] = f"refused: {type(e).__name__}: {e}"[:300]
        print(json.dumps(out), flush=True)
        return 1
    ref = Xw @ B.float()
    out["fwd_max_rel_err"] = float(((fwd - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    out["fwd_max_abs_err"] = float((fwd - ref).abs().max())

    def split3(g):
        hi = g.to(torch.bfloat16)
        r = g - hi.float()
        lo = r.to(torch.bfloat16)
        lo2 = (r - lo.float()).to(torch.bfloat16)
        return torch.cat([hi, lo, lo2], dim=1)

    G3 = split3(G)
    out["split_exact"] = bool(torch.equal(
        (G3[:, :k].float() + G3[:, k:2 * k].float()) + G3[:, 2 * k:].float(), G))
    P = torch.mm(Xb.T, G3, out_dtype=torch.float32)
    grad = (P[:, :k] + P[:, k:2 * k]) + P[:, 2 * k:]
    gref = Xw.T @ G
    g64 = Xw.double().T @ G.double()
    out["grad_max_rel_err_vs_f32"] = float(((grad - gref).abs() / gref.abs()).max())
    out["grad_max_rel_err_vs_f64"] = float(((grad.double() - g64).abs() / g64.abs()).max())
    out["f32_grad_max_rel_err_vs_f64"] = float(((gref.double() - g64).abs()
                                                / g64.abs()).max())
    Bf = B.float()
    out["ms"] = {
        "fwd_bf16_out_f32": _ms(lambda: torch.mm(Xb, B, out_dtype=torch.float32)),
        "grad_bf16_split3": _ms(lambda: torch.mm(Xb.T, split3(G), out_dtype=torch.float32)),
        "split3_only": _ms(lambda: split3(G)),
        "fwd_f32": _ms(lambda: X32 @ Bf),
        "grad_f32": _ms(lambda: X32.T @ G),
        "upcast_bf16_to_f32": _ms(lambda: Xb.float()),
    }
    out["bytes"] = {"X_bf16": Xb.numel() * 2, "X_f32": X32.numel() * 4,
                    "G_f32": G.numel() * 4, "G3_bf16": G3.numel() * 2}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
