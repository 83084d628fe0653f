#!/usr/bin/env python3
"""Where the normal-equations kernel and the top-N spend their time.

    python3 probes/ne_variants.py [--ratings 25000000] [--sass]

On BASELINE config 4's data (``make_movielens_proxy``), after a rank-16
fit of 10 iterations: the kernel's user and item half-steps (CUDA events
over 10 launches) at the fit's chunk (2^18: a chunk change at about half
of the user ratings), with no chunk change (one chunk), and with every
weight 0.5 (no rating takes the aw == 1.0 path); then
``recommend_for_all_users(10)``'s parts on one row block (the product, the
top-n and top-(n + 1), the count of scores at or above the n-th, the sort
of the n by score and id, the rows picked again) and in all. With
``--sass`` it writes the kernel's SASS (``cuobjdump``) to
``probes/_out/normal_equations.sass``. One JSON line; needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ratings", type=int, default=25_000_000)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ne_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.datasets import (
        MOVIELENS_ITEMS, MOVIELENS_USERS, make_movielens_proxy,
    )
    from orange3_spark_tpu_torch.models import als as A
    from orange3_spark_tpu_torch.ops import cuda_build
    from orange3_spark_tpu_torch.ops import normal_equations as NE

    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}
    info = cuda_build.build(["normal_equations"]).get("normal_equations", {})
    out["ptxas"] = [ln.strip() for ln in info.get("log", "").splitlines()
                    if "registers" in ln or "spill" in ln]
    if args.sass:
        os.makedirs(os.path.join(ROOT, "probes", "_out"), exist_ok=True)
        lib = cuda_build.library_path("normal_equations")
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        with open(os.path.join(ROOT, "probes", "_out", "normal_equations.sass"), "w") as f:
            f.write(sass)
        out["sass_lines"] = len(sass.splitlines())
    sess = TorchSession()
    ratings = make_movielens_proxy(args.ratings)
    table = A.ratings_table(ratings, sess)
    est = A.ALS(**cs.MOVIELENS_ALS, n_users=MOVIELENS_USERS, n_items=MOVIELENS_ITEMS)
    model = est.fit(table)
    u = table.column("user").to(torch.int32)
    it = table.column("item").to(torch.int32)
    r = table.column("rating")
    n = table.n_pad
    half = torch.full_like(table.W, 0.5)
    for side, idx, oth, E, factors in (("user", u, it, MOVIELENS_USERS, model.item_factors),
                                       ("item", it, u, MOVIELENS_ITEMS, model.user_factors)):
        for name, chunk, w in (("chunk_2^18", 1 << 18, table.W), ("one_chunk", n, table.W),
                               ("weights_0.5", 1 << 18, half)):
            plan = A._side_plan(idx, oth, r, w, E, factors.shape[0], False, 1.0)(chunk)
            flags = int((plan.key < 0).sum())
            ms = cs.cuda_ms(lambda: NE.normal_equations_sorted(factors, plan), 10, warmup=1)
            out[f"{side}_{name}"] = {"ms": ms, "chunk_changes": flags}
            del plan
    U, V = model.user_factors, model.item_factors
    m, nn = V.shape[0], 10
    block = max(1, A.RECOMMEND_BLOCK_BYTES // (4 * m))
    Q = U[:block]
    parts = {}
    parts["mm"] = cs.cuda_ms(lambda: Q @ V.T, 5, 1)
    S = Q @ V.T
    parts["topk"] = cs.cuda_ms(lambda: torch.topk(S, nn, dim=1), 5, 1)
    parts["topk_n_plus_1"] = cs.cuda_ms(lambda: torch.topk(S, nn + 1, dim=1), 5, 1)
    vals, ids = torch.topk(S, nn + 1, dim=1)
    kth = vals[:, nn - 1:nn]
    # the pass that counted the scores at or above the n-th (replaced by
    # the (n + 1)-th score)
    parts["count_ge"] = cs.cuda_ms(lambda: (S >= kth).sum(dim=1), 5, 1)
    parts["order_keys"] = cs.cuda_ms(lambda: ids[:, :nn].gather(1, torch.argsort(
        A._order_keys(vals[:, :nn] + 0.0, ids[:, :nn], m), dim=1, descending=True)), 5, 1)
    redo = torch.nonzero((vals[:, nn] == vals[:, nn - 1]) | torch.isnan(vals).any(dim=1))
    parts["redo_rows_in_block"] = int(redo.numel())
    parts["block_rows"] = block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = model.recommend_for_all_users(nn)
    parts["recommend_for_all_users_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.recommend_for_all_users(nn)
    parts["recommend_again_s"] = time.perf_counter() - t0
    parts["rows"] = len(recs)
    out["recommend"] = parts
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
