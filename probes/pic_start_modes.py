#!/usr/bin/env python3
"""PowerIterationClustering's start against its 1-D k-means, on the CPU:

    python3 probes/pic_start_modes.py [--nodes 20000 400000]

For planted-partition graphs at com-LiveJournal's mean degree (equal
communities, and the first sourcing 60 % of the edges), from the random
and the degree start: the share of nodes ``assign_clusters`` puts in the
planted community, the share that the sign of the 20-step
pseudo-eigenvector's deviation from its mean puts there, and the
vector's relative spread (the standard deviation over the mean). The
k-means assigns by float32's matmul identity, so a spread far below
float32's resolution of |x|^2 leaves it blind where the vector itself
still separates. One JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[20_000, 400_000])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.datasets import (
        LIVEJOURNAL_EDGES, LIVEJOURNAL_NODES, make_planted_graph,
    )
    from orange3_spark_tpu_torch.models.power_iteration import (
        EdgeLayout, PowerIterationClustering, power_iterate,
    )

    def share(mask, planted) -> float:
        hit = float(np.mean(mask == planted))
        return max(hit, 1.0 - hit)

    rows = []
    for n in args.nodes:
        planted = np.arange(n) >= n // 2
        for first_share in (None, 0.6):
            graph = make_planted_graph(n, n * LIVEJOURNAL_EDGES // LIVEJOURNAL_NODES,
                                       first_share=first_share)
            layout = EdgeLayout(*graph, n, "cpu")
            for mode in ("random", "degree"):
                pic = PowerIterationClustering(k=2, max_iter=20, init_mode=mode, seed=0)
                assign = pic.assign_clusters(graph, device="cpu")
                if mode == "degree":
                    deg = layout.deg.to(torch.float64)
                    v0 = (deg / deg.sum()).to(torch.float32)
                else:
                    r = np.random.default_rng(0).random(n).astype(np.float32)
                    v0 = torch.from_numpy(r / r.sum())
                v = power_iterate(layout, v0, 20).to(torch.float64).numpy()
                rows.append({"nodes": n, "first_share": first_share, "start": mode,
                             "assign_clusters_planted": share(assign == 1, planted),
                             "vector_sign_planted": share(v > v.mean(), planted),
                             "vector_relative_spread": float(v.std() / v.mean()),
                             "sizes": np.bincount(assign, minlength=2).tolist()})
    print(json.dumps({"pic_start_modes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
