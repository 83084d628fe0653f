#!/usr/bin/env python3
"""Times the segment kernels of several trees of this repository on the
same inputs, on one card, in turns (give the trees as parent, change,
change, parent): ``segment_update_sorted`` at three step-shaped inputs and
``segment_sum_sorted`` at the dense table gradient's inputs on the first
two key sets.

    python3 probes/segment_update_zipf.py --trees DIR [DIR ...] [--out FILE]

The inputs, made once from seeds by this tree's ``chip_smoke.py`` and
handed to every tree through a file:

* ``uniform``: 2^18 rows x 26 codes uniform over gen_criteo_csv's 200,000
  a column, hashed into 2^22 rows with the Criteo fit's salts (the
  synthetic Criteo step: no segment over 32 occurrences);
* ``criteo_zipf``: the same rows with Zipf(1.2) codes
  (``chip_smoke._criteo_zipf_keys``), with and without per-pair values;
* ``vw_zipf``: the first 2^17-row chunk of the value-weighted fit's libsvm
  draw (``chip_smoke._libsvm_draw``: Zipf-law indices, a pad where an index
  repeats), hashed with that fit's one salt, its values, the pads dead.

Each carries sparse_adagrad's state (a table and accumulators from a seed,
last-seen steps 0, step 5) and a seeded dl. Each tree runs in its own
process (its own package and build), after the trees' builds ran side by
side: device times from 20 captured launches (5 where a launch is slow),
and each update's table after one launch, which this process compares
across trees (the rows of short segments differing in their bits, which
should be none; the largest difference on rows of long ones). Prints one
JSON line a tree run and a summary line. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, C, D, VW_ROWS = 1 << 18, 26, 1 << 22, 1 << 17


def _inputs(path):
    """Makes the input sets on the card and saves them (on the host) to
    ``path``."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch.models.hashed_linear import HashedLinearParams, hashed_salts
    from orange3_spark_tpu_torch.ops.hashing import hash_columns

    dev = torch.device("cuda")
    salts = hashed_salts(HashedLinearParams(n_dims=D, n_dense=13, n_cat=C))
    rng = np.random.default_rng(0)
    codes = rng.integers(0, cs.CRITEO_CODES, (N, C), dtype=np.int32)
    uniform = torch.sort(hash_columns(torch.from_numpy(codes).to(dev), salts, D).reshape(-1),
                         stable=True)
    zipf = cs._criteo_zipf_keys(N, C, D, salts, dev)
    idx, dup, _, vals, _ = cs._libsvm_draw(VW_ROWS, C, seed=0)
    raw = torch.from_numpy(np.where(dup, -1, idx - 1).astype(np.int32)).to(dev)
    vw_salts = hashed_salts(HashedLinearParams(n_dims=D, n_dense=0, n_cat=C,
                                               value_weighted=True))
    keys = hash_columns(raw, vw_salts, D).masked_fill(raw < 0, D).reshape(-1)
    vw = torch.sort(keys, stable=True)
    vw_vals = torch.from_numpy(np.where(dup, 0.0, vals).astype(np.float32)).reshape(-1)
    gen = torch.Generator().manual_seed(1)
    sets = {}
    for name, (s_idx, order), rows, v in (
            ("uniform", uniform, N, None), ("criteo_zipf", zipf, N, None),
            ("criteo_zipf_values", zipf, N, cs._draw_vals(N * C, dev, seed=5).cpu()),
            ("vw_zipf", vw, VW_ROWS, vw_vals)):
        sets[name] = {"s_idx": s_idx.cpu(), "order": order.cpu(),
                      "dl": torch.randn((rows, 1), generator=gen) * 1e-4, "vals": v,
                      **cs._long_stats(s_idx, D)}
    state = {"emb": torch.randn((D, 1), generator=gen) * 0.01,
             "acc": torch.rand((D, 1), generator=gen)}
    torch.save({"sets": sets, "state": state}, path)
    return {k: {s: v[s] for s in ("long_segments", "long_occurrences", "longest_segment")}
            for k, v in sets.items()}


def _time(tree, path, out):
    """In a process of its own: ``tree``'s kernels on the saved inputs."""
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    import chip_smoke as cs
    from orange3_spark_tpu_torch.ops import segment_sum as ss

    data = torch.load(path)
    dev = torch.device("cuda")
    lr, reg = 0.04, 1e-5
    decay = float(np.float32(1.0) - np.float32(lr) * np.float32(reg))
    state = {k: v.to(dev) for k, v in data["state"].items()}
    line, tables = {"tree": tree, "nvidia_smi": cs.nvidia_smi_line()}, {}
    for name, st in data["sets"].items():
        s_idx, order, dl = (st[k].to(dev) for k in ("s_idx", "order", "dl"))
        vals = None if st["vals"] is None else st["vals"].to(dev)
        C_ = s_idx.numel() // dl.shape[0]

        def fresh():
            return ("adagrad", s_idx, order, C_, dl, state["emb"].clone(),
                    {"acc": state["acc"].clone()}, torch.zeros(D, dtype=torch.int32, device=dev),
                    torch.tensor(5, dtype=torch.int32, device=dev), lr, decay, reg, 0.0)

        once = fresh()
        ss.segment_update_sorted(*once, use_decay=True, vals=vals)
        tables[name] = once[5].cpu()
        work = fresh()
        slow = st["longest_segment"] > 10_000
        entry = {"update_ms": cs.graph_ms(
            lambda: ss.segment_update_sorted(*work, use_decay=True, vals=vals),
            5 if slow else 20)}
        if name in ("uniform", "criteo_zipf"):
            start = torch.ones_like(s_idx, dtype=torch.bool)
            start[1:] = s_idx[1:] != s_idx[:-1]
            seg = torch.cumsum(start, 0, dtype=torch.int32) - 1
            g = dl.index_select(0, order // C_)
            entry["sum_ms"] = cs.graph_ms(lambda: ss.segment_sum_sorted(g, seg, D),
                                          5 if slow else 20)
        line[name] = entry
    torch.save(tables, out)
    print(json.dumps(line), flush=True)
    return 0


def _compare(tables, path):
    """Across trees, each set's table after one update: how many rows whose
    segment has at most 32 occurrences differ in their bits, and the
    largest difference on the others."""
    import torch

    data = torch.load(path)
    out = {}
    for name, st in data["sets"].items():
        keys, counts = torch.unique_consecutive(st["s_idx"], return_counts=True)
        live = keys < D
        long_rows = torch.zeros(D, dtype=torch.bool)
        long_rows[keys[live & (counts > 32)].long()] = True
        base = tables[0][name]
        worst_short, worst_long = 0, 0.0
        for other in tables[1:]:
            t = other[name]
            worst_short = max(worst_short, int((t.view(torch.int32) != base.view(torch.int32))
                                               [~long_rows].sum()))
            if bool(long_rows.any()):
                worst_long = max(worst_long, float((t - base).abs()[long_rows].max()))
        out[name] = {"short_rows_differ": worst_short, "long_rows_max_abs_diff": worst_long}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="roots of the trees, in the order to run them")
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--tables", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("segment_update_zipf: no CUDA device", file=sys.stderr)
        return 2
    if args.time:
        return _time(args.time, args.inputs, args.tables)
    with tempfile.TemporaryDirectory(prefix="segment_update_zipf_") as tmp:
        path = os.path.join(tmp, "inputs.pt")
        lines = [{"inputs": _inputs(path)}]
        trees = [os.path.abspath(t) for t in args.trees]
        build = "from orange3_spark_tpu_torch.ops import cuda_build; cuda_build.build(['segment_sum'])"
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=t)
                 for t in dict.fromkeys(trees)]
        if any(p.wait() for p in procs):
            print("segment_update_zipf: a tree's build failed", file=sys.stderr)
            return 1
        runs = []
        for i, tree in enumerate(trees):
            tables = os.path.join(tmp, f"tables{i}.pt")
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", tree,
                                  "--inputs", path, "--tables", tables],
                                 capture_output=True, text=True, cwd=tree)
            if res.returncode:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            lines.append(json.loads(res.stdout.strip().splitlines()[-1]))
            runs.append((tree, torch.load(tables)))
            print(json.dumps(lines[-1]), flush=True)
        by_tree = {}
        for tree, tables in runs:
            by_tree.setdefault(tree, tables)
        lines.append({"agreement": _compare(list(by_tree.values()), path)})
    for line in (lines[0], lines[-1]):
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
