#!/usr/bin/env python3
"""Time the libsvm parse of ``chip_smoke.py``'s ``libsvm_hashed`` file two
ways, on the host:

    python3 probes/libsvm_parse.py [--rows 524288] [--reps 2]

The file (``chip_smoke._libsvm_draw`` / ``_write_libsvm_file``: 26 pairs a
row, Zipf-drawn indices below 2^24) is written to a temporary directory
outside the checkout. Each arm reads it in ``libsvm_chunk_source``'s 4 MB
batches of lines: ``flat`` is ``io/libsvm._parse_flat`` (one numpy
conversion a batch, what the port runs), ``tokens`` the token-by-token
parse ``_parse_lines_tokens`` flattened to the same arrays. Both arms must
give the same arrays bitwise. Prints one JSON line: the seconds of each
arm (the best of ``--reps``), the write's seconds and the rows. Needs no
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batches(path):
    with open(path) as f:
        while True:
            lines = f.readlines(1 << 22)
            if not lines:
                return
            yield lines


def _tokens_flat(lines, parse_tokens):
    import numpy as np

    lab, rows = parse_tokens(lines, False)
    return (np.asarray(lab, np.float64), np.array([len(i) for i, _ in rows], np.int64),
            np.concatenate([i for i, _ in rows]), np.concatenate([v for _, v in rows]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 19)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    from orange3_spark_tpu_torch.io import libsvm

    tmp = tempfile.mkdtemp(prefix="libsvm_parse_")
    try:
        t0 = time.perf_counter()
        idx, dup, v_int, _, y = cs._libsvm_draw(args.rows, cs.LIBSVM["nnz"], seed=0)
        path = os.path.join(tmp, "pairs.svm")
        cs._write_libsvm_file(path, idx, dup, v_int, y)
        write_s = time.perf_counter() - t0
        del idx, dup, v_int, y
        arms = {"flat": lambda ls: libsvm._parse_flat(ls, False),
                "tokens": lambda ls: _tokens_flat(ls, libsvm._parse_lines_tokens)}
        best, outs = {}, {}
        for _ in range(args.reps):
            for name, parse in arms.items():
                t0 = time.perf_counter()
                got = [parse(ls) for ls in _batches(path)]
                s = time.perf_counter() - t0
                best[name] = min(best.get(name, s), s)
                outs[name] = [np.concatenate(part) for part in zip(*got)]
        equal = all(a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in zip(outs["flat"], outs["tokens"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"probe": "libsvm_parse", "rows": args.rows, "nnz": cs.LIBSVM["nnz"],
                      "write_s": write_s, "flat_s": best["flat"],
                      "tokens_s": best["tokens"], "speedup": best["tokens"] / best["flat"],
                      "bitwise_equal": equal, "reps": args.reps, "cpus": os.cpu_count()}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
