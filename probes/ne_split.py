#!/usr/bin/env python3
"""Where the normal-equations kernel's time goes, by taking parts away.

    python3 probes/ne_split.py [--ratings 25000000]

Builds copies of ``ops/csrc/normal_equations.cu`` with one part of the
kernel removed (the copies give wrong sums and serve only to time) into
``probes/_out/``, one ``nvcc`` each, all started together:

  base            the kernel as it is
  no_sums         the tile's products and adds replaced by one add a row
  no_row_copies   the factor rows never copied into the ring (the keys and
                  weights still are)
  skeleton        both: the ring, the loop, the writes
  no_flush        the chunk flush (total += partial) removed
  no_row_loads    the operands loaded once a stage, not once a row

and times each on BASELINE config 4's user half-step (``make_movielens_
proxy``, a rank-16 fit of 10 iterations; CUDA events over 10 launches, two
rounds) at the fit's chunk (2^18) and at one chunk (no flush). Prints one
JSON line: each copy's registers and times, the kernel's blocks an SM, the
card. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "orange3_spark_tpu_torch", "ops", "csrc", "normal_equations.cu")


def _replace(s: str, old: str, new: str) -> str:
    if old not in s:
        raise SystemExit(f"ne_split: the kernel source changed; cannot find {old!r}")
    return s.replace(old, new)


def _no_sums(s):
    i = s.index("    if (__float_as_int(wt.w) < 0) {\n#pragma unroll")
    j = s.index("    x = nx;\n")
    return s[:i] + "    part[0] = __fadd_rn(part[0], x.x + y.y + wt.x + y3 + e1);\n" + s[j:]


def _no_row_copies(s):
    return _replace(s, "      cp_async<VEC>(stage_g + r * p.row + c * per,",
                    "      if (false) cp_async<VEC>(stage_g + r * p.row + c * per,")


def _no_flush(s):
    return _replace(s, "    if (__float_as_int(wt.w) < 0) {\n#pragma unroll",
                    "    if (false) {\n#pragma unroll")


def _no_row_loads(s):
    return _replace(s, "    const float* nrow = row + p.row;\n", "    const float* nrow = row;\n")


VARIANTS = {"base": lambda s: s, "no_sums": _no_sums, "no_row_copies": _no_row_copies,
            "skeleton": lambda s: _no_row_copies(_no_sums(s)), "no_flush": _no_flush,
            "no_row_loads": _no_row_loads}


def _load(path):
    lib = ctypes.CDLL(path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.normal_equations_sorted_launch.argtypes = [p, i, p, p, p, p, p, ll, p, i, p, p, p, p,
                                                   p, p]
    lib.normal_equations_sorted_launch.restype = i
    lib.normal_equations_max_rank.restype = i
    lib.normal_equations_piece_floats.argtypes = [i]
    lib.normal_equations_piece_floats.restype = ll
    lib.normal_equations_slices.argtypes = [i]
    lib.normal_equations_slices.restype = i
    lib.normal_equations_blocks_per_sm.argtypes = [i]
    lib.normal_equations_blocks_per_sm.restype = i
    lib.normal_equations_error_string.argtypes = [i]
    lib.normal_equations_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ratings", type=int, default=25_000_000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ne_split: no CUDA device", file=sys.stderr)
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

    out_dir = os.path.join(ROOT, "probes", "_out")
    os.makedirs(out_dir, exist_ok=True)
    src = open(SRC).read()
    procs = {}
    for name, edit in VARIANTS.items():
        cu = os.path.join(out_dir, f"ne_split_{name}.cu")
        with open(cu, "w") as f:
            f.write(edit(src))
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"libne_split_{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ne_split: {name} did not build:\n{log}")
        result[name] = {"registers": sorted(set(re.findall(r"Used (\d+) registers", log)))}
    sess = TorchSession()
    table = A.ratings_table(make_movielens_proxy(args.ratings), sess)
    est = A.ALS(**cs.MOVIELENS_ALS, n_users=MOVIELENS_USERS, n_items=MOVIELENS_ITEMS)
    model = est.fit(table)
    u = table.column("user").to(torch.int32)
    it = table.column("item").to(torch.int32)
    side = A._side_plan(u, it, table.column("rating"), table.W, MOVIELENS_USERS,
                        MOVIELENS_ITEMS, False, 1.0)
    plans = {"chunk_2^18": side(1 << 18), "one_chunk": side(table.n_pad)}
    for _round in range(2):
        for name in VARIANTS:
            lib = _load(os.path.join(out_dir, f"libne_split_{name}.so"))
            NE._lib = lambda lib=lib: lib
            result[name]["blocks_per_sm"] = lib.normal_equations_blocks_per_sm(16)
            for what, plan in plans.items():
                ms = cs.cuda_ms(lambda: NE.normal_equations_sorted(model.item_factors, plan),
                                10, warmup=2)
                result[name].setdefault(what + "_ms", []).append(ms)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
