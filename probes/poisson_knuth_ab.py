#!/usr/bin/env python3
"""``poisson_knuth`` of this tree against another tree's, on one card:

    python3 probes/poisson_knuth_ab.py --parent DIR [--rounds 2] [--sass]
        [--tiles 2048,4096,8192]

DIR holds another checkout of the repository (``git archive`` of the
parent commit, unpacked into a git-ignored directory). Its
``ops/csrc/prng.cu`` is built with the package's nvcc flags into
``probes/_out/`` and launched through its own C interface, with its own
table of 16 subkeys a chain (the interface of the one-lane-a-thread
kernel); this tree's kernel through ``ops/prng._launch_knuth``. At the
forest's draw (20 trees x 10,737,856 rows, lam 1) and GBT's subsampled
round (one key, lam 0.8): both kernels' counts bitwise equal, then each
launch captured (10 in a graph) in turns, parent, change, change, parent,
``--rounds`` times; the share of issued lane-slots that did an iteration
(this tree's measurement build; the parent's worked out from the counts,
a warp of 32 consecutive lanes running its slowest lane's iterations);
ptxas' report of both builds, the pass of this tree's loop and the work
the function needs counted in SASS (``chip_smoke.knuth_sass``), and the
bound from that work. Then this tree's kernel at each of ``--tiles`` rows
a block, in turns forward and back, ``--rounds`` times, with each tile's
useful share. With ``--sass`` both libraries' SASS go to
``probes/_out/prng_{parent,change}.sass``. One JSON line; needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "probes", "_out")
PARENT_TABLE = 16       # the one-lane-a-thread kernel's table a chain


def _build_parent(parent: str) -> tuple[ctypes.CDLL, str, str]:
    from orange3_spark_tpu_torch.ops import cuda_build

    src = os.path.join(parent, "orange3_spark_tpu_torch", "ops", "csrc", "prng.cu")
    lib = os.path.join(OUT, "libprng_parent.so")
    os.makedirs(OUT, exist_ok=True)
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"the parent's prng.cu did not build:\n{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.poisson_knuth_launch.argtypes = [p, p, i, ll, ll, ctypes.c_float, p, i, p]
    dll.poisson_knuth_launch.restype = i
    return dll, lib, res.stdout + res.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a checkout of the tree to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--tiles", default="2048,4096,8192",
                    help="rows a block owns, timed against each other")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("poisson_knuth_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch.ops import cuda_build, prng

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kind = torch.cuda.get_device_name(0)
    _, mem_bw, _ = cs.card_rates(kind)
    int_rate = cs.int32_rate()
    parent, parent_lib, parent_log = _build_parent(os.path.abspath(args.parent))
    info = cuda_build.build(["prng"])
    if args.sass:
        for name, lib in (("parent", parent_lib), ("change", cuda_build.library_path("prng"))):
            with open(os.path.join(OUT, f"prng_{name}.sass"), "w") as f:
                f.write(cs.sass_text(lib))
    try:
        sass = cs.knuth_sass()
    except AssertionError as e:     # the times still come; the recount does not
        sass = {"error": str(e)[:4000]}
    work = sass.get("work")

    def parent_launch(packed, lam, out):
        T, n = out.shape
        stream = torch.cuda.current_stream().cuda_stream
        err = parent.poisson_knuth_launch(
            packed.data_ptr(), packed.data_ptr() + 4 * T * PARENT_TABLE * 2, PARENT_TABLE,
            T, n, float(np.float32(lam)), out.data_ptr(), sms, stream)
        if err:
            raise RuntimeError(f"the parent's poisson_knuth launch failed: cudaError {err}")

    def tile_launch(packed, lam, out, J, tile, slots=None):
        T, n = out.shape
        prng._launch("poisson_knuth", packed.data_ptr(), packed.data_ptr() + 4 * T * J * 2,
                     J, T, n, float(np.float32(lam)), tile, out.data_ptr(),
                     None if slots is None else slots.data_ptr(), dev=out.device)

    tiles = [int(t) for t in args.tiles.split(",") if t]

    cases = {"forest": (cs._forest_keys(0, cs.PRNG_TREES), 1.0),
             "gbt_round": ([prng.split(prng.PRNGKey(0))[1]], cs.PRNG_GBT_LAM)}
    line = {"device": kind, "nvidia_smi": cs.nvidia_smi_line(),
            "ptxas": {"parent": [ln.strip() for ln in parent_log.splitlines()
                                 if "ptxas info" in ln and "Used" in ln],
                      "change": [ln.strip() for ln in info.get("prng", {}).get("log", "")
                                 .splitlines() if "ptxas info" in ln and "Used" in ln]},
            "knuth_sass": sass}
    for name, (keys, lam) in cases.items():
        T, n = len(keys), cs.PRNG_ROWS
        J = prng.chain_table_size(lam)
        old = prng._knuth_table(keys, PARENT_TABLE, dev)
        new = prng._knuth_table(keys, J, dev)
        out_p = torch.empty((T, n), dtype=torch.int32, device=dev)
        out_c = torch.empty_like(out_p)
        parent_launch(old, lam, out_p)
        slots = torch.zeros(2, dtype=torch.int64, device=dev)
        prng._launch_knuth(new, lam, out_c, J, slots)
        torch.cuda.synchronize()
        counts = out_c.to(torch.int64)
        shares = cs._knuth_shares(counts, slots)
        iters, rows = int(counts.sum()) + counts.numel(), counts.numel()
        hash_only = cs._prng_bound(4 * rows, cs.HASH_INT_OPS * iters, mem_bw, int_rate)
        if work:    # no lane passes the table at these lams
            recount = cs._prng_bound(4 * rows, work["iteration"] * iters + work["row"] * rows,
                                     mem_bw, int_rate)
        times: dict[str, list[float]] = {"parent": [], "change": []}
        for _ in range(args.rounds):
            for who in ("parent", "change", "change", "parent"):
                fn = ((lambda: parent_launch(old, lam, out_p)) if who == "parent"
                      else (lambda: prng._launch_knuth(new, lam, out_c, J)))
                times[who].append(cs.graph_ms(fn, 10))
        line[name] = {"trees": T, "rows": n, "lam": lam, "chain_table": J,
                      "tile_rows": prng.KNUTH_TILE_ROWS,
                      "bitwise_parent": torch.equal(out_p, out_c),
                      "measurement_build_counts": shares["lane_iterations"] == iters,
                      "ms": times, "iterations": iters, **shares,
                      "hash_bound_ms": hash_only["bound_ms"],
                      "x_hash_bound": min(times["change"]) / hash_only["bound_ms"]}
        if work:
            line[name].update(bound_ms=recount["bound_ms"], bound_by=recount["bound_by"],
                              x_bound=min(times["change"]) / recount["bound_ms"],
                              x_bound_parent=min(times["parent"]) / recount["bound_ms"])
        by_tile: dict[int, dict] = {t: {"ms": []} for t in tiles}
        for t in tiles:
            slots = torch.zeros(2, dtype=torch.int64, device=dev)
            tile_launch(new, lam, out_p, J, t, slots)
            w, lanes = (int(v) for v in slots.cpu())
            by_tile[t].update(bitwise=torch.equal(out_p, out_c), useful_share=lanes / (32 * w),
                              blocks=T * -(-n // t))
        for _ in range(args.rounds):
            for t in tiles + tiles[::-1]:
                by_tile[t]["ms"].append(
                    cs.graph_ms(lambda t=t: tile_launch(new, lam, out_p, J, t), 10))
        line[name]["tiles"] = by_tile
        del out_p, out_c, counts
        torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    ok = all(line[c]["bitwise_parent"] and line[c]["measurement_build_counts"]
             and all(v["bitwise"] for v in line[c]["tiles"].values()) for c in cases)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
