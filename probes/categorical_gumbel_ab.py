#!/usr/bin/env python3
"""``categorical_gumbel`` of this tree against another tree's, on one card:

    python3 probes/categorical_gumbel_ab.py --parent DIR [--rounds 2] [--rows 327680]
        [--vocab 20000] [--sass]

DIR holds another checkout of the repository (``git archive`` of the
parent commit, unpacked into a git-ignored directory). Its
``ops/csrc/prng.cu`` is built with the package's nvcc flags into
``probes/_out/`` and launched through its own C interface (the block-a-draw
kernel that evaluates every element, or a bound-skip kernel given this
tree's table); this tree's kernel through ``ops/prng._launch_categorical``
(both builds' ptxas reports come from ``probes/_out/``). The draw is
Word2Vec's negatives at
``chip_smoke.py``'s cut (2^16 pairs x 5 = 327,680 rows) over the unigram^0.75
distribution of a Zipf(1.0) vocabulary of ``--vocab`` words, the law of
``datasets.make_zipf_corpus``, whose Word2Vec vocabulary ``chip_smoke.py``
draws from. Both kernels' draws are held bitwise equal over every row and to
the plain version on the first and last 4,096 rows; then each is timed by
CUDA events (5 launches after a warm-up) in turns, parent, change, change,
parent, ``--rounds`` times; with the share of elements this tree's kernel
evaluated (its measurement build), ptxas' report of both builds, and the
bounds from ``chip_smoke.categorical_work_sass`` (the function's floor and
a full evaluation). With ``--sass`` both libraries' SASS go to
``--out DIR`` (default ``probes/_out``) as ``prng_{parent,change}.sass``.
One JSON line; needs one CUDA device.
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
CHECK_ROWS = 4096 * 5


def _build(tree: str, name: str) -> tuple[ctypes.CDLL, str, str]:
    """``tree``'s ``prng.cu`` built with the package's flags into
    ``probes/_out/libprng_<name>.so``: the library, its path, nvcc's output
    (ptxas' report)."""
    from orange3_spark_tpu_torch.ops import cuda_build

    src = os.path.join(tree, "orange3_spark_tpu_torch", "ops", "csrc", "prng.cu")
    lib = os.path.join(OUT, f"libprng_{name}.so")
    os.makedirs(OUT, exist_ok=True)
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}'s prng.cu did not build:\n{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(lib)
    p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
    if hasattr(dll, "gumbel_values_launch"):        # the bound-skip kernel's interface
        dll.categorical_gumbel_launch.argtypes = [u, u, p, ll, ll, ll, p, p, p, i, p]
    else:                                           # the block-a-draw kernel's
        dll.categorical_gumbel_launch.argtypes = [u, u, p, ll, ll, ll, p, i, p]
    dll.categorical_gumbel_launch.restype = i
    return dll, lib, res.stdout + res.stderr


def zipf_logits(vocab: int):
    """log of the unigram^0.75 distribution of a Zipf(1.0) vocabulary
    (float32, XLA's log), as Word2Vec forms its negatives' logits."""
    import numpy as np

    freq = (1.0 / np.arange(1, vocab + 1, dtype=np.float64)) ** 0.75
    return (freq / freq.sum()).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a checkout of the tree to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--rows", type=int, default=327_680)
    ap.add_argument("--vocab", type=int, default=20_000)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", default=OUT, help="where --sass writes the listings")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("categorical_gumbel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch.ops import cuda_build, prng

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kind = torch.cuda.get_device_name(0)
    _, mem_bw, _ = cs.card_rates(kind)
    int_rate = cs.int32_rate()
    parent, parent_lib, parent_log = _build(os.path.abspath(args.parent), "parent")
    _, change_lib, change_log = _build(ROOT, "change")
    cuda_build.build(["prng"])
    if args.sass:
        for name, lib in (("parent", parent_lib), ("change", change_lib)):
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"prng_{name}.sass"), "w") as f:
                f.write(cs.sass_text(lib))
    sass = cs.categorical_work_sass()

    logits = prng._xla_log(torch.from_numpy(zipf_logits(args.vocab)).to(dev))
    key = prng.split(prng.split(prng.PRNGKey(0))[0])[1]
    rows, V = args.rows, args.vocab
    out_p = torch.empty(rows, dtype=torch.int32, device=dev)
    out_c = torch.empty_like(out_p)

    table = prng.gumbel_bucket_table(dev)
    with_table = hasattr(parent, "gumbel_values_launch")

    def parent_launch():
        stream = torch.cuda.current_stream().cuda_stream
        args_ = ((table.data_ptr(), out_p.data_ptr(), None) if with_table
                 else (out_p.data_ptr(),))
        err = parent.categorical_gumbel_launch(key[0], key[1], logits.data_ptr(), V, rows, 0,
                                               *args_, sms, stream)
        if err:
            raise RuntimeError(f"the parent's categorical_gumbel launch failed: cudaError {err}")

    def change_launch():
        prng._launch_categorical(key, logits, 0, out_c)

    parent_launch()
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    prng._launch_categorical(key, logits, 0, out_c, counts)
    torch.cuda.synchronize()
    evaluated, passes = (int(c) for c in counts.cpu())
    check = min(CHECK_ROWS, rows)
    first = prng.categorical_gumbel_reference(key, logits, check)
    last = prng.categorical_gumbel_reference(key, logits, check, first_row=rows - check)
    counted = out_c.clone()
    change_launch()
    line = {"device": kind, "nvidia_smi": cs.nvidia_smi_line(), "rows": rows, "V": V,
            "logits": f"Zipf(1.0)^0.75 over {V} words",
            "ptxas": {name: [ln.strip() for ln in log.splitlines()
                             if "ptxas info" in ln and ("Used" in ln or "Function" in ln)]
                      for name, log in (("parent", parent_log), ("change", change_log))},
            "bitwise_parent": torch.equal(out_p, out_c),
            "measurement_build_bitwise": torch.equal(counted, out_c),
            "bitwise_plain_first_last": [torch.equal(out_c[:check], first),
                                         torch.equal(out_c[rows - check:], last)],
            "evaluated": evaluated, "evaluated_share": evaluated / (rows * V),
            "evaluation_passes_per_row": passes / rows, "sass": sass}
    times: dict[str, list[float]] = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for who in ("parent", "change", "change", "parent"):
            fn = parent_launch if who == "parent" else change_launch
            times[who].append(cs.cuda_ms(fn, 5, warmup=1))
    elements = rows * V
    floor = cs._prng_bound(4 * rows + 4 * V, sass["floor"] * elements, mem_bw, int_rate)
    full = cs._prng_bound(4 * rows + 4 * V, sass["element"] * elements, mem_bw, int_rate)
    best = min(times["change"])
    line.update(ms=times, bound_ms=floor["bound_ms"], bound_by=floor["bound_by"],
                x_bound=best / floor["bound_ms"], x_bound_parent=min(times["parent"])
                / floor["bound_ms"], full_evaluation_bound_ms=full["bound_ms"],
                x_full_evaluation_bound=best / full["bound_ms"],
                speedup=min(times["parent"]) / best)
    print(json.dumps(line), flush=True)
    ok = (line["bitwise_parent"] and line["measurement_build_bitwise"]
          and all(line["bitwise_plain_first_last"]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
