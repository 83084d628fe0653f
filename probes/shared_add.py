#!/usr/bin/env python3
"""Measure shared-memory atomic adds on the card and show what they compile to.

    python3 probes/shared_add.py [--out DIR]

Builds ``probes/shared_add.cu`` with nvcc for ``sm_90a``, prints the atomic
opcodes that ``cuobjdump -sass`` finds in it and in the package's kernels
(``orange3_spark_tpu_torch/ops/csrc``), and times each kind of add at random
addresses (4,096 cells of up to 16 bytes per block), at 96 hot ones (32 bins
x 3 stats, one feature's histogram at tree level 0), and at random cells that
put a warp's 32 lanes in 32 different banks. Prints one JSON line; the full
SASS listings go to ``DIR`` (default ``probes/_out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# name: (kind in shared_add.cu, float or integer adds per operation)
KINDS = {"f32_atomicAdd": (0, 1), "f32_red": (1, 1), "u32_atomicAdd_const": (2, 1),
         "u64_atomicAdd": (3, 1), "u32_atomicAdd": (4, 1), "fix64_carry": (5, 1),
         "f32x2_cas64": (6, 2), "f32x3_cas128": (7, 3)}
ATOMIC_OP = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|REDS|REDG|RED)(?:\.[A-Z0-9_]+)*)")


def sass_atomics(lib: Path, out_dir: Path) -> dict[str, list[str]]:
    """{kernel: sorted atomic opcodes} from the library's SASS."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    (out_dir / f"{lib.stem}.sass").write_text(text)
    found: dict[str, set[str]] = {}
    fn = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn is not None:
            for op in ATOMIC_OP.findall(line):
                found.setdefault(fn, set()).add(op)
    return {k: sorted(v) for k, v in found.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "probes" / "_out"))
    args = ap.parse_args()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    sys.path.insert(0, str(ROOT))
    from orange3_spark_tpu_torch.ops import cuda_build

    cuda_build.build()
    build = out_dir / "libshared_add_probe.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(build),
                    str(ROOT / "probes" / "shared_add.cu")], check=True,
                   capture_output=True, text=True)
    sass = {"probe": sass_atomics(build, out_dir)}
    for src in sorted(cuda_build.CSRC.glob("*.cu")):
        sass[src.stem] = sass_atomics(cuda_build.library_path(src.stem), out_dir)

    lib = ctypes.CDLL(str(build))
    fn = lib.shared_add_probe
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_float),
                                        ctypes.POINTER(ctypes.c_ulonglong)]
    fn.restype = ctypes.c_int
    blocks, iters, reps = 132 * 2, 2048, 5
    rates = {}
    for pattern, n_addr, bank_free in (("random", 4096, 0), ("hot96", 96, 0),
                                       ("bank_free", 4096, 1)):
        for kind, (code, per_op) in KINDS.items():
            ms, counted = ctypes.c_float(), ctypes.c_ulonglong()
            rc = fn(code, blocks, n_addr, iters, reps, bank_free, ctypes.byref(ms),
                    ctypes.byref(counted))
            if rc != 0:
                raise RuntimeError(f"{kind}/{pattern}: cudaError {rc}")
            ops = blocks * 512 * iters
            rates[f"{kind}/{pattern}"] = {
                "ms": ms.value, "G_ops_per_s": ops / ms.value / 1e6,
                "G_adds_per_s": per_op * ops / ms.value / 1e6,
                "landed": counted.value, "expected_if_count": ops * (reps + 1)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"probe": "shared_add", "nvidia_smi": smi,
                      "blocks": blocks, "threads": 512, "iters": iters,
                      "sass_atomics": sass, "rates": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
