#!/usr/bin/env python3
"""Split a run of ``chip_smoke.py`` (or of any script that prints one JSON
line a phase) into the phases' walls, from the times its lines arrive:

    python3 probes/phase_walls.py --cwd DIR --out OUT.jsonl [-- python3 chip_smoke.py]

Runs the command (by default ``python3 -u chip_smoke.py``) in ``DIR``, copies
its standard output to ``OUT.jsonl`` and reads each line as it comes. A
phase's wall is the time from the line before it to its own line, so the
walls of a smoke that does not print ``phase_s`` itself (an older checkout)
are split the same way as one that does. Prints one JSON object: the exit
code, the whole wall, and ``[phase, seconds]`` in order.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cwd", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("cmd", nargs="*", default=["python3", "-u", "chip_smoke.py"])
    args = ap.parse_args(argv)
    cmd = args.cmd or ["python3", "-u", "chip_smoke.py"]

    t0 = last = time.perf_counter()
    walls = []
    with open(args.out, "w") as out:
        proc = subprocess.Popen(cmd, cwd=args.cwd, stdout=subprocess.PIPE, text=True)
        for line in proc.stdout:
            now = time.perf_counter()
            out.write(line)
            out.flush()
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and "phase" in obj:
                walls.append([obj["phase"], now - last])
                last = now
        rc = proc.wait()
    walls.append(["(after the last phase line)", time.perf_counter() - last])
    print(json.dumps({"cwd": args.cwd, "rc": rc, "wall_s": time.perf_counter() - t0,
                      "phase_walls": walls}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
