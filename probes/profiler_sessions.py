#!/usr/bin/env python3
"""Why a ``torch.profiler`` test fails, and a later session crashes, in a
run of ``tests/test_torch_cuda.py`` that is not the first GPU process of a
machine's session:

    python3 probes/profiler_sessions.py [--repeat 3] [--rounds 20]

Each arm runs in a process of its own, so a crash shows as its exit code:

  pytest        ``pytest tests/test_torch_cuda.py --noconftest -k
                "capture_trace or small_wrangle"`` (the failing test and the
                one whose profiler exit crashed), ``--repeat`` times
  main          ``--rounds`` torch.profiler sessions on the main thread
                around CUDA work, then one more (``chip_smoke._profile_run``'s
                shape): the control
  thread        ``--rounds`` sessions opened and closed on a second thread
                while the main thread launches kernels throughout (the
                telemetry endpoint's shape), in plain torch; then one session
                on the main thread
  thread_port   the same through ``obs.prof.capture(200 ms)``, the port's
                deep capture
  thread_quiet  the second thread's sessions again, the main thread's
                launches stopped before each session closes
  first_main_thread, first_main_thread_port
                ``thread`` and ``thread_port`` after one session on the main
                thread (the first to start the profiler in the process)
  thread_export ``thread`` with each session's device events counted two
                ways: from ``prof.events()`` and from its Chrome trace

One JSON line a process, as it ends: its exit code (or "timeout" past
``--timeout`` seconds), the device events each session saw (its kernels
from ``prof.events()``, or from the capture's Chrome trace), and the error
lines of a failed run. ``--arms`` picks arms. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = ("main", "thread", "thread_port", "thread_quiet", "first_main_thread",
        "first_main_thread_port", "thread_export")


def _kernels(prof) -> int:
    from torch.autograd import DeviceType

    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def _child(arm: str, rounds: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x = torch.randn(1 << 20, device="cuda")

    def work():
        for _ in range(20):
            (x * 2.0).sum()
        torch.cuda.synchronize()

    seen = []
    if arm.startswith("first_main_"):    # one session on the main thread first
        with profile(activities=acts) as prof:
            work()
        seen.append(_kernels(prof))
        arm = arm[len("first_main_"):]
    for _ in range(rounds):
        if arm == "main":
            with profile(activities=acts) as prof:
                work()
            seen.append(_kernels(prof))
            continue
        out: dict = {}
        launching = threading.Event()
        launching.set()

        def session():
            if arm == "thread_port":
                from orange3_spark_tpu_torch.obs import prof as oprof

                oprof.reset_rate_limit()
                out["capture"] = oprof.capture(200.0, reason="probe")
                return
            with profile(activities=acts) as prof:
                time.sleep(0.2)
                if arm == "thread_quiet":
                    launching.clear()
                    time.sleep(0.05)
            out["kernels"] = _kernels(prof)
            if arm == "thread_export":      # the same session's Chrome trace
                path = os.path.join(os.environ["OTPU_PROF_DIR"], "trace.json")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f).get("traceEvents", [])
                out["kernels"] = [out["kernels"], sum(str(e.get("cat", "")).lower() == "kernel"
                                                      for e in events)]

        t = threading.Thread(target=session)
        t.start()
        while t.is_alive():
            if launching.is_set():
                work()
            else:
                time.sleep(0.001)
        t.join(60)
        if arm == "thread_port":
            sys.path.insert(0, ROOT)
            import chip_smoke as cs

            seen.append(cs._trace_kernel_events(out["capture"]["path"])["kernel_events"])
        else:
            seen.append(out.get("kernels", -1))
    with profile(activities=acts) as prof:
        work()
    return {"arm": arm, "kernels_each_session": seen, "kernels_last_session": _kernels(prof)}


def _errors(text: str) -> list[str]:
    keep = [ln for ln in text.splitlines()
            if ln.startswith(("E ", "FAILED", "Fatal Python error", "ERROR"))
            or re.search(r"\d+ (passed|failed)", ln)]
    return keep[:30]


def _run(cmd, timeout) -> dict:
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or b"").decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        return {"rc": "timeout", "s": timeout, "lines": _errors(out)}
    last = (res.stdout.strip().splitlines() or [""])[-1]
    return {"rc": res.returncode, "s": time.perf_counter() - t0,
            "result": json.loads(last) if last.startswith("{") else None,
            "lines": _errors(res.stdout + res.stderr) + res.stderr.strip().splitlines()[-3:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--arms", default=",".join(("pytest",) + ARMS))
    ap.add_argument("--timeout", type=float, default=150.0,
                    help="seconds a process may take (a hung one is reported so)")
    ap.add_argument("--child", choices=ARMS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profiler_sessions: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        import shutil
        import tempfile

        sys.path.insert(0, ROOT)
        tmp = tempfile.mkdtemp(prefix="profiler_sessions_")
        os.environ["OTPU_PROF_DIR"] = os.path.join(tmp, "prof")
        os.environ["OTPU_FLIGHT_DIR"] = os.path.join(tmp, "flight")
        try:
            print(json.dumps(_child(args.child, args.rounds)), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return 0
    print(json.dumps({"torch": torch.__version__, "device": torch.cuda.get_device_name(0)}),
          flush=True)
    for arm in args.arms.split(","):
        for k in range(args.repeat):
            if arm == "pytest":
                cmd = [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "--noconftest",
                       "-q", "-p", "no:randomly", "-p", "no:cacheprovider", "-rA", "-k",
                       "capture_trace or small_wrangle"]
            else:
                cmd = [sys.executable, os.path.abspath(__file__), "--child", arm,
                       "--rounds", str(args.rounds)]
            print(json.dumps({"arm": arm, "run": k, **_run(cmd, args.timeout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
