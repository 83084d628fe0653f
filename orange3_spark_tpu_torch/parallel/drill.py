"""The lost-host drill — the top rung of the gang's failure ladder.

The PyTorch package's own copy of the JAX package's
``tools/multihost_drill.py`` (``run_drill``), over
``parallel/launcher.MultihostLauncher`` and ``parallel/mh_worker``:

  1. GANG UP: the launcher spawns N ranks over one shared CSV, each parsing
     only its row block.
  2. REFERENCE: the uninterrupted gang fits to completion -> theta_ref,
     plus per-rank goodput/ledger attribution.
  3. KILL: a fresh gang runs with ``--die-after-saves 1`` — the last rank
     SIGKILLs itself the instant its first epoch-boundary checkpoint lands
     (the worst moment: some ranks have saved, the victim just did).
  4. RECOVER: the launcher detects the lost rank TYPED (no hang), aligns
     every rank's checkpoint to the common step (a donor copy, valid only
     because the ranks hold the same bits, which the drill checks from the
     ranks' theta digests), and gang-restarts with seeded backoff; each
     rank fast-forwards its shard through the checkpointed prefix.
  5. VERIFY: the resumed fit's theta must equal theta_ref bitwise and
     resume exactly at the snapshot (0 lost work).

``run_drill(procs=1, rows=2048, epochs=3, chunk_rows=256, out_root=None,
device='cuda', env=None) -> dict``. Ranks run on ``device`` (each its own
process and CUDA context on a shared card), ``env`` is added to their
environment.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys
import tempfile

import numpy as np

#: the directory holding the package, which the ranks import it from
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_drill_csv(path: str, rows: int, d: int = 8, seed: int = 0) -> None:
    """The drill's data: ``d`` standard-normal features and a planted
    logistic label; ``%.9g`` round-trips float32 exactly."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, d)).astype(np.float32)
    w_true = rng.normal(size=(d,)).astype(np.float32)
    y = (X @ w_true + 0.1 * rng.normal(size=rows).astype(np.float32) > 0).astype(np.float32)
    header = ",".join([f"f{j}" for j in range(d)] + ["y"])
    np.savetxt(path, np.column_stack([X, y]), delimiter=",", fmt="%.9g", header=header,
               comments="")


def worker_env(extra: dict | None = None) -> dict:
    """This process's environment with the package's directory first on
    ``PYTHONPATH``, plus ``extra``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p and p != _ROOT])
    env.update(extra or {})
    return env


def read_gang(out_dir: str) -> tuple[dict, dict]:
    """(rank 0's theta arrays, {'host_R': rank R's record}) of a gang run."""
    theta = dict(np.load(os.path.join(out_dir, "theta.npz")))
    hosts = {}
    for p in sorted(glob.glob(os.path.join(out_dir, "host_*.json"))):
        with open(p) as f:
            hosts[os.path.splitext(os.path.basename(p))[0]] = json.load(f)
    return theta, hosts


def gang_global_chunks(path: str, class_col: str, n_total: int, chunk_rows: int,
                       n_ranks: int):
    """A one-process source of the global chunks a data-parallel gang of
    ``n_ranks`` steps on: chunk i is the ranks' i-th lockstep chunks of
    ``sharded_csv_chunk_source`` concatenated in rank order (weights ones
    where a rank's chunk has none). The reference arm a gang is held to."""
    from orange3_spark_tpu_torch.core.session import World
    from orange3_spark_tpu_torch.io.streaming import sharded_csv_chunk_source

    srcs = [sharded_csv_chunk_source(path, class_col, shard_total_rows=n_total,
                                     chunk_rows=chunk_rows, world=World(r, n_ranks))
            for r in range(n_ranks)]

    def open_stream():
        for parts in zip(*(s() for s in srcs)):
            X = np.concatenate([q[0] for q in parts])
            y = None if parts[0][1] is None else np.concatenate([q[1] for q in parts])
            if all(q[2] is None for q in parts):
                yield X, y, None
            else:
                yield X, y, np.concatenate([np.ones(len(q[0]), np.float32) if q[2] is None
                                            else q[2] for q in parts])

    return open_stream


def _gang(csv: str, n_total: int, d: int, out_dir: str, ckpt_dir: str, *, procs: int,
          epochs: int, chunk_rows: int, die: bool, device: str, env: dict):
    from orange3_spark_tpu_torch.parallel.launcher import MultihostLauncher

    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)

    def argv(rank: int, n: int, coord: str) -> list:
        a = [sys.executable, "-m", "orange3_spark_tpu_torch.parallel.mh_worker",
             "--rank", str(rank), "--nprocs", str(n), "--coord", coord,
             "--csv", csv, "--class-col", "y", "--n-total", str(n_total),
             "--n-features", str(d), "--chunk-rows", str(chunk_rows),
             "--epochs", str(epochs), "--step-size", "0.1", "--out-dir", out_dir,
             "--ckpt-dir", ckpt_dir, "--device", device]
        if die and rank == n - 1:
            a += ["--die-after-saves", "1"]
        return a

    lau = MultihostLauncher(argv, procs, env=env, log_dir=os.path.join(out_dir, "logs"),
                            align_ckpt_dir=ckpt_dir)
    res = lau.run()
    theta, hosts = read_gang(out_dir)
    return res, theta, hosts


def run_drill(procs: int = 1, rows: int = 2048, epochs: int = 3, chunk_rows: int = 256,
              out_root: str | None = None, device: str = "cuda",
              env: dict | None = None) -> dict:
    """Run all five rungs; returns the drill record."""
    root = out_root or tempfile.mkdtemp(prefix="otpu-mh-drill-")
    made_root = out_root is None
    os.makedirs(root, exist_ok=True)
    d = 8
    wenv = worker_env(env)
    try:
        csv = os.path.join(root, "drill.csv")
        write_drill_csv(csv, rows, d)
        res_a, theta_a, hosts = _gang(csv, rows, d, os.path.join(root, "a"),
                                      os.path.join(root, "a_ck"), procs=procs, epochs=epochs,
                                      chunk_rows=chunk_rows, die=False, device=device,
                                      env=wenv)
        res_b, theta_b, hosts_b = _gang(csv, rows, d, os.path.join(root, "b"),
                                        os.path.join(root, "b_ck"), procs=procs,
                                        epochs=epochs, chunk_rows=chunk_rows, die=True,
                                        device=device, env=wenv)
        parity = (np.array_equal(theta_a["coef"], theta_b["coef"])
                  and np.array_equal(theta_a["intercept"], theta_b["intercept"]))
        # the aligned restart's donor copy needs every rank's bits equal
        ranks_equal = all(len({h["theta_sha256"] for h in hs.values()}) == 1
                          for hs in (hosts, hosts_b))
        local_rows = -(-rows // procs)                # lockstep per-rank rows
        spe = -(-local_rows // chunk_rows)            # steps per epoch
        resumed = max(h.get("resumed_from_step", 0) for h in hosts_b.values())
        # 0 lost work: the resumed fit starts exactly at the snapshot the
        # kill followed (one trained epoch = spe steps)
        return {
            "procs": procs,
            "rows": rows,
            "epochs": epochs,
            "device": device,
            "hosts_lost": res_b.hosts_lost,
            "gang_restarts": res_b.gang_restarts,
            "gang_starts": res_b.gang_starts,
            "resume_parity_bitwise": bool(parity),
            "ranks_bitwise_equal": bool(ranks_equal),
            "resumed_from_step": int(resumed),
            "lost_work_steps": int(spe - resumed),
            "ref_steps": int(theta_a["n_steps"]),
            "wall_s": {"reference": res_a.wall_s, "drill": res_b.wall_s},
            "hosts": hosts,
        }
    finally:
        if made_root:
            shutil.rmtree(root, ignore_errors=True)
