"""One rank of a MultihostLauncher training gang.

Run as::

    python -m orange3_spark_tpu_torch.parallel.mh_worker \\
        --rank R --nprocs N --coord INIT_METHOD \\
        --csv data.csv --class-col y --n-total ROWS --n-features D \\
        --chunk-rows C --epochs E --step-size LR --out-dir OUT \\
        [--ckpt-dir CK] [--die-after-saves K] [--model-parallel MP] \\
        [--device cuda|cpu] [--backend gloo] \\
        [--hashed --n-dims DIMS --optim-update RULE --cache-dtype DTYPE
         --reg-param REG]

Each rank joins the gang (``TorchSession.initialize_distributed``, when
N > 1), builds a ``DataParallelPartitioner`` (or ``SPMDPartitioner`` with
``--model-parallel``), streams ONLY its row block of the shared CSV through
``sharded_csv_chunk_source``, and runs the ordinary fit on the partitioner's
session — the estimator never knows how many ranks exist:
``StreamingLinearEstimator`` by default, or with ``--hashed`` the Criteo
hashed fit (``StreamingHashedLinearEstimator`` over the raw CSV, label in
column 0, 13 dense + 26 categorical columns). Epoch-boundary checkpoints
(``--ckpt-dir``) are the gang's resume points; rank 0 writes ``theta.npz``
and every rank writes ``host_R.json``: its goodput and device-memory ledger
(from the fit's ``run_report_``), its fit and epoch walls, its collective
seconds and bytes, its kernel launches and a digest of its theta's bits.

``--die-after-saves K`` arms the lost-host DRILL: the rank SIGKILLs its own
process right after its K-th checkpoint save lands — but only on a run that
started from scratch (a ``rankR.died`` marker disarms the bomb after the
restart, so the drill kills exactly once).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import time


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coord", default="")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--class-col", default="y")
    ap.add_argument("--n-total", type=int, required=True)
    ap.add_argument("--n-features", type=int, required=True)
    ap.add_argument("--chunk-rows", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--step-size", type=float, default=0.1)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--die-after-saves", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--hashed", action="store_true",
                    help="the Criteo hashed fit instead of the dense logistic fit")
    ap.add_argument("--n-dims", type=int, default=1 << 22)
    ap.add_argument("--optim-update", default="sparse_adagrad")
    ap.add_argument("--cache-dtype", default="packed")
    ap.add_argument("--reg-param", type=float, default=0.0,
                    help="the hashed fit's reg_param (decoupled decay of the sparse rules)")
    return ap.parse_args(argv)


def theta_digest(arrays) -> str:
    """sha256 of the arrays' bytes in order: equal digests are equal bits."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def _checkpointer(args):
    from orange3_spark_tpu_torch.utils.fault import StreamCheckpointer

    if not args.ckpt_dir:
        return None, 0
    os.makedirs(args.ckpt_dir, exist_ok=True)
    path = os.path.join(args.ckpt_dir, f"rank{args.rank}.ckpt")
    ck = StreamCheckpointer(path, every_steps=10 ** 9)
    resumed_from = ck.load()[0]
    marker = os.path.join(args.ckpt_dir, f"rank{args.rank}.died")
    if args.die_after_saves > 0 and not os.path.exists(marker):
        # the drill bomb: die right AFTER the Kth epoch snapshot lands on
        # disk (atomic rename done), the worst-case instant for the gang
        ck = _DieAfterSaves(path, every_steps=10 ** 9, after=args.die_after_saves,
                            marker=marker)
    return ck, resumed_from


def _replay_collectives(marks: list) -> dict:
    """The collectives of the replay epochs: the fit's collective totals at
    the end of its last epoch less those at the end of its first (in which a
    rank's gathers also wait for its peers' parse)."""
    if len(marks) < 2:
        return {k: 0 for k in marks[0]} if marks else {}
    return {k: marks[-1][k] - marks[0][k] for k in marks[0]}


def _fit(args, part, ck, stage_times):
    """The rank's fit: (model, theta arrays in a fixed order)."""
    import numpy as np

    if args.hashed:
        from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator

        src = part.shard_csv(args.csv, "", n_total=args.n_total, chunk_rows=args.chunk_rows)
        est = StreamingHashedLinearEstimator(
            n_dims=args.n_dims, n_dense=13, n_cat=26, chunk_rows=args.chunk_rows,
            epochs=args.epochs, step_size=args.step_size, reg_param=args.reg_param,
            loss="logistic", label_in_chunk=True, optim_update=args.optim_update,
            cache_dtype=args.cache_dtype, replay_granularity="epoch",
            checkpoint_every_epochs=1 if ck is not None else 0)
        model = est.fit_stream(src, session=part.session, cache_device=True, checkpointer=ck,
                               stage_times=stage_times)
        th = model.theta
        return model, [np.asarray(th[k].cpu()) for k in ("emb", "coef", "intercept")]
    from orange3_spark_tpu_torch.io.streaming import StreamingLinearEstimator

    src = part.shard_csv(args.csv, args.class_col, n_total=args.n_total,
                         chunk_rows=args.chunk_rows)
    est = StreamingLinearEstimator(
        loss="logistic", epochs=args.epochs, step_size=args.step_size,
        chunk_rows=args.chunk_rows, replay_granularity="epoch",
        checkpoint_every_epochs=1 if ck is not None else 0)
    model = est.fit_stream(src, n_features=args.n_features, session=part.session,
                           cache_device=True, checkpointer=ck, stage_times=stage_times)
    return model, [np.asarray(model.coef.cpu()), np.asarray(model.intercept.cpu())]


def main(argv=None) -> int:
    args = _parse(argv)
    import numpy as np

    from orange3_spark_tpu_torch.core.session import TorchSession
    from orange3_spark_tpu_torch.ops import segment_sum
    from orange3_spark_tpu_torch.parallel.collectives import (
        collective_stats, reset_collective_stats,
    )
    from orange3_spark_tpu_torch.parallel.partitioner import (
        DataParallelPartitioner, SPMDPartitioner,
    )

    mp = max(1, args.model_parallel)
    world = TorchSession.initialize_distributed(
        args.rank, args.nprocs, init_method=args.coord or None, backend=args.backend,
        model_parallel=mp)
    part = (SPMDPartitioner(world, model_parallel=mp, device=args.device) if mp > 1
            else DataParallelPartitioner(world, device=args.device))
    ck, resumed_from = _checkpointer(args)
    reset_collective_stats()
    segment_sum.segment_update_sorted.launches = 0
    segment_sum.segment_sum_sorted.launches = 0
    stage_times: dict = {}
    t0 = time.perf_counter()
    model, theta = _fit(args, part, ck, stage_times)
    part.session.synchronize()
    wall = time.perf_counter() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    report = getattr(model, "run_report_", None)
    rep = report.to_dict() if report is not None else {}
    host = {
        "rank": args.rank,
        "nprocs": args.nprocs,
        "data_index": world.data_index,
        "model_index": world.model_index,
        "backend": world.backend,
        "device": str(part.session.device),
        "rows_local": args.n_total // max(1, world.data_parallelism),
        "n_steps": int(model.n_steps_),
        "fit_wall_s": round(wall, 4),
        # epoch 1's wall, then the replay's (each ended by a device sync)
        "epoch_s": stage_times.get("epoch_s", []),
        "epochs": args.epochs,
        "resumed_from_step": int(resumed_from),
        "collectives": collective_stats(),
        "replay_collectives": _replay_collectives(stage_times.get("epoch_collectives", [])),
        "launches": {"segment_update_sorted": segment_sum.segment_update_sorted.launches,
                     "segment_sum_sorted": segment_sum.segment_sum_sorted.launches},
        "theta_sha256": theta_digest(theta),
        "goodput": rep.get("goodput", {}),
        "device_memory": rep.get("device_memory", {}),
    }
    with open(os.path.join(args.out_dir, f"host_{args.rank}.json"), "w") as f:
        json.dump(host, f)
    if args.rank == 0:
        names = ("emb", "coef", "intercept") if args.hashed else ("coef", "intercept")
        np.savez(os.path.join(args.out_dir, "theta.npz"), n_steps=np.asarray(model.n_steps_),
                 **dict(zip(names, theta)))
    TorchSession.shutdown_distributed()
    print(f"OTPU_LIVE mh_worker rank={args.rank} steps={model.n_steps_} "
          f"wall={wall:.3f}s resumed_from={resumed_from}", flush=True)
    return 0


def _die_now(marker: str) -> None:
    with open(marker, "w") as f:
        f.write("killed by --die-after-saves\n")
    os.kill(os.getpid(), signal.SIGKILL)


class _DieAfterSaves:
    """Checkpointer proxy that SIGKILLs the process right after its
    ``after``-th save completes — the drill's fault injector (the marker
    file is written FIRST so the restarted run disarms)."""

    def __init__(self, path: str, *, every_steps: int, after: int, marker: str):
        from orange3_spark_tpu_torch.utils.fault import StreamCheckpointer

        self._inner = StreamCheckpointer(path, every_steps=every_steps)
        self.path = self._inner.path
        self.every_steps = self._inner.every_steps
        self._after = after
        self._saves = 0
        self._marker = marker

    def save(self, step, state, meta=None):
        self._inner.save(step, state, meta)
        self._saves += 1
        if self._saves >= self._after:
            _die_now(self._marker)

    def maybe_save(self, step, state, meta=None):
        if step % self.every_steps != 0:
            return False
        self.save(step, state, meta)
        return True

    def load(self, expect_meta=None):
        return self._inner.load(expect_meta)

    def delete(self):
        self._inner.delete()


if __name__ == "__main__":
    sys.exit(main())
