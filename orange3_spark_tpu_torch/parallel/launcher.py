"""Multi-process training coordinator.

Port of ``orange3_spark_tpu/parallel/launcher.py``. ``MultihostLauncher``
is to training what ``fleet/supervisor.py`` is to serving: it spawns N
training processes as one GANG that joins through ``torch.distributed``
(``core/session.TorchSession.initialize_distributed``), watches them, and
owns the resilience ladder —

  * ranks are fresh interpreters (``Popen``, ``start_new_session=True``),
    never forks of a process that holds a CUDA context; each gets its rank,
    the world size, the model-parallel size and a rendezvous (``OTPU_RANK``,
    ``OTPU_WORLD_SIZE``, ``OTPU_MODEL_PARALLEL``, ``OTPU_INIT_METHOD``): a
    FileStore file fresh for each gang attempt, or ``tcp://`` on
    ``OTPU_MULTIHOST_COORD_PORT``;
  * a rank that dies (crash, SIGKILL, OOM) is detected TYPED within the
    poll interval: the collective the survivors are blocked in can never
    complete, so the launcher kills the process group of every other rank
    (``utils/procs.kill_process_group``) instead of letting it hang;
  * the whole gang restarts after a seeded exponential backoff
    (``resilience/retry.RetryPolicy``, the supervisor's schedule), up to
    ``OTPU_MULTIHOST_RESTARTS`` times;
  * before each restart the per-rank epoch-boundary checkpoints are
    ALIGNED to the newest step every rank holds (a kill can land between
    two ranks' saves), so the resumed gang re-enters lockstep at one
    common step;
  * a gang still running past ``OTPU_MULTIHOST_WALL_S`` is a WEDGE, not a
    slow fit: it is killed and counted as a lost host.

Budget exhausted -> :class:`HostLostError` (typed, carrying the rank, exit
code and log tail) — never a hang.

``cross_process_collectives_supported()`` is the ONE probe for "can this
torch run a 2-rank gloo gang here": tests skip on its negative verdict with
its reason, and ``chip_smoke.py``'s multihost phase fails on it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import uuid

from orange3_spark_tpu_torch.core.session import (
    ENV_INIT, ENV_MODEL_PARALLEL, ENV_RANK, ENV_WORLD_SIZE,
)
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.resilience.retry import RetryPolicy
from orange3_spark_tpu_torch.utils import knobs
from orange3_spark_tpu_torch.utils.procs import kill_process_group

__all__ = ["HostLostError", "GangResult", "MultihostLauncher",
           "cross_process_collectives_supported"]

_M_GANGS = REGISTRY.counter(
    "otpu_multihost_gang_starts_total",
    "Training-gang launches (initial attempts plus restarts).")
_M_LOST = REGISTRY.counter(
    "otpu_multihost_hosts_lost_total",
    "Training processes lost mid-gang (crash/SIGKILL/wall-budget wedge).")
_M_RESTARTS = REGISTRY.counter(
    "otpu_multihost_gang_restarts_total",
    "Gang restarts taken after a lost host (resume from aligned "
    "epoch-boundary checkpoints).")


class HostLostError(RuntimeError):
    """A training rank died (or the gang wedged) and the restart budget is
    spent.

    Typed — the launcher never lets a dead rank surface as a hang: the
    surviving ranks' collectives are killed with it. Carries the first
    failed ``rank`` (-1 for a wall-budget wedge with no dead process), its
    exit code, the restarts already taken, and the rank's log tail."""

    def __init__(self, rank: int, returncode, restarts: int, tail: str = ""):
        self.rank, self.returncode, self.restarts = rank, returncode, restarts
        self.tail = tail
        what = ("wedged past the OTPU_MULTIHOST_WALL_S budget" if rank < 0
                else f"rank {rank} exited {returncode}")
        super().__init__(f"multihost gang lost: {what} after {restarts} gang "
                         f"restart(s); log tail:\n{tail}")


@dataclasses.dataclass
class GangResult:
    """One successful gang run (possibly after restarts)."""
    n_processes: int
    gang_starts: int
    gang_restarts: int
    hosts_lost: int
    wall_s: float
    coord_addr: str
    log_paths: list


def _tail(path: str, n_bytes: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n_bytes))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class MultihostLauncher:
    """Spawn and supervise one N-process training gang.

    ``argv_for_rank(rank, n_processes, coord_addr) -> list[str]`` builds
    each rank's command line (usually ``python -m
    orange3_spark_tpu_torch.parallel.mh_worker ...``); ``coord_addr`` is the
    gang's rendezvous (the ``init_method`` of ``init_process_group``), also
    in the rank's environment. Ranks log to per-rank files under
    ``log_dir`` (pipes would deadlock a chatty gang)."""

    def __init__(self, argv_for_rank, n_processes: int | None = None, *,
                 env: dict | None = None, log_dir: str | None = None,
                 max_gang_restarts: int | None = None, wall_s: float | None = None,
                 coord_port: int | None = None, align_ckpt_dir: str | None = None,
                 model_parallel: int = 1, poll_s: float = 0.05, seed: int = 0):
        self.argv_for_rank = argv_for_rank
        self.n = int(n_processes or (knobs.get_int("OTPU_MULTIHOST_PROCS") or 2))
        self.env = dict(env) if env is not None else dict(os.environ)
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="otpu-mh-")
        os.makedirs(self.log_dir, exist_ok=True)
        self.max_gang_restarts = (knobs.get_int("OTPU_MULTIHOST_RESTARTS")
                                  if max_gang_restarts is None else int(max_gang_restarts))
        self.wall_s = (knobs.get_float("OTPU_MULTIHOST_WALL_S")
                       if wall_s is None else float(wall_s))
        self.coord_port = (knobs.get_int("OTPU_MULTIHOST_COORD_PORT")
                           if coord_port is None else int(coord_port))
        self.align_ckpt_dir = align_ckpt_dir
        self.model_parallel = int(model_parallel)
        self.poll_s = poll_s
        # the supervisor's seeded backoff schedule, one ladder per gang
        self._policy = RetryPolicy.from_env(seed=seed)

    # ------------------------------------------------------------ restarts
    @staticmethod
    def align_checkpoints(ckpt_dir: str, n_processes: int, model_parallel: int = 1) -> int:
        """Coordinated-resume rule: every rank must re-enter the gang at ONE
        common step (a kill can land after rank 0's epoch save but before
        rank 1's — mismatched resume points break the lockstep collectives).
        The common step is the newest one ALL ranks can reach: the minimum
        saved step. A rank holding a different step gets a COPY of a
        common-step donor snapshot of its own model index — legal because
        the ranks of one model index hold the same bits (the rank-order
        folds give every rank the same sums; ``parallel/drill.py`` asserts
        it). If no rank holds a usable snapshot (common == 0), or a model
        index has no donor, all checkpoints are dropped and the gang
        restarts from scratch. Returns the common step."""
        steps = {}
        for rank in range(n_processes):
            path = os.path.join(ckpt_dir, f"rank{rank}.ckpt")
            try:
                with open(path, "rb") as f:
                    steps[rank] = int(pickle.load(f)["step"])
            except (OSError, KeyError, ValueError, EOFError, pickle.UnpicklingError):
                steps[rank] = 0
        common = min(steps.values()) if steps else 0
        donors = {}
        for rank, step in steps.items():
            if step == common:
                donors.setdefault(rank % model_parallel, rank)
        if common == 0 or len(donors) < min(model_parallel, n_processes):
            for rank in steps:
                try:
                    os.unlink(os.path.join(ckpt_dir, f"rank{rank}.ckpt"))
                except OSError:
                    pass
            return 0
        for rank, step in steps.items():
            if step != common:
                shutil.copyfile(os.path.join(ckpt_dir, f"rank{donors[rank % model_parallel]}.ckpt"),
                                os.path.join(ckpt_dir, f"rank{rank}.ckpt"))
        return common

    # ----------------------------------------------------------------- run
    def _coord(self) -> str:
        """A rendezvous fresh for this attempt."""
        if self.coord_port:
            return f"tcp://127.0.0.1:{self.coord_port}"
        return "file://" + os.path.join(os.path.abspath(self.log_dir),
                                        f"gang-{uuid.uuid4().hex}.store")

    def run(self) -> GangResult:
        t0 = time.perf_counter()
        restarts = lost = 0
        log_paths = [os.path.join(self.log_dir, f"rank{r}.log") for r in range(self.n)]
        while True:
            _M_GANGS.inc()
            coord = self._coord()
            procs, logs = [], []
            try:
                for r in range(self.n):
                    f = open(log_paths[r], "ab")
                    logs.append(f)
                    env = dict(self.env, **{ENV_RANK: str(r), ENV_WORLD_SIZE: str(self.n),
                                            ENV_INIT: coord,
                                            ENV_MODEL_PARALLEL: str(self.model_parallel)})
                    procs.append(subprocess.Popen(
                        self.argv_for_rank(r, self.n, coord), stdout=f,
                        stderr=subprocess.STDOUT, env=env, start_new_session=True))
                failed_rank, failed_rc = self._watch(procs)
            finally:
                # a rank blocked in a collective after a peer died never
                # outlives this: its whole process group is killed
                for p in procs:
                    if p.poll() is None:
                        kill_process_group(p, grace_s=0.0, drain_s=2.0)
                for f in logs:
                    f.close()
                if coord.startswith("file://"):
                    try:
                        os.unlink(coord[len("file://"):])
                    except OSError:
                        pass
            if failed_rank is None:
                return GangResult(n_processes=self.n, gang_starts=restarts + 1,
                                  gang_restarts=restarts, hosts_lost=lost,
                                  wall_s=round(time.perf_counter() - t0, 3),
                                  coord_addr=coord, log_paths=log_paths)
            lost += 1
            _M_LOST.inc()
            tail = _tail(log_paths[max(failed_rank, 0)])
            if restarts >= self.max_gang_restarts:
                raise HostLostError(failed_rank, failed_rc, restarts, tail)
            _M_RESTARTS.inc()
            if self.align_ckpt_dir:
                self.align_checkpoints(self.align_ckpt_dir, self.n, self.model_parallel)
            time.sleep(self._policy.delay(restarts))
            restarts += 1

    def _watch(self, procs) -> tuple:
        """Poll the gang. Returns ``(None, None)`` when every rank exited 0;
        otherwise the first failed rank and its exit code (``(-1, None)``
        for a wall-budget wedge)."""
        deadline = time.monotonic() + self.wall_s
        while True:
            codes = [p.poll() for p in procs]
            for r, rc in enumerate(codes):
                if rc is not None and rc != 0:
                    return r, rc
            if all(rc == 0 for rc in codes):
                return None, None
            if time.monotonic() >= deadline:
                return -1, None
            time.sleep(self.poll_s)


# ===================================================== capability probe

_PROBE_SRC = r"""
import sys
import torch
import torch.distributed as dist
rank, n, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n)
parts = [torch.zeros(2) for _ in range(n)]
dist.all_gather(parts, torch.tensor([rank + 1.0, 2.0 * rank]))
total = sum(float(p[0]) for p in parts)
assert total == n * (n + 1) / 2, total
dist.destroy_process_group()
print("OTPU_PROBE gloo gather", total, flush=True)
"""


def _probe_cache_path() -> str:
    import torch

    key = hashlib.sha1(_PROBE_SRC.encode()).hexdigest()[:8]
    return os.path.join(tempfile.gettempdir(),
                        f"otpu_torch_xproc_{os.getuid()}_{torch.__version__}_{key}.json")


def cross_process_collectives_supported(*, force_refresh: bool = False):
    """-> ``(ok, reason)``: can this torch run a REAL 2-rank gloo gang here?
    Probes once (two fresh interpreters join through a FileStore and
    all_gather) and caches the verdict per torch version in the temp dir
    (own-uid files only). A negative verdict is cached only when gloo is
    missing from this torch (definitive), so a transient failure re-probes
    next run. ``reason`` names the torch version: it is the skip message of
    every multi-process test."""
    import torch
    import torch.distributed as dist

    ver = torch.__version__
    cache = _probe_cache_path()
    if not force_refresh:
        try:
            if os.stat(cache).st_uid == os.getuid():
                with open(cache) as f:
                    d = json.load(f)
                return bool(d["ok"]), str(d.get("reason", ""))
        except (OSError, ValueError, KeyError):
            pass
    if not (dist.is_available() and dist.is_gloo_available()):
        ok, reason, definitive = False, f"torch {ver} has no gloo backend", True
    else:
        d = tempfile.mkdtemp(prefix="otpu-probe-")
        init = "file://" + os.path.join(d, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", _PROBE_SRC, str(i), "2", init],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  env=env, start_new_session=True) for i in range(2)]
        outs, timed_out = [], False
        try:
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=120)
                    outs.append(out.decode(errors="replace"))
                except subprocess.TimeoutExpired:
                    timed_out = True
                    kill_process_group(p, grace_s=0.0, drain_s=2.0)
                    outs.append("<probe timeout>")
        finally:
            for p in procs:
                if p.poll() is None:
                    kill_process_group(p, grace_s=0.0, drain_s=2.0)
            shutil.rmtree(d, ignore_errors=True)
        ok = (not timed_out) and all(p.returncode == 0 for p in procs)
        tail = "\n".join(o.strip()[-400:] for o in outs)
        reason = "" if ok else f"torch {ver} cannot run a 2-rank gloo gang here: {tail}"
        definitive = ok
    if definitive:
        tmp = cache + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"ok": ok, "reason": reason}, f)
            os.replace(tmp, cache)
        except OSError:
            pass
    return ok, reason
