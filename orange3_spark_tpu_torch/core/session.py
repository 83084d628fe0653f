"""TorchSession — the SparkSession equivalent of the PyTorch package.

The JAX package's ``TpuSession`` owns a device mesh: a ``data`` axis the
rows split over and a ``model`` axis the hashed table may split over, and
``jax.distributed`` joins the processes of a multi-host run. Here one
process is one rank on one device, and a session owns a ``torch.device``
and a ``World``: its rank, the world size, the model-parallel size and the
``torch.distributed`` groups. The ranks form the reference's mesh
``(world_size // model_parallel, model_parallel)`` in rank order: rank r
has data index ``r // mp`` and model index ``r % mp``. A session made
without ``initialize_distributed`` has a world of one rank and behaves as
the one-device session always did, bit for bit.

The backend is named, never switched behind the caller's back: 'gloo' runs
the collectives on host tensors (a CUDA tensor is staged through a pinned
host buffer, both ways: ``parallel/collectives.py``); 'nccl' raises
``BackendNotPortedError``.

The session runs on the GPU unless the caller asks for the CPU. With no
argument it selects ``cuda`` and raises when CUDA is absent: it never falls
back to the CPU by itself. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import threading

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: the launcher's environment for a rank (``parallel/launcher.py``)
ENV_RANK, ENV_WORLD_SIZE, ENV_INIT = "OTPU_RANK", "OTPU_WORLD_SIZE", "OTPU_INIT_METHOD"
ENV_MODEL_PARALLEL = "OTPU_MODEL_PARALLEL"


class BackendNotPortedError(NotImplementedError):
    """A ``torch.distributed`` backend this package does not run (NCCL
    waits for ROADMAP queue 1 item 6b: a machine with two or more cards)."""


class NoCrossRankFoldError(NotImplementedError):
    """An estimator given a session whose data parallelism is over 1 has no
    fold of its sums across the ranks in this package (ROADMAP queue 1 item
    6b). It raises rather than fit on the local rows alone."""


@dataclasses.dataclass(eq=False)
class World:
    """The ranks of one run. ``data_group`` holds the ranks that share this
    rank's model index (they read different row blocks), ``model_group``
    the ranks that share its data index (they own different table rows);
    each is None where it would hold this rank alone or where there is no
    process group."""

    rank: int = 0
    size: int = 1
    model_parallel: int = 1
    backend: str = "none"
    data_group: object = None
    model_group: object = None

    def __post_init__(self):
        mp = int(self.model_parallel)
        if mp < 1 or self.size % mp:
            raise ValueError(f"model_parallel={mp} does not divide the {self.size}-rank world")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is outside a world of {self.size}")

    @property
    def data_parallelism(self) -> int:
        return self.size // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel


def _make_groups(world: World) -> None:
    """Every rank creates every data and model group, in the same order
    (``new_group`` is collective over the whole world), and keeps its own."""
    import torch.distributed as dist

    mp, dp = world.model_parallel, world.data_parallelism
    if dp > 1:
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)]) if mp > 1 else dist.group.WORLD
            if m == world.model_index:
                world.data_group = g
    if mp > 1:
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)]) if dp > 1 else dist.group.WORLD
            if d == world.data_index:
                world.model_group = g


class TorchSession:
    """Owns the device and the world; get-or-create singleton like
    SparkSession."""

    _lock = threading.Lock()
    _active: "TorchSession | None" = None
    #: the session a ``use()`` block installed (thread/task-local)
    _ctx_active: contextvars.ContextVar = contextvars.ContextVar(
        "otpu_torch_session", default=None)
    #: what ``cache_dtype='auto'`` resolves to (io/codec.py): full compression
    default_cache_dtype: str = "packed"

    def __init__(self, device: str | torch.device | None = None, *,
                 world: World | None = None):
        if device is None:
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSession: no CUDA device is available; pass "
                "device='cpu' to run the port on the CPU")
        self.device = device
        self.world = world if world is not None else World()

    @classmethod
    def builder_get_or_create(
            cls, device: str | torch.device | None = None) -> "TorchSession":
        """``SparkSession.builder.getOrCreate()`` analogue."""
        with cls._lock:
            if cls._active is None or (
                    device is not None
                    and torch.device(device) != cls._active.device):
                cls._active = cls(device)
            return cls._active

    @classmethod
    def active(cls) -> "TorchSession":
        """The innermost ``use()`` block's session, else the singleton."""
        s = cls._ctx_active.get()
        return s if s is not None else cls.builder_get_or_create()

    @classmethod
    def current_world(cls) -> World:
        """The active session's world, without creating a session: a world
        of one rank where none is active."""
        s = cls._ctx_active.get() or cls._active
        return s.world if s is not None else World()

    @contextlib.contextmanager
    def use(self):
        """Install as the active session within this context (thread/task-
        local, so concurrent ``use()`` blocks can't clobber each other's
        view): a model unpickled inside lands on this session's device."""
        token = TorchSession._ctx_active.set(self)
        try:
            yield self
        finally:
            TorchSession._ctx_active.reset(token)

    # ------------------------------------------------------------ the world
    @staticmethod
    def initialize_distributed(rank: int | None = None, world_size: int | None = None, *,
                               init_method: str | None = None, backend: str = "gloo",
                               model_parallel: int | None = None,
                               timeout_s: float = 300.0) -> World:
        """Join this process to its gang: ``torch.distributed``'s process
        group from the arguments, or from the launcher's environment
        (``OTPU_RANK``, ``OTPU_WORLD_SIZE``, ``OTPU_INIT_METHOD``,
        ``OTPU_MODEL_PARALLEL``). ``init_method`` is a ``file://`` path (a
        FileStore) or ``tcp://host:port`` (a TCPStore), fresh for each gang
        attempt. A world of one rank makes no process group. Returns the
        ``World`` to give a session (``TorchSession(device, world=...)``)."""
        if backend == "nccl":
            raise BackendNotPortedError(
                "the 'nccl' backend is not ported: ROADMAP queue 1 item 6b (NCCL on a "
                "machine with two or more cards); use backend='gloo'")
        if backend != "gloo":
            raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
        env = os.environ
        rank = int(env.get(ENV_RANK, "0") if rank is None else rank)
        world_size = int(env.get(ENV_WORLD_SIZE, "1") if world_size is None else world_size)
        mp = int(env.get(ENV_MODEL_PARALLEL, "1") if model_parallel is None
                 else model_parallel)
        world = World(rank, world_size, mp, backend if world_size > 1 else "none")
        if world_size == 1:
            return world
        import torch.distributed as dist

        init_method = init_method or env.get(ENV_INIT)
        if not init_method:
            raise ValueError("a gang of more than one rank needs init_method= (or "
                             f"{ENV_INIT}): a file:// store path or tcp://host:port")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        _make_groups(world)
        return world

    @staticmethod
    def shutdown_distributed() -> None:
        """Leave the process group (a no-op without one)."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()

    # ------------------------------------------------------------ shardings
    @property
    def n_devices(self) -> int:
        return self.world.size

    @property
    def data_parallelism(self) -> int:
        return self.world.data_parallelism

    @property
    def model_parallelism(self) -> int:
        return self.world.model_parallel

    @property
    def data_index(self) -> int:
        return self.world.data_index

    @property
    def model_index(self) -> int:
        return self.world.model_index

    def pad_rows(self, n: int) -> int:
        """Smallest padded row count that divides evenly over the data
        parallelism: the JAX formula (at parallelism 1, ``n``, at least 1)."""
        dp = self.data_parallelism
        return max(dp, -(-n // dp) * dp)

    def require_fold(self, what: str) -> None:
        """Raise ``NoCrossRankFoldError`` when ``what`` (an estimator or an
        op) would run on a session whose rows are split over ranks: it has
        no cross-rank fold in this package."""
        if self.data_parallelism > 1:
            raise NoCrossRankFoldError(
                f"{what} has no fold across the {self.data_parallelism} data-parallel "
                "ranks of this session (ROADMAP queue 1 item 6b); it does not fit on "
                "the local rows alone")

    def synchronize(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
