"""SPMD partitioners — one object owns the multi-process training geometry.

Port of ``orange3_spark_tpu/parallel/partitioner.py``. A partitioner owns
the world (``core/session.World``: this rank, the world size, the data and
model groups), the session built on it and the placement of batches and
state, so estimator code never branches on the number of ranks. The fits
read everything geometric from their session (``pad_rows``, the world's
groups), so a partitioner plugs in as a session factory plus an ingestion
facade:

    world = TorchSession.initialize_distributed()     # the launcher's env
    part = DataParallelPartitioner(world, device="cuda")
    src = part.shard_csv(path, "label", n_total=rows, chunk_rows=4096)
    model = est.fit_stream(src, n_features=d, session=part.session)

``DataParallelPartitioner`` — rows split over the data ranks, state
replicated (the LogReg / linear / k-means regime).
``SPMDPartitioner``          — rows over the data ranks AND the hashed
embedding table split over the model ranks (``models/hashed_linear.py``
splits the table whenever the session's model parallelism is over 1).

Kill-switch: under ``OTPU_MULTIHOST=0`` every partitioner is an inert
facade over the one-process session — plain copies to the device, identity
sources: the pre-multihost path, bitwise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from orange3_spark_tpu_torch.core.session import DATA_AXIS, MODEL_AXIS, TorchSession, World
from orange3_spark_tpu_torch.io.multihost import put_sharded
from orange3_spark_tpu_torch.utils import knobs

__all__ = ["BasePartitioner", "DataParallelPartitioner", "SPMDPartitioner"]


class BasePartitioner:
    """World + session + placement owner."""

    data_axis = DATA_AXIS
    model_axis = MODEL_AXIS

    #: state-dict keys whose leading dim splits over the model ranks (the
    #: hashed table); everything else is replicated
    model_sharded_keys: tuple = ()

    def __init__(self, world: World | None = None, *, device: str | torch.device | None = None):
        self.enabled = knobs.get_bool("OTPU_MULTIHOST")
        if not self.enabled:
            # kill-switch: facade over the one-process session — the same
            # device and placements the estimators use today, bitwise
            self.session = TorchSession.builder_get_or_create(device)
        else:
            world = world if world is not None else World()
            self._check_world(world)
            self.session = TorchSession(device, world=world)
        w = self.session.world
        self.mesh = {DATA_AXIS: w.data_parallelism, MODEL_AXIS: w.model_parallel}

    # ------------------------------------------------------------- geometry
    def _check_world(self, world: World) -> None:
        raise NotImplementedError

    @property
    def n_processes(self) -> int:
        return self.session.world.size

    # ------------------------------------------------------------ shardings
    def state_sharding(self, name: str, value) -> tuple:
        """Placement of one optimizer/model state leaf (by dict key), as a
        partition spec: ``('model', None)`` for a model-split table (rows
        over the model ranks), ``()`` for a replicated leaf."""
        if (self.enabled and name in self.model_sharded_keys and np.ndim(value) >= 2
                and self.session.model_parallelism > 1):
            return (self.model_axis, None)
        return ()

    # ------------------------------------------------------------ placement
    def shard_batch(self, X, y=None, w=None):
        """This rank's row blocks -> tensors on its device. In a gang every
        rank contributes its block and ``put_sharded`` validates the
        lockstep contract (typed ragged-block error); the global batch is
        the blocks in rank order."""
        s = self.session
        out = [put_sharded(np.ascontiguousarray(X), s)]
        for v in (y, w):
            out.append(None if v is None else put_sharded(np.ascontiguousarray(v), s))
        return tuple(out)

    def shard_state(self, state: dict) -> dict:
        """Place a (possibly nested) state dict on this rank's device: a
        model-split leaf keeps this rank's block of rows (model rank m of mp
        holds rows ``[m·n/mp, (m+1)·n/mp)``), everything else whole."""
        w = self.session.world

        def place(name, v):
            if isinstance(v, dict):
                return {k: place(k, x) for k, x in v.items()}
            t = torch.as_tensor(np.asarray(v))
            if self.state_sharding(name, v):
                rows = t.shape[0] // w.model_parallel
                t = t[w.model_index * rows:(w.model_index + 1) * rows]
            return t.to(self.session.device)
        return {k: place(k, v) for k, v in state.items()}

    def partition(self, step_fn: Callable, *, donate_state: bool = True) -> Callable:
        """The step wrapper for ``step_fn(state, *batch) -> state``. With
        ``donate_state`` the new state is written into the old state's
        tensors in place and the old dict is returned (the reference's
        buffer donation: the state keeps its memory across steps)."""
        if not donate_state:
            return step_fn

        def donated(state, *batch):
            from orange3_spark_tpu_torch.models.hashed_linear import _write_back

            _write_back(state, step_fn(state, *batch))
            return state

        return donated

    # ------------------------------------------------------------ ingestion
    def shard_csv(self, path, class_col: str = "", *, n_total: int,
                  chunk_rows: int = 1 << 20, **kw) -> Callable:
        """Per-rank CSV source in this partitioner's geometry: each rank
        parses only its row block, lockstep-padded (inert single-file
        pass-through under the kill-switch)."""
        from orange3_spark_tpu_torch.io.streaming import sharded_csv_chunk_source

        return sharded_csv_chunk_source(path, class_col, shard_total_rows=n_total,
                                        chunk_rows=chunk_rows, world=self.session.world, **kw)

    def shard_parquet(self, path, class_col: str = "", *, chunk_rows: int = 1 << 20,
                      **kw) -> Callable:
        """Per-rank parquet source: this rank's contiguous row-group range
        (Spark's parquet input splits; inert under the kill-switch)."""
        from orange3_spark_tpu_torch.io.streaming import parquet_chunk_source

        return parquet_chunk_source(path, class_col, chunk_rows=chunk_rows, shard=True,
                                    world=self.session.world, **kw)


class DataParallelPartitioner(BasePartitioner):
    """Rows over the data ranks, state replicated — LogReg/linear/k-means."""

    def _check_world(self, world: World) -> None:
        if world.model_parallel != 1:
            raise ValueError(f"DataParallelPartitioner takes a world without model "
                             f"parallelism, got model_parallel={world.model_parallel}")


class SPMDPartitioner(BasePartitioner):
    """Rows over the data ranks AND the hashed embedding table split over
    the model ranks: the world ``(size // model_parallel, model_parallel)``.
    The hashed fit picks the table split up from the session's world alone,
    so SPMD needs no estimator changes."""

    model_sharded_keys = ("emb",)

    def __init__(self, world: World | None = None, *, model_parallel: int = 2,
                 device: str | torch.device | None = None):
        self.model_parallel = int(model_parallel)
        super().__init__(world, device=device)

    def _check_world(self, world: World) -> None:
        mp = self.model_parallel
        if mp < 1 or world.size % mp:
            raise ValueError(f"SPMDPartitioner: model_parallel={mp} does not divide the "
                             f"{world.size}-rank world")
        if world.model_parallel != mp:
            raise ValueError(
                f"SPMDPartitioner: model_parallel={mp}, but the world was initialized "
                f"with model_parallel={world.model_parallel} (its groups are made then: "
                "TorchSession.initialize_distributed(model_parallel=...))")
