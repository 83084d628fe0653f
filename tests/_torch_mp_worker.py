"""One rank of the 2-rank gloo gang of ``tests/test_torch_multiprocess.py``
(the port's counterpart of ``tests/_mp_worker.py``). Run by
``MultihostLauncher`` (the rank, world size and rendezvous come in its
environment) as::

    python tests/_torch_mp_worker.py <csv_path> <out_dir>

The rank reads ONLY its ``process_row_slice`` of the shared CSV and runs, on
the CPU: the dense streaming fit over 125-row chunks of its block, a batch
``LogisticRegression`` on its local table, the three collectives on seeded
blocks, and ``group_by`` on a local table with a live NaN. Every rank writes
its results to ``rank<R>.npz``; the test compares ranks and holds rank 0 to
the JAX package's one-process answers.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> None:
    csv_path, out_dir = sys.argv[1], sys.argv[2]
    from orange3_spark_tpu_torch import TorchSession, TorchTable
    from orange3_spark_tpu_torch.core.domain import (
        ContinuousVariable, DiscreteVariable, Domain,
    )
    from orange3_spark_tpu_torch.io.multihost import process_row_slice, put_sharded
    from orange3_spark_tpu_torch.io.streaming import StreamingLinearEstimator, array_chunk_source
    from orange3_spark_tpu_torch.models.logistic_regression import LogisticRegression
    from orange3_spark_tpu_torch.ops import relational
    from orange3_spark_tpu_torch.parallel import (
        data_parallel_sum, distributed_gramian, tree_aggregate,
    )

    world = TorchSession.initialize_distributed()
    sess = TorchSession("cpu", world=world)
    full = np.loadtxt(csv_path, delimiter=",", skiprows=1, dtype=np.float64).astype(np.float32)
    block = full[process_row_slice(len(full), world)]
    X, y = np.ascontiguousarray(block[:, :-1]), np.ascontiguousarray(block[:, -1])
    Xd = put_sharded(X, sess)          # the lockstep check: both ranks hold 500 rows

    sm = StreamingLinearEstimator(loss="logistic", epochs=2, step_size=0.1,
                                  chunk_rows=128).fit_stream(
        array_chunk_source(X, y, chunk_rows=128), n_features=X.shape[1], session=sess)

    domain = Domain([ContinuousVariable(f"f{i}") for i in range(X.shape[1])],
                    DiscreteVariable("y", ("0", "1")))
    lr = LogisticRegression(max_iter=100, reg_param=1e-3).fit(
        TorchTable.from_numpy(domain, X, y, session=sess))

    rng = np.random.default_rng(100 + world.rank)       # each rank's own rows
    A = rng.standard_normal((64, 5)).astype(np.float32)
    W = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    At, Wt = torch_from(A), torch_from(W)
    agg = tree_aggregate(lambda a, w: ((a * w[:, None]).sum(dim=0), w.sum()), At, Wt,
                         session=sess)
    dps = data_parallel_sum((At, Wt), session=sess)
    G, mean, tot = distributed_gramian(At, Wt, session=sess)

    kdom = Domain([DiscreteVariable("k", ("a", "b", "c")), ContinuousVariable("v")])
    K = np.array([[0, 1.0], [1, 3.0], [1, np.nan], [2, 4.0], [1, 5.0]], np.float32)
    gb = relational.group_by(TorchTable.from_numpy(kdom, K, session=sess), "k",
                             [("v", "min"), ("v", "max")]).to_numpy()[0]

    np.savez(os.path.join(out_dir, f"rank{world.rank}.npz"),
             rank=world.rank, size=world.size, local_rows=Xd.shape[0],
             stream_coef=sm.coef.numpy(), stream_intercept=sm.intercept.numpy(),
             stream_steps=sm.n_steps_, coef=lr.coef.numpy(), intercept=lr.intercept.numpy(),
             A=A, W=W, agg_xw=agg[0].numpy(), agg_w=agg[1].numpy(), dps_a=dps[0].numpy(),
             dps_w=dps[1].numpy(), gram=G.numpy(), gram_mean=mean.numpy(),
             gram_tot=tot.numpy(), group_by=gb)
    TorchSession.shutdown_distributed()
    print(f"rank {world.rank} done", flush=True)


def torch_from(a):
    import torch

    return torch.from_numpy(a)


if __name__ == "__main__":
    main()
