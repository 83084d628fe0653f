"""The port's serving fleet (``orange3_spark_tpu_torch/fleet/``) against the
JAX package's, and on its own.

Against the reference, on the same inputs made from a numpy seed:

* the wire's frames — npy bodies and shared-memory descriptors — are the
  same bytes (a segment's name aside), and each package decodes the
  other's;
* the router's coalescer merges the same members into the same requests
  (same rows, same member trace ids, same npy bytes);
* ``HedgeSchedule`` gives the same hedge delay after every observation of
  one latency sequence;
* the reference's RPC client drives the port's replica server.

On its own (CPU replicas): an in-process fleet serves bitwise what one
``ServingContext`` serves; a replica's reload flips versions; a served
workflow publishes, serves and reloads as one version; a
subprocess replica killed with SIGKILL is restarted and re-admitted, and
one sent SIGTERM drains and exits 0. Every comparison is exact: the
fleet moves bytes and makes decisions, it does no arithmetic of its own.
"""

from __future__ import annotations

import concurrent.futures
import os
import signal
import time

import numpy as np
import pytest

import orange3_spark_tpu.fleet.fastwire as j_fw
import orange3_spark_tpu.fleet.router as j_router
import orange3_spark_tpu.fleet.rpc as j_rpc
import orange3_spark_tpu_torch.fleet.fastwire as t_fw
import orange3_spark_tpu_torch.fleet.router as t_router
import orange3_spark_tpu_torch.fleet.rpc as t_rpc
from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.fleet import rollout as ro

from _torch_artifacts import artifact_dirs  # noqa: F401

N_DENSE = N_CAT = 4


def _ctr_rows(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    X = np.concatenate([
        rng.standard_normal((n, N_DENSE)).astype(np.float32),
        rng.integers(0, 500, (n, N_CAT)).astype(np.float32)], axis=1)
    y = (rng.random(n) < 0.3).astype(np.float32)
    return X, y


def fit_ctr(epochs: int = 1, seed: int = 3, n: int = 2048):
    """A small hashed CTR model fitted on the CPU, and its rows."""
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import (
        StreamingHashedLinearEstimator,
    )

    X, y = _ctr_rows(seed, n)
    model = StreamingHashedLinearEstimator(
        n_dims=1 << 10, n_dense=N_DENSE, n_cat=N_CAT, epochs=epochs,
        step_size=0.05, chunk_rows=512,
    ).fit_stream(array_chunk_source(X, y, chunk_rows=512),
                 session=TorchSession.builder_get_or_create("cpu"))
    return model, X


@pytest.fixture(scope="module")
def ctr():
    return fit_ctr()


def _served(model, X, ladder_max=512):
    from orange3_spark_tpu_torch.serve import BucketLadder, ServingContext

    with ServingContext(BucketLadder(min_bucket=64, max_bucket=ladder_max)) as ctx:
        ctx.warmup(model, n_cols=N_DENSE + N_CAT, kinds=("array",))
        return np.asarray(model.predict(X))


# ------------------------------------------------------------ the wire
FRAMES = [((37, 8), np.float32), ((5,), np.float64), ((3, 4), np.int32)]


@pytest.mark.parametrize("shape,dtype", FRAMES)
def test_npy_and_shm_frames_decode_across_packages(shape, dtype):
    """The npy body is the same bytes in both packages and each decodes
    the other's; a shared-memory descriptor is the same JSON but for the
    segment's name, and each package reads (and unlinks) the other's
    segment."""
    a = (np.random.default_rng(11).standard_normal(shape) * 100).astype(dtype)
    jb, tb = j_rpc.dump_npy(a), t_rpc.dump_npy(a)
    assert jb == tb
    for load in (j_rpc.load_npy, t_rpc.load_npy):
        got = load(tb)
        assert got.dtype == a.dtype and np.array_equal(got, a)
    for dump, load in ((j_fw.dump_shm, t_fw.load_shm), (t_fw.dump_shm, j_fw.load_shm)):
        body, seg = dump(a)
        try:
            got = load(body)
        finally:
            seg.cleanup()
        assert got.dtype == a.dtype and np.array_equal(got, a)
    jd, sj = j_fw.dump_shm(a)
    td, st = t_fw.dump_shm(a)
    sj.cleanup()
    st.cleanup()
    import json

    jd, td = json.loads(jd), json.loads(td)
    assert jd.pop("segment") != td.pop("segment")
    assert jd == td


def _coalesced(router_mod, sizes, tenants, max_rows):
    """The requests one package's coalescer sends for queued members:
    (rows, member trace ids, npy bytes) per wire dispatch."""
    sent = []

    class StubRouter:
        endpoints = [object()]

        def _route(self, X, trace_id, deadline, use_hedge, weight=1,
                   member_traces=None, tenant=None):
            sent.append((X.shape[0], list(member_traces or [trace_id]), tenant,
                         (j_rpc if router_mod is j_router else t_rpc).dump_npy(X)))
            return X[:, 0].copy()

    co = router_mod.FleetCoalescer(StubRouter())
    rng = np.random.default_rng(5)
    members = []
    for i, (n, tenant) in enumerate(zip(sizes, tenants)):
        m = router_mod._Member(rng.standard_normal((n, 8)).astype(np.float32),
                               f"t-{i}", None, tenant)
        members.append(m)
        co._pending.append(m)
    co._leaders = 1
    os.environ["OTPU_FLEET_COALESCE_ROWS"] = str(max_rows)
    try:
        co._drain(False)
    finally:
        os.environ.pop("OTPU_FLEET_COALESCE_ROWS", None)
    outs = [m.await_result() for m in members]
    return sent, outs, co.stats()


def test_coalesced_requests_equal_the_reference():
    """Queued members of mixed sizes and tenants merge into the same wire
    requests in both packages: same groups (same-tenant only, at most the
    row cap), the same npy bytes, each member's rows scattered back."""
    sizes = [64, 32, 200, 7, 64, 300, 1, 90]
    tenants = [None, None, "a", None, "a", None, None, "a"]
    j = _coalesced(j_router, sizes, tenants, 256)
    t = _coalesced(t_router, sizes, tenants, 256)
    assert [s[:3] for s in t[0]] == [s[:3] for s in j[0]]
    assert [s[3] for s in t[0]] == [s[3] for s in j[0]]
    assert all(np.array_equal(a, b) for a, b in zip(t[1], j[1]))
    assert t[2] == j[2] and len(t[0]) < len(sizes)
    for raw in (s[3] for s in t[0]):
        assert np.array_equal(j_rpc.load_npy(raw), t_rpc.load_npy(raw))


def test_hedge_schedule_thresholds_equal_the_reference():
    """Over one seeded latency sequence, every hedge delay and percentile
    estimate is the reference's, floor and percentile both varied."""
    lat = np.random.default_rng(9).lognormal(-3.5, 0.6, 200)
    for floor_ms, pctl in ((30.0, 95.0), (0.0, 99.0), (5.0, 50.0)):
        j = j_router.HedgeSchedule(floor_ms=floor_ms, pctl=pctl)
        t = t_router.HedgeSchedule(floor_ms=floor_ms, pctl=pctl)
        got, want = [t.hedge_delay_s()], [j.hedge_delay_s()]
        for dt in lat:
            j.observe(float(dt))
            t.observe(float(dt))
            got.append((t.hedge_delay_s(), t.p_estimate_s()))
            want.append((j.hedge_delay_s(), j.p_estimate_s()))
        assert got == want


# ------------------------------------------------------- one process
def test_inproc_fleet_serves_bitwise_the_serving_context(ctr, tmp_path, monkeypatch):
    """``OTPU_FLEET_INPROC=2``: FleetFrontend serves through two lanes over
    one CPU runtime behind the router, bitwise what a single-process
    ``ServingContext`` serves, and ``OTPU_FLEET=0`` is the raw predict."""
    from orange3_spark_tpu_torch.fleet import FleetFrontend

    model, X = ctr
    want = _served(model, X[:300])
    monkeypatch.setenv("OTPU_FLEET_INPROC", "2")
    with FleetFrontend(model, root=str(tmp_path / "inproc"), n_replicas=2,
                       n_cols=N_DENSE + N_CAT, ladder_max=512,
                       session=TorchSession("cpu")) as fe:
        assert fe.mode == "inproc" and len(fe._inproc.clients) == 2
        assert fe._inproc.runtime.session.device.type == "cpu"
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda s: fe.predict(X[s:s + 100]), (0, 100, 200)))
        got = np.concatenate(outs)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    monkeypatch.setenv("OTPU_FLEET", "0")
    fe = FleetFrontend(model)
    assert fe.mode == "local" and np.array_equal(fe.predict(X[:64]), model.predict(X[:64]))


def test_replica_rpc_serves_the_reference_client_and_reloads(ctr, tmp_path):
    """A port replica on a loopback port: the reference's RPC client and
    the port's get the bits a ``ServingContext`` serves, with the trace id
    echoed; ``/healthz`` names the device; a reload flips the version."""
    from orange3_spark_tpu_torch.fleet.replica import ReplicaRuntime
    from orange3_spark_tpu_torch.serve import BucketLadder

    model, X = ctr
    root = str(tmp_path / "store")
    ro.publish_version(model, root, n_cols=N_DENSE + N_CAT)
    rt = ReplicaRuntime(root, name="replica-0", device="cpu",
                        ladder=BucketLadder(min_bucket=64, max_bucket=512)).activate()
    try:
        srv = rt.serve_background()
        want = _served(model, X[:200])
        for client_mod in (j_rpc, t_rpc):
            c = client_mod.FleetClient("127.0.0.1", srv.port, name="replica-0")
            out, headers = c.predict(X[:200], trace_id="fleet-abc-1")
            c.close()
            assert np.array_equal(out, want)
            assert headers[t_rpc.TRACE_HEADER] == "fleet-abc-1"
            assert headers[t_rpc.VERSION_HEADER] == "v0001"
        c = t_rpc.FleetClient("127.0.0.1", srv.port)
        status, body = c.get_json("/healthz")
        assert status == 200 and body["device"] == "cpu"
        assert c.ready()[0]
        model2, _ = fit_ctr(epochs=2)
        v2 = ro.publish_version(model2, root, n_cols=N_DENSE + N_CAT)
        assert c.post_json("/reload", {"version": v2}) == (200, {"version": v2})
        out, headers = c.predict(X[:200])
        assert headers[t_rpc.VERSION_HEADER] == v2
        assert np.array_equal(out, _served(model2, X[:200]))
        c.close()
    finally:
        rt.close()


def test_workflow_bundle_publishes_serves_reloads_and_reports_its_dag(tmp_path):
    """``publish_workflow_version``: a ``ServedWorkflow`` (StandardScaler ->
    PCA -> KMeans on Iris) is one versioned unit; a replica serves it
    bitwise the workflow's own predict, a reload of a refitted bundle
    flips, and ``/readyz`` names the DAG."""
    import json
    import urllib.request

    from orange3_spark_tpu_torch.datasets import load_iris
    from orange3_spark_tpu_torch.fleet.replica import ReplicaRuntime
    from orange3_spark_tpu_torch.models.kmeans import KMeans
    from orange3_spark_tpu_torch.models.pca import PCA
    from orange3_spark_tpu_torch.models.preprocess import StandardScaler
    from orange3_spark_tpu_torch.serve import BucketLadder, ServedWorkflow

    iris = load_iris(TorchSession.builder_get_or_create("cpu"))

    def bundle(km_seed):
        scaler = StandardScaler().fit(iris)
        scaled = scaler.transform(iris)
        pca = PCA(k=2).fit(scaled)
        km = KMeans(k=3, seed=km_seed).fit(pca.transform(scaled))
        return ServedWorkflow.from_stages([scaler, pca, km], iris, name="wf-fleet")

    root = str(tmp_path / "wfroot")
    wf1 = bundle(0)
    v1 = ro.publish_workflow_version(wf1, root)
    meta = ro.read_version_meta(root, v1)
    assert meta["workflow"] and meta["dag"] == "wf-fleet"
    assert meta["n_stages"] == 3 and meta["n_cols"] == 4
    assert meta["stage_classes"] == ["StandardScalerModel", "PCAModel", "KMeansModel"]
    X = iris.X[:20].numpy()
    rt = ReplicaRuntime(root, name="wf-replica", device="cpu",
                        ladder=BucketLadder(min_bucket=64, max_bucket=64))
    try:
        rt.activate()
        assert rt.dag == "wf-fleet"
        assert np.array_equal(rt.predict(X), np.asarray(wf1.predict(X)))
        wf2 = bundle(7)
        v2 = ro.publish_workflow_version(wf2, root)
        assert rt.reload(v2) == v2 and rt.version == v2
        assert np.array_equal(rt.predict(X), np.asarray(wf2.predict(X)))
        srv = rt.serve_background()
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/readyz", timeout=10).read())
        assert body["dag"] == "wf-fleet" and body["version"] == v2
    finally:
        rt.close()


def test_replica_fails_loudly_without_cuda(ctr, tmp_path):
    """A replica asked for no device runs on CUDA, and where CUDA is absent
    it raises at start instead of falling back to the CPU."""
    import torch

    from orange3_spark_tpu_torch.fleet.replica import ReplicaRuntime

    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    root = str(tmp_path / "store")
    ro.publish_version(ctr[0], root, n_cols=N_DENSE + N_CAT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaRuntime(root, session=None)


# -------------------------------------------------- replica processes
def _cpu_fleet(tmp_path, model, n):
    from orange3_spark_tpu_torch.fleet.supervisor import ReplicaManager

    root = str(tmp_path / "fleet")
    ro.publish_version(model, root, n_cols=N_DENSE + N_CAT)
    mgr = ReplicaManager(root, n_replicas=n, ladder_max=256, device="cpu",
                         env={"OMP_NUM_THREADS": "1"})
    mgr.start()
    if not mgr.wait_ready(timeout_s=90):
        mgr.stop_all()
        pytest.fail("replica subprocesses never became ready")
    return mgr


def test_replica_subprocess_sigkill_restarts_and_is_readmitted(ctr, tmp_path):
    """Two ``--device cpu`` replica processes behind the router: SIGKILL
    one mid-burst — every request answers bitwise or fails typed, none
    hangs — then the supervisor restarts it and the router re-admits it
    through ``/readyz`` and the breaker's half-open probe. Bounded: 90 s
    to start, 60 s for the burst, 90 s to re-admit."""
    from orange3_spark_tpu_torch.fleet.router import FleetRouter

    model, X = ctr
    mgr = _cpu_fleet(tmp_path, model, 2)
    router = FleetRouter(mgr.endpoints(), hedging=False)
    try:
        router.refresh()
        want = _served(model, X[:64])
        assert np.array_equal(router.predict(X[:64]), want)

        def one(i):
            time.sleep(i * 0.01)
            try:
                return "ok" if np.array_equal(router.predict(X[:64]), want) else "wrong"
            except (t_rpc.ReplicaUnavailableError, t_rpc.ReplicaDrainingError,
                    t_rpc.NoReplicaAvailableError):
                return "typed"

        ex = concurrent.futures.ThreadPoolExecutor(4)
        try:
            futs = [ex.submit(one, i) for i in range(24)]
            time.sleep(0.05)
            pid0 = mgr.handles[0].pid
            mgr.kill(0)
            done, pending = concurrent.futures.wait(futs, timeout=60)
        finally:
            ex.shutdown(wait=False)
        outcomes = [f.result() for f in done]
        assert not pending and "wrong" not in outcomes
        assert outcomes.count("ok") >= 12
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            router.refresh()
            ep = router.endpoint(0)
            if ep.ready and ep.breaker.state() != "open":
                break
            time.sleep(0.25)
        else:
            pytest.fail("the killed replica was not re-admitted")
        assert mgr.handles[0].pid != pid0 and mgr.handles[0].restarts >= 1
        for _ in range(8):
            assert np.array_equal(router.predict(X[:64]), want)
        served = {ep.replica_id for ep in router.endpoints if ep.ready}
        assert served == {0, 1}
    finally:
        router.close()
        mgr.stop_all()


def test_replica_subprocess_sigterm_drains_and_exits_zero(ctr, tmp_path):
    """SIGTERM is a graceful drain: ``/readyz`` turns 503 ``draining``, the
    process exits 0 within the drain budget and is not restarted."""
    model, X = ctr
    mgr = _cpu_fleet(tmp_path, model, 1)
    try:
        h = mgr.handles[0]
        c = mgr.client(0)
        out, _ = c.predict(X[:32])
        assert np.array_equal(out, _served(model, X[:32]))
        h.stopping = True                 # the supervisor must not restart it
        os.kill(h.pid, signal.SIGTERM)
        assert h.proc.wait(timeout=30) == 0
    finally:
        mgr.stop_all()
