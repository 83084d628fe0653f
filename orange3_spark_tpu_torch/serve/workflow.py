"""ServedWorkflow — a whole inference DAG served as ONE model.

Port of ``orange3_spark_tpu/serve/workflow.py``. A canvas request
(preprocess transforms → model predict) walked the per-model serving path
once per STAGE: K bucket pads, K dispatches, K host↔device round trips.
This module wraps the stageable region of an already-run graph as a single
:class:`Model`, so the serving machinery serves it whole:

* ``route()`` sees one transform/predict call; the context builds the
  workflow's raw stagewise walk (under ``_raw_calls``) into ONE bucket
  program per ladder rung, on CUDA one captured graph
  (``serve/context._BucketGraph``). A request pads once at the DAG
  boundary, pad rows ride W = 0 through every stage, and interior stage
  outputs never reach the host. Every stage's product is a per-row sum
  (``models/_linear.row_products``), so the served rows equal the raw
  walk's bitwise at every rung.
* the program key folds :meth:`_serve_state_token`, which folds every
  child model's token: a nested ``load_state_pytree`` moves the whole
  DAG's fingerprint (fresh programs; the old ones retire through the LRU).
* the MicroBatcher groups by that fingerprint, so same-DAG requests merge
  into one dispatch.
* the workflow pickles whole (program + every stage's fitted state).

Kill-switch ``OTPU_WORKFLOW_SERVE=0`` (utils/knobs.py): every request runs
the same stagewise walk outside the fused build, so each stage re-enters
``route()`` on its own — bitwise the per-model serving path.
``OTPU_WORKFLOW_MAX_STAGES`` bounds how large a DAG may fuse. Counters:
``otpu_workflow_requests_total``, ``otpu_workflow_stagewise_total`` and the
gauge ``otpu_workflow_stages`` in the port's metrics registry.
"""

from __future__ import annotations

import numpy as np
import torch

from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import Model, Params
from orange3_spark_tpu_torch.obs.registry import REGISTRY
from orange3_spark_tpu_torch.utils import knobs

__all__ = ["ServedWorkflow"]

_M_REQUESTS = REGISTRY.counter(
    "otpu_workflow_requests_total",
    "workflow requests admitted to the fused DAG serving path")
_M_STAGEWISE = REGISTRY.counter(
    "otpu_workflow_stagewise_total",
    "workflow requests served stage-by-stage (kill-switch or oversized DAG)")
_M_STAGES = REGISTRY.gauge(
    "otpu_workflow_stages", "stages fused into a served workflow DAG")


class ServedWorkflow(Model):
    """One canvas DAG, served through the per-model machinery as a unit.

    Holds the PICKLABLE program ``workflow.staging.build_serve_program``
    returns: a topo-ordered op list (``{"nid", "op", "payload", "feeds"}``
    records run by ``staging.apply_payload``), the single boundary input
    key, and the boundary and sink domains. Construct with
    :meth:`from_graph` (an already-run ``WorkflowGraph``) or
    :meth:`from_stages` (an explicit chain of fitted stages)."""

    def __init__(self, program: dict, *, name: str | None = None):
        self.params = Params()
        self._ops = list(program["ops"])
        if not self._ops:
            raise ValueError("a served workflow needs at least one stage")
        self._input_key = tuple(program["input_key"])
        self._sink_key = tuple(program["sink_key"])
        self.in_domain = program["in_domain"]
        self.out_domain = program["out_domain"]
        self.frontier = list(program.get("frontier") or ())
        self.graph_json = program.get("graph_json")
        self.dag_name = name or f"dag{self._sink_key[0]}"
        _M_STAGES.set(len(self._ops), dag=self.dag_name)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_graph(cls, graph, sink: int, sink_port: str = "data", *,
                   name: str | None = None) -> "ServedWorkflow":
        from orange3_spark_tpu_torch.workflow.staging import build_serve_program

        return cls(build_serve_program(graph, sink, sink_port), name=name)

    @classmethod
    def from_stages(cls, stages, template: TorchTable, *,
                    name: str | None = None) -> "ServedWorkflow":
        """A linear chain of already-FITTED transformers/models, run once on
        ``template`` (which also supplies the domains)."""
        from orange3_spark_tpu_torch.serve.context import _raw_calls
        from orange3_spark_tpu_torch.workflow.staging import apply_payload

        stages = list(stages)
        if not stages:
            raise ValueError("from_stages needs at least one fitted stage")
        ops, t = [], template
        with _raw_calls():
            for i, stage in enumerate(stages):
                op = "model" if isinstance(stage, Model) else "transformer"
                ops.append({"nid": i + 1, "op": op, "payload": stage,
                            "feeds": [("data", (i, "data"))]})
                t = apply_payload(op, stage, {"data": t})
        return cls({"ops": ops, "input_key": (0, "data"),
                    "sink_key": (len(stages), "data"), "in_domain": template.domain,
                    "out_domain": t.domain, "frontier": [], "graph_json": None},
                   name=name)

    # ----------------------------------------------------------- identity
    @property
    def n_stages(self) -> int:
        return len(self._ops)

    @property
    def n_cols(self) -> int:
        """The boundary chunk width (array serving)."""
        return len(self.in_domain.attributes)

    @property
    def _dag_name(self) -> str:
        # what route() and the micro-batcher read for per-DAG span labels
        return self.dag_name

    @property
    def device(self) -> torch.device:
        """Where the stages' state lies (the active session's device for a
        DAG with no tensor state): array requests are served there."""
        from orange3_spark_tpu_torch.serve.context import _state_device

        dev = _state_device(self.state_pytree)
        if dev.type == "cpu" and not any(
                isinstance(m, Model) for m in self._stage_models().values()):
            from orange3_spark_tpu_torch.core.session import TorchSession

            return TorchSession.active().device
        return dev

    @property
    def _hot_reloadable(self) -> bool:
        """True when every stage's state travels through state_pytree (all
        payloads are Models or stateless): the in-place reload
        precondition."""
        return all(op["payload"] is None or isinstance(op["payload"], Model)
                   for op in self._ops)

    @property
    def _bundle_sig(self) -> tuple:
        """Structural signature of the bundle (same DAG shape: state loads
        in place; shape changed: object replacement)."""
        return tuple((op["nid"], op["op"], type(op["payload"]).__name__)
                     for op in self._ops)

    def _serve_passthrough(self, kind: str) -> bool:
        """route()'s pre-dispatch hook: True = serve this request stage by
        stage (the kill-switch, or the DAG outgrew the fusion ceiling). The
        one per-request tick of the otpu_workflow_* counters."""
        max_stages = knobs.get_int("OTPU_WORKFLOW_MAX_STAGES") or 0
        if (not knobs.get_bool("OTPU_WORKFLOW_SERVE")
                or (max_stages and len(self._ops) > max_stages)):
            _M_STAGEWISE.inc(1, dag=self.dag_name)
            return True
        _M_REQUESTS.inc(1, dag=self.dag_name)
        return False

    # ----------------------------------------------------- stagewise walk
    def _walk(self, table: TorchTable, *, stop_before_sink: bool = False):
        """Run the program on ``table``; returns the tables keyed (nid,
        "data"). Inside a fused build the stages' raw methods run (the
        build holds ``_raw_calls``); under the kill-switch each stage's call
        re-enters ``route()`` and serves on its own."""
        from orange3_spark_tpu_torch.workflow.staging import apply_payload

        tables = {self._input_key: table}
        for op in (self._ops[:-1] if stop_before_sink else self._ops):
            ins = {port: tables[tuple(src)] for port, src in op["feeds"]}
            tables[(op["nid"], "data")] = apply_payload(op["op"], op["payload"], ins)
        return tables

    def _sink_input(self, tables) -> TorchTable:
        op = self._ops[-1]
        ins = {port: tables[tuple(src)] for port, src in op["feeds"]}
        if "data" not in ins:
            raise NotImplementedError(
                f"workflow sink op {op['op']!r} has no 'data' input to predict on")
        return ins["data"]

    # ------------------------------------------------------- Model surface
    def transform(self, table: TorchTable) -> TorchTable:
        return self._walk(table)[(self._sink_key[0], "data")]

    def predict(self, x):
        if isinstance(x, TorchTable):
            return self._final_predict(x)
        from orange3_spark_tpu_torch.serve.context import _reentrant, active_serving_context

        X = np.asarray(x, np.float32)
        ctx = active_serving_context()
        if (ctx is not None and not _reentrant()
                and not self._serve_passthrough("array")):
            out = ctx.served_array(self, X)
            if out is not None:
                return out
        return np.asarray(self._final_predict(self._boundary_table(torch.from_numpy(X))))

    def _final_predict(self, table: TorchTable):
        op = self._ops[-1]
        pred = getattr(op["payload"], "predict", None)
        if op["op"] not in ("apply", "model") or pred is None:
            raise NotImplementedError(f"workflow sink ({op['op']}) is not a predicting model")
        return pred(self._sink_input(self._walk(table, stop_before_sink=True)))

    def _device_predict(self, table: TorchTable):
        """The fused-predict hook the serving context builds: the pre-sink
        walk + the sink model's own device hook, in one program. A sink
        without the hook raises: the build fails, the breaker opens, and
        requests serve on the raw stagewise path."""
        op = self._ops[-1]
        hook = getattr(type(op["payload"]), "_device_predict", None)
        if op["op"] not in ("apply", "model") or hook is None:
            raise NotImplementedError(f"workflow sink ({op['op']}) has no _device_predict hook")
        return hook(op["payload"], self._sink_input(self._walk(table, stop_before_sink=True)))

    # ---------------------------------------------------------- array wire
    def _boundary_table(self, X: torch.Tensor) -> TorchTable:
        """Lift one raw request chunk to a boundary table on the stages'
        device (live rows only, W = 1)."""
        from orange3_spark_tpu_torch.core.session import TorchSession

        dev = self.device
        X = X.to(device=dev, dtype=torch.float32)
        n = X.shape[0]
        return TorchTable(self.in_domain, X, None,
                          torch.ones((n,), dtype=torch.float32, device=dev), None, n,
                          TorchSession(dev))

    def _serve_array_state(self) -> dict:
        # the stages' state is read where it lies by the walk
        return {}

    def _serve_array_fn(self, state, Xp):
        """Device fn of the bucketed array program: lift the padded chunk to
        the boundary table and run the fused DAG predict (the caller strips
        ``[:n]``; row-wise stages never read the pad rows' W = 1)."""
        del state
        return self._device_predict(self._boundary_table(Xp))

    # -------------------------------------------------------- state bundle
    def _stage_models(self) -> dict[str, Model]:
        return {f"node{op['nid']}": op["payload"] for op in self._ops
                if isinstance(op["payload"], Model)}

    @property
    def state_pytree(self) -> dict:
        return {key: m.state_pytree for key, m in self._stage_models().items()}

    def load_state_pytree(self, state: dict) -> None:
        """Hot-reload stage state in place; a PARTIAL dict reloads just
        those stages. Any reload moves this workflow's own serving token
        too: its bucket programs read the child state."""
        models = self._stage_models()
        unknown = set(state) - set(models)
        if unknown:
            raise ValueError(f"workflow bundle has state for unknown stages "
                             f"{sorted(unknown)} (have {sorted(models)})")
        for key, sub in state.items():
            models[key].load_state_pytree(sub)
        self._touch_serving_state()

    def _serve_state_token(self):
        return (getattr(self, "_serve_state_version", 0),
                tuple(m._serve_state_token() for m in self._stage_models().values()))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        chain = " -> ".join(type(op["payload"]).__name__ if op["payload"] is not None
                            else op["op"] for op in self._ops)
        return f"ServedWorkflow({self.dag_name}: {chain})"
