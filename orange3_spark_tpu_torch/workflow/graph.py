"""Workflow graph + signal manager — the Orange canvas scheduler, headless.

Port of ``orange3_spark_tpu/workflow/graph.py`` (pure Python). Orange3's
signal manager fires a widget when its inputs change, downstream in
topological order; this module keeps that contract: nodes, typed signal
links, topological propagation, per-node output caching with dirty
tracking, and JSON (de)serialization in the role of ``.ows`` files. The
JSON is the JAX package's: a workflow saved by either package loads in the
other.

Execution stays EAGER per node, as in Orange; staging.py runs an already-run
graph's data path as captured CUDA graphs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from orange3_spark_tpu_torch.widgets.base import Widget
from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY


@dataclasses.dataclass(frozen=True)
class Edge:
    src: int          # source node id
    src_port: str     # output signal name
    dst: int          # destination node id
    dst_port: str     # input signal name


class Node:
    def __init__(self, node_id: int, widget: Widget):
        self.id = node_id
        self.widget = widget
        self.outputs: dict[str, Any] | None = None  # cache; None = dirty

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Node({self.id}, {self.widget.name})"


class WorkflowGraph:
    """DAG of widgets with Orange signal-manager execution semantics."""

    def __init__(self):
        self.nodes: dict[int, Node] = {}
        self.edges: list[Edge] = []
        self._next_id = 0

    # ------------------------------------------------------------ building
    def add(self, widget: Widget) -> int:
        node_id = self._next_id
        self._next_id += 1
        self.nodes[node_id] = Node(node_id, widget)
        return node_id

    def connect(self, src: int, src_port: str, dst: int, dst_port: str) -> None:
        src_w, dst_w = self.nodes[src].widget, self.nodes[dst].widget
        if src_port not in src_w.output_names():
            raise ValueError(f"{src_w.name} has no output {src_port!r}")
        if dst_port not in dst_w.input_names():
            raise ValueError(f"{dst_w.name} has no input {dst_port!r}")
        # replacing a link on a single-input port mirrors Orange reconnect;
        # mutate only after the cycle check so a rejected connect leaves the
        # graph exactly as it was
        new_edges = [
            e for e in self.edges if not (e.dst == dst and e.dst_port == dst_port)
        ]
        new_edges.append(Edge(src, src_port, dst, dst_port))
        old_edges, self.edges = self.edges, new_edges
        try:
            self._check_acyclic()
        except ValueError:
            self.edges = old_edges
            raise
        self.invalidate(dst)

    def _check_acyclic(self) -> None:
        self.topo_order()  # raises on cycle

    # ----------------------------------------------------------- execution
    def topo_order(self) -> list[int]:
        incoming = {nid: 0 for nid in self.nodes}
        for e in self.edges:
            incoming[e.dst] += 1
        ready = sorted(nid for nid, deg in incoming.items() if deg == 0)
        order: list[int] = []
        while ready:
            nid = ready.pop(0)
            order.append(nid)
            for e in self.edges:
                if e.src == nid:
                    incoming[e.dst] -= 1
                    if incoming[e.dst] == 0:
                        ready.append(e.dst)
        if len(order) != len(self.nodes):
            raise ValueError("workflow graph has a cycle")
        return order

    def invalidate(self, node_id: int, _visited: set[int] | None = None) -> None:
        """Mark a node and everything downstream dirty (signal change).

        Always walks the full downstream cone (with a visited set, not
        dirtiness, as the recursion stop): a node can be dirty yet still hold
        a checkpoint-restored ``fitted_model`` — pruning at dirty nodes would
        leave such a model live past them and serve it against changed inputs.
        """
        if _visited is None:
            _visited = set()
        if node_id in _visited:
            return
        _visited.add(node_id)
        node = self.nodes[node_id]
        node.outputs = None
        if getattr(node.widget, "fitted_model", None) is not None:
            # a checkpoint-restored model is stale once ANY upstream signal
            # changes — it must refit on the new inputs, not serve blindly
            node.widget.fitted_model = None
        for e in self.edges:
            if e.src == node_id:
                self.invalidate(e.dst, _visited)

    def set_params(self, node_id: int, **kwargs) -> None:
        """Change a widget's settings — refires it and downstream on next run."""
        w = self.nodes[node_id].widget
        w.params = w.params.replace(**kwargs)
        self.invalidate(node_id)  # also clears any checkpoint-restored model

    def run(self, verbose: bool = False) -> dict[int, dict[str, Any]]:
        """Fire dirty widgets in topological order; return all node outputs."""
        import time

        for nid in self.topo_order():
            node = self.nodes[nid]
            if node.outputs is not None:
                continue  # cached, inputs unchanged
            inputs: dict[str, Any] = {}
            for e in self.edges:
                if e.dst == nid:
                    src_out = self.nodes[e.src].outputs
                    assert src_out is not None, "topo order violated"
                    inputs[e.dst_port] = src_out[e.src_port]
            missing = [
                i.name for i in node.widget.inputs
                if i.required and i.name not in inputs
            ]
            if missing:
                raise ValueError(
                    f"node {nid} ({node.widget.name}) missing inputs: {missing}"
                )
            t0 = time.perf_counter()
            node.outputs = node.widget.process(**inputs)
            if verbose:  # per-widget wall clock
                print(f"[workflow] {node.widget.name}: "
                      f"{time.perf_counter() - t0:.3f}s")
        return {nid: n.outputs for nid, n in self.nodes.items()}

    def output(self, node_id: int, port: str | None = None) -> Any:
        outs = self.nodes[node_id].outputs
        if outs is None:
            outs = self.run()[node_id]
        if port is None:
            port = self.nodes[node_id].widget.output_names()[0]
        return outs[port]

    # -------------------------------------------------------- serialization
    def to_json(self) -> str:
        """.ows-equivalent workflow file: widget names + settings + links."""
        return json.dumps(
            {
                "version": 1,
                "nodes": [
                    {
                        "id": nid,
                        "widget": node.widget.name,
                        "settings": _sanitize(node.widget.settings_dict()),
                    }
                    for nid, node in sorted(self.nodes.items())
                ],
                "edges": [dataclasses.asdict(e) for e in self.edges],
            },
            default=_json_fallback,
            allow_nan=False,  # strict JSON: _sanitize already nulled NaN/inf
        )

    @classmethod
    def from_json(cls, text: str) -> "WorkflowGraph":
        spec = json.loads(text)
        graph = cls()
        id_map: dict[int, int] = {}
        for nspec in spec["nodes"]:
            wcls = WIDGET_REGISTRY.get(nspec["widget"])
            if wcls is None:
                raise ValueError(f"unknown widget {nspec['widget']!r}")
            widget = wcls.from_settings(nspec.get("settings", {}))
            id_map[nspec["id"]] = graph.add(widget)
        for espec in spec["edges"]:
            graph.connect(
                id_map[espec["src"]], espec["src_port"],
                id_map[espec["dst"]], espec["dst_port"],
            )
        return graph

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "WorkflowGraph":
        with open(path) as f:
            return cls.from_json(f.read())


def _sanitize(obj):
    """Strict-JSON settings: NaN/inf -> null, tuples -> lists, recursively."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, float) and (obj != obj or obj in (float("inf"), float("-inf"))):
        return None
    return obj


def _json_fallback(obj):
    try:
        return float(obj)
    except Exception:
        return repr(obj)
