"""Whole-workflow staging: a widget chain run as captured CUDA graphs.

Port of ``orange3_spark_tpu/workflow/staging.py``. The north-star sentence
of the reference is "the Orange widget signal graph is traced and staged
into a single XLA computation". The eager signal manager (graph.py) fires
widgets one by one, each launching its own ops; staging re-runs the DATA
PATH of an already-run graph as one function of its boundary tables.

**What "one program" is here.** On a CUDA device the staged function is
captured as a CUDA graph over static input buffers: a call copies its
tables in and replays the graph, so the whole chain is one launch of the
host (the role of the reference's one XLA dispatch; kernels are not
fused). A node whose work reads the device from the host (a transform that
checks its input, a fit whose solver reads its status) cannot be captured:
the program then becomes consecutive segments, each run of capturable
nodes one captured graph and each such node run eagerly on the device in
the same call, between them. ``segments`` lists them with the reason, and
``graph_segments`` counts the graphs. Capturability is declared by each
model (``Transformer.staged_capturable``) and estimator
(``Estimator.staged_fit_capturable``), so the CPU and the card report the
same segments; a declared-capturable node that fails to capture raises.
On the CPU there are no graphs: the same nodes run eagerly, in the same
order.

Estimator widgets contribute their FITTED model's transform (the fit ran
in the eager run, Spark's fitted PipelineModel); the fitted state is read
where it lies. ``refit=True`` instead re-fits estimators on the data
flowing through the program, each fit inside ``models.base.staging()``,
which picks its device-pure branch (KMeans' device init and fixed-trip
Lloyd loop); such a fit still re-fits when it runs eagerly between
segments, and never falls back to its closed-over state. The counterpart
of the reference's ``jax.eval_shape`` probe is a run of the fit on the
first rows of its template: a fit that raises there keeps its eager state
and is listed in ``refit_fallbacks`` with the error.

``donate_inputs`` is accepted for the reference's signature and does
nothing: the port updates state in place and a call copies its inputs into
the program's own buffers (the rule that replaced ``exec/donate.py``).
Widgets that leave the device (views, evaluators, info) cannot be staged
and end the path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from orange3_spark_tpu_torch.core.table import TorchTable
from orange3_spark_tpu_torch.models.base import staging
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

#: rows of the template a refit probe runs the fit on
_PROBE_ROWS = 4096


@dataclasses.dataclass
class _Step:
    """One staged node: ``fn`` maps {in_port: TorchTable} to the node's
    'data' table; ``feeds`` lists (in_port, source key)."""
    nid: int
    fn: Callable
    feeds: list
    capturable: bool
    reason: str | None = None


def _segments(steps: list[_Step]) -> list[list[_Step]]:
    """Consecutive capturable steps form one segment; a step that cannot
    be captured is a segment of its own."""
    segs: list[list[_Step]] = []
    for s in steps:
        if s.capturable and segs and segs[-1][0].capturable:
            segs[-1].append(s)
        else:
            segs.append([s])
    return segs


def _segment_info(steps: list[_Step], widget_names: dict) -> list[dict]:
    return [{"nodes": [s.nid for s in seg],
             "widgets": [widget_names.get(s.nid, "") for s in seg],
             "kind": "graph" if seg[0].capturable else "eager",
             **({} if seg[0].capturable else {"reason": seg[0].reason})}
            for seg in _segments(steps)]


def _run_steps(seg, tables: dict) -> dict:
    out = {}
    for s in seg:
        ins = {port: out[src] if src in out else tables[src] for port, src in s.feeds}
        out[(s.nid, "data")] = s.fn(ins)
    return out


def _static_like(t: TorchTable) -> TorchTable:
    """A table of fresh buffers with ``t``'s values (a graph's inputs)."""
    return TorchTable(t.domain, t.X.clone(), None if t.Y is None else t.Y.clone(),
                      t.W.clone(), t.metas, t.n_rows, t.session)


def _copy_into(dst: TorchTable, src: TorchTable) -> None:
    if (src.X.shape != dst.X.shape or (src.Y is None) != (dst.Y is None)
            or src.W.shape != dst.W.shape):
        raise ValueError("a staged call's table does not have the shapes the "
                         "program was built for")
    dst.X.copy_(src.X)
    if dst.Y is not None:
        dst.Y.copy_(src.Y)
    dst.W.copy_(src.W)


class _StagedProgram:
    """The staged function for one set of input shapes: on CUDA each
    capturable segment captured as a CUDA graph (``utils/graphs.
    capture_graph``) over static copies of the tables it reads, the other
    segments eager between them, built by a first run on the given inputs;
    on the CPU every step eager, nothing built. A call runs under
    ``_raw_calls`` (a stage's transform must not re-enter the serving
    router)."""

    def __init__(self, steps: list[_Step], input_keys: list, tables: dict, sink_key):
        from orange3_spark_tpu_torch.serve.context import _raw_calls
        from orange3_spark_tpu_torch.utils.graphs import capture_graph

        self.input_keys, self.sink_key = list(input_keys), sink_key
        segs = _segments(steps)
        device = tables[self.input_keys[0]].X.device
        self.captured = device.type == "cuda"
        self.plan = []
        if not self.captured:
            self.plan = [("eager", seg, None, None, None) for seg in segs]
            return
        tables = dict(tables)
        with _raw_calls():
            for i, seg in enumerate(segs):
                if not seg[0].capturable:
                    self.plan.append(("eager", seg, None, None, None))
                    tables.update(_run_steps(seg, tables))
                    continue
                # the graph reads static copies of the tables fed from
                # outside the segment and returns what a later segment (or
                # the caller) reads
                produced = [(s.nid, "data") for s in seg]
                reads = list(dict.fromkeys(src for s in seg for _, src in s.feeds
                                           if src not in produced))
                later = {src for later_seg in segs[i + 1:] for s in later_seg
                         for _, src in s.feeds} | {sink_key}
                keep = [k for k in produced if k in later]
                static = {k: _static_like(tables[k]) for k in reads}

                def fn(seg=seg, static=static, keep=keep):
                    out = _run_steps(seg, static)
                    return {k: out[k] for k in keep}

                graph, outs, _ = capture_graph(fn, device)
                graph.replay()
                self.plan.append(("graph", seg, static, graph, outs))
                tables.update(outs)

    def __call__(self, tables: dict) -> TorchTable:
        from orange3_spark_tpu_torch.serve.context import _raw_calls

        tables = dict(tables)
        with _raw_calls():
            for kind, seg, static, graph, outs in self.plan:
                if kind == "eager":
                    tables.update(_run_steps(seg, tables))
                    continue
                for k, buf in static.items():
                    _copy_into(buf, tables[k])
                graph.replay()
                tables.update(outs)
        out = tables[self.sink_key]
        if not self.captured:
            return out
        # a graph's outputs are overwritten by the next call: the caller
        # owns a copy
        return TorchTable(out.domain, out.X.clone(),
                          None if out.Y is None else out.Y.clone(), out.W.clone(),
                          out.metas, out.n_rows, out.session)


def _shape_key(tables: dict, keys) -> tuple:
    return tuple((tuple(tables[k].X.shape), str(tables[k].X.dtype),
                  None if tables[k].Y is None else tuple(tables[k].Y.shape),
                  tuple(tables[k].W.shape), str(tables[k].X.device)) for k in keys)


class _ProgramCache:
    """The staged programs of one staged object, by input shapes; under an
    active ServingContext they live in the context's cache instead
    (``ServingContext.staged_executable``)."""

    def __init__(self):
        self._programs: dict = {}

    def program(self, staged, tables: dict):
        from orange3_spark_tpu_torch.serve.context import active_serving_context

        ctx = active_serving_context()
        if ctx is not None:
            return ctx.staged_executable(staged, tables)
        key = _shape_key(tables, staged.input_keys)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = staged._build_program(tables)
        return prog


class StagedGraph:
    """The stageable subgraph ending at a sink as one staged program:
    arbitrary DAG shape (branches, diamonds, multi-input nodes such as
    merge and apply-model).

    ``input_keys``: the boundary (node, port) keys, whose cached eager
    tables are the program's inputs; ``frontier``: every node where staging
    STOPPED and why; ``segments`` / ``graph_segments``: the program's
    captured and eager segments (see the module docstring);
    ``refit_fallbacks``: estimator nodes that kept their eager fitted state
    under ``refit=True`` because their fit cannot run staged.
    """

    def __init__(self, steps, input_keys, templates, sink_key, out_domain, out_meta,
                 session, frontier, refit_fallbacks=(), widget_names=None,
                 donate_inputs: bool = False):
        del donate_inputs   # accepted, does nothing (module docstring)
        self.steps = list(steps)
        self.input_keys = list(input_keys)
        self.templates = templates
        self.sink_key = sink_key
        self.out_domain = out_domain
        self._out_meta = out_meta
        self.session = session
        self.frontier = frontier
        self.refit_fallbacks = list(refit_fallbacks)
        self.segments = _segment_info(self.steps, widget_names or {})
        self._cache = _ProgramCache()

    @property
    def graph_segments(self) -> int:
        """Segments captured as CUDA graphs on a card (the CPU runs the
        same segments eagerly)."""
        return sum(1 for s in self.segments if s["kind"] == "graph")

    def _build_program(self, tables: dict) -> _StagedProgram:
        return _StagedProgram(self.steps, self.input_keys, tables, self.sink_key)

    def _input_tables(self, replacements=None) -> dict:
        tables = {}
        for key in self.input_keys:
            t = self.templates[key]
            if replacements and key[0] in replacements:
                r = replacements[key[0]]
                if r.domain != t.domain:
                    raise ValueError(
                        f"replacement table for node {key[0]} has a different "
                        "domain than the staged input")
                t = r
            tables[key] = t
        return tables

    def __call__(self, replacements: dict[int, TorchTable] | None = None) -> TorchTable:
        """Run the staged program; ``replacements`` substitutes new tables
        for boundary input nodes (same domains; a new shape builds a new
        program)."""
        tables = self._input_tables(replacements)
        out = self._cache.program(self, tables)(tables)
        if replacements:
            # every staged widget is row-preserving, so the output's logical
            # row count follows this call's inputs
            n_rows = min((tables[k].n_rows for k in self.input_keys),
                         default=self._out_meta[1])
            metas = None  # host-side metas do not flow through the device path
        else:
            metas, n_rows = self._out_meta
        return TorchTable(self.out_domain, out.X, out.Y, out.W, metas, n_rows, self.session)


class StagedTransform(StagedGraph):
    """The data path source→sink of ``stage_transform_path``: one input
    table, called as ``staged(table)``."""

    def __init__(self, steps, source_key, template, sink_key, out_domain, session,
                 donate_inputs: bool = False):
        super().__init__(steps, [source_key], {source_key: template}, sink_key, out_domain,
                         (template.metas, template.n_rows), session, [],
                         donate_inputs=donate_inputs)
        self.in_domain = template.domain

    def __call__(self, table: TorchTable) -> TorchTable:
        if table.domain != self.in_domain:
            raise ValueError("table domain does not match the staged input domain")
        tables = {self.input_keys[0]: table}
        out = self._cache.program(self, tables)(tables)
        return TorchTable(self.out_domain, out.X, out.Y, out.W, table.metas, table.n_rows,
                          self.session)


def _payload_step(nid: int, op: str, payload, feeds) -> _Step:
    capturable = op == "merge" or bool(getattr(payload, "staged_capturable", True))
    return _Step(nid, lambda ins, o=op, p=payload: apply_payload(o, p, ins), feeds,
                 capturable, None if capturable else
                 f"{type(payload).__name__}.transform reads the device from the host")


def stage_transform_path(graph: WorkflowGraph, source: int, sink: int,
                         donate_inputs: bool = False) -> StagedTransform:
    """Stage the data path source→sink of an already-run graph.

    ``source`` must emit 'data' (its cached table is the template); every
    node along the 'data' edges to ``sink`` must be a transformer, fitted
    estimator or apply widget."""
    outputs = graph.run()
    chain: list[int] = []
    cur = source
    while cur != sink:
        nxt = [e for e in graph.edges if e.src == cur and e.src_port == "data"]
        nxt = [e for e in nxt if _reaches(graph, e.dst, sink)]
        if not nxt:
            raise ValueError(f"no data path from node {cur} to sink {sink}")
        cur = nxt[0].dst
        chain.append(cur)
    template: TorchTable = outputs[source]["data"]
    steps, prev = [], (source, "data")
    for nid in chain:
        classified, reason = _node_payload(graph, nid, outputs)
        if classified is None or classified[0] == "merge":
            raise ValueError(f"node {nid} ({graph.nodes[nid].widget.name}) is not "
                             f"stageable ({reason or 'merge on a linear path'})")
        steps.append(_payload_step(nid, classified[0], classified[1], [("data", prev)]))
        prev = (nid, "data")
    return StagedTransform(steps, (source, "data"), template, prev,
                           outputs[sink]["data"].domain, template.session,
                           donate_inputs=donate_inputs)


def _table_ports(widget) -> set[str]:
    return {i.name for i in widget.inputs if i.type is TorchTable}


def _node_payload(graph: WorkflowGraph, nid: int, outputs):
    """Classify one run node into a PICKLABLE staged op: ((op, payload),
    None) when the node is device-pure (``op`` names how ``apply_payload``
    runs it, ``payload`` is the fitted object it reads, or None), else
    (None, reason). A served workflow (serve/workflow.py) stores its
    program as such records: it pickles, which closures cannot."""
    node = graph.nodes[nid]
    w = node.widget
    outs = node.outputs or {}
    if w.name == "OWApplyModel":
        model_edges = [e for e in graph.edges if e.dst == nid and e.dst_port == "model"]
        if not model_edges:
            return None, "OWApplyModel without a model input"
        e = model_edges[0]
        return ("apply", outputs[e.src][e.src_port]), None
    if w.name == "OWMergeColumns":
        return ("merge", None), None
    if "model" in outs and "data" in outs:
        return ("model", outs["model"]), None    # fitted estimator widget
    if hasattr(w, "transformer") and "data" in outs:
        return ("transformer", w.transformer), None
    if "data" not in outs:
        return None, f"{w.name}: emits no 'data' table"
    return None, f"{w.name}: host-side widget (leaves the device)"


def apply_payload(op: str, payload, ins: dict) -> TorchTable:
    """Run one classified staged op on its input tables."""
    if op == "merge":
        from orange3_spark_tpu_torch.ops.relational import merge_columns

        return merge_columns(ins["left"], ins["right"])
    if op == "model":
        try:
            return payload.transform(ins["data"])
        except NotImplementedError:
            return ins["data"]           # the eager path passes data through
    return payload.transform(ins["data"])    # "apply" | "transformer"


def _refit_fn(widget):
    """Staged fn of an estimator widget that re-FITS on the data flowing
    through the program, inside ``staging()``."""
    def fn(ins, w=widget):
        with staging():
            m = w.estimator_cls(w.params).fit(ins["data"])
            try:
                return m.transform(ins["data"])
            except NotImplementedError:
                return ins["data"]
    return fn


def _fit_runs(widget, template: TorchTable) -> tuple[bool, str | None]:
    """(True, None) when the widget's fit + transform run staged on the
    first rows of ``template`` (on its device); otherwise (False, why) with
    the actual error, so a broken fit is told apart in the report."""
    m = min(template.n_pad, _PROBE_ROWS)
    head = TorchTable(template.domain, template.X[:m],
                      None if template.Y is None else template.Y[:m], template.W[:m],
                      None if template.metas is None else template.metas[:m],
                      min(template.n_rows, m), template.session)
    try:
        _refit_fn(widget)({"data": head})
        return True, None
    except Exception as e:  # noqa: BLE001 - reported in refit_fallbacks, not swallowed
        msg = str(e).strip() or repr(e)
        return False, f"{type(e).__name__}: {msg.splitlines()[0][:300]}"


def _walk_region(graph: WorkflowGraph, sink: int, outputs, classify):
    """Backward walk from ``sink`` over table-typed edges: every node that
    ``classify`` accepts joins the region; other suppliers become boundary
    inputs and land on the frontier with their reason. Returns (region
    {nid: classified}, inputs {key: table}, frontier)."""
    region: dict[int, object] = {}
    inputs: dict[tuple[int, str], TorchTable] = {}
    frontier: list[dict] = []
    visited: set[int] = set()

    def visit(nid: int) -> bool:
        if nid in region:
            return True
        if nid in visited:
            return nid in region
        visited.add(nid)
        c, why = classify(graph, nid, outputs)
        if c is None:
            frontier.append({"node": nid, "widget": graph.nodes[nid].widget.name,
                             "reason": why})
            return False
        region[nid] = c
        tports = _table_ports(graph.nodes[nid].widget)
        for e in graph.edges:
            if e.dst == nid and e.dst_port in tports:
                src_node = graph.nodes[e.src]
                src_has_table_inputs = bool(_table_ports(src_node.widget))
                if src_has_table_inputs and visit(e.src):
                    continue
                if not src_has_table_inputs and not any(
                        f["node"] == e.src for f in frontier):
                    # pure source (reader / in-memory table): natural boundary
                    frontier.append({"node": e.src, "widget": src_node.widget.name,
                                     "reason": "source (staged input)"})
                inputs[(e.src, e.src_port)] = outputs[e.src][e.src_port]
        return True

    visit(sink)
    return region, inputs, frontier


def _feeds(graph: WorkflowGraph, region) -> dict:
    topo = [n for n in graph.topo_order() if n in region]
    feeds: dict[int, list] = {n: [] for n in topo}
    for e in graph.edges:
        if e.dst in region and e.dst_port in _table_ports(graph.nodes[e.dst].widget):
            feeds[e.dst].append((e.dst_port, (e.src, e.src_port)))
    return feeds


def stage_graph(graph: WorkflowGraph, sink: int, sink_port: str = "data",
                refit: bool = False, donate_inputs: bool = False) -> StagedGraph:
    """Stage the whole stageable DAG feeding ``sink``.

    The graph runs eagerly first (estimators FIT there; staging reads the
    fitted state). Walking backward from the sink across table-typed
    edges, every device-pure widget joins the staged region; every other
    upstream node becomes a boundary INPUT (its cached table is an
    argument of the program) and is reported on the ``frontier``.

    ``refit=True``: estimator widgets whose fit runs staged (probed on
    their template, see ``_fit_runs``) re-run ``fit`` on the data flowing
    through the program, so ``staged(replacements={src: new_table})``
    re-fits and re-scores the whole pipeline on new data in one call.
    Estimators whose fit cannot run keep their eager state and are listed
    in ``refit_fallbacks``; a checkpoint-restored widget is never refit.
    OWApplyModel always applies its eagerly fitted upstream model."""
    outputs = graph.run()
    classified, reason = _node_payload(graph, sink, outputs)
    if classified is None:
        raise ValueError(f"sink node {sink} is not stageable: {reason}")
    region, inputs, frontier = _walk_region(graph, sink, outputs, _node_payload)
    feeds = _feeds(graph, region)
    steps = {nid: _payload_step(nid, *region[nid], feeds[nid]) for nid in feeds}

    refit_fallbacks: list = []
    if refit:
        for nid in feeds:
            node = graph.nodes[nid]
            w = node.widget
            if not (hasattr(w, "estimator_cls") and "model" in (node.outputs or {})):
                continue
            if getattr(w, "fitted_model", None) is not None:
                # checkpoint-restored widget: its contract is serve-don't-refit
                refit_fallbacks.append({"node": nid, "widget": w.name,
                                        "reason": "serving a restored fitted_model; not refit"})
                continue
            data_edges = [e for e in graph.edges if e.dst == nid and e.dst_port == "data"]
            if not data_edges:
                continue
            e = data_edges[0]
            runs, why = _fit_runs(w, outputs[e.src][e.src_port])
            if not runs:
                refit_fallbacks.append({
                    "node": nid, "widget": w.name,
                    "reason": f"fit cannot run staged; kept eager fitted state ({why})"})
                continue
            capturable = bool(w.estimator_cls(w.params).staged_fit_capturable)
            steps[nid] = _Step(nid, _refit_fn(w), feeds[nid], capturable,
                               None if capturable else
                               f"{w.estimator_cls.__name__}.fit reads the device from the host")

    _check_row_preserving(graph, list(feeds), outputs)
    sink_table = outputs[sink][sink_port]
    return StagedGraph(
        [steps[n] for n in feeds], sorted(inputs), dict(inputs), (sink, sink_port),
        sink_table.domain, (sink_table.metas, sink_table.n_rows), sink_table.session,
        frontier, refit_fallbacks,
        widget_names={n: graph.nodes[n].widget.name for n in feeds},
        donate_inputs=donate_inputs)


def _check_row_preserving(graph: WorkflowGraph, topo, outputs) -> None:
    """Row preservation, asserted on the EAGER run's row counts: staged and
    served execution relabel the output's logical n_rows from the inputs,
    which is only sound if every staged widget keeps the physical rows
    (dropping is done by zeroing W, not by shrinking)."""
    for nid in topo:
        in_rows = [outputs[e.src][e.src_port].n_rows for e in graph.edges
                   if e.dst == nid and e.dst_port in _table_ports(graph.nodes[nid].widget)]
        out_t = (outputs[nid] or {}).get("data")
        if in_rows and out_t is not None and out_t.n_rows != min(in_rows):
            raise ValueError(
                f"staged widget {graph.nodes[nid].widget.name} (node {nid}) is not "
                f"row-preserving: inputs have {in_rows} rows but its output has "
                f"{out_t.n_rows}. Staged execution requires mask-based row semantics.")


def build_serve_program(graph: WorkflowGraph, sink: int, sink_port: str = "data") -> dict:
    """The SERVING program of an already-run graph: the stageable region
    feeding ``sink``, topo-ordered, each node's fitted payload stored as
    data, the picklable program a ``ServedWorkflow`` (serve/workflow.py)
    wraps. A served workflow is request-shaped: exactly ONE boundary
    input; a region with several raises with their locations.

    Returns ``{"ops", "input_key", "sink_key", "in_domain", "out_domain",
    "frontier", "graph_json"}``; ``ops`` is the topo-ordered list of
    ``{"nid", "op", "payload", "feeds"}`` records ``apply_payload`` runs."""
    outputs = graph.run()
    classified, reason = _node_payload(graph, sink, outputs)
    if classified is None:
        raise ValueError(f"sink node {sink} is not stageable: {reason}")
    region, inputs, frontier = _walk_region(graph, sink, outputs, _node_payload)
    if len(inputs) != 1:
        raise ValueError(
            "a served workflow needs exactly ONE boundary input (the request "
            f"table's entry point); this DAG's staged region has {len(inputs)}: "
            f"{sorted(inputs)} — frontier: "
            + "; ".join(f"node {f['node']} ({f['widget']}): {f['reason']}"
                        for f in frontier))
    feeds = _feeds(graph, region)
    _check_row_preserving(graph, list(feeds), outputs)
    input_key = next(iter(inputs))
    sink_table = outputs[sink][sink_port]
    return {
        "ops": [{"nid": nid, "op": region[nid][0], "payload": region[nid][1],
                 "feeds": feeds[nid]} for nid in feeds],
        "input_key": input_key,
        "sink_key": (sink, sink_port),
        "in_domain": inputs[input_key].domain,
        "out_domain": sink_table.domain,
        "frontier": frontier,
        "graph_json": graph.to_json(),
    }


def _reaches(graph: WorkflowGraph, start: int, target: int) -> bool:
    """Reachability by an iterative DFS over a prebuilt adjacency map (one
    edge scan in all)."""
    adj: dict[int, list[int]] = {}
    for e in graph.edges:
        adj.setdefault(e.src, []).append(e.dst)
    seen = set()
    stack = [start]
    while stack:
        cur = stack.pop()
        if cur == target:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(adj.get(cur, ()))
    return False
