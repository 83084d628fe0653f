"""Workflow rendering — a dependency-free picture of a workflow graph.

Port of ``orange3_spark_tpu/workflow/render.py`` (pure Python; the same
SVG and HTML text for the same graph). Orange's canvas is Qt; this package
is headless by design, but a workflow still deserves a picture:
``render_svg`` lays a ``WorkflowGraph``
out in topological columns and draws widgets (name + non-default params)
with labeled signal links; ``render_html`` wraps it for a browser. Pure
string assembly — no Qt, no graphviz, no new dependency — so it runs in
the same environments the framework does.
"""

from __future__ import annotations

import dataclasses
import html

from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

NODE_W, NODE_H = 190, 58
GAP_X, GAP_Y = 80, 26
PAD = 24


def _depths(graph: WorkflowGraph) -> dict[int, int]:
    """Topological column per node: 1 + max over incoming edges."""
    depth = {nid: 0 for nid in graph.nodes}
    for nid in graph.topo_order():
        for e in graph.edges:
            if e.dst == nid:
                depth[nid] = max(depth[nid], depth[e.src] + 1)
    return depth


def _param_lines(widget, max_items: int = 3) -> list[str]:
    """Non-default params, most interesting first, capped for the box."""
    p = widget.params
    out = []
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        default = f.default if f.default is not dataclasses.MISSING else (
            f.default_factory() if f.default_factory is not dataclasses.MISSING
            else None)
        if v != default:
            out.append(f"{f.name}={v!r}"[:28])
    extra = len(out) - max_items
    return out[:max_items] + ([f"+{extra} more"] if extra > 0 else [])


def render_svg(graph: WorkflowGraph, title: str = "workflow") -> str:
    """The workflow as a standalone SVG document (columns = topo depth);
    ``title`` lands in the SVG <title> element (hover text / a11y name)."""
    depth = _depths(graph)
    cols: dict[int, list[int]] = {}
    for nid in graph.topo_order():
        cols.setdefault(depth[nid], []).append(nid)

    pos: dict[int, tuple[float, float]] = {}
    for d, nids in cols.items():
        for row, nid in enumerate(nids):
            pos[nid] = (PAD + d * (NODE_W + GAP_X),
                        PAD + row * (NODE_H + GAP_Y))
    width = PAD * 2 + (max(cols) + 1) * NODE_W + max(cols) * GAP_X \
        if cols else PAD * 2
    height = PAD * 2 + max(
        (len(nids) * NODE_H + (len(nids) - 1) * GAP_Y)
        for nids in cols.values()
    ) if cols else PAD * 2

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}" '
        f'font-family="sans-serif">',
        f"<title>{html.escape(title)}</title>",
        '<defs><marker id="arrow" viewBox="0 0 10 10" refX="9" refY="5" '
        'markerWidth="7" markerHeight="7" orient="auto-start-reverse">'
        '<path d="M 0 0 L 10 5 L 0 10 z" fill="#64748b"/></marker></defs>',
    ]
    for e in graph.edges:
        x1, y1 = pos[e.src]
        x2, y2 = pos[e.dst]
        sx, sy = x1 + NODE_W, y1 + NODE_H / 2
        dx, dy = x2, y2 + NODE_H / 2
        mx = (sx + dx) / 2
        label = (e.src_port if e.src_port == e.dst_port
                 else f"{e.src_port}→{e.dst_port}")
        parts.append(
            f'<path d="M {sx} {sy} C {mx} {sy}, {mx} {dy}, {dx} {dy}" '
            f'fill="none" stroke="#64748b" stroke-width="1.5" '
            f'marker-end="url(#arrow)"/>')
        parts.append(
            f'<text x="{mx}" y="{(sy + dy) / 2 - 6}" font-size="10" '
            f'fill="#64748b" text-anchor="middle">'
            f'{html.escape(label)}</text>')
    for nid, (x, y) in pos.items():
        w = graph.nodes[nid].widget
        parts.append(
            f'<rect x="{x}" y="{y}" width="{NODE_W}" height="{NODE_H}" '
            f'rx="8" fill="#f1f5f9" stroke="#334155" stroke-width="1.5"/>')
        parts.append(
            f'<text x="{x + 10}" y="{y + 20}" font-size="13" '
            f'font-weight="bold" fill="#0f172a">'
            f'{html.escape(w.name)}</text>')
        for i, line in enumerate(_param_lines(w, max_items=2)):
            parts.append(
                f'<text x="{x + 10}" y="{y + 35 + i * 12}" font-size="10" '
                f'fill="#475569">{html.escape(line)}</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def render_html(graph: WorkflowGraph, title: str = "workflow") -> str:
    """Browser-ready page embedding the SVG."""
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title></head>"
            f"<body style='margin:16px;background:#fff'>"
            f"<h3 style='font-family:sans-serif'>{html.escape(title)}</h3>"
            f"{render_svg(graph, title)}</body></html>")


def save_workflow_view(graph: WorkflowGraph, path: str,
                       title: str = "workflow") -> None:
    """Write the rendering to ``path`` (.svg or .html by extension)."""
    content = (render_html(graph, title) if path.endswith((".html", ".htm"))
               else render_svg(graph, title))
    with open(path, "w", encoding="utf-8") as f:
        f.write(content)
