"""Orange ``.ows`` workflow file import/export.

Port of ``orange3_spark_tpu/workflow/ows.py`` (pure Python). Orange's
canvas saves workflows as ``.ows`` XML (scheme/nodes/links/node_properties).
This module maps those files onto the headless ``WorkflowGraph``, so a
workflow built in the canvas runs here, on the session's device:

* ``read_ows(path)`` — parse the XML, resolve each node's widget by a name
  table (known Orange/OWSpark* widgets) and a normalized exact match
  against the widget catalog, map signal channels (Data/Model/...), and
  apply ``format="literal"`` node settings whose keys match the widget's
  Params fields;
* ``write_ows(graph, path)`` — emit a scheme XML Orange can open (nodes get
  this package's qualified names; positions are synthesized on a grid).

The name table is the reference's, so the same file resolves to the same
widgets. A name that maps to a widget this package has not ported yet is
unmappable here. Unmappable widgets raise by default (``strict=True``) or
are skipped with their links dropped (``strict=False``) — a partial import
is reported in ``graph.import_report``, never silent.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import xml.etree.ElementTree as ET

from orange3_spark_tpu_torch.widgets.catalog import WIDGET_REGISTRY
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

#: the package name written into the nodes of an exported scheme
PROJECT = __name__.split(".")[0]

# explicit Orange/reference-add-on widget name -> catalog name. Catalog
# widgets whose own name normalizes to the canvas title (e.g. 'k-Means' ->
# kmeans -> OWKMeans) resolve by the registry's exact match below and need
# no row here; this table carries the names that DIFFER — Orange3 canvas
# titles and OWSpark*-era aliases.
_NAME_MAP = {
    # environment / sources / viewers
    "owsparkcontext": "OWTpuContext",
    "sparkcontext": "OWTpuContext",
    "sparkenvironment": "OWTpuContext",
    "owcsvfileimport": "OWCsvReader",
    "csvfileimport": "OWCsvReader",
    "owfile": "OWCsvReader",
    "file": "OWCsvReader",
    "sparkdatasetreader": "OWCsvReader",
    "sqltable": "OWSqlReader",
    "owsqltable": "OWSqlReader",
    "libsvmfile": "OWLibsvmReader",
    "datatable": "OWTableView",
    "owdatatable": "OWTableView",
    "datainfo": "OWDataInfo",
    "owdatainfo": "OWDataInfo",
    "savedata": "OWSaveData",
    "owsavedata": "OWSaveData",
    "save": "OWSaveData",
    # scoring / application
    "predictions": "OWApplyModel",
    "owpredictions": "OWApplyModel",
    "applymodel": "OWApplyModel",
    "testandscore": "OWMulticlassEvaluator",
    "owtestandscore": "OWMulticlassEvaluator",
    "owtestlearners": "OWMulticlassEvaluator",
    # wrangling (Orange canvas titles)
    "selectcolumns": "OWSelectColumns",
    "owselectattributes": "OWSelectColumns",
    "selectattributes": "OWSelectColumns",
    "selectrows": "OWSelectRows",
    "owselectrows": "OWSelectRows",
    "pivottable": "OWPivot",
    "owpivot": "OWPivot",
    "aggregate": "OWGroupBy",
    "owaggregatecolumns": "OWGroupBy",
    "mergedata": "OWJoin",
    "owmergedata": "OWJoin",
    "editdomain": "OWSelectColumns",
    "transpose": "OWPivot",
    # preprocessing (Orange canvas titles -> closest transformer)
    "impute": "OWImputer",
    "owimpute": "OWImputer",
    "continuize": "OWOneHotEncoder",
    "owcontinuize": "OWOneHotEncoder",
    "discretize": "OWQuantileDiscretizer",
    "owdiscretize": "OWQuantileDiscretizer",
    "normalize": "OWNormalizer",
    "scaling": "OWStandardScaler",
    "featureconstructor": "OWRFormula",
    "owfeatureconstructor": "OWRFormula",
    "bagofwords": "OWCountVectorizer",
    "owbagofwords": "OWCountVectorizer",
    "corpustonetwork": "OWNGram",
    # models (Orange canvas titles / MLlib names)
    "randomforest": "OWRandomForestClassifier",
    "owrandomforest": "OWRandomForestClassifier",
    "randomforestregression": "OWRandomForestRegressor",
    "gradientboosting": "OWGBTClassifier",
    "owgradientboosting": "OWGBTClassifier",
    "gradientboostedtrees": "OWGBTClassifier",
    "tree": "OWDecisionTreeClassifier",
    "owtree": "OWDecisionTreeClassifier",
    "decisiontree": "OWDecisionTreeClassifier",
    "svm": "OWLinearSVC",
    "owsvm": "OWLinearSVC",
    "linearsvm": "OWLinearSVC",
    "neuralnetwork": "OWMultilayerPerceptronClassifier",
    "ownnlearner": "OWMultilayerPerceptronClassifier",
    "mlpclassifier": "OWMultilayerPerceptronClassifier",
    "sgd": "OWStreamingLinearEstimator",
    "owsgd": "OWStreamingLinearEstimator",
    "stochasticgradientdescent": "OWStreamingLinearEstimator",
    "louvainclustering": "OWKMeans",
    "word2vecembedding": "OWWord2Vec",
    "collaborativefiltering": "OWALS",
    "owals": "OWALS",
    "frequentitemsets": "OWFPGrowth",
    "associationrules": "OWFPGrowth",
    "correspondenceanalysis": "OWPCA",
    "owpcawidget": "OWPCA",
}

_CHANNEL_MAP = {
    "data": "data", "preprocesseddata": "data", "sampledata": "data",
    "table": "data", "dataframe": "data", "transformeddata": "data",
    "scoreddata": "data", "selecteddata": "data", "remainingdata": "data",
    "corpus": "data", "matchingdata": "data",
    "model": "model", "learner": "model", "classifier": "model",
    "predictor": "model", "predictors": "model", "transformer": "model",
    "fittedmodel": "model", "clusterer": "model",
    "evaluationresults": "score", "results": "score",
}


# _NAME_MAP rows that are semantic APPROXIMATIONS, not same-algorithm
# renames: the import still works, but the substitution is recorded in
# graph.import_report so the result's divergence from the saved workflow
# is traceable (same contract as skipped nodes/links).
_APPROX_ALIASES = {
    "louvainclustering", "correspondenceanalysis", "transpose",
    "editdomain", "corpustonetwork", "scaling", "featureconstructor",
}


def _norm(name: str) -> str:
    return re.sub(r"[^a-z0-9]", "", name.lower())


def _resolve_widget(name: str, qualified: str) -> str | None:
    """Map an Orange node (name/qualified_name) to a catalog widget name."""
    candidates = [qualified.rsplit(".", 1)[-1], name]
    for c in candidates:
        n = _norm(c)
        if n in _NAME_MAP:
            # a widget of the JAX package's catalog not ported here is unmappable
            return _NAME_MAP[n] if _NAME_MAP[n] in WIDGET_REGISTRY else None
    # normalized EXACT match against the registry ('Spark Logistic
    # Regression' / 'OWLogisticRegression' both reduce to
    # logisticregression). Deliberately no substring fallback: 'Pivot
    # Table' must NOT silently become OWTable — strict mode promises a
    # faithful import or an error.
    reg_norm = {_norm(k.removeprefix("OW")): k for k in WIDGET_REGISTRY}
    for c in candidates:
        n = _norm(c).removeprefix("ow").removeprefix("spark")
        if n in reg_norm:
            return reg_norm[n]
    return None


def _map_channel(widget, channel: str, kind: str) -> str | None:
    names = widget.output_names() if kind == "out" else widget.input_names()
    n = _norm(channel)
    mapped = _CHANNEL_MAP.get(n, n)
    if mapped in names:
        return mapped
    if len(names) == 1:
        return next(iter(names))
    return None


def read_ows(path: str, *, strict: bool = True) -> WorkflowGraph:
    """Parse an Orange .ows scheme into a WorkflowGraph.

    Returns the graph; ``graph.import_report`` lists skipped nodes/links
    when strict=False.
    """
    root = ET.parse(path).getroot()
    graph = WorkflowGraph()
    id_map: dict[str, int] = {}
    skipped: list[str] = []

    nodes_el = root.find("nodes")
    for nd in (nodes_el if nodes_el is not None else ()):
        name = nd.get("name", "")
        qualified = nd.get("qualified_name", "")
        wname = _resolve_widget(name, qualified)
        if wname is None:
            msg = f"no catalog widget for .ows node {name!r} ({qualified!r})"
            if strict:
                raise ValueError(msg + "; pass strict=False to skip it")
            skipped.append(msg)
            continue
        if any(_norm(c) in _APPROX_ALIASES
               for c in (qualified.rsplit(".", 1)[-1], name)):
            skipped.append(
                f".ows node {name!r} approximated by {wname} "
                "(different algorithm; results will differ)"
            )
        id_map[nd.get("id")] = graph.add(WIDGET_REGISTRY[wname]())

    props = root.find("node_properties")
    if props is not None:
        for pr in props:
            nid = pr.get("node_id")
            if nid not in id_map or pr.get("format") != "literal":
                continue
            try:
                settings = ast.literal_eval(pr.text or "{}")
            except (ValueError, SyntaxError):
                skipped.append(
                    f"settings for node {nid} unparsable; defaults kept"
                )
                continue
            node = graph.nodes[id_map[nid]]
            fields = {f.name for f in dataclasses.fields(node.widget.params)}
            keep = {k: v for k, v in (settings or {}).items() if k in fields}
            if keep:
                graph.set_params(id_map[nid], **keep)

    links_el = root.find("links")
    for ln in (links_el if links_el is not None else ()):
        s, d = ln.get("source_node_id"), ln.get("sink_node_id")
        if s not in id_map or d not in id_map:
            skipped.append(f"link {s}->{d} dropped (unmapped endpoint)")
            continue
        src, dst = id_map[s], id_map[d]
        sp = _map_channel(graph.nodes[src].widget, ln.get("source_channel", ""), "out")
        dp = _map_channel(graph.nodes[dst].widget, ln.get("sink_channel", ""), "in")
        if sp is None or dp is None:
            msg = (f"cannot map channels {ln.get('source_channel')!r}->"
                   f"{ln.get('sink_channel')!r} for link {s}->{d}")
            if strict:
                raise ValueError(msg)
            skipped.append(msg)
            continue
        graph.connect(src, sp, dst, dp)

    graph.import_report = skipped
    return graph


def write_ows(graph: WorkflowGraph, path: str, *, title: str = "workflow") -> None:
    """Emit an Orange-openable .ows scheme for this graph."""
    root = ET.Element("scheme", version="2.0", title=title, description="")
    nodes_el = ET.SubElement(root, "nodes")
    links_el = ET.SubElement(root, "links")
    ET.SubElement(root, "annotations")
    props_el = ET.SubElement(root, "node_properties")
    for i, (nid, node) in enumerate(sorted(graph.nodes.items())):
        ET.SubElement(
            nodes_el, "node",
            id=str(nid), name=node.widget.name,
            qualified_name=f"{PROJECT}.widgets.{node.widget.name}",
            project_name=PROJECT, version="",
            title=node.widget.name,
            position=f"({150 + 150 * (i % 5)}, {150 + 120 * (i // 5)})",
        )
        p = ET.SubElement(props_el, "properties", node_id=str(nid),
                          format="literal")
        p.text = repr(node.widget.params.to_dict())
    for j, e in enumerate(graph.edges):
        ET.SubElement(
            links_el, "link", id=str(j),
            source_node_id=str(e.src), sink_node_id=str(e.dst),
            source_channel=e.src_port, sink_channel=e.dst_port,
            enabled="true",
        )
    ET.ElementTree(root).write(path, encoding="unicode", xml_declaration=True)
