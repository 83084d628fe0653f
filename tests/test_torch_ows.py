"""The port's ``workflow/ows.py`` and ``workflow/render.py`` against the JAX
package's: the reference's ``.ows`` cases (tests/test_ows.py) and a canvas
scheme of wrangling widgets (``chip_smoke.canvas_ows``) load into the same
graph and report in both, run to the same outputs, and render to the same
SVG and HTML text; files and workflow JSON written by either package load
in the other.

Tolerances: graphs, reports, params and rendered text are equal. Outputs
are bitwise, except the aggregated sums and means, which are float32 sums
of up to N = 500 non-negative terms in another order: within N·2^-24
relative (each add rounds by at most 2^-24 of the total). The reference
runs the canvas graph on one device: its group min and max of a column
with a live NaN depend on the device count (tests/test_torch_relational.py).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from _torch_artifacts import artifact_dirs  # noqa: F401
import orange3_spark_tpu.utils  # noqa: F401 - the JAX package's import order
from orange3_spark_tpu.widgets import catalog as jcat
from orange3_spark_tpu.workflow import ows as jows
from orange3_spark_tpu.workflow import render as jrender
from orange3_spark_tpu.workflow.graph import WorkflowGraph as JGraph
from orange3_spark_tpu_torch import TorchSession
from orange3_spark_tpu_torch.datasets import write_tlc_sqlite
from orange3_spark_tpu_torch.widgets import catalog as tcat
from orange3_spark_tpu_torch.workflow import ows as tows
from orange3_spark_tpu_torch.workflow import render as trender
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

from _torch_tables import assert_tables
from test_ows import CANVAS_OWS, OWS

TRIPS = 500
SUM_RTOL = TRIPS * 2.0**-24
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tsess():
    return TorchSession.builder_get_or_create("cpu")


@pytest.fixture(scope="module")
def jsess1():
    import jax

    from orange3_spark_tpu.core.session import TpuSession

    return TpuSession(TpuSession.default_mesh(jax.devices()[:1]))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _shape(graph):
    """A graph's nodes (widget, params), links and import report."""
    return ({nid: (n.widget.name, n.widget.params.to_dict()) for nid, n in graph.nodes.items()},
            sorted((e.src, e.src_port, e.dst, e.dst_port) for e in graph.edges),
            list(getattr(graph, "import_report", [])))


def _write(tmp_path, text, name="flow.ows"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("text,strict", [(OWS, True), (OWS, False), (CANVAS_OWS, False)])
def test_reference_cases_load_into_the_same_graph(session, tsess, tmp_path, text, strict):
    path = _write(tmp_path, text)
    jg, tg = jows.read_ows(path, strict=strict), tows.read_ows(path, strict=strict)
    assert _shape(tg) == _shape(jg)
    assert trender.render_svg(tg, "t") == jrender.render_svg(jg, "t")
    assert trender.render_html(tg, "a & b") == jrender.render_html(jg, "a & b")


@pytest.mark.parametrize("text,match", [(CANVAS_OWS, "Distances"),
                                        (OWS.replace("CSV File Import", "Mystery 3000").replace(
                                            "owcsvimport.OWCSVFileImport", "m.OWMystery"),
                                         "no catalog widget")])
def test_strict_errors_match(session, tsess, tmp_path, text, match):
    path = _write(tmp_path, text)
    for mod in (jows, tows):
        with pytest.raises(ValueError, match=match) as e:
            mod.read_ows(path)
        assert match in str(e.value)
    with pytest.raises(ValueError) as je:
        jows.read_ows(path)
    with pytest.raises(ValueError) as te:
        tows.read_ows(path)
    assert str(je.value) == str(te.value)


def _canvas(smoke, tmp_path, seed=1):
    db = str(tmp_path / "tlc.db")
    write_tlc_sqlite(db, TRIPS, seed)
    return _write(tmp_path, smoke.canvas_ows(db, str(tmp_path)), "tlc.ows"), db


def test_canvas_wrangling_scheme_runs_to_the_reference_outputs(jsess1, tsess, tmp_path,
                                                              smoke):
    path, db = _canvas(smoke, tmp_path)
    jg, tg = jows.read_ows(path), tows.read_ows(path)
    assert _shape(tg) == _shape(jg) and tg.import_report == []
    assert [n.widget.name for _, n in sorted(tg.nodes.items())] == [
        "OWSqlReader", "OWSelectRows", "OWGroupBy", "OWSqlReader", "OWJoin", "OWSaveData",
        "OWPivot", "OWSaveData"]
    assert trender.render_svg(tg, "tlc") == jrender.render_svg(jg, "tlc")
    for g, tag in ((jg, "ref"), (tg, "port")):
        for nid, node in g.nodes.items():
            if node.widget.name == "OWSaveData":
                base = os.path.basename(node.widget.params.path)
                g.set_params(nid, path=str(tmp_path / f"{tag}_{base}"))
    with jsess1.use():
        jout = jg.run()
    tout = tg.run()
    for nid, node in tg.nodes.items():
        if node.widget.name == "OWSaveData":
            continue
        assert_tables(jout[nid]["data"], tout[nid]["data"], rtol=SUM_RTOL,
                      what=node.widget.name)
    # the files the two Save Data nodes wrote: the same rows, sums within tolerance
    from orange3_spark_tpu_torch.io.native import read_csv_native
    from orange3_spark_tpu_torch.io.readers import read_sql

    ref_csv = read_csv_native(str(tmp_path / "ref_borough_payment.csv"), session=tsess)
    got_csv = read_csv_native(str(tmp_path / "port_borough_payment.csv"), session=tsess)
    np.testing.assert_allclose(got_csv.to_numpy()[0], ref_csv.to_numpy()[0], rtol=SUM_RTOL)
    q = "SELECT * FROM tip_pivot"
    ref_sql = read_sql(q, str(tmp_path / "ref_tip_pivot.db"), session=tsess)
    got_sql = read_sql(q, str(tmp_path / "port_tip_pivot.db"), session=tsess)
    assert ref_sql.domain == got_sql.domain
    np.testing.assert_allclose(got_sql.to_numpy()[0], ref_sql.to_numpy()[0], rtol=SUM_RTOL)


def test_smoke_phase_on_the_cpu(tsess, tmp_path, smoke, monkeypatch):
    """``chip_smoke.phase_ows`` rehearsed with the CPU standing for the card."""
    monkeypatch.setattr(smoke, "OWS_TRIPS", TRIPS)
    line = smoke.phase_ows(str(tmp_path), card_device="cpu")
    assert line["import_report"] == [] and line["edges"] == 7
    assert all(c["equal"] for c in line["checks"].values())


def test_files_written_by_either_package_load_in_the_other(session, tsess, tmp_path, smoke):
    path, _ = _canvas(smoke, tmp_path)
    tg = tows.read_ows(path)
    tows.write_ows(tg, str(tmp_path / "port.ows"), title="t")
    jows.write_ows(jows.read_ows(path), str(tmp_path / "ref.ows"), title="t")
    a, b = jows.read_ows(str(tmp_path / "port.ows")), tows.read_ows(str(tmp_path / "ref.ows"))
    assert _shape(a) == _shape(b) == _shape(tg)[:2] + ([],)
    text = (tmp_path / "port.ows").read_text()
    assert 'project_name="orange3_spark_tpu_torch"' in text
    # the workflow JSON of the reference's graph loads in the port, saves
    # back to the same JSON and runs to the graph's outputs
    jg = jows.read_ows(path)
    g = WorkflowGraph.from_json(jg.to_json())
    assert json.loads(g.to_json()) == json.loads(jg.to_json())
    outs, want = g.run(), tg.run()
    for nid, node in g.nodes.items():
        if node.widget.name != "OWSaveData":
            assert_tables(want[nid]["data"], outs[nid]["data"])


def test_every_catalog_widget_survives_an_ows_round_trip(tsess, tmp_path):
    """Each registered widget exports and imports (strict) with its params,
    and a data link into it survives; the reader and wrangling widgets
    carry the reference's registry names (which it registers at import;
    others it registers inside ``except ImportError`` blocks, which an
    import order can skip)."""
    from orange3_spark_tpu_torch.datasets import load_iris

    for wname in ("OWCsvReader", "OWParquetReader", "OWLibsvmReader", "OWSqlReader",
                  "OWJoin", "OWGroupBy", "OWPivot", "OWSaveData"):
        assert wname in jcat.WIDGET_REGISTRY and wname in tcat.WIDGET_REGISTRY, wname
    iris = load_iris(tsess)
    failures = []
    for wname, wcls in sorted(tcat.WIDGET_REGISTRY.items()):
        g = WorkflowGraph()
        w = tcat.OWTable(iris) if wname == "OWTable" else wcls()
        nid = g.add(w)
        ins = sorted(i.name for i in wcls.inputs)
        if ins:
            src = g.add(tcat.OWTable(iris))
            for port in ins:
                g.connect(src, "data", nid, port)
        p = str(tmp_path / f"{wname}.ows")
        tows.write_ows(g, p)
        g2 = tows.read_ows(p, strict=True)
        w2 = next(n.widget for n in g2.nodes.values() if n.widget.name == wname)
        if len(g2.edges) != len(g.edges) or w2.params.to_dict() != w.params.to_dict():
            failures.append(wname)
    assert not failures, failures


def test_canvas_names_resolve_as_in_the_reference(session):
    """Every name of the reference's table resolves to the same widget in
    the port, or to none where the port has not ported that widget."""
    for alias, want in jows._NAME_MAP.items():
        got = tows._resolve_widget(alias, "")
        assert got == (want if want in tcat.WIDGET_REGISTRY else None), alias
    for name in ("Merge Data", "Pivot Table", "Aggregate Columns", "SQL Table", "Save Data",
                 "CSV File Import", "File"):
        assert tows._resolve_widget(name, "") == jows._resolve_widget(name, "")


def test_render_of_a_wrangling_graph_and_save_view(session, tsess, tmp_path):
    """The same graph built in both packages renders to the same text;
    ``save_workflow_view`` writes it by extension."""
    graphs = []
    for cat, Graph in ((jcat, JGraph), (tcat, WorkflowGraph)):
        g = Graph()
        a = g.add(cat.WIDGET_REGISTRY["OWCsvReader"](path="trips.csv", class_col="tip"))
        b = g.add(cat.WIDGET_REGISTRY["OWGroupBy"](keys=("k",), aggs=(("v", "sum"),)))
        c = g.add(cat.WIDGET_REGISTRY["OWSqlReader"](query="SELECT 1", database="z.db"))
        d = g.add(cat.WIDGET_REGISTRY["OWJoin"](on="k", max_matches=2))
        g.connect(a, "data", b, "data")
        g.connect(b, "data", d, "left")
        g.connect(c, "data", d, "right")
        graphs.append(g)
    assert trender.render_svg(graphs[1], "w") == jrender.render_svg(graphs[0], "w")
    trender.save_workflow_view(graphs[1], str(tmp_path / "w.html"), "w")
    jrender.save_workflow_view(graphs[0], str(tmp_path / "r.html"), "w")
    assert (tmp_path / "w.html").read_text() == (tmp_path / "r.html").read_text()
    trender.save_workflow_view(graphs[1], str(tmp_path / "w.svg"))
    assert (tmp_path / "w.svg").read_text().startswith("<svg")
