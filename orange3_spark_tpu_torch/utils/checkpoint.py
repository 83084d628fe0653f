"""Save and load fitted models and fitted workflows (MLlib model.save/load).

Port of ``orange3_spark_tpu/utils/checkpoint.py``. A fitted model is a
pickle of the model object: ``Transformer.__getstate__`` turns its tensors
into numpy arrays, so the file is portable between hosts and devices, and
they come back on the active session's device. A fitted WORKFLOW is its
``.ows``-equivalent JSON (``WorkflowGraph.to_json``) plus each fitted
node's model; restoring sets each estimator widget's ``fitted_model``, so
the next ``run()`` serves the saved models without refitting (until a
setting or an upstream signal changes).

Layout: ``<path>/model.pkl`` for a model; ``<path>/workflow.json`` and
``<path>/node<id>/model.pkl`` for a workflow. Unpickle only files this
program wrote: unpickling can run arbitrary code.
"""

from __future__ import annotations

import os
import pickle

from orange3_spark_tpu_torch.models.base import Model
from orange3_spark_tpu_torch.workflow.graph import WorkflowGraph

MODEL_FILE = "model.pkl"
WORKFLOW_FILE = "workflow.json"


def save_model(model: Model, path: str) -> None:
    """Persist a fitted model (MLlib model.save equivalent).

    Write to a temporary file, fsync, rename: a crash mid-save never
    leaves a torn ``model.pkl`` where a reader expects a whole one."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, MODEL_FILE)
    tmp = f"{final}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(model, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def load_model(path: str) -> Model:
    """Reload a fitted model (MLlib Model.load equivalent); its tensors go
    to the active session's device."""
    with open(os.path.join(path, MODEL_FILE), "rb") as f:
        return pickle.load(f)


def save_workflow(graph: WorkflowGraph, path: str) -> None:
    """Checkpoint a RUN workflow: spec JSON + every fitted node model."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, WORKFLOW_FILE), "w") as f:
        f.write(graph.to_json())
    for nid, node in graph.nodes.items():
        model = (node.outputs or {}).get("model")
        if isinstance(model, Model):
            save_model(model, os.path.join(path, f"node{nid}"))


def load_workflow(path: str) -> WorkflowGraph:
    """Restore a checkpointed workflow: estimator nodes get their fitted
    models back and will SERVE (not refit) on the next run(). Data source
    nodes (``OWTable``) come back empty: set their table before running."""
    with open(os.path.join(path, WORKFLOW_FILE)) as f:
        graph = WorkflowGraph.from_json(f.read())
    for nid, node in graph.nodes.items():
        mdir = os.path.join(path, f"node{nid}")
        if os.path.isdir(mdir):
            node.widget.fitted_model = load_model(mdir)
    return graph
