"""Workflow graphs (the Orange canvas, headless) and their staging into
captured CUDA graphs."""

from orange3_spark_tpu_torch.workflow.graph import Edge, Node, WorkflowGraph

__all__ = ["Edge", "Node", "WorkflowGraph"]
