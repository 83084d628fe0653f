"""The port's tests' artifact directories: an autouse fixture that points
the flight recorder's bundles (``OTPU_FLIGHT_DIR``) and the deep
captures (``OTPU_PROF_DIR``) at the test's own ``tmp_path``, so no test
writes to the knobs' shared defaults. A test module takes it with

    from _torch_artifacts import artifact_dirs  # noqa: F401

Importing it also caps torch's intra-op threads under pytest-xdist: each
of ``PYTEST_XDIST_WORKER_COUNT`` workers gets its share of the cores
(at least one). Without the cap every worker opens OpenMP regions on all
the cores, and a loop of many small ops in one worker waits behind the
other workers' threads. Run alone (no xdist), torch keeps its default.
"""

from __future__ import annotations

import os

import pytest
import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))


@pytest.fixture(autouse=True)
def artifact_dirs(tmp_path, monkeypatch):
    """``tmp_path/flight`` and ``tmp_path/prof`` for this test."""
    monkeypatch.setenv("OTPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("OTPU_PROF_DIR", str(tmp_path / "prof"))
    return tmp_path
