"""The port's tests' artifact directories: an autouse fixture that points
the flight recorder's bundles (``OTPU_FLIGHT_DIR``) and the deep
captures (``OTPU_PROF_DIR``) at the test's own ``tmp_path``, so no test
writes to the knobs' shared defaults. A test module takes it with

    from _torch_artifacts import artifact_dirs  # noqa: F401
"""

from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def artifact_dirs(tmp_path, monkeypatch):
    """``tmp_path/flight`` and ``tmp_path/prof`` for this test."""
    monkeypatch.setenv("OTPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("OTPU_PROF_DIR", str(tmp_path / "prof"))
    return tmp_path
