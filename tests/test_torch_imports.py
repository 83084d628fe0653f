"""The port stands alone: no module of orange3_spark_tpu_torch imports jax or
orange3_spark_tpu, and its session runs on the GPU unless told otherwise."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.ops import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "orange3_spark_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import orange3_spark_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "orange3_spark_tpu")]
    assert not leaked, leaked
    print(len(names))
""")


def test_every_module_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12   # every module was walked


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py, the script that drives the port on the card, imports
    neither jax nor the JAX package either."""
    code = _BLOCKED_IMPORT.replace(
        "import orange3_spark_tpu_torch as pkg",
        "import runpy\nrunpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "import orange3_spark_tpu_torch as pkg")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_session_is_cuda_or_raises():
    """No argument means the GPU; without CUDA it raises, never falling back
    to the CPU by itself."""
    if torch.cuda.is_available():
        assert TorchSession().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchSession()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchSession("cuda")


def test_cpu_session_on_request():
    sess = TorchSession("cpu")
    assert sess.device == torch.device("cpu")
    assert sess.n_devices == 1
    assert (sess.pad_rows(0), sess.pad_rows(37)) == (1, 37)
    sess.synchronize()                            # a no-op on the CPU
    active = TorchSession.builder_get_or_create("cpu")
    assert TorchSession.builder_get_or_create() is active
    assert TorchSession.active() is active


def test_kernel_library_name_follows_source_and_flags():
    """A built library is named by a hash of its source and nvcc flags, so
    an edited kernel is rebuilt, never mixed with a stale build."""
    path = cuda_build.library_path("histogram")
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libhistogram-") and path.suffix == ".so"
    assert "-gencode=arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")) == ["histogram"]
