"""The port stands alone: no module of orange3_spark_tpu_torch imports jax or
orange3_spark_tpu or reads a file inside it (nor ml_dtypes or optax, which
come with jax and are absent on the GPU machine), and its session runs on
the GPU unless told otherwise."""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.ops import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "orange3_spark_tpu_torch")

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "orange3_spark_tpu", "ml_dtypes", "optax"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import orange3_spark_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "orange3_spark_tpu", "ml_dtypes", "optax")]
    assert not leaked, leaked
    print(len(names))
""")


def test_every_module_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 73   # every module was walked


@pytest.mark.parametrize("sub,n_modules", [("serve", 5), ("obs", 4), ("resilience", 5),
                                           ("utils", 6), ("online", 1), ("ops", 7),
                                           ("optim", 1), ("io", 3), ("models", 15)])
def test_serving_layers_import_without_jax(sub, n_modules):
    """The serving path, the fit's recovery layers (the checkpointer, the
    numerics guard, the watchdog), the kernels' wrappers and the host
    layers they stand on (copies of the JAX package's modules) import
    neither jax, ml_dtypes, optax nor anything of the JAX package, each
    subpackage on its own."""
    code = _BLOCKED_IMPORT.replace("import orange3_spark_tpu_torch as pkg",
                                   f"import orange3_spark_tpu_torch.{sub} as pkg")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= n_modules


@pytest.mark.parametrize("module", ["orange3_spark_tpu_torch.models.als",
                                    "orange3_spark_tpu_torch.ops.normal_equations",
                                    "orange3_spark_tpu_torch.utils.checkpoint",
                                    "orange3_spark_tpu_torch.models.evaluation"])
def test_recommender_modules_import_without_jax(module):
    """The ALS slice's modules, each on its own behind the blocker: ALS,
    its kernel's wrapper, model and workflow saving, the evaluators."""
    code = _BLOCKED_IMPORT.split("import orange3_spark_tpu_torch as pkg")[0] + textwrap.dedent(f"""
        importlib.import_module({module!r})
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "orange3_spark_tpu", "ml_dtypes", "optax")]
        assert not leaked, leaked
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


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
    assert sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")) == [
        "histogram", "normal_equations", "segment_sum"]


def _port_sources(suffixes):
    for d, _, files in os.walk(PORT):
        if "_build" in d.split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in sorted(files) if f.endswith(suffixes))


def _code_strings(path):
    """The string literals of a Python file, docstrings left out."""
    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_source_of_the_port_names_a_path_in_the_jax_package():
    """The port reads nothing inside orange3_spark_tpu/: no string in its
    Python code and nothing outside the comments of its C++/CUDA sources
    names that directory (the fastcsv copy is compiled from the port's
    own native/)."""
    pattern = re.compile(r"orange3_spark_tpu(?!_torch)")
    checked = 0
    for path in _port_sources((".py",)):
        hits = [s for s in _code_strings(path) if pattern.search(s)]
        assert not hits, (path, hits)
        checked += 1
    for path in _port_sources((".cpp", ".cu", ".cuh", ".h")):
        text = open(path).read()
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
        assert not pattern.search(code), path
        checked += 1
    assert checked >= 24
    assert os.path.exists(os.path.join(PORT, "native", "fastcsv.cpp"))


def test_no_source_of_the_port_imports_jax_companions():
    """No import statement of the port names jax, ml_dtypes or optax, even
    one inside a function that the import walk above would not run."""
    banned = {"jax", "jaxlib", "ml_dtypes", "optax", "orange3_spark_tpu"}
    for path in list(_port_sources((".py",))) + [os.path.join(ROOT, "chip_smoke.py")]:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, (path, names)
