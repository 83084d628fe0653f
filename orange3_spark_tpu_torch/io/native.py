"""ctypes binding for the native fastcsv engine (``native/fastcsv.cpp``).

The port keeps its own copy of the C++ source. On first use it is compiled
with ``g++ -O3 -std=c++17 -fPIC -shared -pthread`` into the git-ignored
``orange3_spark_tpu_torch/_build/``, under a file name that carries a hash
of the source and the flags, so an edited source is rebuilt and never mixed
with a stale library. The parser fills row-major float32 chunks that go to
the device as they are (one host-to-device copy per chunk).

Without a C++ compiler every entry point raises ``NativeUnavailable``:
there is no slower fallback reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import weakref
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "fastcsv.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastcsv-{digest}.so"


def _build(target: Path) -> None:
    # compile to a temporary name, then rename: another process may race us
    # to load the final path and must never see a half-written library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, target)
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        if tmp.exists():
            tmp.unlink()
        raise NativeUnavailable(f"fastcsv build failed: {detail}") from e


def tune_malloc() -> None:
    """Keep large allocations in the heap arena instead of per-call mmap.

    Every parsed chunk is a fresh ~40 MB numpy buffer; glibc serves those
    via mmap and unmaps them on free, so each chunk pays its page faults
    again. Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD keeps the pages
    resident across chunks.

    Process-wide: afterwards any transient allocation up to 1 GB stays in
    the heap and is never given back to the OS. That suits a dedicated
    ingest or benchmark process, not a host application, so it is an
    explicit opt-in that loading the library does not make."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass  # not glibc: nothing to tune


def get_lib() -> ctypes.CDLL:
    """Load the fastcsv shared library, building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        lib.fcsv_open.restype = ctypes.c_void_p
        lib.fcsv_open.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int]
        lib.fcsv_ncols.restype = ctypes.c_int
        lib.fcsv_ncols.argtypes = [ctypes.c_void_p]
        lib.fcsv_colname.restype = ctypes.c_char_p
        lib.fcsv_colname.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fcsv_read_chunk.restype = ctypes.c_long
        lib.fcsv_read_chunk.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_int,
        ]
        lib.fcsv_close.restype = None
        lib.fcsv_close.argtypes = [ctypes.c_void_p]
        lib.fcsv_set_categorical.restype = ctypes.c_int
        lib.fcsv_set_categorical.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.fcsv_write.restype = ctypes.c_int
        lib.fcsv_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char,
        ]
        _lib = lib
        return _lib


def _register_close(owner, lib, handle):
    """Close a native handle exactly once when ``owner`` dies.

    The callback holds only (lib, handle), never the owner, and skips the
    native call while the interpreter is finalizing, when the library's
    function pointers may already be gone."""

    def _close(lib=lib, handle=handle):
        if not sys.is_finalizing():
            lib.fcsv_close(handle)

    return weakref.finalize(owner, _close)


class NativeCsvReader:
    """Chunked reader over one CSV file.

    >>> with NativeCsvReader("data.csv") as r:
    ...     for chunk in r.chunks(1 << 18):   # f32 [rows, ncols]
    ...         ...
    """

    def __init__(self, path: str, *, delimiter: str = ",", header: bool = True,
                 n_threads: int = 0,
                 categorical_cols: "tuple[int | str, ...]" = ()):
        """categorical_cols: column indices or header names whose cells are
        crc32 & 0xFFFFFF string-hashed at parse time instead of parsed as
        floats (hex-string categories, as real Criteo ships them)."""
        self._lib = get_lib()
        self._h = self._lib.fcsv_open(
            str(path).encode(), delimiter.encode()[0:1] or b",", int(header))
        if not self._h:
            raise FileNotFoundError(path)
        self._finalizer = _register_close(self, self._lib, self._h)
        self.n_threads = n_threads
        self.ncols = self._lib.fcsv_ncols(self._h)

        def _unquote(s: str) -> str:   # one RFC-4180 outer pair
            if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
                return s[1:-1].replace('""', '"')
            return s

        self.colnames = [
            _unquote(self._lib.fcsv_colname(self._h, j).decode())
            for j in range(self.ncols)
        ]
        self.categorical_cols: tuple[int, ...] = tuple(
            sorted(self._resolve_col(c) for c in categorical_cols))
        for j in self.categorical_cols:
            self._lib.fcsv_set_categorical(self._h, j, 1)

    def _resolve_col(self, col: "int | str") -> int:
        if isinstance(col, str):
            if col not in self.colnames:
                raise ValueError(f"column {col!r} not in {self.colnames}")
            return self.colnames.index(col)
        j = int(col)
        if not 0 <= j < self.ncols:
            raise ValueError(f"column index {j} out of range 0..{self.ncols - 1}")
        return j

    def read_chunk(self, max_rows: int) -> np.ndarray | None:
        """Next up-to-max_rows rows as f32 [rows, ncols]; None at EOF. Every
        call fills a new buffer, so a chunk handed on is never overwritten."""
        if self._h is None:
            return None
        buf = np.empty((max_rows, self.ncols), dtype=np.float32)
        n = self._lib.fcsv_read_chunk(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_rows, self.n_threads)
        if n == 0:
            return None
        if n == max_rows:
            return buf
        return buf[:n].copy()   # short last chunk: do not pin the full buffer

    def chunks(self, chunk_rows: int):
        while True:
            c = self.read_chunk(chunk_rows)
            if c is None:
                break
            yield c

    def read_all(self, chunk_rows: int = 1 << 20) -> np.ndarray:
        parts = list(self.chunks(chunk_rows))
        if not parts:
            return np.empty((0, self.ncols), dtype=np.float32)
        return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]

    def close(self):
        # the finalizer owns the one native close; detach() returns None on
        # a second call, so close() is idempotent and safe against GC
        if self._finalizer.detach() is not None:
            self._lib.fcsv_close(self._h)
        self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_csv_native(path: str, data: np.ndarray, names=None, *,
                     delimiter: str = ",") -> None:
    """f32 matrix -> CSV through the native writer (shortest round-trip
    floats; a NaN becomes an empty cell). Raises NativeUnavailable when the
    engine cannot be built."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError(f"data must be 2-D, got {data.shape}")
    header = b""
    if names is not None:
        if len(names) != data.shape[1]:
            raise ValueError(f"{len(names)} names for {data.shape[1]} columns")
        quoted = []
        for n in names:
            s = str(n)
            if "\n" in s or "\r" in s:
                # '\n' separates the names on their way to the writer
                raise ValueError(f"column name {s!r} contains a newline")
            if delimiter in s or '"' in s:
                s = '"' + s.replace('"', '""') + '"'  # RFC-4180 quoting
            quoted.append(s)
        header = "\n".join(quoted).encode()
    rc = lib.fcsv_write(
        str(path).encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[0], data.shape[1], header, delimiter.encode()[0:1] or b",")
    if rc != 0:
        raise OSError(f"fcsv_write failed for {path!r}")


def read_csv_native(path: str, class_col: str = "", *, delimiter: str = ",",
                    header: bool = True, session=None, n_threads: int = 0):
    """A whole CSV file through the native reader -> TorchTable, every
    column continuous (a string cell reads as NaN; ``io/readers.read_csv``
    infers a mixed schema). ``class_col`` names the target column. Raises
    ``NativeUnavailable`` where the engine cannot be built: a fallback
    reader would infer another schema (string columns discrete, not NaN)."""
    from orange3_spark_tpu_torch.core.domain import ContinuousVariable, Domain
    from orange3_spark_tpu_torch.core.table import TorchTable

    with NativeCsvReader(path, delimiter=delimiter, header=header,
                         n_threads=n_threads) as r:
        data = r.read_all()
        names = list(r.colnames)
    if class_col:
        if class_col not in names:
            raise ValueError(f"class_col {class_col!r} not in {names}")
        ci = names.index(class_col)
        keep = [j for j in range(len(names)) if j != ci]
        domain = Domain([ContinuousVariable(names[j]) for j in keep],
                        ContinuousVariable(class_col))
        return TorchTable.from_numpy(domain, np.ascontiguousarray(data[:, keep]),
                                     data[:, ci], session=session)
    domain = Domain([ContinuousVariable(n) for n in names])
    return TorchTable.from_numpy(domain, data, session=session)
