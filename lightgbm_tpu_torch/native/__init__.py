"""Native (C++) text-data parser, built with g++ and loaded with ctypes.

The port's own copy of lightgbm_tpu's ``native/`` (reference:
src/io/parser.cpp, src/io/dataset_loader.cpp): ``text_parser.cpp`` is
built on first use into ``lightgbm_tpu_torch/_build/`` (one library per
source hash) with a plain C interface. A failed build raises; there is no
quiet fall-back. ``_parse_text_file_py`` / ``_parse_buffer_py`` are the
plain numpy versions the tests hold the C++ parser against."""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "text_parser.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

FMT_NAMES = {0: "csv", 1: "tsv", 2: "libsvm"}


def lib_path() -> Path:
    """The library of the current source, under ``_build/``."""
    key = hashlib.sha1(_SRC.read_bytes()
                       + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return _BUILD / f"libtextparser_{key}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("building the native text parser needs g++, "
                           "which was not found on PATH")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on native/text_parser.cpp:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The parser library, built first if missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        lib.ltp_parse_file.restype = ctypes.c_void_p
        lib.ltp_parse_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int]
        lib.ltp_parse_buffer.restype = ctypes.c_void_p
        lib.ltp_parse_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_int]
        lib.ltp_rows.restype = ctypes.c_int64
        lib.ltp_rows.argtypes = [ctypes.c_void_p]
        lib.ltp_cols.restype = ctypes.c_int64
        lib.ltp_cols.argtypes = [ctypes.c_void_p]
        lib.ltp_format.restype = ctypes.c_int
        lib.ltp_format.argtypes = [ctypes.c_void_p]
        lib.ltp_data.restype = ctypes.POINTER(ctypes.c_double)
        lib.ltp_data.argtypes = [ctypes.c_void_p]
        lib.ltp_error.restype = ctypes.c_char_p
        lib.ltp_error.argtypes = [ctypes.c_void_p]
        lib.ltp_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _take(lib: ctypes.CDLL, handle, where: str) -> Tuple[np.ndarray, str]:
    try:
        err = lib.ltp_error(handle).decode()
        if err:
            raise ValueError(f"parse error in {where}: {err}")
        rows, cols = lib.ltp_rows(handle), lib.ltp_cols(handle)
        fmt = FMT_NAMES.get(lib.ltp_format(handle), "csv")
        if rows * cols == 0:
            return np.zeros((rows, cols), np.float64), fmt
        buf = np.ctypeslib.as_array(lib.ltp_data(handle),
                                    shape=(rows, cols)).copy()
        return buf, fmt
    finally:
        lib.ltp_free(handle)


def parse_text_file(path: str, has_header: bool = False,
                    num_threads: int = 0) -> Tuple[np.ndarray, str]:
    """Parse a CSV/TSV/LibSVM data file into a dense [rows, cols] float64
    matrix (column 0 is by convention the label). Returns (matrix,
    format_name)."""
    lib = load()
    handle = lib.ltp_parse_file(path.encode(), int(has_header), num_threads)
    if not handle:
        raise OSError(f"could not open data file: {path}")
    return _take(lib, handle, path)


def parse_buffer(data: bytes, has_header: bool = False,
                 num_threads: int = 0) -> Tuple[np.ndarray, str]:
    """Parse an in-memory, line-aligned text chunk into a dense float64
    matrix: the streaming unit of two-round loading (cli.py)."""
    lib = load()
    handle = lib.ltp_parse_buffer(data, len(data), int(has_header),
                                  num_threads)
    if not handle:
        raise ValueError("could not parse data chunk")
    return _take(lib, handle, "chunk")


def _parse_text_file_py(path: str, has_header: bool) -> Tuple[np.ndarray, str]:
    """Plain version of ``parse_text_file`` (numpy; LibSVM through
    scikit-learn's reader, index j in column j + 1 as the C++ parser puts
    it)."""
    with open(path) as fh:
        first = fh.readline()
    skip = 1 if has_header else 0
    if ":" in first and any(c.isdigit() for c in first.split(":")[0][-3:]):
        from sklearn.datasets import load_svmlight_file
        # the C++ parser's layout: feature index j in column j + 1
        X, y = load_svmlight_file(path, zero_based=True)
        mat = np.concatenate([y.reshape(-1, 1), np.asarray(X.todense())],
                             axis=1)
        return mat, "libsvm"
    delim = "," if "," in first else None
    return _dense_text(open(path).read(), delim, skip), (
        "csv" if delim == "," else "tsv")


def _dense_text(text: str, delim, skip: int) -> np.ndarray:
    """CSV (an empty or non-numeric field is NaN, as the C++ parser reads
    it) or whitespace-separated rows as a float64 matrix."""
    if delim == ",":
        return np.genfromtxt(io.StringIO(text), delimiter=",",
                             skip_header=skip, ndmin=2, dtype=np.float64)
    return np.loadtxt(io.StringIO(text), skiprows=skip, ndmin=2)


def _parse_buffer_py(data: bytes, has_header: bool) -> Tuple[np.ndarray, str]:
    """Plain version of ``parse_buffer`` (CSV/TSV)."""
    text = data.decode()
    first = text.split("\n", 1)[0]
    delim = "," if "," in first else None
    return _dense_text(text, delim, 1 if has_header else 0), (
        "csv" if delim == "," else "tsv")
