"""ctypes bindings for the port's host loader, ``csrc/data_loader.cpp``.

The port's counterpart of the JAX package's io/native.py: the same
functions, signatures and returns, over the port's own copy of the C++
source (the same C ABI and the same float arithmetic, so a clean file
reads to the same bits in both packages).

The library is built at first use, never at import, with the host C++
compiler (:func:`compiler`) and the JAX package's flags
(:data:`BUILD_FLAGS`: ``-O3``, no ``-march=native``, so a binary never
meets a host that lacks its instructions), into
``build/libdata_loader-<hash>.so`` beside ``csrc/`` (git-ignored).  The
hash covers the source, the flags and the compiler's identity (its
path, version, the machine and the C library).  A build goes to a
temporary name that carries the process and thread and is renamed into
place, so concurrent builders (test workers) never load a half-written
file.  Each build is one event of ``obs/compile_ledger.py``; a library
found in ``build/`` records nothing.

With no compiler, or a failed build or load, :func:`get_lib` returns
None and every caller reads through the Python path (the JAX package's
contract: installs without a compiler keep working).  That is logged
once as a warning naming the reason, :func:`status` returns the reason,
and :func:`counts` says how many reads and binnings took the native
path, so a test or a run can tell which path served it.  A test forces
the Python path by patching :func:`parse_file_native` (or
:func:`values_to_bins_native`) to return None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..obs import compile_ledger
from ..utils import log

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "data_loader.cpp"
BUILD_DIR = PKG_DIR / "build"
BUILD_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
#: seconds a compile may take before the build counts as failed
BUILD_TIMEOUT = 180

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_status = "not tried"
_counts = {"parse": 0, "flagged": 0, "bins": 0}


def compiler() -> Optional[str]:
    """The host C++ compiler's path: ``$CXX``; else, where ``$CC`` names
    a ``gcc``, its sibling ``g++``; else ``c++``, else ``g++`` on
    ``PATH``.  None when there is none."""
    cands = [os.environ.get("CXX")]
    cc = os.environ.get("CC") or ""
    base = os.path.basename(cc)
    if base.startswith("gcc"):
        cands.append(os.path.join(os.path.dirname(cc),
                                  "g++" + base[len("gcc"):]))
    cands += ["c++", "g++"]
    for cand in cands:
        found = shutil.which(cand) if cand else None
        if found:
            return found
    return None


def _compiler_tag(cxx: str) -> str:
    """The compiler's identity, part of the library's hash: hosts with
    other toolchains or C libraries never load each other's binaries."""
    try:
        ver = subprocess.run([cxx, "-dumpfullversion", "-dumpversion"],
                             capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        ver = "unknown"
    return f"{cxx}-{ver}-{platform.machine()}-{platform.libc_ver()[1]}"


def library_path(cxx: str) -> Path:
    """Where the library of this source, these flags and this compiler
    lives."""
    key = hashlib.sha256()
    key.update(SOURCE.read_bytes())
    key.update(" ".join(BUILD_FLAGS).encode())
    key.update(_compiler_tag(cxx).encode())
    return BUILD_DIR / f"libdata_loader-{key.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> Optional[str]:
    """Compile the source to ``out``; None on success, else the reason."""
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        return f"cannot create {out.parent}: {e}"
    tmp = out.with_name(
        f"{out.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    t0 = time.perf_counter()
    try:
        try:
            res = subprocess.run(
                [cxx, *BUILD_FLAGS, str(SOURCE), "-o", str(tmp)],
                capture_output=True, text=True, timeout=BUILD_TIMEOUT)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"{cxx} failed to run: {e}"
        if res.returncode != 0:
            return (f"{cxx} failed (exit {res.returncode}): "
                    f"{res.stderr[-2000:]}")
        try:
            os.replace(tmp, out)
        except OSError as e:
            return f"cannot move the library into {out.parent}: {e}"
    finally:
        tmp.unlink(missing_ok=True)
    compile_ledger.record("data_loader", f"host,{out.stem.split('-')[-1]}",
                          time.perf_counter() - t0)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.lgbt_parse_file.restype = ctypes.c_int
    lib.lgbt_parse_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
    lib.lgbt_free.restype = None
    lib.lgbt_free.argtypes = [ctypes.c_void_p]
    lib.lgbt_values_to_bins.restype = None
    lib.lgbt_values_to_bins.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int]
    return lib


def _load_or_build() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the library or None, its status)."""
    cxx = compiler()
    if cxx is None:
        return None, ("no C++ compiler (set CXX, or put c++ or g++ on "
                      "PATH)")
    out = library_path(cxx)
    built = False
    if not out.is_file():
        why = _build(cxx, out)
        if why:
            return None, f"build failed: {why}"
        built = True
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        # a stale or foreign binary under the same name: rebuild once
        out.unlink(missing_ok=True)
        why = _build(cxx, out)
        if why:
            return None, f"build failed: {why}"
        built = True
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            return None, f"cannot load {out}: {e}"
    return _bind(lib), "built" if built else "loaded"


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None if unavailable
    (callers read through Python).  The build runs outside the lock: a
    second thread arriving mid-build is not parked behind the compile,
    and two first callers may both build (safe: each renames a
    temporary of its own into place)."""
    global _lib, _tried, _status
    with _lock:
        if _lib is not None or _tried:
            return _lib
    lib, why = _load_or_build()
    with _lock:
        if not _tried:
            _tried = True
            _status = why
            if lib is None:
                log.warning("the native host loader is unavailable (%s); "
                            "data files are read through Python", why)
        if _lib is None and lib is not None:
            _lib = lib
        return _lib


def status() -> str:
    """``"built"`` (this process compiled the library), ``"loaded"``
    (found in ``build/``), ``"not tried"`` (nothing has needed it yet),
    or the reason it is unavailable."""
    with _lock:
        return _status


def counts() -> Dict[str, int]:
    """Native calls so far: ``parse`` (clean files read), ``flagged``
    (files read and found malformed, re-read by the caller through
    Python) and ``bins`` (numerical columns binned)."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0


def _count(key: str) -> None:
    with _lock:
        _counts[key] += 1


_FMT_NAMES = {0: "csv", 1: "tsv", 2: "libsvm"}


def parse_file_native(path: str, has_header: bool = False,
                      label_idx: int = 0
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, str, int]]:
    """Parse with the C++ loader; (label, X, fmt, first_bad_row) or None
    (no library, or a file the loader leaves to Python: unreadable, no
    data rows, a label column past the first row's fields).
    ``first_bad_row`` is the 1-based ordinal, among the data rows, of the
    first malformed row, or -1 for a clean file; a caller holding a
    flagged result discards it and re-reads through the guarded Python
    path (io/parser.py), which owns the diagnostics and the policy."""
    lib = get_lib()
    if lib is None:
        return None
    data_p = ctypes.POINTER(ctypes.c_double)()
    label_p = ctypes.POINTER(ctypes.c_double)()
    nrows = ctypes.c_int64()
    ncols = ctypes.c_int64()
    fmt = ctypes.c_int()
    bad_row = ctypes.c_int64()
    rc = lib.lgbt_parse_file(os.fsencode(path), int(has_header),
                             int(label_idx), ctypes.byref(data_p),
                             ctypes.byref(label_p), ctypes.byref(nrows),
                             ctypes.byref(ncols), ctypes.byref(fmt),
                             ctypes.byref(bad_row))
    if rc != 0:
        return None
    n, f = nrows.value, ncols.value
    try:
        X = np.ctypeslib.as_array(data_p, shape=(n, f)).copy() if n * f \
            else np.zeros((n, f))
        y = np.ctypeslib.as_array(label_p, shape=(n,)).copy()
    finally:
        lib.lgbt_free(data_p)
        lib.lgbt_free(label_p)
    _count("parse" if bad_row.value < 0 else "flagged")
    return y, X, _FMT_NAMES.get(fmt.value, "csv"), int(bad_row.value)


def values_to_bins_native(values: np.ndarray, upper_bounds: np.ndarray,
                          out_dtype=np.uint8) -> Optional[np.ndarray]:
    """Numerical ValueToBin by the native binary search (the first bound
    >= the value; NaN in bin 0), as uint8 or uint16; None if no
    library."""
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, np.float64)
    bounds = np.ascontiguousarray(upper_bounds, np.float64)
    n = values.size
    is16 = np.dtype(out_dtype) == np.uint16
    out = np.empty(n, dtype=np.uint16 if is16 else np.uint8)
    lib.lgbt_values_to_bins(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(bounds),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), int(is16))
    _count("bins")
    return out
