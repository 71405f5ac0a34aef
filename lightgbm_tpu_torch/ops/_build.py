"""Build the package's CUDA sources with ``nvcc`` at first use; load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/lib<name>-<hash>.so`` (``build/`` sits beside
``csrc/`` inside the package and is git-ignored).  The hash covers the
source, every ``csrc/*.cuh`` header and the flags, so a library is
rebuilt only when one of them changes.  Nothing here runs at import
time: the CPU tests import every module on a host without ``nvcc``.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC``, plus ``-Xptxas -v`` whose register / shared-memory /
spill report is kept beside the library (``lib<name>-<hash>.log``).
No ``--use_fast_math``: the kernels' f32 arithmetic must round as the
plain PyTorch versions do.

Each nvcc run is one event of the compile ledger (``obs/compile_ledger.py``):
program = the source's name, shapes = ``sm_90a,<digest>``, seconds =
that nvcc process's own wall time (each is waited on by a thread of its
own, so a build that ends first is not charged the others' time).  A
library loaded from ``build/`` records nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from ..obs import compile_ledger
from ..utils.log import LightGBMError

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("forest_walk", "leaf_hist", "children_hist", "roll_chain",
           "window_hist")
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise LightGBMError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels build from csrc/ at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    src = SRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise LightGBMError(f"kernel source {src} is missing")
    h.update(src.read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_log(name: str) -> str:
    """nvcc's output (the ``-Xptxas -v`` report) for the current build
    of ``name``; empty when the library came from an earlier process."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.is_file() else ""


def _start(name: str):
    """Launch nvcc for ``name`` unless its library is current; returns
    ``(process, tmp_path, final_path, start_time)`` or None."""
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, t0


def _wait(started) -> tuple:
    """``(output, nvcc's wall seconds)`` of a started build."""
    proc, _, _, t0 = started
    text, _ = proc.communicate()
    return text, time.perf_counter() - t0


def _finish(name: str, started, text: str, seconds: float) -> None:
    proc, tmp, out, _ = started
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise LightGBMError(
            f"nvcc failed to build csrc/{name}.cu (exit "
            f"{proc.returncode}):\n{text}")
    out.with_suffix(".log").write_text(text)
    os.replace(tmp, out)      # atomic: a reader never sees a partial .so
    compile_ledger.record(name, f"{ARCH},{_digest(name)}", seconds)


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every named source, one nvcc per source, all started
    together.  Returns nvcc's wall seconds per source (0.0 when
    current)."""
    with _lock:
        started = {n: _start(n) for n in names}
        done: Dict[str, tuple] = {}

        def wait(n):
            done[n] = _wait(started[n])

        waiters = [threading.Thread(target=wait, args=(n,), daemon=True)
                   for n, s in started.items() if s is not None]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        secs = {}
        for n, s in started.items():
            if s is None:
                secs[n] = 0.0
                continue
            text, secs[n] = done[n]
            _finish(n, s, text, secs[n])
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def launch(dev, fn, *args) -> int:
    """``fn(*args, stream)``: a kernel's C entry point called with
    ``dev``'s current stream as a raw handle (the one PyTorch's own C++
    launches use; ``torch.cuda.current_stream(dev).cuda_stream`` builds a
    Stream object a call), switching the current device only when it
    differs.  The launch's host path is most of a small window's time."""
    index = dev.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
