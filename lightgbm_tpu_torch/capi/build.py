"""Build ``lib_lightgbm_tpu_torch.so``: the C API as a shared library
that a C program or ``ctypes`` loads like the reference's
``lib_lightgbm.so``.

``c_api.c`` is plain C (no Python header, libpython not linked), built
by the host C compiler: ``$CC``, else ``cc``, else ``gcc``, with
``-O2 -shared -fPIC ... -ldl -pthread``.  Three paths are baked in as
``-D`` macros: the shared libpython an embedding boot loads
(``sysconfig`` ``LIBDIR``/``INSTSONAME``), the interpreter's home
(``sys.base_prefix``) and the ``sys.path`` the boot puts first (the repo
root, then the building process's own).  The output is
``build/lib_lightgbm_tpu_torch-<hash>.so`` beside ``csrc/``'s kernels
(git-ignored); the hash covers the C source, ``cdef.py``, the baked
paths and the flags.  Built at first use, never at import; a library
already built is reused.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List

from ..utils.log import LightGBMError

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "c_api.c"
BUILD_DIR = HERE.parent / "build"
REPO_ROOT = HERE.parent.parent
CFLAGS = ("-O2", "-shared", "-fPIC")
LDFLAGS = ("-ldl", "-pthread")

_lock = threading.Lock()


def compiler() -> str:
    """``$CC``, else ``cc``, else ``gcc`` on ``PATH``."""
    for cand in (os.environ.get("CC"), "cc", "gcc"):
        found = shutil.which(cand) if cand else None
        if found:
            return found
    raise LightGBMError(
        "no C compiler found (set CC, or put cc or gcc on PATH): the C "
        "API library builds from capi/c_api.c at first use")


def libpython() -> str:
    """The shared libpython an embedding boot loads ('' where this
    interpreter has none: a C host then fails its first call by
    name)."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    for name in (sysconfig.get_config_var("INSTSONAME"),
                 sysconfig.get_config_var("LDLIBRARY")):
        path = os.path.join(libdir, name or "")
        if ".so" in (name or "") and os.path.isfile(path):
            return path
    return ""


def _defines() -> List[str]:
    """The baked paths as ``-D`` macros, each a C string literal (JSON's
    escapes are C's)."""
    paths = [str(REPO_ROOT)] + [p for p in sys.path
                                if p and p != str(REPO_ROOT)]
    return [f"-DLGBM_TORCH_LIBPYTHON={json.dumps(libpython())}",
            f"-DLGBM_TORCH_PYTHONHOME={json.dumps(sys.base_prefix)}",
            f"-DLGBM_TORCH_BOOT_PATHS={json.dumps(repr(paths))}"]


def library_path() -> Path:
    """Where the library of this source, these paths and flags lives."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update((HERE / "cdef.py").read_bytes())
    h.update("\0".join([*_defines(), *CFLAGS, *LDFLAGS]).encode())
    return BUILD_DIR / f"lib_lightgbm_tpu_torch-{h.hexdigest()[:16]}.so"


def _compile(src: Path, out: Path, flags, libs) -> str:
    """``src`` compiled to ``out`` through a temporary name and
    ``os.replace`` (a loader never sees a partial file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    proc = subprocess.run(
        [compiler(), *flags, "-o", str(tmp), str(src), *libs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise LightGBMError(
            f"the C compiler failed to build capi/{src.name} (exit "
            f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return str(out)


def build_library(force: bool = False) -> str:
    """The path of the built library, compiling it unless it is current
    (or ``force``).  A missing compiler or a compile error raises
    :class:`LightGBMError` with the compiler's output."""
    with _lock:
        out = library_path()
        if out.is_file() and not force:
            return str(out)
        return _compile(SOURCE, out, [*CFLAGS, *_defines()], LDFLAGS)


def build_demo() -> str:
    """The path of ``demo.c`` compiled (``build/capi_demo-<hash>``): a
    C program that loads the library with ``dlopen`` and trains and
    predicts through it; it links nothing but ``libdl``."""
    src = HERE / "demo.c"
    with _lock:
        h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"capi_demo-{h}"
        if out.is_file():
            return str(out)
        return _compile(src, out, ["-O2"], ["-ldl"])


if __name__ == "__main__":
    print(build_library(force="--force" in sys.argv))
