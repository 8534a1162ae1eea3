"""ctypes binding + lazy build of the native C++ data parser.

Port of gp_ss_ak_tpu/native/loader.py. `parse_file` returns the full
(rows, cols) float64 table, or None when the shared library is
unavailable (data/io.py then falls back to the NumPy parser, which
returns the same table). This is a host-side text parser: neither
route touches the device or a kernel, so the fallback hides none.

The library is built on first use, never at import, with g++ -O3 into
`build/native/` beside the package (listed in .gitignore), named by a
hash of the source so a stale build is never loaded; the build writes
a temporary file and renames it, so concurrent processes never load a
partial one. GP_SS_AK_NO_NATIVE=1 disables the parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "native"
_lock = threading.Lock()
_lib = None
_tried = False


def _build(out: Path) -> bool:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
             "-o", str(tmp)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("GP_SS_AK_NO_NATIVE") == "1":
            return None
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"libgp_loader_{digest}.so"
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.gp_loader_size.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.gp_loader_size.restype = ctypes.c_int
        lib.gp_loader_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.gp_loader_parse.restype = ctypes.c_int
        _lib = lib
        return _lib


def parse_file(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int64(0)
    rc = lib.gp_loader_size(path.encode(), ctypes.byref(rows),
                            ctypes.byref(cols))
    if rc != 0:
        return None
    out = np.zeros((rows.value, cols.value), np.float64)
    rc = lib.gp_loader_parse(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.value, cols.value)
    if rc != 0:
        return None
    return out
