"""Build and load the hand-written CUDA kernels (gp_ss_ak_torch/csrc).

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain
C interface for Hopper (`sm_90a`), loaded with ctypes. Nothing here
includes PyTorch's headers, so a build takes seconds. The library goes
to `build/torch_kernels/` beside the package (listed in .gitignore),
named by a hash of the sources and flags so a stale build is never
reused. The build runs on first use, never at import: machines without
a GPU import this module but never call `load()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: what the last build printed (nvcc's -Xptxas -v register/spill report)
#: and how long it took; empty until `load()` has built
build_info = {}
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of gp_ss_ak_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _declare(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("gp_gram_f32", "gp_gram_f64"):
        fn = getattr(lib, name)
        # xi, xj, scal, out, n, m, d, with_diag, device, stream
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    lib.gp_cuda_error_string.argtypes = [i32]
    lib.gp_cuda_error_string.restype = ctypes.c_char_p


def load():
    """The kernel library, built from csrc/ on the first call."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libgp_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               + build_info["log"])
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    _lib = lib
    return lib


def check(lib, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.gp_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
