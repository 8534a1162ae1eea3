"""Build and load the hand-written CUDA kernels (gp_ss_ak_torch/csrc).

`nvcc` compiles every `csrc/*.cu` (which may include `csrc/*.cuh`) for
Hopper (`sm_90a`), one process per source, all started together, then
links the objects into one shared library with a plain C interface,
loaded with ctypes. Nothing here includes PyTorch's headers, so a build
takes seconds (on the host of an H100 80GB HBM3 card: 4.6-5.0 s this
way for gram.cu and matmat.cu, against 6.5-8.6 s for one nvcc over
both; 6.6-7.1 s for the four sources of K1-K4, 7.6-9.7 s with K6's
fifth). The library goes
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: what the build of the loaded library printed (nvcc's -Xptxas -v
#: register/spill report, kept beside the library) and, if `load()` built
#: it, how long that took; empty until `load()` has run
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
    for name in ("gp_gram_batched_f32", "gp_gram_batched_f64"):
        fn = getattr(lib, name)
        # xi, xj, scal, out, batch, n, m, d, with_diag, device, stream
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    # x, v, scal, y, n, b, dp, d, width, device, stream
    lib.gp_matmat_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                  i32, i32, ptr]
    lib.gp_matmat_f32.restype = i32
    # x, v, scal, partial, y, n, dp, d, slab_w, slabs, device, stream
    lib.gp_matvec_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                  i32, i32, i32, ptr]
    lib.gp_matvec_f32.restype = i32
    # dp, mp, shape (4 ints), device
    lib.gp_contraction_shape.argtypes = [i32, i32, ptr, i32]
    lib.gp_contraction_shape.restype = i32
    # rec, partial, rows_pad, slice_w, slices, dp, mp, device, stream
    lib.gp_contraction_f32.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                       i32, ptr]
    lib.gp_contraction_f32.restype = i32
    for name in ("gp_pivchol_f32", "gp_pivchol_f64"):
        fn = getattr(lib, name)
        # x, scal, lt, dvec, pval, pidx, n, d, ld, rank, ks, flip, device,
        # stream
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                       i32, i32, ptr]
        fn.restype = i32
    lib.gp_cuda_error_string.argtypes = [i32]
    lib.gp_cuda_error_string.restype = ctypes.c_char_p


def _run_all(cmds):
    """Run the commands concurrently; the (returncode, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, text) for p, text in zip(procs, outs)]


def _compile_and_link(srcs, out: Path) -> None:
    """One nvcc per source, all at once, then one link into `out`."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{s.stem}.{tag}.o") for s in srcs]
    tmp = out.with_suffix(f".{tag}")
    try:
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                            for s, o in zip(srcs, objs)])
        if all(rc == 0 for rc, _ in results):
            results += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                                  *map(str, objs)]])
        log = "".join(text for _, text in results)
        if any(rc != 0 for rc, _ in results):
            raise RuntimeError("nvcc failed:\n" + log)
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


def load():
    """The kernel library, built from csrc/ on the first call."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libgp_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _compile_and_link(srcs, out)
        build_info["seconds"] = time.perf_counter() - t0
    log = out.with_suffix(".log")
    if log.exists():            # a diagnostic: loading never needs it
        build_info["log"] = log.read_text()
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    _lib = lib
    return lib


def check(lib, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.gp_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
