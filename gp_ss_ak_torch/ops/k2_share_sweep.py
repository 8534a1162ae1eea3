"""Time K2 (csrc/matvec.cu) at other shares of its ex2 split.

    python3 -m gp_ss_ak_torch.ops.k2_share_sweep [--n 65536] [--shares 0 1 2 3 4 5]

K2 computes POLY_OF_8 of every 8 exponentials as a polynomial on the
FP32 pipes and the rest on MUFU. This builds a copy of matvec.cu for each
share (0 puts every exponential on MUFU), one nvcc each, all at once,
under build/k2_sweep; times each on the same points (d = 3) and v with
CUDA events; and holds each output to the library's within twice K2's
gate. The library itself is not changed. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

from gp_ss_ak_torch.ops import _build

#: the line of csrc/matvec.cu that fixes the share
SHARE_LINE = re.compile(r"^constexpr int POLY_OF_8 = (\d+);", re.M)
#: twice the gate the smoke holds K2 to, per unit of s2 * ||v||_1
TOL = 3e-7


def with_share(source: str, k: int) -> str:
    """matvec.cu's source with POLY_OF_8 set to k."""
    if len(SHARE_LINE.findall(source)) != 1:
        raise ValueError("matvec.cu must fix POLY_OF_8 on one line")
    return SHARE_LINE.sub(f"constexpr int POLY_OF_8 = {k};", source)


def build(shares) -> dict:
    """{share: ctypes function gp_matvec_f32 of a build at that share}."""
    out = _build.BUILD_DIR.parent / "k2_sweep"
    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "matvec.cu").read_text()
    cmds, libs = [], []
    for k in shares:
        src = out / f"matvec_poly{k}.cu"
        src.write_text(with_share(source, k))
        libs.append(out / f"libk2_poly{k}.so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                     str(_build.CSRC), "-shared", "-o", str(libs[-1]),
                     str(src)])
    for rc, text in _build._run_all(cmds):
        if rc != 0:
            raise RuntimeError("nvcc failed:\n" + text)
    fns = {}
    for k, path in zip(shares, libs):
        fn = ctypes.CDLL(str(path)).gp_matvec_f32
        fn.argtypes = _build.load().gp_matvec_f32.argtypes
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--shares", type=int, nargs="+",
                    default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from gp_ss_ak_torch.ops import matvec

    if not torch.cuda.is_available():
        print("k2_share_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    fns = build(args.shares)
    device, n = torch.device("cuda", 0), args.n
    g = torch.Generator(device=device).manual_seed(args.seed)
    X = 3.0 * torch.rand(n, 3, generator=g, device=device) - 1.5
    Xk, scal = matvec.operator_arrays(X, 0.6)
    v = torch.randn(n, generator=g, device=device)
    width, slabs = matvec.matvec_slabs(n, torch.cuda.get_device_properties(
        device).multi_processor_count)
    ref = matvec.streamed_matvec(Xk, scal, 0.0, 0.0, v, 3)
    lim = TOL * float(scal) * float(v.abs().sum())
    partial = torch.empty((slabs, n), device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = {}
    for k, fn in fns.items():
        y = torch.empty_like(v)

        def run():
            code = fn(Xk.data_ptr(), v.data_ptr(), scal.data_ptr(),
                      partial.data_ptr(), y.data_ptr(), n, Xk.shape[1], 3,
                      width, slabs, device.index, stream)
            _build.check(_build.load(), code, f"share {k}")

        for _ in range(3):
            run()
        start.record()
        for _ in range(20):
            run()
        end.record()
        torch.cuda.synchronize()
        times[k] = start.elapsed_time(end) / 20
        err = float((y - ref).abs().max())
        if err > lim:
            raise RuntimeError(f"share {k}: {err:.3e} from the library's "
                               f"K2 (limit {lim:.3e})")
    print(f"K2 share sweep N={n} d=3 slabs ({width}, {slabs}), columns of "
          f"every 8 on the polynomial: ms: "
          + ", ".join(f"{k}: {t:.4f}" for k, t in sorted(times.items()))
          + "; each within twice the gate of the library's K2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
