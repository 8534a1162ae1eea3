"""Matrix-free Gram products: Y = A V with A = K + bias + sn2 I, K never built.

    K = s^2 exp(-||xi - xj||),   K(i, i) = s^2 exactly,
    Y = K V + bias * colsum(V) + sn2 * V

over metric-mapped points (ops/fused.mapped_points' convention). At
N = 65536 an f32 K is 17 GB; every CG pass of the matrix-free engines
(serve.IterativePredictor, inference/iterative.py) streams it tile by
tile instead. Two hand-written kernels, each launched for CUDA tensors
(or the wrapper raises) and replaced by a plain torch version for CPU
tensors:

  streamed_matmat  K3, csrc/matmat.cu (replaces the Pallas
                   gp_ss_ak_tpu/ops/matvec.py::_matmat_kernel): B columns
                   per pass; count `launches`. The kernel picks its tile
                   by B: FP32 FFMA tiles 8, 16 and 64 columns wide for
                   B <= 64, where the Gram build sets the pace, and past
                   that a 128-column tile whose product runs on the
                   tensor cores in 3xTF32 (each operand split into two
                   TF32 parts, each k-step's partial sums added into
                   float32 accumulators, since the tensor cores'
                   accumulator truncates). Every tile sums in a fixed
                   order: two passes give equal bits.
  streamed_matvec  K2, csrc/matvec.cu (replaces
                   gp_ss_ak_tpu/ops/matvec.py::_matvec_kernel): one
                   vector per pass; count `matvec_launches`.

The plain versions run row chunks in plain torch and keep the TPU
kernels' |xi|^2 + |xj|^2 - 2 xi.xj expansion and clamp, so CPU results
track the JAX package's kernels.

The bias and noise terms are rank-1 and diagonal and are added outside
the kernel, as in the JAX package. The port needs none of the TPU
layout (points transposed to (dpad, npad), n padded to the tile, V
padded to 8-row blocks): the kernel takes row-major points and V and
masks ragged edges. It only wants each point as whole float4s, so
`operator_arrays` zero-pads the features to a multiple of 4, at most 16
(zero features add nothing to a distance).

`MatvecOperator` (the streamed operator: `__call__` is K2, `matmat` K3)
and `MaterializedOperator` (K built once by K1 and stored in float32 or
bfloat16, then GEMMs) are the operators of inference/iterative.py's
modes.
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.kernels.distance import gram_sqdist, highest_precision
from gp_ss_ak_torch.ops import _build
from gp_ss_ak_torch.ops.pairwise import expans_bias_gram

#: number of times `streamed_matmat` has launched the CUDA kernel K3
launches = 0

#: number of times `streamed_matvec` has launched the CUDA kernel K2
matvec_launches = 0

#: K2 cuts the columns into at most this many slabs (a second grid axis,
#: so that N = 65536 fills the card); partial sums go to a scratch buffer
MATVEC_SLABS = 16

#: K2's column tile (csrc/matvec.cu BK): slab widths are multiples of it
MATVEC_TILE = 256

#: rows per chunk of the plain version (no N x N buffer exists)
PLAIN_CHUNK = 4096


#: the kernel reads each point as at most this many features (4 float4s)
MAX_FEATURES = 16


def operator_arrays(Xm: torch.Tensor, sigma):
    """The operator's array state as a pure function of (Xm, sigma):
    (contiguous float32 points (n, dp), dp = d zero-padded to a multiple
    of 4; scal = [sigma^2] (1,)), both on Xm's device. float32 is the
    kernel's type, as on the TPU."""
    n, d = Xm.shape
    if d > MAX_FEATURES:
        raise ValueError(f"streamed_matmat: at most {MAX_FEATURES} "
                         f"features, got {d}")
    X = torch.zeros((n, -(-d // 4) * 4), dtype=torch.float32,
                    device=Xm.device)
    X[:, :d] = Xm
    s = torch.as_tensor(sigma, dtype=torch.float32, device=X.device)
    return X, (s * s).reshape(1)


def streamed_matmat_plain(Xm: torch.Tensor, scal: torch.Tensor, bias, sn2,
                          V: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, in the dtype of V: the TPU
    kernel's math (matvec.py:108-124), expansion and clamp, exact
    diagonal, built PLAIN_CHUNK rows at a time, then the bias and noise."""
    n = Xm.shape[0]
    chunk = PLAIN_CHUNK
    X = Xm.to(V.dtype)
    s2 = scal[0].to(V.dtype)
    Y = torch.empty_like(V)
    with highest_precision():
        for s in range(0, n, chunk):
            rows = X[s:s + chunk]
            K = s2 * torch.exp(-torch.sqrt(gram_sqdist(rows, X)))
            K.diagonal(offset=s).fill_(s2)              # exact s^2
            Y[s:s + chunk] = K @ V
    return _bias_noise(Y, bias, sn2, V)


def _bias_noise(Y, bias, sn2, V):
    return Y + bias * torch.sum(V, dim=0, keepdim=True) + sn2 * V


def _launch(X: torch.Tensor, scal: torch.Tensor,
            V: torch.Tensor) -> torch.Tensor:
    global launches
    for name, t in (("Xm", X), ("scal", scal), ("V", V)):
        if t.dtype != torch.float32:
            raise TypeError(f"streamed_matmat: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != V.device:
            raise TypeError(f"streamed_matmat: {name} is on {t.device}, V "
                            f"on {V.device}")
        if not t.is_contiguous():
            raise ValueError(f"streamed_matmat: {name} must be contiguous")
    if X.dim() != 2 or V.dim() != 2 or V.shape[0] != X.shape[0]:
        raise ValueError(f"streamed_matmat: Xm (n, d) and V (n, B) needed, "
                         f"got {tuple(X.shape)} and {tuple(V.shape)}")
    if scal.numel() != 1:
        raise ValueError("streamed_matmat: scal must be [sigma^2]")
    n, d = X.shape
    b = V.shape[1]
    if d % 4 or d > MAX_FEATURES or X.data_ptr() % 16:
        raise ValueError("streamed_matmat: Xm must come from "
                         "operator_arrays (features padded to a multiple "
                         f"of 4, at most {MAX_FEATURES}, 16-byte aligned)")
    if max(n * d, n * b) >= 2 ** 31:
        raise ValueError("streamed_matmat: sizes must fit in int32")
    Y = torch.empty_like(V)
    if n == 0 or b == 0:
        return Y
    lib = _build.load()
    stream = torch.cuda.current_stream(V.device).cuda_stream
    code = lib.gp_matmat_f32(X.data_ptr(), V.data_ptr(), scal.data_ptr(),
                             Y.data_ptr(), n, b, d, V.device.index, stream)
    _build.check(lib, code, "matmat kernel launch")
    launches += 1
    return Y


def streamed_matmat(Xm: torch.Tensor, scal: torch.Tensor, bias, sn2,
                    V: torch.Tensor) -> torch.Tensor:
    """A @ V for V (n, B), all B columns in one pass over the Gram
    tiles. Xm and scal come from `operator_arrays` (the plain version
    takes any (n, d) points); bias and sn2 are
    Python floats or 0-d tensors. CUDA tensors launch the CUDA kernel
    (float32, contiguous), CPU tensors run the plain version."""
    if V.device.type == "cpu":
        return streamed_matmat_plain(Xm, scal, bias, sn2, V)
    if V.device.type != "cuda":
        raise ValueError(f"streamed_matmat: no kernel for device "
                         f"{V.device}")
    return _bias_noise(_launch(Xm, scal, V), bias, sn2, V)


def matvec_slabs(n: int):
    """(slab width, slab count) of K2's column split: a function of n
    alone, so two passes over the same v sum in the same order."""
    per = -(-n // MATVEC_SLABS)
    width = -(-per // MATVEC_TILE) * MATVEC_TILE
    return width, -(-n // width)


def streamed_matvec_plain(Xm: torch.Tensor, scal: torch.Tensor, bias, sn2,
                          v: torch.Tensor) -> torch.Tensor:
    """K2's function in plain torch, in the dtype of v: the TPU kernel's
    math (matvec.py:43-57), expansion and clamp, exact diagonal, then the
    bias and noise."""
    return streamed_matmat_plain(Xm, scal, bias, sn2, v[:, None])[:, 0]


def _launch_matvec(X: torch.Tensor, scal: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    global matvec_launches
    for name, t in (("Xm", X), ("scal", scal), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"streamed_matvec: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != v.device:
            raise TypeError(f"streamed_matvec: {name} is on {t.device}, v "
                            f"on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"streamed_matvec: {name} must be contiguous")
    if X.dim() != 2 or v.dim() != 1 or v.shape[0] != X.shape[0]:
        raise ValueError(f"streamed_matvec: Xm (n, d) and v (n,) needed, "
                         f"got {tuple(X.shape)} and {tuple(v.shape)}")
    if scal.numel() != 1:
        raise ValueError("streamed_matvec: scal must be [sigma^2]")
    n, d = X.shape
    if d % 4 or d > MAX_FEATURES or X.data_ptr() % 16:
        raise ValueError("streamed_matvec: Xm must come from "
                         "operator_arrays (features padded to a multiple "
                         f"of 4, at most {MAX_FEATURES}, 16-byte aligned)")
    width, slabs = matvec_slabs(max(n, 1))
    if n * max(d, slabs) >= 2 ** 31:
        raise ValueError("streamed_matvec: sizes must fit in int32")
    y = torch.empty_like(v)
    if n == 0:
        return y
    partial = torch.empty((slabs, n), dtype=torch.float32, device=v.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    code = lib.gp_matvec_f32(X.data_ptr(), v.data_ptr(), scal.data_ptr(),
                             partial.data_ptr(), y.data_ptr(), n, d, width,
                             slabs, v.device.index, stream)
    _build.check(lib, code, "matvec kernel launch")
    matvec_launches += 1
    return y


def streamed_matvec(Xm: torch.Tensor, scal: torch.Tensor, bias, sn2,
                    v: torch.Tensor) -> torch.Tensor:
    """A @ v for one vector v (n,). Xm and scal come from
    `operator_arrays` (the plain version takes any (n, d) points); bias
    and sn2 are Python floats or 0-d tensors. CUDA tensors launch K2
    (float32, contiguous), CPU tensors run the plain version."""
    if v.device.type == "cpu":
        return streamed_matvec_plain(Xm, scal, bias, sn2, v)
    if v.device.type != "cuda":
        raise ValueError(f"streamed_matvec: no kernel for device "
                         f"{v.device}")
    return _bias_noise(_launch_matvec(Xm, scal, v), bias, sn2, v)


class MatvecOperator:
    """A = s^2 exp(-dist) + bias + sn2 I as a streamed operator, in
    float32 on the device of Xm: `__call__` (one vector) is K2, `matmat`
    (B columns in one pass) is K3. Xm: metric-mapped recentred points
    (n, d), ops/fused.py's convention. The JAX class's tile sizes and
    interpret switch have no counterpart: the CUDA kernels pick their
    own tiles and the CPU takes the plain versions."""

    def __init__(self, Xm: torch.Tensor, sigma, bias, sn2):
        f32 = torch.float32
        Xm = Xm.to(f32)
        self.n = Xm.shape[0]
        self.X, self.scal = operator_arrays(Xm, sigma)
        self.sigma = torch.as_tensor(sigma, dtype=f32, device=Xm.device)
        self.bias = torch.as_tensor(bias, dtype=f32, device=Xm.device)
        self.sn2 = torch.as_tensor(sn2, dtype=f32, device=Xm.device)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return streamed_matvec(self.X, self.scal, self.bias, self.sn2,
                               v.to(torch.float32).contiguous())

    def matmat(self, V: torch.Tensor) -> torch.Tensor:
        """A @ V for V (n, B): all B columns ride one pass."""
        return streamed_matmat(self.X, self.scal, self.bias, self.sn2,
                               V.to(torch.float32).contiguous())


#: K entries built per K1 launch when K is stored in a narrower type
#: (and multiplied per block on the CPU): each float32 block holds at
#: most 1 GiB, so the build peaks near the stored matrix's size, not at
#: a whole float32 K beside it
NARROW_BUILD_ELEMS = 1 << 28


def _product_f32(A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """A @ V.to(A.dtype) accumulated and returned in float32, as JAX's
    matmul with preferred_element_type=float32 (matvec.py:215-217): one
    cuBLAS GEMM with a float32 output on CUDA (`aten::mm.dtype`); on the
    CPU, which has no such kernel, the stored values multiplied in
    float32 a block of A's columns at a time (no float32 copy of A)."""
    Vq = V.to(A.dtype)
    if A.is_cuda:
        return torch.mm(A, Vq, out_dtype=torch.float32)
    n, k = A.shape
    cols = max(1, NARROW_BUILD_ELEMS // max(n, 1))
    out = torch.zeros((n, V.shape[1]), dtype=torch.float32, device=A.device)
    for s in range(0, k, cols):
        out += A[:, s:s + cols].float() @ Vq[s:s + cols].float()
    return out


class MaterializedOperator:
    """A = s^2 exp(-dist) + bias + sn2 I with K = s^2 exp(-dist) + bias
    built ONCE by the fused Gram kernel (K1, ops/pairwise.py) and held in
    device memory in `store_dtype`; every product is then one matmul
    (plain XLA in the JAX package, so a torch matmul here) plus sn2 V in
    float32 (matvec.py:160-218).

    float32 storage (the "gemm" mode) builds K in one launch and
    multiplies at full float32 precision. bfloat16 storage (the opt-in
    "gemm_bf16" mode) halves the footprint to 2 N^2 bytes: K is built
    NARROW_BUILD_ELEMS entries at a time by K1's cross entry (each row
    block against all points, its diagonal entries set to the square
    build's exact s^2 + bias) and rounded to bfloat16; the product
    rounds V to bfloat16 and accumulates in float32, so a matvec is
    accurate to ~1e-3 relative, which bounds the achievable CG residual
    (inference.iterative.BF16_CG_TOL_FLOOR). The noise diagonal is
    never quantized: sn2 V is added in float32."""

    def __init__(self, Xm: torch.Tensor, sigma, bias, sn2,
                 store_dtype: torch.dtype = torch.float32):
        f32 = torch.float32
        Xm = Xm.to(f32).contiguous()
        self.n = n = Xm.shape[0]
        self.sigma = torch.as_tensor(sigma, dtype=f32, device=Xm.device)
        self.bias = torch.as_tensor(bias, dtype=f32, device=Xm.device)
        self.sn2 = torch.as_tensor(sn2, dtype=f32, device=Xm.device)
        if store_dtype == f32:
            # sn2 = 0: the stored matrix is K only (diagonal s2 + bias)
            self.A = expans_bias_gram(Xm, sigma, bias, 0.0)
            return
        self.A = torch.empty((n, n), dtype=store_dtype, device=Xm.device)
        on_diag = self.sigma * self.sigma + self.bias
        rows = max(1, NARROW_BUILD_ELEMS // max(n, 1))
        for s in range(0, n, rows):
            K = expans_bias_gram(Xm[s:s + rows], sigma, bias, None, Xm2=Xm)
            K.diagonal(offset=s).copy_(on_diag)
            self.A[s:s + rows] = K
            del K       # freed before the next block is built

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matmat(v[:, None])[:, 0]

    def matmat(self, V: torch.Tensor) -> torch.Tensor:
        V = V.to(torch.float32)
        if self.A.dtype == torch.float32:
            with highest_precision():
                KV = self.A @ V
        else:
            KV = _product_f32(self.A, V)
        return KV + self.sn2 * V
