"""Matrix-free Gram matmat: Y = A V with A = K + bias + sn2 I, K never built.

    K = s^2 exp(-||xi - xj||),   K(i, i) = s^2 exactly,
    Y = K V + bias * colsum(V) + sn2 * V

over metric-mapped points (ops/fused.mapped_points' convention). At
N = 65536 an f32 K is 17 GB; every CG pass of the matrix-free server
(serve.IterativePredictor) streams it tile by tile instead. On a CUDA
tensor `streamed_matmat` launches the hand-written kernel
csrc/matmat.cu (K3; it replaces the Pallas
gp_ss_ak_tpu/ops/matvec.py::_matmat_kernel) or raises. On a CPU tensor
it runs `streamed_matmat_plain`, the same function in plain torch in
row chunks, which keeps the TPU kernel's |xi|^2 + |xj|^2 - 2 xi.xj
expansion and clamp so CPU results track the JAX package's kernel.

The bias and noise terms are rank-1 and diagonal and are added outside
the kernel, as in the JAX package. The port needs none of the TPU
layout (points transposed to (dpad, npad), n padded to the tile, V
padded to 8-row blocks): the kernel takes row-major points and V and
masks ragged edges. It only wants each point as whole float4s, so
`operator_arrays` zero-pads the features to a multiple of 4, at most 16
(zero features add nothing to a distance).

Not ported yet (the training slice): `MatvecOperator` with K2
(`_matvec_kernel`) and `MaterializedOperator`.
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.kernels.distance import gram_sqdist, highest_precision
from gp_ss_ak_torch.ops import _build

#: number of times `streamed_matmat` has launched the CUDA kernel
launches = 0

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
