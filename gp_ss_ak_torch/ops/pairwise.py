"""The fused ExpAns+Bias Gram build — the hot op of the serving path.

    A = sigma^2 * exp(-||xi - xj||) + bias  [+ sn2 on the diagonal]

over metric-mapped points, so the squared-distance matrix never exists
in device memory. On a CUDA tensor `expans_bias_gram` launches the
hand-written kernel csrc/gram.cu (K1; it replaces the Pallas
gp_ss_ak_tpu/ops/pairwise.py::_gram_kernel) or raises. On a CPU tensor
it runs `expans_bias_gram_plain`, the same function in plain torch,
which keeps the TPU kernel's |xi|^2 + |xj|^2 - 2 xi.xj expansion so CPU
results track the JAX package to round-off.
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.ops import _build

#: number of times `expans_bias_gram` has launched the CUDA kernel
launches = 0


def _scalars(sigma, bias, sn2, like: torch.Tensor) -> torch.Tensor:
    """[sigma^2, bias, sn2] as one (3,) tensor on `like`'s device.
    Hyperparameters that already live there are not copied."""
    def t(v):
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)

    s = t(sigma)
    noise = (torch.zeros((), dtype=like.dtype, device=like.device)
             if sn2 is None else t(sn2))
    return torch.stack([s * s, t(bias), noise])


def expans_bias_gram_plain(Xm: torch.Tensor, sigma, bias, sn2=None,
                           Xm2: torch.Tensor = None) -> torch.Tensor:
    """The kernel's function in plain torch (the TPU kernel's math,
    pairwise.py:49-71): expansion, clamp, exp, and the exact diagonal
    s2 + bias + sn2 for the square build with sn2 given."""
    same = Xm2 is None
    X2 = Xm if same else Xm2
    scal = _scalars(sigma, bias, sn2, Xm)
    ni = torch.sum(Xm * Xm, dim=1, keepdim=True)
    nj = torch.sum(X2 * X2, dim=1, keepdim=True)
    d2 = torch.clamp_min(ni + nj.T - 2.0 * (Xm @ X2.T), 0.0)
    K = scal[0] * torch.exp(-torch.sqrt(d2)) + scal[1]
    if same and sn2 is not None:
        K.diagonal().copy_(scal[0] + scal[1] + scal[2])
    return K


def _launch(Xm: torch.Tensor, X2: torch.Tensor, scal: torch.Tensor,
            with_diag: bool) -> torch.Tensor:
    global launches
    if Xm.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expans_bias_gram: float32 or float64, got "
                        f"{Xm.dtype}")
    for name, t in (("Xm", Xm), ("Xm2", X2)):
        if t.dim() != 2:
            raise ValueError(f"expans_bias_gram: {name} must be 2-D, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype != Xm.dtype or t.device != Xm.device:
            raise TypeError(f"expans_bias_gram: {name} is {t.dtype} on "
                            f"{t.device}, Xm is {Xm.dtype} on {Xm.device}")
        if not t.is_contiguous():
            raise ValueError(f"expans_bias_gram: {name} must be contiguous")
    n, d = Xm.shape
    m = X2.shape[0]
    if X2.shape[1] != d:
        raise ValueError(f"expans_bias_gram: feature dims differ ({d} vs "
                         f"{X2.shape[1]})")
    if max(n, m, d) >= 2 ** 31:
        raise ValueError("expans_bias_gram: sizes must fit in int32")
    out = torch.empty((n, m), dtype=Xm.dtype, device=Xm.device)
    if n == 0 or m == 0:
        return out
    lib = _build.load()
    fn = lib.gp_gram_f32 if Xm.dtype == torch.float32 else lib.gp_gram_f64
    stream = torch.cuda.current_stream(Xm.device).cuda_stream
    code = fn(Xm.data_ptr(), X2.data_ptr(), scal.data_ptr(), out.data_ptr(),
              n, m, d, int(with_diag), Xm.device.index, stream)
    _build.check(lib, code, "gram kernel launch")
    launches += 1
    return out


def expans_bias_gram(Xm: torch.Tensor, sigma, bias, sn2=None,
                     Xm2: torch.Tensor = None) -> torch.Tensor:
    """Fused A = sigma^2 exp(-||xi - xj||) + bias [+ sn2 I].

    Xm: metric-mapped, recentred points (N, d) — (X - c) @ M for ExpAns
    (ops/fused.py), so plain Euclidean distance here equals the
    reference's MahaDist. Pass Xm2 for a cross Gram (no diagonal terms,
    even where the two sets share points). sigma, bias and sn2 are
    Python floats or 0-d tensors. CUDA tensors launch the CUDA kernel
    (float32 or float64, contiguous), CPU tensors run the plain version.
    """
    same = Xm2 is None
    X2 = Xm if same else Xm2
    if Xm.device.type == "cpu":
        return expans_bias_gram_plain(Xm, sigma, bias, sn2, Xm2)
    if Xm.device.type != "cuda":
        raise ValueError(f"expans_bias_gram: no kernel for device "
                         f"{Xm.device}")
    scal = _scalars(sigma, bias, sn2, Xm)
    return _launch(Xm, X2, scal, same and sn2 is not None)
