"""The fused ExpAns+Bias Gram build — the hot op of the serving path.

    A = sigma^2 * exp(-||xi - xj||) + bias  [+ sn2 on the diagonal]

over metric-mapped points, so the squared-distance matrix never exists
in device memory. On a CUDA tensor `expans_bias_gram` launches the
hand-written kernel csrc/gram.cu (K1; it replaces the Pallas
gp_ss_ak_tpu/ops/pairwise.py::_gram_kernel) or raises. On a CPU tensor
it runs `expans_bias_gram_plain`, the same function in plain torch,
which keeps the TPU kernel's |xi|^2 + |xj|^2 - 2 xi.xj expansion so CPU
results track the JAX package to round-off.

Both take one point set (n, d) or a batch of them (B, n, d), the JAX
package's `jax.vmap` over ensemble members and sampler chains written
out: each member has its own sigma, bias and sn2 ((B,) tensors), and a
batch is one launch of the kernel's batched entry.
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.ops import _build

#: number of times `expans_bias_gram` has launched the CUDA kernel on one
#: point set (2-D), and on a batch of them (3-D: one launch per batch)
launches = 0
batched_launches = 0


def _scalars(sigma, bias, sn2, like: torch.Tensor) -> torch.Tensor:
    """[sigma^2, bias, sn2] on `like`'s device: (3,) for scalar
    hyperparameters, (B, 3) for (B,) ones. Hyperparameters that already
    live there are not copied."""
    def t(v):
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)

    s = t(sigma)
    noise = (torch.zeros((), dtype=like.dtype, device=like.device)
             if sn2 is None else t(sn2))
    return torch.stack(torch.broadcast_tensors(s * s, t(bias), noise),
                       dim=-1)


def expans_bias_gram_plain(Xm: torch.Tensor, sigma, bias, sn2=None,
                           Xm2: torch.Tensor = None) -> torch.Tensor:
    """The kernel's function in plain torch (the TPU kernel's math,
    pairwise.py:49-71): expansion, clamp, exp, and the exact diagonal
    s2 + bias + sn2 for the square build with sn2 given. Leading batch
    axes broadcast against the hyperparameters' shape."""
    same = Xm2 is None
    X2 = Xm if same else Xm2
    scal = _scalars(sigma, bias, sn2, Xm)
    ni = torch.sum(Xm * Xm, dim=-1, keepdim=True)
    nj = torch.sum(X2 * X2, dim=-1, keepdim=True)
    d2 = torch.clamp_min(ni + nj.mT - 2.0 * (Xm @ X2.mT), 0.0)
    K = (scal[..., 0, None, None] * torch.exp(-torch.sqrt(d2))
         + scal[..., 1, None, None])
    if same and sn2 is not None:
        on_diag = scal[..., 0] + scal[..., 1] + scal[..., 2]
        K.diagonal(dim1=-2, dim2=-1).copy_(on_diag[..., None])
    return K


def _launch(Xm: torch.Tensor, X2: torch.Tensor, scal: torch.Tensor,
            with_diag: bool) -> torch.Tensor:
    global launches, batched_launches
    if Xm.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expans_bias_gram: float32 or float64, got "
                        f"{Xm.dtype}")
    rank = Xm.dim()
    if rank not in (2, 3):
        raise ValueError(f"expans_bias_gram: Xm must be (n, d) or "
                         f"(B, n, d), got shape {tuple(Xm.shape)}")
    for name, t in (("Xm", Xm), ("Xm2", X2)):
        if t.dim() != rank:
            raise ValueError(f"expans_bias_gram: {name} must be {rank}-D, "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != Xm.dtype or t.device != Xm.device:
            raise TypeError(f"expans_bias_gram: {name} is {t.dtype} on "
                            f"{t.device}, Xm is {Xm.dtype} on {Xm.device}")
        if not t.is_contiguous():
            raise ValueError(f"expans_bias_gram: {name} must be contiguous")
    *batch, n, d = Xm.shape
    *batch2, m, d2 = X2.shape
    if d2 != d:
        raise ValueError(f"expans_bias_gram: feature dims differ ({d} vs "
                         f"{d2})")
    if batch2 != batch:
        raise ValueError(f"expans_bias_gram: batch sizes differ ({batch} "
                         f"vs {batch2})")
    B = batch[0] if batch else 1
    if max(n, m, d, B) >= 2 ** 31:
        raise ValueError("expans_bias_gram: sizes must fit in int32")
    if batch:
        scal = scal.expand(B, 3).contiguous()
    elif scal.shape != (3,):
        raise ValueError("expans_bias_gram: one point set takes scalar "
                         "hyperparameters")
    out = torch.empty((*batch, n, m), dtype=Xm.dtype, device=Xm.device)
    if n == 0 or m == 0 or B == 0:
        return out
    lib = _build.load()
    stream = torch.cuda.current_stream(Xm.device).cuda_stream
    f32 = Xm.dtype == torch.float32
    if batch:
        fn = lib.gp_gram_batched_f32 if f32 else lib.gp_gram_batched_f64
        code = fn(Xm.data_ptr(), X2.data_ptr(), scal.data_ptr(),
                  out.data_ptr(), B, n, m, d, int(with_diag),
                  Xm.device.index, stream)
    else:
        fn = lib.gp_gram_f32 if f32 else lib.gp_gram_f64
        code = fn(Xm.data_ptr(), X2.data_ptr(), scal.data_ptr(),
                  out.data_ptr(), n, m, d, int(with_diag), Xm.device.index,
                  stream)
    _build.check(lib, code, "gram kernel launch")
    if batch:
        batched_launches += 1
    else:
        launches += 1
    return out


def expans_bias_gram(Xm: torch.Tensor, sigma, bias, sn2=None,
                     Xm2: torch.Tensor = None) -> torch.Tensor:
    """Fused A = sigma^2 exp(-||xi - xj||) + bias [+ sn2 I].

    Xm: metric-mapped, recentred points (N, d) — (X - c) @ M for ExpAns
    (ops/fused.py), so plain Euclidean distance here equals the
    reference's MahaDist — or a batch of them (B, N, d) with (B,)
    hyperparameters, giving (B, N, M). Pass Xm2 for a cross Gram (no
    diagonal terms, even where the two sets share points). sigma, bias
    and sn2 are Python floats or tensors (0-d, or (B,) for a batch).
    CUDA tensors launch the CUDA kernel (float32 or float64,
    contiguous), CPU tensors run the plain version.
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
