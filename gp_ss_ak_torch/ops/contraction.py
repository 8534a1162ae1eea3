"""The matrix-free gradient's contraction against dA/dtheta (K4).

With U = [w_1..w_m, alpha], V = [z_1..z_m, alpha], c = [1/m.., -1] and
W(p, j) = sum_l c_l U(p, l) V(j, l), the gradient of
1/2 sum_pj W(p, j) A(p, j), A = s2 exp(-r) + bias + sn2 I over
metric-mapped points, is in closed form (inference/iterative.py's
`_grad_contraction` adds the O(N m) terms and the factors):

    t[p] = sum_j W(p, j) exp(-r(p, j))           (the diagonal gives W(p, p))
    g[p] = sum_{j : d2 >= 1e-30} (W(p, j) + W(j, p)) exp(-r) / r (xp - xj)

`expans_contraction(Xm, cU, V)` returns (t, g) from cU = c * U. On a
CUDA tensor it launches the hand-written kernel csrc/contraction.cu (K4;
it replaces no TPU kernel: the JAX package contracts in XLA through
jax.grad, and the port's first version through torch.autograd, both
building every Gram entry in device memory) or raises. On a CPU tensor
it runs `expans_contraction_plain`, the same closed form in plain torch,
a chunk of rows at a time, in the inputs' dtype, with no autograd. The
kernel squares distances by direct differences; the plain version keeps
the arithmetic of the JAX package's autograd (the |xi|^2 + |xj|^2 -
2 xi.xj expansion, and g as xp sum f - sum f xj), as the plain versions
of K1-K3 keep the TPU kernels', so CPU fits take the JAX package's path
to round-off.

The kernel takes d <= 16 features (d <= 3 on its fast path, zero
features padding d < 3) and a rank m + 1 of at most MAX_RANK columns:
it picks its instance (9, 17 or 33 columns, the rest zero) from the
shapes. float32 only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gp_ss_ak_torch.kernels.distance import gram_sqdist, highest_precision
from gp_ss_ak_torch.ops import _build

#: number of times `expans_contraction` has launched the CUDA kernel K4
launches = 0

#: the widest rank (columns of U and V) one launch takes
MAX_RANK = 33

#: the kernel's column counts: a rank is padded to the first that holds it
RANKS = (9, 17, 33)

#: the most features the kernel takes (d <= 3 run the fast instance)
MAX_FEATURES = 16

#: K4's widest column slice: each row's sum over a slice is one float32
#: chain of column tiles, kept short (at N = 100000 on an H100, 8 slices
#: of 12544 columns held d_sigma to 1.1e-7 of float64 against 2.0e-7 with
#: 2 slices of 50048, and ran no slower)
MAX_SLICE = 16384

#: rows per chunk of the plain version (no N x N buffer exists)
PLAIN_CHUNK = 1024

#: d2 below which a pair adds nothing to g (the autograd version's
#: clamp_min(d2, 1e-30))
D2_MIN = 1e-30

LOG2E = 1.4426950408889634


def expans_contraction_plain(Xm: torch.Tensor, cU: torch.Tensor,
                             V: torch.Tensor, chunk: int = PLAIN_CHUNK):
    """(t (n,), g (n, d)) in plain torch, in the dtype of the inputs,
    `chunk` rows at a time: d2 by the expansion (its diagonal exactly 0),
    g as xp sum_j f - sum_j f xj."""
    n = Xm.shape[0]
    t = torch.empty(n, dtype=Xm.dtype, device=Xm.device)
    g = torch.empty_like(Xm)
    with highest_precision():
        for s in range(0, n, chunk):
            d2 = gram_sqdist(Xm[s:s + chunk], Xm)
            d2.diagonal(offset=s).zero_()
            far = d2 >= D2_MIN
            r = torch.sqrt(torch.clamp_min(d2, D2_MIN))
            e = torch.exp(-r)
            w = cU[s:s + chunk] @ V.T                        # W(p, j)
            t[s:s + chunk] = torch.sum(w * e, dim=1)
            f = torch.where(far, (w + V[s:s + chunk] @ cU.T) * e / r, 0.0)
            g[s:s + chunk] = torch.sum(f, 1, keepdim=True) \
                * Xm[s:s + chunk] - f @ Xm
    return t, g


def padded_rank(k: int) -> int:
    """The kernel's column count for rank k (<= MAX_RANK)."""
    for mp in RANKS:
        if k <= mp:
            return mp
    raise ValueError(f"expans_contraction: rank {k} > {MAX_RANK}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def _shape(dp: int, mp: int, index: int):
    """(rows per block, column tile, floats per record, blocks an SM holds)
    of the (dp, mp) instance on card `index`."""
    lib = _build.load()
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.gp_contraction_shape(dp, mp, out, index),
                 "contraction kernel shape")
    return tuple(out)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def contraction_slices(n: int, rows: int, tile: int, wave: int):
    """(slice width, slice count) of K4's column split: each (row block,
    slice) pair is a block, `wave` of them run at once, and each takes
    time in proportion to its slice's width, so the launch takes about
    ceil(blocks / wave) slice widths. The plan takes the fewest slices
    (whole tiles, at most MAX_SLICE columns each) whose launch is within
    2% of the shortest of up to 64 more. A function of n and the card
    alone, so two launches sum in the same order. At n = 100000, rank 9
    on an H100 80GB HBM3 (700 W) it picks 8 slices of 12544 columns,
    which ran in 14.22 ms against 14.89 ms for the fewest, 7 slices of
    14336, whose last wave holds 184 of 396 blocks."""
    row_blocks = _cdiv(n, rows)
    least = _cdiv(n, MAX_SLICE)
    plans = []
    for k in range(least, min(_cdiv(n, tile), least + 64) + 1):
        width = _cdiv(_cdiv(n, k), tile) * tile
        slices = _cdiv(n, width)
        plans.append((_cdiv(row_blocks * slices, wave) * width, slices,
                      width))
    best = min(p[0] for p in plans)
    _, slices, width = next(p for p in plans if p[0] <= 1.02 * best)
    return width, slices


def _check_inputs(Xm: torch.Tensor, cU: torch.Tensor, V: torch.Tensor):
    for name, x in (("Xm", Xm), ("cU", cU), ("V", V)):
        if x.dtype != torch.float32:
            raise TypeError(f"expans_contraction: {name} must be float32, "
                            f"got {x.dtype}")
        if x.device != Xm.device:
            raise TypeError(f"expans_contraction: {name} is on {x.device}, "
                            f"Xm on {Xm.device}")
        if not x.is_contiguous():
            raise ValueError(f"expans_contraction: {name} must be "
                             f"contiguous")
    if Xm.dim() != 2 or cU.dim() != 2 or cU.shape != V.shape \
            or cU.shape[0] != Xm.shape[0]:
        raise ValueError(f"expans_contraction: Xm (n, d), cU and V (n, k) "
                         f"needed, got {tuple(Xm.shape)}, "
                         f"{tuple(cU.shape)} and {tuple(V.shape)}")
    d, k = Xm.shape[1], V.shape[1]
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"expans_contraction: 1 to {MAX_FEATURES} "
                         f"features, got {d}")
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"expans_contraction: rank 1 to {MAX_RANK}, got "
                         f"{k}")


def records(Xm: torch.Tensor, cU: torch.Tensor, V: torch.Tensor):
    """The launch's inputs for n >= 1 checked float32 points Xm (n, d),
    cU and V (n, k) on a card: (rec, the zero-padded records
    [Xm * log2 e | V | cU] of csrc/contraction.cu, one a row; plan, the
    kernel's arguments after rec and partial)."""
    n, d = Xm.shape
    k = V.shape[1]
    dp = 3 if d <= 3 else MAX_FEATURES
    mp = padded_rank(k) if dp == 3 else MAX_RANK
    index = Xm.device.index
    rows, tile, floats, per_sm = _shape(dp, mp, index)
    width, slices = contraction_slices(n, rows, tile,
                                       max(per_sm, 1) * _sm_count(index))
    rows_pad = _cdiv(n, rows) * rows
    npad = max(rows_pad, slices * width)
    if npad * floats >= 2 ** 31 or slices * rows_pad * (1 + dp) >= 2 ** 31:
        raise ValueError("expans_contraction: sizes must fit in int32")
    dx = _cdiv(dp, 4) * 4
    rec = torch.zeros((npad, floats), dtype=torch.float32, device=Xm.device)
    rec[:n, :d] = Xm * LOG2E
    rec[:n, dx:dx + k] = V
    rec[:n, dx + mp:dx + mp + k] = cU
    return rec, (rows_pad, width, slices, dp, mp)


def run_kernel(rec: torch.Tensor, plan) -> torch.Tensor:
    """One launch of K4 on `records`' output: the partial sums (slices,
    rows_pad, 1 + dp), each row's [t, g] over one column slice."""
    global launches
    rows_pad, width, slices, dp, mp = plan
    partial = torch.empty((slices, rows_pad, 1 + dp), dtype=torch.float32,
                          device=rec.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(rec.device).cuda_stream
    code = lib.gp_contraction_f32(rec.data_ptr(), partial.data_ptr(),
                                  rows_pad, width, slices, dp, mp,
                                  rec.device.index, stream)
    _build.check(lib, code, "contraction kernel launch")
    launches += 1
    return partial


def expans_contraction(Xm: torch.Tensor, cU: torch.Tensor, V: torch.Tensor,
                       chunk: int = PLAIN_CHUNK):
    """(t (n,), g (n, d)) of the module's docstring for metric-mapped
    points Xm (n, d), cU = c * U and V (n, k). CUDA tensors launch K4
    (float32, contiguous, d <= MAX_FEATURES, k <= MAX_RANK); CPU tensors
    run the plain version `chunk` rows at a time."""
    if Xm.device.type == "cpu":
        return expans_contraction_plain(Xm, cU, V, chunk)
    if Xm.device.type != "cuda":
        raise ValueError(f"expans_contraction: no kernel for device "
                         f"{Xm.device}")
    _check_inputs(Xm, cU, V)
    n, d = Xm.shape
    if n == 0:
        return Xm.new_zeros(0), Xm.new_zeros(0, d)
    partial = run_kernel(*records(Xm, cU, V))
    total = torch.sum(partial[:, :n], dim=0, dtype=torch.float64)
    return total[:, 0].float(), total[:, 1:1 + d].float()
