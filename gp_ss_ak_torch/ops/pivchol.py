"""The pivoted Cholesky's steps on the card (K6).

`pivoted_cholesky(Xm, sigma, bias, rank)` factors K = s2 exp(-||xi - xj||)
+ bias on metric-mapped points Xm (n, d) to rank `rank`, greedy
max-diagonal pivoting, as inference/iterative.py's
`pivoted_cholesky_plain` does, and returns L (n, rank) with L L^T ~ K.
On a CUDA tensor it queues one launch of the hand-written kernel
csrc/pivchol.cu a step, all `rank` of them from one C call on the current
stream, the pivot chosen on the card: the host makes no read. It
replaces no TPU kernel (the JAX package runs the recursion as XLA inside
lax.fori_loop); it replaces the plain version's ~25 torch launches a
step. Another device raises here: inference.iterative.pivoted_cholesky
sends CPU tensors to the plain version.

The kernel holds L^T (rank, ld), ld the first multiple of 32 at or past
n, and L is returned as the (n, rank) view of its first n columns,
which the consumers' products read without a copy. It takes float32 and
float64, 1 <= d <= MAX_FEATURES features, any rank >= 0 (past n the
remaining columns are zero, as the plain loop gives) and sigma and bias
as numbers or tensors on any device (a device tensor is read on the
card). The two differ by the order of the dot product's sums alone, so
the pivots agree until two residuals come within round-off.
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.ops import _build

#: number of kernel launches `pivoted_cholesky` has queued: one a step,
#: `rank` a call
launches = 0

#: the most features the kernel takes
MAX_FEATURES = 16

#: threads per block (csrc/pivchol.cu NT)
THREADS = 256

#: the k-split choices: groups of a block's threads that share its points
#: and split the rows of L^T between them (csrc/pivchol.cu KS)
SPLITS = (1, 2, 4, 8)

#: blocks a plan aims at: two a streaming multiprocessor on an H100's
#: 132, so that enough rows are read at once to keep the stream near the
#: card's bandwidth
MIN_BLOCKS = 264

#: the row stride of L^T is a multiple of this many entries
LD_ALIGN = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pivchol_plan(n: int, itemsize: int):
    """(ld, splits, points per block, blocks) of K6 for n points of
    `itemsize` bytes: each thread takes 16 bytes of points (four floats
    or two doubles), a block THREADS threads in `splits` groups, so a
    block owns THREADS * 16 / itemsize / splits consecutive points and
    block b the points [b * per_block, (b + 1) * per_block) below n. The
    fewest splits that make MIN_BLOCKS blocks, else the most. A function
    of n and the type alone: every launch of a call, and every call at
    the same n, sums in the same order."""
    per_thread = 16 // itemsize
    for splits in SPLITS:
        per_block = per_thread * THREADS // splits
        blocks = _cdiv(n, per_block)
        if blocks >= MIN_BLOCKS:
            break
    return _cdiv(n, LD_ALIGN) * LD_ALIGN, splits, per_block, blocks


def _check_inputs(Xm: torch.Tensor, rank: int) -> None:
    if Xm.device.type != "cuda":
        raise ValueError(f"pivoted_cholesky: no kernel for device "
                         f"{Xm.device}")
    if Xm.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pivoted_cholesky: float32 or float64 points, got "
                        f"{Xm.dtype}")
    if Xm.dim() != 2 or Xm.shape[0] < 1:
        raise ValueError(f"pivoted_cholesky: points (n, d) with n >= 1 "
                         f"needed, got {tuple(Xm.shape)}")
    if not Xm.is_contiguous():
        raise ValueError("pivoted_cholesky: Xm must be contiguous")
    if not 1 <= Xm.shape[1] <= MAX_FEATURES:
        raise ValueError(f"pivoted_cholesky: 1 to {MAX_FEATURES} features, "
                         f"got {Xm.shape[1]}")
    if rank < 0:
        raise ValueError(f"pivoted_cholesky: rank must be >= 0, got {rank}")
    n = Xm.shape[0]
    if _cdiv(n, LD_ALIGN) * LD_ALIGN >= 2 ** 31 or n * Xm.shape[1] >= 2 ** 31:
        raise ValueError("pivoted_cholesky: sizes must fit in int32")


def run_kernel(Xm: torch.Tensor, scal: torch.Tensor, rank: int,
               alternate: bool = True) -> torch.Tensor:
    """All `rank` launches of K6 on checked points Xm and scal = [s2,
    bias] of their dtype on their card, by the plan of `pivchol_plan`:
    L^T (rank, ld). `alternate` flips the sweep's direction from step to
    step, so that the rows of L^T read last in one step are read first,
    from L2, in the next; the program always alternates, and False is
    there so that `chip_smoke.py` can time the one-direction sweep beside
    it (csrc/pivchol.cu gives the readings that decided it)."""
    global launches
    n, d = Xm.shape
    ld, splits, _, blocks = pivchol_plan(n, Xm.element_size())
    dev = Xm.device
    lt = torch.empty((rank, ld), dtype=Xm.dtype, device=dev)
    dvec = torch.empty(n, dtype=Xm.dtype, device=dev)
    pval = torch.empty((2, blocks), dtype=Xm.dtype, device=dev)
    pidx = torch.empty((2, blocks), dtype=torch.int32, device=dev)
    lib = _build.load()
    fn = lib.gp_pivchol_f32 if Xm.dtype == torch.float32 \
        else lib.gp_pivchol_f64
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(Xm.data_ptr(), scal.data_ptr(), lt.data_ptr(),
              dvec.data_ptr(), pval.data_ptr(), pidx.data_ptr(), n, d, ld,
              rank, splits, int(alternate), dev.index, stream)
    _build.check(lib, code, "pivoted Cholesky kernel launch")
    launches += rank
    return lt


def pivoted_cholesky(Xm: torch.Tensor, sigma, bias, rank: int) -> torch.Tensor:
    """L (n, rank), L L^T ~ K, for points Xm (n, d) on a card: the
    module's docstring."""
    _check_inputs(Xm, rank)
    n = Xm.shape[0]
    if rank == 0:
        return Xm.new_zeros((n, 0))
    s = torch.as_tensor(sigma, dtype=Xm.dtype, device=Xm.device).reshape(())
    b = torch.as_tensor(bias, dtype=Xm.dtype, device=Xm.device).reshape(())
    scal = torch.stack((s * s, b))
    return run_kernel(Xm, scal, rank)[:, :n].T
