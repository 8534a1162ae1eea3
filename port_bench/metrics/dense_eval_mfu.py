"""dense_eval_mfu: a fixed float64 work count for one dense NLML +
gradient at the configuration's N, as a share of what the card could do
in the traced window's time per evaluation, in %: the count's least
time over the window's time per evaluation completed in it (the
optimizer's time between evaluations included, as train_eval_ms).

The count does not depend on how the program computes an evaluation,
so that a cheaper schedule of the same work raises the share:
- the Cholesky factor, n^3 / 3 flop, and A^-1 from it, 2 n^3 / 3 flop
  (a triangular inverse and a triangular product, LAPACK's potri),
  both at the FP64 tensor-core rate;
- K1's forward and backward, each the larger of its bytes over the HBM
  rate and its 3d + 2 FP64 operations an entry over the FP64 rate
  outside the tensor cores: the forward writes the float64 Gram and
  reads the points (twice gram_work's 4-byte count); the backward reads
  the Gram's float64 adjoint once and the points.
The solves against y, the log-determinant and the chain rule to the ten
hyperparameters are O(n^2) or less and left out.
"""

from port_bench import roofline, window

#: NVIDIA H100 SXM data sheet, flop/s: FP64 on the tensor cores, and
#: outside them
PEAK_FP64_TENSOR_FLOPS, PEAK_FP64_FLOPS = 67e12, 34e12


def least_s(n: int, d: int) -> float:
    """The least time of one dense evaluation's counted work, seconds."""
    nbytes, fp, _, _ = roofline.gram_work(n, n, d)
    k1 = max(2 * nbytes / roofline.PEAK_BYTES_S, fp / PEAK_FP64_FLOPS)
    return float(n) ** 3 / PEAK_FP64_TENSOR_FLOPS + 2 * k1


def read(run):
    if run.trace is None or not run.record.completed():
        return None
    c = run.config
    per_eval_s = window.per_item_ms(run.record) * 1e-3
    return 100.0 * least_s(c["n"], c["d"]) / per_eval_s
