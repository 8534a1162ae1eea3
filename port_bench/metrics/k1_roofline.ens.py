"""k1_roofline.ens: the batched K1 launch's share of its roofline, in %:
the least time for B x gram_work(n, n, d) (the configuration's deposits
and sizes: every Gram entry written once, every point read once) over
the device time of K1's kernel (found by its name in the trace) per
batched evaluation of the traced window, each of which launches it
once.

The batched fit's objective runs K1 in float64 (gp_ss_ak_torch/optim/
api.py OBJECTIVE_DTYPE): its entries and points take 8 bytes, twice
gram_work's, and its arithmetic runs on the FP64 pipes, which have no
MUFU. So the least time is the larger of those bytes over the HBM rate
and the 3d + 2 FP64 operations of an entry over the FP64 rate.
"""

from port_bench import roofline

KERNEL = "gram_kernel<double>"
#: NVIDIA H100 SXM data sheet, FP64 outside the tensor cores, flop/s
PEAK_FP64_FLOPS = 34e12


def read(run):
    if run.trace is None:
        return None
    times = [d for name, _, d in run.trace.kernels if KERNEL in name]
    if not times:
        return None
    c = run.config
    nbytes, fp, _, _ = (c["deposits"] * w for w in
                        roofline.gram_work(c["n"], c["n"], c["d"]))
    bound_ms = 1e3 * max(2 * nbytes / roofline.PEAK_BYTES_S,
                         fp / PEAK_FP64_FLOPS)
    per_eval_ms = sum(times) * 1e-3 / len(run.record.items)
    return 100.0 * bound_ms / per_eval_ms
