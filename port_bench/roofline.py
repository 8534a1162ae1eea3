"""The yardstick for work-based metrics: peaks, work counts and bounds.

Frozen copies of chip_smoke.py's `PEAK_*` constants, `SFU_PER_SM_CLOCK`,
`POLY_EX2_SLOTS`, `card_rates`, `sfu_fma_ms`, `bound`, `gram_work` and
`matmat_work` (chip_smoke.py at the commit that added this benchmark),
kept here so that a later change to the program or to its smoke run
cannot move what the benchmark measures against. No metric of the
cells in BENCHMARK.json reads them yet: they are the yardstick for the
roofline and step-share readers that later cells add.
"""

from __future__ import annotations

import subprocess

#: NVIDIA H100 SXM data sheet, dense rates at 700 W: HBM bytes/s, FP32
#: outside the tensor cores and TF32 on them, flop/s
PEAK_BYTES_S, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS = 3.35e12, 67e12, 495e12
#: MUFU rsqrt and ex2 per SM per clock (sm_90)
SFU_PER_SM_CLOCK = 16
#: issue slots of an ex2 computed as a polynomial on the FP32 pipes
#: (gp_ss_ak_torch/csrc/ex2_poly.cuh; 10 in its SASS, measured on an
#: H100 80GB HBM3 at 700 W)
POLY_EX2_SLOTS = 10


def card_rates(device_index: int = 0):
    """{"sms": SM count, "clock_hz": maximum SM clock} of the card, for
    the SFU term of `bound`; read from the card in the run."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", f"--id={device_index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(device_index)
    return {"sms": props.multi_processor_count,
            "clock_hz": float(mhz) * 1e6}


def sfu_fma_ms(work, sms: int, clock_hz: float):
    """(MUFU-only ms, balanced ms) of the SFU and FP32 work of `work`
    (see `bound`), whose SFU operations are one rsqrt and one ex2 an
    entry. Balanced lets x of the ex2 stay on MUFU and computes the rest
    as a polynomial on the FP32 pipes, at the best x, where the two
    units finish together. The FP32 work counts as FMAs, a floor."""
    _, fp32, sfu, _ = work
    mufu = sms * SFU_PER_SM_CLOCK * clock_hz          # operations / s
    slots = PEAK_FP32_FLOPS / 2.0                      # FP32 instructions / s
    rsqrt = ex2 = sfu / 2.0
    f = fp32 / 2.0
    c = POLY_EX2_SLOTS
    mufu_only = max((rsqrt + ex2) / mufu, f / slots)
    x = (mufu * (f + c * ex2) - slots * rsqrt) / (slots + c * mufu)
    x = min(max(x, 0.0), ex2)
    balanced = max((rsqrt + x) / mufu, (f + c * (ex2 - x)) / slots)
    return mufu_only * 1e3, balanced * 1e3


def bound(work, sms: int, clock_hz: float):
    """(bound_ms, term): the least time the card could take for `work` =
    (bytes moved, FP32 operations outside any product, SFU operations,
    product operations at float32 accuracy priced as three TF32
    products), the largest of its terms, and which one it is."""
    nbytes, _, _, tensor = work
    terms = {"bytes": nbytes / PEAK_BYTES_S,
             "SFU/FMA": sfu_fma_ms(work, sms, clock_hz)[1] / 1e3,
             "tensor": tensor / PEAK_TF32_FLOPS}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, term


def gram_work(n: int, m: int, d: int):
    """K1's work for n*m Gram entries over d features: the output written
    once and the points read once; 3d + 2 FP32 operations an entry; an
    rsqrt and an ex2 an entry."""
    return 4.0 * (n * m + (n + m) * d), float(n) * m * (3 * d + 2), \
        2.0 * n * m, 0.0


def matmat_work(n: int, d: int, b: int):
    """K3's work for one pass over the n*n Gram entries against b
    columns: the points (padded to a float4), V and Y once; 3d + 1 FP32
    operations an entry outside the product; two SFU operations an
    entry; the product 2 n^2 b priced as three TF32 products."""
    return 4.0 * n * (4 + 2 * b), float(n) * n * (3 * d + 1), \
        2.0 * n * n, 3 * 2.0 * n * n * b

