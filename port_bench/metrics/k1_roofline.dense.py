"""k1_roofline.dense: the dense objective's K1 launch (the 2-D
gram_kernel<double>, one an evaluation) as a share of its roofline, in
%: k1_roofline.ens's reading of one problem, the configuration's n and
d as a single deposit. The dense objective runs K1 in float64
(gp_ss_ak_torch/optim/api.py OBJECTIVE_DTYPE), as the batched one does,
so the same bound holds: the larger of gram_work's bytes at 8 a value
over the HBM rate and its 3d + 2 FP64 operations an entry over the FP64
rate, over the device time of K1's kernel per evaluation of the traced
window."""

from types import SimpleNamespace

from port_bench import manifest

_ens = manifest.reader("k1_roofline.ens")


def read(run):
    if run.trace is None:
        return None
    return _ens(SimpleNamespace(trace=run.trace, record=run.record,
                                config=dict(run.config, deposits=1)))
