"""The cell dense16k-fit driven end to end on the CPU at N = 300, the
look for a card skipped: the program's answers pass, and the control
(the reference in TF32 in the program's place), the float32 objective
(the program's arithmetic before its objective moved to float64), the
optimizer's iterate frozen and one gradient entry altered each come out
not correct. Then the cell's readers on made-up traces.

The limits here are this size's own. At 300 points the float32
objective's gradient reads 6e-4-0.13 of its scale, the float64 one
1e-10 or less. The host L-BFGS-B of 100 iterations ends 0.03-0.24 of
the reference's decrease short of the reference's own fit (the data are
too few for the smooth grade: both take sn2 to the box, where the
program's two-metric projection crawls), the frozen iterate 0.31-0.32
(seeds 11-13 and the test's), so the margin is thin here: the cell's
limit comes from the readings at 16384 points."""

import inspect
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import harness, manifest
from port_bench.trace import Traced
from port_bench.window import Item, Record

CELL = "dense16k-fit"
LIMITS = {"std_abs": 0.0, "nlml_rel": 1e-6, "grad_rel": 1e-5,
          "fit_gap": 0.28}
SMALL = {"config": {"n": 300, "reference": {"module": "gp_dense",
                                            "tile": 128, "chunk": 100}},
         "traffic": {"iters": 100},
         "spec": {"answers": 8, "limits": LIMITS}}


def run(control=False, seed=987654321012, seconds=4.0, overrides=SMALL,
        log=None):
    result, _ = harness.run(CELL, seed, seconds, False, time.perf_counter(),
                            device="cpu", control=control,
                            overrides=overrides, log=log)
    return result


@pytest.mark.parametrize("checked", ["whole", "cut at the close"])
def test_the_program_passes(checked):
    """On the last whole fit, and on the fit that the callback cut where
    the first outlasts the window (here by 500 iterations in 1 s)."""
    lines = []
    if checked == "whole":
        r = run(log=lines.append)
    else:
        r = run(seconds=1.0, log=lines.append,
                overrides=dict(SMALL, traffic={"iters": 500}))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 9 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "train_eval_ms"}
    assert any(f"the checked fit {checked}," in line for line in lines)


def test_the_tf32_control_fails():
    r = run(control=True)
    assert not r["correct"]


# -- the timed path broken underneath --------------------------------------

def _fit_float32(monkeypatch):
    """The dense objective in float32, as the program evaluated it before
    (the fault of ROADMAP F3)."""
    from gp_ss_ak_torch.optim import api

    monkeypatch.setattr(api, "OBJECTIVE_DTYPE", torch.float32)


def _fit_altered(monkeypatch):
    """One gradient entry (sigma's) of every evaluation negated."""
    from gp_ss_ak_torch.optim import api

    orig = api.make_value_and_grad

    def make(*a, **k):
        vg = orig(*a, **k)

        def altered(x):
            f, g = vg(x)
            g = np.array(g)
            g[6] = -g[6]
            return f, g
        return altered
    monkeypatch.setattr(api, "make_value_and_grad", make)


def _fit_frozen(monkeypatch):
    """The optimizer's iterate never moves: every iteration searches from
    the start again, and the best candidate it accepts is returned."""
    from gp_ss_ak_torch.optim import lbfgsb

    src = inspect.getsource(lbfgsb)
    old = ("            x, f, g = x_new, f_new, g_new\n"
           "            trace.append(f)\n"
           "            if f < best_f:\n"
           "                best_f, best_x = f, x.copy()\n")
    new = ("            trace.append(f_new)\n"
           "            if f_new < best_f:\n"
           "                best_f, best_x = f_new, x_new.copy()\n")
    assert src.count(old) == 1
    ns = {"__name__": lbfgsb.__name__}
    exec(compile(src.replace(old, new), lbfgsb.__file__, "exec"), ns)
    monkeypatch.setattr(lbfgsb.LBFGSB, "minimize", ns["LBFGSB"].minimize)


FAULTS = [_fit_float32, _fit_altered, _fit_frozen]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[5:] for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not run()["correct"]


def test_a_program_whose_fit_keeps_no_record_cannot_run_the_cell(
        monkeypatch):
    """The parent's fit (no `evals` in its timing) stops at the warm-up."""
    from gp_ss_ak_torch.optim import api

    orig = api.fit

    def fit(*a, timing=None, **k):
        out = orig(*a, timing=timing, **k)
        timing.pop("evals", None)
        return out
    monkeypatch.setattr(api, "fit", fit)
    monkeypatch.setattr("gp_ss_ak_torch.optim.fit", fit)
    with pytest.raises(RuntimeError, match="no record of its evaluations"):
        run()


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_size_on_the_card(card):
    """The control at the cell's own size (a short window), on the card."""
    result, _ = harness.run(CELL, 2147499001, 8.0, False,
                            time.perf_counter(), control=True)
    assert result["attempted"] >= 1 and not result["correct"]


# -- the cell's readers on made-up traces -----------------------------------

def traced_run(kernels, ranges, spans, t_close, config=None):
    """A traced run whose window's evaluations have the host `spans`
    (seconds), the card's `kernels` (name, start us, duration us) and the
    device time of each range (seconds)."""
    t = Traced.__new__(Traced)
    t.kernels, t.ranges = kernels, ranges
    rec = Record(0.0, t_close, [Item(a, b) for a, b in spans])
    return SimpleNamespace(trace=t, record=rec,
                           config=config or {"n": 16384, "d": 3})


def test_the_range_readers_give_device_time_per_evaluation():
    run = traced_run([], {"QuadLogdet.forward": 0.2,
                          "QuadLogdet.backward": 1.0,
                          "FusedExpansBiasA.backward": 0.15},
                     [(0, 1), (1, 2), (2, 3), (3, 4)], 3.5)
    # every evaluation the traced window ran, the one past the close too
    for name, want in (("ens_factor_ms", 50.0), ("ens_qw_ms", 250.0),
                       ("ens_gram_bwd_ms", 37.5)):
        assert manifest.reader(name)(run) == pytest.approx(want)
    run.trace.ranges = {}
    assert manifest.reader("ens_qw_ms")(run) is None


def test_the_optimizer_reader_takes_the_time_outside_the_evaluations():
    run = traced_run([], {}, [(0.001, 0.401), (0.403, 0.803),
                              (0.806, 1.206), (1.3, 1.7)], 1.5)
    # three completed: 1.206 s of window, 1.2 s inside evaluations
    got = manifest.reader("optimizer_host_ms")(run)
    assert got == pytest.approx(6e-3 * 1e3 / 3)


def test_the_k1_roofline_and_the_evaluations_share_of_the_peak():
    name = ("void (anonymous namespace)::gram_kernel<double>(double "
            "const*, double const*, double const*, double*, int, int, "
            "int, int)")
    kernels = [(name, 0.0, 1000.0), ("potrf", 2000.0, 500.0),
               (name, 400000.0, 1000.0)]
    run = traced_run(kernels, {}, [(0.0, 0.4), (0.4, 0.8)], 1.0)
    n = 16384
    nbytes = 8.0 * (n * n + 2 * n * 3)
    k1 = manifest.reader("k1_roofline.dense")(run)
    assert k1 == pytest.approx(100 * nbytes / 3.35e12 / 1e-3)
    assert 0 < k1 <= 100
    mfu = manifest.reader("dense_eval_mfu")(run)
    least = n ** 3 / 67e12 + 2 * nbytes / 3.35e12
    assert mfu == pytest.approx(100 * least / 0.4)
    assert 0 < mfu <= 100
    # no K1 launch, and an untraced run, read nothing
    assert manifest.reader("k1_roofline.dense")(
        traced_run(kernels[1:2], {}, [(0.0, 0.4)], 1.0)) is None
    for metric in ("k1_roofline.dense", "dense_eval_mfu"):
        assert manifest.reader(metric)(SimpleNamespace(trace=None)) is None
