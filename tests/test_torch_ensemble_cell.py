"""The batched fit's per-evaluation hook and its objective, on the CPU.

`fit_ensemble` (through `optim.api.minimize_batched` and
`batched_lbfgs.minimize`) takes a hook that sees every batched
evaluation and may end the fit. Here: its evaluations against the
benchmark's plain reference of independent exact GPs
(port_bench/reference/gp_ensemble.py) in float64; the hook seeing each
evaluation once; a stop returning the best so far; the objective's α
solve against torch.cholesky_solve; and the fit without
a hook, and with one that never stops it, bit for bit the code path
before the hook (a frozen copy of it below). Then the benchmark's
readers of the ens256-fit cell on made-up traces.

Tolerances: program and reference compute the same float64 quantities
by other routes (K1's plain version expands |x|^2, the reference takes
direct differences; QW adjoint against autograd of the Gram entries), so
values agree to rtol 1e-9 and gradients to 1e-7 of their largest entry.
"""

from types import SimpleNamespace
from typing import Callable

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from gp_ss_ak_torch.data import MODE_SYMMETRIC, prepare
from gp_ss_ak_torch.ensemble import fit_ensemble
from gp_ss_ak_torch.model import from_flat
from gp_ss_ak_torch.ops.chol import cho_solve, cholesky
from gp_ss_ak_torch.optim import batched_lbfgs
from gp_ss_ak_torch.optim.api import (DEFAULT_LOWER, DEFAULT_UPPER,
                                      batched_nlml_fn,
                                      batched_value_and_grad)
from port_bench import manifest, stage_idle, stages
from port_bench.reference import gp_ensemble as ref
from port_bench.trace import Traced

# one intra-op thread per process: the suite runs on several workers
torch.set_num_threads(1)

F64 = torch.float64
KERNELS = ["ExpAns", "Bias"]


def deposits(seed, B=4, n=64):
    """Raw composites of B deposits (a smooth grade in a 300 m cube with
    noise), the port's standardization of each, and random start
    hyperparameters inside the default box."""
    rng = np.random.default_rng(seed)
    raw = []
    for b in range(B):
        X = rng.uniform(0.0, 300.0, size=(n, 3))
        u = X / 150.0 - 1.0
        y = (1.0 + 0.5 * np.sin(1.5 * u[:, 0] + b) * np.cos(1.2 * u[:, 1])
             + 0.3 * u[:, 2] + 0.05 * rng.normal(size=n))
        raw.append((X, y))
    std = [prepare(X, y, MODE_SYMMETRIC) for X, y in raw]
    theta = np.concatenate([
        rng.uniform(0.3, 1.5, 6), rng.uniform(0.3, 1.0, 1), [0.6],
        rng.uniform(0.05, 0.3, 1), rng.uniform(0.01, 0.05, 1)])
    return (raw, np.stack([s[0] for s in std]),
            np.stack([s[1] for s in std]), theta)


def model(theta, dtype=F64):
    return from_flat(KERNELS, theta, theta[9:], 3, dtype, "cpu")


def recorder(stop_at=None):
    seen = []

    def hook(points, values, grads, mask):
        seen.append((points, values, grads, mask))
        return stop_at is not None and len(seen) >= stop_at
    return seen, hook


@pytest.mark.parametrize("seed", [11, 12])
def test_evaluations_match_the_plain_reference(seed):
    raw, Xb, yb, theta = deposits(seed)
    seen, hook = recorder()
    fit_ensemble(model(theta), Xb, yb, maxiter=4, hook=hook)
    checked = 0
    for points, values, grads, mask in seen[::3]:
        for b in np.flatnonzero(mask.numpy()):
            f, g = ref.evaluate(*raw[b], points[b].numpy(), ref.F64, "cpu")
            assert float(values[b]) == pytest.approx(f, rel=1e-9)
            np.testing.assert_allclose(grads[b].numpy(), g, rtol=0,
                                       atol=1e-7 * np.max(np.abs(g)))
            checked += 1
    assert checked >= 8


@pytest.mark.parametrize("batch", [(), (4,)])
def test_cho_solve_is_cholesky_solve(batch):
    """The objective's α solve (two triangular solves) against
    torch.cholesky_solve; a member whose factor failed (NaN) gives NaN
    alone."""
    g = torch.Generator().manual_seed(5)
    M = torch.randn(*batch, 64, 64, generator=g, dtype=torch.float64)
    A = M @ M.mT + 64 * torch.eye(64, dtype=torch.float64)
    b = torch.randn(*batch, 64, 1, generator=g, dtype=torch.float64)
    L = cholesky(A)
    want = torch.cholesky_solve(b, L)
    np.testing.assert_allclose(cho_solve(L, b), want, rtol=1e-12,
                               atol=1e-14)
    if batch:
        L[1] = float("nan")
        out = cho_solve(L, b)
        assert torch.isnan(out[1]).all()
        np.testing.assert_allclose(out[[0, 2, 3]], want[[0, 2, 3]],
                                   rtol=1e-12, atol=1e-14)


def test_the_hook_sees_each_evaluation_once():
    _, Xb, yb, theta = deposits(13)
    seen, hook = recorder()
    res = fit_ensemble(model(theta, torch.float32), Xb, yb, maxiter=5,
                       hook=hook)
    assert res.n_evals == len(seen) > 5
    B = len(Xb)
    for points, values, grads, mask in seen:
        assert points.shape == (B, 10) and grads.shape == (B, 10)
        assert values.shape == (B,) and mask.shape == (B,)
        assert points.dtype == values.dtype == grads.dtype == torch.float32
        assert mask.dtype == torch.bool
    assert bool(seen[0][3].all())
    # the evaluations are distinct calls, each seen once
    assert len({id(s[1]) for s in seen}) == len(seen)


def test_a_stop_request_returns_the_best_so_far():
    _, Xb, yb, theta = deposits(14)
    seen, hook = recorder(stop_at=9)
    res = fit_ensemble(model(theta), Xb, yb, maxiter=30, hook=hook)
    assert res.n_evals == len(seen) == 9
    assert not bool(res.converged.any())
    # every used value below the iterate's is accepted, so the best so
    # far is the least of the start and every used finite value
    for b in range(len(Xb)):
        cands = [(float(v[b]), p[b]) for p, v, _, m in seen
                 if bool(m[b]) and bool(torch.isfinite(v[b]))]
        f0 = float(seen[0][1][b])
        best_f, best_x = min(cands + [(f0, seen[0][0][b])],
                             key=lambda c: c[0])
        assert float(res.fun[b]) == best_f
        assert torch.equal(res.flat[b], best_x)
        assert best_f <= f0


def _parent_problem():
    _, Xb, yb, theta = deposits(15, B=3, n=32)
    vg = batched_value_and_grad(batched_nlml_fn(model(theta)),
                                torch.as_tensor(Xb), torch.as_tensor(yb))
    x0 = torch.as_tensor(theta).expand(3, 10)
    lb = torch.full((10,), DEFAULT_LOWER, dtype=F64)
    ub = torch.full((10,), DEFAULT_UPPER, dtype=F64)
    return vg, x0, lb, ub, (theta, Xb, yb)


@pytest.mark.parametrize("how", ["minimize", "fit_ensemble"])
def test_without_a_hook_the_fit_is_the_code_path_before_it(how):
    vg, x0, lb, ub, (theta, Xb, yb) = _parent_problem()
    want = _parent_minimize(vg, x0, lb, ub, maxiter=12)
    if how == "minimize":
        runs = [batched_lbfgs.minimize(vg, x0, lb, ub, maxiter=12),
                batched_lbfgs.minimize(vg, x0, lb, ub, maxiter=12,
                                       hook=lambda *_: False)]
        got = [(r.x, r.fun, r.n_iters, r.converged, r.n_evals)
               for r in runs]
    else:
        runs = [fit_ensemble(model(theta), Xb, yb, maxiter=12),
                fit_ensemble(model(theta), Xb, yb, maxiter=12,
                             hook=lambda *_: False)]
        got = [(r.flat, r.fun, r.n_iters, r.converged, r.n_evals)
               for r in runs]
    for x, fun, n_iters, converged, n_evals in got:
        assert torch.equal(x, want.x) and torch.equal(fun, want.fun)
        assert torch.equal(n_iters, want.n_iters)
        assert torch.equal(converged, want.converged)
        assert n_evals == want.n_evals


def _parent_minimize(value_and_grad: Callable, x0: torch.Tensor,
                     lower: torch.Tensor, upper: torch.Tensor,
                     maxiter: int = 100, memory: int = 6,
                     gtol: float = 1e-6, ftol: float = 1e-9,
                     max_backtracks: int = 20
                     ) -> batched_lbfgs.BatchedOptResult:
    """batched_lbfgs.minimize as it was before the hook and the ranges.
    The first change to the optimizer's arithmetic that is meant (the
    lock-step loop's rewrite, ROADMAP (h)) deletes this copy and the
    test that holds the optimizer to it."""
    B, p = x0.shape
    x = torch.clamp(x0, lower, upper)
    f, g = value_and_grad(x)
    n_evals = 1
    S = x.new_zeros((B, memory, p))
    Y = x.new_zeros((B, memory, p))
    valid = torch.zeros((B, memory), dtype=torch.bool, device=x.device)
    best_x, best_f = x, f
    it = torch.zeros(B, dtype=torch.long, device=x.device)
    done = torch.zeros(B, dtype=torch.bool, device=x.device)
    min_t = 2.0 ** (-max_backtracks)

    while True:
        active = (it < maxiter) & ~done
        if not bool(active.any()):
            break
        pg = x - torch.clamp(x - g, lower, upper)
        kkt = torch.amax(torch.abs(pg), dim=-1) < gtol

        d = -batched_lbfgs._two_loop(g, S, Y, valid)
        at_lo = x <= lower + 1e-12
        at_hi = x >= upper - 1e-12
        bad = (at_lo & (d < 0)) | (at_hi & (d > 0))
        d = torch.where(bad, -g, d)
        d = torch.where((at_lo & (g > 0)) | (at_hi & (g < 0)), 0.0, d)
        descent = torch.sum(d * g, dim=-1) < 0
        d = torch.where(descent[:, None], d, -g)

        # the line search: members still searching are those active and
        # not yet accepted with t above its floor
        t = torch.ones(B, dtype=x.dtype, device=x.device)
        accepted = torch.zeros(B, dtype=torch.bool, device=x.device)
        searching = active
        x_new, f_new, g_new = x, f, g
        while True:
            cand = torch.where(searching[:, None],
                               torch.clamp(x + t[:, None] * d, lower, upper),
                               x)
            fc, gc = value_and_grad(cand)
            n_evals += 1
            ok = searching & torch.isfinite(fc) & (fc < f)
            x_new = torch.where(ok[:, None], cand, x_new)
            f_new = torch.where(ok, fc, f_new)
            g_new = torch.where(ok[:, None], gc, g_new)
            accepted = accepted | ok
            t = torch.where(searching, t * 0.5, t)
            searching = searching & ~accepted & (t > min_t)
            if not bool(searching.any()):
                break

        s = x_new - x
        yv = g_new - g
        sy = torch.sum(s * yv, dim=-1)
        good = active & accepted & (
            sy > 1e-10 * torch.linalg.vector_norm(s, dim=-1)
            * torch.linalg.vector_norm(yv, dim=-1))
        S = batched_lbfgs._push(S, s, good)
        Y = batched_lbfgs._push(Y, yv, good)
        valid = batched_lbfgs._push(valid, torch.ones_like(good), good)
        improved = active & (f_new < best_f)
        best_x = torch.where(improved[:, None], x_new, best_x)
        best_f = torch.where(improved, f_new, best_f)
        small_change = accepted & (torch.abs(f - f_new)
                                   <= ftol * (1.0 + torch.abs(f_new)))
        stop = kkt | ~accepted | small_change
        x = torch.where(active[:, None], x_new, x)
        f = torch.where(active, f_new, f)
        g = torch.where(active[:, None], g_new, g)
        done = torch.where(active, stop, done)
        it = it + active.long()
    return batched_lbfgs.BatchedOptResult(best_x, best_f, it, done, n_evals)


# -- the cell's readers on made-up traces -----------------------------------

CPU, GPU = DeviceType.CPU, DeviceType.CUDA


class Ev:
    """A profiler event as `kineto_results.events()` gives it (times in
    us here, ns there)."""

    def __init__(self, name, dev, start_us, dur_us, ann=False):
        self._n, self._d, self._a = name, dev, ann
        self._s, self._u = int(start_us * 1000), int(dur_us * 1000)

    def correlation_id(self):
        return 0

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def is_user_annotation(self):
        return self._a


def traced_run(events, items, config=None, info=None):
    t = Traced()
    t._summarize(events)
    t._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    its = [SimpleNamespace(info=dict(info or {})) for _ in range(items)]
    rec = SimpleNamespace(items=its, completed=lambda: its)
    return SimpleNamespace(trace=t, record=rec, config=config or {})


def test_idle_goes_to_the_batched_fits_innermost_range():
    events = [Ev("ensemble.evaluate", CPU, 0, 60, ann=True),
              Ev("QuadLogdet.forward", CPU, 10, 20, ann=True),   # 10-30
              Ev("batched_lbfgs.line_search", CPU, 60, 20, ann=True),
              Ev("batched_lbfgs.update", CPU, 85, 10, ann=True),  # 85-95
              Ev("aten::mm", CPU, 40, 5),
              Ev("k", GPU, 0, 5), Ev("k", GPU, 30, 20), Ev("k", GPU, 95, 5)]
    run = traced_run(events, items=2)
    got = stage_idle.idle_by_range(*stages.read(events))
    # idle 5-30, 50-95: 60-80 in the line search, 85-95 the update; the
    # evaluation's ranges are not the L-BFGS's, so 5-30, 50-60 and 80-85
    # go outside
    assert got == {"batched_lbfgs.line_search": pytest.approx(20e-6),
                   "batched_lbfgs.update": pytest.approx(10e-6),
                   stages.OUTSIDE: pytest.approx(40e-6)}
    # stages.py's own list leaves these ranges out: all of it outside
    assert stages.idle_by_range(*stages.read(events)) == {
        stages.OUTSIDE: pytest.approx(70e-6)}
    read = manifest.reader("idle_ms.lbfgs")
    assert read(run) == pytest.approx(30e-3 / 2)


def test_k1_roofline_reads_the_batched_gram_kernel():
    config = {"deposits": 256, "n": 1024, "d": 3}
    name = ("void (anonymous namespace)::gram_kernel<double>(double "
            "const*, double const*, double const*, double*, int, int, "
            "int, int)")
    events = [Ev("ensemble.evaluate", CPU, 0, 5000, ann=True),
              Ev(name, GPU, 0, 1200), Ev(name, GPU, 2000, 1200),
              Ev("potrf", GPU, 3500, 500)]
    read = manifest.reader("k1_roofline.ens")
    got = read(traced_run(events, items=2, config=config))
    nbytes = 256 * 4.0 * (1024 * 1024 + 2048 * 3)     # float32 entries
    assert got == pytest.approx(100 * 2 * nbytes / 3.35e12 / 1.2e-3)
    assert 0 < got <= 100
    # a window with no K1 launch, and an untraced run, read nothing
    assert read(traced_run(events[3:], 2, config)) is None
    assert read(SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("metric,range_name", [
    ("ens_factor_ms", "QuadLogdet.forward"),
    ("ens_qw_ms", "QuadLogdet.backward"),
    ("ens_gram_bwd_ms", "FusedExpansBiasA.backward")])
def test_range_readers_give_device_time_per_evaluation(metric, range_name):
    events = [Ev(range_name, GPU, 0, 100, ann=True),
              Ev(range_name, GPU, 200, 100, ann=True),
              Ev("k", GPU, 10, 30), Ev("k", GPU, 220, 50),
              Ev("k", GPU, 150, 40)]                  # outside the range
    read = manifest.reader(metric)
    assert read(traced_run(events, items=4)) == pytest.approx(80e-3 / 4)
    assert read(traced_run(events[2:], items=4)) is None


def test_the_active_share_is_the_mean_used_share():
    run = traced_run([Ev("k", GPU, 0, 1)], items=3,
                     info={"used_pct": 25.0})
    run.record.items[0].info["used_pct"] = 100.0
    assert manifest.reader("ens_active_share")(run) == pytest.approx(50.0)
