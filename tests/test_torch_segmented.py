"""Port parity: the segmented matrix-free evaluator (optim/segmented.py:
the fused stream evaluator with a warm start, under the JAX segmented
evaluator's defaults) and its routes through `fit` and the CLI's
`train --segmented`.

The JAX side runs as its own tests run it (tests/test_iterative.py
TestSegmented): float32, its Pallas kernels in interpret mode with
tm = tn = 128, here at n = 256. Both packages take the same probe
matrices: drawn with `jax.random.rademacher` from the JAX function's
keys and handed to the port (Z_logdet=, Z_trace=).

Tolerances:
  * P^(+1/2) (inference.iterative.precond_sqrt_fwd_apply) in float64:
    1e-12 against JAX's and as the inverse of P^(-1/2);
  * against the JAX package: the stream cases of
    tests/test_torch_iterative_train.py (two float32 implementations of
    one estimator that sum in other orders): CG iterations within 1,
    value rel 1e-4 (abs 0.05), gradient rtol 1e-3 with atol 1e-3 of its
    largest entry;
  * against the port's fused stream evaluator with the same options,
    cold and warm: bit for bit, with equal iterations (the same ops on
    the same operator);
  * warm against cold (tests/test_iterative.py:743-775): fewer
    iterations, value rel 1e-4, gradient rtol 2e-3 / atol 1e-4.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.optim.segmented import (
    make_segmented_value_and_grad as j_seg,
)
from gp_ss_ak_torch.inference import WarpedGaussian
from gp_ss_ak_torch.ops.matvec import MatvecOperator
from gp_ss_ak_torch.optim import fit
from gp_ss_ak_torch.optim.iterative_fit import (
    make_iterative_value_and_grad as t_fused,
)
from gp_ss_ak_torch.optim.segmented import (
    make_segmented_value_and_grad as t_seg,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 256
# cg_tol 1e-4: at 1e-5 the float32 whitened residual of both packages
# creeps along its floor there, and the iteration at which it first dips
# below the tolerance differs by up to 3 (23 against 26 at this case)
OPTS = dict(seed=0, probes=4, lanczos_iters=10, cg_tol=1e-4, slq_probes=8,
            chunk=128)


def case(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3))
    y = np.sin(X @ np.array([1.0, 2.0, 3.0])) + 0.05 * rng.normal(size=n)
    return X, y


def probes(n=N, opts=OPTS):
    """The probe matrices the JAX evaluator draws from its seed."""
    k_ld, k_tr = jax.random.split(jax.random.PRNGKey(opts["seed"]))
    return (np.array(jax.random.rademacher(k_ld, (n, opts["slq_probes"]),
                                             jnp.float32)),
            np.array(jax.random.rademacher(k_tr, (n, opts["probes"]),
                                             jnp.float32)))


def model():
    return tm.default_model(3, dtype=torch.float32, device=CPU)


def start():
    return model().pack().numpy().astype(np.float64)


def grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


def test_precond_sqrt_fwd_apply_inverts_and_matches_jax():
    """P^(+1/2) on JAX's pieces of P = L L^T + sn2 I, float64, a rank
    with one null column (the mask's sqrt(sn2) branch): it undoes
    P^(-1/2) to 1e-12 and equals JAX's function to 1e-12 of the largest
    entry, on a vector and on a block."""
    from gp_ss_ak_tpu.inference import iterative as ji
    from gp_ss_ak_torch.inference import iterative as ti

    rng = np.random.default_rng(8)
    L = rng.normal(size=(40, 6))
    L[:, 3] = 0.0
    sn2 = 0.05
    Q, ise, _ = ji.precond_sqrt_pieces(jnp.asarray(L), sn2)
    assert int(np.sum(np.asarray(ise) == 0.0)) == 1      # the null column
    Qt, iset = torch.tensor(np.asarray(Q)), torch.tensor(np.asarray(ise))
    for v in (rng.normal(size=40), rng.normal(size=(40, 3))):
        vt = torch.tensor(v)
        got = ti.precond_sqrt_fwd_apply(Qt, iset, sn2, vt).numpy()
        want = np.asarray(ji.precond_sqrt_fwd_apply(Q, ise, sn2,
                                                    jnp.asarray(v)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
        back = ti.precond_sqrt_fwd_apply(
            Qt, iset, sn2, ti.precond_sqrt_apply(Qt, iset, sn2, vt))
        np.testing.assert_allclose(back.numpy(), v, rtol=0, atol=1e-12)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_matches_jax_over_a_sequence(warm):
    X, y = case()
    Zl, Zt = probes()
    vg_j = j_seg(jm.default_model(3, dtype=jnp.float32), X, y, tm=128,
                 tn=128, seg_iters=7, warm_start=warm, **OPTS)
    vg_t = t_seg(model(), X, y, warm_start=warm, Z_logdet=Zl, Z_trace=Zt,
                 **OPTS)
    x = start()
    for xi in (x, x * (1.0 + 1e-3)):
        vj, gj = vg_j(xi)
        vt, gt = vg_t(xi)
        assert abs(vg_t.last_cg_iters - vg_j.last_cg_iters) <= 1
        assert vt == pytest.approx(vj, rel=1e-4, abs=0.05)
        grad_close(gt, gj)
        assert 0.0 <= vg_t.last_rel_residual <= OPTS["cg_tol"] * 1.05
    assert vg_t.precond_rank == vg_j.precond_rank > 0
    assert gt.dtype == np.float64 and gt.shape == (10,)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_matches_fused_stream_bit_for_bit(warm):
    """The segmented route is the fused stream evaluator, cold or warm,
    with the same probes drawn from the seed."""
    X, y = case(seed=1)
    kw = dict(OPTS, cg_tol=1e-3)
    fused = t_fused(model(), X, y, mode="stream", warm_start=warm, **kw)
    seg = t_seg(model(), X, y, warm_start=warm, **kw)
    for xi in (start(), start() * 1.05):
        vf, gf = fused(xi)
        vs, gs = seg(xi)
        assert vs == vf
        assert np.array_equal(gs, gf)
        assert seg.last_cg_iters == fused.last_cg_iters > 7
        assert seg.last_rel_residual == fused.last_rel_residual


def test_warm_start_fewer_iterations_same_answer(monkeypatch):
    """Warm-started evaluations converge in fewer CG iterations to the
    cold answer; each evaluation makes CG iterations + Lanczos steps
    operator passes, plus one for a warm start's true residual."""
    X, y = case(n=240, seed=2)
    opts = dict(OPTS, cg_tol=1e-5)
    passes = []
    matmat = MatvecOperator.matmat

    def counted(self, V):
        passes.append(V.shape[1])
        return matmat(self, V)

    monkeypatch.setattr(MatvecOperator, "matmat", counted)
    x = start()
    out = {}
    for warm in (False, True):
        vg = t_seg(model(), X, y, warm_start=warm, **opts)
        runs = []
        for xi in (x, x * (1.0 + 1e-3)):
            del passes[:]
            v, g = vg(xi)
            k = vg.last_cg_iters
            want = [1 + OPTS["probes"]] * (k + (warm and xi is not x)) \
                + [OPTS["slq_probes"]] * OPTS["lanczos_iters"]
            assert passes == want
            runs.append((v, g, k, vg.last_rel_residual))
        out[warm] = runs
    (v1c, _, k1c, _), (v2c, g2c, k2c, _) = out[False]
    (v1w, _, k1w, _), (v2w, g2w, k2w, rel2w) = out[True]
    assert v1w == v1c and k1w == k1c            # the first: cold in both
    assert k2w < k2c
    assert rel2w <= opts["cg_tol"] * 1.05
    assert v2w == pytest.approx(v2c, rel=1e-4)
    np.testing.assert_allclose(g2w, g2c, rtol=2e-3, atol=1e-4)


def test_non_finite_warm_start_starts_cold():
    """An evaluation whose preconditioner fails (sn2 < 0: P^(-1/2) is
    NaN) returns NaN and NaN solutions. JAX warm-starts the next
    evaluation from them and stays NaN; the port starts it cold."""
    X, y = case(seed=3)
    Zl, Zt = probes()
    x = start()
    bad = x.copy()
    bad[-1] = -1.0
    vg_j = j_seg(jm.default_model(3, dtype=jnp.float32), X, y, tm=128,
                 tn=128, **OPTS)
    assert np.isnan(vg_j(bad)[0])
    assert np.isnan(vg_j(x)[0])
    vg_t = t_seg(model(), X, y, Z_logdet=Zl, Z_trace=Zt, **OPTS)
    v_bad, g_bad = vg_t(bad)
    assert np.isnan(v_bad) and np.isnan(g_bad).any()
    assert not bool(torch.isfinite(vg_t.prev_sols).any())
    cold = t_seg(model(), X, y, Z_logdet=Zl, Z_trace=Zt, warm_start=False,
                 **OPTS)
    v, g = vg_t(x)
    vc, gc = cold(x)
    assert v == vc and np.array_equal(g, gc)
    assert vg_t.last_cg_iters == cold.last_cg_iters


def test_fit_routes_segmented(tmp_path):
    """fit(engine="iterative", engine_opts={"segmented": True}) drives
    the segmented evaluator end to end; timing records its CG per
    evaluation and a checkpoint is written."""
    X, y = case(n=200, seed=4)
    timing = {}
    ck = str(tmp_path / "ck")
    fitted, res = fit(model(), X, y, engine="iterative", iters=4,
                      engine_opts=dict(segmented=True),
                      timing=timing, checkpoint_path=ck, checkpoint_every=1)
    assert np.isfinite(res.fun) and res.trace[-1] <= res.trace[0]
    assert len(timing["cg"]) == res.n_evals == timing["n_evals"]
    assert all(k > 0 and 0 <= r <= 1e-3 * 1.05 for k, r in timing["cg"])
    assert np.load(ck + ".npz")["x"].shape == (10,)
    assert np.all(np.isfinite(fitted.pack().numpy()))


def test_segmented_on_a_dense_engine_warns_and_runs_dense():
    X, y = case(n=64, seed=5)
    with pytest.warns(UserWarning, match="segmented=True is only honoured"):
        _, res = fit(model(), X, y, engine="dense", iters=2,
                     engine_opts={"segmented": True})
    dense = fit(model(), X, y, engine="dense", iters=2)[1]
    assert res.fun == dense.fun


@pytest.mark.parametrize("what", ["gemm", "warped", "rank0", "tile",
                                  "seg_iters"])
def test_refusals(what):
    X, y = case(n=32, seed=6)
    if what == "gemm":
        with pytest.raises(ValueError, match="stream-only"):
            fit(model(), X, y, engine="iterative", iters=1,
                engine_opts={"segmented": True, "mode": "gemm"})
        return
    if what == "warped":
        from dataclasses import replace

        lik = WarpedGaussian(family="tanh1", n_triplets=1)
        warped = replace(model(), likelihood=lik,
                         lik_hypers=lik.default_hypers(torch.float32, CPU))
        with pytest.raises(ValueError, match="plain Gaussian likelihood"):
            fit(warped, X, y, engine="iterative", iters=1,
                engine_opts={"segmented": True})
        return
    if what == "rank0":
        with pytest.raises(ValueError, match="precond_rank > 0"):
            t_seg(model(), X, y, precond_rank=0)
        return
    # the JAX function's tile sizes and segment length have no
    # counterpart here
    with pytest.raises(TypeError):
        t_seg(model(), X, y, **{"tm" if what == "tile" else what: 128})


def test_evaluation_is_split_by_profiler_ranges():
    """An evaluation carries the fused evaluator's ranges: the pivoted
    Cholesky, the whitened solve and the SLQ, by which a trace of the
    card splits its device time."""
    from torch.profiler import ProfilerActivity, profile

    X, y = case(n=96, seed=7)
    vg = t_seg(model(), X, y, **OPTS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            vg(start())
    names = {e.name for e in prof.events()}
    assert {"iterative_fit.value_and_grad", "iterative._pivchol",
            "iterative.whitened_solve_info",
            "iterative.slq_logdet_batched"} <= names


@pytest.fixture(scope="module")
def profiled_evaluations():
    """A cold and a warm evaluation of the segmented evaluator, each
    under its own CPU profile."""
    from torch.profiler import ProfilerActivity, profile

    X, y = case(n=96, seed=7)
    vg = t_seg(model(), X, y, **OPTS)
    profs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for x in (start(), start() * 1.05):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                vg(x)
            profs.append(prof)
    return profs


PROGRAM_RANGES = ("iterative.", "iterative_fit.")


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("child,parent", [
    ("iterative.precond_sqrt_pieces", "iterative.whitened_solve_info"),
    ("iterative_fit.chain_rule", "iterative_fit.value_and_grad"),
])
def test_evaluation_stage_ranges_nest(profiled_evaluations, warm, child,
                                      parent):
    """The whitening's pieces sit inside the whitened solve and the chain
    rule inside the evaluation, on the calling thread; no range sits in
    a per-step loop, so an evaluation opens 7 program ranges."""
    events = profiled_evaluations[warm].events()
    (c,) = [e for e in events if e.name == child]
    (p,) = [e for e in events if e.name == parent]
    assert c.thread == p.thread
    assert p.time_range.start <= c.time_range.start
    assert c.time_range.end <= p.time_range.end
    assert len([e for e in events
                if e.name.startswith(PROGRAM_RANGES)]) == 7
