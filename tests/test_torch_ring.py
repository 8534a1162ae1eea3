"""Port parity: the ring's matrix-free mesh engine (parallel/ring.py:
the ring NLML and gradient, its matvec, CG, predict and posterior mean,
the pivoted Cholesky, fit_ring, the two-level ring).

The port runs as torch ranks over gloo on the CPU at world sizes 1, 2
and 4 (tests/torch_mesh_worker.py, one launch for all three sizes, with
a time limit); the JAX package on a mesh of the same size over the CPU devices
tests/conftest.py forces, and both take JAX's probes (the port is handed
the matrices JAX draws). Float64, 37 training points.

Tolerances: value and gradient rtol 1e-8 (of the largest gradient entry)
at a converged CG (tol 1e-10), with equal CG iteration counts; two ranks
against four rtol 1e-10; chunked tiles against whole ones 1e-11 (another
summation order); predict rtol 1e-8. JAX's matvec, CG and posterior mean
build their tiles without the exact diagonal (sqrt(round-off) of distance
left there, ~1e-8 of K), the port with it: those are held to the JAX
package's dense references at 1e-8 (the matvec 1e-12) and to JAX's ring
functions at 1e-7 (matvec) and 1e-5 (the solves, which amplify it), with
CG iteration counts within one. The two pivoted-Cholesky builds 1e-12;
fit_ring's x rtol 1e-6 after two iterations.

A solve cut short (two ranks): CG stopped after 3 iterations is
"unconverged" and keeps JAX's value and gradient (rtol 1e-8, the
converged case's) and fit_ring's steps (x rtol 1e-6, the same stop
reason), warning once per fit and once per predict; stopped after none
it is "failed", and the port's value, gradient and predict are NaN
where JAX's stay finite (the witness of the deliberate difference).
"""

import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import gp_ss_ak_tpu.model as jm
from gp_ss_ak_tpu import parallel as jp
from gp_ss_ak_tpu.inference import predict
from gp_ss_ak_tpu.parallel.mesh import pad_rows

from torch_mesh_worker import collect, start

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
NB = 4
N, D = 37, 3
OPTS = dict(precond_rank=8, probes=4, slq_probes=4, lanczos_iters=8,
            cg_tol=1e-10, cg_maxiter=500)


def _probes(n_pad):
    """JAX's two probe draws of the ring NLML at seed 0 over n_pad rows,
    cut to the true rows (ring.py:668-696)."""
    k_tr, k_ld = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.rademacher(
                k_tr, (n_pad, OPTS["probes"]), jnp.float64))[:N],
            np.asarray(jax.random.rademacher(
                k_ld, (n_pad, OPTS["slq_probes"]), jnp.float64))[:N])


def _inputs(world):
    rng = np.random.default_rng(8)
    X = rng.normal(size=(N, D))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=N)
    m = jm.default_model(D, dtype=jnp.float64)
    flat = np.asarray(m.pack()) * rng.uniform(0.8, 1.2, size=m.n_params)
    data = dict(suite="ring", nb=NB, X=X, y=y, flat=flat,
                Xq=rng.normal(size=(7, D)), v=rng.normal(size=N))
    data["Z"], data["Zl"] = _probes(pad_rows(N, world, NB))
    # fit_ring's mesh is NB-padded too; the two-level rows are 2 ranks
    data["Zfit"], data["Zlfit"] = data["Z"], data["Zl"]
    data["Z2"], data["Zl2"] = _probes(pad_rows(N, 2, NB))
    data["flats2"] = np.stack([flat, np.clip(flat * 1.25, 1e-4, 6.0)])
    return data


def _jax_side(world, data):
    mesh = jp.make_mesh(world)
    X, y = data["X"], data["y"]
    Xs, ys, n, _ = jp.shard_training_data(mesh, X, y, nb=NB)
    model = jm.default_model(D, dtype=jnp.float64).unpack(
        jnp.asarray(data["flat"]))
    k, flat = model.kernel, model.pack()
    Xq = jnp.asarray(data["Xq"])
    out = {}
    v, g, st = jp.make_ring_nlml_and_grad(k, mesh, n=n, with_stats=True,
                                          **OPTS)(flat, Xs, ys)
    out["ring_v"], out["ring_g"], out["ring_stats"] = (
        float(v), np.asarray(g), np.asarray(st))
    vs = jax.device_put(jnp.asarray(np.pad(data["v"], (0, Xs.shape[0] - N))),
                        NamedSharding(mesh, P(jp.ROW_AXIS)))
    out["matvec"] = np.asarray(jp.make_ring_matvec(k, mesh, n=n)(flat, Xs,
                                                                 vs))[:N]
    x, it, _ = jp.make_ring_cg_solve(k, mesh, n=n, tol=1e-10)(flat, Xs, ys)
    out["cg_x"], out["cg_it"] = np.asarray(x)[:N], int(it)
    mu, it, _ = jp.make_ring_posterior_mean(k, mesh, n=n, tol=1e-10)(
        flat, Xs, ys, Xq)
    out["pmean_mu"], out["pmean_it"] = np.asarray(mu), int(it)
    mu, var = jp.make_ring_predict(k, mesh, n=n, tol=1e-10,
                                   precond_rank=8)(flat, Xs, ys, Xq)
    out["rpred_mu"], out["rpred_var"] = np.asarray(mu), np.asarray(var)
    _, res = jp.fit_ring(model, X, y, mesh, nb=NB, iters=2, precond_rank=8,
                         probes=4, slq_probes=4, lanczos_iters=8,
                         cg_tol=1e-10)
    out["fit_x"], out["fit_iters"] = np.asarray(res.x), res.n_iters
    if world == 2:
        for key, maxiter in (("short", 3), ("failed", 0)):
            v, g, st = jp.make_ring_nlml_and_grad(
                k, mesh, n=n, with_stats=True,
                **{**OPTS, "cg_maxiter": maxiter})(flat, Xs, ys)
            out[key + "_v"], out[key + "_g"], out[key + "_stats"] = (
                float(v), np.asarray(g), np.asarray(st))
        _, res = jp.fit_ring(model, X, y, mesh, nb=NB, iters=2,
                             precond_rank=8, probes=4, slq_probes=4,
                             lanczos_iters=8, cg_tol=1e-10, cg_maxiter=3)
        out["short_fit_x"], out["short_fit_stop"] = (np.asarray(res.x),
                                                     res.stop_reason)
    if world == 4:
        mesh2 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                     ("chains", jp.ROW_AXIS))
        n_pad = pad_rows(N, 2, NB)
        Xp, yp = np.zeros((n_pad, D)), np.zeros(n_pad)
        Xp[:N], yp[:N] = X, y
        f2 = jp.make_two_level_ring_nlml_and_grad(k, mesh2, n=N, **OPTS)
        v, g = f2(jax.device_put(jnp.asarray(data["flats2"]),
                                 NamedSharding(mesh2, P("chains", None))),
                  jax.device_put(jnp.asarray(Xp),
                                 NamedSharding(mesh2, P(jp.ROW_AXIS, None))),
                  jax.device_put(jnp.asarray(yp),
                                 NamedSharding(mesh2, P(jp.ROW_AXIS))))
        out["two_v"], out["two_g"] = np.asarray(v), np.asarray(g)
    return out


def _jax_dense(data):
    """The JAX package's dense references, the same at every mesh size:
    A with its exact diagonal (same=True), its matvec and solve, and the
    dense predict."""
    X, y = data["X"], data["y"]
    model = jm.default_model(D, dtype=jnp.float64).unpack(
        jnp.asarray(data["flat"]))
    k = model.kernel
    A = np.asarray(k.matrix(model.kernel_params, jnp.asarray(X),
                            jnp.asarray(X), same=True)) \
        + float(model.lik_hypers[0]) * np.eye(N)
    mu, var = predict(k, model.kernel_params, model.lik_hypers,
                      jnp.asarray(X), jnp.asarray(y),
                      jnp.asarray(data["Xq"]), model.likelihood)
    return dict(matvec_dense=A @ data["v"], cg_dense=np.linalg.solve(A, y),
                mu_dense=np.asarray(mu), var_dense=np.asarray(var))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (inputs, the JAX side, the ranks' results)}; every world
    size's ranks run while the JAX side is computed here."""
    inputs = {w: _inputs(w) for w in WORLDS}
    handle = start(inputs, str(tmp_path_factory.mktemp("ranks")))
    try:
        # one thread a mesh size: XLA compiles without the interpreter lock
        with ThreadPoolExecutor(len(WORLDS)) as pool:
            dense = pool.submit(_jax_dense, inputs[WORLDS[0]])
            jax_out = dict(zip(WORLDS, pool.map(
                lambda w: _jax_side(w, inputs[w]), WORLDS)))
            dense = dense.result()
    finally:
        ranks = collect(handle)
    return {w: (inputs[w], {**jax_out[w], **dense}, ranks[w])
            for w in WORLDS}


def _close(got, want, rtol):
    """Equal within rtol of the largest entry of `want`."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.max(np.abs(want)))


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks])[:N]


@pytest.mark.parametrize("world", WORLDS)
def test_ring_value_gradient_and_stats_match_jax(runs, world):
    _, jx, ranks = runs[world]
    for r in ranks:
        assert float(r["ring_v"]) == pytest.approx(jx["ring_v"], rel=1e-8)
        _close(r["ring_g"], jx["ring_g"], 1e-8)
        # with_stats: the same CG iteration count, both converged
        assert r["ring_stats"][0] == jx["ring_stats"][0]
        assert r["ring_stats"][1] < 1e-9 and jx["ring_stats"][1] < 1e-9


@pytest.mark.parametrize("world", WORLDS)
def test_chunked_and_prime_tiles_match_whole_ones(runs, world):
    _, _, ranks = runs[world]
    r = ranks[0]
    # a different summation order (2.3e-12 seen at four ranks)
    assert float(r["chunked_v"]) == pytest.approx(float(r["ring_v"]),
                                                  rel=1e-11)
    _close(r["chunked_g"], r["ring_g"], 1e-10)
    # one padding row at most: n_local 37 and 19 at one and two ranks,
    # prime, in chunks of 4 with a shorter last one
    assert int(r["prime_nlocal"]) == {1: 37, 2: 19, 4: 10}[world]
    assert float(r["prime_v"]) == pytest.approx(float(r["ring_v"]),
                                                rel=1e-10)
    _close(r["prime_g"], r["ring_g"], 1e-8)


def test_ring_value_two_ranks_against_four(runs):
    v2, v4 = (float(runs[w][2][0]["ring_v"]) for w in (2, 4))
    assert v4 == pytest.approx(v2, rel=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_solves_and_predictions_match_jax(runs, world):
    _, jx, ranks = runs[world]
    # every port tile has the exact diagonal: against the dense
    # references at 1e-8, against JAX's matvec-CG tiles (sqrt(round-off)
    # of distance on their diagonal) at 1e-5
    _close(_rows(ranks, "matvec"), jx["matvec_dense"], 1e-12)
    _close(_rows(ranks, "matvec"), jx["matvec"], 1e-7)
    _close(_rows(ranks, "cg_x"), jx["cg_dense"], 1e-8)
    _close(_rows(ranks, "cg_x"), jx["cg_x"], 1e-5)
    for r in ranks:
        assert abs(int(r["cg_it"]) - jx["cg_it"]) <= 1
        assert abs(int(r["pmean_it"]) - jx["pmean_it"]) <= 1
        _close(r["pmean_mu"], jx["mu_dense"], 1e-8)
        _close(r["pmean_mu"], jx["pmean_mu"], 1e-5)
        # predict's tiles are exact in both packages
        _close(r["rpred_mu"], jx["rpred_mu"], 1e-8)
        _close(r["rpred_var"], jx["rpred_var"], 1e-8)
        _close(r["rpred_mu"], jx["mu_dense"], 1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_pivoted_cholesky_builds_agree(runs, world):
    _, _, ranks = runs[world]
    np.testing.assert_allclose(_rows(ranks, "pc_dist"),
                               _rows(ranks, "pc_gathered"), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_fit_ring_matches_jax(runs, world):
    _, jx, ranks = runs[world]
    for r in ranks:
        np.testing.assert_allclose(r["fit_x"], jx["fit_x"], rtol=1e-6)
        assert int(r["fit_iters"]) == jx["fit_iters"]


def test_two_level_ring_matches_jax(runs):
    _, jx, ranks = runs[4]
    for r in ranks:
        np.testing.assert_allclose(r["two_v"], jx["two_v"], rtol=1e-8)
        for c in range(2):
            _close(r["two_g"][c], jx["two_g"][c], 1e-8)


def test_ring_solve_cut_short_is_flagged_or_nan(runs):
    _, jx, ranks = runs[2]
    for r in ranks:
        # unconverged: JAX's value and gradient, its residual above tol
        assert int(r["short_stats"][0]) == int(jx["short_stats"][0]) == 3
        assert 1e-10 < r["short_stats"][1] < 1
        assert float(r["short_v"]) == pytest.approx(jx["short_v"], rel=1e-8)
        _close(r["short_g"], jx["short_g"], 1e-8)
        # failed: NaN in the port, finite in JAX
        assert np.isnan(r["failed_v"]) and np.isnan(r["failed_g"]).all()
        assert np.isfinite(jx["failed_v"])
        assert np.isfinite(jx["failed_g"]).all()
        assert float(r["failed_stats"][1]) == 1.0
        # the evaluations return their residuals and do not warn; the
        # predict warns for its unconverged solve and is NaN for its
        # failed one; the fit warns once, naming its count
        assert int(r["warn_evals"]) == 0
        assert np.isfinite(r["short_rpred_mu"]).all()
        assert np.isnan(r["failed_rpred_mu"]).all()
        assert np.isnan(r["failed_rpred_var"]).all()
        msgs = list(r["warnings"])
        assert len(msgs) == 2
        assert msgs[0].startswith("ring predict: 1 of 1 CG solves")
        bad, evals = map(int, re.match(r"fit_ring: (\d+) of (\d+) CG "
                                       r"solves", msgs[1]).groups())
        assert 0 < bad <= evals == int(r["short_fit_evals"])
        assert "cg_tol 1e-10" in msgs[1]
        np.testing.assert_allclose(r["short_fit_x"], jx["short_fit_x"],
                                   rtol=1e-6)
        assert str(r["short_fit_stop"]) == jx["short_fit_stop"]
