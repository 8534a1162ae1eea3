"""Port parity: the example workflows (gp_ss_ak_torch/examples) against
the JAX package's functions that examples/*.py call, computed here on
the same data. The JAX example scripts themselves are not run.

  * full_workflow, in this process on the CPU in float64: the trained
    -logL and the test MSE against gp_ss_ak_tpu.optim.fit and its
    Predictor on the same files, rtol 1e-6 (the same L-BFGS-B steps on
    the same float64 objective), after FIT_ITERS iterations: the two
    traces agree to 1e-9 through iteration 30 and part past 43, where
    round-off in a flat valley sends the line searches apart (8e-3 at
    the example's 60 iterations, and the same package on another thread
    count parts there too); its NUTS part with 3 + 3 transitions,
    finite.
  * distributed_workflow on 2 gloo ranks (tests/torch_mesh_worker.py):
    the fit's first and last NLML against JAX's fit_distributed in
    float64 on 2 CPU devices, rtol 1e-6; its own check (the dist and
    ring means within 1e-3) passed on every rank.
  * ring_workflow (3 fit iterations) and bayes_workflow (5 + 5
    transitions) on the same ranks: run to their end, with the ring's
    own MSE check passed and every sample finite; the ranks agree.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_worker import collect, start

torch.set_num_threads(1)

WORLD = 2
RING_ITERS, SAMPLES, WARMUP = 3, 5, 5
FIT_ITERS = 30


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the 2 ranks' results, JAX's fit_distributed on the
    distributed example's data)."""
    handle = start({WORLD: {"suite": "examples", "ring_iters": RING_ITERS,
                            "samples": SAMPLES, "warmup": WARMUP}},
                   str(tmp_path_factory.mktemp("examples")))
    try:
        from gp_ss_ak_tpu.model import default_model
        from gp_ss_ak_tpu.parallel import fit_distributed, make_mesh

        rng = np.random.default_rng(0)
        X = rng.uniform(0, 10, (512, 3))
        y = np.sin(0.7 * X[:, 0]) + 0.5 * np.cos(0.5 * X[:, 1]) \
            + 0.1 * X[:, 2]
        _, res = fit_distributed(default_model(3, dtype=jnp.float64), X, y,
                                 make_mesh(WORLD), nb=64, iters=30,
                                 grad_mode="exact")
    finally:
        out = collect(handle)[WORLD]
    return out, res


def test_distributed_workflow_matches_jax(ranks):
    out, res = ranks
    for r in out:
        assert float(r["dist_trace0"]) == pytest.approx(res.trace[0],
                                                        rel=1e-6)
        assert float(r["dist_fun"]) == pytest.approx(res.fun, rel=1e-6)
        np.testing.assert_allclose(r["dist_mu_ring"], r["dist_mu"],
                                   rtol=0, atol=1e-3)


def test_ring_and_bayes_workflows_run_to_their_end(ranks):
    out, _ = ranks
    for r in out:
        assert float(r["ring_mse"]) < 0.1
        assert 0 <= float(r["ring_cg_rel"]) < 1
        assert np.isfinite(r["bayes_theta"]).all()
        assert r["bayes_theta"].shape[:2] == (4, SAMPLES)
        assert np.isfinite(r["bayes_mu"]).all()
        assert (r["bayes_var"] > 0).all()
        for key in ("ring_fun", "ring_mse", "bayes_theta", "bayes_mu"):
            np.testing.assert_array_equal(r[key], out[0][key])


def test_full_workflow_matches_jax(capsys):
    from gp_ss_ak_torch.examples import full_workflow

    got = full_workflow.main(device="cpu", iters=FIT_ITERS, n_samples=3,
                             n_warmup=3)
    printed = capsys.readouterr().out
    assert printed.startswith("trained: -logL ")
    assert "test MSE " in printed and "bayes: mean accept " in printed
    assert np.isfinite(got["theta"].numpy()).all()

    from gp_ss_ak_tpu.data import (MODE_SYMMETRIC, apply, prepare,
                                   read_data, unapply_y, write_data)
    from gp_ss_ak_tpu.model import default_model
    from gp_ss_ak_tpu.optim import fit
    from gp_ss_ak_tpu.serve import Predictor

    X, y = full_workflow.ore_body(300)
    with tempfile.TemporaryDirectory() as work:
        train, test = (os.path.join(work, f) for f in ("tr.txt", "te.txt"))
        write_data(train, X[:250], y[:250])
        write_data(test, X[250:], y[250:])
        Xs, ys, stats = prepare(*read_data(train), MODE_SYMMETRIC)
        Xte, yte = read_data(test)
    model, res = fit(default_model(3, dtype=jnp.float64), Xs, ys,
                     iters=FIT_ITERS)
    mu, _ = Predictor(model, Xs, ys)(apply(stats, Xte))
    mse = float(np.mean((unapply_y(stats, np.asarray(mu)) - yte) ** 2))
    assert jax.config.jax_enable_x64
    assert got["res"].trace[0] == pytest.approx(res.trace[0], rel=1e-6)
    assert got["res"].fun == pytest.approx(res.fun, rel=1e-6)
    assert got["mse"] == pytest.approx(mse, rel=1e-6)
    assert got["res"].stop_reason == res.stop_reason
