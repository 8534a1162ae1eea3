"""Port parity: the row-split exact mesh engine (parallel/: block
Cholesky, the dist NLML and gradient, predict, fit_distributed, the
two-level NLML) and the mesh hooks of ensemble/ and bayes/.

The port runs as torch ranks over gloo on the CPU at world sizes 1, 2
and 4 (tests/torch_mesh_worker.py, which never imports jax; the ranks of
all three sizes are forked by one launch, with a time limit, and a rank
that fails fails the tests). The JAX package runs here on a mesh of the
same size over the CPU devices tests/conftest.py forces. Float64; 37
training points, so no rank count divides N and padding is exercised.

Tolerances: the block Cholesky and its solves against numpy 1e-10; the
NLML value rtol 1e-10 and gradients rtol 1e-8 of the largest entry (the
same algebra; the panel's diagonal is set exactly in both packages' paths
here); predictions rtol 1e-9; fit_distributed x rtol 1e-6 with equal
iterations and stop reason; the mesh hooks against one rank's answer:
ensembles rtol 1e-10, HMC chains 1e-7, NUTS chains 1e-6 (see the
test).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import gp_ss_ak_tpu.model as jm
from gp_ss_ak_tpu import parallel as jp
from gp_ss_ak_tpu.inference import WarpedGaussian
from gp_ss_ak_tpu.parallel.mesh import pad_rows

from torch_mesh_worker import collect, start

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
NB = 4
N, D = 37, 3
PROBES = 4
FIT_ITERS = 5


def _flat(rng, d=3):
    m = jm.default_model(d, dtype=jnp.float64)
    return np.asarray(m.pack()) * rng.uniform(0.8, 1.2, size=m.n_params)


def _spd(rng, n):
    B = rng.normal(size=(n, n))
    return B @ B.T + n * np.eye(n)


def _inputs(world):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, D))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=N)
    n_pad = pad_rows(N, world, NB)
    data = dict(suite="dist", nb=NB, probes=PROBES, fit_iters=FIT_ITERS,
                X=X, y=y, Xq=rng.normal(size=(7, D)), flat=_flat(rng),
                # JAX's own probe draw at this mesh size, over its padded
                # rows; the port takes the true rows
                Z=np.asarray(jax.random.rademacher(
                    jax.random.PRNGKey(0), (n_pad, PROBES),
                    jnp.float64))[:N])
    for k in (1, 2):
        data[f"spd{k}"] = _spd(rng, world * k * NB)
        data[f"rhs{k}"] = rng.normal(size=(world * k * NB, 3))
    for fam in ("tanh1", "rbf"):
        data[f"wflat_{fam}"] = np.concatenate(
            [data["flat"][:9], [0.3, 0.8, 0.1, -1.5]])
    data["flats2"] = np.stack([data["flat"],
                               np.clip(data["flat"] * 1.3, 1e-4, 6.0)])
    data["flat2"] = _flat(rng, 2)
    data["ens_X"] = rng.uniform(-1, 1, size=(5, 8, 2))
    data["ens_y"] = np.sin(2 * data["ens_X"][..., 0])
    data["hmc_X"] = rng.uniform(-1, 1, size=(12, 2))
    data["hmc_y"] = np.sin(2 * data["hmc_X"][:, 0])
    return data


def _jax_model(flat, likelihood=None):
    m = jm.default_model(3, dtype=jnp.float64)
    if likelihood is not None:
        from dataclasses import replace
        m = replace(m, likelihood=likelihood,
                    lik_hypers=jnp.zeros(likelihood.n_hypers))
    return m.unpack(jnp.asarray(flat))


def _jax_side(world, data):
    mesh = jp.make_mesh(world)
    X, y = data["X"], data["y"]
    Xs, ys, n, _ = jp.shard_training_data(mesh, X, y, nb=NB)
    out = {}

    def nlml(key, m, **kw):
        f = jp.make_dist_nlml_and_grad(m.kernel, m.likelihood, mesh, n=n,
                                       nb=NB, **kw)
        v, g = f(m.pack(), Xs, ys)
        out[key + "_v"], out[key + "_g"] = float(v), np.asarray(g)

    model = _jax_model(data["flat"])
    nlml("exact", model, grad_mode="exact")
    nlml("hutch", model, grad_mode="hutchinson", probes=PROBES)
    for fam in ("tanh1", "rbf"):
        wm = _jax_model(data[f"wflat_{fam}"], WarpedGaussian(fam, 1))
        nlml(f"warp_{fam}", wm, grad_mode="exact")
        if fam == "tanh1":
            mu, var = jp.make_dist_predict(wm.kernel, wm.likelihood, mesh,
                                           n=n, nb=NB)(
                wm.pack(), Xs, ys, jnp.asarray(data["Xq"]))
            out["wpred_mu"], out["wpred_var"] = np.asarray(mu), np.asarray(
                var)
    mu, var = jp.make_dist_predict(model.kernel, model.likelihood, mesh,
                                   n=n, nb=NB)(model.pack(), Xs, ys,
                                               jnp.asarray(data["Xq"]))
    out["pred_mu"], out["pred_var"] = np.asarray(mu), np.asarray(var)
    _, res = jp.fit_distributed(model, X, y, mesh, nb=NB, iters=FIT_ITERS)
    out["fit_x"], out["fit_iters"] = np.asarray(res.x), res.n_iters
    out["fit_stop"] = res.stop_reason
    if world == 4:
        mesh2 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                     ("chains", jp.ROW_AXIS))
        n_pad = pad_rows(N, 2, NB)
        Xp, yp = np.zeros((n_pad, D)), np.zeros(n_pad)
        Xp[:N], yp[:N] = X, y
        f2 = jp.make_two_level_nlml_and_grad(model.kernel, model.likelihood,
                                             mesh2, n=N, nb=NB,
                                             grad_mode="exact")
        v, g = f2(jax.device_put(jnp.asarray(data["flats2"]),
                                 NamedSharding(mesh2, P("chains", None))),
                  jax.device_put(jnp.asarray(Xp),
                                 NamedSharding(mesh2, P(jp.ROW_AXIS, None))),
                  jax.device_put(jnp.asarray(yp),
                                 NamedSharding(mesh2, P(jp.ROW_AXIS))))
        out["two_v"], out["two_g"] = np.asarray(v), np.asarray(g)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (inputs, the JAX side, the ranks' results)}; every world
    size's ranks run while the JAX side is computed here."""
    inputs = {w: _inputs(w) for w in WORLDS}
    handle = start(inputs, str(tmp_path_factory.mktemp("ranks")))
    try:
        # one thread a mesh size: XLA compiles without the interpreter lock
        with ThreadPoolExecutor(len(WORLDS)) as pool:
            jax_out = dict(zip(WORLDS, pool.map(
                lambda w: _jax_side(w, inputs[w]), WORLDS)))
    finally:
        ranks = collect(handle)
    return {w: (inputs[w], jax_out[w], ranks[w]) for w in WORLDS}


def _close(got, want, rtol):
    """Equal within rtol of the largest entry of `want`."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("k", [1, 2], ids=["one_block", "two_blocks"])
def test_block_cholesky_and_solves_match_dense(runs, world, k):
    data, _, ranks = runs[world]
    A, B = data[f"spd{k}"], data[f"rhs{k}"]
    L = np.linalg.cholesky(A)
    np.testing.assert_allclose(_rows(ranks, f"chol{k}_L"), L, atol=1e-10)
    for r in ranks:
        assert float(r[f"chol{k}_hld"]) == pytest.approx(
            np.sum(np.log(np.diag(L))), rel=1e-12)
    lower = np.linalg.solve(L, B)
    np.testing.assert_allclose(_rows(ranks, f"chol{k}_lower"), lower,
                               atol=1e-10)
    np.testing.assert_allclose(_rows(ranks, f"chol{k}_upper"),
                               np.linalg.solve(L.T, B), atol=1e-10)
    np.testing.assert_allclose(_rows(ranks, f"chol{k}_solve"),
                               np.linalg.solve(A, B), atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["exact", "hutch", "warp_tanh1", "warp_rbf"])
def test_dist_value_and_gradient_match_jax(runs, world, key):
    _, jx, ranks = runs[world]
    for r in ranks:        # the same value and gradient on every rank
        assert float(r[key + "_v"]) == pytest.approx(jx[key + "_v"],
                                                     rel=1e-10)
        _close(r[key + "_g"], jx[key + "_g"], 1e-8)
        np.testing.assert_array_equal(r[key + "_g"], ranks[0][key + "_g"])


@pytest.mark.parametrize("world", WORLDS)
def test_fused_panel_and_padding_invariance(runs, world):
    _, _, ranks = runs[world]
    for r in ranks:
        # K1's cross entry (its plain version here) against kernel.matrix
        assert float(r["fused_v"]) == pytest.approx(float(r["exact_v"]),
                                                    rel=1e-12)
        _close(r["fused_g"], r["exact_g"], 1e-10)
        # poisoned padding rows: bit for bit the same
        np.testing.assert_array_equal(r["pad_v"], r["exact_v"])
        np.testing.assert_array_equal(r["pad_g"], r["exact_g"])


@pytest.mark.parametrize("world", WORLDS)
def test_failed_factorization_gives_nan(runs, world):
    _, _, ranks = runs[world]
    for r in ranks:
        live = r["exact_g"] != 0     # InversewidthR has no say at d = 3
        for mode in ("exact", "hutchinson"):
            assert np.isnan(r[f"fail_{mode}_v"])
            assert np.all(np.isnan(r[f"fail_{mode}_g"][live]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["pred", "wpred"])
def test_dist_predict_matches_jax(runs, world, key):
    _, jx, ranks = runs[world]
    for r in ranks:
        _close(r[key + "_mu"], jx[key + "_mu"], 1e-9)
        _close(r[key + "_var"], jx[key + "_var"], 1e-9)
    np.testing.assert_array_equal(ranks[0]["pred_mu_only"],
                                  ranks[0]["pred_mu"])
    assert ranks[0]["pred_var_none"]


@pytest.mark.parametrize("world", WORLDS)
def test_fit_distributed_matches_jax(runs, world):
    _, jx, ranks = runs[world]
    for r in ranks:
        np.testing.assert_allclose(r["fit_x"], jx["fit_x"], rtol=1e-6)
        assert int(r["fit_iters"]) == jx["fit_iters"] == FIT_ITERS
        assert str(r["fit_stop"]) == jx["fit_stop"]


def test_two_level_matches_jax(runs):
    _, jx, ranks = runs[4]
    for r in ranks:
        np.testing.assert_allclose(r["two_v"], jx["two_v"], rtol=1e-10)
        for c in range(2):
            _close(r["two_g"][c], jx["two_g"][c], 1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_hooks_give_what_one_rank_gives(runs, world):
    _, _, ranks = runs[world]
    # the chains on a rank see the same draws and loop bounds as in the
    # whole batch (the same evaluation count), but torch's elementwise
    # CPU math rounds tensors of other sizes and layouts differently
    # (scalar and vector paths), by an ulp, and the leapfrogs amplify it:
    # HMC's fixed trajectories to 1.2e-9 (rtol 1e-7), NUTS's U-turn and
    # multinomial choices further (samples 2.9e-8 apart, one tree's
    # accept statistic 0.0085: rtol 1e-6 and atol 0.02)
    # (the whole batch ran on rank 0 alone)
    one = ranks[0]
    for r in ranks:
        for key in ("x", "fun", "iters", "conv"):
            np.testing.assert_allclose(r["ens_mesh_" + key],
                                       one["ens_" + key], rtol=1e-10)
        for sampler, rtol, atol in (("hmc", 1e-7, 1e-7),
                                    ("nuts", 1e-6, 0.02)):
            assert r[f"{sampler}_mesh_evals"] == one[f"{sampler}_full_evals"]
            np.testing.assert_allclose(r[f"{sampler}_mesh"],
                                       one[f"{sampler}_full"], rtol=rtol)
            np.testing.assert_allclose(r[f"{sampler}_mesh_ap"],
                                       one[f"{sampler}_full_ap"], rtol=0,
                                       atol=atol)
        # the dist NLML through nlml_value_and_grad vs the dense objective
        np.testing.assert_allclose(r["hmc_vg"], one["hmc_dense"], rtol=1e-8)


def test_mesh_helpers_match_jax(monkeypatch):
    """In this process, a mesh of one rank (a world of one over gloo):
    pad_rows as JAX's, row_sharding and replicated, initialize without a
    launcher's environment doing nothing (JAX's no-op), and no card
    without one."""
    from gp_ss_ak_torch import parallel as tp

    for n, p, nb in ((37, 4, 4), (160, 8, 256), (1, 1, 1), (64, 2, 8)):
        assert tp.pad_rows(n, p, nb) == pad_rows(n, p, nb)
    for name in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert tp.initialize() is False
    mesh = tp.make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    assert not mesh.staged
    A = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(tp.row_sharding(mesh, A), A)
    assert torch.equal(tp.replicated(mesh, A), A)
    Xl, yl, n, n_pad = tp.shard_training_data(mesh, A, A[:, 0], nb=4)
    assert (n, n_pad, tuple(Xl.shape)) == (6, 8, (8, 2))
    assert torch.equal(Xl[:6], A) and not Xl[6:].any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no usable CUDA device"):
            tp.make_mesh("cuda")
