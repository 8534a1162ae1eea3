"""Port parity: the gradients of the dense training path, float64 on CPU.

The same numpy inputs go through the JAX package and the port:
  * K1's autograd Function (ops/fused.FusedExpansBiasA) against JAX's
    custom VJP (`fused_expans_bias_A`, its Pallas forward in interpret
    mode), plus torch.autograd.gradcheck;
  * the flat NLML gradient (QW adjoint and reverse mode through potrf)
    against `jax.grad` of gaussian.nlml, metric-map angles and widths
    included; the generic (non-flagship) Gram path too;
  * the zero gradient of coincident points (safe_sqrt, K1's inv2r);
  * the golden fixture's gradient and gp_ss_ak_torch.entry against JAX.

Tolerance: rtol 1e-8. Both sides run the same algebra in float64; the
port's flagship forward is K1's plain version (the TPU kernel's
expansion) where JAX on the CPU takes its generic Gram, and the
backward sums run in other orders, so values and gradients differ by
round-off amplified by the conditioning of A (sn2 = 1e-4 on the golden
fixture), well inside 1e-8.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.ops import fused as jf
from gp_ss_ak_tpu.optim import flat_nlml_fn as j_flat_nlml_fn
from gp_ss_ak_torch.ops import fused as tf
from gp_ss_ak_torch.optim import flat_nlml_fn as t_flat_nlml_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
F64 = torch.float64
CPU = torch.device("cpu")
RTOL = 1e-8

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _points(n, d, seed):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, size=(n, d))


@pytest.mark.parametrize("d", [3, 4])
def test_fused_gram_vjp_matches_jax(d):
    X = _points(40, d, seed=d)
    G = np.random.default_rng(10 + d).normal(size=(40, 40))
    s, b, n2 = 0.7, 0.25, 0.03
    Aj, vjp = jax.vjp(jf.fused_expans_bias_A, jnp.asarray(X), s, b, n2)
    gj = vjp(jnp.asarray(G))
    leaves = [torch.tensor(v, dtype=F64, requires_grad=True)
              for v in (X, s, b, n2)]
    At = tf.fused_expans_bias_A(*leaves)
    gt = torch.autograd.grad((At * torch.from_numpy(G)).sum(), leaves)
    close(At.detach().numpy(), Aj)
    for a, c in zip(gt, gj):
        close(a.numpy(), c)


def test_fused_gram_gradcheck():
    X = torch.tensor(_points(32, 3, seed=1), dtype=F64, requires_grad=True)
    args = [X] + [torch.tensor(v, dtype=F64, requires_grad=True)
                  for v in (0.8, 0.3, 0.05)]
    assert torch.autograd.gradcheck(tf.fused_expans_bias_A, args)


def test_fused_gram_coincident_points_have_finite_gradients():
    # r = 0 off the diagonal: the inv2r guard (fused.py:52) gives those
    # pairs no Xm gradient, as the JAX VJP does
    X = _points(12, 3, seed=2)
    X[5] = X[3]
    G = np.random.default_rng(3).normal(size=(12, 12))
    Xt = torch.tensor(X, dtype=F64, requires_grad=True)
    At = tf.fused_expans_bias_A(Xt, 0.7, 0.2, 0.01)
    (gt,) = torch.autograd.grad((At * torch.from_numpy(G)).sum(), Xt)
    assert torch.isfinite(gt).all()
    _, vjp = jax.vjp(jf.fused_expans_bias_A, jnp.asarray(X), 0.7, 0.2, 0.01)
    close(gt.numpy(), vjp(jnp.asarray(G))[0])


def test_safe_sqrt_has_zero_gradient_at_zero():
    from gp_ss_ak_torch.kernels.distance import safe_sqrt

    x = torch.tensor([0.0, 4.0], dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(safe_sqrt(x).sum(), x)
    assert g.tolist() == [0.0, 0.25]


def models(kernels=None, d=3, seed=0):
    """The JAX and torch default models at the same perturbed flat
    vector, float64, on the CPU."""
    rng = np.random.default_rng(seed)
    mj = jm.default_model(d, kernel_names=kernels)
    flat = np.asarray(mj.pack()) * rng.uniform(0.8, 1.2, size=mj.n_params)
    mj = mj.unpack(jnp.asarray(flat))
    mt = tm.default_model(d, kernel_names=kernels, device=CPU)
    mt = mt.unpack(torch.from_numpy(flat.copy()))
    return mj, mt, flat


def jax_value_grad(mj, flat, X, y, grad_mode):
    f = j_flat_nlml_fn(mj, grad_mode=grad_mode)
    v, g = jax.value_and_grad(lambda p: f(p, jnp.asarray(X),
                                          jnp.asarray(y)))(jnp.asarray(flat))
    return float(v), np.asarray(g)


def torch_value_grad(mt, flat, X, y, grad_mode):
    f = t_flat_nlml_fn(mt, grad_mode=grad_mode)
    p = torch.tensor(flat, dtype=F64, requires_grad=True)
    v = f(p, torch.from_numpy(X), torch.from_numpy(y))
    (g,) = torch.autograd.grad(v, p)
    return float(v.detach()), g.numpy()


@pytest.mark.parametrize("kernels,d", [(None, 3), (None, 4), (None, 2),
                                       (["RBF"], 3)],
                         ids=["flagship3", "flagship4", "flagship2", "rbf"])
def test_nlml_gradient_qw_autodiff_and_jax_agree(kernels, d):
    mj, mt, flat = models(kernels, d, seed=d)
    rng = np.random.default_rng(20 + d)
    X = rng.uniform(-1, 1, size=(64, d))
    y = np.sin(X @ np.arange(1.0, d + 1.0))
    vj, gj = jax_value_grad(mj, flat, X, y, "autodiff")
    for mode in ("qw", "autodiff"):
        vt, gt = torch_value_grad(mt, flat, X, y, mode)
        assert vt == pytest.approx(vj, rel=RTOL)
        close(gt, gj)
    if kernels is None:     # the angles and inverse widths carry gradient
        assert np.all(np.abs(gj[:6]) > 0)


def test_nlml_gradient_with_coincident_points_is_finite():
    # duplicated inputs (drill-hole composites can repeat a location):
    # the distance and its gradient are zero there, never NaN
    mj, mt, flat = models(seed=5)
    X = np.random.default_rng(6).uniform(-1, 1, size=(30, 3))
    X[7] = X[2]
    y = np.cos(X.sum(1))
    vj, gj = jax_value_grad(mj, flat, X, y, "qw")
    vt, gt = torch_value_grad(mt, flat, X, y, "qw")
    assert np.all(np.isfinite(gt))
    assert vt == pytest.approx(vj, rel=RTOL)
    close(gt, gj)


def test_failed_cholesky_gives_nan_value_and_gradient_without_raising():
    _, mt, flat = models(seed=1)
    flat = flat.copy()
    flat[-1] = -5.0           # sn2 < 0: A indefinite
    X = np.random.default_rng(2).uniform(-1, 1, size=(40, 3))
    y = np.sin(X.sum(1))
    vt, gt = torch_value_grad(mt, flat, X, y, "qw")
    # every entry but the unused InversewidthR (3-D inputs) is NaN
    assert np.isnan(vt) and np.isnan(np.delete(gt, 7)).all()


def test_golden_gradient_matches_jax():
    from gp_ss_ak_tpu.data import Statistics, apply, read_data

    mj = jm.load_model(os.path.join(GOLDEN, "model"))
    mt = tm.load_model(os.path.join(GOLDEN, "model"), device=CPU)
    stats = Statistics.load(os.path.join(GOLDEN, "model_Statistics.txt"))
    X, y = read_data(os.path.join(GOLDEN, "train.txt"))
    Xs, ys = apply(stats, X, y)
    flat = np.asarray(mj.pack())
    np.testing.assert_array_equal(mt.pack().numpy(), flat)
    vj, gj = jax_value_grad(mj, flat, Xs, ys, "qw")
    vt, gt = torch_value_grad(mt, flat, Xs, ys, "qw")
    z = np.load(os.path.join(GOLDEN, "expected.npz"))
    assert vt == pytest.approx(float(z["nlml"]), rel=RTOL)
    assert vt == pytest.approx(vj, rel=RTOL)
    close(gt, gj)


def test_entry_matches_jax_entry_in_float64():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as graft

    from gp_ss_ak_torch.entry import entry

    step_j, _ = graft.entry()
    model, Xj, yj = graft._flagship(dtype=jnp.float64)
    vj, gj = step_j(model.pack(), Xj, yj)
    step_t, (flat, Xt, yt) = entry(dtype=F64, device="cpu")
    assert tuple(Xt.shape) == (1024, 3) and Xt.dtype == F64
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    vt, gt = step_t(flat, Xt, yt)
    assert float(vt) == pytest.approx(float(vj), rel=RTOL)
    close(gt.numpy(), gj)
