"""The hand-written CUDA kernels K1 and K3 on the card (marker `gpu`).

Every test here needs a CUDA device and skips without one; the check
runs inside the fixture, never at import. On a machine with a card and
without jax (tests/conftest.py imports it), run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances, relative to the Gram's scale s2 + bias: the kernel computes
d2 by direct differences, its plain version by the expansion, so in
float64 they agree to 1e-10; in float32 the kernel is held to 1e-5
against the plain version evaluated in float64 on the same inputs.
K3 (float32 only) is held per column to
TOL_K3 * (s2 + bias) * ||V[:, b]||_1 against its plain version in
float64: each output sums n products in float32, whose error grows like
n, as ||V||_1 does. TOL_K3 is chip_smoke.py's, set from readings on the
card between the kernel's worst column and a TF32 product's best (which
it must reject there). The card tests add 4 float32 ulps of the output,
which dominate at tiny n: at n = 1 the output is (s2 + bias + sn2) * v,
and its float32 roundings alone reach ~2 ulps.
"""

import os

import numpy as np
import pytest
import torch

from gp_ss_ak_torch.data import Statistics, apply, read_data, unapply_y
from gp_ss_ak_torch.inference import predict
from gp_ss_ak_torch.model import load_model
from gp_ss_ak_torch.ops import matvec, pairwise
from gp_ss_ak_torch.serve import IterativePredictor

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SIGMA, BIAS, SN2 = 0.6, 0.2, 0.016
SCALE = SIGMA * SIGMA + BIAS
TOL_K3 = 1.5e-7


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _points(n, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return 3.0 * torch.rand(n, d, generator=g, device=device,
                            dtype=torch.float64) - 1.5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n,m,d", [(1, 1, 3), (37, None, 3), (37, 17, 4),
                                   (130, 129, 5), (1000, None, 4),
                                   (1000, 333, 3)])
def test_kernel_matches_plain(cuda, n, m, d, dtype):
    X = _points(n, d, cuda, seed=n)
    Y = None if m is None else _points(m, d, cuda, seed=1000 + m)
    sn2 = SN2 if m is None else None
    before = pairwise.launches
    K = pairwise.expans_bias_gram(X.to(dtype), SIGMA, BIAS, sn2,
                                  None if Y is None else Y.to(dtype))
    torch.cuda.synchronize()
    assert pairwise.launches == before + 1
    assert K.dtype == dtype and tuple(K.shape) == (n, n if m is None else m)
    ref = pairwise.expans_bias_gram_plain(
        X.to(dtype).double(), SIGMA, BIAS, sn2,
        None if Y is None else Y.to(dtype).double())
    tol = (1e-10 if dtype == torch.float64 else 1e-5) * SCALE
    assert (K.double() - ref).abs().max().item() <= tol
    if m is None:   # the diagonal is s2 + bias + sn2, to the dtype's eps
        diag = torch.diagonal(K).double()
        assert torch.allclose(diag, torch.full_like(diag, SCALE + SN2),
                              rtol=0, atol=4 * float(torch.finfo(dtype).eps))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_coincident_points_give_exact_zero_distance(cuda, dtype):
    # the direct difference gives d2 = 0 exactly where the expansion
    # leaves sqrt(round-off) ~ 1e-8: held against the direct formula
    X = _points(37, 3, cuda, seed=5).to(dtype)
    K = pairwise.expans_bias_gram(X, SIGMA, BIAS, None, X.clone())
    torch.cuda.synchronize()
    Xd = X.double()
    d2 = ((Xd[:, None, :] - Xd[None, :, :]) ** 2).sum(-1)
    ref = SIGMA * SIGMA * torch.exp(-torch.sqrt(d2)) + BIAS
    tol = (1e-12 if dtype == torch.float64 else 1e-6) * SCALE
    assert (K.double() - ref).abs().max().item() <= tol
    s2 = torch.tensor(SIGMA, dtype=dtype) ** 2
    assert (torch.diagonal(K).cpu() == s2 + torch.tensor(BIAS,
                                                         dtype=dtype)).all()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    X = _points(8, 3, cuda, seed=0)
    with pytest.raises(TypeError):
        pairwise.expans_bias_gram(X.half(), SIGMA, BIAS)
    with pytest.raises(ValueError):
        pairwise.expans_bias_gram(X.T, SIGMA, BIAS)          # strided
    with pytest.raises(TypeError):
        pairwise.expans_bias_gram(X, SIGMA, BIAS, None, X.float())
    with pytest.raises(ValueError):
        pairwise.expans_bias_gram(X, SIGMA, BIAS, None, X[:, :2].clone())


def test_golden_through_the_kernel_in_float64(cuda):
    model = load_model(os.path.join(GOLDEN, "model")).to(torch.float64,
                                                         cuda)
    stats = Statistics.load(os.path.join(GOLDEN, "model_Statistics.txt"))
    Xtr, ytr = read_data(os.path.join(GOLDEN, "train.txt"))
    Xte, _ = read_data(os.path.join(GOLDEN, "test.txt"))
    Xtrs, ytrs = apply(stats, Xtr, ytr)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=cuda)

    before = pairwise.launches
    mu, _ = predict(model.kernel, model.kernel_params, model.lik_hypers,
                    t(Xtrs), t(ytrs), t(apply(stats, Xte)),
                    model.likelihood)
    assert pairwise.launches == before + 2   # A and the cross-Gram
    yh = unapply_y(stats, mu.cpu().numpy())
    z = np.load(os.path.join(GOLDEN, "expected.npz"))
    np.testing.assert_allclose(yh, z["mu"], rtol=1e-7, atol=1e-10)


def _matmat_case(n, b, d, cuda, seed):
    X32 = _points(n, d, cuda, seed).float()
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    V = torch.randn(n, b, generator=g, device=cuda, dtype=torch.float32)
    Xk, scal = matvec.operator_arrays(X32, SIGMA)
    return Xk, scal, V


@pytest.mark.parametrize("n,b,d", [(1, 1, 3), (37, 1, 3), (130, 7, 4),
                                   (1000, 8, 3), (1000, 9, 3), (257, 64, 5),
                                   (4097, 65, 2), (300, 130, 3)])
def test_matmat_kernel_matches_plain(cuda, n, b, d):
    Xk, scal, V = _matmat_case(n, b, d, cuda, seed=n + b)
    before = matvec.launches
    Y = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V)
    torch.cuda.synchronize()
    assert matvec.launches == before + 1
    assert Y.dtype == torch.float32 and tuple(Y.shape) == (n, b)
    ref = matvec.streamed_matmat_plain(Xk.double(), scal.double(), BIAS,
                                       SN2, V.double())
    tol = (TOL_K3 * SCALE * V.double().abs().sum(0)
           + 4 * torch.finfo(torch.float32).eps * ref.abs().max(0).values)
    assert bool(((Y.double() - ref).abs().max(0).values <= tol).all())


def test_matmat_kernel_is_repeatable(cuda):
    # no atomics: two passes give the same bits
    Xk, scal, V = _matmat_case(3000, 33, 3, cuda, seed=3)
    assert torch.equal(matvec.streamed_matmat(Xk, scal, BIAS, SN2, V),
                       matvec.streamed_matmat(Xk, scal, BIAS, SN2, V))


def test_matmat_diagonal_is_exactly_s2(cuda):
    # unit columns pick out Gram columns; at i == j the kernel writes s2
    # itself, not s2 * exp(-sqrt(0 + round-off))
    n = 300
    Xk, scal, _ = _matmat_case(n, 1, 3, cuda, seed=4)
    cols = torch.tensor([0, 1, 127, 128, 299], device=cuda)
    E = torch.zeros(n, cols.numel(), device=cuda)
    E[cols, torch.arange(cols.numel(), device=cuda)] = 1.0
    Y = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, E)
    assert torch.equal(Y[cols, torch.arange(cols.numel(), device=cuda)],
                       scal.expand(cols.numel()))


def test_matmat_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    Xk, scal, V = _matmat_case(16, 2, 3, cuda, seed=5)
    with pytest.raises(TypeError):
        matvec.streamed_matmat(Xk, scal, BIAS, SN2, V.double())
    with pytest.raises(TypeError):
        matvec.streamed_matmat(Xk.double(), scal, BIAS, SN2, V)
    with pytest.raises(TypeError):
        matvec.streamed_matmat(Xk.cpu(), scal, BIAS, SN2, V)
    with pytest.raises(ValueError):
        matvec.streamed_matmat(Xk, scal, BIAS, SN2,
                               V.T.contiguous().T)              # strided
    with pytest.raises(ValueError):
        matvec.streamed_matmat(Xk, scal, BIAS, SN2, V[:8].contiguous())
    with pytest.raises(ValueError):     # features not padded to float4s
        matvec.streamed_matmat(Xk[:, :3].contiguous(), scal, BIAS, SN2, V)


def test_iterative_predictor_on_cuda_launches_k3(cuda):
    rng = np.random.default_rng(7)
    X = rng.uniform(-1, 1, (384, 3))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0]))
    Xs = rng.uniform(-1, 1, (64, 3))
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.serve import Predictor

    model = default_model(3, dtype=torch.float64, device=cuda)
    k3 = matvec.launches
    it = IterativePredictor(model, X, y, precond_rank=64, cg_tol=1e-6,
                            chunk=128)
    mu, var = it(Xs, batch_size=64)
    assert matvec.launches - k3 >= it.setup_cg_iters + it.last_cg_iters
    assert it.alpha.device.type == "cuda"
    mu_d, var_d = Predictor(model, X, y)(Xs)
    np.testing.assert_allclose(mu, mu_d, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var, var_d, rtol=5e-3, atol=5e-4)
