"""The hand-written CUDA kernel K1 on the card (marker `gpu`).

Every test here needs a CUDA device and skips without one; the check
runs inside the fixture, never at import. On a machine with a card and
without jax (tests/conftest.py imports it), run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances, relative to the Gram's scale s2 + bias: the kernel computes
d2 by direct differences, its plain version by the expansion, so in
float64 they agree to 1e-10; in float32 the kernel is held to 1e-5
against the plain version evaluated in float64 on the same inputs.
"""

import os

import numpy as np
import pytest
import torch

from gp_ss_ak_torch.data import Statistics, apply, read_data, unapply_y
from gp_ss_ak_torch.inference import predict
from gp_ss_ak_torch.model import load_model
from gp_ss_ak_torch.ops import pairwise

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SIGMA, BIAS, SN2 = 0.6, 0.2, 0.016
SCALE = SIGMA * SIGMA + BIAS


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
