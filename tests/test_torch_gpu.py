"""The hand-written CUDA kernels K1, K2 and K3, and the training path,
on the card (marker `gpu`).

Every test here needs a CUDA device and skips without one; the check
runs inside the fixture, never at import. On a machine with a card and
without jax (tests/conftest.py imports it), run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances, relative to the Gram's scale s2 + bias: the kernel computes
d2 by direct differences, its plain version by the expansion, so in
float64 they agree to 1e-10; in float32 the kernel is held to 1e-5
against the plain version evaluated in float64 on the same inputs.
K3 (float32 only; 3xTF32 on the tensor cores past B = 64) is held per
column to
TOL_K3 * (s2 + bias) * ||V[:, b]||_1 against its plain version in
float64: each output sums n products in float32, whose error grows like
n, as ||V||_1 does. TOL_K3 is chip_smoke.py's, set from readings on the
card between the kernel's worst column and a TF32 product's best (which
it must reject there). The card tests add 4 float32 ulps of the output,
which dominate at tiny n: at n = 1 the output is (s2 + bias + sn2) * v,
and its float32 roundings alone reach ~2 ulps. K2 (one vector) is held
to K3's gate; against K3 at B = 1 (another summation order) to twice it.
K1's batched entry (one launch for B members, each with its own
scalars) is held to the same tolerances per member, and each member's
output must equal a 2-D launch on that member bit for bit: both run the
same kernel body. The batched objective (optim.api.batched_nlml_fn)
runs in float64 on the card and on the CPU, a failed member included.
The autograd Function and a 3-iteration dense fit run in float64 on the
card and on the CPU: the forward Grams differ by the kernel's direct
differences against the plain version's expansion (1e-10 of the scale),
the gradients and the fitted hyperparameters by round-off. The mesh
engines (parallel/) run on a mesh of one rank, NCCL on the card against
gloo on the CPU, in float64.
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
    model = load_model(os.path.join(GOLDEN, "model"), device=cuda)
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
                                   (4097, 65, 2), (300, 130, 3),
                                   # the edges of the 16-wide, middle and
                                   # tensor-core tiles, at ragged n
                                   (130, 16, 3), (4097, 16, 3), (130, 17, 4),
                                   (4097, 17, 3), (130, 64, 3), (4097, 64, 3),
                                   (130, 65, 3), (130, 128, 4), (4097, 128, 3),
                                   (130, 129, 3), (4097, 129, 5),
                                   (130, 1024, 3), (4097, 1024, 3)])
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


@pytest.mark.parametrize("b", [9, 257, 1024])
def test_matmat_tiles_are_repeatable(cuda, b):
    # the 16-wide FFMA tile (B = 9) and the tensor-core tile: equal bits
    Xk, scal, V = _matmat_case(2049, b, 3, cuda, seed=b)
    assert torch.equal(matvec.streamed_matmat(Xk, scal, BIAS, SN2, V),
                       matvec.streamed_matmat(Xk, scal, BIAS, SN2, V))


def test_matmat_16_wide_tile_equals_the_middle_tile(cuda):
    # both FFMA tiles sum each output over k in one order from the same
    # Gram values: B = 9 equals the same V zero-padded to 64 columns. No
    # bias or noise: torch's column sums of (n, 9) and (n, 64) tensors
    # need not agree in bits
    Xk, scal, V = _matmat_case(3001, 9, 3, cuda, seed=10)
    V64 = torch.zeros(3001, 64, device=cuda)
    V64[:, :9] = V
    Y = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, V)
    Y64 = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, V64)
    assert torch.equal(Y, Y64[:, :9])


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


def test_matmat_diagonal_on_the_tensor_cores(cuda):
    # the wide tile holds s2 exactly but multiplies its 3xTF32 split,
    # whose hi + lo keeps 11 of the 13 bits below hi: within 2^-20 s2
    n = 300
    Xk, scal, _ = _matmat_case(n, 1, 3, cuda, seed=4)
    cols = torch.arange(0, n, 3, device=cuda)          # 100 unit columns
    E = torch.zeros(n, cols.numel(), device=cuda)
    E[cols, torch.arange(cols.numel(), device=cuda)] = 1.0
    Y = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, E)
    diag = Y[cols, torch.arange(cols.numel(), device=cuda)].double()
    s2 = scal.double()
    assert ((diag - s2).abs() <= 2.0 ** -20 * s2).all()


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


# --- K2, the streamed Gram matvec, and the training path on the card ---

@pytest.mark.parametrize("n,d", [(1, 3), (37, 3), (130, 4), (1000, 3),
                                 (4097, 2), (5000, 5), (20000, 3)])
def test_matvec_kernel_matches_plain(cuda, n, d):
    Xk, scal, V = _matmat_case(n, 1, d, cuda, seed=n + d)
    v = V[:, 0].contiguous()
    before = matvec.matvec_launches
    y = matvec.streamed_matvec(Xk, scal, BIAS, SN2, v)
    torch.cuda.synchronize()
    assert matvec.matvec_launches == before + 1
    assert y.dtype == torch.float32 and tuple(y.shape) == (n,)
    ref = matvec.streamed_matvec_plain(Xk.double(), scal.double(), BIAS,
                                       SN2, v.double())
    tol = (TOL_K3 * SCALE * v.double().abs().sum()
           + 4 * torch.finfo(torch.float32).eps * ref.abs().max())
    assert (y.double() - ref).abs().max().item() <= tol.item()


def test_matvec_kernel_is_repeatable_and_matches_k3(cuda):
    # no atomics: two passes give the same bits; K3 at B = 1 computes
    # the same function with another summation order
    Xk, scal, V = _matmat_case(9000, 1, 3, cuda, seed=9)
    v = V[:, 0].contiguous()
    y1 = matvec.streamed_matvec(Xk, scal, BIAS, SN2, v)
    y2 = matvec.streamed_matvec(Xk, scal, BIAS, SN2, v)
    assert torch.equal(y1, y2)
    y3 = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V)[:, 0]
    tol = 2 * TOL_K3 * SCALE * v.abs().sum().item()
    assert (y1 - y3).abs().max().item() <= tol


def test_matvec_diagonal_is_exactly_s2(cuda):
    n = 700
    Xk, scal, _ = _matmat_case(n, 1, 3, cuda, seed=4)
    for i in (0, 255, 256, 511, 512, 699):
        e = torch.zeros(n, device=cuda)
        e[i] = 1.0
        y = matvec.streamed_matvec(Xk, scal, 0.0, 0.0, e)
        assert y[i].item() == scal.item()


def test_matvec_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    Xk, scal, V = _matmat_case(16, 1, 3, cuda, seed=5)
    v = V[:, 0].contiguous()
    with pytest.raises(TypeError):
        matvec.streamed_matvec(Xk, scal, BIAS, SN2, v.double())
    with pytest.raises(TypeError):
        matvec.streamed_matvec(Xk.cpu(), scal, BIAS, SN2, v)
    with pytest.raises(ValueError):
        matvec.streamed_matvec(Xk, scal, BIAS, SN2, V[:, :1])    # 2-D
    with pytest.raises(ValueError):
        matvec.streamed_matvec(Xk, scal, BIAS, SN2, v[:8].contiguous())
    with pytest.raises(ValueError):
        matvec.streamed_matvec(Xk[:, :3].contiguous(), scal, BIAS, SN2, v)


def test_nlml_iterative_without_preconditioner_launches_k2(cuda):
    from gp_ss_ak_torch.inference import iterative as ti

    Xk, _, V = _matmat_case(600, 1, 3, cuda, seed=6)
    X = Xk[:, :3].contiguous()
    y = torch.sin(3 * X[:, 0])
    gp = ti.IterativeGP(X, torch.tensor(SIGMA, device=cuda),
                        torch.tensor(BIAS, device=cuda),
                        torch.tensor(0.5, device=cuda))
    key = torch.Generator(device=cuda).manual_seed(0)
    k2, k3 = matvec.matvec_launches, matvec.launches
    val, alpha, it = ti.nlml_iterative(gp, y, key, cg_tol=1e-5,
                                       precond_rank=0, mode="stream")
    assert matvec.matvec_launches - k2 == it + 1
    assert matvec.launches - k3 == 32          # the SLQ's Lanczos steps
    op = matvec.MatvecOperator(X, SIGMA, BIAS, 0.5)
    res = op.matmat(alpha[:, None])[:, 0] - y
    assert (res.norm() / y.norm()).item() <= 2e-5
    assert np.isfinite(val.item())


def test_fused_gram_autograd_on_cuda_matches_cpu(cuda):
    from gp_ss_ak_torch.ops.fused import fused_expans_bias_A

    X = _points(300, 3, cuda, seed=8)
    G = torch.randn(300, 300, dtype=torch.float64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (
            X, torch.tensor(SIGMA, dtype=torch.float64),
            torch.tensor(BIAS, dtype=torch.float64),
            torch.tensor(SN2, dtype=torch.float64))]
        A = fused_expans_bias_A(*leaves)
        out[dev.type] = (A.detach().cpu(), [g.cpu() for g in
                         torch.autograd.grad((A * G.to(dev)).sum(), leaves)])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-10 * SCALE)
    for gc, gp in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(gc, gp, rtol=1e-9, atol=1e-9)


def test_dense_fit_on_cuda_matches_cpu(cuda):
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.optim import fit

    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (128, 3))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0]))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        model = default_model(3, dtype=torch.float64, device=dev)
        fitted, r = fit(model, X, y, iters=3, engine="dense")
        res[dev.type] = (fitted.pack().cpu().numpy(), r)
    (xc, rc), (xp, rp) = res["cuda"], res["cpu"]
    assert (rc.stop_reason, rc.n_iters, rc.n_evals) == \
        (rp.stop_reason, rp.n_iters, rp.n_evals)
    np.testing.assert_allclose(xc, xp, rtol=1e-8)
    assert rc.fun == pytest.approx(rp.fun, rel=1e-10)


def _batch(B, n, m, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device,
                          dtype=torch.float64)

    X = 3.0 * rand(B, n, d) - 1.5
    Y = None if m is None else 3.0 * rand(B, m, d) - 1.5
    sn2 = 0.01 + 0.05 * rand(B) if m is None else None
    return X, Y, 0.3 + rand(B), 0.05 + 0.3 * rand(B), sn2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("B,n,m,d", [(1, 1, None, 3), (3, 37, None, 3),
                                     (4, 130, 129, 5), (2, 300, None, 4),
                                     (9, 65, 17, 3)])
def test_batched_kernel_matches_plain_and_2d_launches(cuda, B, n, m, d,
                                                      dtype):
    # one batched launch; each member against the plain version in
    # float64 (the 2-D kernel's tolerances) and bit for bit against a
    # 2-D launch on that member
    X, Y, s, b, sn2 = _batch(B, n, m, d, cuda, seed=B + n)
    args = [t.to(dtype) for t in (s, b)] + [
        None if sn2 is None else sn2.to(dtype)]
    Xd = X.to(dtype)
    Yd = None if Y is None else Y.to(dtype)
    before = (pairwise.launches, pairwise.batched_launches)
    K = pairwise.expans_bias_gram(Xd, *args, Yd)
    torch.cuda.synchronize()
    assert (pairwise.launches, pairwise.batched_launches) == \
        (before[0], before[1] + 1)
    assert K.dtype == dtype and tuple(K.shape) == (B, n, n if m is None
                                                   else m)
    ref = pairwise.expans_bias_gram_plain(
        Xd.double(), *(None if a is None else a.double() for a in args),
        None if Yd is None else Yd.double())
    scale = (args[0].double() ** 2 + args[1].double())[:, None, None]
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    assert ((K.double() - ref).abs() / scale).max().item() <= tol
    for i in range(B):
        Ki = pairwise.expans_bias_gram(
            Xd[i], *(None if a is None else a[i] for a in args),
            None if Yd is None else Yd[i])
        assert torch.equal(K[i], Ki)


def test_batched_kernel_past_the_grid_z_limit(cuda):
    # gridDim.z is at most 65535: a larger batch takes several launches
    # of the kernel inside one call of the wrapper
    B = 65535 + 7
    X, _, s, b, sn2 = _batch(B, 2, None, 3, cuda, seed=4)
    before = pairwise.batched_launches
    K = pairwise.expans_bias_gram(X, s, b, sn2)
    torch.cuda.synchronize()
    assert pairwise.batched_launches == before + 1
    ref = pairwise.expans_bias_gram_plain(X, s, b, sn2)
    assert (K - ref).abs().max().item() <= 1e-10


def test_batched_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    X, Y, s, b, _ = _batch(3, 8, 5, 3, cuda, seed=0)
    with pytest.raises(ValueError):       # batch sizes differ
        pairwise.expans_bias_gram(X, s, b, None, Y[:2].contiguous())
    with pytest.raises(ValueError):       # strided
        pairwise.expans_bias_gram(X.transpose(0, 1), s, b)
    with pytest.raises(RuntimeError):     # per-member scalars of 2 members
        pairwise.expans_bias_gram(X, s[:2], b[:2])
    with pytest.raises(ValueError):       # one point set, (B,) scalars
        pairwise.expans_bias_gram(X[0], s, b)


def test_batched_nlml_on_cuda_matches_cpu(cuda):
    # one batched K1 launch per evaluation on the card; values and
    # gradients equal the CPU's to round-off, a failed member included
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.optim.api import (batched_nlml_fn,
                                          batched_value_and_grad)

    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, (4, 96, 3))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0]))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = default_model(3, dtype=torch.float64, device=dev)
        flats = model.pack().detach().expand(4, -1).clone()
        flats[2, -1] = -1.0               # a negative noise: a failed factor
        vg = batched_value_and_grad(
            batched_nlml_fn(model),
            torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev))
        before = (pairwise.launches, pairwise.batched_launches)
        v, g = vg(flats)
        after = (pairwise.launches, pairwise.batched_launches)
        if dev.type == "cuda":
            assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
        out[dev.type] = (v.cpu().numpy(), g.cpu().numpy())
    (vc, gc), (vp, gp) = out["cuda"], out["cpu"]
    # the failed member: NaN value, NaN gradient except where the
    # objective does not depend on the entry (InversewidthR at d = 3)
    assert np.isnan(vc[2]) and np.isnan(vp[2])
    np.testing.assert_array_equal(np.isnan(gc[2]), np.isnan(gp[2]))
    assert np.isnan(gc[2]).sum() == gc.shape[1] - 1
    keep = [0, 1, 3]
    np.testing.assert_allclose(vc[keep], vp[keep], rtol=1e-10)
    np.testing.assert_allclose(gc[keep], gp[keep], rtol=1e-8, atol=1e-8)


def _coincident_sets(device, seed):
    """Two point sets (24 and 40 points, d = 3) with 8 exact coincident
    pairs, as sparse GP regression's inducing subset gives."""
    X = _points(40, 3, device, seed)
    Z = _points(24, 3, device, seed + 1)
    Z[::3] = X[1:17:2]
    return Z, X


def test_fused_cross_autograd_on_cuda_matches_cpu(cuda):
    # the cross-Gram's closed-form backward (r by direct differences on
    # both devices) gives equal gradients to round-off; the forward
    # differs at the coincident pairs, where the card's direct
    # differences give r = 0 exactly and the plain version's expansion
    # sqrt(round-off) ~ 1e-8
    from gp_ss_ak_torch.ops.fused import fused_expans_bias_cross

    Z, X = _coincident_sets(cuda, seed=21)
    G = torch.randn(24, 40, dtype=torch.float64, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (
            Z, X, torch.tensor(SIGMA, dtype=torch.float64),
            torch.tensor(BIAS, dtype=torch.float64))]
        before = pairwise.launches
        K = fused_expans_bias_cross(*leaves)
        if dev.type == "cuda":
            assert pairwise.launches == before + 1
        out[dev.type] = (K.detach().cpu(), [g.cpu() for g in
                         torch.autograd.grad((K * G.to(dev)).sum(), leaves)])
    Kc, Kp = out["cuda"][0], out["cpu"][0]
    same = torch.cdist(Z, X).cpu() == 0
    assert int(same.sum()) == 8
    assert torch.all(Kc[same] == SIGMA * SIGMA + BIAS)
    np.testing.assert_allclose(Kc[~same], Kp[~same], rtol=0,
                               atol=1e-10 * SCALE)
    np.testing.assert_allclose(Kc[same], Kp[same], rtol=0, atol=1e-7)
    for gc, gp in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(gc, gp, rtol=1e-9, atol=1e-9)


def test_sgpr_on_cuda_matches_cpu(cuda):
    # float64, inducing points on a subset of the data: one square and
    # one cross K1 launch per evaluation of the bound. The forwards differ
    # by ~1e-8 at the coincident pairs (the card's r is 0 there, the
    # plain version's expansion leaves sqrt(round-off);
    # tests/test_torch_sgpr.py), which moves the value by ~1e-9 (measured
    # 1.07e-9 on an H100): the value is held at 1e-8, the hyperparameter
    # gradient at 1e-8, the Z gradient within 1e-7 of its largest entry
    from gp_ss_ak_torch.inference import sgpr
    from gp_ss_ak_torch.model import default_model

    rng = np.random.default_rng(4)
    X = rng.uniform(-1, 1, (300, 3))
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=300)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = default_model(3, dtype=torch.float64, device=dev)
        Xd = torch.as_tensor(X, device=dev)
        flat = model.pack().detach().clone().requires_grad_()
        Z = sgpr.init_inducing(Xd, 40, seed=1).clone().requires_grad_()
        before = pairwise.launches
        kp = model.kernel.unpack(flat[:model.kernel.n_params])
        v = sgpr.neg_elbo(model.kernel, kp, flat[model.kernel.n_params:],
                          Xd, torch.as_tensor(y, device=dev), Z)
        if dev.type == "cuda":
            assert pairwise.launches == before + 2
        gf, gz = torch.autograd.grad(v, [flat, Z])
        out[dev.type] = (v.item(), gf.cpu().numpy(), gz.cpu().numpy())
    (vc, gfc, gzc), (vp, gfp, gzp) = out["cuda"], out["cpu"]
    assert vc == pytest.approx(vp, rel=1e-8)
    np.testing.assert_allclose(gfc, gfp, rtol=1e-8,
                               atol=1e-8 * np.abs(gfp).max())
    np.testing.assert_allclose(gzc, gzp, rtol=0,
                               atol=1e-7 * np.abs(gzp).max())


def test_bf16_operator_on_cuda_matches_cpu(cuda, monkeypatch):
    # the card's bf16 store is built in row blocks by K1's cross entry
    # (one launch a block) and multiplied by one cuBLAS GEMM with a
    # float32 output; on the same stored K the CPU's float32 blocks give
    # the product within 1e-5 of max |y|, and the two builds differ by a
    # bfloat16 rounding here and there
    X = _points(1000, 3, cuda, seed=9).float()
    V = torch.randn(1000, 5, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    monkeypatch.setattr(matvec, "NARROW_BUILD_ELEMS", 256 * 1000)
    before = pairwise.launches
    opc = matvec.MaterializedOperator(X, SIGMA, BIAS, SN2,
                                      store_dtype=torch.bfloat16)
    assert pairwise.launches == before + 4
    opp = matvec.MaterializedOperator(X.cpu(), SIGMA, BIAS, SN2,
                                      store_dtype=torch.bfloat16)
    Ac, Ap = opc.A.float().cpu(), opp.A.float()
    flips = Ac != Ap
    assert int(flips.sum()) <= 1e-3 * Ac.numel()
    assert torch.equal(opc.A.diagonal().cpu(), opp.A.diagonal())
    opp.A = opc.A.cpu()
    Yc, Yp = opc.matmat(V).cpu(), opp.matmat(V.cpu())
    assert Yc.dtype == torch.float32
    np.testing.assert_allclose(Yc, Yp, rtol=0,
                               atol=1e-5 * Yp.abs().max().item())


def test_laplace_on_cuda_matches_cpu(cuda):
    # float64: K and kX by K1 on the card (two launches), the Newton
    # iteration's steps and line-search evaluations equal the CPU's
    from gp_ss_ak_torch.inference import laplace
    from gp_ss_ak_torch.model import default_model

    rng = np.random.default_rng(6)
    X = rng.uniform(-1, 1, (200, 3))
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=200)
    Xs = rng.uniform(-1, 1, (50, 3))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = default_model(3, dtype=torch.float64, device=dev)
        hyp = model.lik_hypers

        def log_prob(yy, f):
            return model.likelihood.log_prob(hyp, yy, f)

        stats = {}
        before = pairwise.launches
        mu, var = laplace.predict_latent(
            model.kernel, model.kernel_params, torch.as_tensor(X, device=dev),
            torch.as_tensor(y, device=dev), log_prob,
            torch.as_tensor(Xs, device=dev), stats=stats)
        if dev.type == "cuda":
            assert pairwise.launches == before + 2
        out[dev.type] = (mu.cpu().numpy(), var.cpu().numpy(), stats)
    (mc, vc, sc), (mp, vp, sp) = out["cuda"], out["cpu"]
    assert sc["newton_iters"] == sp["newton_iters"]
    np.testing.assert_allclose(mc, mp, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(vc, vp, rtol=1e-8, atol=1e-9)


def test_nan_debug_and_checked_on_cuda(cuda):
    from gp_ss_ak_torch.utils.debug import checked, nan_debug

    x = torch.tensor([1.0, -1.0], device=cuda)
    with nan_debug():
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
    err, out = checked(torch.log)(x)
    assert err.get() is not None and out.is_cuda
    err, _ = checked(torch.exp)(x)
    assert err.get() is None


def _mesh_case(seed=12, n=70, d=3):
    from gp_ss_ak_torch.model import default_model

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=n)
    model = default_model(d, dtype=torch.float64, device="cpu")
    flat = model.pack() * torch.as_tensor(rng.uniform(0.8, 1.2,
                                                      model.n_params))
    return model, flat, X, y


def test_dist_nlml_on_cuda_matches_cpu(cuda):
    """The row-split exact NLML on a mesh of one rank: NCCL on the card
    (the panel through K1's cross entry, two launches an evaluation: the
    panel, and its rebuild under autograd for the QW contraction) against
    gloo on the CPU (kernel.matrix), float64, value rtol 1e-10 and
    gradient 1e-8 of its largest entry; then the predict."""
    from gp_ss_ak_torch import parallel as tp

    model, flat, X, y = _mesh_case()
    out = []
    for dev in (cuda, torch.device("cpu")):
        mesh = tp.make_mesh(dev)
        Xl, yl, n, _ = tp.shard_training_data(mesh, torch.as_tensor(X),
                                              torch.as_tensor(y), nb=16)
        f = tp.make_dist_nlml_and_grad(model.kernel, model.likelihood, mesh,
                                       n, nb=16, grad_mode="exact")
        before = pairwise.launches
        v, g = f(flat.to(dev), Xl, yl)
        mu, var = tp.make_dist_predict(model.kernel, model.likelihood, mesh,
                                       n, nb=16)(
            flat.to(dev), Xl, yl, torch.as_tensor(X[:9] + 0.05, device=dev))
        if dev.type == "cuda":
            assert pairwise.launches - before == 2 + 2   # NLML, predict
        out.append([t.cpu().numpy() for t in (v, g, mu, var)])
    (vc, gc, muc, varc), (vh, gh, muh, varh) = out
    np.testing.assert_allclose(vc, vh, rtol=1e-10)
    np.testing.assert_allclose(gc, gh, rtol=0, atol=1e-8 * np.abs(gh).max())
    np.testing.assert_allclose(muc, muh, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(varc, varh, rtol=1e-9, atol=1e-12)


def test_ring_nlml_on_cuda_matches_cpu(cuda):
    """The ring NLML on a mesh of one rank, its tiles through K1's cross
    entry on the card, against the CPU on the same probes, float64,
    tile chunks of 24 rows (a shorter last one): value and gradient rtol
    1e-8, the same CG iteration count."""
    from gp_ss_ak_torch import parallel as tp

    model, flat, X, y = _mesh_case()
    out = []
    for dev in (cuda, torch.device("cpu")):
        mesh = tp.make_mesh(dev)
        Xl, yl, n, _ = tp.shard_training_data(mesh, torch.as_tensor(X),
                                              torch.as_tensor(y), nb=8)
        f = tp.make_ring_nlml_and_grad(
            model.kernel, mesh, n, precond_rank=8, probes=4, slq_probes=4,
            lanczos_iters=8, cg_tol=1e-10, cg_maxiter=500, with_stats=True,
            tile_chunk=24)
        before = pairwise.launches
        v, g, st = f(flat.to(dev), Xl, yl)
        if dev.type == "cuda":
            assert pairwise.launches > before
        out.append([t.cpu().numpy() for t in (v, g, st)])
    (vc, gc, sc), (vh, gh, sh) = out
    np.testing.assert_allclose(vc, vh, rtol=1e-8)
    np.testing.assert_allclose(gc, gh, rtol=0, atol=1e-8 * np.abs(gh).max())
    assert sc[0] == sh[0]
