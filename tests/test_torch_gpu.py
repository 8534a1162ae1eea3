"""The hand-written CUDA kernels K1, K2, K3, K4 and K6, and the training
path, on the card (marker `gpu`).

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
K4 (the gradient's contraction, float32 only) is held to its plain
version evaluated in float64 on the same inputs, TOL_K4 of each output's
largest entry: each row's t and g sum n float32 terms of mixed sign.
K6 (the pivoted Cholesky's steps) is held to the plain loop on the card
in its own type: the same pivots, and the factor's products to 1e-4 of
the scale (the two differ by the order of the dot product's sums); and
in float64 to the JAX package's factor, stored with the points in
tests/golden: every pivot, and the products to 1e-10 of the scale.
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
gloo on the CPU, in float64. The segmented evaluator (float32, K3 on the
card against its plain version on the CPU) is held as two float32
implementations of one estimator (tests/test_torch_segmented.py): CG
iterations within 1, value rel 1e-4, gradient rtol 1e-3 with atol 1e-3
of its largest entry; on the card, its warm start against a cold start
as tests/test_torch_segmented.py holds them on the CPU. A failed solve
(gemm_bf16 here) gives a NaN value and gradient on the card as on the
CPU. The four example workflows run at their default sizes, each held
to its own checks.
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
TOL_K4 = 1e-5


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


#: the register tiles' widths around the main path's B = 9 and 32 and
#: the column groups past 32, at ragged n, for d <= 3 and the general
#: kernel (d = 4, 7)
REGISTER_CASES = [(n, b, d) for b in (9, 12, 16, 17, 31, 32, 33, 63, 64)
                  for n in (37, 257, 4097) for d in (1, 2, 3, 4, 7)]


@pytest.mark.parametrize("n,b,d", list(dict.fromkeys(
    [(1, 1, 3), (37, 1, 3), (130, 7, 4), (1000, 8, 3), (1000, 9, 3),
     (257, 64, 5), (4097, 65, 2), (300, 130, 3),
     # the narrow register widths and the tensor-core tile's edges, at
     # ragged n
     (130, 2, 3), (130, 3, 2), (4097, 5, 3), (130, 16, 3), (4097, 16, 3),
     (130, 17, 4), (4097, 17, 3), (130, 64, 3), (4097, 64, 3), (130, 65, 3),
     (130, 128, 4), (4097, 128, 3), (130, 129, 3), (4097, 129, 5),
     (130, 1024, 3), (4097, 1024, 3)] + REGISTER_CASES)))
def test_matmat_kernel_matches_plain(cuda, n, b, d):
    Xk, scal, V = _matmat_case(n, b, d, cuda, seed=n + b)
    route = matvec.matmat_route(b)[0]
    before, routed = matvec.launches, matvec.route_launches[route]
    Y = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V, d)
    torch.cuda.synchronize()
    assert matvec.launches == before + 1
    assert matvec.route_launches[route] == routed + 1
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


@pytest.mark.parametrize("b", [1, 2, 8, 9, 12, 16, 24, 32, 33, 64, 257,
                               1024])
@pytest.mark.parametrize("d", [3, 7])
def test_matmat_tiles_are_repeatable(cuda, b, d):
    # every register width (with its column groups past 32) and the
    # tensor-core tile: equal bits
    Xk, scal, V = _matmat_case(2049, b, d, cuda, seed=b)
    assert torch.equal(matvec.streamed_matmat(Xk, scal, BIAS, SN2, V, d),
                       matvec.streamed_matmat(Xk, scal, BIAS, SN2, V, d))


@pytest.mark.parametrize("b", [8, 9, 12, 16, 17, 31, 32, 33, 63])
def test_matmat_16_wide_tile_equals_the_middle_tile(cuda, b):
    # column b's bits do not depend on B: every register width from 8 on
    # (one ex2 split, none of it on the polynomial) sums each output over
    # j in one order from the same Gram values, so B columns equal the
    # same V zero-padded to 64 (two groups of 32). No bias or noise:
    # torch's column sums of (n, b) and (n, 64) tensors need not agree in
    # bits
    Xk, scal, V = _matmat_case(3001, b, 3, cuda, seed=10)
    V64 = torch.zeros(3001, 64, device=cuda)
    V64[:, :b] = V
    Y = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, V, 3)
    Y64 = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, V64, 3)
    assert torch.equal(Y, Y64[:, :b])


@pytest.mark.parametrize("b", [1, 5, 8, 9, 16, 32, 64])
@pytest.mark.parametrize("d", [3, 4])
def test_matmat_diagonal_is_exactly_s2(cuda, b, d):
    # unit columns pick out Gram columns; at i == j the kernel gives s2
    # itself (d2 = 0 exactly, so exp(-0) = 1 in both classes of its ex2
    # split), not s2 * exp(-sqrt(round-off))
    n = 300
    Xk, scal, _ = _matmat_case(n, 1, d, cuda, seed=4)
    rows = torch.tensor([0, 1, 127, 128, 299], device=cuda)[
        torch.arange(b, device=cuda) % 5]
    cols = torch.arange(b, device=cuda)
    E = torch.zeros(n, b, device=cuda)
    E[rows, cols] = 1.0
    Y = matvec.streamed_matmat(Xk, scal, 0.0, 0.0, E, d)
    assert torch.equal(Y[rows, cols], scal.expand(b))


def _block_shares(Y, ref, V, rows=32):
    """Each `rows`-row block's worst column error against its plain
    version in float64, as a share of the card tests' K3 tolerance."""
    tol = (TOL_K3 * SCALE * V.double().abs().sum(0)
           + 4 * torch.finfo(torch.float32).eps * ref.abs().max(0).values)
    err = ((Y.double() - ref).abs() / tol).amax(dim=1)
    return torch.stack([blk.max() for blk in err.split(rows)])


def test_matmat_every_32_row_block_matches_plain(cuda):
    # SLQ's products (B = 32) block by block: every 32-row block of K3's
    # output at N = 4097 within tolerance of the plain version in
    # float64, at a tolerance that a zeroed block fails (planted here in
    # every block at once: the blocks are judged apart)
    n, b = 4097, 32
    Xk, scal, V = _matmat_case(n, b, 3, cuda, seed=21)
    Y = matvec.streamed_matmat(Xk, scal, BIAS, SN2, V, 3)
    ref = matvec.streamed_matmat_plain(Xk.double(), scal.double(), BIAS,
                                       SN2, V.double())
    shares = _block_shares(Y, ref, V)
    assert shares.numel() == -(-n // 32)
    assert bool((shares <= 1.0).all())
    assert bool((_block_shares(torch.zeros_like(Y), ref, V) > 1.0).all())


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

@pytest.mark.parametrize("n,d", [(1, 3), (37, 2), (37, 3), (130, 4),
                                 (257, 5), (1000, 3), (1000, 4), (4097, 2),
                                 (4097, 3), (5000, 5), (20000, 3)])
def test_matvec_kernel_matches_plain(cuda, n, d):
    # d <= 3 takes the packed kernel, d = 4 and 5 the general path
    Xk, scal, V = _matmat_case(n, 1, d, cuda, seed=n + d)
    v = V[:, 0].contiguous()
    before = matvec.matvec_launches
    y = matvec.streamed_matvec(Xk, scal, BIAS, SN2, v, d)
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
    # columns 0-7 of every group of 8 cover both classes of the ex2
    # split (ops/matvec.py); 256 and 512 start the second and third slab;
    # d = 3 takes the packed kernel, the padded width the general path
    n = 700
    Xk, scal, _ = _matmat_case(n, 1, 3, cuda, seed=4)
    assert matvec.matvec_slabs(n, torch.cuda.get_device_properties(
        cuda).multi_processor_count)[1] == 3
    for d in (3, None):
        for i in (*range(8), 255, 256, 259, 511, 512, 517, 699):
            e = torch.zeros(n, device=cuda)
            e[i] = 1.0
            y = matvec.streamed_matvec(Xk, scal, 0.0, 0.0, e, d)
            assert y[i].item() == scal.item(), (d, i)


def test_matvec_far_pairs_are_finite_and_tiny(cuda):
    # two clusters at metric distance >= 200: exp(-200) is far below
    # float32's normal range; MUFU flushes it to 0, the polynomial
    # returns its 2^-126 floor; both classes of the split are probed
    n = 64
    X = torch.zeros(n, 3, device=cuda)
    X[:, 1] = torch.linspace(0.0, 1.0, n, device=cuda)
    X[n // 2:, 0] = 250.0
    Xk, scal = matvec.operator_arrays(X, SIGMA)
    for j in range(n // 2, n // 2 + 8):
        e = torch.zeros(n, device=cuda)
        e[j] = 1.0
        y = matvec.streamed_matvec(Xk, scal, 0.0, 0.0, e, 3)
        assert bool(torch.isfinite(y).all()) and bool((y >= 0).all())
        assert y[:n // 2].max().item() < 1e-30 * scal.item()
        assert y[j].item() == scal.item()


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


def _contraction_case(n, d, k, cuda, seed):
    """Points, c * U and V of a rank-k contraction: U holds k - 1 probe
    solves (normal, scale 3) and alpha, V the probes (+-1) and alpha,
    c = [1/(k-1).., -1]; points 3 and 7 coincide (n > 7)."""
    X = _points(n, d, cuda, seed).float()
    if n > 7:
        X[7] = X[3]
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    alpha = torch.randn(n, 1, generator=g, device=cuda)
    W = 3.0 * torch.randn(n, k - 1, generator=g, device=cuda)
    Z = torch.randint(0, 2, (n, k - 1), generator=g, device=cuda) * 2.0 - 1
    coef = torch.tensor([1.0 / (k - 1)] * (k - 1) + [-1.0], device=cuda)
    cU = (torch.cat([W, alpha], 1) * coef).contiguous()
    V = torch.cat([Z, alpha], 1).contiguous()
    return X.contiguous(), cU, V


@pytest.mark.parametrize("n,d,k", [(1, 3, 9), (37, 2, 5), (130, 1, 9),
                                   (257, 5, 9), (4097, 3, 9),
                                   (4097, 3, 17), (5000, 3, 33),
                                   (20000, 3, 9), (20000, 3, 17)])
def test_contraction_kernel_matches_plain(cuda, n, d, k):
    """K4 (ops/contraction.py) against its plain version in float64 on
    the same float32 inputs: t and g within TOL_K4 of their largest
    entries (each a float32 sum of n terms of mixed sign); d = 4..16
    take the general instance; two launches give equal bits."""
    from gp_ss_ak_torch.ops import contraction

    X, cU, V = _contraction_case(n, d, k, cuda, seed=n + d + k)
    before = contraction.launches
    t, g = contraction.expans_contraction(X, cU, V)
    t2, g2 = contraction.expans_contraction(X, cU, V)
    torch.cuda.synchronize()
    assert contraction.launches == before + 2
    assert t.dtype == g.dtype == torch.float32
    assert tuple(t.shape) == (n,) and tuple(g.shape) == (n, d)
    assert torch.equal(t, t2) and torch.equal(g, g2)
    t64, g64 = contraction.expans_contraction_plain(
        X.double(), cU.double(), V.double())
    for got, want in ((t, t64), (g, g64)):
        err = (got.double() - want).abs().max().item()
        assert err <= TOL_K4 * want.abs().max().item()
    assert torch.isfinite(g).all()


def test_grad_contraction_is_one_launch_on_cuda(cuda):
    """`_grad_contraction` on the card: one K4 launch a call at rank 9
    and 17, two past MAX_RANK (column groups), and the four gradients
    within TOL_K4 of the closed form in float64 on the same inputs (the
    plain version on the card, the O(N m) terms in float64)."""
    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.ops import contraction

    n = 3000
    X = _points(n, 3, cuda, seed=12).float()
    g = torch.Generator(device=cuda).manual_seed(13)
    for probes, launches in ((8, 1), (16, 1), (40, 2)):
        alpha = torch.randn(n, generator=g, device=cuda)
        ws = 3.0 * torch.randn(probes, n, generator=g, device=cuda)
        zs = torch.randint(0, 2, (probes, n), generator=g,
                           device=cuda) * 2.0 - 1
        gp = ti.IterativeGP(X, torch.tensor(SIGMA, device=cuda),
                            torch.tensor(BIAS, device=cuda),
                            torch.tensor(SN2, device=cuda))
        before = contraction.launches
        got = ti._grad_contraction(gp, alpha, ws, zs, 1024)
        assert contraction.launches - before == launches
        coef = torch.tensor([1.0 / probes] * probes + [-1.0],
                            dtype=torch.float64, device=cuda)
        cU = torch.cat([ws.T, alpha[:, None]], 1).double() * coef
        V = torch.cat([zs.T, alpha[:, None]], 1).double()
        t, gr = contraction.expans_contraction_plain(X.double(), cU, V)
        want = (SIGMA * t.sum(), 0.5 * torch.dot(cU.sum(0), V.sum(0)),
                0.5 * torch.sum(cU * V), -0.5 * SIGMA ** 2 * gr)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == torch.float32
            err = (a.double() - b).abs().max().item()
            assert err <= TOL_K4 * b.abs().max().item()


def test_contraction_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from gp_ss_ak_torch.ops import contraction

    X, cU, V = _contraction_case(64, 3, 9, cuda, seed=3)
    with pytest.raises(TypeError):
        contraction.expans_contraction(X.double(), cU, V)
    with pytest.raises(TypeError):
        contraction.expans_contraction(X, cU.double(), V.double())
    with pytest.raises(ValueError):
        contraction.expans_contraction(X.T.contiguous().T, cU, V)
    with pytest.raises(ValueError):
        contraction.expans_contraction(X, cU[:, ::2], V[:, ::2])
    wide = torch.zeros(64, contraction.MAX_RANK + 1, device=cuda)
    with pytest.raises(ValueError):
        contraction.expans_contraction(X, wide, wide)
    with pytest.raises(ValueError):
        contraction.expans_contraction(torch.zeros(64, 17, device=cuda), cU,
                                       V)


# --- K6, the pivoted Cholesky's steps ---

def _trace_residual(L, s2b):
    """trace(K - L L^T) = n (s2 + bias) - ||L||_F^2, in float64."""
    L64 = L.double()
    return L.shape[0] * s2b - float((L64 * L64).sum())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n,rank,d", [(1, 4, 3), (37, 64, 2),
                                      (4096, 256, 3), (16384, 341, 3),
                                      (100000, 1024, 3)])
def test_pivchol_kernel_matches_plain(cuda, n, rank, d, dtype):
    """K6 against the plain loop on the card: the first 64 pivots (each
    column's largest entry is its pivot's), the trace of K - L L^T within
    1e-4 relative (plus 8 ulps of trace K: at full rank the residual is
    itself round-off), 4096 sampled entries of L L^T within 1e-4
    (s2 + bias), two calls bit for bit, `rank` launches a call, zero
    columns past n."""
    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.ops import pivchol

    X = _points(n, d, cuda, seed=n + rank).to(dtype)
    before = pivchol.launches
    L = ti.pivoted_cholesky(X, SIGMA, BIAS, rank)
    L2 = ti.pivoted_cholesky(X, SIGMA, BIAS, rank)
    assert pivchol.launches == before + 2 * rank
    assert torch.equal(L, L2)
    Lp = ti.pivoted_cholesky_plain(X, SIGMA, BIAS, rank)
    assert L.dtype == dtype and L.shape == Lp.shape == (n, rank)
    k = min(64, rank, n)
    assert torch.equal(L[:, :k].abs().argmax(0), Lp[:, :k].abs().argmax(0))
    tr, trp = _trace_residual(L, SCALE), _trace_residual(Lp, SCALE)
    assert abs(tr - trp) <= 1e-4 * abs(trp) \
        + 8 * torch.finfo(dtype).eps * n * SCALE
    g = torch.Generator(device=cuda).manual_seed(rank)
    p = torch.randint(0, n, (4096,), generator=g, device=cuda)
    q = torch.randint(0, n, (4096,), generator=g, device=cuda)
    L64, Lp64 = L.double(), Lp.double()
    ent = (L64[p] * L64[q]).sum(1) - (Lp64[p] * Lp64[q]).sum(1)
    assert float(ent.abs().max()) <= 1e-4 * SCALE
    if rank > n:
        assert not L[:, n:].any() and not Lp[:, n:].any()


@pytest.mark.parametrize("n,rank,d", [(4096, 256, 3), (1237, 96, 2)])
def test_pivchol_kernel_matches_jax_factor(cuda, n, rank, d):
    """K6 in float64 against the JAX package's factor on the same points
    (tests/golden/pivchol_jax.npz, written on the CPU and held to a fresh
    JAX factor by tests/test_torch_pivchol.py): every column's pivot
    JAX's, and 4096 sampled entries of L L^T within 1e-10 (s2 + bias),
    the limit the plain loop meets against JAX on the CPU."""
    from gp_ss_ak_torch.inference import iterative as ti

    sigma, bias = 0.9, 0.3                  # tests/test_torch_pivchol.py
    z = np.load(os.path.join(GOLDEN, "pivchol_jax.npz"))
    key = f"n{n}_r{rank}_d{d}"
    X = torch.from_numpy(z[f"{key}_X"]).to(cuda)
    L = ti.pivoted_cholesky(X, sigma, bias, rank)
    assert L.is_cuda and L.dtype == torch.float64
    L = L.cpu().numpy()
    np.testing.assert_array_equal(np.abs(L).argmax(0), z[f"{key}_pivots"])
    p, q = z[f"{key}_p"], z[f"{key}_q"]
    ent = np.einsum("ij,ij->i", L[p], L[q])
    assert np.abs(ent - z[f"{key}_entries"]).max() \
        <= 1e-10 * (sigma ** 2 + bias)


def test_pivchol_kernel_with_device_scalars(cuda):
    from gp_ss_ak_torch.inference import iterative as ti

    X = _points(4096, 3, cuda, seed=5).float()
    L = ti.pivoted_cholesky(X, SIGMA, BIAS, 64)
    Lt = ti.pivoted_cholesky(X, torch.tensor(SIGMA, device=cuda),
                             torch.tensor(BIAS, dtype=torch.float64,
                                          device=cuda), 64)
    assert torch.equal(L, Lt)


def test_iterative_evaluation_builds_its_preconditioner_with_k6(cuda):
    """`_pivchol` (every matrix-free evaluation's preconditioner) takes
    K6 on the card: auto_precond_rank(n) launches, no plain step."""
    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.ops import pivchol

    n = 4096
    gp = ti.IterativeGP(_points(n, 3, cuda, seed=9).float(),
                        torch.tensor(SIGMA, device=cuda),
                        torch.tensor(BIAS, device=cuda),
                        torch.tensor(SN2, device=cuda))
    before = pivchol.launches
    L = ti._pivchol(gp, None)
    assert pivchol.launches - before == ti.auto_precond_rank(n)
    assert torch.equal(L, ti.pivoted_cholesky(gp.Xm, gp.sigma, gp.bias,
                                              ti.auto_precond_rank(n)))


def test_pivchol_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from gp_ss_ak_torch.ops import pivchol

    X = _points(64, 3, cuda, seed=3).float()
    with pytest.raises(TypeError):
        pivchol.pivoted_cholesky(X.half(), SIGMA, BIAS, 8)
    with pytest.raises(TypeError):
        pivchol.pivoted_cholesky(X.to(torch.int32), SIGMA, BIAS, 8)
    with pytest.raises(ValueError):
        pivchol.pivoted_cholesky(X.T.contiguous().T, SIGMA, BIAS, 8)
    with pytest.raises(ValueError):
        pivchol.pivoted_cholesky(torch.zeros(64, pivchol.MAX_FEATURES + 1,
                                             device=cuda), SIGMA, BIAS, 8)
    with pytest.raises(ValueError):
        pivchol.pivoted_cholesky(X[:0], SIGMA, BIAS, 8)
    with pytest.raises(ValueError):
        pivchol.pivoted_cholesky(X[0], SIGMA, BIAS, 8)
    with pytest.raises(ValueError):
        pivchol.pivoted_cholesky(X, SIGMA, BIAS, -1)
    with pytest.raises(ValueError):
        pivchol.pivoted_cholesky(X.cpu(), SIGMA, BIAS, 8)


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


def test_segmented_on_cuda_matches_cpu(cuda):
    """optim/segmented.py at n = 4096 (rank auto_precond_rank = 85) on
    the card and on the CPU with the same probes, over a warm-started
    two-point sequence; and on the card, the second point warm against
    cold at JAX's test's cg_tol 1e-5 (tests/test_iterative.py:743-775;
    at the default 1e-3 two solves within tolerance leave this value,
    small beside its terms, 1.6e-4 apart): fewer CG iterations, the same
    value to 1e-4, the gradient to rtol 2e-3 / atol 1e-4 of its largest
    entry, and one K3 launch per CG iteration and Lanczos step, plus
    one for the warm residual."""
    from gp_ss_ak_torch.model import default_model
    from gp_ss_ak_torch.optim.segmented import make_segmented_value_and_grad

    n = 4096
    rng = np.random.default_rng(9)
    X = rng.uniform(-1, 1, (n, 3))
    y = np.sin(X @ np.array([1.0, 2.0, 3.0])) + 0.05 * rng.normal(size=n)
    Zl = np.where(rng.random((n, 32)) < 0.5, -1.0, 1.0)
    Zt = np.where(rng.random((n, 8)) < 0.5, -1.0, 1.0)
    x = default_model(3, dtype=torch.float32, device="cpu").pack().numpy()
    x = x.astype(np.float64)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model = default_model(3, dtype=torch.float32, device=dev)
        vg = make_segmented_value_and_grad(model, X, y, Z_logdet=Zl,
                                           Z_trace=Zt)
        runs[dev.type] = [(*vg(xi), vg.last_cg_iters)
                          for xi in (x, x * (1.0 + 1e-3))]
    for (vc, gc, kc), (vh, gh, kh) in zip(runs["cuda"], runs["cpu"]):
        assert abs(kc - kh) <= 1
        assert vc == pytest.approx(vh, rel=1e-4)
        np.testing.assert_allclose(gc, gh, rtol=1e-3,
                                   atol=1e-3 * np.abs(gh).max())
    model = default_model(3, dtype=torch.float32, device=cuda)
    cold, warm = (make_segmented_value_and_grad(
        model, X, y, Z_logdet=Zl, Z_trace=Zt, cg_tol=1e-5, warm_start=w)
        for w in (False, True))
    before, reg = matvec.launches, matvec.route_launches["register"]
    vc, gc = cold(x * (1.0 + 1e-3))
    assert matvec.launches - before == cold.last_cg_iters + 16
    # CG (B = 9) and SLQ (B = 32) ran on the register tiles
    assert matvec.route_launches["register"] - reg == \
        matvec.launches - before
    warm(x)
    before = matvec.launches
    vw, gw = warm(x * (1.0 + 1e-3))
    assert matvec.launches - before == warm.last_cg_iters + 16 + 1
    assert warm.last_cg_iters < cold.last_cg_iters
    assert warm.last_rel_residual <= 1e-5 * 1.05
    assert vw == pytest.approx(vc, rel=1e-4)
    np.testing.assert_allclose(gw, gc, rtol=2e-3,
                               atol=1e-4 * np.abs(gc).max())


def test_failed_gemm_bf16_solve_is_nan_on_cuda(cuda):
    """The NaN protocol of a failed solve (inference.iterative.
    solve_state) on the card: CG stopped before its first iteration
    leaves relative residual 1, so the evaluation is NaN; the same
    operator with its solve run converges."""
    from gp_ss_ak_torch.inference import iterative as ti

    n = 4096
    X = _points(n, 3, cuda, seed=11).float()
    y = torch.sin(X @ torch.tensor([3.0, 1.0, 2.0], device=cuda))
    gp = ti.IterativeGP(X, torch.tensor(SIGMA, device=cuda),
                        torch.tensor(BIAS, device=cuda),
                        torch.tensor(1.0, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(5)
    Zl, Zt = ti.rademacher(g, (n, 16)), ti.rademacher(g, (n, 4))
    kw = dict(mode="gemm_bf16", probes=4, slq_probes=16, lanczos_iters=8,
              precond_rank=64, Z_logdet=Zl, Z_trace=Zt)
    before = pairwise.launches
    val, grads, st = ti.nlml_and_grad_iterative(gp, y, None, None,
                                                cg_maxiter=0, **kw)
    assert pairwise.launches > before
    assert float(st.rel_residual) == 1.0
    assert np.isnan(float(val)) and all(torch.isnan(t).all() for t in grads)
    val, grads, st = ti.nlml_and_grad_iterative(gp, y, None, None, **kw)
    assert ti.solve_state(st.rel_residual, ti.BF16_CG_TOL_FLOOR) \
        == "converged"
    assert np.isfinite(float(val)) and all(torch.isfinite(t).all()
                                           for t in grads)


@pytest.mark.parametrize("name", ["full_workflow", "bayes_workflow",
                                  "distributed_workflow", "ring_workflow"])
def test_example_workflow_on_cuda_at_its_default_size(cuda, name):
    """Each example's main() on the card at its default size, float32:
    its own checks hold (the distributed workflow's dist-against-ring
    means, the ring workflow's held-out MSE), the full workflow's test
    MSE stays below 0.2 var(y) and the Bayes workflow's NUTS accepts in
    (0.3, 1) with every draw finite."""
    import importlib

    out = importlib.import_module(f"gp_ss_ak_torch.examples.{name}").main()
    if name == "full_workflow":
        assert out["mse"] < 0.2 * out["var_y"]
        assert torch.isfinite(out["theta"]).all()
    elif name == "bayes_workflow":
        assert torch.isfinite(out["theta"]).all()
        assert 0.3 < float(out["accept"].mean()) < 1.0
    elif name == "ring_workflow":
        assert out["mse"] < 0.1 and np.isfinite(out["cg_rel"])
    else:
        assert np.allclose(out["mu"], out["mu_ring"], atol=1e-3)
