"""The pivoted Cholesky (inference/iterative.py's `pivoted_cholesky`,
ops/pivchol.py) on the CPU, where the plain loop stands in for the CUDA
kernel K6.

A CPU tensor runs `pivoted_cholesky_plain`, the loop of torch ops that
follows the JAX package step by step: in float64 the two factors agree
to rtol 1e-10 of the largest entry (the order of the sums inside each
framework's products alone), so the pivots agree, and no K6 launch is
counted. K6's launch plan (`pivchol_plan`) is a pure function of n and
the type: its blocks own consecutive slices of points that cover each
point exactly once, and its row stride is the first multiple of 32 at
or past n, so every row of L^T starts 16-byte aligned.

tests/golden/pivchol_jax.npz holds the JAX package's float64 factor at
two shapes, (4096, 256, 3) and the ragged (1237, 96, 2), for the card
test that holds K6 to it (tests/test_torch_gpu.py, where jax is not
imported): the points, every column's pivot and 4096 sampled entries of
L L^T. Here the file is held to a fresh JAX factor, and the plain loop
to the file by the card test's own limits. Written by

    PYTHONPATH=. python tests/test_torch_pivchol.py     (from the root)

At both shapes the two largest residuals of every step after the first
differ by 1e-5 of the larger or more, far above float64's round-off, so
each implementation picks every pivot as JAX does.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_ss_ak_tpu.inference import iterative as ji
from gp_ss_ak_torch.inference import iterative as ti
from gp_ss_ak_torch.ops import pivchol

SIGMA, BIAS = 0.9, 0.3
RTOL = 1e-10
JAX_FILE = os.path.join(os.path.dirname(__file__), "golden",
                        "pivchol_jax.npz")
#: (n, rank, d, seed) of the stored JAX factors
JAX_CASES = ((4096, 256, 3, 1), (1237, 96, 2, 2))


@pytest.fixture(autouse=True)
def one_thread():
    # six pytest workers at a thread per core oversubscribe the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(n, d, seed):
    return 2.0 * np.random.default_rng(seed).uniform(-1, 1, (n, d))


@pytest.mark.parametrize("n,rank,d", [(1, 4, 3), (37, 64, 2), (150, 40, 3),
                                      (300, 64, 5)])
def test_cpu_call_is_the_plain_loop_and_launches_nothing(n, rank, d):
    X = _points(n, d, seed=n + rank)
    before = pivchol.launches
    L = ti.pivoted_cholesky(torch.from_numpy(X), SIGMA, BIAS, rank)
    assert pivchol.launches == before
    Lp = ti.pivoted_cholesky_plain(torch.from_numpy(X), SIGMA, BIAS, rank)
    assert torch.equal(L, Lp)
    Lj = np.asarray(ji.pivoted_cholesky(jnp.asarray(X), SIGMA, BIAS, rank))
    np.testing.assert_allclose(L.numpy(), Lj, rtol=RTOL,
                               atol=RTOL * np.abs(Lj).max())
    if rank > n:        # every point pivoted: the rest are zero columns
        assert not L[:, n:].any()


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1023, 4096, 16384, 33793,
                               100000, 150001])
def test_plan_covers_every_point_once(n, itemsize):
    ld, splits, per_block, blocks = pivchol.pivchol_plan(n, itemsize)
    assert splits in pivchol.SPLITS
    assert per_block * splits == pivchol.THREADS * 16 // itemsize
    assert ld % pivchol.LD_ALIGN == 0 and n <= ld < n + pivchol.LD_ALIGN
    # block b owns [b * per_block, (b + 1) * per_block) below n: every
    # point once, no block without a point
    owner = np.zeros(n, dtype=np.int64)
    for b in range(blocks):
        lo, hi = b * per_block, min((b + 1) * per_block, n)
        assert lo < hi
        owner[lo:hi] += 1
    assert (owner == 1).all()
    # the fewest splits that reach MIN_BLOCKS blocks, else the most
    if blocks < pivchol.MIN_BLOCKS:
        assert splits == pivchol.SPLITS[-1]
    elif splits != pivchol.SPLITS[0]:
        fewer = pivchol.SPLITS[pivchol.SPLITS.index(splits) - 1]
        assert -(-n // (per_block * splits // fewer)) < pivchol.MIN_BLOCKS
    assert pivchol.pivchol_plan(n, itemsize) == (ld, splits, per_block,
                                                 blocks)


def test_kernel_wrapper_takes_no_cpu_tensor():
    X = torch.from_numpy(_points(64, 3, seed=1))
    with pytest.raises(ValueError):
        pivchol.pivoted_cholesky(X, SIGMA, BIAS, 8)


# --- the stored JAX factor that the card test holds K6 to ---

def _jax_entries(n, rank, d, seed):
    """The case's points, JAX's float64 factor, and 4096 sampled pairs
    (p, q): the points from numpy's legacy RandomState, whose stream
    numpy keeps fixed."""
    rs = np.random.RandomState(seed)
    X = 2.0 * rs.uniform(-1, 1, (n, d))
    p = rs.randint(0, n, 4096).astype(np.int32)
    q = rs.randint(0, n, 4096).astype(np.int32)
    L = np.asarray(ji.pivoted_cholesky(jnp.asarray(X), SIGMA, BIAS, rank))
    return X, L, p, q


def _pivots_and_entries(L, p, q):
    """Each column's pivot (its largest entry) and (L L^T)(p, q)."""
    L = np.asarray(L, np.float64)
    return np.abs(L).argmax(0), np.einsum("ij,ij->i", L[p], L[q])


def write_jax_reference(path=JAX_FILE):
    out = {}
    for n, rank, d, seed in JAX_CASES:
        X, L, p, q = _jax_entries(n, rank, d, seed)
        piv, ent = _pivots_and_entries(L, p, q)
        key = f"n{n}_r{rank}_d{d}"
        out.update({f"{key}_X": X, f"{key}_p": p, f"{key}_q": q,
                    f"{key}_pivots": piv.astype(np.int32),
                    f"{key}_entries": ent})
    np.savez_compressed(path, **out)


@pytest.mark.parametrize("n,rank,d,seed", JAX_CASES)
def test_stored_jax_factor_is_jax_s(n, rank, d, seed):
    z = np.load(JAX_FILE)
    key = f"n{n}_r{rank}_d{d}"
    X, L, p, q = _jax_entries(n, rank, d, seed)
    np.testing.assert_array_equal(z[f"{key}_X"], X)
    np.testing.assert_array_equal(z[f"{key}_p"], p)
    np.testing.assert_array_equal(z[f"{key}_q"], q)
    piv, ent = _pivots_and_entries(L, p, q)
    np.testing.assert_array_equal(z[f"{key}_pivots"], piv)
    np.testing.assert_allclose(z[f"{key}_entries"], ent, rtol=0,
                               atol=1e-12 * (SIGMA ** 2 + BIAS))


@pytest.mark.parametrize("n,rank,d,seed", JAX_CASES)
def test_plain_loop_matches_stored_jax_factor(n, rank, d, seed):
    """The card test's check (tests/test_torch_gpu.py
    `test_pivchol_kernel_matches_jax_factor`) on the plain loop: every
    pivot JAX's, entries of L L^T within RTOL (s2 + bias)."""
    z = np.load(JAX_FILE)
    key = f"n{n}_r{rank}_d{d}"
    L = ti.pivoted_cholesky(torch.from_numpy(z[f"{key}_X"]), SIGMA, BIAS,
                            rank)
    piv, ent = _pivots_and_entries(L.numpy(), z[f"{key}_p"], z[f"{key}_q"])
    np.testing.assert_array_equal(piv, z[f"{key}_pivots"])
    assert np.abs(ent - z[f"{key}_entries"]).max() \
        <= RTOL * (SIGMA ** 2 + BIAS)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_jax_reference()
