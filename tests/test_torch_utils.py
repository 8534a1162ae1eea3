"""Port parity: utils/ (checkpoint, profiling, debug) and `fit`'s
checkpoints, on the CPU.

  * checkpoint: the files are the JAX package's, key for key, so a fit
    checkpointed by one package resumes in the other. A resumed fit
    starts from the checkpoint's x (its trace starts at the objective
    there) and, in float64 at n = 48, takes the JAX fit's path from the
    same file: the same iterations and stop reason, hyperparameters
    within rtol 1e-6 (tests/test_torch_optim.py's tolerance);
  * profiling: the flop counters equal JAX's; the timers and the trace
    run (a CPU time says nothing about the card, so no time is held);
  * debug: `nan_debug` raises at the first operation that makes a NaN,
    forward or backward, where `jax_debug_nans` raises on the same
    computation; `checked` reports a NaN or inf in the outputs where
    JAX's checkify reports one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_tpu.optim as jo
import gp_ss_ak_torch.model as tm
import gp_ss_ak_torch.optim as to
from gp_ss_ak_tpu.utils import checkpoint as jck
from gp_ss_ak_tpu.utils import debug as jdbg
from gp_ss_ak_tpu.utils import profiling as jprof
from gp_ss_ak_torch.utils import checkpoint as tck
from gp_ss_ak_torch.utils import debug as tdbg
from gp_ss_ak_torch.utils import profiling as tprof

F64 = torch.float64

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)


def data(n=48, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3))
    y = np.sin(X @ np.array([1.0, 2.0, 3.0])) + 0.05 * rng.normal(size=n)
    return X, y


def models():
    return (jm.default_model(3, dtype=jnp.float64),
            tm.default_model(3, dtype=F64, device="cpu"))


def same_fit(rt, rj):
    assert (rt.n_iters, rt.stop_reason) == (rj.n_iters, rj.stop_reason)
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-6, atol=1e-8)
    assert rt.fun == pytest.approx(rj.fun, rel=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_checkpoint_resumes_in_either_package(writer, tmp_path):
    X, y = data()
    mj, mt = models()
    path = str(tmp_path / "fit")
    # the first leg writes every 2 iterations; the fit stops at 5, so the
    # file holds iteration 4
    if writer == "jax":
        jo.fit(mj, X, y, iters=5, checkpoint_path=path, checkpoint_every=2)
    else:
        to.fit(mt, X, y, iters=5, checkpoint_path=path, checkpoint_every=2)
    ck_j, ck_t = jck.load_fit_checkpoint(path), tck.load_fit_checkpoint(path)
    assert ck_t["iteration"] == ck_j["iteration"] == 4
    np.testing.assert_array_equal(ck_t["x"], ck_j["x"])
    assert ck_t["fun"] == ck_j["fun"]
    with open(path + ".json") as f:
        assert json.load(f) == {"iteration": 4, "nlml": ck_t["fun"]}
    # both packages resume from the same file (no further saves: every 10)
    _, rj = jo.fit(mj, X, y, iters=6, checkpoint_path=path)
    _, rt = to.fit(mt, X, y, iters=6, checkpoint_path=path)
    same_fit(rt, rj)
    f0, _ = to.make_value_and_grad(mt, X, y)(ck_t["x"])
    assert rt.trace[0] == pytest.approx(f0, rel=1e-12)
    assert rt.trace[0] == pytest.approx(ck_t["fun"], rel=1e-9)
    # resume=False starts from the model's own hyperparameters
    _, fresh = to.fit(mt, X, y, iters=1, checkpoint_path=path, resume=False)
    f_model, _ = to.make_value_and_grad(mt, X, y)(
        mt.pack().detach().numpy())
    assert fresh.trace[0] == pytest.approx(f_model, rel=1e-12)


def test_the_device_loop_starts_from_a_checkpoint(tmp_path):
    X, y = data()
    mj, mt = models()
    path = str(tmp_path / "fit")
    jo.fit(mj, X, y, iters=4, checkpoint_path=path, checkpoint_every=2)
    x_ck = jck.load_fit_checkpoint(path)["x"]
    start = mt.unpack(torch.tensor(x_ck))
    _, r_resumed = to.fit(mt, X, y, optimizer="JIT", iters=3,
                          checkpoint_path=path)
    _, r_start = to.fit(start, X, y, optimizer="JIT", iters=3)
    np.testing.assert_array_equal(r_resumed.x, r_start.x)


def test_checkpoint_callback_cadence_matches_jax(tmp_path):
    seen_t, seen_j = [], []
    cb_t = tck.CheckpointCallback(str(tmp_path / "t"), every=3,
                                  inner=lambda *a: seen_t.append(a[0]))
    cb_j = jck.CheckpointCallback(str(tmp_path / "j"), every=3,
                                  inner=lambda *a: seen_j.append(a[0]))
    saved = []
    for it in range(1, 11):
        x = np.full(4, 0.1 * it)
        cb_t(it, x, 10.0 - it)
        cb_j(it, x, 10.0 - it)
        ct = tck.load_fit_checkpoint(str(tmp_path / "t"))
        cj = jck.load_fit_checkpoint(str(tmp_path / "j"))
        assert (ct is None) == (cj is None)
        if ct is not None:
            assert ct["iteration"] == cj["iteration"]
            np.testing.assert_array_equal(ct["x"], cj["x"])
            saved.append(ct["iteration"])
    assert sorted(set(saved)) == [3, 6, 9]
    assert seen_t == seen_j == list(range(1, 11))
    assert tck.CheckpointCallback("p", every=0).every == 1


@pytest.mark.parametrize("accept", [True, False])
def test_chains_round_trip_across_packages(accept, tmp_path):
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(4, 8, 10))
    acc = rng.uniform(size=(4, 8)) if accept else None
    tck.save_chains(str(tmp_path / "t.npz"), theta, acc)
    jck.save_chains(str(tmp_path / "j.npz"), theta, acc)
    for load in (tck.load_chains, jck.load_chains):
        for name in ("t", "j.npz"):
            th, ac = load(str(tmp_path / name))
            np.testing.assert_array_equal(th, theta)
            np.testing.assert_array_equal(ac, acc if accept
                                          else np.zeros(0))


def test_flop_counters_match_jax():
    for n, m, d in ((1, 1, 1), (4096, 4096, 3), (65536, 1024, 4)):
        assert tprof.gram_flops(n, m, d) == jprof.gram_flops(n, m, d)
        assert tprof.cholesky_flops(n) == jprof.cholesky_flops(n)
        assert tprof.solve_flops(n, m) == jprof.solve_flops(n, m)
        assert tprof.achieved_tflops(n * m, 0.5) == \
            jprof.achieved_tflops(n * m, 0.5)


def test_timers_and_trace_run(tmp_path):
    calls = []

    def step(z, s, A):
        calls.append(1)
        return torch.sum(A @ (z + s))

    A = torch.eye(8)
    sec = tprof.chain_timeit(step, torch.ones(8), reps=4, args=(A,))
    assert sec > 0 and len(calls) == 4 * (1 + 3)
    assert tprof.chain_timeit(step, torch.ones(8), reps=2, args=(A,),
                              subtract_null=False) > 0
    assert tprof.timeit_fn(torch.mm, A, A, reps=3) > 0
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.mm(A, A)
    path = tmp_path / "tr" / tprof.TRACE_FILE
    assert path.stat().st_size > 0
    assert "aten::mm" in path.read_text()
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_nan_debug_raises_at_the_first_nan_as_jax_does():
    x = torch.tensor([1.0, -1.0])
    with tdbg.nan_debug():
        y = x * 2.0                       # no NaN: runs
        with pytest.raises(FloatingPointError, match="sqrt"):
            torch.sqrt(y)
    assert y.tolist() == [2.0, -2.0]
    # the flag JAX's nan_debug sets (its context manager reads the flag
    # by an accessor this jax version refuses, so the flag is set here)
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jnp.sqrt(jnp.asarray([2.0, -2.0])).block_until_ready()
    # off, and outside the block, a NaN passes silently
    with tdbg.nan_debug(enable=False):
        assert torch.isnan(torch.sqrt(x)).any()
    assert torch.isnan(torch.sqrt(x)).any()
    # the backward's operations are checked too: sqrt'(0) = inf, times 0
    z = torch.zeros(1, requires_grad=True)
    out = (torch.sqrt(z) * 0.0).sum()
    with tdbg.nan_debug():
        with pytest.raises(FloatingPointError):
            out.backward()


def test_checked_reports_what_jax_checkify_reports():
    def f_t(x):
        return torch.log(x), x + 1.0

    def f_j(x):
        return jnp.log(x), x + 1.0

    for xs in ([1.0, 2.0], [1.0, -2.0], [0.0, 2.0]):
        err_t, out_t = tdbg.checked(f_t)(torch.tensor(xs, dtype=F64))
        err_j, out_j = jdbg.checked(f_j)(jnp.asarray(xs))
        np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
        bad = not np.isfinite(np.asarray(out_j[0])).all()
        assert (err_t.get() is not None) == bad
        if xs[1] < 0:   # NaN: JAX's float checks fire as well
            assert err_j.get() is not None
        if bad:
            with pytest.raises(FloatingPointError):
                err_t.throw()
        else:
            err_t.throw()
