"""The ranks of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_ring.py).

    python tests/torch_mesh_worker.py WORKDIR WORLD [WORLD ...]

One launcher process imports torch and the port once, then forks every
rank of every world size: WORKDIR/w{WORLD}/in.npz holds a world's
inputs. Each rank starts torch.distributed over gloo on the CPU from
torchrun's environment variables (through parallel.make_mesh), runs the
suite the input names, and writes its results to
WORKDIR/w{WORLD}/rank{RANK}.npz and its output to rank{RANK}.log there.
At the first rank that fails the launcher kills the others and exits 1.
It imports torch and gp_ss_ak_torch only, never jax or gp_ss_ak_tpu: the
parent test computes the JAX package's side.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import torch

F64 = torch.float64
CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _model(d, flat, likelihood=None):
    from gp_ss_ak_torch.model import from_flat

    return from_flat(["ExpAns", "Bias"], flat[:9], flat[9:], d, F64, CPU,
                     likelihood=likelihood)


def _rows(mesh, A):
    n_local = A.shape[0] // mesh.size
    return _t(A[mesh.rank * n_local:(mesh.rank + 1) * n_local])


def suite_dist(mesh, data, out):
    from gp_ss_ak_torch import parallel as tp
    from gp_ss_ak_torch.bayes import sample_hyperposterior
    from gp_ss_ak_torch.ensemble import fit_ensemble
    from gp_ss_ak_torch.inference import WarpedGaussian
    from gp_ss_ak_torch.parallel import nlml as dist_nlml

    nb = int(data["nb"])
    # block Cholesky and the substitutions, one and two blocks per rank
    for k in (1, 2):
        A, B = _rows(mesh, data[f"spd{k}"]), _rows(mesh, data[f"rhs{k}"])
        L, hld = tp.block_cholesky_local(A, nb, mesh)
        out[f"chol{k}_L"], out[f"chol{k}_hld"] = L.numpy(), hld.numpy()
        out[f"chol{k}_lower"] = tp.tri_solve_lower_local(L, B, nb,
                                                         mesh).numpy()
        out[f"chol{k}_upper"] = tp.tri_solve_upper_local(L, B, nb,
                                                         mesh).numpy()
        out[f"chol{k}_solve"] = tp.solve_chol_local(L, B, nb, mesh).numpy()

    X, y, Xq, flat = data["X"], data["y"], data["Xq"], _t(data["flat"])
    n = X.shape[0]
    model = _model(3, data["flat"])
    Xl, yl, _, _ = tp.shard_training_data(mesh, _t(X), _t(y), nb=nb)

    def nlml(key, m, flat_, **kw):
        f = tp.make_dist_nlml_and_grad(m.kernel, m.likelihood, mesh, n,
                                       nb=nb, **kw)
        v, g = f(flat_, Xl, yl)
        out[key + "_v"], out[key + "_g"] = v.numpy(), g.numpy()
        return f

    nlml("exact", model, flat, grad_mode="exact")
    nlml("fused", model, flat, grad_mode="exact", fused=True)
    f = nlml("hutch", model, flat, grad_mode="hutchinson",
             probes=int(data["probes"]), Z=data["Z"])
    # padding invariance: poisoned padding rows change nothing
    f = tp.make_dist_nlml_and_grad(model.kernel, model.likelihood, mesh, n,
                                   nb=nb, grad_mode="exact")
    Xp = Xl.clone()
    Xp[(mesh.rank * Xl.shape[0] + torch.arange(Xl.shape[0])) >= n] = 1e3
    v, g = f(flat, Xp, yl)
    out["pad_v"], out["pad_g"] = v.numpy(), g.numpy()
    # a failed factorization: NaN value and gradient, no exception
    bad = flat.clone()
    bad[-1] = -50.0
    for mode in ("exact", "hutchinson"):
        nlml(f"fail_{mode}", model, bad, grad_mode=mode, probes=4)

    # three queries a chunk, so the predicts below run several chunks
    dist_nlml.PREDICT_CHUNK = 3
    for fam in ("tanh1", "rbf"):
        wm = _model(3, data[f"wflat_{fam}"], WarpedGaussian(fam, 1))
        nlml(f"warp_{fam}", wm, _t(data[f"wflat_{fam}"]), grad_mode="exact")
        if fam == "tanh1":
            mu, var = tp.make_dist_predict(wm.kernel, wm.likelihood, mesh, n,
                                           nb=nb)(
                _t(data[f"wflat_{fam}"]), Xl, yl, _t(Xq))
            out["wpred_mu"], out["wpred_var"] = mu.numpy(), var.numpy()

    pred = tp.make_dist_predict(model.kernel, model.likelihood, mesh, n,
                                nb=nb)
    mu, var = pred(flat, Xl, yl, _t(Xq))
    out["pred_mu"], out["pred_var"] = mu.numpy(), var.numpy()
    mu_only, none = pred(flat, Xl, yl, _t(Xq), mean_only=True)
    out["pred_mu_only"] = mu_only.numpy()
    out["pred_var_none"] = np.asarray(none is None)

    fitted, res = tp.fit_distributed(model, X, y, mesh, nb=nb,
                                     iters=int(data["fit_iters"]))
    out["fit_x"] = np.asarray(res.x)
    out["fit_iters"] = np.asarray(res.n_iters)
    out["fit_stop"] = np.asarray(res.stop_reason)

    # the hooks: deposits and chains split over the ranks; the whole
    # batch in one process, the answer every rank's is held to, on rank 0
    first = mesh.rank == 0
    Xb, yb = data["ens_X"], data["ens_y"]
    m2 = _model(Xb.shape[2], data["flat2"])
    runs = [("ens_mesh", fit_ensemble(m2, _t(Xb), _t(yb), maxiter=3,
                                      mesh=mesh))]
    if first:
        runs.append(("ens", fit_ensemble(m2, _t(Xb), _t(yb), maxiter=3)))
    for key, r in runs:
        out[key + "_x"], out[key + "_fun"] = r.flat.numpy(), r.fun.numpy()
        out[key + "_iters"] = r.n_iters.numpy()
        out[key + "_conv"] = r.converged.numpy()
    X2, y2 = _t(data["hmc_X"]), _t(data["hmc_y"])
    for sampler in ("hmc", "nuts"):
        kw = dict(n_chains=4, n_samples=2, n_warmup=2, sampler=sampler)
        for key, mesh_ in (("mesh", mesh), ("full", None))[:1 + first]:
            st = {}
            z, ap = sample_hyperposterior(m2, X2, y2, 3, mesh=mesh_,
                                          stats=st, **kw)
            out[f"{sampler}_{key}"], out[f"{sampler}_{key}_ap"] = (
                z.numpy(), ap.numpy())
            out[f"{sampler}_{key}_evals"] = np.asarray(st["evals"])
    # the dist NLML inside every leapfrog against the dense objective
    vg = tp.make_dist_nlml_and_grad(model.kernel, model.likelihood, mesh, n,
                                    nb=nb, grad_mode="exact")
    kw = dict(n_chains=1, n_samples=1, n_warmup=1, sampler="hmc")
    out["hmc_vg"] = sample_hyperposterior(
        model, _t(X), _t(y), 5, nlml_value_and_grad=lambda t: vg(t, Xl, yl),
        **kw)[0].numpy()
    if first:
        out["hmc_dense"] = sample_hyperposterior(model, _t(X), _t(y), 5,
                                                 **kw)[0].numpy()

    if mesh.size == 4:
        two = tp.two_level_mesh(rows_per_host=2, device="cpu",
                                backend="gloo")
        X2l, y2l, _, _ = tp.shard_training_data(two.rows, _t(X), _t(y),
                                                nb=nb)
        f2 = tp.make_two_level_nlml_and_grad(model.kernel, model.likelihood,
                                             two, n, nb=nb,
                                             grad_mode="exact")
        v, g = f2(_t(data["flats2"]), X2l, y2l)
        out["two_v"], out["two_g"] = v.numpy(), g.numpy()


def suite_ring(mesh, data, out):
    from gp_ss_ak_torch import parallel as tp
    from gp_ss_ak_torch.parallel import ring

    nb = int(data["nb"])
    X, y, Xq, flat = data["X"], data["y"], data["Xq"], _t(data["flat"])
    n = X.shape[0]
    model = _model(3, data["flat"])
    k = model.kernel
    Xl, yl, _, _ = tp.shard_training_data(mesh, _t(X), _t(y), nb=nb)
    opts = dict(precond_rank=8, probes=4, slq_probes=4, lanczos_iters=8,
                cg_tol=1e-10, cg_maxiter=500, with_stats=True,
                Z=data["Z"], Zl=data["Zl"])
    for key, X_, y_, chunk in (("ring", Xl, yl, None),
                               ("chunked", Xl, yl, 5)):
        v, g, st = tp.make_ring_nlml_and_grad(k, mesh, n, tile_chunk=chunk,
                                              **opts)(flat, X_, y_)
        out[key + "_v"], out[key + "_g"] = v.numpy(), g.numpy()
        out[key + "_stats"] = st.numpy()
    # one row per padding block: n_local is prime at one and two ranks
    Xp, yp, _, _ = tp.shard_training_data(mesh, _t(X), _t(y), nb=1)
    v, g, _ = tp.make_ring_nlml_and_grad(k, mesh, n, tile_chunk=4,
                                         **opts)(flat, Xp, yp)
    out["prime_v"], out["prime_g"] = v.numpy(), g.numpy()
    out["prime_nlocal"] = np.asarray(Xp.shape[0])

    _, vl, _, _ = tp.shard_training_data(mesh, _t(X), _t(data["v"]), nb=nb)
    out["matvec"] = tp.make_ring_matvec(k, mesh, n)(flat, Xl, vl).numpy()
    x, it, res = tp.make_ring_cg_solve(k, mesh, n, tol=1e-10)(flat, Xl, yl)
    out["cg_x"], out["cg_it"] = x.numpy(), np.asarray(it)
    ring.PREDICT_CHUNK = 3      # several query chunks
    mu, it, res = tp.make_ring_posterior_mean(k, mesh, n, tol=1e-10)(
        flat, Xl, yl, _t(Xq))
    out["pmean_mu"], out["pmean_it"] = mu.numpy(), np.asarray(it)
    mu, var = tp.make_ring_predict(k, mesh, n, tol=1e-10, precond_rank=8)(
        flat, Xl, yl, _t(Xq))
    out["rpred_mu"], out["rpred_var"] = mu.numpy(), var.numpy()

    # the gathered and the per-step distributed pivoted Cholesky
    loc = ring._Local(mesh, Xl, n)
    params, sigma, bias, _ = ring._hypers(k, flat)
    Xm = loc.mapped(k, params, Xl)
    n_pad = Xl.shape[0] * mesh.size
    out["pc_gathered"] = ring._ring_pivoted_chol_gathered(
        loc, Xm, sigma, bias, 8, n_pad).numpy()
    out["pc_dist"] = ring._ring_pivoted_chol(loc, Xm, sigma, bias, 8,
                                             n_pad).numpy()

    # fit_ring on the JAX probes, through the probe draw fit_ring makes
    ring.draw_probes = lambda seed, n_, p, s: (data["Zfit"], data["Zlfit"])
    _, res = tp.fit_ring(model, X, y, mesh, nb=nb, iters=2,
                         precond_rank=8, probes=4, slq_probes=4,
                         lanczos_iters=8, cg_tol=1e-10)
    out["fit_x"], out["fit_iters"] = np.asarray(res.x), np.asarray(
        res.n_iters)

    if mesh.size == 4:
        two = tp.two_level_mesh(rows_per_host=2, device="cpu",
                                backend="gloo")
        X2l, y2l, _, _ = tp.shard_training_data(two.rows, _t(X), _t(y),
                                                nb=nb)
        opts2 = {key: val for key, val in opts.items() if key != "with_stats"}
        opts2["Z"], opts2["Zl"] = data["Z2"], data["Zl2"]
        v, g = tp.make_two_level_ring_nlml_and_grad(k, two, n, **opts2)(
            _t(data["flats2"]), X2l, y2l)
        out["two_v"], out["two_g"] = v.numpy(), g.numpy()


def start(inputs: dict, workdir: str):
    """Launch the ranks of every world size in `inputs` ({world: data};
    data's "suite" key names the suite) in one process group of their
    own; returns the handle `collect` takes."""
    import subprocess

    for world, data in inputs.items():
        os.makedirs(os.path.join(workdir, f"w{world}"), exist_ok=True)
        np.savez(os.path.join(workdir, f"w{world}", "in.npz"), **data)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    log = open(os.path.join(workdir, "launcher.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), workdir,
         *map(str, inputs)], stdout=log, stderr=subprocess.STDOUT, env=env,
        start_new_session=True)
    return workdir, sorted(inputs), proc, log


def collect(handle, timeout: float = 240.0):
    """Wait for the launcher; if it fails, or past `timeout` seconds, stop
    every rank and raise with their output. Returns {world: the ranks'
    results, in rank order}."""
    import signal
    import subprocess

    workdir, worlds, proc, log = handle
    try:
        rc = proc.wait(timeout)
    except subprocess.TimeoutExpired:
        rc = "timeout"
    if rc != 0:
        try:
            os.killpg(proc.pid, signal.SIGKILL)    # the forked ranks too
        except ProcessLookupError:
            pass
        proc.wait()
    log.close()
    if rc != 0:
        logs = [os.path.join(workdir, "launcher.log")] + [
            os.path.join(workdir, f"w{w}", f"rank{r}.log")
            for w in worlds for r in range(w)]
        text = "".join(f"--- {f}\n" + open(f).read()[-3000:]
                       for f in logs if os.path.exists(f))
        raise RuntimeError(f"mesh ranks failed ({rc}):\n{text}")
    out = {}
    for w in worlds:
        out[w] = []
        for r in range(w):
            with np.load(os.path.join(workdir, f"w{w}",
                                      f"rank{r}.npz")) as f:
                out[w].append(dict(f))
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rank(rank: int, world: int, port: int, wdir: str) -> int:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    from gp_ss_ak_torch import parallel

    mesh = parallel.make_mesh("cpu", timeout=timedelta(seconds=120))
    with np.load(os.path.join(wdir, "in.npz")) as f:
        data = dict(f)
    out = {}
    {"dist": suite_dist, "ring": suite_ring}[str(data["suite"])](
        mesh, data, out)
    np.savez(os.path.join(wdir, f"rank{rank}.npz"), **out)
    assert "jax" not in sys.modules and "gp_ss_ak_tpu" not in sys.modules
    return 0


def main(argv):
    import signal
    import traceback

    workdir, worlds = argv[1], [int(w) for w in argv[2:]]
    torch.set_num_threads(1)
    # imported once here, before the forks, for every rank to share
    import gp_ss_ak_torch.bayes  # noqa: F401
    import gp_ss_ak_torch.ensemble  # noqa: F401
    import gp_ss_ak_torch.parallel  # noqa: F401

    children = {}
    for world in worlds:
        port, wdir = _free_port(), os.path.join(workdir, f"w{world}")
        for rank in range(world):
            sys.stdout.flush()
            sys.stderr.flush()
            pid = os.fork()
            if pid == 0:
                code = 1
                try:
                    fd = os.open(os.path.join(wdir, f"rank{rank}.log"),
                                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
                    os.dup2(fd, 1)
                    os.dup2(fd, 2)
                    code = run_rank(rank, world, port, wdir)
                except BaseException:
                    traceback.print_exc()
                finally:
                    sys.stdout.flush()
                    sys.stderr.flush()
                    os._exit(code)
            children[pid] = (world, rank)
    while children:
        pid, status = os.wait()
        world, rank = children.pop(pid)
        if os.waitstatus_to_exitcode(status) != 0:
            print(f"world {world} rank {rank} failed", flush=True)
            for other in children:
                os.kill(other, signal.SIGKILL)
            for _ in children:
                os.wait()
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
