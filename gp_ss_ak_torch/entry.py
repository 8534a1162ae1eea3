"""Entry points (the torch counterparts of `__graft_entry__` at the
repository root).

entry(): one flagship NLML + gradient evaluation, the unit of work inside
hyperparameter optimization.

    step, (flat, X, y) = entry()              # on the card
    value, grad = step(flat, X, y)

The flagship model is Sum([ExpAns, Bias]) with Gaussian noise at its
default hyperparameters; the data are N = 1024 points in [-1, 1]^3 from
numpy seed 0 with y = sin(X @ [3, 1, 2]), exactly as the JAX entry makes
them. The gradient is the dense engine's: K1 forward, the QW adjoint and
K1's closed-form backward (optim.flat_nlml_fn).

dryrun_multichip(n_devices): the whole mesh surface (parallel/) on tiny
shapes, over n ranks: the row-split NLML + gradient and a projected step
in the [1e-4, 6] box, `fit_distributed` for 3 iterations, the
distributed predict, the ring's matrix-free NLML + gradient through its
bounded-memory panel loop, and one two-level (chains x rows) batch.
Inside a world of n ranks (torchrun, or any torch.distributed launch) it
runs in place on every rank; otherwise it starts n local ranks itself:

    python -m gp_ss_ak_torch.entry 4            # 4 ranks, on the card
    python -m gp_ss_ak_torch.entry 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from gp_ss_ak_torch.model import default_model
from gp_ss_ak_torch.optim import flat_nlml_fn

#: how long the ranks `dryrun_multichip` starts may take, start-up
#: included, before they are stopped
DRYRUN_TIMEOUT_S = 600


def _flagship(n: int = 1024, d: int = 3, dtype=torch.float32,
              device="cuda"):
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, size=(n, d))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0][:d]))
    model = default_model(input_dim=d, dtype=dtype, device=device)
    return (model, torch.as_tensor(X, dtype=dtype, device=model.pack().device),
            torch.as_tensor(y, dtype=dtype, device=model.pack().device))


def entry(dtype=torch.float32, device="cuda"):
    """(step, (flat, X, y)): step(flat, X, y) -> (value, grad), both
    tensors on `device` (the card unless the caller asks for the CPU)."""
    model, X, y = _flagship(dtype=dtype, device=device)
    f = flat_nlml_fn(model)

    def step(flat, X, y):
        flat = flat.detach().requires_grad_()
        value = f(flat, X, y)
        (grad,) = torch.autograd.grad(value, flat)
        return value.detach(), grad

    return step, (model.pack(), X, y)


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> dict:
    """Exercise the mesh engines over `n_devices` ranks and print the JAX
    dry run's final line (on rank 0). Returns {"nlml", "fit3", "ring",
    "ring_iters", "ring_rel", "line"}, the same on every rank, and
    "two_level", whether this rank ran the two-level batch.

    In place when torch.distributed already runs a world of n_devices
    ranks (with that world's backend unless `backend` names another), or
    when n_devices is 1. Otherwise it starts n_devices local ranks: NCCL,
    one card each, when `device` is a CUDA device and the machine has
    that many cards; else gloo, every rank on the one `device` (on a
    card, collectives staged through the host). The two-level batch
    (2 chains x n // 2 rows) runs on the first 2 (n // 2) ranks for any
    n >= 2, as the JAX dry run puts it on its first 2 (n // 2) devices;
    at an odd n the last rank skips it."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == n_devices:
        if dist.is_initialized() and backend is None:
            backend = dist.get_backend()
        return _dryrun_rank(n_devices, device, backend)
    if world != 1:
        raise ValueError(f"dryrun_multichip({n_devices}) inside a world of "
                         f"{world} ranks")
    return _launch_ranks(n_devices, device, backend)


def _dryrun_rank(n_devices: int, device, backend) -> dict:
    """One rank's dry run (__graft_entry__.py:53-168)."""
    from gp_ss_ak_torch import parallel as tp
    from gp_ss_ak_torch.optim.lbfgsb import DEFAULT_LOWER, DEFAULT_UPPER

    mesh = tp.make_mesh(device, backend)
    if mesh.size != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the mesh has "
                           f"{mesh.size}")
    nb = 8
    n, d = 8 * n_devices, 3
    f32 = torch.float32
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    y = np.sin(X @ np.array([3.0, 1.0, 2.0], np.float32))
    model = default_model(input_dim=d, dtype=f32, device=mesh.device)
    Xl, yl, n_true, _ = tp.shard_training_data(mesh, torch.as_tensor(X),
                                               torch.as_tensor(y), nb=nb)
    nlml_grad = tp.make_dist_nlml_and_grad(model.kernel, model.likelihood,
                                           mesh, n=n_true, nb=nb)
    lb = torch.full((model.n_params,), DEFAULT_LOWER, dtype=f32,
                    device=mesh.device)
    ub = torch.full_like(lb, DEFAULT_UPPER)

    # the distributed training step and its projected update
    flat0 = model.pack()
    value, grad = nlml_grad(flat0, Xl, yl)
    flat1 = torch.clamp(flat0 - 1e-3 * grad, lb, ub)
    v = float(value)
    assert np.isfinite(v), f"dryrun NLML not finite: {v}"
    assert bool(torch.isfinite(flat1).all())

    # fit_distributed, a few iterations
    fitted, res = tp.fit_distributed(model, X, y, mesh, nb=nb, iters=3)
    assert np.isfinite(res.fun), "fit_distributed diverged"
    assert res.fun <= v + 1e-6, "fit_distributed did not improve"

    # distributed prediction
    predict = tp.make_dist_predict(model.kernel, model.likelihood, mesh,
                                   n=n_true, nb=nb)
    Xq = torch.as_tensor(rng.uniform(-1, 1, size=(5, d)), dtype=f32,
                         device=mesh.device)
    mu, var = predict(fitted.pack(), Xl, yl, Xq)
    assert bool(torch.isfinite(mu).all())
    assert bool((var >= 0).all())

    # the ring's matrix-free NLML + gradient; tile_chunk=4 forces the
    # bounded-memory panel loop, with_stats the CG iterations and residual
    ring = tp.make_ring_nlml_and_grad(model.kernel, mesh, n=n_true,
                                      precond_rank=8, probes=4,
                                      slq_probes=4, lanczos_iters=8,
                                      cg_tol=1e-6, cg_maxiter=200,
                                      with_stats=True, tile_chunk=4)
    vr, gr, st = ring(flat0, Xl, yl)
    assert np.isfinite(float(vr)), "ring NLML not finite"
    assert bool(torch.isfinite(gr).all()), "ring grad not finite"
    assert float(st[1]) < 1e-4, "ring CG did not converge"

    # the two-level (chains x rows) mesh: a chain-parallel NLML batch on
    # the first 2 (n // 2) ranks; every rank takes part in building it
    two = None
    if n_devices >= 2:
        n_rows = n_devices // 2
        two = tp.two_level_mesh(rows_per_host=n_rows, device=mesh.device,
                                backend=mesh.backend, n_ranks=2 * n_rows)
    if two is not None:
        n2 = 8 * n_rows
        X2l, y2l, _, _ = tp.shard_training_data(
            two.rows, torch.as_tensor(X[:n2]), torch.as_tensor(y[:n2]),
            nb=nb)
        f2 = tp.make_two_level_nlml_and_grad(model.kernel, model.likelihood,
                                             two, n=n2, nb=nb)
        flats = torch.stack([flat0, torch.clamp(flat0 * 1.3, lb, ub)])
        vals2, grads2 = f2(flats, X2l, y2l)
        assert bool(torch.isfinite(vals2).all())
        assert bool(torch.isfinite(grads2).all())

    line = (f"dryrun_multichip({n_devices}): nlml={v:.4f} "
            f"fit3={res.fun:.4f} ring={float(vr):.4f} predict+2level ok")
    if mesh.rank == 0:
        print(line, flush=True)
    return {"nlml": v, "fit3": float(res.fun), "ring": float(vr),
            "ring_iters": int(st[0]), "ring_rel": float(st[1]),
            "line": line, "two_level": two is not None}


def _launch_ranks(n_devices: int, device, backend) -> dict:
    """Start n_devices ranks of this module on this machine
    (parallel.launch_local) and wait for them. Returns rank 0's result
    and prints its line."""
    from gp_ss_ak_torch.parallel import launch_local

    dev = torch.device(device)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and torch.cuda.device_count() >= n_devices else "gloo")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=pkg_root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as work:
        launch_local([sys.executable, "-m", "gp_ss_ak_torch.entry",
                      str(n_devices), "--device", str(device), "--backend",
                      backend, "--out", work], n_devices, work,
                     DRYRUN_TIMEOUT_S, env=env)
        with open(os.path.join(work, "rank0.json")) as f:
            out = json.load(f)
    print(out["line"], flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gp_ss_ak_torch.entry",
        description="the mesh dry run over N ranks (dryrun_multichip)")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--out", default=None,
                    help="write this rank's result as JSON to "
                         "OUT/rank<RANK>.json (a rank started by "
                         "dryrun_multichip)")
    args = ap.parse_args(argv)
    if args.out is None:
        dryrun_multichip(args.n_devices, args.device, args.backend)
        return 0
    # one rank of a launch: make_mesh starts the world from the
    # environment
    out = _dryrun_rank(args.n_devices, args.device, args.backend)
    with open(os.path.join(args.out, f"rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
