"""Command-line interface mirroring the reference binary's surface.

Usage (gp_ss_ak.cpp:14-63, 511-557; same flags as gp_ss_ak_tpu.cli):

  python -m gp_ss_ak_torch [-v N] [-pm N] train [-k NAME]... [-o OPT]
         [-# ITERS] [-kn 0|1] [-mf NAME] [-lf NAME] [--init-params CSV]
         [--init-lik SN2] [--engine auto|dense|iterative|dist|ring]
         [--segmented] [--float64]
         [--device DEV] TRAIN_FILE [MODEL_NAME]

  python -m gp_ss_ak_torch [-v N] [-pm N] test [--no-plot] [--float64]
         [--engine auto|dense|iterative] [--device DEV] TEST_FILE
         MODEL_FILE TRAIN_FILE [OUTPUT_FILE]

Both run on the first CUDA device (`--device cuda`, the default). Without
a usable CUDA device they exit 1 and say so, unless `--device cpu` asks
for the CPU.

`train` fits the hyperparameters (optim.fit: dense, or matrix-free past
DENSE_MAX_N on a GPU), writes the reference-format model file,
MODEL_NAME_Statistics.txt and MODEL_NAME_metrics.json, and prints the
training-set MSE and var(y). `-lf WarpGauss[:family[:m]]` trains the
warped Gaussian likelihood (family tanh1, rbf or srbf, m triplets; the
JAX CLI's parsing). The training-set mean behind that MSE comes from
the engine the fit ran (`_training_mean`): after a dense or chol-mode
fit, the exact dense predict over chunks of TRAIN_PREDICT_CHUNK
queries, with no variance solve for a plain Gaussian; after a gemm- or
stream-mode fit, the
matrix-free `serve.IterativePredictor`. The JAX CLI predicts densely
with the full N x N cross-Gram at every N (gp_ss_ak_tpu/cli.py:216-219),
16 N^2 bytes at its peak; this keeps the peak at the factorization's
8 N^2. `test` serves the flagship model (plain or warped) through
the matrix-free `serve.IterativePredictor` past ITERATIVE_MIN_N training
points (`--engine auto`) or on `--engine iterative`, else through one
dense factorize-and-predict; it prints MSE and var(y) (two bare numbers
at verbose 0, labeled at verbose > 0 — gp_ss_ak.cpp:312-325, 417-430)
and writes the reference prediction file (gp_ss_ak.cpp:434-481) plus,
unless --no-plot, the Observed-vs-Estimated plot.

`train -o JIT` fits with the batched L-BFGS on one problem
(optim/batched_lbfgs.py, the counterpart of the JAX package's whole-fit
device optimizer optim/jax_lbfgs.py).

`train --engine dist|ring` fits over a mesh of ranks (parallel/): the
row-split exact NLML (`fit_distributed`) or the ring's matrix-free one
(`fit_ring`). A plain process is a mesh of one rank (NCCL on the card,
gloo with `--device cpu`); under `torchrun --nproc_per_node P` the mesh
has P ranks and only rank 0 prints and writes files. The training-set
mean comes from the same engine (`_training_mean_mesh`), where the JAX
CLI predicts densely.

`train --engine iterative --segmented` fits with the JAX package's
segmented evaluator's route (optim/segmented.py): the stream evaluator
with its defaults, each CG solve warm-started from the last one's
solutions; its training-set mean comes from the matrix-free server,
since the fit ran in stream mode at any N.

A CG solve that ends above its tolerance (inference.iterative's
UnconvergedSolveWarning: the fit's count and largest residual, or a
server's first such solve) prints one line, "Warning: ...", on stderr,
so stdout stays the JAX CLI's. The JAX CLI says nothing there.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import sys
import warnings
from dataclasses import replace

import numpy as np

from gp_ss_ak_torch.optim.iterative_fit import DENSE_MAX_N

#: auto engine switches to the matrix-free server past this training
#: size (the dense K + chol wall of a 16 GB TPU, gp_ss_ak_tpu/cli.py:
#: 264-266); kept for parity, still to be re-derived for an 80 GB H100
ITERATIVE_MIN_N = 32768
#: queries per chunk of train's dense training-set predict: the cross-Gram
#: it holds is N x TRAIN_PREDICT_CHUNK
TRAIN_PREDICT_CHUNK = 4096


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: 'cuda' (default, the "
                        "first card), 'cuda:N' or 'cpu'")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gp_ss_ak_torch",
        description="GP engine with the GP_SS_AK capability set "
                    "(PyTorch/CUDA port)",
    )
    p.add_argument("-v", "--verboseL", type=int, default=0, dest="verbose")
    p.add_argument("-pm", "--prepMethod", type=int, default=1, dest="prep",
                   help="0: mean/std, 1: symmetric (default), 2: zero-one")
    sub = p.add_subparsers(dest="command", required=True)

    tr = sub.add_parser("train", help="fit hyperparameters by "
                        "maximizing the marginal likelihood")
    tr.add_argument("-k", "--kernel", action="append", default=[],
                    help="kernel name (repeatable): ExpAns (default), "
                    "RBF, Exp, Bias, White")
    tr.add_argument("-o", "--optimiser", default="LBFGS",
                    help="LBFGS (default) | BFGS | SCG | JIT (the "
                    "batched L-BFGS on one problem)")
    tr.add_argument("-#", "--iterations", type=int, default=100,
                    dest="iters")
    tr.add_argument("-kn", "--Knoise", type=int, default=1,
                    help="append a Bias noise kernel (default 1)")
    tr.add_argument("-mf", "--meanfunction", default="mean_zero")
    tr.add_argument("-lf", "--likefunction", default="Gauss")
    tr.add_argument("--init-params", default=None,
                    help="comma-separated initial kernel params "
                    "(replaces the reference's stdin prompts)")
    tr.add_argument("--init-lik", type=float, default=None,
                    help="initial likelihood noise variance sn2")
    tr.add_argument("--engine", default="auto",
                    choices=("auto", "dense", "iterative", "dist", "ring"),
                    help="NLML engine: 'dense' Cholesky; 'iterative' the "
                         "matrix-free engine (float32; exact Cholesky, "
                         "GEMM-backed or streamed by N); 'auto' "
                         f"(default) iterative past N={DENSE_MAX_N} on a "
                         "GPU; 'dist' the row-split exact engine and "
                         "'ring' the ring's matrix-free one over every "
                         "rank (parallel/)")
    tr.add_argument("--segmented", action="store_true",
                    help="with --engine iterative: the stream "
                         "evaluator with each CG solve warm-started "
                         "from the last one's solutions "
                         "(optim/segmented.py), for the N >~ 10^5 regime")
    tr.add_argument("--float64", action="store_true",
                    help="fit in float64 (ignored by the iterative "
                         "engine, which is float32-only)")
    _add_device(tr)
    tr.add_argument("train_file")
    tr.add_argument("model_name", nargs="?", default="gp_model")

    te = sub.add_parser("test", help="predict a test set with a "
                        "trained model and plot the results")
    te.add_argument("test_file")
    te.add_argument("model_file")
    te.add_argument("train_file")
    te.add_argument("output_file", nargs="?", default=None)
    te.add_argument("--no-plot", action="store_true")
    te.add_argument("--float64", action="store_true")
    te.add_argument("--engine", default="auto",
                    choices=("auto", "dense", "iterative"),
                    help="serving path: 'dense' factorize-and-predict, "
                         "'iterative' the matrix-free server (flagship "
                         "model, float32); 'auto' (default) picks "
                         f"iterative past N={ITERATIVE_MIN_N} training "
                         "points")
    _add_device(te)
    return p


def _device(args):
    """The torch device the command asked for, or None (after saying
    why on stderr) when it names a CUDA device that is not usable."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if (device.index or 0) >= count:
            print(f"Error: no usable CUDA device for --device "
                  f"{args.device} ({count} visible); pass --device cpu "
                  "to run on the CPU", file=sys.stderr)
            return None
    elif device.type != "cpu":
        print(f"Error: --device must be cuda[:N] or cpu, got "
              f"{args.device}", file=sys.stderr)
        return None
    return device


def _training_mean(model, Xs, ys, engine: str, device, dtype,
                   segmented: bool = False):
    """The predictive mean at the training inputs, for the printed MSE,
    by the engine and mode the fit ran: a dense or chol-mode fit held A
    and L on the device, so the exact dense predict runs
    (gaussian.posterior_mean over TRAIN_PREDICT_CHUNK queries at a time,
    no N x N cross-Gram);
    a gemm- or stream-mode fit could not, so the matrix-free server
    gives the mean (a warped model there still pays the variance
    solves, as the JAX server does). A segmented iterative fit ran in
    stream mode whatever N is."""
    import torch

    from gp_ss_ak_torch.inference import factorize, posterior_mean
    from gp_ss_ak_torch.inference import iterative as ti
    from gp_ss_ak_torch.optim import resolve_engine
    from gp_ss_ak_torch.serve import IterativePredictor

    n = Xs.shape[0]
    if (resolve_engine(engine, n, model) == "iterative"
            and (segmented or ti.choose_mode(n, "auto", device) != "chol")):
        mu, _ = IterativePredictor(model, Xs, ys)(Xs, mean_only=True)
        return mu
    X = torch.as_tensor(Xs, dtype=dtype, device=device)
    y = torch.as_tensor(ys, dtype=dtype, device=device)
    post = factorize(model.kernel, model.kernel_params, model.lik_hypers,
                     X, y, model.likelihood)
    return posterior_mean(model.kernel, model.kernel_params,
                          model.lik_hypers, X, post, X, model.likelihood,
                          chunk=TRAIN_PREDICT_CHUNK).cpu().numpy()


def cmd_train(args) -> int:
    import torch

    from gp_ss_ak_torch.data import prepare, read_data, unapply_y
    from gp_ss_ak_torch.inference import WarpedGaussian, warping
    from gp_ss_ak_torch.model import default_model, save_model
    from gp_ss_ak_torch.optim import fit
    from gp_ss_ak_torch.utils import FitLogger

    lf = args.likefunction
    wlik = None
    if lf != "Gauss":
        # "WarpGauss[:family[:m]]" (gp_ss_ak_tpu/cli.py:132-147): the
        # reference wires only Gauss in its CLI (gp_ss_ak.cpp:192)
        parts = lf.split(":")
        if parts[0] not in ("WarpGauss", "warpgauss"):
            print(f"Unknown likelihood function: {lf}", file=sys.stderr)
            return 1
        family = parts[1] if len(parts) > 1 else warping.TANH1
        if family not in warping.FAMILIES:
            raise ValueError(f"unknown warp family {family!r}")
        wlik = WarpedGaussian(family=family,
                              n_triplets=int(parts[2]) if len(parts) > 2
                              else 1)
    device = _device(args)
    if device is None:
        return 1
    mesh = None
    if args.engine in ("dist", "ring"):
        from gp_ss_ak_torch.parallel import make_mesh

        mesh = make_mesh(device)
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    dtype = torch.float64 if args.float64 else torch.float32
    X, y = read_data(args.train_file)
    Xs, ys, stats = prepare(X, y, args.prep)
    if lead:
        stats.save(args.model_name + "_Statistics.txt")
    if args.verbose > 0:
        say(f"Read {X.shape[0]} points, {X.shape[1]} features")

    names = args.kernel or ["ExpAns"]
    model = default_model(input_dim=X.shape[1], kernel_names=names,
                          knoise=bool(args.Knoise), dtype=dtype,
                          device=device)
    if wlik is not None:
        model = replace(model, likelihood=wlik,
                        lik_hypers=wlik.default_hypers(dtype, device))
    if args.init_params:
        vals = [float(t) for t in args.init_params.split(",")]
        if len(vals) != model.kernel.n_params:
            print(f"--init-params needs {model.kernel.n_params} values",
                  file=sys.stderr)
            return 1
        model = replace(model, kernel_params=model.kernel.unpack(
            torch.tensor(vals, dtype=dtype, device=device)))
    if args.init_lik is not None:
        if wlik is not None:
            # warped models parameterize the noise as exp(2 theta_last):
            # write into the last hyper, keep the warp triplets
            lh = model.lik_hypers.clone()
            lh[-1] = 0.5 * math.log(max(args.init_lik, 1e-12))
            model = replace(model, lik_hypers=lh)
        else:
            model = replace(model, lik_hypers=torch.tensor(
                [args.init_lik], dtype=dtype, device=device))

    if args.verbose > 0:
        say(f"Optimizing {model.n_params} hyperparameters with "
            f"{args.optimiser} ({args.iters} iters)")
    if args.float64 and args.engine == "iterative":
        print("Warning: --float64 is ignored by the iterative engine "
              "(matrix-free CG/SLQ runs in float32)", file=sys.stderr)
    logger = FitLogger(verbose=max(0, args.verbose - 1) if lead else 0,
                       path=args.model_name + "_metrics.json" if lead
                       else None)
    if mesh is not None:
        fitted, res = _fit_mesh(args, model, Xs, ys, mesh, logger)
    else:
        fitted, res = fit(model, Xs, ys, optimizer=args.optimiser,
                          iters=args.iters, callback=logger,
                          engine=args.engine,
                          engine_opts=dict(segmented=True)
                          if args.segmented else None)
    logger.save()
    if args.verbose > 0:
        say(f"-logL: {res.trace[0]:.6f} -> {res.fun:.6f} "
            f"({res.n_iters} iters, {res.n_evals} evals, stop: "
            f"{res.stop_reason})")
    if lead:
        save_model(fitted, args.model_name)

    # the training-set fit, by the engine the fit ran; a profiler range
    # of its own
    with torch.autograd.profiler.record_function("cmd_train.predict"):
        if mesh is not None:
            mu = _training_mean_mesh(args.engine, fitted, Xs, ys, mesh)
        else:
            mu = _training_mean(fitted, Xs, ys, args.engine, device, dtype,
                                args.segmented)
    yh = unapply_y(stats, mu)
    mse = float(np.mean((y - yh) ** 2))
    var_y = float(np.mean((y - y.mean()) ** 2))
    if args.verbose > 0:
        say(f"Mean Square Error of training: {mse}")
        say(f"Var MSE Train: {var_y}")
    else:
        say(mse)
        say(var_y)
    return 0


def _fit_mesh(args, model, Xs, ys, mesh, logger):
    """`train --engine dist|ring` over every rank of the mesh: the
    row-split exact fit or the ring's matrix-free one, with the JAX
    CLI's defaults (gp_ss_ak_tpu/cli.py:181-203)."""
    from gp_ss_ak_torch.parallel import fit_distributed, fit_ring

    verbose = max(0, args.verbose - 1) if mesh.rank == 0 else 0
    if args.engine == "dist":
        return fit_distributed(model, Xs, ys, mesh, optimizer=args.optimiser,
                               iters=args.iters, callback=logger,
                               verbose=verbose)
    return fit_ring(model, Xs, ys, mesh, iters=args.iters, callback=logger,
                    verbose=verbose)


def _training_mean_mesh(engine: str, model, Xs, ys, mesh):
    """The predictive mean at the training inputs by the mesh engine
    that did the fit, in chunks of queries (the engines'
    PREDICT_CHUNK): the row-split exact predict (the mean alone for a
    plain Gaussian) or the ring's posterior mean (alpha by ring CG);
    never an N x N panel. The JAX CLI predicts densely here."""
    import torch

    from gp_ss_ak_torch.parallel import (
        make_dist_predict,
        make_ring_posterior_mean,
        shard_training_data,
    )
    from gp_ss_ak_torch.parallel.fit import NB

    flat = model.pack().detach()
    X_local, y_local, n, _ = shard_training_data(
        mesh, torch.as_tensor(Xs, dtype=flat.dtype),
        torch.as_tensor(ys, dtype=flat.dtype), nb=NB)
    Xq = torch.as_tensor(Xs, dtype=flat.dtype, device=mesh.device)
    if engine == "dist":
        mu, _ = make_dist_predict(model.kernel, model.likelihood, mesh, n,
                                  nb=NB)(flat, X_local, y_local, Xq,
                                         mean_only=True)
    else:
        mu, _, _ = make_ring_posterior_mean(model.kernel, mesh, n)(
            flat, X_local, y_local, Xq)
    return mu.cpu().numpy()


def cmd_test(args) -> int:
    import torch

    from gp_ss_ak_torch.data import (
        Statistics,
        apply,
        read_data,
        unapply_var,
        unapply_y,
        write_predictions,
    )
    from gp_ss_ak_torch.inference import predict
    from gp_ss_ak_torch.model import load_model
    from gp_ss_ak_torch.optim import supports_iterative
    from gp_ss_ak_torch.serve import IterativePredictor

    device = _device(args)
    if device is None:
        return 1
    dtype = torch.float64 if args.float64 else torch.float32
    model = load_model(args.model_file, dtype, device)
    stats = Statistics.load(args.model_file + "_Statistics.txt")

    Xt, yt = read_data(args.test_file)
    Xtr, ytr = read_data(args.train_file)
    if Xt.shape[1] != model.input_dim:
        print("Incorrect dimension of input data.", file=sys.stderr)
        return 1
    Xts = apply(stats, Xt)
    Xtrs, ytrs = apply(stats, Xtr, ytr)

    use_iter = supports_iterative(model) and (
        args.engine == "iterative"
        or (args.engine == "auto" and Xtr.shape[0] > ITERATIVE_MIN_N))
    if args.engine == "iterative" and not supports_iterative(model):
        print("--engine iterative requires the flagship "
              "Sum([ExpAns, Bias]) model; falling back to dense",
              file=sys.stderr)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if use_iter:
        server = IterativePredictor(model, Xtrs, ytrs)
        mu, var = server(Xts, batch_size=4096)
    else:
        mu, var = predict(model.kernel, model.kernel_params,
                          model.lik_hypers, t(Xtrs), t(ytrs), t(Xts),
                          model.likelihood)
        mu, var = mu.cpu().numpy(), var.cpu().numpy()
    yh = unapply_y(stats, mu)
    std = unapply_var(stats, var)

    mse = float(np.mean((yt - yh) ** 2))
    var_y = float(np.mean((yt - yt.mean()) ** 2))
    if args.verbose > 0:
        print(f"Mean Square Error of testing: {mse}")
        print(f"Var MSE Test: {var_y}")
    else:
        print(mse)
        print(var_y)

    out = args.output_file or (args.model_file + "_predict.txt")
    write_predictions(out, yt, yh, std, Xt)
    if not args.no_plot:
        _plot(args.model_file, yt, yh, std)
    return 0


def _plot(model_name: str, y, yh, std) -> None:
    """Observed vs Estimated with a 95% band — the gnuplot replacement
    (gp_ss_ak.cpp:482-505); skipped when matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    order = np.argsort(np.asarray(y), kind="stable")
    ys = np.asarray(y)[order]
    yhs = np.asarray(yh)[order]
    stds = np.asarray(std)[order]
    xs = np.arange(1, len(ys) + 1)
    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.fill_between(xs, yhs - stds, yhs + stds, alpha=0.35,
                    color="green", label="95% CI")
    ax.plot(xs, yhs, color="red", lw=1, label="Estimated")
    ax.plot(xs, ys, color="blue", lw=1, label="Observed")
    ax.set_title("Observed vs Estimated")
    ax.set_xlabel("Sample")
    ax.set_ylabel("Grade")
    ax.legend(loc="upper left")
    fig.tight_layout()
    fig.savefig(model_name + "_predict.pdf")
    plt.close(fig)


@contextlib.contextmanager
def _solve_warnings_on_stderr():
    """Print every UnconvergedSolveWarning as one "Warning: ..." line on
    stderr; other warnings go through as they would."""
    from gp_ss_ak_torch.inference.iterative import UnconvergedSolveWarning

    with warnings.catch_warnings():
        warnings.simplefilter("always", UnconvergedSolveWarning)
        show = warnings.showwarning

        def shown(message, category, *args, **kw):
            if issubclass(category, UnconvergedSolveWarning):
                print(f"Warning: {message}", file=sys.stderr, flush=True)
            else:
                show(message, category, *args, **kw)

        warnings.showwarning = shown
        yield


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    # Clean termination on user errors — the reference's
    # ErrorTermination -> exit(1) (ModelInf.h:84-88, Control.cpp:331-337)
    # without a Python traceback. `-v 3` keeps the full traceback.
    cmd = {"train": cmd_train, "test": cmd_test}[args.command]
    try:
        with _solve_warnings_on_stderr():
            return cmd(args)
    except FileNotFoundError as e:
        print(f"Error: file not found: {e.filename or e}", file=sys.stderr)
    except (ValueError, KeyError) as e:
        if args.verbose >= 3:
            raise
        print(f"Error: {e}", file=sys.stderr)
    except KeyboardInterrupt:
        print("Interrupted.", file=sys.stderr)
        return 130
    except Exception as e:  # noqa: BLE001 - CLI boundary
        if args.verbose >= 3:
            raise
        print(f"Error ({type(e).__name__}): {e}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
