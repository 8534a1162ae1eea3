"""Command-line interface: the reference binary's `test` mode.

Usage (gp_ss_ak.cpp:14-63, 511-557; same flags as gp_ss_ak_tpu.cli):

  python -m gp_ss_ak_torch [-v N] [-pm N] test [--no-plot] [--float64]
         [--engine auto|dense|iterative] TEST_FILE MODEL_FILE
         TRAIN_FILE [OUTPUT_FILE]

Runs on the first CUDA device when one is present, else on the CPU.
Past ITERATIVE_MIN_N training points (`--engine auto`), or on
`--engine iterative`, the flagship model is served by the matrix-free
`serve.IterativePredictor` (float32, the streamed Gram kernel on a
GPU); otherwise by one dense factorize-and-predict.
Prints MSE and var(y) (two bare numbers at verbose 0, labeled at
verbose > 0 — gp_ss_ak.cpp:417-430) and writes the reference prediction
file (gp_ss_ak.cpp:434-481) plus, unless --no-plot, the
Observed-vs-Estimated plot.

Not ported yet: `train`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

#: auto engine switches to the matrix-free server past this training
#: size (the dense K + chol wall of a 16 GB TPU, gp_ss_ak_tpu/cli.py:
#: 264-266); kept for parity, still to be re-derived for an 80 GB H100
ITERATIVE_MIN_N = 32768


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gp_ss_ak_torch",
        description="GP engine with the GP_SS_AK capability set "
                    "(PyTorch/CUDA port: test mode)",
    )
    p.add_argument("-v", "--verboseL", type=int, default=0, dest="verbose")
    p.add_argument("-pm", "--prepMethod", type=int, default=1, dest="prep",
                   help="0: mean/std, 1: symmetric (default), 2: zero-one")
    sub = p.add_subparsers(dest="command", required=True)

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
    return p


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

    dtype = torch.float64 if args.float64 else torch.float32
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    model = load_model(args.model_file).to(dtype, device)
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


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    # Clean termination on user errors — the reference's
    # ErrorTermination -> exit(1) (ModelInf.h:84-88, Control.cpp:331-337)
    # without a Python traceback. `-v 3` keeps the full traceback.
    try:
        return cmd_test(args)
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
