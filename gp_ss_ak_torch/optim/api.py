"""Training: glue between GPModel, the NLML and the host
optimizers (the role of GP_utils::OptimisePars + Opt_Algs::Optimise,
GP_Utils.cpp:1288-1301 / Opt_pars.h:176-195). Port of
gp_ss_ak_tpu/optim/api.py.

The objective is a function of the flat hyper vector; its gradient is
torch autograd of the exact NLML (the QW closed-form adjoint by
default). Optimizer names mirror the CLI ("LBFGS", "BFGS", "SCG",
gp_ss_ak.cpp:286-293). The objective runs on the device and in the
dtype of the model's parameters; one host read per evaluation brings
back the value and the gradient.

`optimizer="JIT"` (also "LBFGS-JIT", "DEVICE"; the CLI's `-o JIT`) runs
the batched L-BFGS of optim/batched_lbfgs.py on one problem: the JAX
package's whole-fit device optimizer (optim/jax_lbfgs.py), here a host
loop of batched evaluations. `batched_nlml_fn` is the objective of B
independent problems at once (the multi-deposit ensembles, the
sampler's chains).

`fit(checkpoint_path=...)` saves the flat hyper vector every
`checkpoint_every` iterations and, with `resume`, starts from the last
one saved (utils/checkpoint.py, the JAX package's files).

`engine_opts={"segmented": True}` runs the iterative engine's stream
evaluator with a warm start, under the JAX segmented evaluator's
defaults (optim/segmented.py).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import replace
from typing import Optional, Tuple

import numpy as np
import torch

from gp_ss_ak_torch.inference import gaussian
from gp_ss_ak_torch.inference.iterative import (
    UnconvergedSolveWarning,
    solve_summary,
    unconverged_message,
)
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.optim import batched_lbfgs
from gp_ss_ak_torch.optim.bfgs import DenseBFGS
from gp_ss_ak_torch.optim.iterative_fit import (
    DENSE_MAX_N,
    make_iterative_value_and_grad,
    supports_iterative,
)
from gp_ss_ak_torch.optim.lbfgsb import (
    DEFAULT_LOWER,
    DEFAULT_UPPER,
    LBFGSB,
    OptResult,
)
from gp_ss_ak_torch.optim.scg import SCG
from gp_ss_ak_torch.optim.segmented import make_segmented_value_and_grad
from gp_ss_ak_torch.utils.checkpoint import (
    CheckpointCallback,
    load_fit_checkpoint,
)

#: the optimizer names of the batched L-BFGS (gp_ss_ak_tpu/optim/api.py:
#: 240-276, the JAX package's whole-fit device optimizer)
DEVICE_LOOP = ("JIT", "LBFGS-JIT", "DEVICE")


def flat_nlml_fn(model: GPModel, jitter: float = 0.0,
                 grad_mode: str = "qw"):
    """f(flat, X, y) -> NLML as a differentiable torch function; data
    is passed per call, nothing is bound. Defaults to the QW closed-form
    adjoint (inference/gaussian.QuadLogdet)."""
    kernel = model.kernel
    likelihood = model.likelihood
    nk = kernel.n_params
    nl = model.lik_hypers.numel()

    def f(flat, X, y):
        kp = kernel.unpack(flat[:nk])
        lh = flat[nk : nk + nl]
        return gaussian.nlml(kernel, kp, lh, X, y, likelihood, jitter,
                             grad_mode=grad_mode)

    return f


def unpack_batched(model: GPModel, flats: torch.Tensor):
    """(kernel parameters with (B,) leaves, lik_hypers (n_lik, B)) of
    (B, p) flat vectors: the batched layout of inference/gaussian.py."""
    nk = model.kernel.n_params
    nl = model.lik_hypers.numel()
    return model.kernel.unpack(flats[:, :nk].T), flats[:, nk : nk + nl].T


def batched_nlml_fn(model: GPModel, jitter: float = 0.0):
    """f(flats (B, p), X (B, n, d), y (B, n)) -> (B,) NLML of B
    independent problems, differentiable in the flats: the JAX
    package's `jax.vmap(flat_nlml_fn(model))`.

    The flagship model with the plain Gaussian likelihood evaluates all
    members at once (one batched K1 launch on the card, batched potrf
    and QW adjoint); any other model loops over the members
    (inference/gaussian.py)."""
    kernel = model.kernel
    likelihood = model.likelihood

    def f(flats, X, y):
        kp, lh = unpack_batched(model, flats)
        return gaussian.nlml(kernel, kp, lh, X, y, likelihood, jitter,
                             grad_mode="qw")

    return f


def batched_value_and_grad(f, X: torch.Tensor, y: torch.Tensor):
    """vg(flats (B, p)) -> (values (B,), gradients (B, p)) of a batched
    objective `f` on fixed data, detached; a member's NaN stays in its
    own value and gradient."""

    def vg(flats: torch.Tensor):
        with torch.enable_grad():
            x = flats.detach().requires_grad_(True)
            val = f(x, X, y)
            (grad,) = torch.autograd.grad(val.sum(), x)
        return val.detach(), grad

    return vg


def minimize_batched(model: GPModel, X, y, maxiter: int,
                     lower=None, upper=None, jitter: float = 0.0):
    """The batched L-BFGS on B independent problems, X (B, n, d) and
    y (B, n), each from the model's hyperparameters, on the model's
    device and dtype, in the box [lower, upper] ((p,), the default box
    when None). Returns batched_lbfgs.minimize's result."""
    flat0 = model.pack().detach()

    def as_(a):
        return torch.as_tensor(a, dtype=flat0.dtype, device=flat0.device)

    X, y = as_(X), as_(y)
    p = flat0.shape[0]
    lb = as_(np.full(p, DEFAULT_LOWER) if lower is None else lower)
    ub = as_(np.full(p, DEFAULT_UPPER) if upper is None else upper)
    vg = batched_value_and_grad(batched_nlml_fn(model, jitter), X, y)
    return batched_lbfgs.minimize(vg, flat0.expand(X.shape[0], p), lb, ub,
                                  maxiter=maxiter)


def make_value_and_grad(model: GPModel, X, y, jitter: float = 0.0,
                        dtype=None):
    """Host-callable value_and_grad(flat numpy) -> (float, float64 grad)
    of the dense NLML, on the model's device (and dtype unless given)."""
    flat0 = model.pack()
    dtype = dtype or flat0.dtype
    device = flat0.device
    Xd = torch.as_tensor(X, dtype=dtype, device=device)
    yd = torch.as_tensor(y, dtype=dtype, device=device)
    f = flat_nlml_fn(model, jitter)

    def value_and_grad(x_np: np.ndarray):
        flat = torch.tensor(np.asarray(x_np, np.float64), dtype=dtype,
                            device=device, requires_grad=True)
        val = f(flat, Xd, yd)
        (grad,) = torch.autograd.grad(val, flat)
        out = torch.cat([val.detach().reshape(1), grad]).cpu()
        return float(out[0]), out[1:].numpy().astype(np.float64)

    return value_and_grad


def resolve_engine(engine: str, n_data: int, model: GPModel) -> str:
    """The engine `fit` runs for `engine`: "dense" or "iterative";
    "auto" picks iterative when N > DENSE_MAX_N, the model supports it
    and it lies on a CUDA device (off the card the streamed operator
    runs its plain version), dense otherwise."""
    eng = engine.lower()
    if eng == "auto":
        eng = ("iterative" if n_data > DENSE_MAX_N
               and supports_iterative(model)
               and model.pack().device.type == "cuda" else "dense")
    if eng not in ("dense", "iterative"):
        raise ValueError(f"Unrecognised engine: {engine}")
    return eng


class _TimedVGrad:
    """Wall-clock wrap that stays transparent: unknown attribute reads
    (last_cg_iters, last_rel_residual, cg_tol, precond_rank) forward to
    the inner closure. Each evaluation ends in a host read of its value,
    so the device work is done when the clock stops."""

    def __init__(self, inner, walls, spans, cg):
        self.inner = inner
        self._walls = walls
        self._spans = spans
        self._cg = cg

    def __call__(self, x):
        t0 = time.perf_counter()
        out = self.inner(x)
        t1 = time.perf_counter()
        self._walls.append(t1 - t0)
        self._spans.append((t0, t1))
        if getattr(self.inner, "last_cg_iters", None) is not None:
            self._cg.append((self.inner.last_cg_iters,
                             self.inner.last_rel_residual))
        return out

    def __getattr__(self, name):  # missing attrs only
        return getattr(self.__dict__["inner"], name)


def fit(
    model: GPModel,
    X,
    y,
    optimizer: str = "LBFGS",
    iters: int = 100,
    lower: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    jitter: float = 0.0,
    verbose: int = 0,
    callback=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    resume: bool = True,
    engine: str = "auto",
    engine_opts: Optional[dict] = None,
    timing: Optional[dict] = None,
    opt_opts: Optional[dict] = None,
) -> Tuple[GPModel, OptResult]:
    """Maximize the marginal likelihood over the box [1e-4, 6]^p, on the
    device of the model's parameters.

    `engine`: "dense" (exact Cholesky NLML, inference/gaussian.py),
    "iterative" (matrix-free CG + SLQ, optim/iterative_fit.py; flagship
    model only, float32), or "auto" (`resolve_engine`).
    `engine_opts` go to make_iterative_value_and_grad; with
    "segmented": True they go to optim/segmented.py's
    make_segmented_value_and_grad instead (stream mode only; "mode" may
    be None, "auto" or "stream"; plain Gaussian likelihood only). On a
    dense engine "segmented" warns and is ignored.

    With `checkpoint_path`, the flat hyper vector is saved every
    `checkpoint_every` iterations and (if `resume`) restored as the
    starting point on the next call: the reference's hypers-only
    checkpoint philosophy applied mid-run (utils/checkpoint.py). The
    batched L-BFGS (`optimizer="JIT"`) starts from a checkpoint but
    saves none, as in the JAX package.

    Pass a dict as `timing` to receive {"backend_touch_s", "eval_s"
    (list), "eval_spans", "n_evals", "eval_s_sum", "eval_s_first",
    "eval_s_steady_median", "pre_first_eval_s", "post_last_eval_s",
    "unconverged_evals", "max_rel_residual"}, and for the iterative
    engine "cg": (CG iterations, achieved relative residual) per
    evaluation. An iterative fit with evaluations whose CG ended above
    its cg_tol warns once, an UnconvergedSolveWarning naming their
    count, the largest relative residual and the cg_tol (a failed solve
    made its evaluation NaN, which the optimizer rejected); the stop
    reason is the optimizer's, as in the JAX package.
    `pre_first_eval_s` counts from the end of the backend touch, so the
    two do not overlap. `opt_opts` go to the optimizer's constructor."""
    t_enter = time.perf_counter()
    device = model.pack().device
    t_ready = t_enter
    if timing is not None:
        # the first device touch of a process (context creation) is
        # environmental: time it apart from the engine's construction
        torch.zeros((), device=device).item()
        t_ready = time.perf_counter()
        timing["backend_touch_s"] = t_ready - t_enter
    x0 = model.pack().detach().cpu().numpy().astype(np.float64)
    if checkpoint_path:
        if resume:
            ck = load_fit_checkpoint(checkpoint_path)
            if ck is not None and ck["x"].shape == x0.shape:
                x0 = ck["x"]
        callback = CheckpointCallback(checkpoint_path, checkpoint_every,
                                      inner=callback)
    p = x0.shape[0]
    lb = np.full(p, DEFAULT_LOWER) if lower is None else np.asarray(lower)
    ub = np.full(p, DEFAULT_UPPER) if upper is None else np.asarray(upper)

    opts = dict(engine_opts or {})
    segmented = opts.pop("segmented", False)
    n_data = int(np.shape(X)[0])
    eng = resolve_engine(engine, n_data, model)
    if (engine.lower() == "auto" and n_data > DENSE_MAX_N
            and eng == "dense" and verbose >= 0):
        warnings.warn(
            f"engine='auto' picked the dense path at N={n_data} "
            "(no CUDA device or unsupported model); expect large "
            "memory cost — pass engine='iterative' to force the "
            "matrix-free route", stacklevel=2)
    if segmented and eng != "iterative":
        warnings.warn(
            f"segmented=True is only honoured by the iterative engine; "
            f"the resolved engine is '{eng}' and the fit will run "
            "un-segmented (pass engine='iterative' to force it)",
            stacklevel=2)
    name = optimizer.upper()
    if name in DEVICE_LOOP and eng == "iterative":
        # the matrix-free objective is driven by the host L-BFGS-B, as
        # in the JAX package
        name = "LBFGS"
    if name in DEVICE_LOOP:
        start = model.unpack(torch.as_tensor(x0, dtype=model.pack().dtype,
                                             device=device))
        return _fit_device_loop(start, X, y, lb, ub, iters, jitter, timing)
    if eng == "iterative":
        opts.setdefault("jitter", jitter)
        if segmented:
            mode = opts.pop("mode", None)
            if mode not in (None, "auto", "stream"):
                raise ValueError(
                    f"segmented=True is stream-only; drop mode={mode!r} "
                    "or run un-segmented")
            vgrad = make_segmented_value_and_grad(model, X, y, **opts)
        else:
            vgrad = make_iterative_value_and_grad(model, X, y, **opts)
    else:
        vgrad = make_value_and_grad(model, X, y, jitter)

    walls: list = []
    spans: list = []
    cg: list = []
    vgrad = _TimedVGrad(vgrad, walls, spans, cg)
    if timing is not None:
        timing["eval_s"] = walls
        timing["eval_spans"] = spans
        if eng == "iterative":
            timing["cg"] = cg

    opt = host_optimizer(name, iters, verbose, **(opt_opts or {}))
    res = opt.minimize(vgrad, x0, lb, ub, callback=callback)
    tol = getattr(vgrad, "cg_tol", None)
    n_bad, max_rel = solve_summary([r for _, r in cg], tol or 0.0)
    if n_bad:
        warnings.warn(unconverged_message(
            "fit", n_bad, len(cg), max_rel, tol), UnconvergedSolveWarning,
            stacklevel=2)
    if timing is not None:
        timing["unconverged_evals"] = n_bad
        timing["max_rel_residual"] = max_rel
    if timing is not None and timing["eval_spans"]:
        spans_ = timing["eval_spans"]
        timing["pre_first_eval_s"] = spans_[0][0] - t_ready
        timing["post_last_eval_s"] = time.perf_counter() - spans_[-1][1]
        walls = timing["eval_s"]
        steady = walls[1:] or walls
        timing["n_evals"] = len(walls)
        timing["eval_s_sum"] = float(np.sum(walls))
        timing["eval_s_first"] = float(walls[0])
        timing["eval_s_steady_median"] = float(np.median(steady))
    return _fitted(model, res, X), res


def host_optimizer(optimizer: str, iters: int, verbose: int = 0, **opts):
    """The host optimizer the CLI's `-o` names ("LBFGS", "BFGS", "SCG";
    gp_ss_ak.cpp:286-293), `opts` to its constructor."""
    name = optimizer.upper()
    if name in ("LBFGS", "LBFGSB", "L-BFGS-B"):
        return LBFGSB(maxiter=iters, verbose=verbose, **opts)
    if name == "BFGS":
        return DenseBFGS(maxiter=iters, verbose=verbose, **opts)
    if name == "SCG":
        return SCG(maxiter=iters, verbose=verbose, **opts)
    raise ValueError(f"Unrecognised optimiser type: {optimizer}")


def _fitted(model: GPModel, res: OptResult, X) -> GPModel:
    flat0 = model.pack()
    fitted = model.unpack(torch.as_tensor(res.x, dtype=flat0.dtype,
                                          device=flat0.device))
    return replace(fitted, num_data=int(np.shape(X)[0]),
                   input_dim=int(np.shape(X)[1]))


def _fit_device_loop(model: GPModel, X, y, lb, ub, iters: int,
                     jitter: float, timing: Optional[dict]):
    """`fit` with the batched L-BFGS on one problem (B = 1), as the JAX
    package's fit runs jax_lbfgs.minimize: no per-evaluation record (the
    result's n_evals is -1), `timing["total_wall_s"]` for the whole fit,
    and the stop reason "device_loop_converged" or "maxiter"."""
    flat0 = model.pack()
    dtype, device = flat0.dtype, flat0.device
    Xd = torch.as_tensor(X, dtype=dtype, device=device)[None]
    yd = torch.as_tensor(y, dtype=dtype, device=device)[None]
    t0 = time.perf_counter()
    out = minimize_batched(model, Xd, yd, iters, lb, ub, jitter)
    x = out.x[0].cpu().numpy().astype(np.float64)
    fun = float(out.fun[0])
    converged = bool(out.converged[0])
    if timing is not None:
        timing["total_wall_s"] = time.perf_counter() - t0
        timing["note"] = ("device-loop optimizer: per-evaluation timing "
                          "not recorded; total_wall_s is the whole fit")
        timing["unconverged_evals"], timing["max_rel_residual"] = 0, 0.0
    res = OptResult(x, fun, int(out.n_iters[0]), -1, converged, [fun],
                    "device_loop_converged" if converged else "maxiter")
    return _fitted(model, res, X), res
