"""Training: glue between GPModel, the NLML and the host
optimizers (the role of GP_utils::OptimisePars + Opt_Algs::Optimise,
GP_Utils.cpp:1288-1301 / Opt_pars.h:176-195). Port of
gp_ss_ak_tpu/optim/api.py.

The objective is a function of the flat hyper vector; its gradient is
torch autograd of the exact NLML (the QW closed-form adjoint by
default). Optimizer names mirror the CLI ("LBFGS", "BFGS", "SCG",
gp_ss_ak.cpp:286-293). The dense objective runs on the device in
float64 (`OBJECTIVE_DTYPE`) whatever the model's dtype, and hands its
value and gradient to the host optimizer in float64; one host read per
evaluation brings them back. The matrix-free engines run in float32.

`optimizer="JIT"` (also "LBFGS-JIT", "DEVICE"; the CLI's `-o JIT`) runs
the batched L-BFGS of optim/batched_lbfgs.py on one problem: the JAX
package's whole-fit device optimizer (optim/jax_lbfgs.py), here a host
loop of batched evaluations whose objective runs in float64
(`OBJECTIVE_DTYPE`). `batched_nlml_fn` is the objective of B
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
from torch.autograd.profiler import record_function

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


#: the arithmetic of the dense and the batched fits' objective, whatever
#: the model's dtype. In float32 the NLML's gradient at 256 deposits x 1024
#: composites, once a fit has taken sn2 below ~1e-3, was off the exact
#: float64 one by a median 0.039 and up to 30.6 of its scale: no better
#: than TF32 products (median 0.235), and still up to 0.54 with the Gram,
#: the factor and the QW adjoint in float64 and only the Gram's backward
#: in float32. In float64: up to 1.6e-4, at 99.9 ms an evaluation
#: against float32's 69.7 (NVIDIA H100 80GB HBM3, 700 W;
#: PERF.md, ens256-fit). At one problem of 16384 points the float32
#: gradient was off by up to 51.3 of its scale at the points L-BFGS-B
#: reaches mid-fit (sn2 ~ 3e-3-7e-3), float64 by 9.7e-10 (PERF.md,
#: dense16k-fit).
OBJECTIVE_DTYPE = torch.float64


def minimize_batched(model: GPModel, X, y, maxiter: int,
                     lower=None, upper=None, jitter: float = 0.0,
                     hook=None):
    """The batched L-BFGS on B independent problems, X (B, n, d) and
    y (B, n), each from the model's hyperparameters, on the model's
    device and dtype, in the box [lower, upper] ((p,), the default box
    when None). Each batched evaluation is a profiler range,
    "ensemble.evaluate"; `hook` sees each one and may end the fit
    (batched_lbfgs.minimize). Returns batched_lbfgs.minimize's
    result.

    The optimizer's state is in the model's dtype; the data go to
    `OBJECTIVE_DTYPE` (float64) as given, and the objective evaluates in
    it and hands its values and gradients back in the model's dtype."""
    flat0 = model.pack().detach()

    def as_(a, dtype=flat0.dtype):
        return torch.as_tensor(a, dtype=dtype, device=flat0.device)

    X, y = as_(X, OBJECTIVE_DTYPE), as_(y, OBJECTIVE_DTYPE)
    p = flat0.shape[0]
    lb = as_(np.full(p, DEFAULT_LOWER) if lower is None else lower)
    ub = as_(np.full(p, DEFAULT_UPPER) if upper is None else upper)
    vg = batched_value_and_grad(batched_nlml_fn(model, jitter), X, y)

    def evaluate(flats):
        with record_function("ensemble.evaluate"):
            f, g = vg(flats.to(OBJECTIVE_DTYPE))
            return f.to(flats.dtype), g.to(flats.dtype)

    return batched_lbfgs.minimize(evaluate, flat0.expand(X.shape[0], p),
                                  lb, ub, maxiter=maxiter, hook=hook)


def make_value_and_grad(model: GPModel, X, y, jitter: float = 0.0):
    """Host-callable value_and_grad(flat numpy) -> (float, float64 grad)
    of the dense NLML on the model's device, evaluated in
    `OBJECTIVE_DTYPE` (float64) whatever the model's dtype: the data go
    to it as given, the point as the optimizer holds it, and the value
    and the gradient come back in float64. Each evaluation is a profiler
    range, "dense_fit.value_and_grad"."""
    device = model.pack().device
    Xd = torch.as_tensor(X, dtype=OBJECTIVE_DTYPE, device=device)
    yd = torch.as_tensor(y, dtype=OBJECTIVE_DTYPE, device=device)
    f = flat_nlml_fn(model, jitter)

    def value_and_grad(x_np: np.ndarray):
        with record_function("dense_fit.value_and_grad"):
            flat = torch.tensor(np.asarray(x_np, np.float64),
                                dtype=Xd.dtype, device=device,
                                requires_grad=True)
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
    """The fit's closure: a wall-clock wrap that stays transparent
    (unknown attribute reads, last_cg_iters, last_rel_residual, cg_tol,
    precond_rank, forward to the inner closure) and keeps the fit's
    record: each evaluation's span and its (point, value, gradient), and
    each iteration's count of evaluations (`end_iteration`; the first's
    includes the start's). Each evaluation ends in a host read of its
    value, so the device work is done when the clock stops."""

    def __init__(self, inner, walls, spans, cg, evals, per_iter):
        self.inner = inner
        self._walls = walls
        self._spans = spans
        self._cg = cg
        self._evals = evals
        self._per_iter = per_iter

    def __call__(self, x):
        t0 = time.perf_counter()
        out = self.inner(x)
        t1 = time.perf_counter()
        self._walls.append(t1 - t0)
        self._spans.append((t0, t1))
        self._evals.append((np.array(x, np.float64), out[0],
                            np.array(out[1], np.float64)))
        if getattr(self.inner, "last_cg_iters", None) is not None:
            self._cg.append((self.inner.last_cg_iters,
                             self.inner.last_rel_residual))
        return out

    def end_iteration(self):
        self._per_iter.append(len(self._walls) - sum(self._per_iter))

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

    `engine`: "dense" (exact Cholesky NLML, inference/gaussian.py,
    evaluated in float64 whatever the model's dtype: `make_value_and_grad`),
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
    "unconverged_evals", "max_rel_residual", "evals" (each evaluation's
    (point, value, gradient), as the optimizer saw it), "evals_per_iter"
    (each iteration's evaluations, the start's counted in the first's)},
    and for the iterative engine "cg": (CG iterations, achieved relative
    residual) per evaluation. "eval_s", "eval_spans", "evals" and
    "evals_per_iter" fill as the fit runs, so a `callback` may read
    them. An iterative fit with evaluations whose CG ended above its
    cg_tol warns once, an UnconvergedSolveWarning naming their
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
    evals: list = []
    per_iter: list = []
    vgrad = _TimedVGrad(vgrad, walls, spans, cg, evals, per_iter)
    if timing is not None:
        timing["eval_s"] = walls
        timing["eval_spans"] = spans
        timing["evals"] = evals
        timing["evals_per_iter"] = per_iter
        if eng == "iterative":
            timing["cg"] = cg

    def iteration_end(it, x, f):
        vgrad.end_iteration()
        if callback is not None:
            callback(it, x, f)

    opt = host_optimizer(name, iters, verbose, **(opt_opts or {}))
    res = opt.minimize(vgrad, x0, lb, ub, callback=iteration_end)
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
    device = model.pack().device
    Xd = torch.as_tensor(X, dtype=OBJECTIVE_DTYPE, device=device)[None]
    yd = torch.as_tensor(y, dtype=OBJECTIVE_DTYPE, device=device)[None]
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
