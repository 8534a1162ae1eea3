"""GPModel: hyperparameter container + reference-format model files.

A model file stores ONLY hyperparameters + structure (kernel blocks,
counts); posterior state (alpha / Cholesky) is re-derived from training
data on load (gp_ss_ak.cpp:382-395). The layout matches
ToFile_GP_Params / FromFile_GP_Params (GP_Utils.cpp:1324-1390) and the
kernel block format (Kernel.cpp:20-40, 55-75) line for line, and the
bytes written equal gp_ss_ak_tpu.model.save_model's for the same model.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gp_ss_ak_torch.inference.likelihoods import (
    Gaussian,
    WarpedGaussian,
    make_likelihood,
)
from gp_ss_ak_torch.kernels import Kernel, Sum, make_kernel


@dataclass
class GPModel:
    kernel: Kernel
    kernel_params: object           # params matching kernel
    likelihood: object              # Gaussian | WarpedGaussian
    lik_hypers: torch.Tensor
    mean_hypers: torch.Tensor = field(
        default_factory=lambda: torch.zeros((0,), dtype=torch.float64))
    input_dim: int = 3
    output_dim: int = 1
    num_data: int = 0
    inference: str = "Lapalce"      # the reference's exact (typo'd) string
    mean_function: str = "Zero"

    # -- flat parameter vector: [kernel..., lik..., mean...] -------------
    # (get/set_GP_Pars ordering, GP_Utils.cpp:101-157)
    def pack(self) -> torch.Tensor:
        parts = [self.kernel.pack(self.kernel_params)]
        if self.lik_hypers.numel():
            parts.append(self.lik_hypers)
        if self.mean_hypers.numel():
            parts.append(self.mean_hypers)
        return torch.cat(parts)

    def unpack(self, flat: torch.Tensor) -> "GPModel":
        nk = self.kernel.n_params
        nl = self.lik_hypers.numel()
        kp = self.kernel.unpack(flat[:nk])
        lik = flat[nk : nk + nl]
        mean = flat[nk + nl :]
        return replace(self, kernel_params=kp, lik_hypers=lik,
                       mean_hypers=mean)

    def to(self, dtype: torch.dtype, device: torch.device) -> "GPModel":
        """The same model with every hyperparameter cast to the working
        dtype and moved to `device` (load_model reads float64)."""
        return self.unpack(self.pack().to(device=device, dtype=dtype))

    @property
    def n_params(self) -> int:
        return (self.kernel.n_params + self.lik_hypers.numel()
                + self.mean_hypers.numel())


def default_model(input_dim: int, kernel_names: Optional[List[str]] = None,
                  knoise: bool = True, dtype: torch.dtype = torch.float64,
                  device="cuda") -> GPModel:
    """CLI-equivalent default: Sum([ExpAns..., Bias]) + Gaussian noise
    (gp_ss_ak.cpp:146-196), on `device`: the card unless the caller asks
    for the CPU (without a usable CUDA device, creating it raises)."""
    device = torch.device(device)
    names = kernel_names or ["ExpAns"]
    children = [make_kernel(n) for n in names]
    if knoise:
        children.append(make_kernel("Bias"))
    kern = Sum(children)
    lik = Gaussian()
    return GPModel(
        kernel=kern,
        kernel_params=kern.init_params(dtype, device),
        likelihood=lik,
        lik_hypers=lik.default_hypers(dtype, device),
        mean_hypers=torch.zeros((0,), dtype=dtype, device=device),
        input_dim=input_dim,
    )


def from_flat(kernel_names: Sequence[str], flat, lik_hypers,
              input_dim: int, dtype: torch.dtype,
              device: torch.device, likelihood=None) -> GPModel:
    """A Sum-of-`kernel_names` model from a flat kernel vector.

    Carries weights across from another implementation: `flat` is a
    reference-order flat vector whose first `kernel.n_params` entries
    are the kernel's (e.g. the JAX model's `np.asarray(model.pack())`,
    likelihood entries trailing), and `lik_hypers` the likelihood
    vector, both as numpy arrays. `likelihood` defaults to Gaussian();
    a warped model passes its WarpedGaussian(family, n_triplets)."""
    kern = Sum([make_kernel(n) for n in kernel_names])
    flat_t = torch.tensor(np.asarray(flat, np.float64), dtype=dtype,
                          device=device)
    if flat_t.numel() < kern.n_params:
        raise ValueError(f"{kern!r} needs {kern.n_params} parameters, "
                         f"got {flat_t.numel()}")
    return GPModel(
        kernel=kern,
        kernel_params=kern.unpack(flat_t[: kern.n_params]),
        likelihood=Gaussian() if likelihood is None else likelihood,
        lik_hypers=torch.tensor(
            np.asarray(lik_hypers, np.float64).reshape(-1), dtype=dtype,
            device=device),
        mean_hypers=torch.zeros((0,), dtype=dtype, device=device),
        input_dim=input_dim,
    )


# ---------------------------------------------------------------------------
# reference text model-file format
# ---------------------------------------------------------------------------

def _fmt(v: float) -> str:
    """The reference prints integral values as ints (Kernel.cpp:31-35);
    non-integral values get full precision (%.17g)."""
    f = float(v)
    if f == int(f):
        return str(int(f))
    return f"{f:.17g}"


def _as_f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float64).numpy()


def _write_kernel_with_params(out, kern: Kernel, params, input_dim: int):
    if isinstance(kern, Sum):
        out.write(f"KernelName={kern.name}\n")
        out.write(f"NumberOfKernels={len(kern.children)}\n")
        for c, p in zip(kern.children, params):
            _write_kernel_with_params(out, c, p, input_dim)
        return
    out.write(f"KernelName={kern.name}\n")
    out.write(f"inputDim={input_dim}\n")
    out.write(f"numParams={kern.n_params}\n")
    flat = _as_f64(kern.pack(params))
    out.write(" ".join(_fmt(v) for v in flat) + " \n")


def save_model(model: GPModel, path: str,
               comment: str = "# GP_SS_AK Model File ") -> None:
    with open(path, "w") as out:
        out.write(comment + "\n")
        if isinstance(model.likelihood, WarpedGaussian):
            # comment marker (skipped by the reference's reader,
            # StreamInt.h:81-85) so the warp family survives a round
            # trip — the reference format stores only likelihood=1
            out.write(f"# WarpFamily={model.likelihood.family} "
                      f"Triplets={model.likelihood.n_triplets}\n")
        out.write(f"Inference={model.inference}\n")
        out.write(f"likelihood={model.likelihood.kind}\n")
        out.write(f"MeanFunction={model.mean_function}\n")
        out.write(f"numData={model.num_data}\n")
        out.write(f"outputDim={model.output_dim}\n")
        out.write(f"inputDim={model.input_dim}\n")
        out.write(f"NumHyperKernel={model.kernel.n_params}\n")
        out.write(f"NumHyperLik={model.lik_hypers.numel()}\n")
        out.write(f"NumHyperMean={model.mean_hypers.numel()}\n")
        _write_kernel_with_params(out, model.kernel, model.kernel_params,
                                  model.input_dim)
        for v in _as_f64(model.lik_hypers).reshape(-1):
            out.write(f"Hyperparams_likelihood={_fmt(v)}\n")
        for v in _as_f64(model.mean_hypers).reshape(-1):
            out.write(f"Hyperparams_meanfunction={_fmt(v)}\n")


class _LineReader:
    """key=value line protocol with '#'-comment skipping
    (StreamIntfce::ReadStrStrm, StreamInt.h:75-89)."""

    def __init__(self, text: str):
        self.lines = text.splitlines()
        self.i = 0

    def next_line(self) -> str:
        while self.i < len(self.lines):
            line = self.lines[self.i]
            self.i += 1
            if line.startswith("#"):
                continue
            return line
        raise EOFError("unexpected end of model file")

    def read_kv(self) -> Tuple[str, str]:
        line = self.next_line()
        if "=" not in line:
            raise ValueError(f"expected key=value, got {line!r}")
        k, _, v = line.partition("=")
        return k.strip(), v.strip()

    def expect(self, key: str) -> str:
        k, v = self.read_kv()
        if k != key:
            raise ValueError(f"expected {key}=..., got {k}=...")
        return v


def _read_kernel(r: _LineReader, dtype, device):
    _, name = r.read_kv()  # KernelName=...
    if name == "Hyb":
        n = int(r.expect("NumberOfKernels"))
        children, params = [], []
        for _ in range(n):
            c, p = _read_kernel(r, dtype, device)
            children.append(c)
            params.append(p)
        return Sum(children), tuple(params)
    kern = make_kernel(name)
    int(r.expect("inputDim"))
    nparams = int(r.expect("numParams"))
    if nparams != kern.n_params:
        raise ValueError(
            f"kernel {name}: file has {nparams} params, expected "
            f"{kern.n_params}")
    vals = [float(t) for t in r.next_line().split()]
    flat = torch.tensor(vals, dtype=dtype, device=device)
    return kern, kern.unpack(flat)


def _warp_comment(text: str, triplets: int):
    """(family, triplets) of a warped likelihood from the "# WarpFamily=
    ... Triplets=..." line that save_model writes; tanh1 and `triplets`
    when the file has none (gp_ss_ak_tpu/model.py:228-240)."""
    family = "tanh1"
    for line in text.splitlines():
        if line.startswith("# WarpFamily="):
            toks = line[2:].split()
            family = toks[0].split("=", 1)[1]
            if len(toks) > 1 and toks[1].startswith("Triplets="):
                triplets = int(toks[1].split("=", 1)[1])
            break
    return family, triplets


def load_model(path: str, dtype: torch.dtype = torch.float64,
               device="cuda") -> GPModel:
    """Read a reference-format model file onto `device`: the card unless
    the caller asks for the CPU (without a usable CUDA device, reading
    onto the card raises)."""
    device = torch.device(device)
    with open(path, "r") as f:
        text = f.read()
    r = _LineReader(text)
    inference = r.expect("Inference")
    lik_kind = int(r.expect("likelihood"))
    mean_fn = r.expect("MeanFunction")
    num_data = int(r.expect("numData"))
    output_dim = int(r.expect("outputDim"))
    input_dim = int(r.expect("inputDim"))
    int(r.expect("NumHyperKernel"))
    n_lik = int(r.expect("NumHyperLik"))
    n_mean = int(r.expect("NumHyperMean"))
    kern, kparams = _read_kernel(r, dtype, device)
    lik_hypers = [float(r.expect("Hyperparams_likelihood"))
                  for _ in range(n_lik)]
    mean_hypers = [float(r.expect("Hyperparams_meanfunction"))
                   for _ in range(n_mean)]
    likelihood = make_likelihood(
        lik_kind, *_warp_comment(text, max(1, (n_lik - 1) // 3)))
    return GPModel(
        kernel=kern,
        kernel_params=kparams,
        likelihood=likelihood,
        lik_hypers=torch.tensor(lik_hypers, dtype=dtype, device=device),
        mean_hypers=torch.tensor(mean_hypers, dtype=dtype, device=device),
        input_dim=input_dim,
        output_dim=output_dim,
        num_data=num_data,
        inference=inference,
        mean_function=mean_fn,
    )
