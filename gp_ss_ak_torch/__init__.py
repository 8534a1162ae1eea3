"""gp_ss_ak_torch — the PyTorch/CUDA port of gp_ss_ak_tpu.

Anisotropic exponential-kernel GP regression for ore-grade estimation
(the GP_SS_AK capability set), ported from the JAX/Pallas package
gp_ss_ak_tpu, which stays in the repository as the reference. Module
names mirror gp_ss_ak_tpu's. This package imports torch and numpy,
never jax and never gp_ss_ak_tpu.

Ported so far: the serving and training paths — data IO (with the
native text parser) and standardization, the kernel library, model
files, exact Gaussian and warped-Gaussian inference with their
gradients, the jitter-retry factorization, the host optimizers and
`optim.fit`, the
matrix-free engine (inference/iterative.py: CG, SLQ, the Hutchinson
gradient), the dense `serve.Predictor`, the matrix-free
`serve.IterativePredictor`, and the CLI's `train` and `test`; the
batched paths: the batched L-BFGS behind `optim.fit(optimizer="JIT")`
and `train -o JIT` (optim/batched_lbfgs.py), multi-deposit ensembles
(ensemble/), and HMC/NUTS hyperposteriors (bayes/). On a GPU the
flagship Sum([ExpAns, Bias]) Gram runs through the hand-written CUDA
kernel csrc/gram.cu (ops/pairwise.py; one launch for a batch of
problems), and the matrix-free operator
through csrc/matmat.cu and csrc/matvec.cu (ops/matvec.py). Entry points
run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from gp_ss_ak_torch import data, inference, kernels, ops  # noqa: F401
from gp_ss_ak_torch.model import GPModel, load_model, save_model  # noqa: F401
