"""gp_ss_ak_torch — the PyTorch/CUDA port of gp_ss_ak_tpu.

Anisotropic exponential-kernel GP regression for ore-grade estimation
(the GP_SS_AK capability set), ported from the JAX/Pallas package
gp_ss_ak_tpu, which stays in the repository as the reference. Module
names mirror gp_ss_ak_tpu's. This package imports torch and numpy,
never jax and never gp_ss_ak_tpu.

Ported so far: the serving path — data IO and standardization, the
kernel library, model files, exact Gaussian inference (forward), the
dense `serve.Predictor`, the matrix-free `serve.IterativePredictor`
(pivoted-Cholesky whitened batched CG, inference/iterative.py) and the
CLI's `test` mode with both engines. On a GPU the flagship
Sum([ExpAns, Bias]) Gram runs through the hand-written CUDA kernel
csrc/gram.cu (ops/pairwise.py), and the matrix-free operator through
csrc/matmat.cu (ops/matvec.py).
"""

__version__ = "0.1.0"

from gp_ss_ak_torch import data, inference, kernels, ops  # noqa: F401
from gp_ss_ak_torch.model import GPModel, load_model, save_model  # noqa: F401
