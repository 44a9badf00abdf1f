"""pyglm_tpu — a Bayesian network-GLM framework on JAX accelerators.

A from-scratch JAX/XLA rebuild of the capability surface of
``slinderman/pyglm`` (fully-Bayesian Gibbs inference for generalized linear
models of neural spike trains with network priors on the synaptic weights),
designed for one accelerator or a mesh of them (an NVIDIA H100 today):

- Polya-gamma auxiliary draws run as vectorized accept-reject kernels over the
  full (T, N) grid (reference: C++/OpenMP ``pypolyagamma``).
- Basis-filtered spike-history design tensors are XLA convolutions
  (reference: ``pyglm/utils/basis.py`` scipy fftconvolve).
- Per-neuron conditionally-Gaussian weight updates are batched Cholesky solves
  on sufficient statistics formed as batched matmuls (reference:
  ``pyglm/regressions.py`` per-neuron numpy loops).
- Spike-and-slab adjacency + network priors (Erdős–Rényi / SBM /
  latent-distance) run inside one jit-compiled Gibbs sweep
  (reference: ``pyglm/networks.py``, ``pyglm/models.py``).
- Multi-device scaling via ``jax.sharding.Mesh`` (neuron × time axes) with
  XLA collectives — no reference analog (reference is single-process NumPy).
"""

__version__ = "0.1.0"

from pyglm_tpu.ops.basis import cosine_basis, convolve_with_basis
from pyglm_tpu.ops.polyagamma import (
    polya_gamma, pg_devroye, pg_gamma_series, pg_draw_unit, pg_mean, pg_var,
)
from pyglm_tpu.models.glm import (  # noqa: E402
    NonlinearAutoregressiveModel,
    GLM,
    BernoulliGLM,
    SparseBernoulliGLM,
    GaussianGLM,
    SparseGaussianGLM,
    NegativeBinomialGLM,
    SparseNegativeBinomialGLM,
    BinomialGLM,
)

__all__ = [
    "cosine_basis",
    "convolve_with_basis",
    "polya_gamma",
    "pg_devroye",
    "pg_gamma_series",
    "pg_mean",
    "pg_var",
    "NonlinearAutoregressiveModel",
    "GLM",
    "BernoulliGLM",
    "SparseBernoulliGLM",
    "GaussianGLM",
    "SparseGaussianGLM",
    "NegativeBinomialGLM",
    "SparseNegativeBinomialGLM",
    "BinomialGLM",
]
