"""Small numeric helpers.

Capability parity with ``pyglm/utils/utils.py`` (logistic/logit, scalar →
array hyperparameter broadcasting), re-expressed for JAX.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

# <repo>/.jax_cache: the repository root holds the package directory.
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for an entry point and
    return its directory. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    already reads it and this sets no directory; otherwise the cache lives
    at the fixed path ``<repo>/.jax_cache`` (listed in .gitignore), so that
    every run of the repository's scripts finds the programs compiled
    before. Call it before the first compilation."""
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = _REPO_CACHE
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache


def logistic(x):
    """Numerically-stable logistic sigmoid."""
    return 1.0 / (1.0 + jnp.exp(-x))


def logit(p):
    return jnp.log(p) - jnp.log1p(-p)


def expand_scalar(x, shape, dtype=np.float32):
    """Broadcast a scalar (or compatible array) hyperparameter to `shape`.

    Mirrors the reference's convention of accepting either scalar or
    fully-specified per-edge hyperparameters (pyglm/utils/utils.py).
    Returns a host numpy array — hyperparameters are static model config.
    """
    x = np.asarray(x, dtype=dtype)
    return np.broadcast_to(x, shape).copy()


def expand_cov(sigma, shape):
    """Broadcast a covariance hyperparameter to a (..., B, B) array.

    Accepts a scalar variance, a (B,) diagonal, a (B, B) matrix, or a fully
    specified (..., B, B) array.
    """
    B = shape[-1]
    assert shape[-2] == B
    sigma = np.asarray(sigma, dtype=np.float32)
    if sigma.ndim == 0:
        cov = sigma * np.eye(B, dtype=np.float32)
    elif sigma.ndim == 1:
        assert sigma.shape == (B,)
        cov = np.diag(sigma).astype(np.float32)
    else:
        cov = sigma.astype(np.float32)
    return np.broadcast_to(cov, shape).copy()


def softplus(x):
    return jnp.logaddexp(x, 0.0)


class PerformanceWarning(UserWarning):
    """The library took a correct-but-slower path than the model's
    configuration implies (e.g. a sharded model ingesting a dataset
    unsharded because T is not divisible by the mesh's time axis, or a
    mesh sweep bypassing the fused spike-and-slab kernel). Results are
    unaffected; throughput is. Filter with
    ``warnings.simplefilter("error", PerformanceWarning)`` to make these
    fatal in performance-critical deployments."""
