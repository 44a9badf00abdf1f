"""Conjugate-update linear algebra and distribution samplers.

Batched analog of the reference's Bayesian primitives layer
(``pybasicbayes/util/stats.py``: ``sample_gaussian`` (info form),
``sample_invwishart``, ``sample_niw``) — pure functions on ``jax.random``
keys, written to batch cleanly under ``vmap`` (the rebuild replaces the
reference's per-neuron / per-block Python loops with batched Cholesky
factorizations).

The small matrix products here are pinned to full f32 (`_F32`): left at
the backend default, a GPU runs f32 matmuls in TF32, which would leak
~1e-3 relative error into every conjugate posterior.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

_F32 = lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_F32)


def sample_mvn_info(key, h, Lambda):
    """Sample x ~ N(mu, Lambda^{-1}) with mu = Lambda^{-1} h (information form).

    Uses one Cholesky: Lambda = C C^T, mu = C^{-T} C^{-1} h,
    x = mu + C^{-T} eps. Batched via vmap.
    """
    C = jnp.linalg.cholesky(Lambda)
    z = solve_triangular(C, h, lower=True)
    mu = solve_triangular(C.T, z, lower=False)
    eps = jax.random.normal(key, h.shape, dtype=h.dtype)
    return mu + solve_triangular(C.T, eps, lower=False)


class GaussianEvidence(NamedTuple):
    """Pieces of the collapsed spike-and-slab marginal-likelihood ratio."""
    log_evidence: jax.Array   # log integral(exp(w'm - w'Jw/2) N(w; mu0, L0^-1))
    mu_post: jax.Array
    chol_post: jax.Array


def gaussian_evidence(m, J, mu0, Lambda0, chol0_logdet=None):
    """Collapsed Gaussian evidence for one weight block.

    Likelihood exponent in w: w'm - (1/2) w'Jw; prior N(mu0, Lambda0^{-1}).
    Returns log evidence ratio vs the point w=0 (which contributes exp(0)):
        log E = 1/2 mu_p' Lp mu_p - 1/2 mu0' L0 mu0 + 1/2 log|L0| - 1/2 log|Lp|
    with Lp = L0 + J, mu_p = Lp^{-1}(m + L0 mu0).

    This is the per-edge odds kernel of the reference's collapsed
    spike-and-slab resampling (pyglm/regressions.py, _resample_A_W).
    """
    Lp = Lambda0 + J
    Cp = jnp.linalg.cholesky(Lp)
    bpost = m + _mm(Lambda0, mu0)
    z = solve_triangular(Cp, bpost, lower=True)
    mu_p = solve_triangular(Cp.T, z, lower=False)
    quad_p = 0.5 * jnp.sum(z * z)                      # = 1/2 mu_p' Lp mu_p
    quad_0 = 0.5 * jnp.sum(mu0 * _mm(Lambda0, mu0))
    logdet_p = jnp.sum(jnp.log(jnp.diagonal(Cp)))      # = 1/2 log|Lp|
    if chol0_logdet is None:
        C0 = jnp.linalg.cholesky(Lambda0)
        chol0_logdet = jnp.sum(jnp.log(jnp.diagonal(C0)))
    log_ev = quad_p - quad_0 + chol0_logdet - logdet_p
    return GaussianEvidence(log_ev, mu_p, Cp)


def sample_from_evidence(key, ev: GaussianEvidence):
    """Draw w ~ N(mu_post, Lp^{-1}) given a factored posterior."""
    eps = jax.random.normal(key, ev.mu_post.shape, dtype=ev.mu_post.dtype)
    return ev.mu_post + solve_triangular(ev.chol_post.T, eps, lower=False)


# ---------------------------------------------------------------------------
# (Inverse-)Wishart / NIW
# ---------------------------------------------------------------------------

def sample_wishart(key, nu, S):
    """W ~ Wishart(nu, S) via Bartlett decomposition (S = scale matrix).

    nu may be a traced scalar (>= dim - 1).
    """
    dim = S.shape[-1]
    k1, k2 = jax.random.split(key)
    Ls = jnp.linalg.cholesky(S)
    df = nu - jnp.arange(dim, dtype=S.dtype)
    chi2 = 2.0 * jax.random.gamma(k1, 0.5 * df)        # chi^2_{nu-i}
    A = jnp.tril(jax.random.normal(k2, (dim, dim), dtype=S.dtype), -1)
    A = A + jnp.diag(jnp.sqrt(chi2))
    LA = _mm(Ls, A)
    return _mm(LA, LA.T)


def sample_invwishart(key, nu, Psi):
    """Sigma ~ InverseWishart(nu, Psi): Sigma^{-1} ~ Wishart(nu, Psi^{-1})."""
    dim = Psi.shape[-1]
    eye = jnp.eye(dim, dtype=Psi.dtype)
    Psi_inv = jnp.linalg.solve(Psi, eye)
    Psi_inv = 0.5 * (Psi_inv + Psi_inv.T)
    W = sample_wishart(key, nu, Psi_inv)
    Sigma = jnp.linalg.solve(W, eye)
    return 0.5 * (Sigma + Sigma.T)


class NIWParams(NamedTuple):
    mu0: jax.Array     # (D,)
    kappa0: jax.Array  # ()
    nu0: jax.Array     # ()
    Psi0: jax.Array    # (D, D)


def niw_posterior(p: NIWParams, n, xbar, S):
    """Conjugate NIW posterior from sufficient stats (n, mean, scatter).

    S is the centered scatter sum_i (x_i - xbar)(x_i - xbar)^T. Handles n=0
    gracefully (returns the prior).
    """
    n = jnp.asarray(n, p.mu0.dtype)
    kappa_n = p.kappa0 + n
    nu_n = p.nu0 + n
    safe_n = jnp.maximum(n, 1e-12)
    xbar = jnp.where(n > 0, xbar, p.mu0)
    mu_n = (p.kappa0 * p.mu0 + n * xbar) / kappa_n
    d = (xbar - p.mu0)[:, None]
    Psi_n = p.Psi0 + S + (p.kappa0 * n / kappa_n) * _mm(d, d.T)
    del safe_n
    return NIWParams(mu_n, kappa_n, nu_n, Psi_n)


def sample_niw(key, p: NIWParams):
    """(mu, Sigma) ~ NIW(mu0, kappa0, nu0, Psi0)."""
    k1, k2 = jax.random.split(key)
    Sigma = sample_invwishart(k1, p.nu0, p.Psi0)
    C = jnp.linalg.cholesky(Sigma / p.kappa0)
    mu = p.mu0 + _mm(C, jax.random.normal(k2, p.mu0.shape, dtype=p.mu0.dtype))
    return mu, Sigma


# ---------------------------------------------------------------------------
# Misc conjugate draws
# ---------------------------------------------------------------------------

def sample_inverse_gamma(key, alpha, beta):
    """x ~ InvGamma(alpha, beta) (mean beta/(alpha-1))."""
    return beta / jax.random.gamma(key, alpha)


def crt_sample(key, y, r, max_y: int):
    """Chinese-restaurant-table counts l | y, r (Zhou & Carin NB augmentation).

    l = sum_{i=0}^{y-1} Bernoulli(r / (r + i)), elementwise over y.
    `max_y` is the static bound on y (max of the dataset, known at trace
    time). Loops over the table index with masked Bernoulli draws — O(max_y)
    passes over the batch, no data-dependent shapes.
    """
    y = jnp.asarray(y)
    r = jnp.broadcast_to(jnp.asarray(r, jnp.float32), y.shape)

    def body(i, carry):
        l, key = carry
        key, sub = jax.random.split(key)
        p = r / (r + i)
        draw = jax.random.bernoulli(sub, p) & (i < y)
        return l + draw.astype(jnp.int32), key

    l0 = jnp.zeros(y.shape, jnp.int32)
    l, _ = lax.fori_loop(0, max_y, body, (l0, key))
    return l


def logdet_from_chol(C):
    """log|A| given A = C C^T."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(C, axis1=-2, axis2=-1)), axis=-1)


# ---------------------------------------------------------------------------
# Unrolled small-B Cholesky / triangular solves
# ---------------------------------------------------------------------------
# The collapsed spike-and-slab scan performs ~N_pre sequential per-edge
# steps, each factorizing (N, B, B) posteriors with B in {1..8}. At those
# sizes jnp.linalg.cholesky / solve_triangular lower to separate batched
# kernels whose fixed launch latency dominates the sweep (BASELINE.md
# round-2 breakdown). These unrolled forms are pure elementwise arithmetic
# over the batch, so XLA fuses the whole edge step into a few kernels.

_SMALL_B_MAX = 8


def chol_small(A):
    """Cholesky of (..., B, B) SPD matrices, unrolled over static B."""
    B = A.shape[-1]
    if B > _SMALL_B_MAX:
        return jnp.linalg.cholesky(A)
    L = [[None] * B for _ in range(B)]
    for j in range(B):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, B):
            s2 = A[..., i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv_d
    zero = jnp.zeros_like(A[..., 0, 0])
    rows = [jnp.stack([L[i][j] if j <= i else zero for j in range(B)],
                      axis=-1) for i in range(B)]
    return jnp.stack(rows, axis=-2)


def solve_lower_small(L, b):
    """x with L x = b for lower-triangular (..., B, B) L, (..., B) b."""
    B = L.shape[-1]
    if B > _SMALL_B_MAX:
        return solve_triangular(L, b[..., None], lower=True)[..., 0]
    x = [None] * B
    for i in range(B):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)


def solve_lower_t_small(L, b):
    """x with L^T x = b (upper solve via the lower factor, no transpose)."""
    B = L.shape[-1]
    if B > _SMALL_B_MAX:
        return solve_triangular(
            jnp.swapaxes(L, -1, -2), b[..., None], lower=False)[..., 0]
    x = [None] * B
    for i in range(B - 1, -1, -1):
        s = b[..., i]
        for k in range(i + 1, B):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)
