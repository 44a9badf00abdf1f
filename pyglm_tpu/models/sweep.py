"""The jit-compiled Gibbs sweep and autoregressive generation.

Reference analog: ``pyglm/models.py`` (``resample_model`` — the per-neuron
Python loop over regressions followed by the network resample; ``generate``
— the per-bin Python loop). Here one sweep is a single pure function
``state, data, key -> state`` compiled once by XLA, and generation is a
``lax.scan`` over time carrying an L-bin ring buffer.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pyglm_tpu.models.weights import (
    einsum_at, pack_weights, unpack_weights, sufficient_stats,
    resample_spike_slab_tspace, resample_dense,
)


class GLMData(NamedTuple):
    Y: jax.Array    # (T, N) observations
    Xf: jax.Array   # (T, P) flattened design (P = N*B+1, last col = ones)
    # Transposed design (P, T), materialized once at add_data: the
    # residual-space group matmuls consume the design presyn-major, so it
    # is not re-transposed on every sweep.
    Xt: object = None
    # Cached unweighted Gram statistics (Gaussian observations only — there
    # omega = 1/eta_n is constant over time, so X'OmegaX = Gram / eta_n and
    # the per-sweep stat scans over T collapse to broadcasts):
    Gg0: object = None   # (Ng, 1, GB, GB) unweighted group Gram blocks
    Gfull: object = None  # (P, P) unweighted full Gram
    XtY: object = None    # (P, N) X' Y
    # psi-independent log-likelihood summary (observation-family-specific,
    # see observations._FamilyBase.ll_cache): lets the per-sweep LL
    # diagnostic skip the T*N normalizer pass (NB/Binomial gammaln terms).
    llc: object = None


class GLMState(NamedTuple):
    A: jax.Array    # (N, N) adjacency, A[pre, post] in {0, 1}
    W: jax.Array    # (N, N, B) weights (0 where A == 0)
    b: jax.Array    # (N,) biases
    aux: object     # observation-family aux params ({'r': ...}, {'eta': ...})
    net: object     # network-prior state


def make_gibbs_sweep(obs, network, N: int, B: int, spike_slab: bool,
                     t_chunk: int = 512, precision: str = "highest"):
    """Build the jittable one-sweep kernel for a model configuration.

    Gibbs move order (matches reference resample_model: weights/adjacency
    given aux, then observation aux, then network hyperparameters):
      1. psi = Xf @ w;  omega ~ PG(b(y), psi), kappa = kappa(y)
      2. sufficient stats J = X'OmegaX, h = X'kappa  (summed over datasets)
      3. (A, W, bias) — collapsed spike-and-slab or dense conjugate draw
      4. observation aux (NB dispersion r / Gaussian noise eta)
      5. network hyperparameters given (A, W)
    Returns (new_state, diagnostics).
    """

    def sweep(key, state: GLMState, datas: tuple):
        k_pg, k_w, k_aux, k_net = jax.random.split(key, 4)
        w_full = pack_weights(state.A, state.W, state.b)
        hyp = network.edge_hypers(state.net)
        Y_cat = jnp.concatenate([d.Y for d in datas], axis=0)

        # Gaussian observations: omega = 1/eta_n is constant over time, so
        # the weighted Gram stats are cached unweighted Grams / eta
        # (computed once at add_data) instead of per-sweep O(T) scans.
        gaussian_cached = (not obs.needs_pg
                           and all(d.Gg0 is not None for d in datas))

        if spike_slab:
            # Residual-space collapsed update: O(N^2 T B), no Gram stack.
            # Datasets concatenate along time (designs never cross datasets).
            Xf_cat = jnp.concatenate([d.Xf for d in datas], axis=0)
            Xt_cat = (jnp.concatenate([d.Xt for d in datas], axis=1)
                      if all(d.Xt is not None for d in datas) else None)
            psi = einsum_at("tp,pn->tn", Xf_cat, w_full, precision)
            omega, kappa = obs.omega_kappa(k_pg, Y_cat, psi, state.aux)
            Jg = None
            if gaussian_cached:
                Gg0 = sum(d.Gg0 for d in datas)        # (Ng, 1, GB, GB)
                inv_eta = 1.0 / state.aux["eta"]
                Jg = Gg0 * inv_eta[None, :, None, None]
            A, w_full, u, _ = resample_spike_slab_tspace(
                k_w, Xf_cat, omega, kappa, w_full, hyp, B,
                t_chunk=t_chunk, precision=precision, psi=psi, Jg=Jg,
                Xt=Xt_cat)
            # psi under the NEW weights, recovered without a big matmul.
            psi_cat = (kappa - u) / omega
        else:
            P = N * B + 1
            if gaussian_cached:
                inv_eta = 1.0 / state.aux["eta"]
                Gfull = sum(d.Gfull for d in datas)
                XtY = sum(d.XtY for d in datas)
                J_tot = Gfull[None] * inv_eta[:, None, None]   # (N, P, P)
                h_tot = XtY * inv_eta[None, :]
            else:
                J_tot = jnp.zeros((N, P, P), jnp.float32)
                h_tot = jnp.zeros((P, N), jnp.float32)
                for i, d in enumerate(datas):
                    psi = einsum_at("tp,pn->tn", d.Xf, w_full, precision)
                    omega, kappa = obs.omega_kappa(
                        jax.random.fold_in(k_pg, i), d.Y, psi, state.aux)
                    J, h = sufficient_stats(
                        d.Xf, omega, kappa,
                        t_chunk=t_chunk, precision=precision)
                    J_tot = J_tot + J
                    h_tot = h_tot + h
            w_full = resample_dense(k_w, J_tot, h_tot, hyp, B)
            A = jnp.ones((N, N), jnp.float32)
            psi_cat = jnp.concatenate(
                [einsum_at("tp,pn->tn", d.Xf, w_full, precision)
                 for d in datas], axis=0)

        W, b = unpack_weights(w_full, N, B)
        # Dataset ll caches are additive summaries (counts / scalar sums),
        # so concatenation over datasets = summing the caches.
        caches = [d.llc for d in datas]
        llc_tot = (jax.tree.map(lambda *xs: sum(xs), *caches)
                   if caches and all(c is not None for c in caches) else None)
        # The cache also feeds the NB collapsed-CRT r update (the count
        # table supplies the per-table-index binomial trial counts).
        aux = obs.resample_aux(k_aux, state.aux, Y_cat, psi_cat,
                               cache=llc_tot)
        net = network.resample(k_net, state.net, A, W)
        ll = obs.log_likelihood_sum(Y_cat, psi_cat, aux, llc_tot)
        diag = {"log_likelihood": ll, "n_edges": jnp.sum(A)}
        if hasattr(net, "hmc_accept"):
            diag["hmc_accept"] = net.hmc_accept
        return GLMState(A, W, b, aux, net), diag

    return sweep


def make_log_likelihood(obs, N: int, B: int, precision: str = "highest"):
    def log_likelihood(state: GLMState, data: GLMData):
        w_full = pack_weights(state.A, state.W, state.b)
        psi = einsum_at("tp,pn->tn", data.Xf, w_full, precision)
        return jnp.sum(obs.log_likelihood(data.Y, psi, state.aux))
    return log_likelihood


def make_generator(obs, N: int, B: int):
    """Autoregressive forward simulation via lax.scan with an L-bin ring
    buffer (reference: pyglm/models.py generate — per-bin Python loop).

    `ring0` (the last L bins of observed history) makes this a posterior-
    predictive forecaster; zeros = generation from silence."""

    def generate(key, state: GLMState, basis, T: int, ring0=None):
        L = basis.shape[0]
        basis_rev = jnp.asarray(basis, jnp.float32)[::-1]       # (L, B)
        Weff = state.A[:, :, None] * state.W                    # (N, N, B)

        def step(ring, k_t):
            # X[t, j, b] = sum_i ring[i, j] * basis_rev[i, b]
            F = jnp.einsum("ij,ib->jb", ring, basis_rev,
                           precision=lax.Precision.HIGHEST)
            psi = state.b + jnp.einsum("jb,jnb->n", F, Weff,
                                       precision=lax.Precision.HIGHEST)
            y = obs.sample(k_t, psi[None, :], state.aux)[0]
            ring = jnp.concatenate([ring[1:], y[None, :]], axis=0)
            return ring, (y, psi)

        keys = jax.random.split(key, T)
        if ring0 is None:
            ring0 = jnp.zeros((L, N), jnp.float32)
        _, (Y, psi) = lax.scan(step, ring0, keys)
        return Y, psi

    return generate


def init_state_from_prior(key, obs, network, N: int, B: int,
                          spike_slab: bool) -> GLMState:
    """Draw (A, W, b, aux, net) from the model prior — used both to
    initialize Gibbs chains and to build ground-truth generative models."""
    k_net, k_a, k_w, k_b = jax.random.split(key, 4)
    net = network.init_state(k_net)
    hyp = network.edge_hypers(net)
    if spike_slab:
        from pyglm_tpu.utils.utils import logistic
        A = jax.random.bernoulli(k_a, logistic(hyp.logit_rho)).astype(jnp.float32)
    else:
        A = jnp.ones((N, N), jnp.float32)
    # W_ij ~ N(mu_ij, Lam_ij^{-1}) batched over all N^2 edges. With
    # Lam = L L', x = mu + L^{-T} eps has covariance L^{-T} L^{-1} = Lam^{-1}
    # — no batched library inv/cholesky over 40k 4x4 blocks; the unrolled
    # small-B forms fuse to elementwise code.
    from pyglm_tpu.ops.linalg import chol_small, solve_lower_t_small
    eps = jax.random.normal(k_w, (N, N, B))
    W = hyp.mu + solve_lower_t_small(chol_small(hyp.Lam), eps)
    W = W * A[:, :, None]
    b = hyp.mu_b + jax.random.normal(k_b, (N,)) / jnp.sqrt(hyp.lam_b)
    aux = obs.init_aux(N)
    return GLMState(A, W, b, aux, net)
