"""Geweke joint-distribution test for the Gibbs sweep.

The successive-conditional simulator alternates
    data   ~ p(Y | theta)        (forward generation)
    theta  ~ Gibbs(theta | Y)    (one full sweep)
whose stationary marginal over theta must equal the *prior* — any bug in any
conditional update shows up as a drift away from the prior marginals. This is
the ecosystem-canonical correctness test for Linderman-style Gibbs samplers
(SURVEY.md §4: pyhawkes test/geweke*; the pre-rewrite pyglm had the same).

The chain runs as compiled ``lax.scan`` segments — generation, design
convolution, and the sweep are a single compiled program, so a
2000-iteration Geweke chain takes seconds rather than the reference's
minutes. The scan is segmented at the host level (``seg_iters``), which
bounds the device memory that holds a segment's per-iteration summaries
before they are copied to the host. Segmenting is bitwise-identical to the
monolithic scan: the per-iteration keys are precomputed from one split, and
the carry stays on device between segments.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from pyglm_tpu.ops.basis import design_matrix
from pyglm_tpu.models.sweep import (
    GLMData, make_gibbs_sweep, make_generator, init_state_from_prior,
)


def geweke_chain(key, obs, network, N: int, B: int, basis, T: int,
                 spike_slab: bool, n_iters: int = 2000, t_chunk: int = 64,
                 precision: str = "highest", with_xt: bool = False,
                 with_llc: bool = False, seg_iters: int = 500):
    """Run the successive-conditional simulator; returns per-iteration
    parameter summaries (host numpy dict).

    Collected series: bias (n, N), A_density (n,), n_active, W_sum, W_sq
    (n,), y_max (n,) — the largest regenerated observation — plus
    network/obs-specific scalars when present (rho, r, eta).

    ``seg_iters`` is the number of iterations one compiled scan runs before
    its summaries are copied to the host.

    ``with_xt=True`` registers the transposed design with each dataset, as
    ``add_data`` does, so the chain runs the same residual-space group
    matmuls as a fitted model.

    ``with_llc=True`` registers the psi-independent LL cache with each
    regenerated dataset (via the family's traced ``ll_cache`` path), so the
    cache-consuming conditionals — the NB collapsed-CRT r update and the
    cached LL normalizer — face the joint-distribution test instead of the
    elementwise fallbacks.
    """
    sweep = make_gibbs_sweep(obs, network, N, B, spike_slab, t_chunk=t_chunk,
                             precision=precision)
    gen = make_generator(obs, N, B)
    basis = jnp.asarray(basis, jnp.float32)

    k_init, k_chain = jax.random.split(key)
    state0 = init_state_from_prior(k_init, obs, network, N, B, spike_slab)

    def step(state, k):
        k1, k2 = jax.random.split(k)
        Y, _ = gen(k1, state, basis, T)
        Xf = design_matrix(Y, basis)
        data = GLMData(Y=Y, Xf=Xf, Xt=Xf.T if with_xt else None,
                       llc=obs.ll_cache(Y) if with_llc else None)
        state, _ = sweep(k2, state, (data,))
        n_act = jnp.sum(state.A)
        Wsum = jnp.sum(state.W)                    # inactive entries are 0
        Wsq = jnp.sum(state.W ** 2)
        out = {
            "bias": state.b,
            "A_density": n_act / state.A.size,
            "n_active": n_act,
            "W_sum": Wsum,
            "W_sq": Wsq,
            # Max regenerated observation: the first thing to check when a
            # count-family chain corrupts. The exp-link NB autoregression is
            # explosive for supercritical prior configs — a runaway shows up
            # here as y_max ~ 1e6 (the generator's lam clamp) one iteration
            # before the f32 overflow cascade NaNs the state.
            "y_max": jnp.max(Y),
        }
        if hasattr(state.net, "rho"):
            out["rho"] = state.net.rho
        if hasattr(state.net, "mu") and hasattr(state.net, "Sigma"):
            # learned Gaussian weight-prior hypers (shared for dense/ER/
            # latent-distance; per-block for SBM)
            out["prior_mu"] = state.net.mu
            out["prior_Sigma"] = state.net.Sigma
        if hasattr(state.net, "pi"):
            out["pi"] = state.net.pi
        if hasattr(state.net, "c"):
            K = state.net.pi.shape[0]
            out["c_frac"] = jnp.mean(
                jax.nn.one_hot(state.net.c, K), axis=0)   # (K,)
        if isinstance(state.aux, dict):
            for k_aux, v in state.aux.items():
                out[k_aux] = v
        return state, out

    keys = jax.random.split(k_chain, n_iters)
    seg = max(1, min(int(seg_iters), n_iters))
    n_seg = -(-n_iters // seg)
    pad = n_seg * seg - n_iters
    if pad:
        # pad with copies of the last key so every segment has the static
        # length `seg` (one compile); padded iterations are discarded below.
        keys = jnp.concatenate([keys, jnp.repeat(keys[-1:], pad, axis=0)])
    run = jax.jit(lambda s, ks: lax.scan(step, s, ks))
    state, chunks = state0, []
    for i in range(n_seg):
        state, out = run(state, keys[i * seg:(i + 1) * seg])
        # pull each segment to host immediately: bounds the device-side
        # output footprint.
        chunks.append({k: np.asarray(v) for k, v in out.items()})
    return {k: np.concatenate([c[k] for c in chunks])[:n_iters]
            for k in chunks[0]}


def ks_two_sample(samples, reference, thin: int = 1):
    """Two-sample KS statistic between (optionally thinned) samples and a
    reference sample. Returns (ks, threshold) at alpha ~ 1e-4
    (c(alpha) ~ 1.95), using the thinned count as the effective sample size
    — conservative only if thinning clears the chain's autocorrelation time
    (for iid samplers use thin=1).

    Used by the PG sampler exactness tests (gamma-series vs the native
    exact-convolution oracle) and the Geweke prior-marginal KS checks.
    """
    s = np.sort(np.asarray(samples, np.float64)[::thin].ravel())
    p = np.sort(np.asarray(reference, np.float64).ravel())
    grid = np.concatenate([s, p])
    cdf_s = np.searchsorted(s, grid, side="right") / len(s)
    cdf_p = np.searchsorted(p, grid, side="right") / len(p)
    ks = float(np.max(np.abs(cdf_s - cdf_p)))
    n_eff = len(s) * len(p) / (len(s) + len(p))
    thresh = 1.95 / np.sqrt(n_eff)
    return ks, thresh
