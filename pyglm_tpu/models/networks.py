"""Network priors on the synaptic adjacency/weights (A, W).

Capability parity with ``pyglm/networks.py`` (dense / independent-sparse
Erdős–Rényi / stochastic-block / latent-distance network models), rebuilt
functionally: each prior is a frozen config dataclass with

  init_state(key)            -> pytree of sampled hyperparameters
  edge_hypers(state)         -> EdgeHypers (per-edge mu, Lambda, logit rho)
  resample(key, state, A, W) -> new state  (one Gibbs move on hyperparams)

All N^2 directed edges (including self-connections) carry priors, matching
the reference's autoregressive self-history edges.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

import numpy as np

from pyglm_tpu.models.weights import EdgeHypers
from pyglm_tpu.ops.linalg import (
    NIWParams, niw_posterior, sample_niw,
)
from pyglm_tpu.utils.utils import expand_cov, expand_scalar, logit

# Network-prior contractions feed conjugate and HMC acceptance steps: full
# f32, never the backend's reduced-precision default (TF32 on a GPU).
_F32 = lax.Precision.HIGHEST


def _bias_hypers(cfg, N):
    """Bias prior hypers; mu_bias / sigma_bias may be scalar or (N,) —
    the reference accepts scalar OR fully-specified hyperparameters
    (pyglm/utils/utils.py expand_scalar convention)."""
    mu_b = jnp.asarray(expand_scalar(cfg.mu_bias, (N,)))
    sig_b = jnp.asarray(expand_scalar(cfg.sigma_bias, (N,)))
    return mu_b, 1.0 / sig_b ** 2


def _is_scalar(x) -> bool:
    return np.ndim(x) == 0


def _fixed_weight_hypers(cfg):
    """Per-edge (mu, Lam) from config when the weight prior is FIXED
    (learn_weight_prior=False): mu_w may be scalar | (B,) | (N,N,B);
    sigma_w (a variance) may be scalar | (B,) diag | (B,B) | (N,N,B,B)."""
    N, B = cfg.N, cfg.B
    mu = jnp.asarray(expand_scalar(getattr(cfg, "mu_w", 0.0), (N, N, B)))
    Sig = jnp.asarray(expand_cov(cfg.sigma_w, (N, N, B, B)))
    return mu, jnp.linalg.inv(Sig)


def _sigma_w_scalar(cfg) -> float:
    """Scalar summary of sigma_w for state initialization (exact when
    sigma_w is scalar; learned priors overwrite it after one sweep)."""
    s = np.asarray(cfg.sigma_w, np.float32)
    return float(s.mean())


def _niw_params(cfg) -> NIWParams:
    B = cfg.B
    return NIWParams(
        mu0=jnp.full((B,), cfg.niw_mu0, jnp.float32),
        kappa0=jnp.asarray(cfg.niw_kappa0, jnp.float32),
        nu0=jnp.asarray(cfg.niw_nu0 if cfg.niw_nu0 is not None else B + 2,
                        jnp.float32),
        Psi0=jnp.eye(B, dtype=jnp.float32) * cfg.niw_psi0,
    )


def _masked_niw_resample(key, cfg, W, mask):
    """(mu, Sigma) ~ NIW posterior from active-edge weights W[mask].

    Masked sufficient stats keep shapes static under jit (the reference
    gathers W[A==1] into a ragged array; here inactive edges contribute 0).
    """
    m = mask[..., None]
    n = jnp.sum(mask)
    xbar = jnp.sum(m * W, axis=(0, 1)) / jnp.maximum(n, 1e-12)
    diffs = (W - xbar) * m
    S = jnp.einsum("ijb,ijc->bc", diffs, diffs, precision=_F32)
    post = niw_posterior(_niw_params(cfg), n, xbar, S)
    return sample_niw(key, post)


# ---------------------------------------------------------------------------
# Dense (fixed rho = 1) and Erdős–Rényi (independent sparse) networks
# ---------------------------------------------------------------------------

class GaussianWeightsState(NamedTuple):
    mu: jax.Array      # (B,) shared weight prior mean
    Sigma: jax.Array   # (B, B) shared weight prior covariance
    rho: jax.Array     # () global connection probability


@dataclass(frozen=True)
class DenseNetworkConfig:
    """All edges present (rho=1); shared NIW-learned Gaussian weight prior,
    or a FIXED (optionally per-edge) Gaussian prior when
    learn_weight_prior=False — mu_w / sigma_w / mu_bias / sigma_bias each
    accept scalar or fully-specified arrays (reference convention).

    Reference analog: pyglm/networks.py dense Gaussian network w/ NIW.
    """
    N: int
    B: int
    mu_bias: object = -2.0       # scalar | (N,)
    sigma_bias: object = 1.0     # scalar | (N,)
    learn_weight_prior: bool = True
    niw_mu0: float = 0.0
    niw_kappa0: float = 1.0
    niw_nu0: float | None = None
    niw_psi0: float = 1.0
    mu_w: object = 0.0           # scalar | (B,) | (N,N,B); fixed prior only
    sigma_w: object = 1.0        # scalar | (B,) | (B,B) | (N,N,B,B) variance
    name: str = "dense"

    def __post_init__(self):
        if self.learn_weight_prior and not (
                _is_scalar(self.sigma_w) and _is_scalar(self.mu_w)):
            raise ValueError(
                "per-edge mu_w/sigma_w require learn_weight_prior=False "
                "(the learned prior is shared across edges)")

    def init_state(self, key) -> GaussianWeightsState:
        B = self.B
        return GaussianWeightsState(
            mu=jnp.zeros((B,), jnp.float32),
            Sigma=jnp.eye(B, dtype=jnp.float32) * _sigma_w_scalar(self),
            rho=jnp.asarray(1.0, jnp.float32),
        )

    def edge_hypers(self, state: GaussianWeightsState) -> EdgeHypers:
        N, B = self.N, self.B
        if self.learn_weight_prior:
            Lam = jnp.linalg.inv(state.Sigma)
            mu = jnp.broadcast_to(state.mu, (N, N, B))
            Lam = jnp.broadcast_to(Lam, (N, N, B, B))
        else:
            mu, Lam = _fixed_weight_hypers(self)
        # rho == 1: logit clipped to keep spike-slab numerics finite if a
        # sparse resampler is (mis)configured on a dense prior.
        lrho = jnp.full((N, N), 20.0, jnp.float32)
        mu_b, lam_b = _bias_hypers(self, N)
        return EdgeHypers(mu, Lam, lrho, mu_b, lam_b)

    def resample(self, key, state: GaussianWeightsState, A, W):
        if not self.learn_weight_prior:
            return state
        mu, Sigma = _masked_niw_resample(key, self, W, A)
        return GaussianWeightsState(mu, Sigma, state.rho)


@dataclass(frozen=True)
class ErdosRenyiConfig:
    """Independent-Bernoulli sparsity: A_ij ~ Bern(rho), rho ~ Beta(a, b);
    shared (optionally NIW-learned) Gaussian weight prior on active edges.

    Reference analog: pyglm/networks.py independent/sparse network.
    """
    N: int
    B: int
    a_rho: float = 1.0
    b_rho: float = 1.0
    rho_init: object = 0.25      # scalar | (N,N) per-edge (learn_rho=False)
    learn_rho: bool = True
    mu_bias: object = -2.0       # scalar | (N,)
    sigma_bias: object = 1.0     # scalar | (N,)
    learn_weight_prior: bool = True
    niw_mu0: float = 0.0
    niw_kappa0: float = 1.0
    niw_nu0: float | None = None
    niw_psi0: float = 1.0
    mu_w: object = 0.0           # scalar | (B,) | (N,N,B); fixed prior only
    sigma_w: object = 1.0        # scalar | (B,) | (B,B) | (N,N,B,B) variance
    name: str = "erdos_renyi"

    def __post_init__(self):
        if self.learn_rho and not _is_scalar(self.rho_init):
            raise ValueError(
                "per-edge rho_init requires learn_rho=False (the learned "
                "rho is a single shared Beta-posterior draw)")
        if self.learn_weight_prior and not (
                _is_scalar(self.sigma_w) and _is_scalar(self.mu_w)):
            raise ValueError(
                "per-edge mu_w/sigma_w require learn_weight_prior=False")

    def init_state(self, key) -> GaussianWeightsState:
        return GaussianWeightsState(
            mu=jnp.zeros((self.B,), jnp.float32),
            Sigma=jnp.eye(self.B, dtype=jnp.float32) * _sigma_w_scalar(self),
            rho=jnp.asarray(np.mean(self.rho_init), jnp.float32),
        )

    def edge_hypers(self, state: GaussianWeightsState) -> EdgeHypers:
        N, B = self.N, self.B
        if self.learn_weight_prior:
            Lam = jnp.linalg.inv(state.Sigma)
            mu = jnp.broadcast_to(state.mu, (N, N, B))
            Lam = jnp.broadcast_to(Lam, (N, N, B, B))
        else:
            mu, Lam = _fixed_weight_hypers(self)
        if self.learn_rho:
            rho = jnp.broadcast_to(state.rho, (N, N))
        else:
            rho = jnp.asarray(expand_scalar(self.rho_init, (N, N)))
        lrho = logit(jnp.clip(rho, 1e-5, 1.0 - 1e-5))
        mu_b, lam_b = _bias_hypers(self, N)
        return EdgeHypers(mu, Lam, lrho, mu_b, lam_b)

    def resample(self, key, state: GaussianWeightsState, A, W):
        k1, k2 = jax.random.split(key)
        rho = state.rho
        if self.learn_rho:
            n_act = jnp.sum(A)
            n_tot = A.size
            rho = jax.random.beta(
                k1, self.a_rho + n_act, self.b_rho + n_tot - n_act)
        mu, Sigma = state.mu, state.Sigma
        if self.learn_weight_prior:
            mu, Sigma = _masked_niw_resample(k2, self, W, A)
        return GaussianWeightsState(mu, Sigma, rho)


# ---------------------------------------------------------------------------
# Stochastic block model
# ---------------------------------------------------------------------------

class SBMState(NamedTuple):
    c: jax.Array        # (N,) int32 block labels
    pi: jax.Array       # (K,) block probabilities
    rho: jax.Array      # (K, K) block connection probabilities
    mu: jax.Array       # (K, K, B) block weight means
    Sigma: jax.Array    # (K, K, B, B) block weight covariances


@dataclass(frozen=True)
class SBMConfig:
    """Stochastic block model: c_n ~ Cat(pi), A_ij ~ Bern(rho[c_i, c_j]),
    W_ij ~ N(mu[c_i, c_j], Sigma[c_i, c_j]) on active edges.

    Label resampling is a sequential Gibbs scan over neurons (labels
    interact through shared edges) consuming precomputed (K, K, N, N)
    edge-loglik tables — O(N^2 K^2) vectorized work + an O(N) scan, vs the
    reference's pure-Python O(N^2 K) loop (pyglm/networks.py SBM).
    """
    N: int
    B: int
    K: int = 5
    alpha_pi: float = 1.0
    a_rho: float = 1.0
    b_rho: float = 1.0
    mu_bias: float = -2.0
    sigma_bias: float = 1.0
    niw_mu0: float = 0.0
    niw_kappa0: float = 1.0
    niw_nu0: float | None = None
    niw_psi0: float = 1.0
    sigma_w: float = 1.0
    rho_init: float = 0.25
    name: str = "sbm"

    def init_state(self, key) -> SBMState:
        N, B, K = self.N, self.B, self.K
        k1, k2 = jax.random.split(key)
        c = jax.random.randint(k1, (N,), 0, K)
        pi = jnp.full((K,), 1.0 / K, jnp.float32)
        rho = jnp.full((K, K), self.rho_init, jnp.float32)
        mu = jnp.zeros((K, K, B), jnp.float32)
        Sigma = jnp.broadcast_to(
            jnp.eye(B, dtype=jnp.float32) * self.sigma_w, (K, K, B, B)).copy()
        return SBMState(c, pi, rho, mu, Sigma)

    def edge_hypers(self, state: SBMState) -> EdgeHypers:
        N, B = self.N, self.B
        ci, cj = state.c[:, None], state.c[None, :]
        mu = state.mu[ci, cj]                  # (N, N, B)
        Lam_blocks = jnp.linalg.inv(state.Sigma)   # (K, K, B, B)
        Lam = Lam_blocks[ci, cj]
        lrho = logit(jnp.clip(state.rho, 1e-5, 1 - 1e-5))[ci, cj]
        mu_b, lam_b = _bias_hypers(self, N)
        return EdgeHypers(mu, Lam, lrho, mu_b, lam_b)

    def _edge_tables(self, state: SBMState, A, W):
        """tbl[k1,k2,i,j] = log Bern(A_ij; rho[k1,k2])
        + A_ij * log N(W_ij; mu[k1,k2], Sigma[k1,k2])."""
        K, B = self.K, self.B
        rho = jnp.clip(state.rho, 1e-5, 1 - 1e-5)
        logB = (A[None, None] * jnp.log(rho)[:, :, None, None]
                + (1 - A)[None, None] * jnp.log1p(-rho)[:, :, None, None])
        Lam = jnp.linalg.inv(state.Sigma)                     # (K,K,B,B)
        C = jnp.linalg.cholesky(state.Sigma)
        logdet = 2 * jnp.sum(
            jnp.log(jnp.diagonal(C, axis1=-2, axis2=-1)), axis=-1)  # (K,K)
        d = W[None, None] - state.mu[:, :, None, None]        # (K,K,N,N,B)
        quad = jnp.einsum("xyijb,xybc,xyijc->xyij", d, Lam, d,
                          precision=_F32)
        logN = -0.5 * (quad + logdet[:, :, None, None]
                       + B * jnp.log(2 * jnp.pi))
        return logB + A[None, None] * logN

    def resample(self, key, state: SBMState, A, W):
        N, K, B = self.N, self.K, self.B
        k_lab, k_pi, k_rho, k_niw = jax.random.split(key, 4)

        # --- labels: sequential Gibbs scan over neurons -------------------
        tbl = self._edge_tables(state, A, W)                  # (K,K,N,N)
        tblT = tbl.transpose(0, 1, 3, 2)
        onehot = jax.nn.one_hot(state.c, K)                   # (N, K)
        keys = jax.random.split(k_lab, N)

        def body(onehot, xs):
            n, kn = xs
            out_t = lax.dynamic_slice(
                tbl, (0, 0, n, 0), (K, K, 1, N))[:, :, 0, :]
            in_t = lax.dynamic_slice(
                tblT, (0, 0, n, 0), (K, K, 1, N))[:, :, 0, :]
            # The self-edge n->n carries the candidate label on BOTH ends:
            # exclude it from the outgoing and incoming sums (which pair the
            # candidate with the OTHER neurons' current labels) and add
            # tbl[x, x, n, n] once.
            self_mask = 1.0 - jax.nn.one_hot(n, N)
            masked = onehot * self_mask[:, None]
            ll_out = jnp.einsum("xpm,mp->x", out_t, masked, precision=_F32)
            ll_in = jnp.einsum("pxm,mp->x", in_t, masked, precision=_F32)
            self_t = lax.dynamic_slice(out_t, (0, 0, n), (K, K, 1))[:, :, 0]
            ll_self = jnp.diagonal(self_t)
            logits = jnp.log(state.pi + 1e-12) + ll_out + ll_in + ll_self
            cn = jax.random.categorical(kn, logits)
            onehot = onehot.at[n].set(jax.nn.one_hot(cn, K))
            return onehot, cn

        onehot, c = lax.scan(body, onehot, (jnp.arange(N), keys))

        # --- block hyperparameters ---------------------------------------
        counts = jnp.sum(onehot, axis=0)                      # (K,)
        pi = jax.random.dirichlet(k_pi, self.alpha_pi + counts)
        pair = jnp.einsum("ix,jy->xyij", onehot, onehot,
                          precision=_F32)                 # (K,K,N,N)
        n_pair = jnp.sum(pair, axis=(2, 3))
        n_act = jnp.einsum("xyij,ij->xy", pair, A, precision=_F32)
        rho = jax.random.beta(k_rho, self.a_rho + n_act,
                              self.b_rho + n_pair - n_act)

        mask = pair * A[None, None]                           # (K,K,N,N)
        n_w = jnp.sum(mask, axis=(2, 3))
        xbar = (jnp.einsum("xyij,ijb->xyb", mask, W, precision=_F32)
                / jnp.maximum(n_w, 1e-12)[..., None])
        d = W[None, None] - xbar[:, :, None, None]
        S = jnp.einsum("xyij,xyijb,xyijc->xybc", mask, d, d,
                       precision=_F32)
        niw0 = _niw_params(self)

        def block_niw(kk, n, xb, Sb):
            post = niw_posterior(niw0, n, xb, Sb)
            return sample_niw(kk, post)

        kks = jax.random.split(k_niw, K * K).reshape(K, K)
        mu, Sigma = jax.vmap(jax.vmap(block_niw))(
            kks, n_w, xbar, S)
        return SBMState(c.astype(jnp.int32), pi, rho, mu, Sigma)


# ---------------------------------------------------------------------------
# Latent-distance network
# ---------------------------------------------------------------------------

class LatentDistanceState(NamedTuple):
    L: jax.Array        # (N, dim) latent positions
    gamma: jax.Array    # () connection-probability offset
    mu: jax.Array       # (B,) shared weight prior mean
    Sigma: jax.Array    # (B, B)
    hmc_accept: jax.Array = jnp.asarray(0.0, jnp.float32)  # last-sweep rate


@dataclass(frozen=True)
class LatentDistanceConfig:
    """rho_ij = logistic(-||l_i - l_j||^2 + gamma); (l, gamma) sampled by
    jitted leapfrog HMC with autodiff gradients (the reference hand-codes
    the HMC gradient; pyglm/networks.py latent-distance model).
    """
    N: int
    B: int
    dim: int = 2
    sigma_l: float = 1.0
    sigma_gamma: float = 2.0
    gamma_init: float = 0.0
    # HMC step size must shrink with N (the potential's curvature grows
    # ~N with the number of edge terms per position; leapfrog stability
    # needs eps ~ 1/sqrt(N)). None -> 0.15/sqrt(N), which measured ~0.9
    # acceptance at N=500 where the old fixed 0.01 accepted 0.2% of
    # trajectories and froze the positions (round-2 config-5 analysis).
    hmc_eps: float | None = None
    hmc_steps: int = 50
    hmc_iters: int = 10         # HMC trajectories per Gibbs sweep (cheap:
                                # each costs O(N^2) vs the sweep's O(N^2 T B))
    # Discrete position moves run after HMC each sweep — HMC transports
    # the embedding locally but cannot jump between embedding modes (the
    # round-2 config-5 analysis measured a fresh-chain AUC plateau of
    # ~0.80 against a 0.96 truth-initialized ceiling). Both are exact MH
    # on the A-likelihood restricted to the touched rows/cols, O(N) per
    # proposal:
    #  * swap_moves: symmetric l_i <-> l_j exchanges (cross terms cancel
    #    — the swapped pair's distance is unchanged);
    #  * relocate_moves: independence proposals l_i' ~ N(0, sigma_l^2 I)
    #    — the proposal equals the prior, so the prior and proposal
    #    densities cancel and a mis-placed neuron can jump straight into
    #    its correct basin.
    swap_moves: int = 0
    relocate_moves: int = 0
    mu_bias: object = -2.0       # scalar | (N,)
    sigma_bias: object = 1.0     # scalar | (N,)
    learn_weight_prior: bool = True
    niw_mu0: float = 0.0
    niw_kappa0: float = 1.0
    niw_nu0: float | None = None
    niw_psi0: float = 1.0
    mu_w: object = 0.0           # scalar | (B,) | (N,N,B); fixed prior only
    sigma_w: object = 1.0        # scalar | (B,) | (B,B) | (N,N,B,B) variance
    name: str = "latent_distance"

    def __post_init__(self):
        if self.learn_weight_prior and not (
                _is_scalar(self.sigma_w) and _is_scalar(self.mu_w)):
            raise ValueError(
                "per-edge mu_w/sigma_w require learn_weight_prior=False")

    def init_state(self, key) -> LatentDistanceState:
        L = self.sigma_l * jax.random.normal(key, (self.N, self.dim))
        return LatentDistanceState(
            L=L.astype(jnp.float32),
            gamma=jnp.asarray(self.gamma_init, jnp.float32),
            mu=jnp.zeros((self.B,), jnp.float32),
            Sigma=jnp.eye(self.B, dtype=jnp.float32) * _sigma_w_scalar(self),
        )

    def _logit_rho(self, L, gamma):
        d2 = jnp.sum((L[:, None, :] - L[None, :, :]) ** 2, axis=-1)
        return gamma - d2

    def edge_hypers(self, state: LatentDistanceState) -> EdgeHypers:
        N, B = self.N, self.B
        if self.learn_weight_prior:
            Lam = jnp.linalg.inv(state.Sigma)
            mu = jnp.broadcast_to(state.mu, (N, N, B))
            Lam = jnp.broadcast_to(Lam, (N, N, B, B))
        else:
            mu, Lam = _fixed_weight_hypers(self)
        lrho = jnp.clip(self._logit_rho(state.L, state.gamma), -15.0, 15.0)
        mu_b, lam_b = _bias_hypers(self, N)
        return EdgeHypers(mu, Lam, lrho, mu_b, lam_b)

    def _potential_grad(self, params, A):
        """Closed-form gradient of the HMC potential — the autodiff
        backward pass materializes the (N, N, dim) broadcast intermediates
        of d2 twice; this form needs one (N, N) @ (N, dim) matmul and row
        sums (asserted equal to jax.grad in tests/test_networks.py).

        With w = sigmoid(lrho) - A (= dU/dlrho) and ws = w + w':
          dU/dl_k = 2 [ (ws @ L)_k - rowsum(ws)_k l_k ] + l_k / sigma_l^2
          dU/dgamma = sum(w) + gamma / sigma_gamma^2
        """
        L, gamma = params
        lrho = self._logit_rho(L, gamma)
        w = jax.nn.sigmoid(lrho) - A
        ws = w + w.T
        gL = (2.0 * (jnp.matmul(ws, L, precision=_F32)
                     - jnp.sum(ws, axis=1)[:, None] * L)
              + L / self.sigma_l ** 2)
        gg = jnp.sum(w) + gamma / self.sigma_gamma ** 2
        return gL, gg

    def resample(self, key, state: LatentDistanceState, A, W):
        k_hmc, k_niw = jax.random.split(key)

        def potential(params):
            L, gamma = params
            lrho = self._logit_rho(L, gamma)
            # log Bern(A; logistic(lrho)) = A*lrho - softplus(lrho)
            ll = jnp.sum(A * lrho - jnp.logaddexp(lrho, 0.0))
            lp = (-0.5 * jnp.sum(L ** 2) / self.sigma_l ** 2
                  - 0.5 * gamma ** 2 / self.sigma_gamma ** 2)
            return -(ll + lp)

        def grad_fn(params):
            return self._potential_grad(params, A)
        eps = (self.hmc_eps if self.hmc_eps is not None
               else 0.15 / float(np.sqrt(self.N)))

        def kinetic(m):
            return 0.5 * sum(jnp.sum(x ** 2) for x in jax.tree.leaves(m))

        def leapfrog(carry, _):
            # Merged-kick step: the trailing half-kick of step k and the
            # leading half-kick of step k+1 use the SAME gradient, so one
            # evaluation per step suffices (the classic kick-drift-kick
            # merge — identical trajectory, half the gradient work; the
            # half-kicks at both trajectory ends live in one_trajectory).
            p, m = carry
            p = jax.tree.map(lambda pi, mi: pi + eps * mi, p, m)
            g = grad_fn(p)
            m = jax.tree.map(lambda mi, gi: mi - eps * gi, m, g)
            return (p, m), None

        def one_trajectory(params, k):
            k_m1, k_m2, k_a = jax.random.split(k, 3)
            mom = (jax.random.normal(k_m1, state.L.shape),
                   jax.random.normal(k_m2, ()))
            g0 = grad_fn(params)
            mom_h = jax.tree.map(lambda mi, gi: mi - 0.5 * eps * gi,
                                 mom, g0)
            (params_new, mom_o), _ = lax.scan(
                leapfrog, (params, mom_h), None, length=self.hmc_steps,
                unroll=2)
            # the scan's last full kick overshot by half a step: undo it.
            g_end = grad_fn(params_new)
            mom_new = jax.tree.map(lambda mi, gi: mi + 0.5 * eps * gi,
                                   mom_o, g_end)
            log_alpha = (potential(params) + kinetic(mom)
                         - potential(params_new) - kinetic(mom_new))
            accept = jnp.log(jax.random.uniform(k_a, ())) < log_alpha
            return jax.tree.map(
                lambda new, old: jnp.where(accept, new, old),
                params_new, params), accept.astype(jnp.float32)

        params, accepts = lax.scan(
            one_trajectory, (state.L, state.gamma),
            jax.random.split(jax.random.fold_in(k_hmc, 0), self.hmc_iters))
        L, gamma = params

        if self.swap_moves > 0:
            L = self._swap_scan(jax.random.fold_in(k_hmc, 1), L, gamma, A)
        if self.relocate_moves > 0:
            L = self._relocate_scan(jax.random.fold_in(k_hmc, 2), L,
                                    gamma, A)

        mu, Sigma = state.mu, state.Sigma
        if self.learn_weight_prior:
            mu, Sigma = _masked_niw_resample(k_niw, self, W, A)
        return LatentDistanceState(L, gamma, mu, Sigma,
                                   jnp.mean(accepts))

    @staticmethod
    def _row_ll(L, gamma, i_pos, i_idx, A):
        """Bernoulli log-likelihood of all directed edges touching neuron
        i_idx when it sits at i_pos — the restricted potential of the
        single-site moves. The (i, i) self term appears in both the out-
        and in-sums and is subtracted once."""
        d2 = jnp.sum((i_pos[None, :] - L) ** 2, axis=-1)           # (N,)
        lr = gamma - d2
        ll_out = jnp.sum(A[i_idx, :] * lr - jnp.logaddexp(lr, 0.0))
        ll_in = jnp.sum(A[:, i_idx] * lr - jnp.logaddexp(lr, 0.0))
        self_t = A[i_idx, i_idx] * lr[i_idx] - jnp.logaddexp(
            lr[i_idx], 0.0)
        return ll_out + ll_in - self_t

    def _swap_scan(self, key, L, gamma, A):
        """self.swap_moves sequential Metropolis l_i <-> l_j exchanges.

        The swap changes only rows/cols {i, j} of the edge-probability
        matrix, and the position prior is exchangeable, so the MH ratio is
        the Bernoulli log-likelihood delta of those rows/cols.
        Each proposal costs O(N dim); self-pairs (i == j) are no-ops.
        """
        N = self.N

        def row_ll(L, i_pos, i_idx, A):
            return self._row_ll(L, gamma, i_pos, i_idx, A)

        def step(L, k):
            k_ij, k_a = jax.random.split(k)
            ij = jax.random.randint(k_ij, (2,), 0, N)
            i, j = ij[0], ij[1]
            li, lj = L[i], L[j]
            # current and proposed restricted log-likelihoods; evaluate the
            # swapped config on the TEMPORARILY-updated L so cross terms
            # between i and j stay consistent.
            ll_cur = row_ll(L, li, i, A) + row_ll(L, lj, j, A)
            L_prop = L.at[i].set(lj).at[j].set(li)
            ll_new = row_ll(L_prop, lj, i, A) + row_ll(L_prop, li, j, A)
            accept = (jnp.log(jax.random.uniform(k_a, ()))
                      < ll_new - ll_cur) & (i != j)
            return jnp.where(accept, L_prop, L), None

        L, _ = lax.scan(step, L, jax.random.split(key, self.swap_moves))
        return L

    def _relocate_scan(self, key, L, gamma, A):
        """self.relocate_moves sequential independence-Metropolis moves:
        propose l_i' ~ N(0, sigma_l^2 I) (the prior), accept on the
        restricted A-likelihood. Because proposal == prior, the prior and
        proposal densities cancel exactly; the move lets a neuron stuck in
        the wrong embedding basin jump directly to a better one, which
        leapfrog transport cannot do."""
        N = self.N

        def step(L, k):
            k_i, k_p, k_a = jax.random.split(k, 3)
            i = jax.random.randint(k_i, (), 0, N)
            l_new = self.sigma_l * jax.random.normal(k_p, (self.dim,))
            ll_cur = self._row_ll(L, gamma, L[i], i, A)
            L_prop = L.at[i].set(l_new)
            ll_new = self._row_ll(L_prop, gamma, l_new, i, A)
            accept = jnp.log(jax.random.uniform(k_a, ())) < ll_new - ll_cur
            return jnp.where(accept, L_prop, L), accept.astype(jnp.float32)

        L, accs = lax.scan(step, L,
                           jax.random.split(key, self.relocate_moves))
        return L


NetworkConfig = (DenseNetworkConfig | ErdosRenyiConfig | SBMConfig
                 | LatentDistanceConfig)


def make_network(name: str, N: int, B: int, **kwargs):
    name = name.lower()
    if name == "dense":
        return DenseNetworkConfig(N=N, B=B, **kwargs)
    if name in ("erdos_renyi", "er", "independent", "sparse"):
        return ErdosRenyiConfig(N=N, B=B, **kwargs)
    if name in ("sbm", "stochastic_block"):
        return SBMConfig(N=N, B=B, **kwargs)
    if name in ("latent_distance", "distance"):
        return LatentDistanceConfig(N=N, B=B, **kwargs)
    raise ValueError(f"unknown network prior: {name}")
