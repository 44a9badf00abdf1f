"""Observation families for PG-augmented GLMs.

Capability parity with the reference's observation layer
(``pypolyagamma/distributions.py``: ``BernoulliRegression``,
``BinomialRegression``, ``NegativeBinomialRegression`` — each a (kappa, b)
map into the shared PG machinery — and ``pyglm/regressions.py``'s
``SparseGaussianRegression``), re-expressed functionally: a family is a
stateless config object mapping data to the PG-augmented conditionally-
Gaussian form

    likelihood(psi) prop-to exp(kappa * psi - omega * psi^2 / 2),
    omega ~ PG(b_pg(y), psi),

plus per-neuron auxiliary-parameter updates (NB dispersion r via
Chinese-restaurant-table augmentation; Gaussian noise variance eta via
conjugate inverse-gamma).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from pyglm_tpu.ops.polyagamma import polya_gamma, pg_draw_unit
from pyglm_tpu.ops.linalg import crt_sample, sample_inverse_gamma
from pyglm_tpu.utils.utils import logistic, softplus


class _FamilyBase:
    """Shared hooks every observation family inherits.

    ``ll_cache`` / ``log_likelihood_sum`` exist so the per-sweep total
    log-likelihood (a diagnostic computed inside the hot jitted sweep,
    models/sweep.py) can precompute the psi-INDEPENDENT part of the
    likelihood once at data-registration time instead of re-evaluating it
    over all T*N elements every sweep — e.g. the NB normalizer's gammaln
    terms depend on the data only through per-count tallies, so 20M
    gammaln evals/sweep collapse to (max_y+1)*N. Families without such
    structure return None and take the elementwise path.
    """

    def ll_cache(self, Y):
        """Per-dataset psi-independent summary for log_likelihood_sum
        (None = no cacheable structure). Called eagerly at add_data."""
        return None

    def log_likelihood_sum(self, Y, psi, aux, cache=None):
        """Total log-likelihood over a dataset; `cache` is the (possibly
        dataset-summed) ll_cache output. Must equal
        sum(log_likelihood(Y, psi, aux)) up to fp summation order."""
        return jnp.sum(self.log_likelihood(Y, psi, aux))

    def tempering_blocker(self):
        """None if the family supports exact power-posterior tempering
        with its current flags, else a human-readable reason. A family
        tempers exactly when the beta-power likelihood stays inside the
        PG-conjugate form AND no likelihood-side auxiliary (NB r, Gaussian
        eta) is being resampled — those auxiliaries' conjugate updates
        assume the untempered likelihood."""
        return None

    def tempered_omega_kappa(self, key, Y, psi, aux, beta):
        """(omega, kappa) targeting the beta-POWER likelihood L^beta.

        For every logit family the power stays in the PG family with the
        shape scaled linearly — L(psi)^beta = e^{beta*kappa*psi} /
        cosh-form with b -> beta*b — so omega ~ PG(beta*b, psi) and
        kappa -> beta*kappa; for Gaussian the precision scales. ``beta``
        is a per-lane (N,) vector (a tempering ladder stacked on postsyn
        lanes, models/tempering.py)."""
        raise NotImplementedError


@dataclass(frozen=True)
class Bernoulli(_FamilyBase):
    """y ~ Bern(logistic(psi)); kappa = y - 1/2, b_pg = 1 (exact Devroye).

    Reference: pypolyagamma/distributions.py (BernoulliRegression),
    pyglm/regressions.py (SparseBernoulliRegression).
    """
    name: str = "bernoulli"
    needs_pg: bool = True

    def init_aux(self, N: int):
        return None

    def omega_kappa(self, key, Y, psi, aux):
        omega = pg_draw_unit(key, psi)
        kappa = Y - 0.5
        return omega, kappa

    def tempered_omega_kappa(self, key, Y, psi, aux, beta):
        b = jnp.broadcast_to(beta[None, :], psi.shape)
        omega = polya_gamma(key, b, psi, method="real")  # fractional shape
        kappa = beta[None, :] * (Y - 0.5)
        return omega, kappa

    def log_likelihood(self, Y, psi, aux):
        return Y * psi - softplus(psi)

    def sample(self, key, psi, aux):
        return jax.random.bernoulli(key, logistic(psi)).astype(jnp.float32)

    def mean(self, psi, aux):
        return logistic(psi)

    def resample_aux(self, key, aux, Y, psi, cache=None):
        return aux


@dataclass(frozen=True)
class Binomial(_FamilyBase):
    """y ~ Binom(n_trials, logistic(psi)); kappa = y - n/2, b_pg = n."""
    n_trials: int = 1
    name: str = "binomial"
    needs_pg: bool = True

    def init_aux(self, N: int):
        return None

    def omega_kappa(self, key, Y, psi, aux):
        b = jnp.full_like(psi, float(self.n_trials))
        omega = polya_gamma(key, b, psi)
        kappa = Y - 0.5 * self.n_trials
        return omega, kappa

    def tempered_omega_kappa(self, key, Y, psi, aux, beta):
        b = jnp.broadcast_to(float(self.n_trials) * beta[None, :], psi.shape)
        omega = polya_gamma(key, b, psi, method="real")
        kappa = beta[None, :] * (Y - 0.5 * self.n_trials)
        return omega, kappa

    def log_likelihood(self, Y, psi, aux):
        n = float(self.n_trials)
        logC = gammaln(n + 1.0) - gammaln(Y + 1.0) - gammaln(n - Y + 1.0)
        return logC + Y * psi - n * softplus(psi)

    def ll_cache(self, Y):
        # The binomial normalizer log C(n, y) is state-independent: its
        # dataset total is one scalar, so the per-sweep total LL needs no
        # T*N gammaln pass at all.
        n = float(self.n_trials)
        logC = gammaln(n + 1.0) - gammaln(Y + 1.0) - gammaln(n - Y + 1.0)
        return {"logC_sum": jnp.sum(logC)}

    def log_likelihood_sum(self, Y, psi, aux, cache=None):
        if cache is None:
            return jnp.sum(self.log_likelihood(Y, psi, aux))
        n = float(self.n_trials)
        return cache["logC_sum"] + jnp.sum(Y * psi - n * softplus(psi))

    def sample(self, key, psi, aux):
        return jax.random.binomial(
            key, float(self.n_trials), logistic(psi)).astype(jnp.float32)

    def mean(self, psi, aux):
        return self.n_trials * logistic(psi)

    def resample_aux(self, key, aux, Y, psi, cache=None):
        return aux


@dataclass(frozen=True)
class NegativeBinomial(_FamilyBase):
    """y ~ NB(r, p = logistic(psi)): mean r p/(1-p); kappa=(y-r)/2, b_pg=y+r.

    Dispersion r (per neuron) is resampled by the Zhou–Carin CRT + Gamma
    conjugate augmentation. `max_y` must bound the observed counts (static).
    Reference: pypolyagamma/distributions.py (NegativeBinomialRegression).
    """
    r_init: float = 4.0
    a_r: float = 2.0          # Gamma(a_r, b_r) prior on r
    b_r: float = 0.5
    max_y: int = 256
    resample_r: bool = True
    name: str = "negative_binomial"
    needs_pg: bool = True

    def init_aux(self, N: int):
        return {"r": jnp.full((N,), self.r_init, jnp.float32)}

    def omega_kappa(self, key, Y, psi, aux):
        r = aux["r"][None, :]
        b = Y + r
        # b = y + r is generically non-integer: skip the b==1 Devroye overlay
        omega = polya_gamma(key, b, psi, method="real")
        kappa = 0.5 * (Y - r)
        return omega, kappa

    def tempering_blocker(self):
        if self.resample_r:
            return ("NegativeBinomial with resample_r=True: the CRT r "
                    "update assumes the untempered likelihood; construct "
                    "with resample_r=False (fixed dispersion) to temper")
        return None

    def tempered_omega_kappa(self, key, Y, psi, aux, beta):
        r = aux["r"][None, :]
        omega = polya_gamma(key, beta[None, :] * (Y + r), psi, method="real")
        kappa = beta[None, :] * 0.5 * (Y - r)
        return omega, kappa

    def log_likelihood(self, Y, psi, aux):
        r = aux["r"][None, :]
        logC = gammaln(Y + r) - gammaln(r) - gammaln(Y + 1.0)
        return logC + Y * psi - (Y + r) * softplus(psi)

    def ll_cache(self, Y):
        # sum_t gammaln(y_tn + r_n) depends on the data only through the
        # per-neuron count tallies #{t : y_tn = k}: precompute the
        # (max_y+1, N) table once so the per-sweep total LL evaluates
        # (max_y+1)*N gammalns instead of T*N (20M at the NB flagship
        # shapes, where gammaln dominated the LL stage). The same table
        # feeds the collapsed-CRT r update (resample_aux).
        K = self.max_y + 1
        if isinstance(Y, jax.core.Tracer):
            # Traced path (the Geweke successive-conditional simulator
            # regenerates Y inside a scan): one-hot contraction. Only used
            # at tiny diagnostic shapes — concrete data takes the host
            # bincount below.
            counts = jnp.sum(jax.nn.one_hot(
                jnp.asarray(Y, jnp.int32), K, axis=0), axis=1)
            return {"counts": counts.astype(jnp.float32)}
        import numpy as np
        Yn = np.asarray(Y).astype(np.int64)
        # Counts above max_y would silently vanish from the table, biasing
        # BOTH the LL normalizer and the collapsed-CRT r update that
        # consume it (ADVICE r4). add_data raises first with a friendlier
        # message; this guards any other concrete-data caller.
        assert Yn.max() <= self.max_y, (
            f"observed count {Yn.max()} exceeds max_y={self.max_y}; "
            f"construct the family with a larger max_y")
        counts = np.stack(
            [np.bincount(Yn[:, j], minlength=K)[:K]
             for j in range(Yn.shape[1])], axis=1)
        return {"counts": jnp.asarray(counts, jnp.float32)}

    def log_likelihood_sum(self, Y, psi, aux, cache=None):
        if cache is None:
            return jnp.sum(self.log_likelihood(Y, psi, aux))
        r = aux["r"]                                   # (N,)
        counts = cache["counts"]                       # (max_y+1, N)
        k = jnp.arange(counts.shape[0], dtype=jnp.float32)[:, None]
        logC = gammaln(k + r[None, :]) - gammaln(r)[None, :] - gammaln(k + 1.0)
        const = jnp.sum(counts * logC)
        return const + jnp.sum(Y * psi - (Y + r[None, :]) * softplus(psi))

    def sample(self, key, psi, aux):
        k1, k2 = jax.random.split(key)
        r = aux["r"][None, :]
        # Gamma-Poisson mixture: lam ~ Gamma(r) * p/(1-p) = Gamma(r) * e^psi.
        lam = jax.random.gamma(k1, jnp.broadcast_to(r, psi.shape)) * jnp.exp(psi)
        # Saturate to avoid int32 overflow if the autoregressive dynamics
        # run away (exp link + positive feedback is explosive for any
        # sufficiently positive weights — true of the reference model too).
        lam = jnp.minimum(lam, 1e6)
        return jax.random.poisson(k2, lam).astype(jnp.float32)

    def mean(self, psi, aux):
        return aux["r"][None, :] * jnp.exp(psi)

    def resample_aux(self, key, aux, Y, psi, cache=None):
        if not self.resample_r:
            return aux
        k1, k2 = jax.random.split(key)
        r = aux["r"]
        if cache is not None:
            # Collapsed CRT: the table counts l_tn = sum_{i<y_tn}
            # Bern(r_n/(r_n+i)) are independent across (t, i) given y, and
            # the r conditional needs only sum_t l_tn — so group the
            # Bernoullis by table index i instead of by element:
            #   sum_t l_tn = sum_i Binomial(#{t: y_tn > i}, r_n/(r_n+i)),
            # an EXACT regrouping. Trial counts come from the cached
            # (max_y+1, N) count table (the same one the LL normalizer
            # contracts against), so the 20M-element x max_y-pass CRT
            # loop collapses to max_y*N binomial draws at the NB flagship.
            # i = 0 has p = 1 (every y > 0 seats a first table) and is
            # added deterministically.
            counts = cache["counts"]                     # (max_y+1, N)
            K = counts.shape[0]
            # m[i] = #{t : y_tn > i} for i = 0..K-2 (suffix sums)
            m = jnp.cumsum(counts[::-1], axis=0)[::-1][1:]   # (K-1, N)
            i = jnp.arange(1, K - 1, dtype=jnp.float32)[:, None]
            p = r[None, :] / (r[None, :] + i)
            draws = jax.random.binomial(k1, m[1:], p)    # (K-2, N)
            lsum = m[0] + jnp.sum(draws, axis=0)
        else:
            l = crt_sample(k1, Y.astype(jnp.int32), r[None, :], self.max_y)
            lsum = jnp.sum(l, axis=0).astype(jnp.float32)
        shape = self.a_r + lsum
        rate = self.b_r + jnp.sum(softplus(psi), axis=0)
        r_new = jax.random.gamma(k2, shape) / rate
        return {"r": jnp.maximum(r_new, 1e-3)}


@dataclass(frozen=True)
class Gaussian(_FamilyBase):
    """y ~ N(psi, eta_n): identity link, conjugate noise variance.

    No PG augmentation — the auxiliary weights are deterministic
    omega = 1/eta_n, kappa = y/eta_n, which yields the exact Gaussian
    conditional for the weights. eta resampled by inverse-gamma conjugacy.
    Reference: pyglm/regressions.py (SparseGaussianRegression).
    """
    eta_init: float = 1.0
    a_eta: float = 2.0        # InvGamma(a_eta, b_eta) prior on eta
    b_eta: float = 1.0
    resample_eta: bool = True
    name: str = "gaussian"
    needs_pg: bool = False

    def init_aux(self, N: int):
        return {"eta": jnp.full((N,), self.eta_init, jnp.float32)}

    def omega_kappa(self, key, Y, psi, aux):
        inv_eta = 1.0 / aux["eta"][None, :]
        omega = jnp.broadcast_to(inv_eta, Y.shape)
        kappa = Y * inv_eta
        return omega, kappa

    def tempering_blocker(self):
        if self.resample_eta:
            return ("Gaussian with resample_eta=True: the inverse-gamma "
                    "eta update assumes the untempered likelihood; "
                    "construct with resample_eta=False to temper")
        return None

    def tempered_omega_kappa(self, key, Y, psi, aux, beta):
        # N(y|psi, eta)^beta is Gaussian with precision beta/eta: omega and
        # kappa scale deterministically (no PG draw on this family).
        om, ka = self.omega_kappa(key, Y, psi, aux)
        return beta[None, :] * om, beta[None, :] * ka

    def log_likelihood(self, Y, psi, aux):
        eta = aux["eta"][None, :]
        return -0.5 * jnp.log(2.0 * jnp.pi * eta) - 0.5 * (Y - psi) ** 2 / eta

    def sample(self, key, psi, aux):
        eta = aux["eta"][None, :]
        return psi + jnp.sqrt(eta) * jax.random.normal(key, psi.shape)

    def mean(self, psi, aux):
        return psi

    def resample_aux(self, key, aux, Y, psi, cache=None):
        if not self.resample_eta:
            return aux
        T = Y.shape[0]
        alpha = self.a_eta + 0.5 * T
        beta = self.b_eta + 0.5 * jnp.sum((Y - psi) ** 2, axis=0)
        eta = sample_inverse_gamma(key, alpha, beta)
        return {"eta": jnp.maximum(eta, 1e-6)}


ObservationFamily = Any  # duck-typed: Bernoulli | Binomial | NegativeBinomial | Gaussian


def make_observation(name: str, **kwargs) -> ObservationFamily:
    name = name.lower()
    if name == "bernoulli":
        return Bernoulli(**kwargs)
    if name == "binomial":
        return Binomial(**kwargs)
    if name in ("negative_binomial", "nb", "negbin"):
        return NegativeBinomial(**kwargs)
    if name == "gaussian":
        return Gaussian(**kwargs)
    raise ValueError(f"unknown observation family: {name}")
