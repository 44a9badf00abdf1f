"""Geweke joint-distribution tests of the Gibbs sweep as the GPU runs it.

The CPU Geweke suite (tests/test_geweke.py) runs at N=3, T=50 on XLA's CPU
backend. This lane runs the successive-conditional simulator on the card at
a larger shape (N=8, B=4, T=384, precision='high', transposed design
registered as add_data does) for the three PG families — Bernoulli
(Devroye PG(1, psi)), negative binomial (gamma-series PG(y + r, psi) plus
the collapsed count-table CRT dispersion update) and Binomial (PG(5, psi))
— and asserts the same prior-marginal gates as the CPU suite. A bug in a
conditional as the GPU compiles it (its f32 dot algorithms, its sampler
lowering) shows up as stationary-marginal drift that no parity test can
mask. Run with `python -m pytest tests/ -m gpu` on a machine with a GPU.

With T=384 informative observations the conditionals concentrate, so the
chain walks the prior more slowly than the N=3/T=50 CPU configs; gates
discount n_eff by the measured integrated autocorrelation time of each
series rather than assuming the thinned draws are independent.
"""
import numpy as np
import pytest

import jax

from pyglm_tpu.ops.basis import cosine_basis
from pyglm_tpu.models.observations import Bernoulli
from pyglm_tpu.models.networks import ErdosRenyiConfig
from pyglm_tpu.diagnostics.geweke import geweke_chain

pytestmark = pytest.mark.gpu

N, B, L, T = 8, 4, 10, 384
N_ITERS = 4000
BURN = 500


def _tau_int(x, c=5.0):
    """Integrated autocorrelation time (Sokal windowing)."""
    x = np.asarray(x, np.float64)
    x = x - x.mean()
    n = x.size
    acf = np.correlate(x, x, mode="full")[n - 1:] / (x.var() * n + 1e-30)
    tau = 1.0
    for m in range(1, n // 4):
        tau += 2.0 * acf[m]
        if m >= c * tau:
            break
    return max(tau, 1.0)


def _z(mean_emp, mean_true, var_true, n_eff):
    return abs(mean_emp - mean_true) / np.sqrt(var_true / max(n_eff, 2.0))


@pytest.fixture(scope="module")
def bern_chain(gpu):
    basis = cosine_basis(B=B, L=L)
    obs = Bernoulli()
    net = ErdosRenyiConfig(
        N=N, B=B, rho_init=0.4, learn_rho=False, learn_weight_prior=False,
        sigma_w=0.25, mu_bias=-1.5, sigma_bias=0.3)
    series = geweke_chain(jax.random.key(7), obs, net, N, B, basis, T,
                          spike_slab=True, n_iters=N_ITERS, t_chunk=384,
                          precision="high", with_xt=True)
    return series, net


def test_bern_geweke_bias_marginal(bern_chain):
    series, net = bern_chain
    b = series["bias"][BURN:]                        # (n, N)
    tau = max(_tau_int(b.mean(axis=1)), 1.0)
    n_eff = b.shape[0] * N / tau
    z = _z(b.mean(), net.mu_bias, net.sigma_bias ** 2, n_eff)
    assert z < 5.0, (b.mean(), tau, z)
    assert abs(b.var() / net.sigma_bias ** 2 - 1) < 0.3, (b.var(), tau)


def test_bern_geweke_adjacency_marginal(bern_chain):
    series, net = bern_chain
    dens = series["A_density"][BURN:]
    tau = max(_tau_int(dens), 1.0)
    n_eff = dens.shape[0] * N * N / tau
    z = _z(dens.mean(), net.rho_init,
           net.rho_init * (1 - net.rho_init), n_eff)
    assert z < 5.0, (dens.mean(), tau, z)


@pytest.fixture(scope="module")
def nb_chain(gpu):
    """Count path on the card: NB observations with BOTH the transposed
    design and the LL cache (collapsed count-table CRT r update — the
    flagship NB model's post-add_data path) registered. The per-sweep PG
    draws are PG(y + r, psi) via method='real', so the gamma-series sampler
    runs inside the joint-distribution test rather than only its KS
    grids."""
    from pyglm_tpu.models.observations import NegativeBinomial

    basis = cosine_basis(B=B, L=L)
    a_r, b_r = 4.0, 2.0
    # The prior config must keep the exp-link autoregression SUBCRITICAL:
    # at (rho=0.4, sigma_w=0.01, mu_bias=-1.5) the prior-predictive runaway
    # probability is ~1e-3/iteration (measured: y saturates the generator's
    # 1e6 lam clamp, the f32 weight update overflows, and the NaN poisons r
    # for the rest of the chain — reproduced identically on CPU/XLA and
    # on two accelerator backends, so a config instability, not a sampler
    # bug). The config
    # below measured y_max <= ~30 over the full 4000-iteration chain.
    obs = NegativeBinomial(r_init=2.0, resample_r=True, a_r=a_r, b_r=b_r,
                           max_y=128)
    net = ErdosRenyiConfig(
        N=N, B=B, rho_init=0.25, learn_rho=False, learn_weight_prior=False,
        sigma_w=0.004, mu_bias=-2.0, sigma_bias=0.2)
    series = geweke_chain(jax.random.key(11), obs, net, N, B, basis, T,
                          spike_slab=True, n_iters=N_ITERS, t_chunk=384,
                          precision="high", with_xt=True, with_llc=True)
    # Loud guard for the two silent chain-killers: an autoregressive
    # runaway (y_max ~ 1e6) and a violated count-table bound (y > max_y
    # biases the collapsed-CRT r update with no error under tracing).
    assert float(series["y_max"].max()) <= obs.max_y, series["y_max"].max()
    assert np.all(np.isfinite(series["r"])), "dispersion series went NaN"
    return series, net, (a_r, b_r)


def test_nb_geweke_bias_marginal(nb_chain):
    series, net, _ = nb_chain
    b = series["bias"][BURN:]
    tau = max(_tau_int(b.mean(axis=1)), 1.0)
    n_eff = b.shape[0] * N / tau
    z = _z(b.mean(), net.mu_bias, net.sigma_bias ** 2, n_eff)
    assert z < 5.0, (b.mean(), tau, z)
    assert abs(b.var() / net.sigma_bias ** 2 - 1) < 0.3, (b.var(), tau)


def test_nb_geweke_r_marginal(nb_chain):
    """The learned dispersion must keep its Gamma(a_r, b_r) prior as the
    stationary marginal — the collapsed-CRT seating counts, the conjugate
    gamma draw, AND the PG(y+r) draws that shape psi all sit inside this
    loop; a bias in any of them drifts r off its prior."""
    series, _, (a_r, b_r) = nb_chain
    r = series["r"][BURN:]                           # (n, N)
    m_true, v_true = a_r / b_r, a_r / b_r ** 2
    tau = max(_tau_int(r.mean(axis=1)), 1.0)
    n_eff = r.shape[0] * N / tau
    z = _z(r.mean(), m_true, v_true, n_eff)
    assert z < 5.0, (r.mean(), tau, z)
    assert abs(r.var() / v_true - 1) < 0.35, (r.var(), tau)


def test_nb_geweke_adjacency_marginal(nb_chain):
    series, net, _ = nb_chain
    dens = series["A_density"][BURN:]
    tau = max(_tau_int(dens), 1.0)
    n_eff = dens.shape[0] * N * N / tau
    z = _z(dens.mean(), net.rho_init,
           net.rho_init * (1 - net.rho_init), n_eff)
    assert z < 5.0, (dens.mean(), tau, z)


@pytest.fixture(scope="module")
def binom_chain(gpu):
    """Binomial (n_trials=5) on the card: every auxiliary draw is
    PG(5, psi) through the integer-b gamma-series dispatch — the constant-b
    regime the NB config (b = y + r, data-dependent) never pins down."""
    from pyglm_tpu.models.observations import Binomial

    basis = cosine_basis(B=B, L=L)
    obs = Binomial(n_trials=5)
    net = ErdosRenyiConfig(
        N=N, B=B, rho_init=0.4, learn_rho=False, learn_weight_prior=False,
        sigma_w=0.05, mu_bias=-1.0, sigma_bias=0.3)
    series = geweke_chain(jax.random.key(12), obs, net, N, B, basis, T,
                          spike_slab=True, n_iters=N_ITERS, t_chunk=384,
                          precision="high", with_xt=True)
    return series, net


def test_binom_geweke_bias_marginal(binom_chain):
    series, net = binom_chain
    b = series["bias"][BURN:]
    tau = max(_tau_int(b.mean(axis=1)), 1.0)
    n_eff = b.shape[0] * N / tau
    z = _z(b.mean(), net.mu_bias, net.sigma_bias ** 2, n_eff)
    assert z < 5.0, (b.mean(), tau, z)
    assert abs(b.var() / net.sigma_bias ** 2 - 1) < 0.3, (b.var(), tau)


def test_binom_geweke_adjacency_marginal(binom_chain):
    series, net = binom_chain
    dens = series["A_density"][BURN:]
    tau = max(_tau_int(dens), 1.0)
    n_eff = dens.shape[0] * N * N / tau
    z = _z(dens.mean(), net.rho_init,
           net.rho_init * (1 - net.rho_init), n_eff)
    assert z < 5.0, (dens.mean(), tau, z)


def test_bern_geweke_weight_marginal(bern_chain):
    series, net = bern_chain
    wsq = series["W_sq"][BURN:]
    nact = series["n_active"][BURN:]
    # Active weights are iid N(0, sigma_w) under the prior: per-coefficient
    # second moment sigma_w (B coefficients per active edge).
    ratio = wsq.sum() / (nact.sum() * B * net.sigma_w)
    tau = max(_tau_int(wsq / np.maximum(nact, 1.0)), 1.0)
    n_draws = nact.sum() * B / tau
    # chi^2 concentration: sd of the ratio ~ sqrt(2/n_draws)
    assert abs(ratio - 1) < max(5.0 * np.sqrt(2.0 / n_draws), 0.05), (
        ratio, tau, n_draws)
    wsum = series["W_sum"][BURN:]
    est_mean = wsum.sum() / (nact.sum() * B)
    se = np.sqrt(net.sigma_w / n_draws)
    assert abs(est_mean) < 6 * se, (est_mean, se, tau)
