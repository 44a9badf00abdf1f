"""Shared benchmark fixtures: the flagship ground truths.

bench.py, chip_smoke.py and the scripts in benchmarks/ all fit data from
these two definitions, so their numbers are for the same chains.
"""


def bernoulli_flagship_data(pt, n, t, B=4, L=10):
    """(T, N) spikes of the Bernoulli flagship's ER spike-and-slab ground
    truth (BASELINE.json metric at n=200, t=100k)."""
    true = pt.SparseBernoulliGLM(
        n, B=B, L=L, seed=42,
        net_kwargs=dict(rho_init=0.05, learn_rho=False, mu_bias=-2.5,
                        sigma_bias=0.25, learn_weight_prior=False,
                        sigma_w=1.0))
    return true.generate(t, keep=False)


def nb_flagship_models(pt, jnp, n, t, B=4, L=10):
    """(true_model, fresh_model, Y) for the NB flagship configuration."""
    true = pt.SparseNegativeBinomialGLM(
        n, B=B, L=L, seed=42,
        net_kwargs=dict(rho_init=0.05, learn_rho=False, mu_bias=-2.0,
                        sigma_bias=0.25, learn_weight_prior=False,
                        sigma_w=0.003),
        obs_kwargs=dict(max_y=16))
    Y = jnp.minimum(true.generate(t, keep=False), 15.0)

    def fresh(precision="default"):
        return pt.SparseNegativeBinomialGLM(
            n, B=B, L=L, seed=0, precision=precision,
            obs_kwargs=dict(max_y=16))

    return true, fresh, Y
