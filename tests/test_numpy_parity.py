"""End-to-end posterior parity: the JAX Gibbs sampler vs the
independent NumPy/f64 reference implementation on the SAME data and priors.

This is the operative substitute for reference-pyglm posterior parity
(mount empty — SURVEY.md): two independently-written samplers targeting the
same posterior must agree on posterior functionals within MC tolerance.
"""
import numpy as np
import pytest

import pyglm_tpu as pt
from pyglm_tpu.reference.numpy_ref import NumpyGLMReference
from pyglm_tpu.ops.basis import cosine_basis


@pytest.mark.slow
def test_posterior_means_match_numpy_reference():
    N, B, L, T = 5, 2, 4, 1500
    rho, sigma_w, mu_b, sigma_b = 0.35, 0.8, -1.2, 0.4
    basis = cosine_basis(B=B, L=L)

    # Common synthetic dataset from a planted model.
    gen = pt.SparseBernoulliGLM(
        N, basis=basis, seed=123,
        net_kwargs=dict(rho_init=rho, learn_rho=False, mu_bias=mu_b,
                        sigma_bias=sigma_b, learn_weight_prior=False,
                        sigma_w=sigma_w))
    Y = gen.generate(T, keep=False).astype(np.float64)

    n_burn, n_keep = 150, 400

    # --- JAX chain ---------------------------------------------
    model = pt.SparseBernoulliGLM(
        N, basis=basis, seed=0,
        net_kwargs=dict(rho_init=rho, learn_rho=False, mu_bias=mu_b,
                        sigma_bias=sigma_b, learn_weight_prior=False,
                        sigma_w=sigma_w))
    model.add_data(Y)
    A1 = np.zeros((N, N)); W1 = np.zeros((N, N)); b1 = np.zeros(N)
    for it in range(n_burn + n_keep):
        model.resample_model()
        if it >= n_burn:
            A1 += model.A / n_keep
            W1 += model.W_effective / n_keep
            b1 += model.bias / n_keep

    # --- NumPy reference chain ----------------------------------------
    ref = NumpyGLMReference(N=N, B=B, basis=basis, rho=rho, mu_w=0.0,
                            sigma_w=sigma_w, mu_b=mu_b, sigma_b=sigma_b,
                            seed=7)
    Xf = ref.design(Y)
    A2 = np.zeros((N, N)); W2 = np.zeros((N, N)); b2 = np.zeros(N)
    for it in range(n_burn + n_keep):
        ref.resample(Y, Xf)
        if it >= n_burn:
            A2 += ref.A / n_keep
            W2 += (ref.A[:, :, None] * ref.W).sum(-1) / n_keep
            b2 += ref.b / n_keep

    # Posterior functionals agree within MC tolerance.
    assert np.max(np.abs(b1 - b2)) < 0.25, (b1, b2)
    assert np.max(np.abs(A1 - A2)) < 0.22, np.max(np.abs(A1 - A2))
    assert np.max(np.abs(W1 - W2)) < 0.35, np.max(np.abs(W1 - W2))
    # Aggregate edge-probability calibration.
    assert abs(A1.mean() - A2.mean()) < 0.06


@pytest.mark.slow
def test_posterior_means_match_numpy_reference_nb():
    """Count-data path (VERDICT r3 item #6): negative-binomial observations
    — gamma-series PG(y + r, psi) auxiliaries, CRT + conjugate-Gamma
    dispersion updates — against the independent f64 NumPy oracle."""
    N, B, L, T = 5, 2, 4, 1000
    rho, sigma_w, mu_b, sigma_b = 0.35, 0.01, -2.0, 0.3
    r_true, a_r, b_r = 4.0, 2.0, 0.5
    basis = cosine_basis(B=B, L=L)

    gen = pt.SparseNegativeBinomialGLM(
        N, basis=basis, seed=321,
        obs_kwargs=dict(r_init=r_true, resample_r=False, max_y=64),
        net_kwargs=dict(rho_init=rho, learn_rho=False, mu_bias=mu_b,
                        sigma_bias=sigma_b, learn_weight_prior=False,
                        sigma_w=sigma_w))
    Y = np.minimum(gen.generate(T, keep=False), 63.0).astype(np.float64)

    n_burn, n_keep = 150, 400

    # --- JAX chain ---------------------------------------------
    model = pt.SparseNegativeBinomialGLM(
        N, basis=basis, seed=0,
        obs_kwargs=dict(r_init=2.0, a_r=a_r, b_r=b_r, max_y=64),
        net_kwargs=dict(rho_init=rho, learn_rho=False, mu_bias=mu_b,
                        sigma_bias=sigma_b, learn_weight_prior=False,
                        sigma_w=sigma_w))
    model.add_data(Y)
    A1 = np.zeros((N, N)); W1 = np.zeros((N, N)); b1 = np.zeros(N)
    r1 = np.zeros(N)
    for it in range(n_burn + n_keep):
        model.resample_model()
        if it >= n_burn:
            A1 += model.A / n_keep
            W1 += model.W_effective / n_keep
            b1 += model.bias / n_keep
            r1 += np.asarray(model.state.aux["r"]) / n_keep

    # --- NumPy/f64 reference chain --------------------------------------
    from pyglm_tpu.reference.numpy_ref import NumpyGLMReference
    ref = NumpyGLMReference(N=N, B=B, basis=basis, rho=rho, mu_w=0.0,
                            sigma_w=sigma_w, mu_b=mu_b, sigma_b=sigma_b,
                            seed=7, observation="negative_binomial",
                            r_init=2.0, a_r=a_r, b_r=b_r)
    Xf = ref.design(Y)
    A2 = np.zeros((N, N)); W2 = np.zeros((N, N)); b2 = np.zeros(N)
    r2 = np.zeros(N)
    for it in range(n_burn + n_keep):
        ref.resample(Y, Xf)
        if it >= n_burn:
            A2 += ref.A / n_keep
            W2 += (ref.A[:, :, None] * ref.W).sum(-1) / n_keep
            b2 += ref.b / n_keep
            r2 += ref.r / n_keep

    assert np.max(np.abs(b1 - b2)) < 0.25, (b1, b2)
    assert np.max(np.abs(A1 - A2)) < 0.22, np.max(np.abs(A1 - A2))
    assert np.max(np.abs(W1 - W2)) < 0.35, np.max(np.abs(W1 - W2))
    assert abs(A1.mean() - A2.mean()) < 0.06
    # dispersion posterior agrees per neuron (r_true = 4, prior mean = 4)
    assert np.max(np.abs(r1 - r2) / r2) < 0.25, (r1, r2)


@pytest.mark.slow
def test_posterior_means_match_numpy_reference_gaussian():
    """Identity-link path (third oracle family, round 4): Gaussian
    observations — deterministic omega = 1/eta auxiliaries (no PG draw)
    and the conjugate inverse-gamma noise update — against the independent
    f64 NumPy oracle. Exercises the non-PG branch of the weight
    conditional and the Gaussian cached-Gram fast path end to end.

    Test design note (retuned r5, VERDICT r4 weak #5): with deterministic
    omega the A-posterior is an Ising-like distribution with FIXED
    couplings (no PG jitter). At the pre-r5 eta_true=0.09 the
    near-noiseless identity link froze boundary edges in BOTH samplers
    (within-sampler seed spread ~0.25 per-edge), forcing a loose 0.3
    per-edge gate. At eta_true=0.3 the posterior keeps real edge
    uncertainty and single-site Gibbs traverses it: measured over five
    chain-pair comparisons (two pooled pairs per sampler, both cross and
    within), per-edge max-abs <= 0.19, bias <= 0.04, W <= 0.03,
    density <= 0.013, eta rel <= 0.002 — the gates below sit 2-6x above
    those. Each side still pools two independent chains."""
    N, B, L, T = 5, 2, 4, 2000
    rho, sigma_w, mu_b, sigma_b = 0.35, 0.05, 0.3, 0.4
    eta_true, a_eta, b_eta = 0.3, 2.0, 1.0
    basis = cosine_basis(B=B, L=L)

    # Small planted weights + low noise keep the linear AR dynamics stable
    # and the edge signal detectable above eta.
    gen = pt.SparseGaussianGLM(
        N, basis=basis, seed=456,
        obs_kwargs=dict(eta_init=eta_true, resample_eta=False),
        net_kwargs=dict(rho_init=rho, learn_rho=False, mu_bias=mu_b,
                        sigma_bias=sigma_b, learn_weight_prior=False,
                        sigma_w=sigma_w))
    Y = gen.generate(T, keep=False).astype(np.float64)
    assert np.all(np.isfinite(Y))

    n_burn, n_keep = 200, 800

    # --- JAX chains (two seeds, pooled) ---------------------------
    A1 = np.zeros((N, N)); W1 = np.zeros((N, N)); b1 = np.zeros(N)
    e1 = np.zeros(N)
    seeds1 = (0, 1)
    for seed in seeds1:
        model = pt.SparseGaussianGLM(
            N, basis=basis, seed=seed,
            obs_kwargs=dict(eta_init=1.0, a_eta=a_eta, b_eta=b_eta),
            net_kwargs=dict(rho_init=rho, learn_rho=False, mu_bias=mu_b,
                            sigma_bias=sigma_b, learn_weight_prior=False,
                            sigma_w=sigma_w))
        model.add_data(Y)
        k = n_keep * len(seeds1)
        for it in range(n_burn + n_keep):
            model.resample_model()
            if it >= n_burn:
                A1 += model.A / k
                W1 += model.W_effective / k
                b1 += model.bias / k
                e1 += np.asarray(model.state.aux["eta"]) / k

    # --- NumPy/f64 reference chains (two seeds, pooled) ------------------
    A2 = np.zeros((N, N)); W2 = np.zeros((N, N)); b2 = np.zeros(N)
    e2 = np.zeros(N)
    seeds2 = (7, 8)
    for seed in seeds2:
        ref = NumpyGLMReference(N=N, B=B, basis=basis, rho=rho, mu_w=0.0,
                                sigma_w=sigma_w, mu_b=mu_b, sigma_b=sigma_b,
                                seed=seed, observation="gaussian",
                                eta_init=1.0, a_eta=a_eta, b_eta=b_eta)
        Xf = ref.design(Y)
        k = n_keep * len(seeds2)
        for it in range(n_burn + n_keep):
            ref.resample(Y, Xf)
            if it >= n_burn:
                A2 += ref.A / k
                W2 += (ref.A[:, :, None] * ref.W).sum(-1) / k
                b2 += ref.b / k
                e2 += ref.eta / k

    assert np.max(np.abs(b1 - b2)) < 0.08, (b1, b2)
    assert np.max(np.abs(W1 - W2)) < 0.08, np.max(np.abs(W1 - W2))
    assert abs(A1.mean() - A2.mean()) < 0.04
    assert np.max(np.abs(A1 - A2)) < 0.25, np.max(np.abs(A1 - A2))
    # noise posterior agrees per neuron and concentrates near eta_true
    assert np.max(np.abs(e1 - e2) / e2) < 0.05, (e1, e2)
    assert np.all(e1 < 2 * eta_true) and np.all(e1 > eta_true / 2), e1


@pytest.mark.slow
def test_posterior_means_match_numpy_reference_binomial():
    """Integer-b path (fifth oracle family, round 4): Binomial observations
    — PG(n_trials, psi) auxiliaries — against the independent f64 NumPy
    oracle, which draws the auxiliary as the EXACT n_trials-fold Devroye
    convolution while the JAX side routes through the integer-b
    gamma-series dispatch (ops/polyagamma.py), so the two samplers share
    no PG code path at all.

    Test design note: measured within-sampler seed spread on the per-edge
    A marginals is ~0.2-0.3 on this posterior (boundary edges are sticky
    in BOTH samplers), so each side pools two independent chains, the
    tight asserts target fast-mixing functionals (bias, W means, edge
    density), and the per-edge A bound is a loose sanity check sized
    from the measured spread."""
    N, B, L, T = 5, 2, 4, 1000
    n_trials = 3
    rho, sigma_w, mu_b, sigma_b = 0.35, 0.05, -1.5, 0.3
    basis = cosine_basis(B=B, L=L)

    nk = dict(rho_init=rho, learn_rho=False, mu_bias=mu_b,
              sigma_bias=sigma_b, learn_weight_prior=False, sigma_w=sigma_w)
    gen = pt.NonlinearAutoregressiveModel(
        N, basis=basis, observation="binomial", network="erdos_renyi",
        spike_and_slab=True, seed=77, obs_kwargs=dict(n_trials=n_trials),
        net_kwargs=nk)
    Y = gen.generate(T, keep=False).astype(np.float64)
    assert Y.max() <= n_trials and Y.min() >= 0

    n_burn, n_keep = 150, 400

    # --- JAX chains (two seeds, pooled; scanned driver — eager
    # per-sweep dispatch at this tiny shape costs ~100x the sweep) ---------
    import jax
    import jax.numpy as jnp
    A1 = np.zeros((N, N)); W1 = np.zeros((N, N)); b1 = np.zeros(N)
    seeds1 = (0, 1)
    k = n_keep * len(seeds1)
    for seed in seeds1:
        model = pt.NonlinearAutoregressiveModel(
            N, basis=basis, observation="binomial", network="erdos_renyi",
            spike_and_slab=True, seed=seed,
            obs_kwargs=dict(n_trials=n_trials), net_kwargs=nk)
        model.add_data(Y)
        sweep = model._sweep
        datas = tuple(model.datas)

        @jax.jit
        def chain(state, kb, ka):
            def step(s, kk):
                return sweep(kk, s, datas)[0], None

            state = jax.lax.scan(step, state, kb)[0]

            def astep(carry, kk):
                s, aA, aW, ab = carry
                s = sweep(kk, s, datas)[0]
                return (s, aA + s.A,
                        aW + jnp.sum(s.A[:, :, None] * s.W, -1),
                        ab + s.b), None

            z = jnp.zeros
            carry = (state, z((N, N)), z((N, N)), z((N,)))
            return jax.lax.scan(astep, carry, ka)[0]

        _, aA, aW, ab = chain(
            model.state, jax.random.split(model._next_key(), n_burn),
            jax.random.split(model._next_key(), n_keep))
        A1 += np.asarray(aA) / k
        W1 += np.asarray(aW) / k
        b1 += np.asarray(ab) / k

    # --- NumPy/f64 reference chains (two seeds, pooled) -------------------
    A2 = np.zeros((N, N)); W2 = np.zeros((N, N)); b2 = np.zeros(N)
    seeds2 = (7, 8)
    k = n_keep * len(seeds2)
    for seed in seeds2:
        ref = NumpyGLMReference(N=N, B=B, basis=basis, rho=rho, mu_w=0.0,
                                sigma_w=sigma_w, mu_b=mu_b, sigma_b=sigma_b,
                                seed=seed, observation="binomial",
                                n_trials=n_trials)
        Xf = ref.design(Y)
        for it in range(n_burn + n_keep):
            ref.resample(Y, Xf)
            if it >= n_burn:
                A2 += ref.A / k
                W2 += (ref.A[:, :, None] * ref.W).sum(-1) / k
                b2 += ref.b / k

    assert np.max(np.abs(b1 - b2)) < 0.2, (b1, b2)
    assert np.max(np.abs(W1 - W2)) < 0.2, np.max(np.abs(W1 - W2))
    assert np.max(np.abs(A1 - A2)) < 0.3, np.max(np.abs(A1 - A2))
    assert abs(A1.mean() - A2.mean()) < 0.06


@pytest.mark.slow
def test_posterior_means_match_numpy_reference_sbm():
    """Structured-prior path (round 4, deepening VERDICT r3 weak #5): the
    stochastic block model — per-edge spike/slab hypers indexed by learned
    block labels, sequential-Gibbs label scan, Dirichlet pi, per-pair Beta
    rho and NIW weight priors — against the independent f64 NumPy oracle.
    All compared functionals are label-permutation invariant (per-edge A/W
    posterior means, bias, edge density, MEAN of the rho block matrix)."""
    N, B, L, T = 6, 2, 4, 1500
    K, a_rho, b_rho, alpha_pi = 2, 1.0, 1.0, 1.0
    mu_b, sigma_b, sigma_w = -1.0, 0.4, 0.5
    basis = cosine_basis(B=B, L=L)

    nk = dict(K=K, a_rho=a_rho, b_rho=b_rho, alpha_pi=alpha_pi,
              sigma_w=sigma_w, niw_kappa0=1.0, niw_psi0=1.0,
              mu_bias=mu_b, sigma_bias=sigma_b, rho_init=0.35)
    gen = pt.NonlinearAutoregressiveModel(
        N, basis=basis, observation="bernoulli", network="sbm",
        spike_and_slab=True, seed=99, net_kwargs=nk)
    Y = gen.generate(T, keep=False).astype(np.float64)

    n_burn, n_keep = 200, 600

    # --- JAX chains (two seeds, pooled; scanned driver — the eager
    # per-sweep dispatch at this tiny shape costs ~100x the sweep) ---------
    import jax
    import jax.numpy as jnp
    A1 = np.zeros((N, N)); W1 = np.zeros((N, N)); b1 = np.zeros(N)
    rho1 = 0.0
    seeds1 = (0, 1)
    k = n_keep * len(seeds1)
    for seed in seeds1:
        model = pt.NonlinearAutoregressiveModel(
            N, basis=basis, observation="bernoulli", network="sbm",
            spike_and_slab=True, seed=seed, net_kwargs=nk)
        model.add_data(Y)
        sweep = model._sweep
        datas = tuple(model.datas)

        @jax.jit
        def chain(state, kb, ka):
            def step(s, kk):
                return sweep(kk, s, datas)[0], None

            state = jax.lax.scan(step, state, kb)[0]

            def astep(carry, kk):
                s, aA, aW, ab, ar = carry
                s = sweep(kk, s, datas)[0]
                return (s, aA + s.A,
                        aW + jnp.sum(s.A[:, :, None] * s.W, -1),
                        ab + s.b, ar + jnp.mean(s.net.rho)), None

            z = jnp.zeros
            carry = (state, z((N, N)), z((N, N)), z((N,)), 0.0)
            return jax.lax.scan(astep, carry, ka)[0]

        _, aA, aW, ab, ar = chain(
            model.state, jax.random.split(model._next_key(), n_burn),
            jax.random.split(model._next_key(), n_keep))
        A1 += np.asarray(aA) / k
        W1 += np.asarray(aW) / k
        b1 += np.asarray(ab) / k
        rho1 += float(ar) / k

    # --- NumPy/f64 reference chains (two seeds, pooled) ------------------
    A2 = np.zeros((N, N)); W2 = np.zeros((N, N)); b2 = np.zeros(N)
    rho2 = 0.0
    seeds2 = (7, 8)
    k = n_keep * len(seeds2)
    for seed in seeds2:
        ref = NumpyGLMReference(
            N=N, B=B, basis=basis, rho=0.35, sigma_w=sigma_w,
            mu_b=mu_b, sigma_b=sigma_b, seed=seed, network="sbm",
            K=K, alpha_pi=alpha_pi, a_rho=a_rho, b_rho=b_rho,
            niw_kappa0=1.0, niw_psi0=1.0)
        Xf = ref.design(Y)
        for it in range(n_burn + n_keep):
            ref.resample(Y, Xf)
            if it >= n_burn:
                A2 += ref.A / k
                W2 += (ref.A[:, :, None] * ref.W).sum(-1) / k
                b2 += ref.b / k
                rho2 += float(ref.rho_blk.mean()) / k

    assert np.max(np.abs(b1 - b2)) < 0.25, (b1, b2)
    assert np.max(np.abs(A1 - A2)) < 0.25, np.max(np.abs(A1 - A2))
    assert np.max(np.abs(W1 - W2)) < 0.35, np.max(np.abs(W1 - W2))
    assert abs(A1.mean() - A2.mean()) < 0.06
    assert abs(rho1 - rho2) < 0.12, (rho1, rho2)


@pytest.mark.slow
def test_posterior_means_match_numpy_reference_latent_distance():
    """Distance-prior path (sixth oracle family, round 4): the latent-
    distance network — rho_ij = logistic(gamma - ||l_i - l_j||^2) with the
    shared masked-NIW slab — against the independent f64 NumPy oracle.

    The two samplers use DIFFERENT exact algorithms for the (l, gamma)
    conditional: the JAX side runs merged-kick leapfrog HMC plus swap /
    prior-relocation MH (networks.py LatentDistanceConfig.resample), the
    oracle runs single-site random-walk Metropolis + prior relocations.
    Agreement on the position-marginal functionals therefore cross-checks
    the HMC implementation itself, not just the shared math. All compared
    functionals are rotation/reflection invariant (per-edge A/W posterior
    means, bias, edge density, gamma)."""
    N, B, L, T = 5, 2, 4, 1500
    sigma_l, sigma_gamma, sigma_w = 1.0, 2.0, 0.5
    mu_b, sigma_b = -1.0, 0.4
    basis = cosine_basis(B=B, L=L)

    nk = dict(dim=2, sigma_l=sigma_l, sigma_gamma=sigma_gamma,
              sigma_w=sigma_w, mu_bias=mu_b, sigma_bias=sigma_b,
              niw_kappa0=1.0, niw_psi0=1.0)
    gen = pt.NonlinearAutoregressiveModel(
        N, basis=basis, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=11,
        net_kwargs=dict(nk, gamma_init=0.5))
    Y = gen.generate(T, keep=False).astype(np.float64)

    n_burn, n_keep = 200, 600

    # --- JAX chains (two seeds, pooled; scanned driver — the eager
    # per-sweep dispatch at this tiny shape costs ~100x the sweep) ---------
    import jax
    import jax.numpy as jnp
    A1 = np.zeros((N, N)); W1 = np.zeros((N, N)); b1 = np.zeros(N)
    g1 = 0.0
    seeds1 = (0, 1)
    k = n_keep * len(seeds1)
    for seed in seeds1:
        model = pt.NonlinearAutoregressiveModel(
            N, basis=basis, observation="bernoulli",
            network="latent_distance", spike_and_slab=True, seed=seed,
            net_kwargs=dict(nk, swap_moves=2, relocate_moves=2))
        model.add_data(Y)
        sweep = model._sweep
        datas = tuple(model.datas)

        @jax.jit
        def chain(state, kb, ka):
            def step(s, kk):
                return sweep(kk, s, datas)[0], None

            state = jax.lax.scan(step, state, kb)[0]

            def astep(carry, kk):
                s, aA, aW, ab, ag = carry
                s = sweep(kk, s, datas)[0]
                return (s, aA + s.A,
                        aW + jnp.sum(s.A[:, :, None] * s.W, -1),
                        ab + s.b, ag + s.net.gamma), None

            z = jnp.zeros
            carry = (state, z((N, N)), z((N, N)), z((N,)), 0.0)
            return jax.lax.scan(astep, carry, ka)[0]

        _, aA, aW, ab, ag = chain(
            model.state, jax.random.split(model._next_key(), n_burn),
            jax.random.split(model._next_key(), n_keep))
        A1 += np.asarray(aA) / k
        W1 += np.asarray(aW) / k
        b1 += np.asarray(ab) / k
        g1 += float(ag) / k

    # --- NumPy/f64 reference chains (two seeds, pooled) ------------------
    A2 = np.zeros((N, N)); W2 = np.zeros((N, N)); b2 = np.zeros(N)
    g2 = 0.0
    seeds2 = (7, 8)
    k = n_keep * len(seeds2)
    for seed in seeds2:
        ref = NumpyGLMReference(
            N=N, B=B, basis=basis, rho=0.35, sigma_w=sigma_w,
            mu_b=mu_b, sigma_b=sigma_b, seed=seed,
            network="latent_distance", dim=2, sigma_l=sigma_l,
            sigma_gamma=sigma_gamma, niw_kappa0=1.0, niw_psi0=1.0)
        Xf = ref.design(Y)
        for it in range(n_burn + n_keep):
            ref.resample(Y, Xf)
            if it >= n_burn:
                A2 += ref.A / k
                W2 += (ref.A[:, :, None] * ref.W).sum(-1) / k
                b2 += ref.b / k
                g2 += ref.gamma / k

    assert np.max(np.abs(b1 - b2)) < 0.25, (b1, b2)
    assert np.max(np.abs(A1 - A2)) < 0.25, np.max(np.abs(A1 - A2))
    assert np.max(np.abs(W1 - W2)) < 0.35, np.max(np.abs(W1 - W2))
    assert abs(A1.mean() - A2.mean()) < 0.06
    assert abs(g1 - g2) < 0.6, (g1, g2)


@pytest.mark.slow
def test_posterior_means_match_numpy_reference_multinomial():
    """Stick-breaking path (seventh oracle config, round 4): the standalone
    MultinomialRegression — K-way counts decomposed into K-1 dependent
    binomial stick subproblems (ops/stick_breaking.py N_vec/kappa_vec) with
    PG(N_k, psi_k) auxiliaries — against the independent f64 NumPy oracle,
    which draws the integer-b auxiliaries as exact N_k-fold Devroye
    convolutions while the JAX side routes through the integer-b
    gamma-series dispatch: zero shared PG code. This is the only parity
    config exercising the regression layer (models/regressions.py) rather
    than the network GLM, so the stick transforms, the batched multi-dim
    weight draw, and the b=0 PG edge case (exhausted sticks) all get an
    independent cross-implementation check."""
    from pyglm_tpu.models.regressions import MultinomialRegression
    from pyglm_tpu.reference.numpy_ref import NumpyMultinomialRegression

    K, D_in, T, n_trials = 4, 3, 600, 5
    rng = np.random.RandomState(5)
    X = rng.randn(T, D_in).astype(np.float64)

    planted = MultinomialRegression(K, D_in, seed=42)
    Y = np.asarray(planted.rvs(X, n_trials=n_trials), np.float64)
    assert Y.sum(-1).max() == n_trials

    n_burn, n_keep = 100, 400

    # --- JAX chain -------------------------------------------------
    reg = MultinomialRegression(K, D_in, seed=0)
    A1 = np.zeros((K - 1, D_in)); b1 = np.zeros(K - 1)
    pi1 = np.zeros((T, K))
    for it in range(n_burn + n_keep):
        reg.resample((X, Y))
        if it >= n_burn:
            A1 += reg.A / n_keep
            b1 += reg.b / n_keep
            pi1 += np.asarray(reg.pi(X)) / n_keep

    # --- NumPy/f64 reference chain ----------------------------------------
    ref = NumpyMultinomialRegression(K, D_in, seed=7)
    A2 = np.zeros((K - 1, D_in)); b2 = np.zeros(K - 1)
    pi2 = np.zeros((T, K))
    for it in range(n_burn + n_keep):
        ref.resample(X, Y)
        if it >= n_burn:
            A2 += ref.A / n_keep
            b2 += ref.b / n_keep
            pi2 += ref.pi(X) / n_keep

    assert np.max(np.abs(A1 - A2)) < 0.1, (A1, A2)
    assert np.max(np.abs(b1 - b2)) < 0.1, (b1, b2)
    assert np.max(np.abs(pi1 - pi2)) < 0.03, np.max(np.abs(pi1 - pi2))
    # simplex sanity
    assert np.allclose(pi1.sum(-1), 1.0, atol=1e-4)


@pytest.mark.slow
def test_posterior_means_match_numpy_reference_dense_niw():
    """Dense path (eighth oracle config, round 4): the non-spike-and-slab
    weight conditional — each neuron's full (N*B+1)-dim conjugate Gaussian
    draw (weights.py resample_dense / _dense_one_neuron), which NO other
    parity config exercises — with the learned shared NIW weight prior
    over all N^2 edges, against the independent f64 NumPy oracle. Gates
    posterior means of W, bias, and the learned prior's (mu, tr Sigma)."""
    N, B, L, T = 4, 2, 4, 1500
    sigma_w, mu_b, sigma_b = 0.05, -1.0, 0.4
    basis = cosine_basis(B=B, L=L)

    gen = pt.BernoulliGLM(
        N, basis=basis, seed=31,
        net_kwargs=dict(learn_weight_prior=False, sigma_w=sigma_w,
                        mu_bias=mu_b, sigma_bias=sigma_b))
    Y = gen.generate(T, keep=False).astype(np.float64)

    nk = dict(mu_bias=mu_b, sigma_bias=sigma_b, sigma_w=sigma_w,
              niw_kappa0=1.0, niw_psi0=1.0)
    n_burn, n_keep = 150, 400

    # --- JAX chain -------------------------------------------------
    model = pt.BernoulliGLM(N, basis=basis, seed=0, net_kwargs=nk)
    model.add_data(Y)
    W1 = np.zeros((N, N)); b1 = np.zeros(N)
    mu1 = np.zeros(B); tr1 = 0.0
    for it in range(n_burn + n_keep):
        model.resample_model()
        if it >= n_burn:
            W1 += model.W_effective / n_keep
            b1 += model.bias / n_keep
            mu1 += np.asarray(model.state.net.mu) / n_keep
            tr1 += float(np.trace(np.asarray(model.state.net.Sigma))) / n_keep

    # --- NumPy/f64 reference chain ----------------------------------------
    ref = NumpyGLMReference(N=N, B=B, basis=basis, sigma_w=sigma_w,
                            mu_b=mu_b, sigma_b=sigma_b, seed=7,
                            network="dense", niw_kappa0=1.0, niw_psi0=1.0)
    Xf = ref.design(Y)
    W2 = np.zeros((N, N)); b2 = np.zeros(N)
    mu2 = np.zeros(B); tr2 = 0.0
    for it in range(n_burn + n_keep):
        ref.resample(Y, Xf)
        if it >= n_burn:
            W2 += ref.W.sum(-1) / n_keep
            b2 += ref.b / n_keep
            mu2 += ref.mu_sh / n_keep
            tr2 += float(np.trace(ref.Sigma_sh)) / n_keep

    assert np.max(np.abs(b1 - b2)) < 0.25, (b1, b2)
    assert np.max(np.abs(W1 - W2)) < 0.25, np.max(np.abs(W1 - W2))
    assert np.max(np.abs(mu1 - mu2)) < 0.15, (mu1, mu2)
    assert abs(tr1 - tr2) / tr2 < 0.3, (tr1, tr2)
