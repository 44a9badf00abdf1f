"""User-facing model classes — the reference API surface, on JAX devices.

Mirrors ``pyglm/models.py``: ``NonlinearAutoregressiveModel`` (alias ``GLM``)
with ``add_data`` / ``generate`` / ``resample_model`` / ``log_likelihood`` /
``means`` and properties ``A`` / ``W`` / ``bias``, plus the pre-wired
convenience classes (``SparseBernoulliGLM`` etc., reference ~bottom of
models.py). The class is a thin stateful shell around pure jitted kernels:
all arrays live on device as a ``GLMState`` pytree; one ``resample_model``
call is one compiled Gibbs sweep.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from pyglm_tpu.ops.basis import cosine_basis, design_matrix
from pyglm_tpu.models.observations import make_observation
from pyglm_tpu.models.networks import make_network
from pyglm_tpu.models.sweep import (
    GLMData, GLMState, make_gibbs_sweep, make_log_likelihood,
    make_generator, init_state_from_prior,
)


class NonlinearAutoregressiveModel:
    """Fully-Bayesian network GLM of spike trains (Gibbs inference).

    psi[t, n] = b[n] + sum_j A[j,n] sum_k W[j,n,k] (Y[:,j] * basis_k)(t-1)
    Y[t, n] ~ observation(link(psi[t, n]))
    (A, W) ~ network prior.

    Args:
      N: number of neurons.
      B, L: basis dimension / filter length (ignored if `basis` given).
      basis: optional (L, B) filter matrix.
      observation: 'bernoulli' | 'binomial' | 'negative_binomial' | 'gaussian'
        or a family object from pyglm_tpu.models.observations.
      network: 'dense' | 'erdos_renyi' | 'sbm' | 'latent_distance' or a
        config object from pyglm_tpu.models.networks.
      spike_and_slab: resample a sparse adjacency A jointly with W.
      seed: PRNG seed for this model's chain.
      precision: accuracy / speed trade of the sweep's large matmuls (psi
        and the Gram statistics), each mode an explicit dot algorithm
        (models/weights.py _PRECISIONS) —
        'high' (default): f32-grade, three bf16 products with f32
        accumulation (lax.DotAlgorithmPreset.BF16_BF16_F32_X3);
        'default': the backend's fastest f32 dot, TF32 on an H100
        (~1e-3 relative), the fastest; 'highest': full f32, the slowest.
        The small contractions of the edge scan and the network prior
        always run in full f32.
    """

    def __init__(self, N: int, B: int = 4, L: int = 10, basis=None,
                 observation="bernoulli", network="dense",
                 spike_and_slab: bool = False, seed: int = 0,
                 t_chunk: int = 512, precision: str = "high",
                 obs_kwargs: Optional[dict] = None,
                 net_kwargs: Optional[dict] = None):
        if basis is None:
            basis = cosine_basis(B=B, L=L)
        basis = np.asarray(basis, np.float32)
        self.N = N
        self.L, self.B = basis.shape
        self.basis = basis
        self.spike_and_slab = bool(spike_and_slab)

        self.observation = (make_observation(observation, **(obs_kwargs or {}))
                            if isinstance(observation, str) else observation)
        self.network = (make_network(network, N=N, B=self.B,
                                     **(net_kwargs or {}))
                        if isinstance(network, str) else network)

        from pyglm_tpu.models.weights import dot_precision
        dot_precision(precision)            # reject unknown / removed modes
        self._key = jax.random.key(seed)
        self._t_chunk = t_chunk
        self._precision = precision
        self._mesh = None
        self.state: GLMState = init_state_from_prior(
            self._next_key(), self.observation, self.network,
            N, self.B, self.spike_and_slab)

        self._sweep = jax.jit(make_gibbs_sweep(
            self.observation, self.network, N, self.B, self.spike_and_slab,
            t_chunk=t_chunk, precision=precision))
        self._loglik = jax.jit(make_log_likelihood(
            self.observation, N, self.B, precision=precision))
        self._generate = jax.jit(
            make_generator(self.observation, N, self.B),
            static_argnames=("T",))
        self.datas: list[GLMData] = []

    # -- plumbing ----------------------------------------------------------

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    @property
    def P(self) -> int:
        return self.N * self.B + 1

    # -- reference API surface ----------------------------------------------

    def add_data(self, Y) -> None:
        """Register a (T, N) spike matrix: builds the design tensor on device
        (reference: models.py add_data -> basis convolution)."""
        Y = jnp.asarray(Y, jnp.float32)
        assert Y.ndim == 2 and Y.shape[1] == self.N, (
            f"expected (T, {self.N}) data, got {Y.shape}")
        max_y = getattr(self.observation, "max_y", None)
        if max_y is not None:
            # The CRT r-update sums a static max_y tables; counts above it
            # would be silently dropped, biasing the r conditional.
            y_max = float(jnp.max(Y))
            if y_max > max_y:
                raise ValueError(
                    f"max observed count {y_max:.0f} exceeds the "
                    f"observation family's max_y={max_y}; construct with "
                    f"obs_kwargs=dict(max_y={int(y_max)}) or larger so the "
                    f"CRT dispersion update sees every count")
        # On a sharded model, ingest under the mesh: per-time-shard causal
        # conv with an L-bin ppermute halo, so the full (T, P) design is
        # never materialized on one device (SURVEY.md §5 long-context row).
        if self._mesh is not None:
            n_time = self._mesh.shape.get("time", 1)
            if Y.shape[0] % n_time == 0 and Y.shape[0] // n_time >= self.L:
                from pyglm_tpu.ops.basis import design_matrix_sharded
                Xf = design_matrix_sharded(Y, self.basis, self._mesh)
            else:
                import warnings
                from pyglm_tpu.utils.utils import PerformanceWarning
                warnings.warn(
                    f"sharded model: dataset with T={Y.shape[0]} ingests "
                    f"UNSHARDED (needs T divisible by the mesh time axis "
                    f"{n_time} and a shard of at least L={self.L} bins); "
                    f"the sweep will also bypass the mesh-fused "
                    f"spike-and-slab path — pad or trim T to a multiple "
                    f"of {n_time} to keep the sharded design",
                    PerformanceWarning, stacklevel=2)
                Xf = design_matrix(Y, self.basis)
        else:
            Xf = design_matrix(Y, self.basis)
        Gg0 = Gfull = XtY = None
        if not self.observation.needs_pg:
            # Gaussian fast path: cache unweighted Gram statistics once —
            # omega = 1/eta is time-constant, so per-sweep stats are just
            # these divided by eta (see models/sweep.py).
            from pyglm_tpu.models.weights import (
                einsum_at, group_gram_blocks, _auto_group)
            T = Y.shape[0]
            if self.spike_and_slab:
                G = _auto_group(self.N, self.B)
                Gg0 = group_gram_blocks(
                    Xf, jnp.ones((T, 1), jnp.float32), self.B, G,
                    t_chunk=self._t_chunk, precision=self._precision)
            else:
                Gfull = einsum_at("tp,tq->pq", Xf, Xf, self._precision)
                XtY = einsum_at("tp,tn->pn", Xf, Y, self._precision)
        # Transposed design at rest: the residual-space group matmuls and
        # the mesh spike-and-slab pass consume the design presyn-major, so
        # it is transposed once here rather than on every sweep.
        Xt = jnp.asarray(Xf.T)
        self.datas.append(GLMData(Y=Y, Xf=Xf, Xt=Xt, Gg0=Gg0, Gfull=Gfull,
                                  XtY=XtY,
                                  llc=self.observation.ll_cache(Y)))

    def generate(self, T: int, keep: bool = True):
        """Sample a (T, N) spike train from the current model parameters."""
        Y, _ = self._generate(self._next_key(), self.state, self.basis, T=T)
        Y = np.asarray(Y)
        if keep:
            self.add_data(Y)
        return Y

    def forecast(self, T_ahead: int, n_samples: int = 1, thin: int = 1,
                 data_index: int = -1):
        """Posterior-predictive simulation continuing from observed history.

        Seeds the autoregressive generator with the last L bins of the
        chosen dataset, drawing `n_samples` futures; between samples the
        Gibbs chain advances `thin` sweeps so futures integrate over
        parameter uncertainty (the serving-path analog of the reference's
        demo-only generate()). Returns (n_samples, T_ahead, N).
        """
        assert self.datas, "no observed history; call add_data() first"
        ring0 = self.datas[data_index].Y[-self.L:]
        if ring0.shape[0] < self.L:
            ring0 = jnp.concatenate(
                [jnp.zeros((self.L - ring0.shape[0], self.N)), ring0], axis=0)
        out = []
        for _ in range(n_samples):
            if thin > 0:
                for _ in range(thin):
                    self.resample_model()
            Y, _ = self._generate(self._next_key(), self.state, self.basis,
                                  T=T_ahead, ring0=ring0)
            out.append(np.asarray(Y))
        return np.stack(out)

    def resample_model(self):
        """One full Gibbs sweep over weights, adjacency, aux, and network."""
        assert self.datas, "call add_data() or generate(keep=True) first"
        self.state, diag = self._sweep(
            self._next_key(), self.state, tuple(self.datas))
        return {k: float(v) for k, v in diag.items()}

    def log_likelihood(self, data=None) -> float:
        """Total log-likelihood of registered data (or a provided (T,N) Y)."""
        if data is None:
            return float(sum(self._loglik(self.state, d) for d in self.datas))
        Y = jnp.asarray(data, jnp.float32)
        d = GLMData(Y=Y, Xf=design_matrix(Y, self.basis))
        return float(self._loglik(self.state, d))

    def log_probability(self) -> float:
        return self.log_likelihood()

    @property
    def A(self) -> np.ndarray:
        """(N_pre, N_post) adjacency sample."""
        return np.asarray(self.state.A)

    @property
    def W(self) -> np.ndarray:
        """(N_pre, N_post, B) weight sample (zero where A == 0)."""
        return np.asarray(self.state.W)

    @property
    def W_effective(self) -> np.ndarray:
        """(N_pre, N_post) net synaptic weights: sum over basis of A*W."""
        return np.asarray(jnp.sum(self.state.A[:, :, None] * self.state.W,
                                  axis=-1))

    @property
    def bias(self) -> np.ndarray:
        return np.asarray(self.state.b)

    @property
    def means(self):
        """Per-dataset conditional mean rates E[y_t | history] (reference:
        models.py `means` property)."""
        from pyglm_tpu.models.weights import einsum_at, pack_weights
        out = []
        w_full = pack_weights(self.state.A, self.state.W, self.state.b)
        for d in self.datas:
            psi = einsum_at("tp,pn->tn", d.Xf, w_full, self._precision)
            out.append(np.asarray(self.observation.mean(psi, self.state.aux)))
        return out

    # -- conveniences beyond the reference -----------------------------------

    def shard(self, mesh=None):
        """Distribute this model over a device mesh (SPMD Gibbs). With no
        argument, auto-selects the largest compatible mesh."""
        from pyglm_tpu.parallel.sharding import best_mesh_for, shard_model
        if mesh is None:
            mesh = best_mesh_for(
                self.N, T=[int(d.Y.shape[0]) for d in self.datas])
        return shard_model(self, mesh)

    def fit(self, n_samples: int = 100, n_burnin: int = 0, thin: int = 1,
            callback=None, verbose: bool = False):
        """Run the Gibbs chain, returning thinned posterior samples as host
        arrays: dict with 'A' (S,N,N), 'W' (S,N,N,B), 'bias' (S,N), 'lls'.

        Runs ``n_burnin + n_samples * thin`` sweeps and records every
        ``thin``-th post-burn-in sweep, so exactly ``n_samples`` samples
        return regardless of thin — the same contract as ``fit_compiled``.
        """
        samples = {"A": [], "W": [], "bias": [], "lls": []}
        for it in range(n_burnin + n_samples * thin):
            diag = self.resample_model()
            if it >= n_burnin and (it - n_burnin) % thin == thin - 1:
                samples["A"].append(self.A)
                samples["W"].append(self.W)
                samples["bias"].append(self.bias)
                samples["lls"].append(diag["log_likelihood"])
            if callback is not None:
                callback(self, it, diag)
            if verbose and it % 10 == 0:
                print(f"iter {it}: ll={diag['log_likelihood']:.1f} "
                      f"edges={diag['n_edges']:.0f}")
        return {k: np.asarray(v) for k, v in samples.items()}

    def fit_compiled(self, n_samples: int = 100, n_burnin: int = 0,
                     thin: int = 1, max_sweeps_per_launch: int = 250):
        """Run the Gibbs chain as compiled lax.scan segments on device.

        Much faster than fit() when per-sweep dispatch dominates (small and
        medium models). Returns the same dict as fit(). On a sharded model
        the scan runs the SPMD sweep under the mesh (whole chains on the
        device mesh with zero host dispatch).

        max_sweeps_per_launch bounds the sweeps one device program scans,
        and with them the device memory that holds a segment's samples
        (each sample is an (N, N, B+1) block) until they are copied to the
        host; long chains run as several launches — one compile, since
        segment lengths repeat.
        """
        assert self.datas, "call add_data() first"
        cap = max(1, max_sweeps_per_launch)
        if thin > cap:
            raise ValueError(
                f"thin={thin} exceeds max_sweeps_per_launch={cap}: one "
                f"sample segment would scan {thin} sweeps in a single "
                f"device program, past the bound this parameter sets; "
                f"raise max_sweeps_per_launch explicitly")
        datas = tuple(self.datas)
        sweep = (self._sweep_raw if self._mesh is not None
                 else self._sweep)

        # Segment runners are cached on the model (keyed by the sweep fn
        # object and thin) so repeated calls — e.g. fit_ensemble's chains —
        # reuse one trace/compile instead of re-jitting per call.
        if not hasattr(self, "_fit_jits"):
            self._fit_jits = {}
        cache_key = (sweep, thin)
        if cache_key not in self._fit_jits:
            def burn_seg(key, state, datas, length):
                def step(s, k):
                    s, _ = sweep(k, s, datas)
                    return s, None
                return jax.lax.scan(step, state,
                                    jax.random.split(key, length))[0]

            def sample_seg(key, state, datas, length):
                def one(s, k):
                    ks = jax.random.split(k, thin)
                    s, diags = jax.lax.scan(
                        lambda ss, kk: sweep(kk, ss, datas), s, ks)
                    return s, (s.A, s.W, s.b, diags["log_likelihood"][-1])
                return jax.lax.scan(one, state, jax.random.split(key, length))

            self._fit_jits[cache_key] = (
                jax.jit(burn_seg, static_argnames=("length",)),
                jax.jit(sample_seg, static_argnames=("length",)))
        burn_j, sample_j = self._fit_jits[cache_key]

        state = self.state
        left = n_burnin
        while left > 0:
            c = min(left, cap)
            state = burn_j(self._next_key(), state, datas, length=c)
            left -= c
        out = {"A": [], "W": [], "bias": [], "lls": []}
        left = n_samples
        while left > 0:
            c = min(left, max(1, cap // max(1, thin)))
            state, (A, W, b, lls) = sample_j(
                self._next_key(), state, datas, length=c)
            out["A"].append(np.asarray(A))
            out["W"].append(np.asarray(W))
            out["bias"].append(np.asarray(b))
            out["lls"].append(np.asarray(lls))
            left -= c
        self.state = state
        if not out["A"]:        # burn-only call: correctly-shaped empties
            N, B = self.N, self.B
            return {"A": np.zeros((0, N, N), np.float32),
                    "W": np.zeros((0, N, N, B), np.float32),
                    "bias": np.zeros((0, N), np.float32),
                    "lls": np.zeros((0,), np.float32)}
        return {k: np.concatenate(v, axis=0) for k, v in out.items()}

    def fit_ensemble(self, n_chains: int = 4, n_samples: int = 100,
                     n_burnin: int = 0, thin: int = 1, seeds=None,
                     compiled: bool = True, stacked: bool | str = "auto",
                     mesh=None, collect: str = "samples"):
        """Run ``n_chains`` independent Gibbs chains from fresh prior
        initializations on the registered data, with split-R̂ convergence
        diagnostics over the pooled traces.

        The reference leaves convergence assessment entirely to the
        user-owned MCMC loop (SURVEY.md §3.5); this is the canonical
        multi-chain check — chains started overdispersed (from the prior)
        must agree on every marginal.

        Execution: ``stacked`` (default "auto") runs all C chains as ONE
        lane-stacked sweep at C*N postsyn lanes (models/ensemble.py) —
        the design stream and its Gram products are shared across chains,
        so aggregate chain-sweeps/sec is several times the sequential
        loop at small N. "auto" uses the stacked path whenever the model
        is unsharded; ``stacked=False`` forces the sequential loop (each
        chain on this model's compiled sweep, zero recompiles after the
        first chain).

        Chain-axis device parallelism: pass ``mesh`` (a ('chain',) mesh
        from parallel.sharding.make_chain_mesh) to spread the stacked
        chains one-group-per-device with the data replicated — M devices
        give M× aggregate chain throughput with zero collectives in the
        Gibbs pass (models/ensemble.py make_stacked_sweep_sharded). To
        COMPOSE chain parallelism with data parallelism (big models whose
        per-chain sweep itself needs sharding), pass a 3-D
        ('chain','time','neuron') mesh from
        parallel.sharding.make_chain_data_mesh instead: chains spread
        over chain groups AND each group's sweep runs neuron/time-sharded
        (make_stacked_sweep_gspmd). Either way the model itself must be
        unsharded — the mesh carries all the parallelism.

        Returns a dict with stacked per-chain samples 'A' (C,S,N,N),
        'W' (C,S,N,N,B), 'bias' (C,S,N), 'lls' (C,S), plus
        'rhat_edge' (N,N) split-R̂ of the A inclusion traces,
        'rhat_bias' (N,) and 'rhat_ll' (scalar). R̂ ≲ 1.01 across the
        board indicates the chains have mixed. The model's own chain
        state and key are restored afterwards.

        Posterior-mean mode: ``collect="mean"`` skips sample
        materialization entirely — per-chain posterior means accumulate
        in the compiled scan carry (O(state) memory; at N=500, C=8 the
        sample stacks would be tens of GB) and the return dict is instead
        {'A_mean' (C,N,N), 'Weff_mean' (C,N,N), 'A_mean_pooled' (N,N),
        'Weff_mean_pooled' (N,N), 'lls' (C,S), 'rhat_ll',
        'final_states': list of C GLMState}. The POOLED means are the
        measured-best config-5-scale estimator (BASELINE.md round-4 PT
        study: 8 pooled chains AUC 0.875 vs 0.823 single at matched
        FLOPs); benchmarks/acceptance.py gates it. Requires the stacked
        path (any mesh kind is fine); ``thin`` is ignored.
        """
        from pyglm_tpu.utils.metrics import split_rhat

        assert self.datas, "call add_data() or generate(keep=True) first"
        assert n_chains >= 2 and n_samples >= 4, (n_chains, n_samples)
        if mesh is not None:
            assert self._mesh is None, (
                "chain-axis parallelism needs an unsharded model (the "
                "dataset is replicated per device); use EITHER shard() "
                "or fit_ensemble(mesh=...)")
            assert "chain" in mesh.shape, (
                "fit_ensemble mesh must have a 'chain' axis "
                "(parallel.sharding.make_chain_mesh)")
            assert stacked in ("auto", True), (
                "mesh= implies the stacked path; drop stacked=False")
            stacked = True
        if stacked == "auto":
            stacked = self._mesh is None and compiled
        assert collect in ("samples", "mean"), collect
        if collect == "mean":
            assert stacked, (
                "collect='mean' accumulates in the lane-stacked scan; it "
                "needs the stacked path (unsharded model or mesh=)")
        state0, key0 = self.state, self._key
        if seeds is None:
            seeds = range(1, n_chains + 1)
        runs = []
        try:
            if stacked:
                from pyglm_tpu.models.ensemble import run_stacked_chains
                runs = run_stacked_chains(
                    self, n_chains, n_samples=n_samples,
                    n_burnin=n_burnin, thin=thin, seeds=seeds, mesh=mesh,
                    collect=collect)
            else:
                for sd in seeds:
                    # distinct, reproducible key stream per chain
                    self._key = jax.random.fold_in(
                        jax.random.key(int(sd)), 0x5EED)
                    self.state = init_state_from_prior(
                        self._next_key(), self.observation, self.network,
                        self.N, self.B, self.spike_and_slab)
                    fit = self.fit_compiled if compiled else self.fit
                    runs.append(fit(n_samples=n_samples, n_burnin=n_burnin,
                                    thin=thin))
        finally:
            self.state, self._key = state0, key0
        if collect == "mean":
            out = runs                       # dict from run_stacked_chains
            out["lls"] = out["lls"].T        # (S, C) -> (C, S)
            out["A_mean_pooled"] = out["A_mean"].mean(axis=0)
            out["Weff_mean_pooled"] = out["Weff_mean"].mean(axis=0)
            out["rhat_ll"] = float(np.asarray(
                split_rhat(out["lls"][..., None]))[0])
            return out
        out = {k: np.stack([r[k] for r in runs])
               for k in ("A", "W", "bias", "lls")}
        out["rhat_edge"] = split_rhat(out["A"])
        out["rhat_bias"] = split_rhat(out["bias"])
        out["rhat_ll"] = float(np.asarray(split_rhat(out["lls"][..., None]))[0])
        return out

    def fit_tempered(self, n_samples: int = 100, n_burnin: int = 0,
                     thin: int = 1, n_rungs: int = 8, betas=None,
                     accept: float = 0.3, pilot_sweeps: int = 200,
                     seeds=None, max_sweeps_per_launch: int | None = None,
                     mesh=None):
        """Parallel-tempered Gibbs: a ``n_rungs`` inverse-temperature ladder
        β_1 < … < β_C = 1 run as ONE lane-stacked sweep, with adjacent-rung
        replica-exchange swaps every sweep (models/tempering.py). Returns
        the COLD (β = 1) rung's thinned samples in the same dict contract
        as ``fit_compiled`` ('A','W','bias','lls'), plus the diagnostics
        'betas' (C,), 'swap_rate' (C,) — accepted swaps per ATTEMPT per
        rung (interior rungs attempt every sweep, the two ends only on
        their parity); healthy ladders sit well above ~0.2 — and
        'ladder_span' (β_C − β_1), 'sd_ll' (the pilot's measured posterior
        fluctuation scale; None when betas was given) and 'pilot_sweeps'
        (the 2×pilot cost a matched-budget comparison must count).

        Ladder choice: with ``betas=None`` a short pilot of the standard
        chain measures the posterior fluctuation scale sd(ll) of the
        untempered log-likelihood, and the ladder is spaced at the uniform
        Δβ whose adjacent-swap acceptance is ≈ ``accept``
        (tempering.suggest_ladder). The resulting span 1 − β_1 is narrow
        when sd(ll) is large (Δβ ≈ 2 erfc⁻¹(accept)/sd(ll)) — that is the
        ladder the config-5 study measured to cut τ_int of the
        latent-distance position panel 6.5× and lift matched-budget link
        AUC +0.037 over the single chain (BASELINE.md config-5, round 4);
        wide ladders at practical C freeze (swap rate ≈ 0).

        When to prefer this over ``fit_ensemble``: tempering buys
        PER-CHAIN mixing (one coherent exact chain with 6.5× lower τ) —
        use it for joint trajectory functionals, suspected multimodality,
        or τ-bound workflows. For pooled posterior-MEAN functionals on a
        well-behaved posterior, ``fit_ensemble``'s C independent chains
        pool to a better estimator at the same FLOPs (the study's
        ensemble arm: AUC 0.875 vs 0.860 at matched budget).

        Supported for every observation family whose β-power likelihood
        stays PG-conjugate with fixed likelihood auxiliaries: Bernoulli
        and Binomial always (ω ~ PG(β·b, ψ), κ → βκ), NegativeBinomial
        with ``resample_r=False``, Gaussian with ``resample_eta=False``
        (precision scales by β). Reference analog: none (SURVEY.md §3.5 —
        the reference leaves multi-chain strategies to the user).

        Chain-axis device parallelism: pass ``mesh`` (a ('chain',) mesh
        from parallel.sharding.make_chain_mesh) to spread the ladder's
        rungs across devices on replicated data — the Gibbs pass is
        collective-free and the swap moves only the (C,) log-likelihoods
        plus the accepted rung states between devices, so a whole ladder
        costs about one rung of wall time on M=C devices
        (models/tempering.py make_tempered_sweep_sharded). A 3-D
        ('chain','time','neuron') mesh (make_chain_data_mesh) COMPOSES
        the ladder with data parallelism: rungs over chain groups, each
        rung's Gibbs pass neuron/time-sharded
        (make_tempered_sweep_gspmd) — the config-5-scale model with a
        ladder on one slice.
        """
        from pyglm_tpu.models.tempering import (init_tempered_states,
                                                make_tempered_sweep,
                                                make_tempered_sweep_gspmd,
                                                make_tempered_sweep_sharded,
                                                suggest_ladder)

        assert self.datas, "call add_data() or generate(keep=True) first"
        assert self._mesh is None, (
            "fit_tempered runs on the lane-stacked (unsharded) machinery; "
            "temper before shard(), or run the sharded chain untempered")
        if mesh is not None:
            assert "chain" in mesh.shape, (
                "fit_tempered mesh must have a 'chain' axis "
                "(parallel.sharding.make_chain_mesh)")
        # Same per-launch sample-memory bound as run_stacked_chains: the
        # ladder stacks n_rungs lane-chains into one program, so the auto
        # default divides the single-chain 250-sweep segment by the rung
        # count.
        cap = max(1, (250 // max(1, n_rungs)) if max_sweeps_per_launch is None
                  else max_sweeps_per_launch)
        if thin > cap:
            raise ValueError(
                f"thin={thin} exceeds max_sweeps_per_launch={cap}")

        sd_ll = None
        pilot_cost = 0
        if betas is None:
            # Pilot: measure sd(ll) near the posterior on the standard
            # chain (state/key restored — the pilot is scaffolding). Its
            # 2*pilot_sweeps sweeps are real compute: matched-budget
            # comparisons should count them (returned as 'pilot_sweeps').
            state0, key0 = self.state, self._key
            try:
                pilot = self.fit_compiled(
                    n_samples=pilot_sweeps, n_burnin=pilot_sweeps,
                    max_sweeps_per_launch=cap)
            finally:
                self.state, self._key = state0, key0
            sd_ll = float(np.std(pilot["lls"]))
            betas, span = suggest_ladder(sd_ll, n_rungs, accept=accept)
            pilot_cost = 2 * pilot_sweeps
            if span < 0.1:
                import warnings
                warnings.warn(
                    f"fit_tempered: the acceptance-feasible ladder is "
                    f"NARROW — {n_rungs} rungs span only "
                    f"[{betas[0]:.4f}, 1] (sd(ll)={sd_ll:.1f} bounds the "
                    f"swap-feasible rung gap at ~{span / (n_rungs - 1):.2e}"
                    f"). This is the design the config-5 study validated "
                    f"(it still cuts the cold chain's tau_int; wide "
                    f"ladders at practical C freeze at ~0 swaps), but if "
                    f"you expected rungs near a flat beta~0.3 posterior, "
                    f"this ladder does not provide them — covering "
                    f"[0.3, 1] at this sd(ll) would need "
                    f"~{int(np.ceil(0.7 * (n_rungs - 1) / max(span, 1e-12)))}"
                    f" rungs", stacklevel=2)
        betas = np.asarray(betas, np.float64)
        C = betas.shape[0]
        assert betas.ndim == 1 and C >= 2, betas.shape
        # Degenerate rungs fail silently otherwise: PG(beta*b, psi) at
        # beta <= 0 returns omega = 0, the psi recovery (kappa - u)/omega
        # goes NaN, and every swap touching the rung rejects — the ladder
        # quietly loses rungs with no error (ADVICE r4).
        assert np.all(betas > 0), (
            f"betas must be positive (got min {betas.min():.4g}); "
            f"suggest_ladder clamps its auto ladder to a positive floor")
        assert np.all(np.diff(betas) > 0), "betas must be strictly ascending"
        assert abs(betas[-1] - 1.0) < 1e-9, (
            f"the cold rung must run at beta=1 (got betas[-1]={betas[-1]!r})")

        composed = mesh is not None and bool(
            set(mesh.shape) & {"time", "neuron"})
        if composed:
            # 3-D chain-data mesh: rungs over chain groups, each rung's
            # Gibbs pass neuron/time-sharded (make_chain_data_mesh).
            sweep = make_tempered_sweep_gspmd(
                self.observation, self.network, self.N, self.B, betas,
                mesh, spike_slab=self.spike_and_slab,
                t_chunk=self._t_chunk, precision=self._precision)
        elif mesh is not None:
            sweep = make_tempered_sweep_sharded(
                self.observation, self.network, self.N, self.B, betas,
                mesh, spike_slab=self.spike_and_slab,
                t_chunk=self._t_chunk, precision=self._precision)
        else:
            sweep = make_tempered_sweep(
                self.observation, self.network, self.N, self.B, betas,
                spike_slab=self.spike_and_slab, t_chunk=self._t_chunk,
                precision=self._precision)
        st = init_tempered_states(self, betas, seeds=seeds)
        datas = tuple(self.datas)
        if composed:
            from pyglm_tpu.models.ensemble import chain_data_shardings
            state_sh, data_sh = chain_data_shardings(mesh, st, datas)
            st = jax.device_put(st, state_sh)
            datas = jax.device_put(datas, data_sh)
        elif mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            st = jax.device_put(st, jax.tree.map(
                lambda _: NamedSharding(mesh, P("chain")), st))
            datas = jax.device_put(datas, jax.tree.map(
                lambda _: NamedSharding(mesh, P()), datas))
        cold = C - 1
        key = jax.random.fold_in(self._next_key(), 0x7E3B)

        def burn_seg(key, st, datas, length):
            def step(s, k):
                s, d = sweep(k, s, datas)
                return s, (d["swap_accept"], d["swap_parity"])
            st, (acc, par) = jax.lax.scan(
                step, st, jax.random.split(key, length))
            return st, acc.sum(axis=0), par.sum()

        def sample_seg(key, st, datas, length):
            def one(s, k):
                ks = jax.random.split(k, thin)
                s, d = jax.lax.scan(
                    lambda ss, kk: sweep(kk, ss, datas), s, ks)
                return s, (s.A[cold], s.W[cold], s.b[cold],
                           d["log_likelihood"][-1, cold],
                           d["swap_accept"].sum(axis=0),
                           d["swap_parity"].sum())
            st, outs = jax.lax.scan(one, st, jax.random.split(key, length))
            return st, outs

        burn_j = jax.jit(burn_seg, static_argnames=("length",))
        sample_j = jax.jit(sample_seg, static_argnames=("length",))

        sw_acc = np.zeros(C, np.float64)
        n_sweeps = 0
        n_parity1 = 0.0
        left = n_burnin
        while left > 0:
            c = min(left, cap)
            key, k = jax.random.split(key)
            st, acc, par = burn_j(k, st, datas, length=c)
            sw_acc += np.asarray(acc); n_sweeps += c
            n_parity1 += float(par)
            left -= c
        out = {"A": [], "W": [], "bias": [], "lls": []}
        left = n_samples
        while left > 0:
            c = min(left, max(1, cap // max(1, thin)))
            key, k = jax.random.split(key)
            st, (A, W, b, lls, acc, par) = sample_j(k, st, datas, length=c)
            out["A"].append(np.asarray(A))
            out["W"].append(np.asarray(W))
            out["bias"].append(np.asarray(b))
            out["lls"].append(np.asarray(lls))
            sw_acc += np.asarray(acc).sum(axis=0); n_sweeps += c * thin
            n_parity1 += float(np.asarray(par).sum())
            left -= c
        res = {k: np.concatenate(v, axis=0) for k, v in out.items()}
        # Interior rungs attempt one swap EVERY sweep; only the two end
        # rungs sit out on the off parity. End attempts use the ACTUAL
        # parity counts (the parity bit is Bernoulli(1/2) per sweep, so
        # the expected n/2 would be noisy for short runs — ADVICE r4):
        # rung 0 pairs rightward on parity 0; rung C-1 pairs leftward on
        # parity 0 when C is even, parity 1 when C is odd
        # (models/tempering.py swap_permutation's is_left/partner rule).
        n_parity0 = n_sweeps - n_parity1
        attempts = np.full(C, max(n_sweeps, 1), np.float64)
        attempts[0] = max(n_parity0, 1.0)
        attempts[-1] = max(n_parity0 if C % 2 == 0 else n_parity1, 1.0)
        res["swap_rate"] = sw_acc / attempts
        res["betas"] = betas
        res["ladder_span"] = float(betas[-1] - betas[0])
        res["sd_ll"] = sd_ll          # None unless the auto-ladder pilot ran
        res["pilot_sweeps"] = pilot_cost
        return res

    def copy_sample(self):
        """Host snapshot of the current parameter sample (pickle-friendly)."""
        return jax.tree.map(np.asarray, self.state)


GLM = NonlinearAutoregressiveModel


def _merge_net_defaults(kw: dict, **defaults) -> dict:
    """Merge convenience-class network-prior defaults under user overrides.

    Autoregressive models with unbounded links (Gaussian, NB's exp-mean)
    need small weight priors for the forward dynamics to be stable; the
    spiking Bernoulli link is bounded so sigma_w = 1 is fine.
    """
    net_kwargs = dict(defaults)
    net_kwargs.update(kw.get("net_kwargs") or {})
    kw["net_kwargs"] = net_kwargs
    return kw


class BernoulliGLM(NonlinearAutoregressiveModel):
    """Dense Bernoulli GLM (reference: pyglm/models.py BernoulliGLM)."""
    def __init__(self, N, **kw):
        kw.setdefault("observation", "bernoulli")
        kw.setdefault("network", "dense")
        kw.setdefault("spike_and_slab", False)
        super().__init__(N, **kw)


class SparseBernoulliGLM(NonlinearAutoregressiveModel):
    """Spike-and-slab Bernoulli GLM (reference: SparseBernoulliGLM)."""
    def __init__(self, N, **kw):
        kw.setdefault("observation", "bernoulli")
        kw.setdefault("network", "erdos_renyi")
        kw.setdefault("spike_and_slab", True)
        super().__init__(N, **kw)


class GaussianGLM(NonlinearAutoregressiveModel):
    """Dense linear-Gaussian model (reference: GaussianGLM)."""
    def __init__(self, N, **kw):
        kw.setdefault("observation", "gaussian")
        kw.setdefault("network", "dense")
        kw.setdefault("spike_and_slab", False)
        kw = _merge_net_defaults(kw, sigma_w=0.05, mu_bias=0.0)
        super().__init__(N, **kw)


class SparseGaussianGLM(NonlinearAutoregressiveModel):
    """Spike-and-slab linear-Gaussian model (reference: SparseGaussianGLM)."""
    def __init__(self, N, **kw):
        kw.setdefault("observation", "gaussian")
        kw.setdefault("network", "erdos_renyi")
        kw.setdefault("spike_and_slab", True)
        kw = _merge_net_defaults(kw, sigma_w=0.05, mu_bias=0.0)
        super().__init__(N, **kw)


class NegativeBinomialGLM(NonlinearAutoregressiveModel):
    """Dense negative-binomial count GLM (PG-augmented, b = y + r)."""
    def __init__(self, N, **kw):
        kw.setdefault("observation", "negative_binomial")
        kw.setdefault("network", "dense")
        kw.setdefault("spike_and_slab", False)
        kw = _merge_net_defaults(kw, sigma_w=0.003, mu_bias=-2.0)
        super().__init__(N, **kw)


class SparseNegativeBinomialGLM(NonlinearAutoregressiveModel):
    def __init__(self, N, **kw):
        kw.setdefault("observation", "negative_binomial")
        kw.setdefault("network", "erdos_renyi")
        kw.setdefault("spike_and_slab", True)
        kw = _merge_net_defaults(kw, sigma_w=0.003, mu_bias=-2.0)
        super().__init__(N, **kw)


class BinomialGLM(NonlinearAutoregressiveModel):
    def __init__(self, N, **kw):
        kw.setdefault("observation", "binomial")
        kw.setdefault("network", "dense")
        kw.setdefault("spike_and_slab", False)
        super().__init__(N, **kw)
