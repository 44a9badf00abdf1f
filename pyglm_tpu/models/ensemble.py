"""Lane-stacked multi-chain Gibbs: C independent chains as ONE wide sweep.

The GLM's Gibbs conditionals factorize over POSTSYN neurons given the
design — every (T, N) auxiliary array, every (P, N) weight column, and
the whole collapsed spike-and-slab update are lane-parallel over the
postsyn axis. C independent
chains of the same N-neuron model are therefore EXACTLY an N_pre-presyn,
C*N-postsyn model sharing one design: stack each chain's postsyn columns
side by side and run the ordinary sweep machinery once at C*N lanes.

Why chains are stacked on lanes (vs the reference's one-process-per-
chain, or a sequential loop over chains):
  - The design stream, its Gram products Z = x_i x_j, and every presyn
    block are computed ONCE and shared by all C chains — the marginal
    cost of a chain is only its omega/u lanes.
  - Small models leave most of the device idle (every per-edge step of
    an N=27 model is a few hundred elements wide); stacking chains widens
    each step C-fold at almost no extra latency. Throughput is aggregate
    chain-sweeps/sec, the quantity that matters for R-hat / ESS workflows
    (utils/metrics.py), which need >= 4 chains anyway.
  - No new code paths: the PG draws and the collapsed update are already
    lane-parallel; only the network prior and observation aux couple
    lanes WITHIN a chain, and those resample per chain under jax.vmap.

Chain independence: postsyn draws are lane-local in every path (XLA
draws shaped over lanes), network/aux updates
get split keys per chain, and the z-protocol statistical tests compare
stacked marginals against single-chain truth (tests/test_ensemble.py).

Reference analog: none — pyglm leaves multi-chain MCMC entirely to the
user (SURVEY.md §3.5); this is a capability the CPU architecture could
not express.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pyglm_tpu.models.sweep import GLMState, init_state_from_prior
from pyglm_tpu.models.weights import (EdgeHypers, einsum_at, pack_weights,
                                      resample_dense,
                                      resample_spike_slab_tspace,
                                      sufficient_stats, unpack_weights)


def _to_lanes(x):
    """(C, R, N, ...) -> (R, C*N, ...): chain-major postsyn lanes."""
    perm = (1, 0, 2) + tuple(range(3, x.ndim))
    return x.transpose(perm).reshape(
        (x.shape[1], x.shape[0] * x.shape[2]) + x.shape[3:])


def _from_lanes(x, C):
    """(R, C*N, ...) -> (C, R, N, ...)."""
    R, CN = x.shape[:2]
    y = x.reshape((R, C, CN // C) + x.shape[2:])
    return y.transpose((1, 0, 2) + tuple(range(3, y.ndim)))


def stack_states(states):
    """List of C same-config GLMState -> one pytree with a chain axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, 0), *states)


def unstack_states(st, C):
    return [jax.tree.map(lambda x: x[c], st) for c in range(C)]


def make_stacked_sweep(obs, network, N: int, B: int, C: int,
                       spike_slab: bool, t_chunk: int = 512,
                       precision: str = "highest"):
    """Build the C-chain lane-stacked sweep: (key, stacked_state, datas) ->
    (stacked_state, diag with per-chain (C,) entries).

    The Gibbs move order and conditionals are identical to
    models/sweep.py make_gibbs_sweep — per lane, per chain. Not supported
    here: the Gaussian cached-Gram fast path and sharded meshes (callers
    fall back to sequential chains).
    """
    def sweep(key, st: GLMState, datas: tuple):
        k_pg, k_w, k_aux, k_net = jax.random.split(key, 4)
        # ---- pack C chains onto postsyn lanes ---------------------------
        w_lane = _to_lanes(jax.vmap(pack_weights)(st.A, st.W, st.b))
        hyp_c = jax.vmap(network.edge_hypers)(st.net)
        hyp = EdgeHypers(
            mu=_to_lanes(hyp_c.mu), Lam=_to_lanes(hyp_c.Lam),
            logit_rho=_to_lanes(hyp_c.logit_rho),
            mu_b=hyp_c.mu_b.reshape(-1), lam_b=hyp_c.lam_b.reshape(-1))
        aux_lane = jax.tree.map(
            lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:]),
            st.aux)

        Y_cat = jnp.concatenate([d.Y for d in datas], axis=0)
        Y_lane = jnp.tile(Y_cat, (1, C))
        Xf_cat = jnp.concatenate([d.Xf for d in datas], axis=0)
        T = Y_cat.shape[0]

        psi = einsum_at("tp,pn->tn", Xf_cat, w_lane, precision)
        omega, kappa = obs.omega_kappa(k_pg, Y_lane, psi, aux_lane)

        if spike_slab:
            Xt_cat = (jnp.concatenate([d.Xt for d in datas], axis=1)
                      if all(d.Xt is not None for d in datas) else None)
            A_lane, w_lane, u, _ = resample_spike_slab_tspace(
                k_w, Xf_cat, omega, kappa, w_lane, hyp, B,
                t_chunk=t_chunk, precision=precision, psi=psi, Xt=Xt_cat)
            psi_cat = (kappa - u) / omega
        else:
            J, h = sufficient_stats(Xf_cat, omega, kappa, t_chunk=t_chunk,
                                    precision=precision)
            w_lane = resample_dense(k_w, J, h, hyp, B)
            A_lane = jnp.ones((N, C * N), jnp.float32)
            psi_cat = einsum_at("tp,pn->tn", Xf_cat, w_lane, precision)

        # ---- unstack to per-chain structure -----------------------------
        w_c = _from_lanes(w_lane, C)                       # (C, P, N)
        W, b = jax.vmap(unpack_weights, in_axes=(0, None, None))(w_c, N, B)
        A = _from_lanes(A_lane, C)                         # (C, N, N)

        aux_lane = obs.resample_aux(k_aux, aux_lane, Y_lane, psi_cat)
        aux = jax.tree.map(lambda xl, xs: xl.reshape(xs.shape),
                           aux_lane, st.aux)
        net = jax.vmap(network.resample)(
            jax.random.split(k_net, C), st.net, A, W)

        ll_el = obs.log_likelihood(Y_lane, psi_cat, aux_lane)
        lls = ll_el.reshape(T, C, N).sum(axis=(0, 2))
        diag = {"log_likelihood": lls, "n_edges": A.sum(axis=(1, 2))}
        if hasattr(net, "hmc_accept"):
            diag["hmc_accept"] = net.hmc_accept
        return GLMState(A, W, b, aux, net), diag

    return sweep


def make_stacked_sweep_sharded(obs, network, N: int, B: int, C: int,
                               mesh, spike_slab: bool, t_chunk: int = 512,
                               precision: str = "highest"):
    """Chain-axis DATA PARALLELISM: the C-chain stacked sweep sharded over
    a 1-D ('chain',) device mesh (parallel.sharding.make_chain_mesh).

    Each of the M mesh devices runs the ordinary lane-stacked sweep for its
    C/M chains on a REPLICATED copy of the data — chains are independent,
    so the Gibbs pass needs ZERO collectives (the embarrassingly-parallel
    MCMC axis; contrast the ('time','neuron') mesh, whose sufficient stats
    psum across devices). RNG: the driver key is folded with the
    device's chain-axis index, then the local sweep splits it as usual —
    chains on different devices draw from disjoint counter streams.

    Reference analog: none — the reference's multi-chain story is one OS
    process per chain (SURVEY.md §3.5); here M devices give M× aggregate
    chain throughput with one compiled program.
    """
    from jax.sharding import PartitionSpec as P

    M = mesh.shape["chain"]
    assert C % M == 0, (
        f"n_chains={C} must be divisible by the chain mesh size {M}")
    local = make_stacked_sweep(obs, network, N, B, C // M, spike_slab,
                               t_chunk=t_chunk, precision=precision)
    chain_sp = P("chain")

    def body(key, st, datas):
        k = jax.random.fold_in(key, jax.lax.axis_index("chain"))
        return local(k, st, datas)

    def sweep(key, st, datas):
        state_sp = jax.tree.map(lambda _: chain_sp, st)
        data_sp = jax.tree.map(lambda _: P(), datas)
        diag_sp = {"log_likelihood": chain_sp, "n_edges": chain_sp}
        if hasattr(st.net, "hmc_accept"):
            diag_sp["hmc_accept"] = chain_sp
        # check_vma=False: the PG samplers' masked while_loops mix
        # replicated and shard-varying carries (same note as
        # ops/polyagamma._shard_map_elementwise).
        return jax.shard_map(
            body, mesh=mesh, in_specs=(P(), state_sp, data_sp),
            out_specs=(state_sp, diag_sp), check_vma=False)(key, st, datas)

    return sweep


def make_stacked_sweep_gspmd(obs, network, N: int, B: int, C: int,
                             mesh, spike_slab: bool, t_chunk: int = 512,
                             precision: str = "highest"):
    """CHAIN x DATA composed parallelism: the C-chain stacked sweep under a
    3-D ('chain','time','neuron') mesh (parallel.sharding.
    make_chain_data_mesh) — the one parallelism composition the 1-D chain
    mesh cannot express (VERDICT r4 missing #3): chains/rungs spread over
    device groups AND each group runs the neuron/time-sharded data-parallel
    sweep, so a big sharded model (config-5's N=500) still gets the
    ensemble/ladder machinery.

    How it works: the stacked sweep is already "one wide model" — C chains
    ARE C*N postsyn lanes sharing one design (module docstring), and every
    lane pass (PG draws, Gram blocks, the fused collapsed spike-and-slab
    update) is lane-agnostic. So the composed path is the ORDINARY stacked
    sweep traced with the 3-D mesh as the active sharding context: the
    kernel dispatchers (ops/polyagamma.py, models/weights.py) wrap their
    shard_maps with the lane axis partitioned jointly over
    ('chain','neuron') and psum their stats over 'time', exactly as the
    2-D data mesh does with lanes = neurons. The per-chain couplings
    (network prior, observation aux, the (C,) log-likelihoods) happen
    OUTSIDE the lane kernels on small arrays; GSPMD lays them out along
    the chain axis. Requires C % n_chain == 0, N % n_neuron == 0, and
    every dataset's T % n_time == 0.

    Reference analog: none — this composes two capabilities the reference
    lacks (SURVEY.md §2.4 DP/SP rows, §3.5).
    """
    from pyglm_tpu.parallel.sharding import active_mesh, set_active_mesh

    n_chain = mesh.shape.get("chain", 1)
    n_neuron = mesh.shape.get("neuron", 1)
    assert C % n_chain == 0, (
        f"n_chains={C} must be divisible by the chain mesh axis {n_chain}")
    assert N % n_neuron == 0, (
        f"N={N} must be divisible by the neuron mesh axis {n_neuron}")
    inner = make_stacked_sweep(obs, network, N, B, C, spike_slab,
                               t_chunk=t_chunk, precision=precision)

    def sweep(key, st, datas):
        # Scoped trace-time context (same discipline as
        # parallel.sharding.make_sharded_sweep): the kernel dispatchers
        # consult the active mesh while the sweep traces.
        prev = active_mesh()
        set_active_mesh(mesh)
        try:
            return inner(key, st, datas)
        finally:
            set_active_mesh(prev)

    return sweep


def chain_data_shardings(mesh, st, datas):
    """NamedShardings placing a stacked (C-leading) state and the shared
    datasets on a composed chain-data mesh: chain-indexed state axes over
    'chain' (postsyn over 'neuron' where present), time-major data over
    'time'. Placement is an efficiency hint — the kernels' shard_maps
    enforce their own specs — but putting buffers where they will be used
    avoids an all-to-all on the first sweep."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    state_sh = GLMState(
        A=ns("chain", None, "neuron"),       # (C, N_pre, N_post)
        W=ns("chain", None, "neuron", None),
        b=ns("chain", "neuron"),
        aux=jax.tree.map(lambda _: ns("chain"), st.aux),
        net=jax.tree.map(lambda _: ns("chain"), st.net),
    )
    n_time = mesh.shape.get("time", 1)

    def data_sh(d):
        t_ok = int(d.Y.shape[0]) % n_time == 0
        t_sp = "time" if t_ok else None
        return type(d)(
            Y=ns(t_sp, None), Xf=ns(t_sp, None),
            Xt=None if d.Xt is None else ns(None, t_sp),
            Gg0=None if d.Gg0 is None else ns(),
            Gfull=None if d.Gfull is None else ns(),
            XtY=None if d.XtY is None else ns(),
            llc=None if d.llc is None else jax.tree.map(lambda _: ns(),
                                                        d.llc))
    return state_sh, tuple(data_sh(d) for d in datas)


def run_stacked_chains(model, n_chains: int, n_samples: int,
                       n_burnin: int = 0, thin: int = 1, seeds=None,
                       max_sweeps_per_launch: int | None = None, mesh=None,
                       collect: str = "samples"):
    """Run C prior-initialized chains with the lane-stacked sweep.

    With ``collect="samples"`` (default) returns a list of C per-chain
    dicts {'A' (S,N,N), 'W' (S,N,N,B), 'bias' (S,N), 'lls' (S,)} — the
    same contract as model.fit_compiled, so
    NonlinearAutoregressiveModel.fit_ensemble can assemble R-hat
    identically for both execution paths. Chain c is seeded exactly like
    the sequential path (fold_in(key(seed_c), 0x5EED) then a prior init),
    so the two paths draw from the same initialization distribution.

    With ``collect="mean"`` the post-burn-in sweeps are NOT materialized:
    per-chain posterior means of A and W_effective accumulate in the scan
    carry (O(state) device memory) and the return value is one dict
    {'A_mean' (C,N,N), 'Weff_mean' (C,N,N), 'lls' (S,C) float32,
    'final_states': list of C GLMState}. This is the estimator mode for
    big models — at N=500, C=8 the sample stacks fit_ensemble would
    otherwise host-stage run to tens of GB. ``thin`` is ignored (every
    post-burn-in sweep contributes to the mean).

    With ``mesh`` (a ('chain',) mesh from make_chain_mesh) the stacked
    sweep is sharded chain-major across devices: each device sweeps
    C/M chains locally on replicated data (make_stacked_sweep_sharded).
    """
    assert collect in ("samples", "mean"), collect
    assert model.datas, "call add_data() or generate(keep=True) first"
    C = n_chains
    if seeds is None:
        seeds = range(1, C + 1)
    seeds = list(seeds)
    assert len(seeds) == C

    states, keys = [], []
    for sd in seeds:
        kc = jax.random.fold_in(jax.random.key(int(sd)), 0x5EED)
        kc, k_init = jax.random.split(kc)
        states.append(init_state_from_prior(
            k_init, model.observation, model.network, model.N, model.B,
            model.spike_and_slab))
        keys.append(kc)
    st = stack_states(states)
    key = jax.random.fold_in(keys[0], 0xC8A1)   # one driver stream

    datas = tuple(model.datas)
    if mesh is not None and set(mesh.shape) & {"time", "neuron"}:
        # Composed chain-data mesh: GSPMD stacked sweep with the lane
        # kernels' shard_maps partitioned over ('chain','neuron') lanes.
        sweep = make_stacked_sweep_gspmd(
            model.observation, model.network, model.N, model.B, C,
            mesh, model.spike_and_slab, t_chunk=model._t_chunk,
            precision=model._precision)
        state_sh, data_sh = chain_data_shardings(mesh, st, datas)
        st = jax.device_put(st, state_sh)
        datas = jax.device_put(datas, data_sh)
    elif mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        sweep = make_stacked_sweep_sharded(
            model.observation, model.network, model.N, model.B, C,
            mesh, model.spike_and_slab, t_chunk=model._t_chunk,
            precision=model._precision)
        # Place the chain axis across devices and replicate the data up
        # front, so the first jit does not start with an implicit reshard.
        st = jax.device_put(
            st, jax.tree.map(lambda _: NamedSharding(mesh, P("chain")), st))
        datas = jax.device_put(
            datas, jax.tree.map(lambda _: NamedSharding(mesh, P()), datas))
    else:
        sweep = make_stacked_sweep(
            model.observation, model.network, model.N, model.B, C,
            model.spike_and_slab, t_chunk=model._t_chunk,
            precision=model._precision)
    # One launch scans `cap` sweeps and, in collect="samples", holds their
    # samples on the device until the segment ends: C stacked chains hold
    # C x the single-chain sample block, so the auto default divides the
    # single-chain 250-sweep segment by C to keep that block bounded.
    cap = max(1, (250 // C) if max_sweeps_per_launch is None
              else max_sweeps_per_launch)
    if thin > cap:
        raise ValueError(f"thin={thin} exceeds max_sweeps_per_launch={cap}")

    def burn_seg(key, st, datas, length):
        def step(s, k):
            s, _ = sweep(k, s, datas)
            return s, None
        return jax.lax.scan(step, st, jax.random.split(key, length))[0]

    def sample_seg(key, st, datas, length):
        def one(s, k):
            ks = jax.random.split(k, thin)
            s, diags = jax.lax.scan(
                lambda ss, kk: sweep(kk, ss, datas), s, ks)
            # inner-scan lls: (thin, C) -> keep the last sweep's (C,)
            return s, (s.A, s.W, s.b, diags["log_likelihood"][-1])
        return jax.lax.scan(one, st, jax.random.split(key, length))

    def mean_seg(key, st, datas, accA, accW, length):
        def step(carry, k):
            s, aA, aW = carry
            # same key derivation as sample_seg at thin=1, so
            # collect="mean" reproduces collect="samples" means EXACTLY
            # (tests/test_ensemble.py cross-checks bit-level)
            s, diag = sweep(jax.random.split(k, 1)[0], s, datas)
            weff = jnp.sum(s.A[..., None] * s.W, axis=-1)   # (C, N, N)
            return (s, aA + s.A, aW + weff), diag["log_likelihood"]
        (st, accA, accW), lls = jax.lax.scan(
            step, (st, accA, accW), jax.random.split(key, length))
        return st, accA, accW, lls                          # lls (len, C)

    burn_j = jax.jit(burn_seg, static_argnames=("length",))
    sample_j = jax.jit(sample_seg, static_argnames=("length",))
    mean_j = jax.jit(mean_seg, static_argnames=("length",))

    left = n_burnin
    while left > 0:
        c = min(left, cap)
        key, k = jax.random.split(key)
        st = burn_j(k, st, datas, length=c)
        left -= c

    if collect == "mean":
        accA = jnp.zeros_like(st.A)     # (C, N, N), inherits st's sharding
        accW = jnp.zeros_like(st.A)
        lls_out = []
        left = n_samples
        while left > 0:
            c = min(left, cap)
            key, k = jax.random.split(key)
            st, accA, accW, lls = mean_j(k, st, datas, accA, accW, length=c)
            lls_out.append(np.asarray(lls))
            left -= c
        return {"A_mean": np.asarray(accA) / n_samples,
                "Weff_mean": np.asarray(accW) / n_samples,
                "lls": np.concatenate(lls_out, axis=0),     # (S, C)
                "final_states": unstack_states(st, C)}

    out = {"A": [], "W": [], "bias": [], "lls": []}
    left = n_samples
    while left > 0:
        c = min(left, max(1, cap // max(1, thin)))
        key, k = jax.random.split(key)
        st, (A, W, b, lls) = sample_j(k, st, datas, length=c)
        out["A"].append(np.asarray(A))          # (S_seg, C, N, N)
        out["W"].append(np.asarray(W))
        out["bias"].append(np.asarray(b))
        out["lls"].append(np.asarray(lls))      # (S_seg, C)
        left -= c
    stacked = {k: np.concatenate(v, axis=0) for k, v in out.items()}
    return [{k: stacked[k][:, c] for k in stacked} for c in range(C)]
