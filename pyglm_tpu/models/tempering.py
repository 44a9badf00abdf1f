"""Parallel tempering on the lane-stacked ensemble machinery.

A temperature ladder beta_1 < ... < beta_C = 1 runs as ONE lane-stacked
sweep (models/ensemble.py): chain c sweeps the POWER posterior

    pi_c(theta) ∝ p(theta) * L(theta)^{beta_c},

which stays exactly in the PG-conjugate family for EVERY observation
layer here: the power scales the PG shape and kappa linearly (Bernoulli
omega ~ PG(beta, psi), kappa = beta*(y-1/2); Binomial b -> beta*n; NB
b -> beta*(y+r) at fixed r) and scales the Gaussian precision (beta/eta
at fixed eta) — see observations.tempered_omega_kappa. The collapsed
spike-and-slab machinery is unchanged per lane and the cold chain
(beta = 1) is the standard exact sampler. Likelihood-side auxiliaries
(NB r, Gaussian eta) must be fixed: their conjugate updates assume the
untempered likelihood (obs.tempering_blocker gates this). Between sweeps, adjacent rungs
exchange their ENTIRE parameter state (A, W, b, aux, network state) by a
Metropolis swap on the joint density: swapping theta_i <-> theta_j is
accepted with probability

    min(1, exp((beta_j - beta_i) * (ll_i - ll_j))),

where ll is the UNTEMPERED data log-likelihood (the shared prior cancels;
the PG auxiliaries are not part of the carried state — they are redrawn
from their conditional at the top of every sweep, so the swap operates on
the marginal power posteriors, which is exactly valid). Even/odd adjacent
pairs alternate by a random parity bit (a random mixture of valid kernels).

Swap-acceptance feasibility: adjacent-rung acceptance is governed by the
posterior fluctuation scale of ll — roughly Phi(-|d_beta| * sd(ll)) — so a
ladder with |d_beta| >> 1/sd(ll) freezes. sd(ll) grows like sqrt(d_eff/2)
with the effective parameter count; `suggest_ladder` builds a geometric
ladder from a measured sd(ll). See BASELINE.md config-5 for the measured
verdict on this model family.

Reference analog: none — pyglm has no tempering or multi-chain machinery
(SURVEY.md §3.5); this rides the lane-stacked ensemble, where the
marginal cost of a rung is its omega/u lanes only.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pyglm_tpu.models.ensemble import _from_lanes, _to_lanes, stack_states
from pyglm_tpu.models.sweep import GLMState, init_state_from_prior
from pyglm_tpu.models.weights import (EdgeHypers, einsum_at, pack_weights,
                                      resample_spike_slab_tspace,
                                      sufficient_stats, unpack_weights)


def swap_permutation(key, lls, betas):
    """One even/odd round of adjacent-rung Metropolis swaps.

    Args:
      lls: (C,) UNTEMPERED data log-likelihood of each chain's current state.
      betas: (C,) ascending inverse temperatures.
    Returns (perm (C,) int32 — apply as tree.map(lambda x: x[perm], state),
    accept (C,) float32 — 1 where the rung swapped, parity ()).
    """
    C = betas.shape[0]
    kp, ka = jax.random.split(key)
    parity = jax.random.bernoulli(kp, 0.5).astype(jnp.int32)
    i = jnp.arange(C)
    is_left = ((i - parity) % 2) == 0
    partner = jnp.where(is_left, i + 1, i - 1)
    valid = (partner >= 0) & (partner < C)
    partner = jnp.clip(partner, 0, C - 1)
    # log alpha = (beta_p - beta_i)(ll_i - ll_p): symmetric under i <-> p,
    # so both pair members compute the same value.
    log_alpha = (betas[partner] - betas[i]) * (lls[i] - lls[partner])
    # one uniform per PAIR (keyed by the pair's lower index)
    us = jax.random.uniform(ka, (C,))
    u_pair = us[jnp.minimum(i, partner)]
    accept = valid & (jnp.log(u_pair) < log_alpha)
    perm = jnp.where(accept, partner, i)
    return perm, accept.astype(jnp.float32), parity


def suggest_ladder(sd_ll, C, accept=0.3, beta_max=1.0, beta_floor=0.05):
    """Uniform-Δβ ladder sized so adjacent swaps accept at roughly
    `accept`, given the measured posterior standard deviation of the
    untempered log-likelihood.

    Adjacent acceptance ~ E min(1, e^{dbeta * dll}) with dll ~ N(0-ish,
    ~2 sd_ll^2) between independent rungs, giving accept ~
    erfc(dbeta * sd_ll / 2); invert for dbeta. Returns (betas (C,),
    feasible_span = dbeta * (C-1)) — if feasible_span < the range you
    wanted to cover, PT cannot both accept and span at this C.

    When sd_ll is small (a few nats — tiny datasets), the acceptance-
    targeted Δβ can push β_1 to zero or below, where the power posterior
    degenerates (PG(0, ψ) gives ω = 0 and the ψ recovery divides by it).
    The ladder is then clamped to span [beta_floor, beta_max] — every
    rung stays a proper posterior and adjacent acceptance comes out
    HIGHER than requested, which is harmless — with a warning that the
    requested accept/C pair was infeasible.
    """
    from scipy.special import erfcinv
    dbeta = 2.0 * erfcinv(accept) / max(float(sd_ll), 1e-12)
    if dbeta * (C - 1) > beta_max - beta_floor:
        import warnings
        dbeta_c = (beta_max - beta_floor) / max(C - 1, 1)
        warnings.warn(
            f"suggest_ladder: the acceptance-targeted rung gap "
            f"dbeta={dbeta:.4g} would drive beta_1 to "
            f"{beta_max - dbeta * (C - 1):.4g} <= 0-ish at C={C}; "
            f"clamping the ladder to [{beta_floor}, {beta_max}] "
            f"(gap {dbeta_c:.4g}, adjacent acceptance above the requested "
            f"{accept})", stacklevel=2)
        dbeta = dbeta_c
    betas = beta_max - dbeta * np.arange(C - 1, -1, -1)
    return np.asarray(betas, np.float64), float(dbeta * (C - 1))


def _make_tempered_pass(obs, network, N: int, B: int, C: int,
                        spike_slab: bool, t_chunk: int, precision: str):
    """The within-rung tempered Gibbs pass for C rungs (no swaps):
    (k_pg, k_w, k_net, st (C,...), datas, betas (C,)) ->
    (new_st, lls (C,), n_edges (C,)). Factored out so the single-device
    sweep and the chain-mesh shard_map body (make_tempered_sweep_sharded,
    where C is the per-device rung count) share one implementation."""
    def gibbs(k_pg, k_w, k_net, st: GLMState, datas: tuple, betas):
        beta_lane = jnp.repeat(betas, N)        # (C*N,)
        w_lane = _to_lanes(jax.vmap(pack_weights)(st.A, st.W, st.b))
        hyp_c = jax.vmap(network.edge_hypers)(st.net)
        hyp = EdgeHypers(
            mu=_to_lanes(hyp_c.mu), Lam=_to_lanes(hyp_c.Lam),
            logit_rho=_to_lanes(hyp_c.logit_rho),
            mu_b=hyp_c.mu_b.reshape(-1), lam_b=hyp_c.lam_b.reshape(-1))

        Y_cat = jnp.concatenate([d.Y for d in datas], axis=0)
        Y_lane = jnp.tile(Y_cat, (1, C))
        Xf_cat = jnp.concatenate([d.Xf for d in datas], axis=0)
        T = Y_cat.shape[0]

        psi = einsum_at("tp,pn->tn", Xf_cat, w_lane, precision)
        aux_lane = jax.tree.map(
            lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:]),
            st.aux)
        # tempered auxiliaries targeting L^beta per lane, e.g. Bernoulli:
        # omega ~ PG(beta, psi), kappa = beta*(y - 1/2)
        omega, kappa = obs.tempered_omega_kappa(
            k_pg, Y_lane, psi, aux_lane, beta_lane)

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
            from pyglm_tpu.models.weights import resample_dense
            w_lane = resample_dense(k_w, J, h, hyp, B)
            A_lane = jnp.ones((N, C * N), jnp.float32)
            psi_cat = einsum_at("tp,pn->tn", Xf_cat, w_lane, precision)

        w_c = _from_lanes(w_lane, C)
        W, b = jax.vmap(unpack_weights, in_axes=(0, None, None))(w_c, N, B)
        A = _from_lanes(A_lane, C)
        net = jax.vmap(network.resample)(
            jax.random.split(k_net, C), st.net, A, W)
        new_st = GLMState(A, W, b, st.aux, net)

        # UNTEMPERED log-likelihood per chain (psi under the new weights);
        # theta-independent normalizers are constant across rungs, so any
        # family's log_likelihood works in the swap ratio as-is.
        ll_el = obs.log_likelihood(Y_lane, psi_cat, aux_lane)
        lls = ll_el.reshape(T, C, N).sum(axis=(0, 2))
        return new_st, lls, A.sum(axis=(1, 2))

    return gibbs


def make_tempered_sweep(obs, network, N: int, B: int, betas,
                        spike_slab: bool = True, t_chunk: int = 512,
                        precision: str = "high"):
    """Build the C-rung parallel-tempering sweep: (key, stacked_state,
    datas) -> (stacked_state, diag). Chain c targets the beta_c-power
    posterior; rung C-1 (beta=1) is the exact cold chain. Supported for
    every observation family whose beta-power likelihood stays in the
    PG-conjugate form with fixed likelihood auxiliaries — Bernoulli and
    Binomial always; NegativeBinomial/Gaussian with resample_r/
    resample_eta off (obs.tempering_blocker explains refusals)."""
    blocker = obs.tempering_blocker()
    assert blocker is None, blocker
    betas = jnp.asarray(betas, jnp.float32)
    C = betas.shape[0]
    gibbs = _make_tempered_pass(obs, network, N, B, C, spike_slab,
                                t_chunk, precision)

    def sweep(key, st: GLMState, datas: tuple):
        k_pg, k_w, k_net, k_swap = jax.random.split(key, 4)
        new_st, lls, n_edges = gibbs(k_pg, k_w, k_net, st, datas, betas)

        # -- replica exchange: permute theta between rungs ----------------
        perm, accept, parity = swap_permutation(k_swap, lls, betas)
        new_st = jax.tree.map(lambda x: x[perm], new_st)
        diag = {"log_likelihood": lls[perm], "n_edges": n_edges,
                "swap_accept": accept, "swap_parity": parity}
        if hasattr(new_st.net, "hmc_accept"):
            diag["hmc_accept"] = new_st.net.hmc_accept
        return new_st, diag

    return sweep


def make_tempered_sweep_sharded(obs, network, N: int, B: int, betas, mesh,
                                spike_slab: bool = True, t_chunk: int = 512,
                                precision: str = "high"):
    """The C-rung tempering sweep with rungs spread over a ('chain',) mesh
    (parallel.sharding.make_chain_mesh): each device runs the tempered
    Gibbs pass for its C/M rungs on replicated data, then the rungs'
    untempered log-likelihoods (C scalars) are gathered for the swap and
    the accepted permutation moves whole states between devices — the only
    cross-device traffic a tempering sweep needs, so a whole temperature
    ladder costs ~1 rung of wall time on an M=C slice. Same conditionals
    and swap rule as make_tempered_sweep; RNG streams are folded per
    device. Reference analog: none (SURVEY.md §3.5)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    blocker = obs.tempering_blocker()
    assert blocker is None, blocker
    betas = jnp.asarray(betas, jnp.float32)
    C = betas.shape[0]
    M = mesh.shape["chain"]
    assert C % M == 0, (
        f"n_rungs={C} must be divisible by the chain mesh size {M}")
    gibbs = _make_tempered_pass(obs, network, N, B, C // M, spike_slab,
                                t_chunk, precision)
    chain_sp = P("chain")

    def body(k_pg, k_w, k_net, st, datas, betas_local):
        idx = jax.lax.axis_index("chain")
        return gibbs(jax.random.fold_in(k_pg, idx),
                     jax.random.fold_in(k_w, idx),
                     jax.random.fold_in(k_net, idx),
                     st, datas, betas_local)

    def sweep(key, st: GLMState, datas: tuple):
        k_pg, k_w, k_net, k_swap = jax.random.split(key, 4)
        state_sp = jax.tree.map(lambda _: chain_sp, st)
        data_sp = jax.tree.map(lambda _: P(), datas)
        # check_vma=False: same masked-while carry note as the ensemble's
        # make_stacked_sweep_sharded.
        new_st, lls, n_edges = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(), state_sp, data_sp, chain_sp),
            out_specs=(state_sp, chain_sp, chain_sp),
            check_vma=False)(k_pg, k_w, k_net, st, datas, betas)

        # Swap on the gathered (C,) lls; x[perm] on the chain-sharded
        # state is the cross-device exchange — GSPMD lowers it to the
        # needed collective, and the constraint pins the result back to
        # one-rung-group-per-device for the next sweep.
        perm, accept, parity = swap_permutation(k_swap, lls, betas)
        csh = NamedSharding(mesh, chain_sp)
        new_st = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x[perm], csh),
            new_st)
        diag = {"log_likelihood": lls[perm], "n_edges": n_edges,
                "swap_accept": accept, "swap_parity": parity}
        if hasattr(new_st.net, "hmc_accept"):
            diag["hmc_accept"] = new_st.net.hmc_accept
        return new_st, diag

    return sweep


def make_tempered_sweep_gspmd(obs, network, N: int, B: int, betas, mesh,
                              spike_slab: bool = True, t_chunk: int = 512,
                              precision: str = "high"):
    """The C-rung tempering sweep under a composed 3-D
    ('chain','time','neuron') mesh (parallel.sharding.make_chain_data_mesh):
    rungs spread over chain groups AND each rung's Gibbs pass runs
    neuron/time-sharded — the ladder on a SHARDED model (VERDICT r4
    missing #3). Same mechanism as ensemble.make_stacked_sweep_gspmd: the
    tempered pass is lane-parallel over the C*N rung-stacked postsyn
    lanes, so it traces with the 3-D mesh as the active context and the
    kernel dispatchers partition lanes over ('chain','neuron') / psum
    stats over 'time'. The swap gathers the (C,) untempered lls and the
    accepted permutation moves rung states between chain groups — GSPMD
    lowers x[perm] to the needed collective. Same conditionals and swap
    rule as make_tempered_sweep. Reference analog: none (SURVEY.md §3.5).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pyglm_tpu.parallel.sharding import active_mesh, set_active_mesh

    blocker = obs.tempering_blocker()
    assert blocker is None, blocker
    betas = jnp.asarray(betas, jnp.float32)
    C = betas.shape[0]
    n_chain = mesh.shape.get("chain", 1)
    assert C % n_chain == 0, (
        f"n_rungs={C} must be divisible by the chain mesh axis {n_chain}")
    assert N % mesh.shape.get("neuron", 1) == 0, (
        f"N={N} must be divisible by the neuron mesh axis "
        f"{mesh.shape.get('neuron', 1)}")
    gibbs = _make_tempered_pass(obs, network, N, B, C, spike_slab,
                                t_chunk, precision)
    csh = NamedSharding(mesh, P("chain"))

    def sweep(key, st: GLMState, datas: tuple):
        k_pg, k_w, k_net, k_swap = jax.random.split(key, 4)
        prev = active_mesh()
        set_active_mesh(mesh)
        try:
            new_st, lls, n_edges = gibbs(k_pg, k_w, k_net, st, datas, betas)
        finally:
            set_active_mesh(prev)
        perm, accept, parity = swap_permutation(k_swap, lls, betas)
        new_st = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x[perm], csh),
            new_st)
        diag = {"log_likelihood": lls[perm], "n_edges": n_edges,
                "swap_accept": accept, "swap_parity": parity}
        if hasattr(new_st.net, "hmc_accept"):
            diag["hmc_accept"] = new_st.net.hmc_accept
        return new_st, diag

    return sweep


def init_tempered_states(model, betas, seeds=None):
    """C prior-initialized chain states stacked on a chain axis, seeded like
    run_stacked_chains so rung trajectories are reproducible."""
    C = len(betas)
    if seeds is None:
        seeds = range(1, C + 1)
    states = []
    for sd in seeds:
        kc = jax.random.fold_in(jax.random.key(int(sd)), 0x5EED)
        _, k_init = jax.random.split(kc)
        states.append(init_state_from_prior(
            k_init, model.observation, model.network, model.N, model.B,
            model.spike_and_slab))
    return stack_states(states)
