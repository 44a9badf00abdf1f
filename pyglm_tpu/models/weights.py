"""Sufficient statistics + conditionally-Gaussian weight updates.

The reference forms per-neuron sufficient statistics X' Omega X with NumPy
loops (pyglm/regressions.py: _lkhd_sufficient_statistics, _resample_A_W).
Here the stats for *all* neurons are one chunked batched matmul, and the
per-neuron updates are batched under vmap:

- dense weights: batched P-dim information-form Gaussian draws;
- spike-and-slab: collapsed Gibbs over incoming edges. The per-edge scan is
  inherently sequential (each a_j conditions on the others), but all N
  postsynaptic neurons run in parallel (vmap) and the scan consumes the
  precomputed Gram matrix via rank-B residual updates instead of reforming
  X' Omega X per edge like the reference.

Weight layout: P = N*B + 1 design columns, presyn-major
(column j*B + b = presyn neuron j, basis b; last column = bias).
w_full[:, n] stacks A[j,n] * W[j,n,:] for all j, then b[n].
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pyglm_tpu.ops.linalg import (
    chol_small, gaussian_evidence, sample_from_evidence, sample_mvn_info,
    solve_lower_small, solve_lower_t_small,
)
from pyglm_tpu.utils.utils import logistic

# Model precision mode -> `precision=` of the sweep's large f32 matmuls
# (psi = Xf w and the Gram statistics). Each mode names a dot algorithm, so
# it means the same on every backend; lax.Precision.HIGH would lower to
# TF32 on a GPU, the same as DEFAULT.
_PRECISIONS = {
    # the backend's fastest f32 dot: TF32 (~1e-3 relative) on an H100
    "default": lax.Precision.DEFAULT,
    # f32-grade: three bf16 products with f32 accumulation (~1e-6 relative)
    "high": lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    # full f32
    "highest": lax.Precision.HIGHEST,
}

# The small contractions of the collapsed edge scan feed the acceptance
# odds of every edge; they always run in full f32.
_F32 = lax.Precision.HIGHEST


def dot_precision(precision: str):
    """The `precision=` argument the sweep's matmuls use for a model
    precision mode ('default' | 'high' | 'highest')."""
    if precision == "sr":
        raise ValueError(
            "precision='sr' (stochastically rounded bf16 statistics) has "
            "been removed: it existed only inside a hand-written kernel for "
            "the library's first accelerator. Use 'high' (f32-grade, the "
            "default) or 'default' (TF32 on a GPU)")
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{sorted(_PRECISIONS)}")
    return _PRECISIONS[precision]


def _einsum_precision(spec: str, x_shape, y_shape, precision: str):
    """The `precision=` of einsum(spec) at a model precision mode. A dot
    with a free (non-batch, non-contracted) dimension of 1 is a
    matrix-vector product; XLA's CPU backend emits such a dot elementwise
    when it fuses it, and that emitter has no three-pass algorithm, so it
    runs in full f32, which at its size is as cheap."""
    prec = dot_precision(precision)
    ins, out = spec.split("->")
    xs, ys = ins.split(",")
    size = dict(zip(xs, x_shape)) | dict(zip(ys, y_shape))
    if any(size[c] == 1 for c in out if not (c in xs and c in ys)):
        return _F32
    return prec


def einsum_at(spec: str, x, y, precision: str):
    """einsum(spec, x, y) with f32 accumulation at a model precision mode
    ('default' | 'high' | 'highest'): the sweep's large matmuls."""
    return jnp.einsum(
        spec, x, y, preferred_element_type=jnp.float32,
        precision=_einsum_precision(spec, x.shape, y.shape, precision))


# Which spike-and-slab implementation the most recent _tspace_impl TRACE
# selected ("staged" | "mesh_fused"). Set at trace time, so it reflects the
# path baked into the compiled sweep — tests use it to assert the mesh path
# actually engaged (a silent fallback would otherwise go unnoticed).
LAST_SS_PATH = None


class EdgeHypers(NamedTuple):
    """Per-edge prior parameters handed from the network layer to the weight
    layer — the functional analog of the reference's network->regression
    hyperparameter injection (pyglm/networks.py -> regressions resample)."""
    mu: jax.Array          # (N, N, B)   prior mean of W[pre, post]
    Lam: jax.Array         # (N, N, B, B) prior precision
    logit_rho: jax.Array   # (N, N)      prior log-odds of A[pre, post]
    mu_b: jax.Array        # (N,)        bias prior mean
    lam_b: jax.Array       # (N,)        bias prior precision


def pack_weights(A, W, b):
    """(A, W, b) -> w_full (P, N) in the design-column layout."""
    N, _, B = W.shape
    # (N_pre, N_post, B) -> (N_pre*B, N_post): presyn-major rows.
    w = (A[:, :, None] * W).transpose(0, 2, 1).reshape(N * B, N)
    return jnp.concatenate([w, b[None, :]], axis=0)


def unpack_weights(w_full, N: int, B: int):
    """w_full (P, N) -> (W_eff (N,N,B), b (N,)) (W_eff already masked by A)."""
    W = w_full[: N * B].reshape(N, B, N).transpose(0, 2, 1)
    b = w_full[N * B]
    return W, b


@partial(jax.jit, static_argnames=("t_chunk", "precision"))
def sufficient_stats(Xf, omega, kappa, t_chunk: int = 512,
                     precision: str = "highest"):
    """J[n] = Xf' diag(omega[:, n]) Xf and h[:, n] = Xf' kappa[:, n].

    The dominant FLOPs of a sweep: O(N * T * P^2), executed as a lax.scan
    over time chunks of batched (P x tc)(tc x P) matmuls with f32
    accumulation (each chunk sums <= t_chunk terms, so f32 is safe at
    T = 100k; SURVEY.md §7 hard-part #2).

    Returns J (N, P, P), h (P, N).
    """
    T, P = Xf.shape
    N = omega.shape[1]
    n_chunks = -(-T // t_chunk)
    pad = n_chunks * t_chunk - T
    Xp = jnp.pad(Xf, ((0, pad), (0, 0)))
    Op = jnp.pad(omega, ((0, pad), (0, 0)))
    Xc = Xp.reshape(n_chunks, t_chunk, P)
    Oc = Op.reshape(n_chunks, t_chunk, N)

    def body(J, xs):
        xc, oc = xs
        xw = xc[:, None, :] * oc[:, :, None]            # (tc, N, P)
        Jc = einsum_at("tnp,tq->npq", xw, xc, precision)
        return J + Jc, None

    J0 = jnp.zeros((N, P, P), jnp.float32)
    J, _ = lax.scan(body, J0, (Xc, Oc))
    Kp = jnp.pad(kappa, ((0, pad), (0, 0)))
    h = einsum_at("tp,tn->pn", Xp, Kp, precision)
    return J, h


def _resample_bias(key, J, h, w, r_vec, mu_b, lam_b):
    """Conditional 1-D Gaussian draw for the always-active bias column."""
    m = h[-1] - (r_vec[-1] - J[-1, -1] * w[-1]) + lam_b * mu_b
    lamp = lam_b + J[-1, -1]
    bnew = m / lamp + jax.random.normal(key, ()) / jnp.sqrt(lamp)
    r_vec = r_vec + J[:, -1] * (bnew - w[-1])
    w = w.at[-1].set(bnew)
    return w, r_vec


def _spike_slab_one_neuron(key, J, h, w_init, mu0, Lam0, logit_rho,
                           mu_b, lam_b, B: int):
    """Collapsed spike-and-slab Gibbs over the N incoming edges of one neuron.

    For each presyn block j (sequential — inherent to collapsed Gibbs,
    SURVEY.md §7 hard-part #3): residualize the linear term against all other
    current weights using the running r_vec = J @ w, compute the collapsed
    Bernoulli odds for a_j, then draw w_j | a_j.

    Math (reference: pyglm/regressions.py _resample_A_W):
        m_j  = h_j - (J @ w)_j + J_jj w_j
        logodds = logit(rho_j) + 1/2 mu_p' Lp mu_p - 1/2 mu0' L0 mu0
                  + 1/2 log|L0| - 1/2 log|Lp|,   Lp = L0 + J_jj
    """
    N = logit_rho.shape[0]
    P = h.shape[0]
    C0 = chol_small(Lam0)                                # (N, B, B)
    ld0_half = jnp.sum(jnp.log(jnp.diagonal(C0, axis1=-2, axis2=-1)), axis=-1)
    r_vec = jnp.matmul(J, w_init, precision=_F32)
    keys = jax.random.split(key, N + 1)

    def body(carry, xs):
        w, r_vec = carry
        j, kj, mu0j, Lam0j, ld0j, lrho = xs
        k1, k2 = jax.random.split(kj)
        sl = j * B
        Jjj = lax.dynamic_slice(J, (sl, sl), (B, B))
        Jcol = lax.dynamic_slice(J, (0, sl), (P, B))
        hj = lax.dynamic_slice(h, (sl,), (B,))
        rj = lax.dynamic_slice(r_vec, (sl,), (B,))
        wj = lax.dynamic_slice(w, (sl,), (B,))
        mj = hj - (rj - jnp.matmul(Jjj, wj, precision=_F32))
        ev = gaussian_evidence(mj, Jjj, mu0j, Lam0j, chol0_logdet=ld0j)
        log_odds = lrho + ev.log_evidence
        a = jax.random.bernoulli(k1, logistic(log_odds))
        wnew = jnp.where(a, sample_from_evidence(k2, ev), jnp.zeros((B,)))
        r_vec = r_vec + jnp.matmul(Jcol, wnew - wj, precision=_F32)
        w = lax.dynamic_update_slice(w, wnew, (sl,))
        return (w, r_vec), a.astype(jnp.float32)

    xs = (jnp.arange(N), keys[:N], mu0, Lam0, ld0_half, logit_rho)
    (w, r_vec), a = lax.scan(body, (w_init, r_vec), xs)
    w, r_vec = _resample_bias(keys[N], J, h, w, r_vec, mu_b, lam_b)
    return a, w


@partial(jax.jit, static_argnames=("B",))
def resample_spike_slab(key, J, h, w_full, hyp: EdgeHypers, B: int):
    """Batched spike-and-slab update for all N neurons (vmap over postsyn).

    Args:
      J: (N, P, P); h: (P, N); w_full: (P, N) current packed weights.
    Returns:
      A (N_pre, N_post), w_full (P, N).
    """
    N = h.shape[1]
    keys = jax.random.split(key, N)
    # Per-postsyn-neuron views: mu[:, n], Lam[:, n], logit_rho[:, n].
    a, w = jax.vmap(
        _spike_slab_one_neuron,
        in_axes=(0, 0, 1, 1, 1, 1, 1, 0, 0, None),
    )(keys, J, h, w_full, hyp.mu, hyp.Lam, hyp.logit_rho,
      hyp.mu_b, hyp.lam_b, B)
    return a.T, w.T         # a: (post, pre) -> (pre, post); w -> (P, N)


@partial(jax.jit, static_argnames=("B", "t_chunk", "precision"))
def diag_blocks(Xf, omega, B: int, t_chunk: int = 512,
                precision: str = "highest"):
    """Jd[j, n] = X_j' diag(omega[:, n]) X_j for every (presyn j, postsyn n).

    One chunked matmul: Z[t, (j,b,c)] = X[t,jb] X[t,jc], Jd = Z' omega.
    O(N^2 T B^2) FLOPs — a factor (N B^2 / B^2) = N cheaper than the full
    Gram stack, and the only quadratic-in-basis statistic the collapsed
    spike-and-slab scan needs. Returns Jd (N_pre, N_post, B, B).
    """
    T, P = Xf.shape
    N_pre = (P - 1) // B
    N = omega.shape[1]
    n_chunks = -(-T // t_chunk)
    pad = n_chunks * t_chunk - T
    Xp = jnp.pad(Xf[:, : N_pre * B], ((0, pad), (0, 0)))
    Op = jnp.pad(omega, ((0, pad), (0, 0)))
    Xc = Xp.reshape(n_chunks, t_chunk, N_pre, B)
    Oc = Op.reshape(n_chunks, t_chunk, N)

    def body(acc, xs):
        xc, oc = xs                                   # (tc,Npre,B), (tc,N)
        Z = (xc[:, :, :, None] * xc[:, :, None, :]).reshape(
            t_chunk, N_pre * B * B)
        acc = acc + einsum_at("tz,tn->zn", Z, oc, precision)
        return acc, None

    acc0 = jnp.zeros((N_pre * B * B, N), jnp.float32)
    acc, _ = lax.scan(body, acc0, (Xc, Oc))
    return acc.reshape(N_pre, B, B, N).transpose(0, 3, 1, 2)


def _group_edge_scan(kg, Jgg, M0, wg, mu0g, Lam0g, ld0g, lrhog,
                     G: int, B: int):
    """Collapsed Gibbs over one group's G presyn blocks, vectorized over all
    postsyn neurons (the sequential-in-G heart of the spike-and-slab update,
    shared by the staged path and the mesh-sharded fused path).

    Args:
      Jgg: (N, GB, GB) within-group Gram for every postsyn neuron.
      M0, wg: (GB, N) gather stats / current group weights.
      mu0g: (G, N, B); Lam0g: (G, N, B, B); ld0g, lrhog: (G, N).
    Returns (dW (GB, N) = w_new - w_old, wg_new (GB, N), a_g (G, N)).
    """
    GB = G * B
    N = M0.shape[1]
    gkeys = jax.random.split(kg, G)

    def edge(carry_i, xs_i):
        dW, w_cur = carry_i        # (GB, N) delta vs wg, current (GB,N)
        i, ki, mu0i, Lam0i, ld0i, lrhoi = xs_i
        k1, k2 = jax.random.split(ki)
        li = i * B
        Jrow = lax.dynamic_slice(Jgg, (0, li, 0), (N, B, GB))
        Jii = lax.dynamic_slice(Jgg, (0, li, li), (N, B, B))
        wi = lax.dynamic_slice(w_cur, (li, 0), (B, N))     # (B, N)
        M0i = lax.dynamic_slice(M0, (li, 0), (B, N))
        m = (M0i.T - jnp.einsum("nbq,qn->nb", Jrow, dW, precision=_F32)
             + jnp.einsum("nbc,cn->nb", Jii, wi, precision=_F32))
        log_ev, mu_p, Cp = _batched_evidence(m, Jii, mu0i, Lam0i, ld0i)
        a = jax.random.bernoulli(k1, logistic(lrhoi + log_ev))
        eps = jax.random.normal(k2, (N, B))
        w_draw = mu_p + solve_lower_t_small(Cp, eps)
        w_new = jnp.where(a[:, None], w_draw, 0.0)         # (N, B)
        # each edge visited once per sweep: its dW row is simply new-old
        dW = lax.dynamic_update_slice(dW, w_new.T - wi, (li, 0))
        w_cur = lax.dynamic_update_slice(w_cur, w_new.T, (li, 0))
        return (dW, w_cur), a.astype(jnp.float32)

    xs_i = (jnp.arange(G), gkeys, mu0g, Lam0g, ld0g, lrhog)
    (dW, wg_new), a_g = lax.scan(
        edge, (jnp.zeros((GB, N), jnp.float32), wg), xs_i)
    return dW, wg_new, a_g


def _batched_evidence(m, Jjj, mu0, Lam0, ld0_half):
    """Vectorized collapsed evidence for one presyn block across all
    postsyn neurons: m (N,B), Jjj (N,B,B), mu0 (N,B), Lam0 (N,B,B).

    Uses the unrolled small-B factorizations (ops/linalg.py) so the whole
    per-edge step fuses into a few elementwise kernels — at B<=8 the
    batched LAPACK-style cholesky/solve launch latency would otherwise
    dominate the N_pre-step sequential scan."""
    Lp = Lam0 + Jjj
    Cp = chol_small(Lp)
    bpost = m + jnp.einsum("nbc,nc->nb", Lam0, mu0, precision=_F32)
    z = solve_lower_small(Cp, bpost)
    quad_p = 0.5 * jnp.sum(z * z, axis=-1)
    quad_0 = 0.5 * jnp.einsum("nb,nbc,nc->n", mu0, Lam0, mu0,
                              precision=_F32)
    logdet_p = jnp.sum(jnp.log(jnp.diagonal(Cp, axis1=-2, axis2=-1)), axis=-1)
    log_ev = quad_p - quad_0 + ld0_half - logdet_p
    mu_p = solve_lower_t_small(Cp, z)
    return log_ev, mu_p, Cp


@partial(jax.jit, static_argnames=("B", "G", "t_chunk", "precision"))
def group_gram_blocks(Xf, omega, B: int, G: int, t_chunk: int = 512,
                      precision: str = "highest"):
    """Within-group Gram blocks: for edge groups of G presyn neurons,
    Jg[g, n] = Xg' diag(omega[:, n]) Xg with Xg the group's (T, G*B)
    design columns. One chunked matmul; O(N^2 T B^2 G / ... ) — G x the
    diagonal-blocks cost, still ~N/G cheaper than the full Gram stack.
    Returns (n_groups, N_post, G*B, G*B).
    """
    T, P = Xf.shape
    N_pre = (P - 1) // B
    assert N_pre % G == 0
    Ng = N_pre // G
    GB = G * B
    N = omega.shape[1]
    n_chunks = -(-T // t_chunk)
    pad = n_chunks * t_chunk - T
    Xp = jnp.pad(Xf[:, : N_pre * B], ((0, pad), (0, 0)))
    Op = jnp.pad(omega, ((0, pad), (0, 0)))
    Xc = Xp.reshape(n_chunks, t_chunk, Ng, GB)
    Oc = Op.reshape(n_chunks, t_chunk, N)

    def body(acc, xs):
        xc, oc = xs                                   # (tc,Ng,GB), (tc,N)
        Z = (xc[:, :, :, None] * xc[:, :, None, :]).reshape(
            t_chunk, Ng * GB * GB)
        acc = acc + einsum_at("tz,tn->zn", Z, oc, precision)
        return acc, None

    acc0 = jnp.zeros((Ng * GB * GB, N), jnp.float32)
    acc, _ = lax.scan(body, acc0, (Xc, Oc))
    return acc.reshape(Ng, GB, GB, N).transpose(0, 3, 1, 2)


def _gram_shard_map(Xf, omega, B, G, t_chunk, precision, mesh):
    """Group Gram blocks under a mesh via jax.shard_map: each device forms
    its local time-slice Gram and the time axis psums — the stats are
    associative sums over t (SURVEY.md §2.4 seq-parallel row). The lane
    (postsyn) axis shards over 'neuron', or jointly over ('chain','neuron')
    on a composed chain-data mesh (parallel.sharding.lane_axes)."""
    from jax.sharding import PartitionSpec as P
    from pyglm_tpu.parallel.sharding import lane_axes

    def fn(xf, om):
        Jl = group_gram_blocks(xf, om, B, G, t_chunk=t_chunk,
                               precision=precision)
        return lax.psum(Jl, "time")

    lanes = lane_axes(mesh)
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P("time", None), P("time", lanes)),
        out_specs=P(None, lanes, None, None), check_vma=False)(Xf, omega)


def _ss_fused_shard_map(key, Xt, omega, kappa, psi, w_full, hyp: EdgeHypers,
                        B: int, G: int, mesh, t_chunk: int, precision: str):
    """Mesh-sharded fused spike-and-slab update.

    Runs the whole collapsed update inside ONE jax.shard_map over the
    ('time','neuron') mesh. Per group of G presyn neurons, each device runs
    a scatter+gather+Gram pass over its local time slice, then Jgg/M0 psum
    over the time axis and the collapsed edge scan (_group_edge_scan, the
    same Geweke-tested conditionals as the staged path) runs replicated
    across time shards on each device's local postsyn lanes. RNG: the key
    is folded with the lane-shard index, so postsyn draws are independent
    across lane shards and bit-identical across time shards (their
    scatters agree).

    The postsyn-lane axis shards over 'neuron', or jointly over
    ('chain','neuron') on a composed chain-data mesh — the whole update is
    lane-parallel, so a chain-stacked lane axis (models/ensemble.py) rides
    the identical pass; only the lane count and partition axes change
    (parallel.sharding.lane_axes).
    """
    from jax.sharding import PartitionSpec as PS
    from pyglm_tpu.parallel.sharding import lane_axes, lane_count, lane_index

    T, N = omega.shape
    Pdim = w_full.shape[0]
    N_pre = (Pdim - 1) // B
    Ng = N_pre // G
    GB = G * B
    n_time = mesh.shape.get("time", 1)
    lanes = lane_axes(mesh)
    n_neuron = lane_count(mesh)
    Tl = T // n_time
    Nl = N // n_neuron

    def group_pass(Xp, Xg, u, om, dW):
        """(u_new, M0 (GB,Nl), Jgg (Nl,GB,GB)) for one group: scatter the
        previous group's weight change into the residual, then gather."""
        u_new = u - om * lax.dot_general(
            Xp, dW, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=_F32)
        M0 = lax.dot_general(Xg, u_new, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.float32,
                             precision=_F32)
        Z = (Xg[:, None, :] * Xg[None, :, :]).reshape(GB * GB, Tl)
        Jgg = einsum_at("zt,tn->zn", Z, om, precision)
        return u_new, M0, Jgg.reshape(GB, GB, Nl).transpose(2, 0, 1)

    def shard_fn(k, xt, om, ka, ps, w, mu, lam, lrho, mu_b, lam_b):
        k = jax.random.fold_in(k, lane_index(mesh))
        keys = jax.random.split(k, Ng + 1)
        u = ka - om * ps
        C0 = chol_small(lam)                          # (Npre, Nl, B, B)
        ld0_half = jnp.sum(
            jnp.log(jnp.diagonal(C0, axis1=-2, axis2=-1)), axis=-1)

        def regroup(x):
            return x.reshape((Ng, G) + x.shape[1:])

        mu_g, Lam_g = regroup(mu), regroup(lam)
        ld0_g, lrho_g = regroup(ld0_half), regroup(lrho)
        w_nb = w[: N_pre * B]

        def body(carry, xs):
            u, w_nb_c, dW_prev = carry
            g, kg, mu0g, Lam0g, ld0g, lrhog = xs
            gp = jnp.maximum(g - 1, 0)                 # dW_prev == 0 at g=0
            Xp = lax.dynamic_slice(xt, (gp * GB, 0), (GB, Tl))
            Xg = lax.dynamic_slice(xt, (g * GB, 0), (GB, Tl))
            u, M0_loc, Jgg_loc = group_pass(Xp, Xg, u, om, dW_prev)
            M0 = lax.psum(M0_loc, "time")
            Jgg = lax.psum(Jgg_loc, "time")
            wg = lax.dynamic_slice(w_nb_c, (g * GB, 0), (GB, Nl))
            dW, wg_new, a_g = _group_edge_scan(
                kg, Jgg, M0, wg, mu0g, Lam0g, ld0g, lrhog, G, B)
            w_nb_c = lax.dynamic_update_slice(w_nb_c, wg_new, (g * GB, 0))
            return (u, w_nb_c, dW), a_g

        xs = (jnp.arange(Ng), keys[:Ng], mu_g, Lam_g, ld0_g, lrho_g)
        (u, w_nb, dW_last), A_g = lax.scan(
            body, (u, w_nb, jnp.zeros((GB, Nl), jnp.float32)), xs)

        # Epilogue: the last group's draws have not been scattered yet.
        Xl = lax.dynamic_slice(xt, ((Ng - 1) * GB, 0), (GB, Tl))
        u = u - om * lax.dot_general(
            Xl, dW_last, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST)

        # Bias column (always active): X_bias = ones.
        sum_om = lax.psum(jnp.sum(om, axis=0), "time")   # (Nl,)
        b_old = w[Pdim - 1]
        m_b = (lax.psum(jnp.sum(u, axis=0), "time")
               + sum_om * b_old + lam_b * mu_b)
        lam_p = lam_b + sum_om
        b_new = (m_b / lam_p
                 + jax.random.normal(keys[Ng], (Nl,)) / jnp.sqrt(lam_p))
        u = u - om * (b_new - b_old)[None, :]
        w_out = jnp.concatenate([w_nb, b_new[None, :]], axis=0)
        A = A_g.reshape(N_pre, Nl)
        return A, w_out, u, sum_om

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(PS(), PS(None, "time"), PS("time", lanes),
                  PS("time", lanes), PS("time", lanes),
                  PS(None, lanes), PS(None, lanes, None),
                  PS(None, lanes, None, None), PS(None, lanes),
                  PS(lanes), PS(lanes)),
        out_specs=(PS(None, lanes), PS(None, lanes),
                   PS("time", lanes), PS(lanes)),
        check_vma=False)
    return fn(key, Xt, omega, kappa, psi, w_full, hyp.mu, hyp.Lam,
              hyp.logit_rho, hyp.mu_b, hyp.lam_b)


def _auto_group(N_pre: int, B: int = 4) -> int:
    """Divisor of N_pre balancing group-Gram FLOPs (~G) against residual
    memory traffic (~1/G): the divisor nearest 5, larger on ties."""
    divs = [g for g in range(1, min(16, N_pre) + 1) if N_pre % g == 0]
    return min(divs, key=lambda g: (abs(g - 5), -g))


def resample_spike_slab_tspace(key, Xf, omega, kappa, w_full,
                               hyp: EdgeHypers, B: int, t_chunk: int = 512,
                               precision: str = "highest",
                               group: int | None = None, psi=None, Jg=None,
                               Xt=None):
    """Collapsed spike-and-slab dispatcher: captures the active mesh as a
    STATIC jit argument so the mesh-sharded and single-device traces can
    never be served from each other's jit cache (they pick different code
    paths at trace time). See _tspace_impl for the math."""
    from pyglm_tpu.parallel.sharding import active_mesh
    return _tspace_impl(key, Xf, omega, kappa, w_full, hyp, B=B,
                        t_chunk=t_chunk, precision=precision, group=group,
                        psi=psi, Jg=Jg, Xt=Xt, mesh=active_mesh())


@partial(jax.jit, static_argnames=("B", "t_chunk", "precision", "group",
                                   "mesh"))
def _tspace_impl(key, Xf, omega, kappa, w_full,
                 hyp: EdgeHypers, B: int, t_chunk: int = 512,
                 precision: str = "highest",
                 group: int | None = None, psi=None, Jg=None,
                 Xt=None, mesh=None):
    """Collapsed spike-and-slab for all neurons in residual (T-) space.

    Instead of materializing the full (N, P, P) Gram stack (O(N^3 T B^2)
    FLOPs — what the reference and `resample_spike_slab` do), maintain the
    working residual u = kappa - omega * psi. Edges are processed in groups
    of G presyn neurons: the big (T, N) arrays are touched once per *group*
    (one gather matmul M0 = Xg'u, one scatter matmul u -= omega * Xg dW),
    while the per-edge sequential conditioning inside a group rides the
    precomputed within-group Gram blocks:

        m_i = (Xg'u)_i - Jg[i, :] dW + Jg[i, i] w_i^cur

    O(N^2 T B) total, identical conditionals to the reference's per-edge
    collapsed Gibbs (pyglm/regressions.py _resample_A_W), ~G x less memory
    traffic than edge-at-a-time. Scan order: edge groups, then bias.

    Returns (A, w_full, u, sum_omega); psi under the new weights is
    (kappa - u) / omega — no extra big matmul.
    """
    T, P = Xf.shape
    N = omega.shape[1]
    N_pre = (P - 1) // B
    G = _auto_group(N_pre, B) if group is None else group
    Ng = N_pre // G
    GB = G * B

    # Trace-time record of which implementation this call compiled into
    # ("staged" | "mesh_fused") — a test/debug hook so suites can assert
    # the mesh path actually engaged rather than silently falling back.
    global LAST_SS_PATH
    LAST_SS_PATH = "staged"

    # Mesh path: the whole collapsed update inside one shard_map — per-group
    # passes per device, time-axis psums of Jgg/M0, replicated edge scan.
    if mesh is not None and Jg is None:
        from pyglm_tpu.parallel.sharding import lane_count
        reasons = []
        if Xt is None:
            reasons.append("no transposed design (Xt) was registered")
        if psi is None:
            reasons.append("psi was not precomputed")
        if T % mesh.shape.get("time", 1) != 0:
            reasons.append(
                f"T={T} is not divisible by the mesh time axis "
                f"{mesh.shape.get('time', 1)}")
        if N % lane_count(mesh) != 0:
            reasons.append(
                f"{N} postsyn lanes are not divisible by the mesh lane "
                f"axes ({lane_count(mesh)} devices)")
        if not reasons:
            LAST_SS_PATH = "mesh_fused"
            return _ss_fused_shard_map(key, Xt, omega, kappa, psi, w_full,
                                       hyp, B, G, mesh, t_chunk, precision)
        # Loud downgrade: the staged path below is exact but loses the
        # per-shard passes. Trace-time warning — fires once per compiled
        # sweep shape, not per sweep.
        import warnings
        from pyglm_tpu.utils.utils import PerformanceWarning
        warnings.warn(
            "mesh sweep is bypassing the fused spike-and-slab shard_map "
            "and running the staged path: " + "; ".join(reasons),
            PerformanceWarning, stacklevel=2)

    if Jg is None:
        if mesh is not None and mesh.devices.size > 1:
            from pyglm_tpu.parallel.sharding import lane_count
            mesh_ok = (T % mesh.shape.get("time", 1) == 0
                       and N % lane_count(mesh) == 0)
        else:
            mesh_ok = False
        if mesh_ok:
            Jg = _gram_shard_map(Xf, omega, B, G, t_chunk, precision, mesh)
        else:
            Jg = group_gram_blocks(Xf, omega, B, G, t_chunk=t_chunk,
                                   precision=precision)  # (Ng, N, GB, GB)
    # Unrolled small-B cholesky: a batched library Cholesky of the
    # (Npre, N, B, B) prior stack is launch-bound — per sweep, since hyp
    # changes with the network state.
    C0 = chol_small(hyp.Lam)                          # (Npre, N, B, B)
    ld0_half = jnp.sum(jnp.log(jnp.diagonal(C0, axis1=-2, axis2=-1)), axis=-1)

    if psi is None:
        psi = einsum_at("tp,pn->tn", Xf, w_full, precision)
    u0 = kappa - omega * psi
    keys = jax.random.split(key, Ng + 1)

    def regroup(x):
        """(N_pre, N, ...) -> (Ng, G, N, ...)."""
        return x.reshape((Ng, G) + x.shape[1:])

    mu_g = regroup(hyp.mu)
    Lam_g = regroup(hyp.Lam)
    ld0_g = regroup(ld0_half)
    lrho_g = regroup(hyp.logit_rho)

    def body(carry, xs):
        u, w = carry
        g, kg, mu0g, Lam0g, ld0g, lrhog, Jgg = xs
        sl = g * GB
        if Xt is not None:
            # At-rest transposed design: a group's columns are contiguous
            # ROWS of Xt — no strided (T, GB) gather per group.
            Xg_t = lax.dynamic_slice(Xt, (sl, 0), (GB, T))     # (GB, T)
            M0 = jnp.dot(Xg_t, u, preferred_element_type=jnp.float32,
                         precision=lax.Precision.HIGHEST)      # (GB, N)
        else:
            Xg = lax.dynamic_slice(Xf, (0, sl), (T, GB))       # (T, GB)
            M0 = jnp.dot(Xg.T, u, preferred_element_type=jnp.float32,
                         precision=lax.Precision.HIGHEST)      # (GB, N)
        wg = lax.dynamic_slice(w, (sl, 0), (GB, N))            # (GB, N)
        dW, wg_new, a_g = _group_edge_scan(
            kg, Jgg, M0, wg, mu0g, Lam0g, ld0g, lrhog, G, B)
        if Xt is not None:
            XdW = lax.dot_general(
                Xg_t, dW, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=lax.Precision.HIGHEST)               # (T, N)
        else:
            XdW = jnp.dot(Xg, dW, preferred_element_type=jnp.float32,
                          precision=lax.Precision.HIGHEST)
        u = u - omega * XdW
        w = lax.dynamic_update_slice(w, wg_new, (sl, 0))
        return (u, w), a_g

    xs = (jnp.arange(Ng), keys[:Ng], mu_g, Lam_g, ld0_g, lrho_g, Jg)
    (u, w), A = lax.scan(body, (u0, w_full), xs)
    A = A.reshape(N_pre, N)

    # Bias column (always active): X_bias = ones.
    sum_om = jnp.sum(omega, axis=0)                               # (N,)
    b_old = w[P - 1]
    m_b = jnp.sum(u, axis=0) + sum_om * b_old + hyp.lam_b * hyp.mu_b
    lam_p = hyp.lam_b + sum_om
    b_new = m_b / lam_p + jax.random.normal(keys[Ng], (N,)) / jnp.sqrt(lam_p)
    u = u - omega * (b_new - b_old)[None, :]
    w = w.at[P - 1].set(b_new)
    return A, w, u, sum_om


def _block_diag_precision(Lam0, lam_b, P: int, B: int):
    """Scatter (N, B, B) per-edge prior precisions + bias into (P, P)."""
    N = Lam0.shape[0]
    idx = jnp.arange(N * B).reshape(N, B)
    full = jnp.zeros((P, P), Lam0.dtype)
    full = full.at[idx[:, :, None], idx[:, None, :]].set(Lam0)
    full = full.at[P - 1, P - 1].set(lam_b)
    return full


def _dense_one_neuron(key, J, h, mu0, Lam0, mu_b, lam_b, B: int):
    """Full P-dim conjugate Gaussian draw (dense adjacency, A == 1)."""
    P = h.shape[0]
    prior_prec = _block_diag_precision(Lam0, lam_b, P, B)
    h0 = jnp.einsum("jbc,jc->jb", Lam0, mu0, precision=_F32).reshape(-1)
    h0 = jnp.concatenate([h0, (lam_b * mu_b)[None]])
    return sample_mvn_info(key, h + h0, prior_prec + J)


@partial(jax.jit, static_argnames=("B",))
def resample_dense(key, J, h, hyp: EdgeHypers, B: int):
    """Batched dense weight update: w[:, n] ~ N(.., (Lam0 + J_n)^{-1})."""
    N = h.shape[1]
    keys = jax.random.split(key, N)
    w = jax.vmap(
        _dense_one_neuron, in_axes=(0, 0, 1, 1, 1, 0, 0, None),
    )(keys, J, h, hyp.mu, hyp.Lam, hyp.mu_b, hyp.lam_b, B)
    return w.T              # (P, N)
