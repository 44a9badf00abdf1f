"""Polya-Gamma random variates on the accelerator.

This module replaces the reference's native sampling layer
(``pypolyagamma/cpp/PolyaGamma*.{h,cpp}`` — Devroye / alternate / saddlepoint
C++ samplers fanned out with OpenMP in ``pypolyagamma.pyx (pgdrawvpar)``) with
fully vectorized JAX samplers that draw *all* N*T auxiliary variables of a
Gibbs sweep in one masked, elementwise accept-reject pass:

- :func:`pg_devroye` — exact PG(1, c) via Devroye's alternating-series
  rejection sampler for J*(1, z) (Polson–Scott–Windle 2013, Alg. 1),
  expressed as ``lax.while_loop`` over the whole batch with per-element
  acceptance masks (no data-dependent shapes).
- :func:`pg_gamma_series` — PG(b, c) for arbitrary real b > 0 via the
  infinite-sum-of-gammas representation truncated at K terms with a
  moment-matched Gamma tail correction.
- :func:`pg_normal_approx` — Gaussian approximation for large b (the
  reference's hybrid dispatch uses this for b >~ 170).
- :func:`polya_gamma` — hybrid dispatch, the analog of
  ``PyPolyaGamma.pgdrawv`` / ``pgdrawvpar``.

PG(b, c) facts used throughout:
    E[PG(b,c)]   = b/(2c) * tanh(c/2)
    Var[PG(b,c)] = b * (2t - c(1-t^2)) / (4 c^3),  t = tanh(c/2)
    PG(1, c) = J*(1, c/2) / 4
    PG(b, c) = (1/(2 pi^2)) * sum_k g_k / ((k-1/2)^2 + c^2/(4 pi^2)),
               g_k ~ Gamma(b, 1) iid.

Parity is *statistical*, never bitwise: the reference uses stateful GSL RNG
streams, we use counter-based ``jax.random`` keys.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.stats import norm as _norm

_PI = 3.141592653589793
_TRUNC = 0.64          # Devroye proposal truncation point t
_MAX_OUTER = 64        # outer proposal rounds (acceptance >= 0.9992/round)
_MAX_INNER = 64        # truncated-inverse-Gaussian rounds
_N_SERIES = 4          # alternating-series terms: a_3/a_0 < 1e-17, i.e.
                       # terms beyond n=3 are invisible at f32 precision


# ---------------------------------------------------------------------------
# Moments (stable for all c, including c -> 0)
# ---------------------------------------------------------------------------

def pg_mean(b, c):
    """E[PG(b, c)] = b/(2c) tanh(c/2), stable at c=0 (-> b/4)."""
    b = jnp.asarray(b, jnp.float32)
    c = jnp.asarray(c, jnp.float32)
    x = 0.5 * jnp.abs(c)
    small = x < 1e-3
    # tanh(x)/x ~ 1 - x^2/3 + 2 x^4/15
    ratio = jnp.where(
        small,
        1.0 - x * x / 3.0 + 2.0 * x ** 4 / 15.0,
        jnp.tanh(x) / jnp.where(small, 1.0, x),
    )
    return 0.25 * b * ratio


def pg_var(b, c):
    """Var[PG(b, c)], stable at c=0 (-> b/24)."""
    b = jnp.asarray(b, jnp.float32)
    c = jnp.abs(jnp.asarray(c, jnp.float32))
    t = jnp.tanh(0.5 * c)
    # The exact form cancels catastrophically for small c (and an f32 tanh
    # is only ~1e-6-accurate there), so switch to the Taylor series below
    # c = 0.6.
    small = c < 0.6
    num = 2.0 * t - c * (1.0 - t * t)      # = (sinh c - c)/cosh^2(c/2)
    exact = num / jnp.where(small, 1.0, 4.0 * c ** 3)
    c2 = c * c
    series = 1.0 / 24.0 - c2 / 120.0 + 17.0 * c2 * c2 / 13440.0
    return b * jnp.where(small, series, exact)


# ---------------------------------------------------------------------------
# Devroye exact sampler for PG(1, c)
# ---------------------------------------------------------------------------

def _log_coef(x, n):
    """log a_n(x): piecewise alternating-series coefficients of J*(1, .).

    Left branch (x <= t):  pi(n+1/2) (2/(pi x))^{3/2} exp(-2(n+1/2)^2/x)
    Right branch (x > t):  pi(n+1/2) exp(-(n+1/2)^2 pi^2 x / 2)
    Computed in log space so tiny x underflows cleanly to -inf.
    """
    half = n + 0.5
    xs = jnp.maximum(x, 1e-30)
    logl = (jnp.log(_PI * half) + 1.5 * (jnp.log(2.0 / _PI) - jnp.log(xs))
            - 2.0 * half * half / xs)
    logr = jnp.log(_PI * half) - half * half * _PI * _PI * xs / 2.0
    return jnp.where(x <= _TRUNC, logl, logr)


def _trunc_inv_gauss(key, z, active):
    """X ~ InverseGaussian(mu=1/z, lambda=1) restricted to (0, t), vectorized.

    Two regimes (PSW 2013 / Devroye):
      z*t < 1 (mu > t): tilted-Levy rejection
          E1,E2 ~ Exp(1) s.t. E1^2 <= 2 E2/t; X = t/(1+t E1)^2;
          accept w.p. exp(-z^2 X / 2).
      z*t >= 1 (mu <= t): Michael–Schucany–Haas transform, retry until X <= t.
    Runs a masked while_loop until every `active` element accepts.
    """
    t = _TRUNC
    shape = z.shape

    def cond(state):
        i, _, _, done = state
        return (i < _MAX_INNER) & jnp.any(~done)

    def body(state):
        i, key, X, done = state
        key, k1, k2, k3, k4, k5 = jax.random.split(key, 6)
        # Regime A: tilted Levy on (0, t).
        E1 = jax.random.exponential(k1, shape)
        E2 = jax.random.exponential(k2, shape)
        okA = (E1 * E1) <= (2.0 * E2 / t)
        XA = t / (1.0 + t * E1) ** 2
        accA = okA & (jax.random.uniform(k3, shape)
                      <= jnp.exp(-0.5 * z * z * XA))
        # Regime B: IG(mu, 1) by MSH, accept if <= t.
        mu = 1.0 / jnp.maximum(z, 1e-30)
        Yn = jax.random.normal(k4, shape) ** 2
        muY = mu * Yn
        XB0 = mu + 0.5 * mu * muY - 0.5 * mu * jnp.sqrt(4.0 * muY + muY * muY)
        XB0 = jnp.maximum(XB0, 1e-30)
        takeB = jax.random.uniform(k5, shape) <= mu / (mu + XB0)
        XB = jnp.where(takeB, XB0, mu * mu / XB0)
        accB = XB <= t
        useA = (z * t) < 1.0
        Xn = jnp.where(useA, XA, XB)
        acc = jnp.where(useA, accA, accB) & ~done
        X = jnp.where(acc, Xn, X)
        done = done | acc
        return i + 1, key, X, done

    # Elements not active are marked done immediately (their X is unused).
    init = (jnp.zeros((), jnp.int32), key,
            jnp.full(shape, 0.5 * t, z.dtype), ~active)
    _, _, X, _ = lax.while_loop(cond, body, init)
    return X


def _series_accept(key, X, active):
    """Alternating-series accept/reject test given proposal X ~ envelope.

    Y = U * a_0(X); accept iff Y <= sum of alternating series. With N_SERIES
    fixed terms: accept if Y <= last lower bound, reject if Y > last upper
    bound; the indeterminate band has mass ~ a_N(X) < 1e-40.
    """
    la0 = _log_coef(X, 0.0)
    U = jax.random.uniform(key, X.shape, minval=1e-12)
    logY = jnp.log(U) + la0
    S = jnp.exp(la0)
    lower = jnp.zeros_like(S)
    for n in range(1, _N_SERIES + 1):
        term = jnp.exp(_log_coef(X, float(n)))
        if n % 2 == 1:
            S = S - term
            lower = S
        else:
            S = S + term
    Y = jnp.exp(logY)
    accept = Y <= lower
    return accept & active


def pg_devroye(key, c):
    """Exact PG(1, c) draws, elementwise over any-shaped `c`.

    Vectorized rebuild of ``PolyaGamma::draw`` (reference:
    pypolyagamma/cpp/PolyaGamma.cpp): the scalar rejection loop becomes a
    masked ``lax.while_loop`` over the full batch; acceptance per round is
    >= 0.9992 uniformly in c, so the loop converges in ~3 rounds even for
    tens of millions of elements.
    """
    c = jnp.asarray(c, jnp.float32)
    z = 0.5 * jnp.abs(c)
    shape = z.shape
    t = _TRUNC

    K = _PI * _PI / 8.0 + 0.5 * z * z
    logp = jnp.log(_PI / (2.0 * K)) - K * t
    sqt = jnp.sqrt(t)
    logq = jnp.log(2.0) + jnp.logaddexp(
        -z + _norm.logcdf((z * t - 1.0) / sqt),
        z + _norm.logcdf(-(z * t + 1.0) / sqt),
    )
    ratio_exp = jnp.exp(logp - jnp.logaddexp(logp, logq))  # P(exp branch)

    zsafe = jnp.maximum(z, 1e-6)
    fallback = jnp.where(z < 1e-6, 1.0, jnp.tanh(zsafe) / zsafe)  # E[J*(1,z)]

    def cond(state):
        i, _, _, done = state
        return (i < _MAX_OUTER) & jnp.any(~done)

    def body(state):
        i, key, X, done = state
        key, kb, ke, kig, ks = jax.random.split(key, 5)
        branch_exp = jax.random.uniform(kb, shape) < ratio_exp
        Xexp = t + jax.random.exponential(ke, shape) / K
        need_ig = (~done) & (~branch_exp)
        Xig = _trunc_inv_gauss(kig, z, need_ig)
        Xprop = jnp.where(branch_exp, Xexp, Xig)
        acc = _series_accept(ks, Xprop, ~done)
        X = jnp.where(acc, Xprop, X)
        done = done | acc
        return i + 1, key, X, done

    state = (jnp.zeros((), jnp.int32), key, fallback, jnp.zeros(shape, bool))
    _, _, X, _ = lax.while_loop(cond, body, state)
    return 0.25 * X


# ---------------------------------------------------------------------------
# Gamma-series sampler for general b > 0
# ---------------------------------------------------------------------------

def _tail_sums(a, K):
    """(S1, S2, S3) = sum_{k>K} 1/d_k, 1/d_k^2, 1/d_k^3 with
    d_k = (k-1/2)^2 + a^2.

    Midpoint-rule integrals (grid points are interval midpoints, so the
    approximation error is O(f''/24) — at the shipped K the tail's
    variance share is small and the end-to-end draws remain
    KS-indistinguishable from the exact native convolution oracle across
    b in {1..130} (benchmarks/k8_study.py; tests/test_polyagamma.py)):
      S1 ~ atan(a/K)/a            (-> 1/K as a->0)
      S2 ~ atan(a/K)/(2a^3) - K/(2a^2(K^2+a^2))   (-> 1/(3K^3) as a->0)
      S3 ~ 3 atan(a/K)/(8a^5) - K/(4a^2(K^2+a^2)^2) - 3K/(8a^4(K^2+a^2))
                                                   (-> 1/(5K^5) as a->0)
    S3 feeds the THIRD tail moment (the shifted-gamma tail match). The
    exact S2/S3 forms cancel catastrophically in f32 for small a, so we
    switch to their Taylor series below a = 0.5.
    """
    Kf = float(K)
    asafe = jnp.maximum(a, 1e-12)
    small = a < 0.5
    S1 = jnp.where(
        small,
        (1.0 - (a / Kf) ** 2 / 3.0 + (a / Kf) ** 4 / 5.0) / Kf,
        jnp.arctan(asafe / Kf) / asafe,
    )
    S2_exact = (jnp.arctan(asafe / Kf) / (2.0 * asafe ** 3)
                - Kf / (2.0 * asafe ** 2 * (Kf * Kf + asafe ** 2)))
    S2_series = (1.0 / (3.0 * Kf ** 3) - 2.0 * a ** 2 / (5.0 * Kf ** 5)
                 + 3.0 * a ** 4 / (7.0 * Kf ** 7))
    S2 = jnp.where(small, S2_series, S2_exact)
    d_K = Kf * Kf + asafe ** 2
    S3_exact = (3.0 * jnp.arctan(asafe / Kf) / (8.0 * asafe ** 5)
                - Kf / (4.0 * asafe ** 2 * d_K * d_K)
                - 3.0 * Kf / (8.0 * asafe ** 4 * d_K))
    S3_series = (1.0 / (5.0 * Kf ** 5) - 3.0 * a ** 2 / (7.0 * Kf ** 7)
                 + 2.0 * a ** 4 / (3.0 * Kf ** 9))
    S3 = jnp.where(small, S3_series, S3_exact)
    # First Euler-Maclaurin midpoint correction: sum_{k>K} f(k-1/2) =
    # int_K^inf f + f'(K)/24 + O(f''') with f = d^-p, f'(K) =
    # -2pK d_K^-(p+1). Cuts the raw midpoint bias ~100x (verified vs
    # brute-force sums), which is what keeps the matched tail honest at
    # small K.
    dKa = Kf * Kf + a * a          # exact at a = 0 too
    S1 = S1 - (2.0 * Kf / 24.0) / (dKa * dKa)
    S2 = S2 - (4.0 * Kf / 24.0) / (dKa * dKa * dKa)
    S3 = S3 - (6.0 * Kf / 24.0) / (dKa * dKa * dKa * dKa)
    return S1, S2, S3


@partial(jax.jit, static_argnames=("K",))
def pg_gamma_series(key, b, c, K: int = 4):
    """PG(b, c) for arbitrary real b > 0 via truncated gamma series.

    PG(b,c) = (1/(2 pi^2)) sum_{k>=1} g_k / ((k-1/2)^2 + c^2/(4 pi^2)).
    First K terms drawn exactly (g_k ~ Gamma(b,1)); the tail — a sum of many
    small independent gammas — is replaced by one moment-matched Gamma draw.
    Replaces the reference's alternate + saddlepoint C++ samplers
    (pypolyagamma/cpp/PolyaGammaAlt.cpp, PolyaGammaSP.cpp) with a single
    branch-free vectorized path valid for every b regime.
    """
    b = jnp.asarray(b, jnp.float32)
    c = jnp.asarray(c, jnp.float32)
    shape = jnp.broadcast_shapes(b.shape, c.shape)
    b = jnp.broadcast_to(b, shape)
    c = jnp.broadcast_to(c, shape)
    bsafe = jnp.maximum(b, 1e-6)

    a = jnp.abs(c) / (2.0 * _PI)
    ks = (jnp.arange(K, dtype=jnp.float32) + 0.5) ** 2        # (K,)
    d = ks + (a * a)[..., None]                                # (..., K)
    kg, kt = jax.random.split(key)
    g = jax.random.gamma(kg, bsafe[..., None], shape=shape + (K,))
    s = jnp.sum(g / d, axis=-1) / (2.0 * _PI * _PI)

    S1, S2, S3 = _tail_sums(a, K)
    m_t = bsafe * S1 / (2.0 * _PI * _PI)
    v_t = bsafe * S2 / (4.0 * _PI ** 4)
    # Shifted-gamma tail matching THREE moments (third cumulants of the
    # tail terms add: mu3 = 2b S3/(2pi^2)^3). A plain 2-moment gamma
    # UNDERSHOOTS the tail's skewness (Cauchy-Schwarz: S2^2 <= S1 S3), so
    # the shift delta = m - 2v^2/mu3 is >= 0 — the match never leaves the
    # positive support. This is what lets K shrink without the KS grid
    # seeing the third-cumulant mismatch.
    mu3_t = 2.0 * bsafe * S3 / (2.0 * _PI * _PI) ** 3
    beta = 2.0 * v_t / jnp.maximum(mu3_t, 1e-30)
    alpha = v_t * beta * beta
    delta = jnp.maximum(m_t - alpha / beta, 0.0)
    tail = delta + jax.random.gamma(kt, alpha, shape=shape) / beta

    out = s + tail
    return jnp.where(b > 0, out, 0.0)


@jax.jit
def pg_normal_approx(key, b, c):
    """Gaussian approximation PG(b,c) ~ N(mean, var) for large b.

    The reference's hybrid dispatch uses this for b >~ 170
    (pypolyagamma/pypolyagamma.pyx); moment error is O(1/b).
    """
    m = pg_mean(b, c)
    v = pg_var(b, c)
    x = m + jnp.sqrt(v) * jax.random.normal(key, jnp.shape(m))
    return jnp.maximum(x, 1e-30)


def _shard_map_elementwise(draw_fn, key, mesh, *arrs):
    """Run an elementwise sampler per mesh shard via jax.shard_map, with a
    per-shard fold of the key (SURVEY.md §2.4 comm row), so every shard
    draws its local (time, lanes) tile with no collectives. The lane axis
    shards over the mesh's lane axes — 'neuron' on a data mesh, jointly
    ('chain','neuron') on a composed chain-data mesh
    (parallel.sharding.lane_axes).
    """
    from jax.sharding import PartitionSpec as P
    from pyglm_tpu.parallel.sharding import lane_axes
    lanes = lane_axes(mesh)

    idx_axes = (("time",) if "time" in mesh.shape else ()) + lanes

    def fn(k, *local):
        idx = jnp.int32(0)
        for a in idx_axes:
            idx = idx * mesh.shape[a] + lax.axis_index(a)
        return draw_fn(jax.random.fold_in(k, idx), *local)

    spec = P("time" if "time" in mesh.shape else None, lanes)
    # check_vma=False: the samplers' masked while_loops mix replicated
    # (key-derived) and shard-varying carries, which the vma analysis
    # rejects; there are no collectives inside, so the check buys nothing.
    return jax.shard_map(
        fn, mesh=mesh, in_specs=(P(),) + (spec,) * len(arrs),
        out_specs=spec, check_vma=False)(key, *arrs)


def _sharded(mesh, *arrs) -> bool:
    """Whether to draw per shard: a multi-device mesh whose time and lane
    axes divide every (T, lanes) input."""
    if mesh is None or mesh.devices.size == 1:
        return False
    from pyglm_tpu.parallel.sharding import lane_count
    return all(a.ndim == 2 and a.shape[0] % mesh.shape.get("time", 1) == 0
               and a.shape[1] % lane_count(mesh) == 0 for a in arrs)


def pg_draw_unit(key, c, mesh=None):
    """PG(1, c): the exact Devroye sampler, run per shard inside
    jax.shard_map when ``mesh`` (default: the trace-time active mesh,
    parallel.sharding.active_mesh) spans several devices."""
    if mesh is None:
        from pyglm_tpu.parallel.sharding import active_mesh
        mesh = active_mesh()
    if _sharded(mesh, c):
        return _shard_map_elementwise(pg_devroye, key, mesh, c)
    return pg_devroye(key, c)


# Matches the reference's hybrid dispatch (pypolyagamma.pyx: normal approx
# only for b >~ 170). The gamma-series path is valid for every b and its
# cost is b-independent, so the higher cutoff buys accuracy for free.
_NORMAL_CUTOFF = 170.0


def polya_gamma(key, b, c, method: str = "auto", K: int = 4):
    """Hybrid PG(b, c) sampler — analog of ``pgdrawv``/``pgdrawvpar``.

    method:
      "auto"    — gamma-series for b < 170, normal approx above, exact
                  Devroye where b == 1; zeros where b == 0 (masked data).
      "real"    — like auto but without the b == 1 Devroye overlay; use for
                  families whose b is generically non-integer (e.g. NB's
                  b = y + r), where computing the overlay is pure waste.
      "devroye" — exact PG(1, c) (b must be all ones).
      "gamma"   — gamma-series for all elements.
      "normal"  — normal approximation for all elements.

    The active mesh is captured as a STATIC jit argument, so traces made
    under different meshes can never be served from each other's cache
    (same discipline as weights.resample_spike_slab_tspace).
    """
    from pyglm_tpu.parallel.sharding import active_mesh
    return _polya_gamma_impl(key, b, c, method=method, K=K,
                             mesh=active_mesh())


@partial(jax.jit, static_argnames=("method", "K", "mesh"))
def _polya_gamma_impl(key, b, c, method: str, K: int, mesh):
    b = jnp.asarray(b, jnp.float32)
    c = jnp.asarray(c, jnp.float32)
    shape = jnp.broadcast_shapes(b.shape, c.shape)
    b = jnp.broadcast_to(b, shape)
    c = jnp.broadcast_to(c, shape)

    if method == "devroye":
        return pg_devroye(key, c)
    if method == "gamma":
        return _gamma_series_dispatch(key, b, c, K, mesh)
    if method == "normal":
        return pg_normal_approx(key, b, c)

    k1, k2, k3 = jax.random.split(key, 3)
    out = jnp.where(
        b >= _NORMAL_CUTOFF,
        pg_normal_approx(k1, b, c),
        _gamma_series_dispatch(k2, jnp.minimum(b, _NORMAL_CUTOFF), c, K,
                               mesh),
    )
    if method == "auto":
        out = jnp.where(b == 1.0, pg_draw_unit(k3, c, mesh=mesh), out)
    return jnp.where(b > 0, out, 0.0)


def _gamma_series_dispatch(key, b, c, K, mesh):
    """The gamma-series sampler, per shard inside jax.shard_map when the
    mesh spans several devices (same rule as pg_draw_unit)."""
    if _sharded(mesh, b, c):
        return _shard_map_elementwise(
            lambda k, bb, cc: pg_gamma_series(k, bb, cc, K=K),
            key, mesh, b, c)
    return pg_gamma_series(key, b, c, K=K)
