"""Smoke test of the Gibbs sampler on one GPU, through the public API.

Runs the main path at the flagship width (N=200 neurons, T=100k bins, B=4,
random ground truth from a seed): a sparse Bernoulli GLM fitted with
``fit_compiled`` at precision "high" and "default", the same shape with
negative-binomial observations, and the numerics of the sweep's matmuls and
Polya-gamma samplers against plain float64 references. Every phase raises
on failure, so any failed check exits non-zero. The last line of standard
output is one JSON object naming the device; everything else comes before.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # only the four-GPU mesh paths and the
                                  # single-GPU values they are compared with

It refuses to run unless JAX's default device is a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Relative Frobenius error bounds of the sweep's matmuls against float64,
# per model precision. "highest" (plain f32) is held below what "high"
# (three bf16 products) reaches, so a silent downgrade of one to the other
# fails. "default" is TF32 on an H100 (10-bit mantissa).
BOUNDS = {"high": 1e-5, "highest": 7e-7, "default": 3e-3}
# Per-bin sampler means must sit within this many standard errors.
Z_MAX = 5.0


def log(*args):
    print(*args, flush=True)


def require_gpu():
    """Exit non-zero, printing no result, unless the default device is a
    GPU. Returns jax.devices()."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}",
              file=sys.stderr)
        sys.exit(2)
    return devs


def device_info():
    """Card name and power limit (nvidia-smi), JAX version, flags, cache."""
    import jax
    from pyglm_tpu.utils.utils import enable_compile_cache
    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    log(f"nvidia-smi: {smi.strip()}")
    log(f"jax {jax.__version__}; devices {jax.devices()}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")


def process_peak_bytes():
    """Peak device bytes in use by this process so far: JAX never resets
    it, so a phase reports the largest of its own peak and every earlier
    phase's."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _fit_twice(model, n_burnin, n_samples):
    """First fit_compiled call compiles and runs; the second runs the same
    compiled segments. Returns (compile seconds, sweeps/s, lls)."""
    t0 = time.perf_counter()
    model.fit_compiled(n_samples=n_samples, n_burnin=n_burnin)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.fit_compiled(n_samples=n_samples, n_burnin=n_burnin)
    t_run = time.perf_counter() - t0
    return t_first - t_run, (n_burnin + n_samples) / t_run, out["lls"]


def _check_fit(name, ll0, lls, n_samples):
    lls = np.asarray(lls)
    if lls.shape != (n_samples,) or not np.all(np.isfinite(lls)):
        raise AssertionError(f"{name}: lls not finite: {lls}")
    if not np.median(lls) > ll0:
        raise AssertionError(
            f"{name}: ll did not rise from the initial state "
            f"({ll0:.1f} -> median {np.median(lls):.1f})")


def flagship_bernoulli(N=200, T=100_000, B=4, L=10, n_burnin=2,
                       n_samples=10, precisions=("high", "default")):
    """SparseBernoulliGLM at the flagship shape, fitted at each precision."""
    import pyglm_tpu as pt
    from benchmarks.common import bernoulli_flagship_data
    Y = bernoulli_flagship_data(pt, N, T, B=B, L=L)
    log(f"bernoulli N={N} T={T} B={B}: spike rate {float(Y.mean()):.4f}")
    for prec in precisions:
        model = pt.SparseBernoulliGLM(N, B=B, L=L, seed=0, precision=prec)
        model.add_data(Y)
        ll0 = model.log_likelihood()
        compile_s, rate, lls = _fit_twice(model, n_burnin, n_samples)
        _check_fit(f"bernoulli/{prec}", ll0, lls, n_samples)
        log(f"bernoulli precision={prec}: compile {compile_s:.1f} s, "
            f"{rate:.3f} sweeps/s, ll {ll0:.1f} -> {lls[-1]:.1f}, "
            f"process peak device bytes so far {process_peak_bytes()}")


def flagship_nb(N=200, T=100_000, B=4, L=10, n_burnin=1, n_samples=4,
                precision="high"):
    """SparseNegativeBinomialGLM at the flagship shape: gamma-series PG
    draws and the collapsed CRT dispersion update."""
    import jax.numpy as jnp
    import pyglm_tpu as pt
    from benchmarks.common import nb_flagship_models
    _, fresh, Y = nb_flagship_models(pt, jnp, N, T, B=B, L=L)
    model = fresh(precision)
    model.add_data(Y)
    ll0 = model.log_likelihood()
    compile_s, rate, lls = _fit_twice(model, n_burnin, n_samples)
    _check_fit("negative_binomial", ll0, lls, n_samples)
    r = np.asarray(model.state.aux["r"])
    if not np.all(np.isfinite(r) & (r > 0)):
        raise AssertionError(f"negative_binomial: bad dispersion r {r}")
    log(f"negative_binomial N={N} T={T} precision={precision}: compile "
        f"{compile_s:.1f} s, {rate:.3f} sweeps/s, ll {ll0:.1f} -> "
        f"{lls[-1]:.1f}, process peak device bytes so far "
        f"{process_peak_bytes()}")


def _rel_err(x, ref):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def gram_psi_numerics(T=100_000, N=200, B=4, L=10, lanes=8, seed=0,
                      precisions=("high", "highest", "default")):
    """group_gram_blocks and psi = Xf w against float64 NumPy on `lanes`
    postsynaptic lanes of a design of P = N*B + 1 columns."""
    import jax.numpy as jnp
    import pyglm_tpu as pt
    from pyglm_tpu.models.weights import (_auto_group, einsum_at,
                                          group_gram_blocks)
    from pyglm_tpu.ops.basis import design_matrix
    rng = np.random.default_rng(seed)
    Y = (rng.random((T, N)) < 0.05).astype(np.float32)
    Xf = design_matrix(jnp.asarray(Y), pt.cosine_basis(B=B, L=L))
    P = Xf.shape[1]
    omega = rng.uniform(0.05, 0.3, (T, lanes)).astype(np.float32)
    w = (rng.standard_normal((P, lanes)) * 0.3).astype(np.float32)
    G = _auto_group(N, B)
    GB = G * B
    X64 = np.asarray(Xf, np.float64)
    psi_ref = X64 @ w.astype(np.float64)
    om64 = omega.astype(np.float64)
    gram_ref = np.empty((N // G, lanes, GB, GB))
    for g in range(N // G):
        Xg = X64[:, g * GB:(g + 1) * GB]
        Z = (Xg[:, :, None] * Xg[:, None, :]).reshape(T, GB * GB)
        gram_ref[g] = (Z.T @ om64).T.reshape(lanes, GB, GB)
    for prec in precisions:
        gram = group_gram_blocks(Xf, jnp.asarray(omega), B, G,
                                 precision=prec)
        psi = einsum_at("tp,pn->tn", Xf, jnp.asarray(w), prec)
        for name, err in (("group_gram", _rel_err(gram, gram_ref)),
                          ("psi", _rel_err(psi, psi_ref))):
            ok = err <= BOUNDS[prec]
            log(f"numerics {name} precision={prec} T={T} P={P}: rel err "
                f"{err:.3e} (bound {BOUNDS[prec]:.1e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}/{prec}: {err} > {BOUNDS[prec]}")


def _check_bin_means(name, draws, bins):
    """Mean of the draws in each (b, c) bin against pg_mean, in standard
    errors from pg_var."""
    import pyglm_tpu as pt
    from pyglm_tpu.ops.polyagamma import pg_var
    draws = np.asarray(draws, np.float64).ravel()
    worst = 0.0
    for (bb, cc), idx in bins:
        x = draws[idx]
        mean = float(pt.pg_mean(bb, cc))
        se = float(np.sqrt(pg_var(bb, cc) / x.size))
        z = abs(x.mean() - mean) / se
        worst = max(worst, z)
        if not z < Z_MAX:
            raise AssertionError(
                f"{name} b={bb} c={cc}: mean {x.mean():.6f} vs "
                f"{mean:.6f}, z={z:.2f}")
    log(f"numerics {name}: {draws.size} draws in {len(bins)} bins, worst "
        f"|z| {worst:.2f} (bound {Z_MAX})")


def pg_numerics(n_unit=20_000_000, n_gamma=4_000_000, seed=0):
    """PG(1, c) through pg_draw_unit and PG(b, c) through the gamma-series
    path of polya_gamma, binned by (b, c), against the closed-form mean."""
    import jax
    import jax.numpy as jnp
    import pyglm_tpu as pt
    cs = np.array([0.0, 0.1, 0.5, 1.0, 2.0, 3.5, 5.0, 8.0, 12.0, 20.0],
                  np.float32)
    c = np.repeat(cs, -(-n_unit // cs.size))[:n_unit]
    draws = pt.pg_draw_unit(jax.random.key(seed), jnp.asarray(c))
    bins = [((1.0, float(v)), np.flatnonzero(c == v)) for v in cs]
    _check_bin_means("pg_devroye PG(1,c)", draws, bins)

    pairs = [(b, cc) for b in (1.5, 4.0, 17.0, 60.0)
             for cc in (0.0, 1.0, 4.0)]
    k = -(-n_gamma // len(pairs))
    b = np.repeat(np.array([p[0] for p in pairs], np.float32), k)[:n_gamma]
    c = np.repeat(np.array([p[1] for p in pairs], np.float32), k)[:n_gamma]
    draws = pt.polya_gamma(jax.random.key(seed + 1), jnp.asarray(b),
                           jnp.asarray(c), method="real")
    bins = [((bb, cc), np.flatnonzero((b == bb) & (c == cc)))
            for bb, cc in pairs]
    _check_bin_means("pg_gamma_series PG(b,c)", draws, bins)


def _span(sl):
    return ":" if sl.start is None and sl.stop is None else \
        f"{sl.start}:{sl.stop}"


def four_device(N=500, T=20_000, B=4, L=10, n_chains=8, precision="high"):
    """BASELINE config 5 (latent-distance spike-and-slab) on four devices:
    the ('time','neuron') sharded model against its single-device values,
    a C-chain ensemble on a ('chain',) mesh, and the composed
    ('chain','time','neuron') mesh."""
    import jax
    import jax.numpy as jnp
    import pyglm_tpu as pt
    from pyglm_tpu.models.weights import (_auto_group, _gram_shard_map,
                                          group_gram_blocks)
    from pyglm_tpu.parallel.sharding import (make_chain_data_mesh,
                                             make_chain_mesh, make_mesh)
    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four needs 4 devices, found {len(devs)}")
    devs = devs[:4]

    def config5(seed):
        return pt.NonlinearAutoregressiveModel(
            N, B=B, L=L, observation="bernoulli", network="latent_distance",
            spike_and_slab=True, seed=seed, precision=precision,
            net_kwargs=dict(dim=2, mu_bias=-3.0))

    Y = config5(5).generate(T, keep=False)
    model = config5(0)
    model.add_data(Y)

    def check_chains(name, out, C):
        lls = np.asarray(out["lls"])
        if lls.shape[0] != C or not np.all(np.isfinite(lls)):
            raise AssertionError(f"{name}: bad lls {lls}")
        for i in range(1, C):
            if np.allclose(lls[0], lls[i]):
                raise AssertionError(f"{name}: chains 0 and {i} coincide")
        log(f"{name}: {C} chains x {lls.shape[1]} samples, final lls "
            f"{[round(float(x), 1) for x in lls[:, -1]]}")

    t0 = time.perf_counter()
    # n_burnin=0: each fit compiles one scanned segment, not two.
    out = model.fit_ensemble(n_chains=n_chains, n_samples=4, n_burnin=0,
                             mesh=make_chain_mesh(4, devices=devs))
    check_chains(f"chain mesh (4,) N={N} T={T}", out, n_chains)
    log(f"chain mesh: {time.perf_counter() - t0:.1f} s incl. compile")
    t0 = time.perf_counter()
    mesh3 = make_chain_data_mesh(2, 1, 2, devices=devs)
    out = model.fit_ensemble(n_chains=4, n_samples=4, n_burnin=0,
                             mesh=mesh3)
    check_chains(f"composed mesh {dict(mesh3.shape)}", out, 4)
    log(f"composed mesh: {time.perf_counter() - t0:.1f} s incl. compile")

    # Single-device values at the model's current state, then the same
    # on the sharded model.
    rng = np.random.default_rng(1)
    omega = jnp.asarray(rng.uniform(0.05, 0.3, (T, N)).astype(np.float32))
    G = _auto_group(N, B)
    gram1 = np.asarray(group_gram_blocks(model.datas[0].Xf, omega, B, G,
                                         precision=precision), np.float64)
    ll1 = model.log_likelihood()
    mesh = make_mesh(n_time=2, n_neuron=2, devices=devs)
    model.shard(mesh)
    d = model.datas[0]
    for name, arr in (("Xf", d.Xf), ("Xt", d.Xt), ("Y", d.Y),
                      ("A", model.state.A), ("W", model.state.W)):
        shards = arr.addressable_shards
        where = {s.device.id for s in shards}
        log(f"shard placement {name} {tuple(arr.shape)}: " + ", ".join(
            f"device {s.device.id} [{_span(s.index[0])}, "
            f"{_span(s.index[1])}]" for s in shards))
        if len(shards) != 4 or len(where) != 4:
            raise AssertionError(f"{name} is not spread over 4 devices")
    ll4 = model.log_likelihood()
    om4 = jax.device_put(omega, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("time", "neuron")))
    gram4 = _gram_shard_map(d.Xf, om4, B, G, model._t_chunk, precision,
                            mesh)
    ll_err = abs(ll4 - ll1) / abs(ll1)
    gram_err = _rel_err(gram4, gram1)
    bound = BOUNDS[precision]
    log(f"sharded vs single device mesh {dict(mesh.shape)}: ll {ll4:.3f} "
        f"vs {ll1:.3f} (rel {ll_err:.2e}); group Gram rel err "
        f"{gram_err:.2e} (bound {bound:.0e})")
    if not (ll_err <= bound and gram_err <= bound):
        raise AssertionError("sharded model disagrees with single device")
    t0 = time.perf_counter()
    out = model.fit_compiled(n_samples=4, n_burnin=0)
    if not np.all(np.isfinite(out["lls"])):
        raise AssertionError(f"sharded fit: bad lls {out['lls']}")
    log(f"sharded fit_compiled: lls "
        f"{[round(float(x), 1) for x in out['lls']]}, "
        f"{time.perf_counter() - t0:.1f} s incl. compile")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh paths")
    args = ap.parse_args(argv)
    devs = require_gpu()
    device_info()
    if args.four:
        four_device()
    else:
        flagship_bernoulli()
        flagship_nb()
        gram_psi_numerics()
        pg_numerics()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
